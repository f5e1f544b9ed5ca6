"""The port's snapshot engine: abort-to-running, host backend, preflight,
and the chunked attention path the layers keep for long prompts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import self_attention as jax_self_attention
from repro_torch.api import CheckpointSession, capabilities, check
from repro_torch.core import CheckpointAborted
from repro_torch.core.streams import StreamOp, StreamSet
from repro_torch.models import layers as L


def _session(run_dir, state, **kw):
    s = CheckpointSession(run_dir, device="cpu", **kw)
    s.attach(lambda: {"st": state})
    return s


def test_unsafe_op_in_flight_aborts_dump_and_job_keeps_running(tmp_path):
    state = {"w": torch.arange(4.0)}
    s = _session(str(tmp_path / "run"), state)
    streams = StreamSet()
    s.engine.device_plugin.attach_streams(streams)
    streams.enqueue("compute", StreamOp("collective", quiescable=False))
    with pytest.raises(CheckpointAborted, match="unsafe op"):
        s.checkpoint(0)
    assert s.latest_step() is None and not s.engine.device_plugin.lock.locked
    streams.clear_stuck()
    applied = []
    streams.enqueue("compute", StreamOp("dispatch",
                                        apply=lambda: applied.append(1)))
    s.checkpoint(1)                        # quiescable ops drain first
    assert applied == [1] and s.latest_step() == 1


def test_frozen_body_error_aborts_without_image(tmp_path):
    s = _session(str(tmp_path / "run"), {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="changed my mind"):
        with s.frozen(3):
            raise RuntimeError("changed my mind")
    assert s.latest_step() is None
    with s.frozen(4) as snap:
        assert snap.stats["device_bytes"] == 8.0
    assert s.latest_step() == 4 and snap.path.endswith("step_00000004")


def test_host_backend_restores_numpy(tmp_path):
    run = str(tmp_path / "run")
    _session(run, {"w": torch.arange(6, dtype=torch.int32),
                   "b": torch.ones(3, dtype=torch.bfloat16)}).checkpoint(0)
    out = CheckpointSession(run, backend="host").restore()["st"]
    np.testing.assert_array_equal(out["w"], np.arange(6, dtype=np.int32))
    assert out["b"].dtype == np.uint16                     # bf16 bits
    np.testing.assert_array_equal(out["b"], np.full(3, 0x3F80, np.uint16))


def test_check_and_capabilities(tmp_path):
    rep = check(run_dir=str(tmp_path / "run"))
    assert rep.ok, rep.summary()
    caps = capabilities()
    assert {"torch", "host"} <= set(caps["backends"])
    assert caps["pack_formats"] == {"write": [1, 2], "read": [1, 2]}
    s = CheckpointSession(str(tmp_path / "r2"), device="cpu")
    assert s.check().ok
    assert s.capabilities()["session"]["device"] == "cpu"


@pytest.mark.parametrize("window", [0, 512])
def test_chunked_self_attention_matches_reference(window):
    """Prompts of CHUNK_THRESHOLD tokens and more take the query-chunked
    path (and the key-window slice under SWA)."""
    S = L.CHUNK_THRESHOLD
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, S, 2, 16)).astype(np.float32)
    k = rng.standard_normal((1, S, 1, 16)).astype(np.float32)
    v = rng.standard_normal((1, S, 1, 16)).astype(np.float32)
    want = jax_self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window)
    got = L.self_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
