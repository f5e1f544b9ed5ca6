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


def test_session_frozen_phases(tmp_path):
    """Port of tests/test_api.py::test_session_frozen_phases."""
    s = _session(str(tmp_path / "run"), {"w0": torch.arange(8.0)})
    with s.frozen(1) as snap:
        # ①–③ already ran: capture is in host memory, job quiesced
        assert snap.step == 1
        assert "frozen_s" in snap.stats
        assert s.engine.device_plugin.lock.locked
        assert s.store.list_steps() == []      # nothing committed yet
        assert snap.warnings == []
    # ④ ran on exit: image committed, lock released
    assert s.store.list_steps() == [1]
    assert not s.engine.device_plugin.lock.locked
    assert snap.path is not None


def test_frozen_warnings_are_the_captures_list(tmp_path):
    """``snap.warnings`` is the capture context's list: what a plugin
    appends while the job is frozen shows on the handle, as the
    reference's ``FrozenCheckpoint.warnings`` does."""
    from repro_torch.core.plugins import Plugin

    class _Warns(Plugin):
        name = "warns"

        def pause_devices(self, ctx):
            ctx.warnings.append(f"step {ctx.step}: probe")

    s = _session(str(tmp_path / "run"), {"w": torch.ones(3)})
    s.add_plugin(_Warns())
    with s.frozen(2) as snap:
        assert snap.step == 2
        assert snap.warnings == ["step 2: probe"]
    assert s.latest_step() == 2


@pytest.mark.cuda
def test_frozen_warnings_carry_the_leftover_device_bytes(tmp_path):
    """On the card the device plugin warns of device memory outside the
    registered roots; the warning reaches ``snap.warnings``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the leftover-bytes warning "
                    "counts CUDA memory); run python3 chip_smoke.py on "
                    "the card")
    state = {"w": torch.ones(1024, device="cuda")}
    scratch = torch.empty(1 << 20, device="cuda")   # outside the roots
    s = CheckpointSession(str(tmp_path / "run"), device="cuda")
    s.attach(lambda: {"st": state})
    with s.frozen(1) as snap:
        assert any("outside the registered roots" in w
                   for w in snap.warnings)
        assert snap.stats["leftover_device_bytes"] >= scratch.nbytes
    del scratch


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
