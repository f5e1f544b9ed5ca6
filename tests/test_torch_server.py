"""The port's DecodeServer: snapshot mid-generation, resume token-exact.

Ports tests/test_server.py to ``repro_torch`` on the CPU (warm and cold
restore, sync and async dumps) and crosses the packages: a generation
snapshotted by the JAX server resumes in the port with the JAX
continuation's tokens, and the other way round; with the same numpy params
both packages pick the same greedy tokens in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.encdec import build_model
from repro.runtime.server import DecodeServer as JaxDecodeServer
from repro.sharding import get_policy
from repro_torch.api import CheckpointOptions, OptionsError
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime.server import DecodeServer

ARCH = "qwen1.5-0.5b"
POLICY = get_policy("baseline")
MAX_SEQ = 64


def _np_params(seed=0):
    """Params as numpy, drawn once for both packages."""
    jm = build_model(jax_smoke_config(ARCH), POLICY, None,
                     compute_dtype=jnp.float32, remat=False)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32),
        jm.init_abstract())


def _prompt(B=2, S=12):
    from repro.data import TokenPipeline
    return TokenPipeline(jax_smoke_config(ARCH), B, S, seed=9).next()


def _server(run_dir, params=None, mode="sync"):
    srv = DecodeServer(get_smoke_config(ARCH), run_dir, max_seq=MAX_SEQ,
                       options=CheckpointOptions(mode=mode), device="cpu")
    if params is not None:
        srv.load(params_from_numpy(params, "cpu"))
    return srv


def _jax_server(run_dir, mesh, params=None):
    srv = JaxDecodeServer(jax_smoke_config(ARCH), POLICY, mesh, run_dir,
                          max_seq=MAX_SEQ)
    if params is not None:
        srv.load(jax.tree.map(jnp.asarray, params))
    return srv


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("boot", ["warm", "cold"])
def test_snapshot_mid_generation_token_exact(boot, mode, tmp_path):
    run = str(tmp_path / "srv")
    params = _np_params()
    srv = _server(run, params, mode)
    batch = _prompt()
    srv.start(batch)
    srv.decode(3)
    srv.checkpoint(0)
    expected = srv.decode(4).copy()          # uninterrupted continuation
    srv.session.wait_pending()
    assert srv.session.last_commit_step == 0

    if boot == "warm":
        srv2 = _server(run, params)
        srv2.start(batch)                    # live structures, then restore
    else:
        srv2 = _server(run)                  # nothing loaded, never started
    srv2.restore()
    assert srv2.pos == srv.pos - 4
    np.testing.assert_array_equal(srv2.decode(4), expected)


def test_preempt_checkpoints_and_yields(tmp_path):
    run = str(tmp_path / "srv")
    srv = _server(run, _np_params())
    srv.start(_prompt())
    out = srv.decode_until(srv.pos + 10, preempt=lambda: srv.pos == 15)
    assert out["preempted"] and out["pos"] == 15
    assert srv.session.latest_step() == 15
    expected = srv.decode(3).copy()
    srv2 = _server(run)
    assert srv2.restore() == 15
    np.testing.assert_array_equal(srv2.decode(3), expected)


def test_greedy_tokens_match_jax(tmp_path, mesh1):
    params = _np_params()
    batch = _prompt()
    js = _jax_server(str(tmp_path / "jax"), mesh1, params)
    js.start(batch)
    want = js.decode(5)
    ts = _server(str(tmp_path / "torch"), params)
    ts.start(batch)
    np.testing.assert_array_equal(ts.decode(5), want)


def test_jax_image_cold_boots_in_port(tmp_path, mesh1):
    run = str(tmp_path / "srv")
    js = _jax_server(run, mesh1, _np_params())
    js.start(_prompt())
    js.decode(3)
    js.checkpoint(0)
    expected = js.decode(4).copy()
    ts = _server(run)                        # the port's cold server
    ts.restore()
    assert ts.pos == js.pos - 4
    np.testing.assert_array_equal(ts.decode(4), expected)


def test_port_image_cold_boots_in_jax(tmp_path, mesh1):
    run = str(tmp_path / "srv")
    ts = _server(run, _np_params())
    ts.start(_prompt())
    ts.decode(3)
    ts.checkpoint(0)
    expected = ts.decode(4).copy()
    js = _jax_server(run, mesh1)
    js.restore()
    assert js.pos == ts.pos - 4
    np.testing.assert_array_equal(js.decode(4), expected)


def test_unported_options_are_rejected(tmp_path):
    for bad in (dict(restore_mode="lazy"), dict(incremental=True),
                dict(replicate_to=str(tmp_path / "peer")),
                dict(pack_format=1)):
        with pytest.raises(OptionsError, match="not ported"):
            CheckpointOptions(**bad)


def test_server_without_device_needs_cuda(tmp_path):
    """No device given: CUDA or an error, never a quiet CPU run."""
    if torch.cuda.is_available():
        srv = DecodeServer(get_smoke_config(ARCH), str(tmp_path / "s"))
        assert srv.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DecodeServer(get_smoke_config(ARCH), str(tmp_path / "s"))
