"""The port's DecodeServer: snapshot mid-generation, resume token-exact.

Ports tests/test_server.py to ``repro_torch`` on the CPU (warm and cold
restore, sync and async dumps) and crosses the packages: a generation
snapshotted by the JAX server resumes in the port with the JAX
continuation's tokens, and the other way round; with the same numpy params
both packages pick the same greedy tokens in f32.  Each runs for the dense
(qwen1.5, KV cache) and the pure-SSM (mamba2, SSM cache) smoke configs;
the images cross the packages for the jamba hybrid too.  The sliding-window
server (h2o-danube, window 16) agrees with the JAX server while max_seq
stays within the window; past it, where the JAX server pads the ring to
max_seq and loses the window, the port's greedy tokens follow its own
windowed forward.  The encoder-decoder (whisper: frames, a self and a
cross cache) and the VLM (qwen2-vl: vision embeddings over the first
tokens, the positions of a 4 x 4 image) resume warm and cold and cross
the packages too, their images naming the same entries
(``serve_state/cache/{self_k,self_v,cross_k,cross_v}`` for whisper).
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
from repro_torch.models.layers import image_positions
from repro_torch.runtime.server import DecodeServer

ARCH = "qwen1.5-0.5b"
ARCHS = ["qwen1.5-0.5b", "mamba2-2.7b"]
# the encoder-decoder and the VLM: a second input path into prefill
MM_ARCHS = ["whisper-tiny", "qwen2-vl-7b"]
# across the packages also the hybrid: K/V beside SSM states, MoE FFNs
CROSS_ARCHS = ARCHS + ["jamba-v0.1-52b"] + MM_ARCHS
SWA_ARCH = "h2o-danube-1.8b"
POLICY = get_policy("baseline")
MAX_SEQ = 64


def _np_params(seed=0, arch=ARCH):
    """Params as numpy, drawn once for both packages."""
    jm = build_model(jax_smoke_config(arch), POLICY, None,
                     compute_dtype=jnp.float32, remat=False)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32),
        jm.init_abstract())


def _prompt(B=2, S=12, arch=ARCH):
    """The reference pipeline's batch (whisper's with frames); a VLM's
    prompt holds a 4 x 4 image (its 16 vision embeddings) and 4 text
    tokens, with the image's positions."""
    from repro.data import TokenPipeline
    cfg = jax_smoke_config(arch)
    if cfg.vision_stub:
        S = max(S, cfg.num_patches + 4)
    batch = TokenPipeline(cfg, B, S, seed=9).next()
    if cfg.vision_stub:
        batch["positions"] = image_positions(B, S, (4, 4)).numpy()
    return batch


def _server(run_dir, params=None, mode="sync", arch=ARCH, max_seq=MAX_SEQ):
    srv = DecodeServer(get_smoke_config(arch), run_dir, max_seq=max_seq,
                       options=CheckpointOptions(mode=mode), device="cpu")
    if params is not None:
        srv.load(params_from_numpy(params, "cpu"))
    return srv


def _jax_server(run_dir, mesh, params=None, arch=ARCH, max_seq=MAX_SEQ):
    if jax_smoke_config(arch).moe_num_experts:
        # the reference's MoE block wants an expert-parallel "model" axis
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((1, 1), ("data", "model"))
    srv = JaxDecodeServer(jax_smoke_config(arch), POLICY, mesh, run_dir,
                          max_seq=max_seq)
    if params is not None:
        srv.load(jax.tree.map(jnp.asarray, params))
    return srv


@pytest.mark.parametrize("arch", ARCHS + MM_ARCHS)
@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("boot", ["warm", "cold"])
def test_snapshot_mid_generation_token_exact(boot, mode, arch, tmp_path):
    run = str(tmp_path / "srv")
    params = _np_params(arch=arch)
    srv = _server(run, params, mode, arch)
    batch = _prompt(arch=arch)
    srv.start(batch)
    srv.decode(3)
    srv.checkpoint(0)
    expected = srv.decode(4).copy()          # uninterrupted continuation
    srv.session.wait_pending()
    assert srv.session.last_commit_step == 0

    if boot == "warm":
        srv2 = _server(run, params, arch=arch)
        srv2.start(batch)                    # live structures, then restore
    else:
        srv2 = _server(run, arch=arch)       # nothing loaded, never started
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


@pytest.mark.parametrize("arch", ARCHS)
def test_crash_mid_generation_resumes_token_exact(arch, tmp_path):
    """`fail_at` raises SimulatedFailure at that position; a fresh server
    restores the last image and finishes the generation with the tokens
    of the run that never crashed (`straggle_at` only stalls a token)."""
    from repro_torch.runtime.fault import SimulatedFailure
    params, batch = _np_params(arch=arch), _prompt(arch=arch)
    ref = _server(str(tmp_path / "ref"), params, arch=arch)
    ref.start(batch)
    want = ref.decode(8).copy()
    run = str(tmp_path / "srv")
    srv = _server(run, params, arch=arch)
    srv.start(batch)
    srv.decode_until(srv.pos + 3, straggle_at=srv.pos + 1)
    srv.checkpoint(srv.pos)
    with pytest.raises(SimulatedFailure):
        srv.decode_until(srv.pos + 5, fail_at=srv.pos + 2)
    fresh = _server(run, arch=arch)
    assert fresh.restore() == ref.pos - 5
    fresh.decode_until(ref.pos)
    np.testing.assert_array_equal(fresh.tokens, want)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_greedy_tokens_match_jax(arch, tmp_path, mesh1):
    params = _np_params(arch=arch)
    batch = _prompt(arch=arch)
    js = _jax_server(str(tmp_path / "jax"), mesh1, params, arch)
    js.start(batch)
    want = js.decode(5)
    ts = _server(str(tmp_path / "torch"), params, arch=arch)
    ts.start(batch)
    np.testing.assert_array_equal(ts.decode(5), want)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_jax_image_cold_boots_in_port(arch, tmp_path, mesh1):
    run = str(tmp_path / "srv")
    js = _jax_server(run, mesh1, _np_params(arch=arch), arch)
    js.start(_prompt(arch=arch))
    js.decode(3)
    js.checkpoint(0)
    expected = js.decode(4).copy()
    ts = _server(run, arch=arch)             # the port's cold server
    ts.restore()
    assert ts.pos == js.pos - 4
    np.testing.assert_array_equal(ts.decode(4), expected)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_port_image_cold_boots_in_jax(arch, tmp_path, mesh1):
    run = str(tmp_path / "srv")
    ts = _server(run, _np_params(arch=arch), arch=arch)
    ts.start(_prompt(arch=arch))
    ts.decode(3)
    ts.checkpoint(0)
    expected = ts.decode(4).copy()
    js = _jax_server(run, mesh1, arch=arch)
    js.restore()
    assert js.pos == ts.pos - 4
    np.testing.assert_array_equal(js.decode(4), expected)


def test_pad_cache_pads_only_attention_kv():
    """The KV seq dim is padded to that of the model's declared cache:
    max_seq, and an SWA ring only to its window; an SSM state h
    (L,B,nh,P,N) is 5-D too, with nh below max_seq, and stays as it is
    (keyed by leaf name, as in src/repro/runtime/server.py:88-106)."""
    L, B, S, max_seq, window = 2, 3, 5, 16, 8
    kv = torch.randn(L, B, S, 2, 8)
    h = torch.randn(L, B, 4, 16, 32)                 # nh=4 < max_seq
    conv = torch.randn(L, B, 3, 64)

    def meta(*shape):
        return torch.empty(shape, device="meta")
    template = {"pos0": {n: meta(L, B, max_seq, 2, 8) for n in "kv"},
                "pos1": {"h": meta(*h.shape), "conv_x": meta(*conv.shape)},
                "pos2": {n: meta(L, B, window, 2, 8) for n in "kv"}}
    out = DecodeServer._pad_cache(
        {"pos0": {"k": kv, "v": kv.clone()},
         "pos1": {"h": h, "conv_x": conv},
         "pos2": {"k": kv.clone(), "v": kv.clone()}}, template)
    for pos, length in (("pos0", max_seq), ("pos2", window)):
        for name in ("k", "v"):
            assert out[pos][name].shape == (L, B, length, 2, 8)
            torch.testing.assert_close(out[pos][name][:, :, :S], kv)
            assert not out[pos][name][:, :, S:].any()
    assert out["pos1"]["h"] is h
    assert out["pos1"]["conv_x"] is conv


def test_swa_server_matches_jax_within_the_window(tmp_path, mesh1):
    """max_seq 16 = the window: both servers hold the same ring and pick
    the same greedy tokens."""
    params = _np_params(arch=SWA_ARCH)
    batch = _prompt(S=8, arch=SWA_ARCH)
    js = _jax_server(str(tmp_path / "jax"), mesh1, params, SWA_ARCH, 16)
    js.start(batch)
    ts = _server(str(tmp_path / "torch"), params, arch=SWA_ARCH, max_seq=16)
    ts.start(batch)
    assert ts.cache["pos0"]["k"].shape[2] == 16
    np.testing.assert_array_equal(ts.decode(7), js.decode(7))


@pytest.mark.parametrize("prompt", [8, 24])
def test_swa_server_past_the_window_follows_its_forward(prompt, tmp_path):
    """max_seq 40 > the window (16): the ring stays 16 slots long, and
    every greedy token is the argmax of the windowed forward over the
    tokens before it, also once decode wraps the ring (the case the JAX
    server gets wrong, ROADMAP C)."""
    params = _np_params(arch=SWA_ARCH)
    ts = _server(str(tmp_path / "torch"), params, arch=SWA_ARCH, max_seq=40)
    ts.start(_prompt(S=prompt, arch=SWA_ARCH))
    assert ts.cache["pos0"]["k"].shape[2] == 16
    tokens = ts.decode(39 - prompt).copy()
    with torch.no_grad():
        logits = ts.model.forward(ts.params, {"tokens": torch.as_tensor(
            tokens).long()})
    want = logits[:, prompt - 1:-1, :].argmax(-1).numpy()
    np.testing.assert_array_equal(tokens[:, prompt:], want)


def test_unported_options_are_rejected(tmp_path):
    """Replication, transfer policies and the v1 writer are ported: the
    options take them, and reject malformed values as the reference
    does."""
    from repro_torch.api import TransferPolicy
    opts = CheckpointOptions(replicate_to=str(tmp_path / "peer"),
                             transfer_policy=TransferPolicy(mode="delta"),
                             pack_format=1)
    assert opts.transfer_policy.mode == "delta" and opts.pack_format == 1
    assert CheckpointOptions().transfer_policy == TransferPolicy()
    for bad, match in ((dict(replicate_to=""), "replicate_to"),
                       (dict(transfer_policy=object()), "TransferPolicy"),
                       (dict(pack_format=3), "pack_format")):
        with pytest.raises(OptionsError, match=match):
            CheckpointOptions(**bad)


def test_server_without_device_needs_cuda(tmp_path):
    """No device given: CUDA or an error, never a quiet CPU run."""
    if torch.cuda.is_available():
        srv = DecodeServer(get_smoke_config(ARCH), str(tmp_path / "s"))
        assert srv.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DecodeServer(get_smoke_config(ARCH), str(tmp_path / "s"))


def test_encdec_image_names_self_and_cross_caches(tmp_path):
    """A whisper server image read by the reference's store: the cache
    entries are the reference's names, the cross cache at the encoder's
    frame count."""
    from repro.core.snapshot_io import SnapshotStore as JaxStore
    arch = "whisper-tiny"
    run = str(tmp_path / "srv")
    ts = _server(run, _np_params(arch=arch), arch=arch)
    ts.start(_prompt(arch=arch))
    ts.checkpoint(0)
    reader = JaxStore(run).reader(0)
    try:
        shapes = {key: tuple(reader.load_entry("serve_state", key)["shape"])
                  for key in reader.entry_names("serve_state")
                  if key.startswith("cache/")}
    finally:
        reader.close()
    cfg = jax_smoke_config(arch)
    kv = (cfg.num_layers, 2, MAX_SEQ, cfg.num_kv_heads, cfg.head_dim)
    cross = kv[:2] + (cfg.num_audio_frames,) + kv[3:]
    assert shapes == {"cache/self_k": kv, "cache/self_v": kv,
                      "cache/cross_k": cross, "cache/cross_v": cross}
