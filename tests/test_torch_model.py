"""The port's LM held against the JAX package's LM on the CPU.

For the dense (qwen1.5) and the pure-SSM (mamba2) smoke configs: same
params (drawn with numpy, carried into torch by ``params_from_numpy``),
f32: prefill logits and cache (K/V, or the SSM state h and the conv
tails) and a decode chain agree to 1e-3 (the tolerance of
tests/test_models_smoke.py), and the kernel path equals the plain path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.encdec import build_model
from repro.sharding import get_policy
from repro_torch.configs import get_smoke_config
from repro_torch.models import mamba as M
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.models.lm import LM

ARCHS = ["qwen1.5-0.5b", "mamba2-2.7b"]
TOL = dict(rtol=1e-3, atol=1e-3)


def _models(ARCH):
    cfg = jax_smoke_config(ARCH)
    jm = build_model(cfg, get_policy("baseline"), None,
                     compute_dtype=jnp.float32, remat=False)
    rng = np.random.default_rng(0)
    # numpy params for both packages (jax.random and torch differ);
    # non-zero biases so the QKV bias path is exercised
    params = jax.tree.map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32),
        jm.init_abstract())
    tm = LM(get_smoke_config(ARCH), compute_dtype=torch.float32,
            device="cpu")
    return cfg, jm, jax.tree.map(jnp.asarray, params), tm, \
        params_from_numpy(params, "cpu")


def _tokens(cfg, B=2, S=12, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _pad_kv(cache, n, pad_fn):
    """Pad the attention K/V seq dim (axis 2) by n; SSM leaves as they
    are."""
    return {p: {k: pad_fn(v, n) if k in ("k", "v") else v
                for k, v in leaves.items()} for p, leaves in cache.items()}


@pytest.mark.parametrize("ARCH", ARCHS)
def test_param_tree_matches_reference_paths(ARCH):
    cfg, jm, jp, tm, tp = _models(ARCH)
    jflat = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf in
             jax.tree_util.tree_flatten_with_path(jm.init_abstract())[0]}
    from repro_torch.core.device_plugin import flatten_with_paths
    tflat = {k: tuple(v.shape)
             for k, v in flatten_with_paths(tm.init(0)).items()}
    assert tflat == jflat
    assert set(flatten_with_paths(tm.init_abstract())) == set(jflat)


@pytest.mark.parametrize("ARCH", ARCHS)
def test_prefill_matches_jax(ARCH):
    cfg, jm, jp, tm, tp = _models(ARCH)
    toks = _tokens(cfg)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    lt, ct = tm.prefill(tp, {"tokens": torch.as_tensor(toks).long()})
    V = cfg.vocab_size
    np.testing.assert_allclose(lt.numpy()[:, :V], np.asarray(lj)[:, :V],
                               **TOL)
    assert set(ct["pos0"]) == set(cj["pos0"])
    for name in ct["pos0"]:
        assert ct["pos0"][name].dtype == torch.float32
        np.testing.assert_allclose(ct["pos0"][name].numpy(),
                                   np.asarray(cj["pos0"][name]), **TOL)
    assert (lt.numpy()[:, V:] <= -1e29).all()        # padded vocab masked


@pytest.mark.parametrize("ARCH", ARCHS)
def test_decode_chain_matches_jax(ARCH):
    cfg, jm, jp, tm, tp = _models(ARCH)
    toks = _tokens(cfg, S=8)
    S, max_seq = toks.shape[1], 16
    _, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    _, ct = tm.prefill(tp, {"tokens": torch.as_tensor(toks).long()})
    pad = [(0, 0), (0, 0), (0, max_seq - S), (0, 0), (0, 0)]
    cj = _pad_kv(cj, max_seq - S, lambda a, n: jnp.pad(a, pad))
    ct = _pad_kv(ct, max_seq - S, lambda v, n: torch.nn.functional.pad(
        v, (0, 0, 0, 0, 0, n)))
    last = toks[:, -1]
    for i in range(4):
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(last), jnp.int32(S + i))
        lt, ct = tm.decode_step(tp, ct, torch.as_tensor(last).long(), S + i)
        np.testing.assert_allclose(lt.numpy()[:, :cfg.vocab_size],
                                   np.asarray(lj)[:, :cfg.vocab_size], **TOL)
        last = np.array(jnp.argmax(lj, axis=-1), np.int32)
        assert (lt.argmax(-1).numpy() == last).all()
    for name in ct["pos0"]:                 # the in-place cache updates
        np.testing.assert_allclose(ct["pos0"][name].numpy(),
                                   np.asarray(cj["pos0"][name]), **TOL)


@pytest.mark.parametrize("ARCH", ARCHS)
def test_kernel_path_equals_plain_path_on_cpu(ARCH):
    cfg, _, _, tm, tp = _models(ARCH)
    tk = LM(get_smoke_config(ARCH), compute_dtype=torch.float32,
            use_kernels=True, device="cpu")
    toks = torch.as_tensor(_tokens(cfg)).long()
    l0, c0 = tm.prefill(tp, {"tokens": toks})
    l1, c1 = tk.prefill(tp, {"tokens": toks})
    torch.testing.assert_close(l1, l0, **TOL)
    torch.testing.assert_close(c1, c0, **TOL)


def test_unported_layer_kinds_raise():
    """Every config builds through ``build_model``: the decoder-only
    patterns (SWA, the Mamba/attention hybrid, MoE, the VLM) as ``LM``,
    whisper as ``EncDecLM``; ``LM`` itself refuses an encoder-decoder
    config and names ``build_model``."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.encdec import build_model as port_build_model
    for arch in ARCH_IDS:
        model = port_build_model(get_smoke_config(arch), device="cpu")
        assert isinstance(model, EncDecLM) == (arch == "whisper-tiny")
    with pytest.raises(ValueError, match="build_model"):
        LM(get_smoke_config("whisper-tiny"), device="cpu")


def test_mamba_layers_keep_the_reference_entries():
    """A pure-SSM layer has ``mamba`` and no ``mlp`` (d_ff == 0) but keeps
    ``pre_mlp_norm``, as the reference declares it; its cache is h in f32
    and the conv tails in the compute dtype."""
    cfg = get_smoke_config("mamba2-2.7b")
    tm = LM(cfg, compute_dtype=torch.bfloat16, device="cpu")
    layer = tm.init_abstract()["blocks"]["pos0"]
    assert set(layer) == {"pre_mixer_norm", "pre_mlp_norm", "mamba"}
    assert set(layer["mamba"]) == set(M.mamba_specs(cfg))
    cache = tm.cache_abstract(3, 64)["pos0"]
    L, nh, P, N = cfg.num_layers, cfg.ssm_nheads, cfg.ssm_headdim, \
        cfg.ssm_state
    assert cache["h"].shape == (L, 3, nh, P, N)
    assert cache["h"].dtype == torch.float32 and cache["h"].is_meta
    assert cache["conv_x"].shape == (L, 3, cfg.ssm_conv_width - 1,
                                     cfg.d_inner)
    assert cache["conv_B"].dtype == torch.bfloat16
    live = M.mamba_cache_init(cfg, 3, torch.bfloat16)
    assert {k: (v.shape, v.dtype) for k, v in live.items()} == \
        {k: (v.shape[1:], v.dtype) for k, v in cache.items()}


def test_mamba_cache_carries_from_numpy():
    """A reference SSM cache (numpy) becomes the port's with the same
    paths, shapes and dtypes, and decode continues from it."""
    cfg, jm, jp, tm, tp = _models("mamba2-2.7b")
    toks = _tokens(cfg, S=8)
    _, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    ct = cache_from_numpy(jax.tree.map(np.asarray, cj), "cpu")
    for name, leaf in ct["pos0"].items():
        assert leaf.shape == cj["pos0"][name].shape
        assert str(leaf.dtype).split(".")[-1] == str(cj["pos0"][name].dtype)
    lj, _ = jm.decode_step(jp, cj, jnp.asarray(toks[:, -1]), jnp.int32(8))
    lt, _ = tm.decode_step(tp, ct, torch.as_tensor(toks[:, -1]).long(), 8)
    np.testing.assert_allclose(lt.numpy()[:, :cfg.vocab_size],
                               np.asarray(lj)[:, :cfg.vocab_size], **TOL)


def test_decode_position_is_bounded_only_by_attention_caches():
    """An SSM cache has no length: mamba decodes at any position, while an
    attention cache still refuses a position past its end."""
    for arch, ok in (("mamba2-2.7b", True), ("qwen1.5-0.5b", False)):
        tm = LM(get_smoke_config(arch), compute_dtype=torch.float32,
                device="cpu")
        params, cache = tm.init(0), tm.init_cache(2, 4)
        tokens = torch.zeros(2, dtype=torch.long)
        if ok:
            logits, _ = tm.decode_step(params, cache, tokens, 100)
            assert torch.isfinite(logits).all()
        else:
            with pytest.raises(ValueError, match="outside the cache"):
                tm.decode_step(params, cache, tokens, 4)
