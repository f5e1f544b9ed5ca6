"""The port's dense LM held against the JAX package's LM on the CPU.

Same smoke config, same params (drawn with numpy, carried into torch by
``params_from_numpy``), f32: prefill logits and cache and a decode chain
agree to 1e-3 (the tolerance of tests/test_models_smoke.py), and the
kernel path equals the plain path.
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
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM

ARCH = "qwen1.5-0.5b"
TOL = dict(rtol=1e-3, atol=1e-3)


def _models():
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


def test_param_tree_matches_reference_paths():
    cfg, jm, jp, tm, tp = _models()
    jflat = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf in
             jax.tree_util.tree_flatten_with_path(jm.init_abstract())[0]}
    from repro_torch.core.device_plugin import flatten_with_paths
    tflat = {k: tuple(v.shape)
             for k, v in flatten_with_paths(tm.init(0)).items()}
    assert tflat == jflat
    assert set(flatten_with_paths(tm.init_abstract())) == set(jflat)


def test_prefill_matches_jax():
    cfg, jm, jp, tm, tp = _models()
    toks = _tokens(cfg)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    lt, ct = tm.prefill(tp, {"tokens": torch.as_tensor(toks).long()})
    V = cfg.vocab_size
    np.testing.assert_allclose(lt.numpy()[:, :V], np.asarray(lj)[:, :V],
                               **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct["pos0"][name].numpy(),
                                   np.asarray(cj["pos0"][name]), **TOL)
    assert (lt.numpy()[:, V:] <= -1e29).all()        # padded vocab masked


def test_decode_chain_matches_jax():
    cfg, jm, jp, tm, tp = _models()
    toks = _tokens(cfg, S=8)
    S, max_seq = toks.shape[1], 16
    _, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    _, ct = tm.prefill(tp, {"tokens": torch.as_tensor(toks).long()})
    pad = [(0, 0), (0, 0), (0, max_seq - S), (0, 0), (0, 0)]
    cj = jax.tree.map(lambda a: jnp.pad(a, pad), cj)
    ct = {"pos0": {k: torch.nn.functional.pad(
        v, (0, 0, 0, 0, 0, max_seq - S)) for k, v in ct["pos0"].items()}}
    last = toks[:, -1]
    for i in range(4):
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(last), jnp.int32(S + i))
        lt, ct = tm.decode_step(tp, ct, torch.as_tensor(last).long(), S + i)
        np.testing.assert_allclose(lt.numpy()[:, :cfg.vocab_size],
                                   np.asarray(lj)[:, :cfg.vocab_size], **TOL)
        last = np.array(jnp.argmax(lj, axis=-1), np.int32)
        assert (lt.argmax(-1).numpy() == last).all()
    np.testing.assert_allclose(ct["pos0"]["k"].numpy(),
                               np.asarray(cj["pos0"]["k"]), **TOL)


def test_kernel_path_equals_plain_path_on_cpu():
    cfg, _, _, tm, tp = _models()
    tk = LM(get_smoke_config(ARCH), compute_dtype=torch.float32,
            use_kernels=True, device="cpu")
    toks = torch.as_tensor(_tokens(cfg)).long()
    l0, c0 = tm.prefill(tp, {"tokens": toks})
    l1, c1 = tk.prefill(tp, {"tokens": toks})
    torch.testing.assert_close(l1, l0, **TOL)
    torch.testing.assert_close(c1["pos0"]["k"], c0["pos0"]["k"], **TOL)


def test_unported_layer_kinds_raise():
    with pytest.raises(NotImplementedError, match="SWA|attn"):
        LM(get_smoke_config("h2o-danube-1.8b"), device="cpu")
    with pytest.raises(NotImplementedError):
        LM(get_smoke_config("mamba2-2.7b"), device="cpu")
