"""The decoder model zoo in the port, held against the JAX package on the
CPU: sliding-window attention (h2o-danube), the Mamba/attention hybrid
with MoE (jamba), MoE with q/k-norm (both qwen3-moe configs) and the
dense GQA arches with an untied head (phi3-medium, deepseek-coder, the
latter also at its GQA group of 7).

Same numpy params (``params_from_numpy``) and tokens into both packages,
f32, smoke configs: logits, loss and the MoE aux loss to 1e-3; every grad
leaf against ``jax.grad`` to 1e-4 of that leaf's largest |g| (as
tests/test_torch_train.py); prefill + decode against ``forward`` as
tests/test_models_smoke.py:76-113 does (2e-4, at the smoke configs'
no-drop capacity), and against the JAX prefill and decode; a decode chain
that wraps an SWA ring; the port of test_swa_vs_full_attention_differs;
and the ``use_kernels`` path against the plain path for every
architecture (whisper and qwen2-vl with their frames and vision
embeddings).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import TokenPipeline as JaxPipeline
from repro.models.encdec import build_model
from repro.sharding import get_policy
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.encdec import build_model as port_build_model
from repro_torch.models.lm import LM
from repro_torch.runtime.trainer import loss_and_grads

ZOO = ["h2o-danube-1.8b", "jamba-v0.1-52b", "qwen3-moe-30b-a3b",
       "qwen3-moe-235b-a22b", "phi3-medium-14b", "deepseek-coder-33b"]
#: the smoke configs keep 4 query heads over 2; deepseek-coder-33b's
#: published GQA group of 7 (56 over 8) at the smoke width
GQA7 = dict(num_heads=14, num_kv_heads=2)
POLICY = get_policy("baseline")
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke shapes run fastest on one thread (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch, **over):
    """The JAX and the port's LM (f32, no remat) and the same numpy params
    for both."""
    jm = build_model(jax_smoke_config(arch, **over), POLICY, None,
                     compute_dtype=jnp.float32, remat=False)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32),
        jm.init_abstract())
    tm = LM(get_smoke_config(arch, **over), compute_dtype=torch.float32,
            remat=False, device="cpu")
    return jm, jax.tree.map(jnp.asarray, params), tm, \
        params_from_numpy(params, "cpu")


def _tokens(arch, B=2, S=32, seed=1):
    return JaxPipeline(jax_smoke_config(arch), B, S, seed=seed).next()[
        "tokens"].astype(np.int32)


def _paths(tree):
    return {"/".join(str(k.key) for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pad(cache, S, n, pad_fn):
    """Pad every K/V leaf of length S (a full-attention cache) by n."""
    return {p: {k: pad_fn(v, n) if k in ("k", "v") and v.shape[2] == S
                else v for k, v in leaves.items()}
            for p, leaves in cache.items()}


def _pad_torch(t, n):
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))


def _pad_jax(a, n):
    return jnp.pad(a, [(0, 0), (0, 0), (0, n), (0, 0), (0, 0)])


@pytest.mark.parametrize("arch", ZOO)
def test_param_and_cache_trees_match_reference(arch):
    jm, _, tm, _ = _models(arch)
    jflat = {k: v.shape for k, v in _paths(jm.init_abstract()).items()}
    tflat = {k: tuple(v.shape)
             for k, v in flatten_with_paths(tm.init_abstract()).items()}
    assert tflat == jflat
    jc = {k: (v.shape, str(v.dtype)) for k, v in
          _paths(jm.cache_abstract(3, 40)).items()}
    tc = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in
          flatten_with_paths(tm.cache_abstract(3, 40)).items()}
    assert tc == jc


@pytest.mark.parametrize("arch", ZOO)
def test_forward_and_loss_match_jax(arch):
    jm, jp, tm, tp = _models(arch)
    toks = _tokens(arch)
    V = tm.cfg.vocab_size
    lj = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    lt = tm.forward(tp, {"tokens": torch.as_tensor(toks).long()})
    np.testing.assert_allclose(lt.detach().numpy()[..., :V],
                               np.asarray(lj)[..., :V], **TOL)
    (jtot, jmet) = jm.loss(jp, {"tokens": jnp.asarray(toks)})
    ttot, tmet = tm.loss(tp, {"tokens": torch.as_tensor(toks).long()})
    for name in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                   **TOL)
    np.testing.assert_allclose(float(ttot), float(jtot), **TOL)
    assert (float(tmet["aux_loss"]) > 0) == bool(tm.cfg.moe_num_experts)


@pytest.mark.parametrize("arch", ZOO)
def test_grads_match_jax(arch):
    jm, jp, tm, tp = _models(arch)
    toks = _tokens(arch)
    (_, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})
    tmet, tgrads = loss_and_grads(tm, tp,
                                  {"tokens": torch.as_tensor(toks).long()})
    np.testing.assert_allclose(float(tmet["aux_loss"]),
                               float(jmet["aux_loss"]), rtol=1e-5)
    want = {k: np.asarray(v) for k, v in _paths(jgrads).items()}
    got = {k: v.numpy() for k, v in flatten_with_paths(tgrads).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(got[k] - w).max() <= 1e-4 * scale, k
    if tm.cfg.moe_num_experts:                 # the aux reaches the router
        router = [k for k in got if k.endswith("moe/router")]
        assert router and all(np.abs(got[k]).max() > 0 for k in router)


@pytest.mark.parametrize("arch", ZOO)
def test_remat_equals_no_remat_bitwise(arch):
    """The checkpointed layer returns its MoE aux beside x: the aux's
    gradient flows through the recompute, bit for bit."""
    _, _, _, tp = _models(arch)
    batch = {"tokens": torch.as_tensor(_tokens(arch)).long()}
    out = [loss_and_grads(LM(get_smoke_config(arch), remat=remat,
                             compute_dtype=torch.float32, device="cpu"),
                          tp, batch) for remat in (False, True)]
    assert torch.equal(out[0][0]["aux_loss"], out[1][0]["aux_loss"])
    a, b = (flatten_with_paths(o[1]) for o in out)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_decode_matches_forward_and_jax(arch):
    """prefill(prompt) + decode_step(tok) agree with a full forward over
    prompt + tok (tests/test_models_smoke.py:76-113) and with the JAX
    prefill and decode step; the caches agree with the JAX caches."""
    jm, jp, tm, tp = _models(arch)
    S = 24
    toks = _tokens(arch, S=S + 1, seed=3)
    full = tm.forward(tp, {"tokens": torch.as_tensor(toks).long()})
    lt, ct = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :S]).long()})
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])})
    np.testing.assert_allclose(lt.numpy(), full[:, S - 1].detach().numpy(),
                               rtol=2e-4, atol=2e-4)
    V = tm.cfg.vocab_size
    np.testing.assert_allclose(lt.numpy()[:, :V], np.asarray(lj)[:, :V],
                               **TOL)
    for k, w in _paths(cj).items():
        np.testing.assert_allclose(flatten_with_paths(ct)[k].numpy(),
                                   np.asarray(w), **TOL, err_msg=k)
    ct, cj = _pad(ct, S, 8, _pad_torch), _pad(cj, S, 8, _pad_jax)
    ld, _ = tm.decode_step(tp, ct, torch.as_tensor(toks[:, S]).long(), S)
    ljd, _ = jm.decode_step(jp, cj, jnp.asarray(toks[:, S]), jnp.int32(S))
    np.testing.assert_allclose(ld.numpy(), full[:, S].detach().numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ld.numpy()[:, :V], np.asarray(ljd)[:, :V],
                               **TOL)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "deepseek-coder-33b"])
def test_gqa_group_of_seven_matches_jax(arch):
    """The smoke config at a GQA group of 7 (``GQA7``, in both packages):
    forward logits, then prefill + decode against the JAX prefill and
    decode step."""
    jm, jp, tm, tp = _models(arch, **GQA7)
    assert tm.cfg.num_heads // tm.cfg.num_kv_heads == 7
    V, S = tm.cfg.vocab_size, 24
    toks = _tokens(arch, S=S + 1, seed=3)
    lt = tm.forward(tp, {"tokens": torch.as_tensor(toks).long()})
    lj = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(lt.detach().numpy()[..., :V],
                               np.asarray(lj)[..., :V], **TOL)
    pt, ct = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :S]).long()})
    pj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])})
    np.testing.assert_allclose(pt.numpy()[:, :V], np.asarray(pj)[:, :V],
                               **TOL)
    ct, cj = _pad(ct, S, 8, _pad_torch), _pad(cj, S, 8, _pad_jax)
    ld, _ = tm.decode_step(tp, ct, torch.as_tensor(toks[:, S]).long(), S)
    ljd, _ = jm.decode_step(jp, cj, jnp.asarray(toks[:, S]), jnp.int32(S))
    np.testing.assert_allclose(ld.numpy()[:, :V], np.asarray(ljd)[:, :V],
                               **TOL)


@pytest.mark.parametrize("prompt", [8, 20])
def test_swa_decode_chain_wraps_the_ring(prompt):
    """An SWA cache of window 16: prompts shorter and longer than the
    window, then decode steps past it; each step's logits equal the full
    windowed forward's at that position, and the ring is never padded."""
    _, _, tm, tp = _models("h2o-danube-1.8b")
    W, n = tm.cfg.sliding_window, 12
    toks = _tokens("h2o-danube-1.8b", S=prompt + n, seed=5)
    full = tm.forward(tp, {"tokens": torch.as_tensor(toks).long()})
    _, cache = tm.prefill(tp, {"tokens": torch.as_tensor(
        toks[:, :prompt]).long()})
    cache = _pad(cache, prompt, W - prompt, _pad_torch) if prompt < W \
        else cache
    assert cache["pos0"]["k"].shape[2] == W
    for i in range(n):
        pos = prompt + i
        ld, cache = tm.decode_step(tp, cache, torch.as_tensor(
            toks[:, pos]).long(), pos)
        np.testing.assert_allclose(ld.numpy(), full[:, pos].detach().numpy(),
                                   rtol=5e-4, atol=5e-4, err_msg=str(pos))


def test_hybrid_cache_holds_kv_beside_ssm_states():
    """jamba: one period of 8 layers per ``pos{j}`` stack; attention at
    pos4 with K/V, Mamba elsewhere with h and conv tails; MoE at the odd
    positions and a dense MLP at the even ones."""
    _, _, tm, _ = _models("jamba-v0.1-52b")
    cache = tm.cache_abstract(2, 40)
    assert set(cache["pos4"]) == {"k", "v"}
    for j in (0, 1, 2, 3, 5, 6, 7):
        assert set(cache[f"pos{j}"]) == {"h", "conv_x", "conv_B", "conv_C"}
    blocks = tm.init_abstract()["blocks"]
    for j in range(8):
        assert ("moe" in blocks[f"pos{j}"]) == (j % 2 == 1)
        assert ("mlp" in blocks[f"pos{j}"]) == (j % 2 == 0)
        assert ("attn" in blocks[f"pos{j}"]) == (j == 4)


def test_swa_vs_full_attention_differs():
    """h2o-danube SWA: tokens beyond the window are invisible
    (tests/test_models_smoke.py:175-191)."""
    cfg = get_smoke_config("h2o-danube-1.8b", sliding_window=8)
    model = LM(cfg, compute_dtype=torch.float32, remat=False, device="cpu")
    full = LM(dataclasses.replace(cfg, layer_pattern=("attn",),
                                  sliding_window=0),
              compute_dtype=torch.float32, remat=False, device="cpu")
    params = model.init(0)
    batch = {"tokens": torch.as_tensor(_tokens("h2o-danube-1.8b")).long()}
    with torch.no_grad():
        l_swa, l_full = model.forward(params, batch), full.forward(params,
                                                                   batch)
    # identical for early positions (inside the window), different later
    assert (l_swa[:, :8] - l_full[:, :8]).abs().max() < 1e-4
    assert (l_swa[:, -1] - l_full[:, -1]).abs().max() > 1e-6


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_use_kernels_path_matches_plain_path(arch):
    """The kernel path (on the CPU: the kernels' plain versions) equals
    the plain path end to end (tests/test_models_smoke.py:207-221), on
    the reference pipeline's whole batch (whisper's frames, qwen2-vl's
    vision embeddings)."""
    cfg = get_smoke_config(arch)
    m0, m1 = (port_build_model(cfg, compute_dtype=torch.float32,
                               remat=False, use_kernels=k, device="cpu")
              for k in (False, True))
    params = m0.init(0)
    batch = {k: torch.as_tensor(v) for k, v in JaxPipeline(
        jax_smoke_config(arch), 2, 32, seed=1).next().items()}
    batch["tokens"] = batch["tokens"].long()
    with torch.no_grad():
        l0, l1 = m0.forward(params, batch), m1.forward(params, batch)
    V = cfg.vocab_size
    torch.testing.assert_close(l1[..., :V], l0[..., :V], **TOL)
