"""The port's gradients held against the JAX package's on the CPU.

The kernels' autograd Functions (``repro_torch.kernels.ops``: kernel
forward, oracle backward) against the reference's ``custom_vjp`` ops, at
the shapes and tolerances of tests/test_kernels.py:152-207 (attention
2e-4, SSD 1e-3, RMSNorm 1e-5; the JAX forward runs its Pallas kernel in
interpret mode, the port's its plain version).  Then ``LM.loss`` and its
grads against the JAX ``LM.loss`` and ``jax.grad`` for the qwen1.5 and
mamba2 smoke configs, f32, same numpy params and batch: loss to rtol
1e-5, every grad leaf to 1e-4 of that leaf's largest |g|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import TokenPipeline as JaxPipeline
from repro.kernels import ops as jops
from repro.models.encdec import build_model
from repro.sharding import get_policy
from repro_torch.configs import get_smoke_config
from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import ssd_ref
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM
from repro_torch.runtime.trainer import loss_and_grads

ARCHS = ["qwen1.5-0.5b", "mamba2-2.7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke shapes run fastest on one thread; with several test workers
    on the machine, torch's default of one thread per core makes every
    small op wait on the others' workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _attention_inputs():
    rng = np.random.default_rng(9)
    return _np(rng, 1, 64, 4, 32), _np(rng, 1, 64, 2, 32), \
        _np(rng, 1, 64, 2, 32)


def _ssd_inputs():
    rng = np.random.default_rng(10)
    B, S, nh, P, N = 1, 32, 2, 8, 16
    x = _np(rng, B, S, nh, P)
    dt = np.log1p(np.exp(_np(rng, B, S, nh)))                 # softplus
    A = -np.exp(0.3 * _np(rng, nh))
    return x, dt, A, _np(rng, B, S, N), _np(rng, B, S, N)


def _rmsnorm_inputs():
    rng = np.random.default_rng(11)
    return _np(rng, 4, 8, 64), _np(rng, 64)


# (inputs, JAX loss, port loss, tolerance): loss = sum of squares of the
# op's outputs, so the grads depend on the forward's values too
OPS = {
    "attention": (
        _attention_inputs,
        lambda q, k, v: jnp.sum(jops.attention(q, k, v, causal=True,
                                               block_q=32, block_k=32) ** 2),
        lambda q, k, v: torch.sum(ops.attention(q, k, v, causal=True) ** 2),
        2e-4),
    "ssd": (
        _ssd_inputs,
        lambda *a: sum(jnp.sum(o ** 2) for o in jops.ssd(*a, chunk=16)),
        lambda *a: sum(torch.sum(o ** 2) for o in ops.ssd(*a, chunk=16)),
        1e-3),
    "rmsnorm": (
        _rmsnorm_inputs,
        lambda x, s: jnp.sum(jops.rmsnorm(x, s) ** 2),
        lambda x, s: torch.sum(ops.rmsnorm(x, s) ** 2),
        1e-5),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_grads_match_jax(op):
    make, f_jax, f_port, tol = OPS[op]
    arrays = make()
    n = len(arrays)
    want = jax.grad(f_jax, argnums=tuple(range(n)))(
        *map(jnp.asarray, arrays))
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    before = (fa.launches, ssd.launches)
    got = torch.autograd.grad(f_port(*ins), ins)
    assert (fa.launches, ssd.launches) == before   # CPU: plain versions
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("which", ["y", "h", "both"])
def test_ssd_backward_takes_a_grad_for_either_output(which):
    """The SSD Function's backward accepts a gradient for y, h_final or
    both, and then equals autograd through the token-by-token oracle."""
    arrays = _ssd_inputs()
    grads = {}
    for name, fn in (("op", lambda *a: ops.ssd(*a, chunk=16)),
                     ("oracle", ssd_ref)):
        ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
        y, h = fn(*ins)
        loss = {"y": (y ** 2).sum(), "h": (h ** 2).sum(),
                "both": (y ** 2).sum() + (h ** 2).sum()}[which]
        # C does not reach h_final: a zero grad
        grads[name] = torch.autograd.grad(loss, ins, allow_unused=True,
                                          materialize_grads=True)
    for a, b in zip(grads["op"], grads["oracle"]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


def test_xent_picks_the_label_logit_as_cross_entropy_does():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(_np(rng, 2, 6, 40))
    targets = torch.from_numpy(rng.integers(0, 40, (2, 6)))
    mask = torch.ones(2, 6)
    mask[:, -1] = 0
    loss, ntok = L.softmax_xent_sharded(logits, targets, mask)
    want = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, 40), targets[:, :-1].reshape(-1))
    torch.testing.assert_close(loss, want)
    assert float(ntok) == 10.0


def test_xent_seq_chunk_gives_the_same_loss(monkeypatch):
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(_np(rng, 2, 8, 30))
    targets = torch.from_numpy(rng.integers(0, 30, (2, 8)))
    whole = L.softmax_xent_sharded(logits, targets)[0]
    monkeypatch.setattr(L, "XENT_SEQ_CHUNK", 4)
    torch.testing.assert_close(L.softmax_xent_sharded(logits, targets)[0],
                               whole)


def _loss_inputs(arch):
    cfg = jax_smoke_config(arch)
    jm = build_model(cfg, get_policy("baseline"), None,
                     compute_dtype=jnp.float32, remat=False)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: rng.normal(0.0, 0.05, a.shape).astype(np.float32),
        jm.init_abstract())
    return cfg, params, JaxPipeline(cfg, 2, 32, seed=1).next()


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch, use_kernels):
    cfg, params, batch = _loss_inputs(arch)
    jm = build_model(cfg, get_policy("baseline"), None,
                     compute_dtype=jnp.float32, remat=False,
                     use_kernels=use_kernels)
    (_, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tm = LM(get_smoke_config(arch), compute_dtype=torch.float32,
            remat=False, use_kernels=use_kernels, device="cpu")
    tmet, tgrads = loss_and_grads(
        tm, params_from_numpy(params, "cpu"),
        {"tokens": torch.as_tensor(batch["tokens"]).long()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert float(tmet["ntokens"]) == float(jmet["ntokens"])
    assert float(tmet["aux_loss"]) == 0.0
    want = {"/".join(str(k.key) for k in path): np.asarray(g) for path, g
            in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    got = {k: v.numpy() for k, v in flatten_with_paths(tgrads).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(got[k] - w).max() <= 1e-4 * scale, k


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_bitwise(arch, use_kernels):
    cfg, params, batch = _loss_inputs(arch)
    tp = params_from_numpy(params, "cpu")
    tokens = {"tokens": torch.as_tensor(batch["tokens"]).long()}
    out = {}
    for remat in (False, True):
        tm = LM(get_smoke_config(arch), compute_dtype=torch.float32,
                remat=remat, use_kernels=use_kernels, device="cpu")
        out[remat] = loss_and_grads(tm, tp, tokens)
    assert torch.equal(out[True][0]["loss"], out[False][0]["loss"])
    a, b = (flatten_with_paths(out[r][1]) for r in (False, True))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_forward_logits_match_prefill_last_position():
    """The training forward and the serving prefill are one model: the
    last position's logits agree."""
    cfg, params, batch = _loss_inputs("qwen1.5-0.5b")
    tm = LM(get_smoke_config("qwen1.5-0.5b"), compute_dtype=torch.float32,
            device="cpu")
    tp = params_from_numpy(params, "cpu")
    b = {"tokens": torch.as_tensor(batch["tokens"]).long()}
    with torch.no_grad():
        full = tm.forward(tp, b)
    last, _ = tm.prefill(tp, b)
    torch.testing.assert_close(full[:, -1], last, rtol=1e-5, atol=1e-5)
