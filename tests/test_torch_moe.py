"""The port's MoE FFN held against the JAX package's on the CPU.

Ports the single-device tests of tests/test_moe.py to ``repro_torch``:
the dropless block against a dense all-experts mixture, the capacity
formula, tight capacity dropping tokens, the aux loss of uniform routing,
and grads reaching router and experts.  Each also holds the port's
``moe_block`` against the JAX one on the same numpy inputs (f32):
outputs and aux to 2e-5, grads to 1e-5 of each leaf's largest |g|; under
tight capacity both packages drop the same (token, k) assignments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as JMOE
from repro.sharding import get_policy
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as MOE

POLICY = get_policy("baseline")
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke shapes run fastest on one thread (see test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(E=4, k=2, d=16, f=32, T=24, seed=0, capacity_factor=8.0):
    """The configs of both packages and numpy params and input."""
    over = dict(moe_num_experts=E, moe_top_k=k, d_model=d, moe_d_ff=f,
                moe_capacity_factor=capacity_factor)
    rng = np.random.default_rng(seed)
    draw = lambda *s: (rng.normal(0.0, 0.1, s)          # noqa: E731
                       .astype(np.float32))
    params = {"router": draw(d, E), "w_gate": draw(E, d, f),
              "w_up": draw(E, d, f), "w_down": draw(E, f, d)}
    x = rng.normal(0.0, 1.0, (2, T // 2, d)).astype(np.float32)
    return (get_smoke_config("qwen3-moe-30b-a3b", **over),
            jax_smoke_config("qwen3-moe-30b-a3b", **over), params, x)


def _both(cfg, jcfg, params, x, dropless):
    """(port y, port aux), (JAX y, JAX aux) as numpy."""
    y, aux = MOE.moe_block({k: torch.from_numpy(v) for k, v in
                            params.items()}, cfg, torch.from_numpy(x),
                           dropless=dropless)
    jy, jaux = JMOE.moe_block({k: jnp.asarray(v) for k, v in
                               params.items()}, jcfg, jnp.asarray(x),
                              POLICY, None, dropless=dropless)
    return (y.numpy(), float(aux)), (np.asarray(jy), float(jaux))


def _dense_reference(params, k, x):
    """Every expert for every token, the top-k mixed: no capacity, no
    dispatch table (tests/test_moe.py's reference, in numpy)."""
    xt = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = xt @ params["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top_e = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    top_w = np.take_along_axis(probs, top_e, -1)
    top_w /= top_w.sum(-1, keepdims=True)
    g = np.einsum("td,edf->tef", xt, params["w_gate"])
    u = np.einsum("td,edf->tef", xt, params["w_up"])
    out = np.einsum("tef,efd->ted", g / (1 + np.exp(-g)) * u,
                    params["w_down"])
    mix = sum(top_w[:, j:j + 1] * out[np.arange(len(xt)), top_e[:, j]]
              for j in range(k))
    return mix.reshape(x.shape)


def test_fallback_matches_dense_reference():
    cfg, jcfg, params, x = _setup()
    (y, aux), (jy, jaux) = _both(cfg, jcfg, params, x, dropless=True)
    np.testing.assert_allclose(y, _dense_reference(params, 2, x), **TOL)
    np.testing.assert_allclose(y, jy, **TOL)
    assert np.isfinite(aux) and aux > 0
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)


def test_capacity_formula():
    assert MOE.capacity(tokens=64, k=2, num_experts=8, factor=1.0) == 16
    assert MOE.capacity(tokens=64, k=2, num_experts=8, factor=1.25) == 20
    # capped at tokens
    assert MOE.capacity(tokens=4, k=2, num_experts=1, factor=10.0) == 4
    # at least k
    assert MOE.capacity(tokens=2, k=2, num_experts=64, factor=1.0) >= 2
    for T, k, E, f in [(2048, 8, 128, 1.25), (2048, 2, 16, 1.25),
                       (4, 8, 128, 1.25), (24, 2, 4, 0.25), (7, 3, 5, 1.0)]:
        assert MOE.capacity(T, k, E, f) == JMOE.capacity(T, k, E, f)


def test_tight_capacity_drops_tokens():
    """With factor << 1 some tokens overflow expert capacity and their
    contribution is dropped (GShard semantics): the output differs from
    the dropless run but stays finite, and equals the JAX block's."""
    cfg, jcfg, params, x = _setup(capacity_factor=0.25)
    (y_drop, _), (jy_drop, _) = _both(cfg, jcfg, params, x, dropless=False)
    (y_full, _), _ = _both(cfg, jcfg, params, x, dropless=True)
    assert np.isfinite(y_drop).all()
    assert np.abs(y_drop - y_full).max() > 1e-6
    np.testing.assert_allclose(y_drop, jy_drop, **TOL)


def _kept(y, E):
    """(token, expert) pairs whose contribution reached y, when expert e
    writes coordinate e only."""
    yt = y.reshape(-1, y.shape[-1])[:, :E]
    return {(int(t), int(e)) for t, e in zip(*np.nonzero(yt))}


def test_same_assignments_dropped_as_jax():
    """At capacity_factor 1.0 with routing skewed to expert 0, the same
    (token, k) assignments overflow in both packages: the ones that come
    last in flat (token, k) order.  Expert e writes only coordinate e, so
    y shows which assignments were kept."""
    E = 4
    cfg, jcfg, params, x = _setup(T=48, capacity_factor=1.0)
    down = np.zeros_like(params["w_down"])
    for e in range(E):
        down[e, :, e] = params["w_down"][e, :, e] + 0.5
    bias = np.zeros(x.shape[-1], np.float32)
    bias[0] = 2.0                                # every token leans to 0
    params = dict(params, w_down=down)
    params["router"] = params["router"].copy()
    params["router"][0, 0] = 2.0
    x = (x + bias).astype(np.float32)
    (y, _), (jy, _) = _both(cfg, jcfg, params, x, dropless=False)
    (y_full, _), _ = _both(cfg, jcfg, params, x, dropless=True)
    kept, jkept, every = _kept(y, E), _kept(jy, E), _kept(y_full, E)
    assert kept == jkept
    dropped = every - kept
    assert dropped, "no assignment overflowed: the case tests nothing"
    # the port's own dispatch table names the same kept set
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    _, top_w, top_e = MOE.route(xt, torch.from_numpy(params["router"]),
                                cfg.moe_top_k)
    C = MOE.capacity(xt.shape[0], cfg.moe_top_k, E, 1.0)
    table, _, vtab = MOE.dispatch(top_e, top_w, E, C)
    assert {(int(table[e, c]), e) for e, c in zip(*np.nonzero(
        vtab.numpy()))} == kept
    # the assignments dropped are the last ones in (token, k) order
    for e in range(E):
        ts = sorted(t for t, ee in every if ee == e)
        assert {(t, e) for t in ts[C:]} == {p for p in dropped
                                            if p[1] == e}


def test_aux_loss_uniform_routing_is_one():
    """Perfectly uniform routing gives the Switch aux loss its minimum
    E * (1/E) * (1/E) * E = 1; ties pick the same experts as lax.top_k."""
    cfg, jcfg, params, x = _setup(E=4)
    params = dict(params, router=np.zeros_like(params["router"]))
    (y, aux), (jy, jaux) = _both(cfg, jcfg, params, x, dropless=True)
    assert 0.9 < aux < 1.6
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    np.testing.assert_allclose(y, jy, **TOL)


def test_moe_grads_flow_to_all_parts():
    cfg, jcfg, params, x = _setup()

    def jloss(p):
        y, aux = JMOE.moe_block(p, jcfg, jnp.asarray(x), POLICY, None,
                                dropless=True)
        return jnp.sum(y ** 2) + 0.01 * aux

    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in
          params.items()}
    y, aux = MOE.moe_block(tp, cfg, torch.from_numpy(x), dropless=True)
    got = dict(zip(tp, torch.autograd.grad(torch.sum(y ** 2) + 0.01 * aux,
                                           list(tp.values()))))
    for name in ("router", "w_gate", "w_up", "w_down"):
        g, w = got[name].numpy(), np.asarray(want[name])
        assert np.abs(g).max() > 0, name
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), name


def test_empty_slots_add_exact_zero_in_bf16():
    """Decode is dropless (C = T), so most slots of the expert table are
    empty: they point at token 0 with weight 0.  Their input is zeroed
    before the experts, so a token 0 whose expert outputs overflow bf16
    leaks no inf or NaN (0 * inf) into the other tokens."""
    cfg, _, params, x = _setup(E=4, T=4)
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in params.items()}
    xt = torch.from_numpy(x).bfloat16()
    big = xt.clone()
    big[0, 0] *= 1e20                     # same routing order, huge outputs
    y, _ = MOE.moe_block(tp, cfg, xt, dropless=True)
    y_big, _ = MOE.moe_block(tp, cfg, big, dropless=True)
    assert not torch.isfinite(y_big[0, 0]).all()
    rest = y_big.reshape(4, -1)[1:]
    assert torch.isfinite(rest).all()
    torch.testing.assert_close(rest, y.reshape(4, -1)[1:])
