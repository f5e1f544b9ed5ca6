"""Cricket-style interception baseline in the port: the log grows with
call count, restore == full replay, and replay is bitwise.

Ports the four cases of tests/test_interception.py to ``repro_torch``.
The overhead case asserts by counting (intercepted calls, logged H2D
bytes, interception time growing with calls), not by racing wrapped
calls against bare ones on the wall clock.  Then what torch's mutable
tensors add: an in-place AdamW step replays bitwise, the initial state
is copied when registered, and the handle table holds every tensor it
keys.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.baselines.interception import InterceptionCheckpointer
from repro_torch.optim import AdamW


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stepfn(w, x):
    x = torch.as_tensor(x, device=w.device)
    return w - 0.1 * torch.tanh(w @ x) @ x.T


def _w(seed, shape=(8, 8)):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def test_log_grows_linearly_with_calls(tmp_path):
    ic = InterceptionCheckpointer(str(tmp_path))
    w = torch.ones((8, 8))
    x = np.ones((8, 8), np.float32)
    ic.register_initial_state("w", w)
    f = ic.wrap(stepfn, "step")
    for _ in range(10):
        w = f(w, x)
    assert ic.stats["intercepted_calls"] == 10
    assert len(ic.log) == 10
    # H2D payloads are copied synchronously (the cudaMemcpy forwarding)
    assert ic.stats["logged_bytes"] == 10 * x.nbytes
    assert ic.stats["intercept_s"] > 0.0


def test_replay_reproduces_state_bitwise(tmp_path):
    ic = InterceptionCheckpointer(str(tmp_path))
    w0 = _w(0)
    x = _w(1).numpy()
    ic.register_initial_state("w", w0)
    f = ic.wrap(stepfn, "step")
    w = w0
    for _ in range(5):
        w = f(w, x)
    path = ic.checkpoint(5)

    ic2 = InterceptionCheckpointer(str(tmp_path))
    results, stats = ic2.restore(path, {"step": stepfn}, device="cpu")
    assert stats["replayed_calls"] == 5
    final = results[ic.log[-1]["out_handles"][0]]
    assert torch.equal(final, w)


def test_interception_adds_per_call_overhead(tmp_path):
    """The paper's Fig. 2 claim, by counting: every call is intercepted,
    logs its H2D payload, and adds interception time; the time grows
    with the calls."""
    ic = InterceptionCheckpointer(str(tmp_path))
    w = torch.ones((16, 16))
    x = np.ones((16, 16), np.float32)
    ic.register_initial_state("w", w)
    wrapped = ic.wrap(stepfn, "step")
    n = 50
    spent = []
    v = w
    for i in range(n):
        v = wrapped(v, x)
        spent.append(ic.stats["intercept_s"])
        assert ic.stats["intercepted_calls"] == i + 1
        assert ic.stats["logged_bytes"] == (i + 1) * x.nbytes
    assert all(b >= a for a, b in zip(spent, spent[1:]))
    assert spent[-1] > spent[0] > 0.0
    assert len(ic.log) == n
    # the wrapper computes what the bare callable computes
    bare = w
    for _ in range(n):
        bare = stepfn(bare, x)
    assert torch.equal(v, bare)


def test_restore_cost_scales_with_log_length(tmp_path):
    """Replay-based restore re-executes the whole log — restore work grows
    with run length (the paper's prolonged-recovery criticism)."""
    x = np.ones((8, 8), np.float32)

    def run(n):
        ic = InterceptionCheckpointer(str(tmp_path / f"n{n}"))
        w = torch.ones((8, 8))
        ic.register_initial_state("w", w)
        f = ic.wrap(stepfn, "step")
        for _ in range(n):
            w = f(w, x)
        path = ic.checkpoint(n)
        _, stats = InterceptionCheckpointer(
            str(tmp_path / f"n{n}")).restore(path, {"step": stepfn},
                                             device="cpu")
        return stats

    s_short = run(3)
    s_long = run(60)
    assert s_long["replayed_calls"] == 60
    assert s_long["log_entries"] > s_short["log_entries"]
    assert s_long["restore_s"] >= s_long["load_s"]
    assert s_long["replay_s"] > 0.0


# ----------------------------------------------------- in-place steps
def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w1": torch.from_numpy(rng.normal(size=(6, 16)).astype(
                np.float32) * np.float32(0.3)),
            "w2": torch.from_numpy(rng.normal(size=(16, 1)).astype(
                np.float32) * np.float32(0.3))}


OPT = AdamW(lr=lambda step: 1e-2 * (1 + step.float()) ** -0.5)


def adamw_step(params, opt_state, batch):
    """A training step that updates params and moments in place (the
    port's AdamW) and returns the same objects."""
    x = torch.as_tensor(batch["x"])
    y = torch.as_tensor(batch["y"])
    flat = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = torch.mean((torch.tanh(x @ flat["w1"]) @ flat["w2"] - y) ** 2)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    params, opt_state, _ = OPT.update(grads, opt_state, params)
    return params, opt_state


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(4, 6)).astype(np.float32),
             "y": rng.normal(size=(4, 1)).astype(np.float32)}
            for _ in range(n)]


def test_inplace_adamw_step_replays_bitwise(tmp_path):
    """The state is copied when registered; the in-place step keeps its
    handles (one copy of the state in the table however long the run),
    and replay mutates the restored tensors in the same order: the
    replayed params, moments and step equal the live ones bitwise."""
    params = _params(0)
    opt_state = OPT.init(params)
    ic = InterceptionCheckpointer(str(tmp_path))
    ic.register_initial_state("train", {"params": params, "opt": opt_state})
    n_handles = len(ic._results)
    step = ic.wrap(adamw_step, "step")
    batches = _batches(6)
    for i, b in enumerate(batches):
        out = step(params, opt_state, b)
        assert out[0] is params and out[1] is opt_state     # in place
        if i == 2:
            path3 = ic.checkpoint(3)
            want3 = {k: v.clone() for k, v in params.items()}
    assert len(ic._results) == n_handles       # no new handles
    assert ic.stats["logged_bytes"] == sum(
        b["x"].nbytes + b["y"].nbytes for b in batches)
    # the registered snapshot is the state before the first step
    init = ic.initial_state["train"]["params"]
    assert torch.equal(init["w1"], _params(0)["w1"])
    assert not torch.equal(init["w1"], params["w1"])
    path6 = ic.checkpoint(6)

    for path, n, want_params in ((path3, 3, want3), (path6, 6, params)):
        rc = InterceptionCheckpointer(str(tmp_path))
        results, stats = rc.restore(path, {"step": adamw_step},
                                    device="cpu")
        assert stats["replayed_calls"] == n
        got = rc.replayed_tree(results, "train")
        for k in want_params:
            assert torch.equal(got["params"][k], want_params[k]), k
        assert int(got["opt"].step) == n
        if n == 6:
            for part in ("m", "v"):
                for k in params:
                    assert torch.equal(getattr(got["opt"], part)[k],
                                       getattr(opt_state, part)[k])


def test_handle_table_holds_what_it_keys(tmp_path):
    """A functional step's outputs are tagged and held: the caller
    dropping them frees nothing, so no id() is reused and every handle
    still names its own tensor."""
    ic = InterceptionCheckpointer(str(tmp_path))
    w = _w(3)
    x = _w(4).numpy()
    ic.register_initial_state("w", w)
    f = ic.wrap(stepfn, "step")
    refs = []
    for _ in range(8):
        w = f(w, x)
        refs.append(weakref.ref(w))
    del w
    gc.collect()
    assert all(r() is not None for r in refs)
    handles = [rec["out_handles"][0] for rec in ic.log]
    assert len(set(handles)) == 8
    assert all(ic._results[h] is r() for h, r in zip(handles, refs))


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: restore would run")
def test_restore_needs_a_card_unless_cpu(tmp_path):
    ic = InterceptionCheckpointer(str(tmp_path))
    ic.register_initial_state("w", torch.ones(2))
    path = ic.checkpoint(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ic.restore(path, {})


# ------------------------------------------- parity with the JAX package
MLP_STEPS = 20


def _mlp_inputs(seed=0):
    """The `intercept` workload's MLP: w0 (10→32→1, scale 0.1), x, y."""
    rng = np.random.default_rng(seed)
    w0 = {"w1": rng.normal(size=(10, 32)).astype(np.float32) * np.float32(.1),
          "w2": rng.normal(size=(32, 1)).astype(np.float32) * np.float32(.1)}
    x = rng.normal(size=(16, 10)).astype(np.float32)
    y = rng.normal(size=(16, 1)).astype(np.float32)
    return w0, x, y


def _jax_mlp_step():
    from repro.orchestrator.workloads import InterceptionWorkload
    return InterceptionWorkload._make_step()


def test_mlp_step_matches_the_jax_package():
    """The same w0, x and y through the port's `mlp_step` and the JAX
    package's jitted step: the weights after MLP_STEPS SGD steps agree to
    f32 rounding (rtol 1e-5, atol 1e-6)."""
    import jax.numpy as jnp
    from repro_torch.orchestrator.workloads import mlp_step
    w0, x, y = _mlp_inputs()
    jstep = _jax_mlp_step()
    wj = {k: jnp.asarray(v) for k, v in w0.items()}
    wt = {k: torch.from_numpy(v.copy()) for k, v in w0.items()}
    for _ in range(MLP_STEPS):
        wj = jstep(wj, x, y)
        wt = mlp_step(wt, x, y)
    for k in w0:
        assert not np.array_equal(np.asarray(wj[k]), w0[k]), k   # it moved
        np.testing.assert_allclose(wt[k].numpy(), np.asarray(wj[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_interception_counts_match_the_jax_package(tmp_path):
    """Both packages' checkpointers through the same call sequence (the
    MLP registered, MLP_STEPS wrapped steps, images at 5 and at the end,
    each restored by replay): intercepted_calls, logged_bytes, the log's
    length, its handles and argument kinds, and each restore's
    replayed_calls and log_entries are equal; the replayed weights agree
    with each other to f32 rounding."""
    import jax.numpy as jnp
    from repro.baselines.interception import (
        InterceptionCheckpointer as JaxInterceptionCheckpointer)
    from repro_torch.orchestrator.workloads import mlp_step
    w0, x, y = _mlp_inputs()
    jstep = _jax_mlp_step()
    sides = {
        "jax": (JaxInterceptionCheckpointer(str(tmp_path / "jax")), jstep,
                {k: jnp.asarray(v) for k, v in w0.items()}),
        "torch": (InterceptionCheckpointer(str(tmp_path / "torch")),
                  mlp_step, {k: torch.from_numpy(v.copy())
                             for k, v in w0.items()}),
    }
    got = {}
    for side, (ic, fn, w) in sides.items():
        ic.register_initial_state("w", w)
        f = ic.wrap(fn, "step")
        paths = []
        for i in range(1, MLP_STEPS + 1):
            w = f(w, x, y)
            if i in (5, MLP_STEPS):
                paths.append(ic.checkpoint(i))
        restores = []
        for path in paths:
            if side == "jax":
                results, st = JaxInterceptionCheckpointer(
                    str(tmp_path / side)).restore(path, {"step": fn})
            else:
                results, st = InterceptionCheckpointer(
                    str(tmp_path / side)).restore(path, {"step": fn},
                                                  device="cpu")
            restores.append((st["replayed_calls"], st["log_entries"]))
        last = [np.asarray(results[h]) for h in ic.log[-1]["out_handles"]]
        got[side] = dict(
            calls=ic.stats["intercepted_calls"],
            logged_bytes=ic.stats["logged_bytes"], log_len=len(ic.log),
            handles=[r["out_handles"] for r in ic.log],
            kinds=[[kind for kind, _ in r["args"]] for r in ic.log],
            restores=restores, last=last)
    j, t = got["jax"], got["torch"]
    assert t["calls"] == j["calls"] == MLP_STEPS
    assert t["logged_bytes"] == j["logged_bytes"] \
        == MLP_STEPS * (x.nbytes + y.nbytes)
    assert t["log_len"] == j["log_len"] == MLP_STEPS
    assert t["handles"] == j["handles"]
    assert t["kinds"] == j["kinds"]
    assert t["restores"] == j["restores"] == [(5, 5),
                                              (MLP_STEPS, MLP_STEPS)]
    for a, b in zip(t["last"], j["last"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
