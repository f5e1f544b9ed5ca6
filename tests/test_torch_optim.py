"""The port's optimizer, data pipeline and fault monitors against the JAX
package's, on the same numpy inputs.

AdamW (global-norm clip, bias correction, decoupled weight decay) and its
schedules over 3 updates to 1e-6; the optimizer state flattens to the
reference's image names (``opt/step`` int32, ``opt/m/…``, ``opt/v/…``)
and ``retree`` rebuilds it as an ``OptState``; the data pipeline's batches
are bitwise the reference's; the straggler monitor, failure detector and
JIT policy decide as the reference's do (tests/test_trainer_fault.py:
27-63).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.device_plugin import _key_str
from repro.data import TokenPipeline as JaxPipeline
from repro.optim import AdamW as JaxAdamW
from repro.optim import schedule as jax_schedule
from repro.runtime import fault as jax_fault
from repro_torch.configs import get_smoke_config
from repro_torch.core.device_plugin import capture_tree, flatten_with_paths
from repro_torch.core.engine import SnapshotEngine
from repro_torch.data import TokenPipeline
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.optim import AdamW, OptState, constant, warmup_cosine
from repro_torch.runtime import fault

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke shapes run fastest on one thread; with several test workers
    on the machine, torch's default of one thread per core makes every
    small op wait on the others' workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    return {"a": {"w": (scale * rng.standard_normal((4, 3))).astype(np.float32),
                  "b": (scale * rng.standard_normal(3)).astype(np.float32)},
            "z": (scale * rng.standard_normal((2, 5))).astype(np.float32)}


SCHEDULES = {
    "warmup_cosine": (lambda: warmup_cosine(1e-2, 2, 10),
                      lambda: jax_schedule.warmup_cosine(1e-2, 2, 10)),
    "constant": (lambda: constant(3e-3), lambda: jax_schedule.constant(3e-3)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    port, ref = (f() for f in SCHEDULES[name])
    for step in range(13):
        np.testing.assert_allclose(
            port(torch.tensor(step, dtype=torch.int32)).numpy(),
            np.asarray(ref(jnp.int32(step))), **TOL)


@pytest.mark.parametrize("clip", [1.0, 100.0])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_adamw_three_updates_match_reference(name, clip):
    """clip 1.0 clips (the grads' global norm is ~5), 100.0 does not."""
    port_lr, ref_lr = (f() for f in SCHEDULES[name])
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    jopt = JaxAdamW(lr=ref_lr, clip_norm=clip)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    topt = AdamW(lr=port_lr, clip_norm=clip)
    tp = params_from_numpy(params, "cpu")
    ts = topt.init(tp)
    for g in grads:
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp2, ts2, tm = topt.update(params_from_numpy(g, "cpu"), ts, tp)
        assert tp2 is tp and ts2 is ts                 # in place
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), **TOL)
        np.testing.assert_allclose(tm["lr"].numpy(), np.asarray(jm["lr"]),
                                   **TOL)
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step) == 3
    for name_, got, want in (("params", tp, jp), ("m", ts.m, js.m),
                             ("v", ts.v, js.v)):
        got = flatten_with_paths(got)
        for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            np.testing.assert_allclose(got[_key_str(path)].numpy(),
                                       np.asarray(w), **TOL,
                                       err_msg=name_)


def test_opt_state_paths_match_reference_image_names():
    rng = np.random.default_rng(1)
    params = _tree(rng)
    js = JaxAdamW(lr=jax_schedule.constant(1e-3)).init(
        jax.tree.map(jnp.asarray, params))
    want = {_key_str(p): (np.asarray(x).shape, np.asarray(x).dtype.name)
            for p, x in jax.tree_util.tree_flatten_with_path({"opt": js})[0]}
    ts = AdamW(lr=constant(1e-3)).init(params_from_numpy(params, "cpu"))
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flatten_with_paths({"opt": ts}).items()}
    assert got == want
    assert got["opt/step"] == ((), "int32")


def test_retree_rebuilds_the_opt_state_dataclass():
    rng = np.random.default_rng(2)
    state = opt_state_from_numpy(
        (np.int32(7), _tree(rng), _tree(rng)), "cpu")
    raw = {}
    for k, v in flatten_with_paths({"params": {"x": torch.ones(2)},
                                    "opt": state}).items():
        node = raw
        for p in k.split("/")[:-1]:
            node = node.setdefault(p, {})
        node[k.split("/")[-1]] = v.clone()
    template = {"params": {"x": torch.empty(2, device="meta")},
                "opt": AdamW(lr=constant(1e-3)).init_abstract(
                    params_from_numpy(_tree(rng), "cpu"))}
    out = SnapshotEngine.retree(template, raw)
    assert isinstance(out["opt"], OptState)
    assert out["opt"].step.dtype == torch.int32 and int(out["opt"].step) == 7
    for k, v in flatten_with_paths(state).items():
        assert torch.equal(flatten_with_paths(out["opt"])[k], v)


def test_capture_takes_leaves_that_require_grad():
    """``.numpy()`` raises on a tensor that requires grad: the capture
    copies through ``detach`` first."""
    w = torch.randn(3, 4, requires_grad=True)
    cap = capture_tree({"s": {"w": w, "b": torch.zeros(2)}})["s"]
    assert cap["w"]["shape"] == [3, 4]
    np.testing.assert_array_equal(cap["w"]["shards"][0]["data"],
                                  w.detach().numpy())
    with torch.no_grad():
        w.add_(1.0)                  # the capture is a copy, not a view
    assert not np.array_equal(cap["w"]["shards"][0]["data"],
                              w.detach().numpy())


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-2.7b",
                                  "qwen2-vl-7b", "whisper-tiny"])
def test_pipeline_batches_bitwise_equal_reference(arch):
    """Steps 0-5, for a text-only, an SSM, a VLM (vision stub + loss mask)
    and an encoder-decoder (audio frames) config."""
    port = TokenPipeline(get_smoke_config(arch), 3, 24, seed=5, host_id=1,
                         num_hosts=2)
    ref = JaxPipeline(jax_smoke_config(arch), 3, 24, seed=5, host_id=1,
                      num_hosts=2)
    for _ in range(6):
        a, b = port.next(), ref.next()
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_pipeline_state_round_trip():
    cfg = get_smoke_config("qwen1.5-0.5b")
    p = TokenPipeline(cfg, 2, 16, seed=3)
    for _ in range(4):
        p.next()
    st = p.state()
    assert st == JaxPipeline(jax_smoke_config("qwen1.5-0.5b"), 2, 16,
                             seed=3, step=4).state()
    want = p.next()
    q = TokenPipeline(cfg, 7, 9, seed=0)
    q.restore_state(st)
    np.testing.assert_array_equal(q.next()["tokens"], want["tokens"])


# ------------------------------------------------------------ monitors
def test_failure_detector_matches_reference():
    reports = []
    for mod in (fault, jax_fault):
        t = [0.0]
        fd = mod.FailureDetector(deadline_s=5.0, clock=lambda: t[0])
        fd.register("w0")
        fd.register("w1")
        seen = [fd.healthy()]
        t[0] = 4.0
        fd.heartbeat("w0")
        t[0] = 6.0
        seen += [fd.dead_workers(), fd.dead_workers(), fd.healthy()]
        fd.heartbeat("w1")
        seen.append(fd.healthy())
        t[0] = 12.0
        seen.append(fd.dead_workers())
        reports.append(seen)
    assert reports[0] == reports[1]
    assert reports[0][1] == ["w1"] and reports[0][2] == []


def test_straggler_monitor_matches_reference():
    times = [0.10 + 0.001 * (i % 3) for i in range(20)] + [0.50, 0.10] + \
        [0.1 + 0.05 * (i % 7) for i in range(30)]
    flags = []
    for mod in (fault, jax_fault):
        m = mod.StragglerMonitor(min_samples=8, threshold=3.0)
        flags.append(([m.record(t) for t in times], m.flagged_steps,
                      m.median))
    assert flags[0] == flags[1]
    assert flags[0][0][20] is True and not any(flags[0][0][:20])


def test_jit_policy_matches_reference():
    class FakeEngine:
        def __init__(self):
            self.steps = []

        def checkpoint(self, step):
            self.steps.append(step)

    out = []
    for mod in (fault, jax_fault):
        eng = FakeEngine()
        pol = mod.JITCheckpointPolicy(eng, cooldown_steps=10)
        fired = [pol.on_signal(s) for s in (5, 8, 16, 17, 40)]
        out.append((fired, eng.steps, pol.triggered))
    assert out[0] == out[1]
    assert out[0][1] == [5, 16, 40]
