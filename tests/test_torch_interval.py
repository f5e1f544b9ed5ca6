"""The checkpoint-interval planner in the port, and the session glue that
feeds it.

Ports the planner tests of tests/test_orchestrator.py:321-375 and the
Young-Daly tests of tests/test_multihost.py:147-186 to ``repro_torch``,
then holds ``repro_torch.runtime.interval`` against the JAX package's
module on the same inputs with exact equality (both are pure Python).
The session feeds its planner where the reference's does: after
``checkpoint``, ``checkpoint_running``, ``checkpoint_finalize`` and a
committed ``frozen()`` dump; an aborted dump feeds nothing.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.runtime import interval as jax_interval
from repro_torch.api import CheckpointOptions, CheckpointSession
from repro_torch.runtime.interval import (IntervalPlanner,
                                          expected_overhead_fraction,
                                          frozen_window_s, young_daly)


def _session(run_dir, planner=None, **opts):
    s = CheckpointSession(run_dir, CheckpointOptions(mode="sync", **opts),
                          device="cpu", planner=planner)
    return s


# ---------------------------------------------------- the session's glue
def test_session_auto_feeds_planner(run_dir):
    """Measured frozen-window cost flows into τ* with no hand-wiring:
    set_planner (or planner=) + checkpoint is all a caller does."""
    state = {"w": torch.ones((64, 64))}
    planner = IntervalPlanner(mtbf_guess_s=3600.0)
    base = planner.interval_s()               # pessimistic 60 s default δ
    s = _session(run_dir, planner)
    s.attach(lambda: {"train_state": state})
    s.checkpoint(1)
    assert len(planner._costs) == 1           # fed by checkpoint()
    with s.frozen(2):
        pass
    assert len(planner._costs) == 2           # fed by frozen() commit
    assert s.frozen_window_s is not None
    assert planner.ckpt_cost_s < 60.0         # not the pessimistic default
    # sub-second measured dumps shrink τ* vs the 60 s prior
    assert planner.interval_s() < base


def test_frozen_abort_does_not_feed_planner(run_dir):
    planner = IntervalPlanner()
    s = _session(run_dir)
    s.set_planner(planner)
    s.attach(lambda: {"train_state": {"w": torch.zeros(4)}})
    with s.frozen(1) as snap:
        snap.abort()
    assert planner._costs == []               # aborted dump: no sample


def test_frozen_exception_does_not_feed_planner(run_dir):
    planner = IntervalPlanner()
    s = _session(run_dir, planner)
    s.attach(lambda: {"train_state": {"w": torch.zeros(4)}})
    with pytest.raises(KeyError):
        with s.frozen(1):
            raise KeyError("job died inside the freeze")
    assert planner._costs == [] and s.latest_step() is None


def test_interval_observe_prefers_blocked_window():
    # async dump: the job was blocked only for locked_total_s
    assert frozen_window_s({"locked_total_s": 0.5, "total_s": 9.0,
                            "frozen_s": 0.2}) == 0.5
    # sync dump: blocked for the whole dump+write
    assert frozen_window_s({"total_s": 3.0, "frozen_s": 0.2}) == 3.0
    assert frozen_window_s({}) is None
    p = IntervalPlanner()
    assert p.observe({"locked_total_s": 1.25}) == 1.25
    assert p._costs == [1.25]
    assert p.observe({}) is None
    assert p._costs == [1.25]


def test_running_and_concurrent_dumps_feed_planner(run_dir):
    """checkpoint_running and checkpoint_finalize feed it too (the
    pre-copy round capture and the soft-freeze validate)."""
    planner = IntervalPlanner()
    state = {"w": torch.ones(256), "b": torch.zeros(8)}
    opts = CheckpointOptions(capture="concurrent", incremental=True)
    s = CheckpointSession(run_dir, opts, device="cpu", planner=planner)
    s.attach(lambda: {"train_state": state})
    s.checkpoint_running(1)
    assert len(planner._costs) == 1
    handle = s.checkpoint_begin(2)
    handle.wait_speculated()
    assert s.checkpoint_finalize() is not None
    assert len(planner._costs) == 2
    assert s.checkpoint_finalize() is None    # nothing in flight
    assert len(planner._costs) == 2


def test_async_session_feeds_blocked_window(run_dir):
    """An async dump feeds its blocked window (locked_total_s), not its
    write."""
    planner = IntervalPlanner()
    s = CheckpointSession(run_dir, CheckpointOptions(mode="async"),
                          device="cpu", planner=planner)
    s.attach(lambda: {"train_state": {"w": torch.ones(1024)}})
    s.checkpoint(1)
    s.wait_pending()
    assert planner._costs == [s.last_stats["locked_total_s"]]


def test_from_engine_and_add_plugin(run_dir):
    """from_engine wraps a built engine; add_plugin registers host state
    that rides in the image."""
    from repro_torch.core.engine import SnapshotEngine
    from repro_torch.core.plugins import CallbackPlugin
    eng = SnapshotEngine(run_dir, options=CheckpointOptions(mode="sync"),
                         device="cpu")
    s = CheckpointSession.from_engine(eng)
    assert s.engine is eng and s.backend_name == "torch"
    assert s.device == torch.device("cpu")
    box = {"v": 7}
    s.add_plugin(CallbackPlugin("cursor", lambda: dict(box),
                                lambda st: box.update(st)))
    planner = IntervalPlanner()
    s.set_planner(planner)
    s.attach(lambda: {"train_state": {"w": torch.arange(4.0)}})
    s.checkpoint(3)
    assert len(planner._costs) == 1
    box["v"] = 0
    s.restore()
    assert box == {"v": 7}


# ------------------------------------------------------------ Young-Daly
def test_young_daly_formula():
    assert young_daly(60.0, 6 * 3600.0) == pytest.approx(
        (2 * 60 * 6 * 3600) ** 0.5)
    # async engine shrinks δ -> τ* shrinks with sqrt(δ)
    assert young_daly(1.0, 6 * 3600.0) == pytest.approx(
        young_daly(100.0, 6 * 3600.0) / 10.0)


def test_overhead_minimised_at_tau_star():
    d, m = 30.0, 4 * 3600.0
    tau = young_daly(d, m)
    f_star = expected_overhead_fraction(tau, d, m)
    for factor in (0.25, 0.5, 2.0, 4.0):
        assert f_star <= expected_overhead_fraction(tau * factor, d, m)


def test_planner_adapts_to_measurements():
    p = IntervalPlanner(mtbf_guess_s=3600.0)
    base = p.interval_s()
    for _ in range(4):
        p.record_checkpoint_cost(1.0)      # async-engine-class cost
    fast = p.interval_s()
    assert fast < base                     # cheaper ckpt -> shorter interval
    # two failures an hour apart -> MTBF measured at 1h
    p.record_failure(1000.0)
    p.record_failure(1000.0 + 3600.0)
    assert p.mtbf_s == pytest.approx(3600.0)
    assert p.steps_between_checkpoints(step_time_s=2.0) >= 1


def test_planner_clamps_interval():
    p = IntervalPlanner(min_interval_s=30, max_interval_s=60)
    p.record_checkpoint_cost(1e-9)
    assert p.interval_s() == 30
    p2 = IntervalPlanner(min_interval_s=30, max_interval_s=60,
                         mtbf_guess_s=1e12)
    p2.record_checkpoint_cost(1e6)
    assert p2.interval_s() == 60


# --------------------------------------------------- parity with the JAX
COSTS = [-1.0, 0.0, 1e-9, 0.25, 1.0, 77.0, 1e6]
MTBFS = [-5.0, 0.0, 1.0, 3600.0, 11.1 * 3600.0, 1e12]


@pytest.mark.parametrize("cost,mtbf", list(itertools.product(COSTS, MTBFS)))
def test_formulas_equal_reference(cost, mtbf):
    assert young_daly(cost, mtbf) == jax_interval.young_daly(cost, mtbf)
    for tau in (-1.0, 0.0, 0.5, 600.0):
        assert expected_overhead_fraction(tau, cost, mtbf) == \
            jax_interval.expected_overhead_fraction(tau, cost, mtbf)


STATS = [{}, {"frozen_s": 0.2}, {"total_s": 3.0, "frozen_s": 0.2},
         {"locked_total_s": 0.5, "total_s": 9.0, "frozen_s": 0.2},
         {"locked_total_s": None, "total_s": 2, "frozen_s": 1}]


@pytest.mark.parametrize("seed", range(4))
def test_planner_equals_reference(seed):
    """The same feed of dump stats, costs and failures gives the same
    cost, MTBF, interval and steps in both packages, after every event."""
    rng = np.random.default_rng(seed)
    kw = dict(mtbf_guess_s=float(rng.uniform(60, 1e5)),
              min_interval_s=float(rng.uniform(0.1, 60)),
              max_interval_s=float(rng.uniform(120, 1e5)))
    ours, ref = IntervalPlanner(**kw), jax_interval.IntervalPlanner(**kw)
    t = 0.0
    for _ in range(40):
        ev = rng.integers(3)
        if ev == 0:
            st = STATS[rng.integers(len(STATS))]
            assert ours.observe(st) == ref.observe(st)
            assert frozen_window_s(st) == jax_interval.frozen_window_s(st)
        elif ev == 1:
            c = float(rng.exponential(5.0))
            ours.record_checkpoint_cost(c)
            ref.record_checkpoint_cost(c)
        else:
            t += float(rng.exponential(1000.0))
            ours.record_failure(t)
            ref.record_failure(t)
        assert ours.ckpt_cost_s == ref.ckpt_cost_s
        assert ours.mtbf_s == ref.mtbf_s
        assert ours.interval_s() == ref.interval_s()
        for step_s in (-1.0, 0.0, 0.01, 0.37, 30.0):
            assert ours.steps_between_checkpoints(step_s) == \
                ref.steps_between_checkpoints(step_s)
