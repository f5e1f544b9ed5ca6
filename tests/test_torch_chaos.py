"""The port's chaos layer (``repro_torch.chaos``) against the JAX
package's, on the CPU.

Fed the same seeds, both packages plan the same fault events, and their
survivability campaigns give the same fingerprint, per-class rows and
per-job outcomes and digests (``device="cpu"`` steps the sim with
``np.sin`` on the tensor's numpy view, so the digests are the reference's
bits).  Ports of tests/test_chaos.py (the hook plane inert, install
exclusive, the plan's rules, the small campaign's invariant, same seed /
different seed) and of the concurrent-capture cases the chaos planner
and injector rest on (tests/test_concurrent_capture.py:241, :320): the
mutation storm on torch CPU tensors, and ``dirty_burst`` flipping a byte
of a live tensor and reverting it at the validate pause.  Last: with no
card, ``run_campaign()`` and ``chaos-campaign`` without ``--device``
refuse to run.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.chaos import campaign as jax_campaign
from repro.chaos import plan as jax_plan
from repro.chaos.sim import reference_digest as jax_reference_digest
from repro.orchestrator.job import JobSpec as JaxJobSpec
from repro_torch.chaos import hooks
from repro_torch.chaos.campaign import run_campaign
from repro_torch.chaos.injector import FaultInjector
from repro_torch.chaos.plan import (FAULT_CLASSES, ChaosConfig, FaultEvent,
                                    generate_plan, parse_fault_spec)
from repro_torch.chaos.sim import (SimWorkload, _sim_step, make_sim_factory,
                                   reference_digest)
from repro_torch.orchestrator.job import JobSpec

STABLE = ("planned", "targets", "injected", "recovered", "healed",
          "quarantined")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- hook plane
def test_hooks_inert_without_injector(tmp_path):
    """No injector -> INJECTOR is None, a sim job runs to its bit-exact
    reference digest (the JAX package's, on the CPU) through the dump /
    restore stack, and no stat mentions chaos."""
    assert hooks.INJECTOR is None
    assert hooks.fire("pack.chunk", anything=1) is None
    spec = JobSpec("solo", kind="sim", total_steps=6, ckpt_every=2)
    wl = SimWorkload(spec, str(tmp_path / "job"), device="cpu")
    wl.start()
    while not wl.done:
        wl.run_slice(2)
    wl.checkpoint(wl.step)
    wl.finish()
    assert wl.digest() == reference_digest(spec, "cpu") == \
        jax_reference_digest(JaxJobSpec("solo", kind="sim", total_steps=6,
                                        ckpt_every=2))
    assert not any("chaos" in k for k in wl.session.last_stats)
    r = SimWorkload(spec, str(tmp_path / "job"), device="cpu")
    assert r.restore() == 6
    assert r.digest() == wl.digest()
    assert not any("chaos" in k for k in r.session.last_stats)
    r.release()
    assert r.vec is None


def test_sim_step_on_the_cpu_is_numpys():
    from repro.chaos.sim import _init_vec, _sim_step as jax_step
    a = _init_vec("j000")
    t = torch.from_numpy(a.copy())
    for step in range(12):
        a = jax_step(a, step)
        t = _sim_step(t, step)
        assert t.dtype == torch.float64
        np.testing.assert_array_equal(t.numpy(), a)


def test_install_is_exclusive():
    class _Stub:
        def on(self, site, **ctx):
            return None

    hooks.install(_Stub())
    try:
        with pytest.raises(RuntimeError, match="already installed"):
            hooks.install(_Stub())
    finally:
        hooks.uninstall()
    assert hooks.INJECTOR is None


# ------------------------------------------------------------ fault plan
@pytest.mark.parametrize("spec", ["all=1", "all=2", "all=1,exhaust=0",
                                  "host_kill=3,torn_write=1", ""])
def test_parse_fault_spec_matches_reference(spec):
    assert parse_fault_spec(spec) == jax_plan.parse_fault_spec(spec)
    assert FAULT_CLASSES == jax_plan.FAULT_CLASSES
    with pytest.raises(ValueError, match="unknown fault class"):
        parse_fault_spec("rowhammer=1")


def _specs(mod, n, max_restarts=6):
    return [mod(f"j{i:03d}", kind="sim", total_steps=12, ckpt_every=3,
                max_restarts=max_restarts) for i in range(n)]


def _events(plan):
    return [(e.kind, e.job_id, e.at_step, e.seq, e.detail)
            for e in plan.events]


# (seed, jobs, hosts, fault spec, max_restarts): the plans of
# tests/test_chaos.py:87-124 and tests/test_concurrent_capture.py:320
PLAN_CASES = [(11, 20, 4, "all=1", 6), (12, 20, 4, "all=1", 6),
              (3, 30, 4, "all=2", 6),
              (3, 10, 1, "eviction_wall=2,host_kill=1", 6),
              (5, 2, 2, "host_kill=6", 2), (9, 20, 4, "all=2", 6),
              (0, 100, 20, "all=1", 6)]


@pytest.mark.parametrize("seed,n,hosts,spec,budget", PLAN_CASES)
def test_generate_plan_matches_reference(seed, n, hosts, spec, budget):
    ours = generate_plan(seed, _specs(JobSpec, n, budget), hosts,
                         parse_fault_spec(spec))
    ref = jax_plan.generate_plan(seed, _specs(JaxJobSpec, n, budget), hosts,
                                 jax_plan.parse_fault_spec(spec))
    assert _events(ours) == _events(ref) and ours.events
    assert ours.counts == ref.counts


def test_generate_plan_rules():
    """tests/test_chaos.py's plan rules, on the port's planner."""
    a = generate_plan(11, _specs(JobSpec, 20), 4, parse_fault_spec("all=1"))
    c = generate_plan(12, _specs(JobSpec, 20), 4, parse_fault_spec("all=1"))
    assert [(e.kind, e.job_id) for e in a.events] != \
        [(e.kind, e.job_id) for e in c.events]
    plan = generate_plan(3, _specs(JobSpec, 30), 4, parse_fault_spec("all=2"))
    exhaust = set(plan.targets("exhaust"))
    assert all(ev.job_id not in exhaust for ev in plan.events
               if ev.kind != "exhaust")
    for cls in FAULT_CLASSES:
        assert len(plan.events_for(cls)) == 2, cls
    single = generate_plan(3, _specs(JobSpec, 10), 1,
                           parse_fault_spec("eviction_wall=2,host_kill=1"))
    assert single.events_for("eviction_wall") == []
    capped = generate_plan(5, _specs(JobSpec, 2, max_restarts=2), 2,
                           parse_fault_spec("host_kill=6"))
    assert len(capped.events_for("host_kill")) == 2
    burst = generate_plan(9, _specs(JobSpec, 20), 4, parse_fault_spec("all=2"))
    non_inc = set(burst.targets("torn_write")) | set(
        burst.targets("fsync_drop"))
    assert len(burst.events_for("dirty_burst")) == 2
    assert all(ev.job_id not in non_inc
               for ev in burst.events_for("dirty_burst"))


# -------------------------------------------------------------- campaign
# (jobs, hosts, seed, faults, capture): the reference tests' sizes and
# the README's fleet (sync)
CAMPAIGNS = {"8x3-sync": (8, 3, 7, "all=1", "sync"),
             "8x3-concurrent": (8, 3, 7, "all=1", "concurrent"),
             "100x20-sync": (100, 20, 0, "all=1", "sync")}


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """Each campaign of CAMPAIGNS run once by each package."""
    out = {}
    for name, (jobs, hosts, seed, faults, capture) in CAMPAIGNS.items():
        base = tmp_path_factory.mktemp(name)
        kw = dict(jobs=jobs, hosts=hosts, seed=seed, faults=faults,
                  capture=capture)
        out[name] = (run_campaign(str(base / "port"), device="cpu", **kw),
                     jax_campaign.run_campaign(str(base / "jax"), **kw))
    return out


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_campaign_matches_reference(campaigns, name):
    ours, ref = campaigns[name]
    assert ours.ok and ref.ok, (ours.violations, ref.violations)
    assert ours.fingerprint() == ref.fingerprint()
    assert ours.outcomes == ref.outcomes and ours.digests == ref.digests
    assert {c: {k: r[k] for k in STABLE} for c, r in ours.rows.items()} == \
        {c: {k: r[k] for k in STABLE} for c, r in ref.rows.items()}
    assert ours.planned == ref.planned
    if CAMPAIGNS[name][4] == "concurrent":
        assert ours.rows["dirty_burst"]["injected"] == 1


def test_small_campaign_invariant_holds(campaigns):
    """tests/test_chaos.py::test_small_campaign_invariant_holds."""
    report, _ = campaigns["8x3-sync"]
    assert report.ok, report.violations
    for cls, row in report.rows.items():
        assert row["injected"] == row["planned"], cls
    assert report.rows["exhaust"]["quarantined"] == 1
    assert report.rows["exhaust"]["recovered"] == 0
    for cls, row in report.rows.items():
        if cls != "exhaust":
            assert row["recovered"] == row["targets"], cls
    assert report.rows["cas_corrupt"]["healed"] >= 1
    done = [j for j, o in report.outcomes.items() if o == "recovered"]
    assert len(done) == 8 - 1


def test_report_surfaces(campaigns):
    report, ref = campaigns["8x3-sync"]
    d = report.to_dict()
    assert d["fingerprint"] == report.fingerprint() and d["ok"]
    assert json.loads(json.dumps(d, default=str))["rows"].keys() == \
        ref.to_dict()["rows"].keys()
    table = report.table_markdown()
    assert "**invariant held**" in table and "| exhaust | 1/1 |" in table
    timed = ("wall_s", "mttr_s")
    assert {k: v for k, v in report.metrics().items()
            if not k.endswith(timed)} == \
        {k: v for k, v in ref.metrics().items() if not k.endswith(timed)}


def test_same_seed_reproduces_identical_fingerprint(tmp_path):
    """tests/test_chaos.py::test_same_seed_reproduces_identical_fingerprint
    (seed 21 equal to the reference's too)."""
    kw = dict(jobs=5, hosts=2, seed=21,
              faults="commit_kill=1,signal_dup=1,host_kill=1")
    a = run_campaign(str(tmp_path / "a"), device="cpu", **kw)
    b = run_campaign(str(tmp_path / "b"), device="cpu", **kw)
    assert a.ok and b.ok
    assert a.fingerprint() == b.fingerprint()
    assert a.outcomes == b.outcomes and a.digests == b.digests
    c = run_campaign(str(tmp_path / "c"), device="cpu", **dict(kw, seed=22))
    assert c.fingerprint() != a.fingerprint()
    ref = jax_campaign.run_campaign(str(tmp_path / "ref"), **kw)
    assert ref.fingerprint() == a.fingerprint()


# ----------------------------------------- concurrent capture + dirty_burst
def _concurrent_session(run_dir, state):
    from repro_torch.api import CheckpointOptions, CheckpointSession
    sess = CheckpointSession(run_dir, CheckpointOptions(
        incremental=True, capture="concurrent"), device="cpu")
    sess.attach(lambda: {"state": state})
    return sess


def test_mutation_storm_commit_never_torn(tmp_path):
    """tests/test_concurrent_capture.py::test_mutation_storm_commit_never_torn
    on torch CPU tensors: every entry mutated (in place through the
    stream set, or rebound) while the capture is open; the image equals
    the live tree at finalize, entry for entry."""
    from repro_torch.api import CheckpointOptions, CheckpointSession
    from repro_torch.core.streams import StreamOp, StreamSet
    g = torch.Generator().manual_seed(0)
    state = {f"w{i}": torch.randn(32 * 128, generator=g) for i in range(10)}
    c = _concurrent_session(str(tmp_path / "c"), state)
    streams = StreamSet()
    c.engine.device_plugin.attach_streams(streams)
    handle = c.checkpoint_begin(1)
    assert handle.wait_speculated(60.0), "speculation hung"
    for i, k in enumerate(list(state)):
        if i % 2:
            state[k] = state[k] * -1.0                 # rebind
        else:
            t = state[k]
            streams.enqueue("compute", StreamOp(
                "dispatch", targets=(f"state::{k}",),
                apply=lambda t=t, s=i: t.fill_(float(s))))
    c.checkpoint_finalize()
    assert c.last_stats["recaptured_entries"] == len(state)
    r = CheckpointSession(str(tmp_path / "c"), CheckpointOptions(),
                          device="cpu")
    r.attach(lambda: {"state": None})
    restored = r.restore()["state"]
    for k, v in state.items():
        assert torch.equal(restored[k], v), k


def test_dirty_burst_flips_a_live_tensor_and_reverts_it(tmp_path):
    """The injector's dirty_burst on a torch tensor: one byte flipped in
    place mid-speculation and noted, reverted at the validate site; the
    speculated copy is stale, so the validate pause re-captures it, and
    the committed image equals the unmutated state."""
    g = torch.Generator().manual_seed(1)
    state = {"a": torch.randn(4096, dtype=torch.float64, generator=g),
             "b": torch.randn(512, generator=g)}
    before = {k: v.clone() for k, v in state.items()}
    ev = FaultEvent(kind="dirty_burst", job_id="jb", at_step=1, seq=0)
    inj = FaultInjector(ChaosConfig(seed=0, hosts=1,
                                    counts={"dirty_burst": 1}, events=[ev]))
    c = _concurrent_session(str(tmp_path / "c"), state)
    with inj.installed():
        inj.on("sim.checkpoint", job_id="jb", step=1)
        c.checkpoint(1)
    assert ev.state == "injected" and "mutated" not in ev.detail
    (rec,) = inj.injections
    assert rec["kind"] == "dirty_burst" and rec["device"] == "cpu"
    assert rec["key"] in ("state::a", "state::b")
    assert c.last_stats["recaptured_entries"] >= 1
    for k in state:
        assert torch.equal(state[k], before[k]), k
    r = _concurrent_session(str(tmp_path / "c"), None)
    restored = r.restore()["state"]
    for k in state:
        assert torch.equal(restored[k], before[k]), k


def test_dirty_burst_skips_a_non_contiguous_leaf():
    ev = FaultEvent(kind="dirty_burst", job_id="jb", at_step=1, seq=0)
    inj = FaultInjector(ChaosConfig(seed=0, hosts=1,
                                    counts={"dirty_burst": 1}, events=[ev]))
    inj.current_job, inj.current_ckpt_step = "jb", 1
    leaf = torch.arange(16.0).reshape(4, 4).t()
    noted = []
    inj.on("engine.speculate", key="k", leaf=leaf, note=noted.append)
    assert ev.state == "pending" and noted == []
    assert torch.equal(leaf, torch.arange(16.0).reshape(4, 4).t())


# ------------------------------------------------------------ the device
def test_factory_sims_live_on_the_given_device(tmp_path):
    spec = JobSpec("jd", kind="sim", total_steps=4, ckpt_every=2)
    wl = make_sim_factory(str(tmp_path), device="cpu")(spec, 0)
    wl.start()
    assert wl.vec.device.type == "cpu" and wl.vec.dtype == torch.float64
    assert wl.session.options.replicate_to.endswith("job_jd_replica")
    assert dataclasses.asdict(wl.session.options.transfer_policy)["mode"] \
        == "delta"


def test_no_card_no_campaign(tmp_path, capsys):
    """Without a card and without device="cpu" the campaign refuses to
    run: no quiet move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.cli import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_campaign(str(tmp_path / "f"), jobs=2, hosts=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sim_factory(str(tmp_path / "g"))
    assert main(["chaos-campaign", str(tmp_path / "cli"),
                 "--jobs", "2", "--hosts", "1"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "cli" / "jobs").exists()
