"""Multi-tenant preemption orchestrator in the port: job lifecycle,
scheduler, signals, recovery accounting, the end-to-end cases, and parity
with the JAX package's orchestrator.

Ports every case of tests/test_orchestrator.py but the CLI smoke (the
port has no CLI yet) to ``repro_torch`` at smoke size with
``device="cpu"``; the offline inspection of a run goes through the JAX
package's ``repro jobs``, which reads the port's records.  Then, fed the
same inputs in both packages: scheduler decisions over the same records,
``RecoveryLog`` breakdowns and totals under an injected clock,
``GoodputMeter``, and a ``JobRecord`` written by one package and loaded
by the other.  Last, what the port adds: an evicted, crashed or finished
job's tensors are freed the moment it leaves (no garbage collection
needed), and the default factory needs a card unless given the CPU.
"""
import json
import os
import weakref

import numpy as np
import pytest
import torch

from repro.orchestrator import job as jax_job
from repro.orchestrator import recovery as jax_recovery
from repro.orchestrator import scheduler as jax_scheduler
from repro.orchestrator import signals as jax_signals
from repro_torch.core.device_plugin import flatten_with_paths
from repro_torch.orchestrator import (InvalidTransition, JobRecord, JobSpec,
                                      JobState, Orchestrator,
                                      OrchestratorConfig, Scheduler, Signal,
                                      SignalChannel, list_job_records,
                                      run_scenario)
from repro_torch.orchestrator.recovery import GoodputMeter, RecoveryLog
from repro_torch.orchestrator.workloads import (ServeWorkload, TrainWorkload,
                                                make_workload_factory)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- lifecycle
def test_job_state_machine_legal_path(run_dir):
    rec = JobRecord(JobSpec("j1"), run_dir)
    assert rec.state == JobState.PENDING
    for to in (JobState.RUNNING, JobState.FREEZING, JobState.PREEMPTED,
               JobState.RESTORING, JobState.RUNNING, JobState.DONE):
        rec.transition(to)
    assert rec.terminal
    assert [e["to"] for e in rec.events] == [
        "running", "freezing", "preempted", "restoring", "running", "done"]


def test_job_state_machine_rejects_illegal(run_dir):
    rec = JobRecord(JobSpec("j1"), run_dir)
    with pytest.raises(InvalidTransition):
        rec.transition(JobState.PREEMPTED)     # pending -> preempted
    rec.transition(JobState.RUNNING)
    with pytest.raises(InvalidTransition):
        rec.transition(JobState.RESTORING)     # running -> restoring
    rec.transition(JobState.DONE)
    with pytest.raises(InvalidTransition):
        rec.transition(JobState.RUNNING)       # done is terminal


def test_job_record_persists_and_loads_offline(run_dir):
    rec = JobRecord(JobSpec("alpha", priority=3, total_steps=12,
                            fail_at_step=5), run_dir)
    rec.transition(JobState.RUNNING)
    rec.step = 7
    rec.recovery.open("failure", 1.0, 1.5, 7, 6)
    rec.save()
    # a different process inspects the run dir without the orchestrator
    loaded = list_job_records(run_dir)
    assert len(loaded) == 1
    got = loaded[0]
    assert got.spec.priority == 3 and got.spec.fail_at_step == 5
    assert got.state == JobState.RUNNING and got.step == 7
    assert got.recovery.incidents[0]["cause"] == "failure"
    # the on-disk form is plain JSON (scripting contract)
    raw = json.load(open(os.path.join(run_dir, "jobs", "alpha.json")))
    assert raw["format"] == 1 and raw["spec"]["job_id"] == "alpha"


# --------------------------------------------------------------- signals
def test_signal_channel_delivery_and_handlers():
    ch = SignalChannel()
    seen = []
    ch.register("a", seen.append)
    ch.send("a", Signal.PREEMPT)
    assert seen == [Signal.PREEMPT]           # handler fired at send
    assert ch.pending("a") == Signal.PREEMPT  # peek is non-destructive
    assert ch.checker("a")()
    assert ch.consume("a") == Signal.PREEMPT
    assert ch.pending("a") is None
    assert not ch.checker("b")()


# -------------------------------------------------------------- scheduler
def _recs(*specs):
    return {s.job_id: JobRecord(s) for s in specs}


def test_scheduler_admits_by_priority_then_fifo():
    ch = SignalChannel()
    sched = Scheduler(capacity=2, channel=ch)
    recs = _recs(JobSpec("low", priority=0), JobSpec("hi", priority=9),
                 JobSpec("mid", priority=4))
    d = sched.plan(recs)
    assert d.admit == ["hi", "mid"]           # capacity 2, priority order
    assert d.preempt == []


def test_scheduler_preempts_lowest_priority_victim():
    ch = SignalChannel()
    sched = Scheduler(capacity=2, channel=ch)
    recs = _recs(JobSpec("a", priority=1), JobSpec("b", priority=2))
    for j in ("a", "b"):
        recs[j].transition(JobState.RUNNING)
        sched.allocate(j, 1)
    recs["vip"] = JobRecord(JobSpec("vip", priority=8))
    d = sched.plan(recs)
    assert d.preempt == ["a"]                 # lowest priority evicted
    assert ch.pending("a") == Signal.PREEMPT
    assert ch.pending("b") is None
    # a already-signalled victim is not signalled twice
    assert sched.plan(recs).preempt == []
    # capacity arrives only after the victim acknowledges (freeze+release)
    assert sched.free_capacity() == 0
    sched.release("a")
    recs["a"].transition(JobState.FREEZING)
    recs["a"].transition(JobState.PREEMPTED)
    assert sched.plan(recs).admit == ["vip"]


def test_scheduler_never_preempts_equal_or_higher_priority():
    ch = SignalChannel()
    sched = Scheduler(capacity=1, channel=ch)
    recs = _recs(JobSpec("a", priority=5))
    recs["a"].transition(JobState.RUNNING)
    sched.allocate("a", 1)
    recs["same"] = JobRecord(JobSpec("same", priority=5))
    d = sched.plan(recs)
    assert d.preempt == [] and d.admit == []


def test_scheduler_respects_arrival_tick():
    ch = SignalChannel()
    sched = Scheduler(capacity=1, channel=ch)
    recs = _recs(JobSpec("late", priority=9, arrive_tick=5))
    assert sched.plan(recs, tick=0).admit == []
    assert sched.plan(recs, tick=5).admit == ["late"]


# ------------------------------------------------------------- accounting
def test_recovery_log_phase_breakdown():
    log = RecoveryLog()
    log.open("failure", t_interrupt=10.0, t_detect=10.5,
             step_at_interrupt=9, last_ckpt_step=6)
    log.mark_scheduled(11.0)
    log.mark_restored(11.7, restored_step=6, read_s=0.6)
    log.mark_caught_up(12.9)
    (b,) = log.breakdown()
    assert b["detect_s"] == pytest.approx(0.5)
    assert b["schedule_s"] == pytest.approx(0.5)
    assert b["restore_s"] == pytest.approx(0.7)
    assert b["replay_s"] == pytest.approx(1.2)
    assert b["total_s"] == pytest.approx(2.9)
    assert b["steps_replayed"] == 3
    assert b["meta"]["read_s"] == 0.6
    assert log.totals()["incidents"] == 1


def test_goodput_counts_replayed_steps_once():
    m = GoodputMeter()
    m.record_slice(0, 4, wall_s=4.0)          # steps 0..4
    m.record_slice(2, 6, wall_s=4.0)          # restored to 2, replay 2
    assert m.steps_executed == 8
    assert m.useful_steps == 6
    assert m.useful_step_seconds() == pytest.approx(6.0)
    assert m.goodput(12.0) == pytest.approx(0.5)


# ------------------------------------------------------------ end-to-end
def _digests(summary):
    return {j: v["digest"] for j, v in summary["jobs"].items()}


def _undisturbed(cls, kind, total, run_dir, **kw):
    ref = cls(JobSpec("ref", kind=kind, total_steps=total), run_dir,
              device="cpu", **kw)
    ref.start()
    while not ref.done:
        ref.run_slice(2)
    ref.finish()
    return ref.digest()


def test_preemption_recovers_bit_exact(tmp_path):
    """Low-priority training job preempted mid-run by a high-priority job,
    checkpoints on signal, reschedules, restores, and finishes with
    bit-exact train state vs an unpreempted run."""
    total = 6
    summary = run_scenario("preemption", str(tmp_path / "orch"),
                           device="cpu", total_steps=total)
    assert summary["all_done"]
    lo = summary["jobs"]["lo"]
    assert lo["step"] == total and lo["restarts"] >= 1
    (inc,) = [i for i in lo["recovery"] if i["cause"] == "preemption"]
    assert inc["total_s"] is not None         # closed incident
    assert _digests(summary)["lo"] == _undisturbed(
        TrainWorkload, "train", total, str(tmp_path / "ref"))
    assert summary["jobs"]["hi"]["state"] == "done"


def test_failure_detected_and_recovered_with_breakdown(tmp_path):
    summary = run_scenario("failure", str(tmp_path / "orch"), device="cpu",
                           total_steps=6)
    assert summary["all_done"]
    j = summary["jobs"]["crashy"]
    assert j["restarts"] == 1
    (inc,) = j["recovery"]
    assert inc["cause"] == "failure"
    # all four phases measured (heartbeat detection costs the deadline)
    for phase in ("detect_s", "schedule_s", "restore_s", "replay_s"):
        assert inc[phase] is not None and inc[phase] >= 0.0
    assert inc["detect_s"] > 0.0
    assert inc["steps_replayed"] >= 0
    # the records are inspectable offline after the orchestrator exits,
    # by the JAX package's CLI (the record format is shared)
    from repro.cli import main
    assert main(["jobs", str(tmp_path / "orch")]) == 0
    assert main(["jobs", str(tmp_path / "orch"), "--job", "crashy"]) == 0


def test_serve_job_preempted_and_resumed_token_exact(tmp_path):
    total = 6
    summary = run_scenario("preemption", str(tmp_path / "orch"),
                           device="cpu", total_steps=total, kind="serve")
    assert summary["all_done"]
    assert summary["jobs"]["lo"]["restarts"] >= 1
    assert _digests(summary)["lo"] == _undisturbed(
        ServeWorkload, "serve", total, str(tmp_path / "ref"))


def test_interception_scenario_runs(tmp_path):
    """The baseline engine rides the same lifecycle: checkpoint = replay
    log, restore = re-execution."""
    summary = run_scenario("failure", str(tmp_path / "orch"), device="cpu",
                           total_steps=8, kind="intercept")
    assert summary["all_done"]
    j = summary["jobs"]["crashy"]
    assert j["restarts"] == 1 and j["step"] == 8


def test_run_scenario_refuses_stale_run_dir(tmp_path):
    """Re-running into a run_dir with previous job records would restore
    from another run's images — it must be rejected, not silently mixed."""
    d = str(tmp_path / "orch")
    run_scenario("failure", d, device="cpu", total_steps=6,
                 kind="intercept")
    with pytest.raises(ValueError, match="fresh run_dir"):
        run_scenario("failure", d, device="cpu", total_steps=4,
                     kind="intercept")


def test_orchestrator_rejects_impossible_device_demand(tmp_path):
    with pytest.raises(ValueError, match="never be scheduled"):
        Orchestrator(str(tmp_path), [JobSpec("big", devices=4)],
                     config=OrchestratorConfig(capacity=2), device="cpu")


# ----------------------------------------------------- write_error abort
def test_write_error_aborts_trainer_promptly(tmp_path, monkeypatch):
    from repro_torch.api import CheckpointOptions, SnapshotWriteFailed
    from repro_torch.configs import get_smoke_config
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    tcfg = TrainConfig(batch_size=2, seq_len=32, total_steps=64,
                       warmup_steps=2, compute_dtype=torch.float32,
                       remat=False, ckpt=CheckpointOptions(mode="async"))
    t = Trainer(get_smoke_config("qwen1.5-0.5b"), tcfg,
                str(tmp_path / "r"), device="cpu")
    t.initialize()
    t.run(2)
    monkeypatch.setattr(t.engine, "_write",
                        lambda ctx: (_ for _ in ()).throw(
                            IOError("disk gone")))
    t.session.checkpoint(t.step)              # async dump fails in the bg
    t.engine._pending.join()                  # failure has landed
    with pytest.raises(SnapshotWriteFailed, match="disk gone"):
        t.run(4)                              # aborts at the next step,
    assert t.step <= 3                        # not at the next dump


def test_write_error_marks_job_failed_in_orchestrator(tmp_path):
    from repro_torch.api import CheckpointOptions

    base = str(tmp_path / "orch")
    inner = make_workload_factory(base,
                                  options=CheckpointOptions(mode="async"),
                                  device="cpu")

    def factory(spec, attempt):
        wl = inner(spec, attempt)
        wl.session.engine._write = lambda ctx: (_ for _ in ()).throw(
            IOError("dead disk"))
        return wl

    spec = JobSpec("doomed", total_steps=16, ckpt_every=2, max_restarts=0)
    orch = Orchestrator(base, [spec], workload_factory=factory,
                        config=OrchestratorConfig(capacity=1,
                                                  slice_steps=2))
    summary = orch.run()
    j = summary["jobs"]["doomed"]
    assert j["state"] == "failed"
    assert any(i["cause"] == "write_error" for i in j["recovery"])
    # the record on disk says why (offline triage)
    rec = list_job_records(base)[0]
    assert any("write_error" in e for e in rec.events)


# ------------------------------------------------- lazy restore incidents
def test_preemption_with_lazy_restore_bit_exact_and_phase_split(tmp_path):
    """The preemption scenario on a lazy (resume-before-read) engine:
    recovery is still bit-exact vs an undisturbed run, and the incident's
    restore splits into restore-critical (the resume point) vs
    restore-background (the streamed cold tail, overlapping replay)."""
    from repro_torch.api import CheckpointOptions
    total = 6
    opts = CheckpointOptions(restore_mode="lazy")
    summary = run_scenario("preemption", str(tmp_path / "orch"),
                           options=opts, device="cpu", total_steps=total)
    assert summary["all_done"]
    lo = summary["jobs"]["lo"]
    assert lo["step"] == total and lo["restarts"] >= 1
    (inc,) = [i for i in lo["recovery"] if i["cause"] == "preemption"]
    assert inc["total_s"] is not None
    assert inc["restore_s"] is not None                # critical resume
    assert inc["restore_critical_s"] == inc["restore_s"]
    assert inc["meta"].get("restore_mode") == "lazy"
    # the background stream was joined and accounted
    assert inc["restore_background_s"] is not None
    assert inc["restore_background_s"] >= 0.0
    assert lo["recovery_totals"]["restore_background_s"] >= 0.0
    # bit-exact vs an undisturbed run on an eager engine
    assert _digests(summary)["lo"] == _undisturbed(
        TrainWorkload, "train", total, str(tmp_path / "ref"))


# ------------------------------------------- parity with the JAX package
def _jax_recs(specs):
    return {s.job_id: jax_job.JobRecord(jax_job.JobSpec(**s.to_dict()))
            for s in specs}


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_decisions_equal_reference(seed):
    """Random job sets and random lifecycle moves, applied to both
    packages' records: every planning round admits and preempts the same
    jobs, sends the same signals and leaves the same allocations."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 5))
    specs = [JobSpec(f"j{i}", priority=int(rng.integers(0, 4)),
                     devices=int(rng.integers(1, cap + 1)),
                     arrive_tick=int(rng.integers(0, 4)),
                     max_restarts=int(rng.integers(0, 3)))
             for i in range(int(rng.integers(3, 8)))]
    ours_ch, ref_ch = SignalChannel(), jax_signals.SignalChannel()
    ours, ref = Scheduler(cap, ours_ch), jax_scheduler.Scheduler(cap, ref_ch)
    recs = {s.job_id: JobRecord(s) for s in specs}
    jrecs = _jax_recs(specs)
    for tick in range(12):
        d, jd = ours.plan(recs, tick), ref.plan(jrecs, tick)
        assert (d.admit, d.preempt) == (jd.admit, jd.preempt), tick
        assert [(j, s.value) for j, s in ours_ch.sent] == \
            [(j, s.value) for j, s in ref_ch.sent]
        for j in d.admit:                      # the orchestrator's moves
            for s, r in ((ours, recs[j]), (ref, jrecs[j])):
                s.allocate(j, r.spec.devices)
                if r.state != JobState.PENDING:
                    r.transition(type(r.state)("restoring"))
                r.transition(type(r.state)("running"))
        for j in d.preempt:                    # victims freeze and yield
            for s, r in ((ours, recs[j]), (ref, jrecs[j])):
                r.transition(type(r.state)("freezing"))
                r.transition(type(r.state)("preempted"))
                s.release(j)
        running = sorted(j for j, r in recs.items()
                         if r.state == JobState.RUNNING)
        if running and rng.random() < 0.4:     # one finishes or crashes
            j = running[int(rng.integers(len(running)))]
            to = "done" if rng.random() < 0.5 else "failed"
            for s, r in ((ours, recs[j]), (ref, jrecs[j])):
                r.transition(type(r.state)(to))
                s.release(j)
        assert ours.allocations == ref.allocations
        assert ours.free_capacity() == ref.free_capacity()


def _clock(times):
    it = iter(times)
    return lambda: next(it)


@pytest.mark.parametrize("seed", range(4))
def test_recovery_log_equals_reference(seed):
    """The same incidents, marked at the same (injected) times, give the
    same breakdown and totals in both packages."""
    rng = np.random.default_rng(seed)
    logs = (RecoveryLog(job_id="j"), jax_recovery.RecoveryLog(job_id="j"))
    t = 0.0
    for n in range(int(rng.integers(1, 5))):
        t += float(rng.exponential(3.0))
        ti, td = t, t + float(rng.exponential(0.2))
        step = int(rng.integers(4, 40))
        last = int(rng.integers(0, step + 1))
        marks = [("open", rng.choice(["failure", "preemption",
                                      "migration"]))]
        tt = td
        if rng.random() < 0.5:
            a, b = tt, tt + float(rng.exponential(1.0))
            rounds = [{"round": 0, "bytes_sent": int(rng.integers(1e6)),
                       "wall_s": b - a, "residual": True}]
            marks.append(("transfer", a, b, rounds))
            tt = b
        tt += float(rng.exponential(0.5))
        marks.append(("scheduled", tt))
        tt += float(rng.exponential(1.0))
        marks.append(("restored", tt, last))
        if rng.random() < 0.5:
            marks.append(("materialized",
                          tt + float(rng.exponential(0.5))))
        if n < 3 or rng.random() < 0.5:       # the last may stay open
            marks.append(("caught_up", tt + float(rng.exponential(2.0))))
        for log in logs:
            for m in marks:
                if m[0] == "open":
                    log.open(str(m[1]), ti, td, step, last)
                elif m[0] == "transfer":
                    log.mark_transfer(m[1], m[2], rounds=m[3],
                                      bytes_sent=m[3][0]["bytes_sent"])
                elif m[0] == "scheduled":
                    log.mark_scheduled(m[1])
                elif m[0] == "restored":
                    log.mark_restored(m[1], restored_step=m[2], read_s=0.5)
                elif m[0] == "materialized":
                    log.mark_materialized(m[1])
                else:
                    log.mark_caught_up(m[1])
        t = tt + 5.0
    assert logs[0].breakdown() == logs[1].breakdown()
    assert logs[0].totals() == logs[1].totals()
    assert logs[0].to_list() == logs[1].to_list()


@pytest.mark.parametrize("seed", range(4))
def test_goodput_meter_equals_reference(seed):
    rng = np.random.default_rng(seed)
    ours, ref = GoodputMeter(), jax_recovery.GoodputMeter()
    step = 0
    for _ in range(20):
        start = max(0, step - int(rng.integers(0, 4)))  # replay after restore
        end = start + int(rng.integers(0, 5))
        wall = float(rng.exponential(0.3))
        ours.record_slice(start, end, wall)
        ref.record_slice(start, end, wall)
        step = max(step, end)
        for w in (0.0, 1.0, float(rng.exponential(20.0))):
            assert ours.goodput(w) == ref.goodput(w)
        assert ours.useful_step_seconds() == ref.useful_step_seconds()
        assert ours.to_dict() == ref.to_dict()


def _record(pkg_job, run_dir, clock):
    spec = pkg_job.JobSpec("alpha", kind="serve", priority=3, total_steps=12,
                           ckpt_every=2, fail_at_step=5, migrate_at_step=7)
    rec = pkg_job.JobRecord(spec, run_dir, clock=clock)
    rec.transition(pkg_job.JobState.RUNNING)
    rec.step, rec.host, rec.last_ckpt_step = 7, "host01", 6
    rec.recovery.open("failure", 1.0, 1.5, 7, 6)
    rec.recovery.mark_scheduled(2.0)
    rec.recovery.mark_restored(2.5, restored_step=6, read_s=0.25)
    rec.recovery.mark_caught_up(3.0)
    rec.goodput.record_slice(0, 7, 1.75)
    rec.transition(pkg_job.JobState.DONE)
    return rec


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_job_record_crosses_packages(writer, tmp_path):
    """A record written by one package loads in the other with every
    field; both packages write the same JSON for the same job."""
    import repro_torch.orchestrator.job as port_job
    clock = _clock([10.0 + i for i in range(20)])
    pkgs = {"port": port_job, "jax": jax_job}
    d = str(tmp_path / writer)
    wrote = _record(pkgs[writer], d, clock)
    reader = pkgs["jax" if writer == "port" else "port"]
    got = reader.list_job_records(d)
    assert len(got) == 1 and got[0].to_dict() == wrote.to_dict()
    assert got[0].state.value == "done" and got[0].host == "host01"
    assert got[0].recovery.breakdown() == wrote.recovery.breakdown()
    other = str(tmp_path / "other")
    _record(reader, other, _clock([10.0 + i for i in range(20)]))
    assert json.load(open(os.path.join(d, "jobs", "alpha.json"))) == \
        json.load(open(os.path.join(other, "jobs", "alpha.json")))


# ----------------------------------------------- device memory on leave
def _tensor_refs(wl):
    if hasattr(wl, "trainer"):
        tree = {"p": wl.trainer.params, "o": wl.trainer.opt_state}
    elif hasattr(wl, "server"):
        tree = {"p": wl.server.params, "c": wl.server.cache}
    else:
        tree = {"w": wl.w}
    return [weakref.ref(t) for t in flatten_with_paths(tree).values()
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_leaving_jobs_free_their_tensors(kind, tmp_path, monkeypatch):
    """The preempted, crashed and finished jobs of the mixed scenario
    free every param, optimizer and cache tensor the moment the
    orchestrator drops them, without a garbage collection (the reference
    cycle through the session is cut by ``release``)."""
    import gc
    left = []
    drop = Orchestrator._drop

    def checked_drop(self, job_id):
        wl = self.workloads.get(job_id)
        if wl is None:                         # dropped already (crash)
            return drop(self, job_id)
        refs = _tensor_refs(wl)
        drop(self, job_id)
        left.append((job_id, self.records[job_id].state.value,
                     len(refs), sum(r() is not None for r in refs)))

    monkeypatch.setattr(Orchestrator, "_drop", checked_drop)
    gc.disable()
    try:
        summary = run_scenario("mixed", str(tmp_path / "orch"),
                               device="cpu", total_steps=6, kind=kind)
    finally:
        gc.enable()
    assert summary["all_done"]
    states = {s for _, s, _, _ in left}
    assert {"preempted", "running", "done"} <= states, left
    assert all(n > 0 and alive == 0 for _, _, n, alive in left), left


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the factory would run")
def test_default_factory_needs_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        make_workload_factory(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        Orchestrator(str(tmp_path), [JobSpec("a")])
