"""Orchestrator — the event loop that drives preemption and recovery.

One process plays the cluster: a priority :class:`Scheduler` over
simulated device capacity, a :class:`SignalChannel` for SIGTERM-style
preemption, ``FailureDetector`` heartbeats for crash detection,
per-job ``StragglerMonitor`` JIT-checkpoint triggers, and per-job
``IntervalPlanner`` τ* cadence (auto-fed from measured frozen windows via
``CheckpointSession.set_planner``).  Jobs run cooperatively in slices —
each tick gives every running job up to ``slice_steps`` steps, with the
preemption predicate checked between steps so a signal lands mid-run.

The lifecycle per interruption (the paper's recovery story, measured):

    signal/crash -> detect -> [RecoveryLog] -> reschedule -> restore
    (image read) -> replay to the interrupted step -> caught up

Every transition persists the job's JSON record (the JAX package's
format), so ``python -m repro jobs RUN_DIR`` inspects a (possibly dead)
cluster offline.

The port's differences: the default workload factory runs on ``device``
(``cuda`` unless the caller passes ``"cpu"``), and a job that leaves the
device (evicted after a preemption or a migration, crashed, failed or
done) has its workload *released*: its device tensors are dropped at
once, so the next tenant gets the memory back (under JAX the buffers go
with the last reference; a torch trainer is kept alive by reference
cycles through its session).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.api.options import TransferPolicy
from repro_torch.chaos import hooks as chaos_hooks
from repro_torch.obs import trace as obs_trace
from repro_torch.orchestrator.job import JobRecord, JobSpec, JobState
from repro_torch.orchestrator.scheduler import Scheduler
from repro_torch.orchestrator.signals import Signal, SignalChannel
from repro_torch.orchestrator.workloads import make_workload_factory
from repro_torch.runtime.fault import FailureDetector, StragglerMonitor
from repro_torch.runtime.interval import IntervalPlanner


@dataclasses.dataclass
class OrchestratorConfig:
    capacity: int = 2               # simulated device slots
    slice_steps: int = 2            # steps per job per tick
    heartbeat_deadline_s: float = 0.05
    max_ticks: int = 10_000
    mtbf_guess_s: float = 3600.0    # planner prior per job
    planner_min_interval_s: float = 0.5
    jit_cooldown_steps: int = 8
    idle_sleep_s: float = 0.005     # when a tick ran nothing (await detect)
    hosts: int = 1                  # simulated hosts (job dirs per host)
    transfer_policy: Optional[TransferPolicy] = None   # None: delta


@dataclasses.dataclass
class MigrationPlan:
    """One planned live migration: checkpoint the job on its current
    host, delta-transfer the image to another host's store, restore it
    there.  Driven by ``JobSpec.migrate_at_step``.

    Stop-and-copy state walk: pending → signalled → transferred (or
    failed).  With a pre-copy policy (``TransferPolicy.precopy_rounds``)
    an extra live phase slots in — pending → **precopy** (budget-driven
    delta rounds while the job keeps stepping, each appended to
    ``rounds``) → signalled (the convergence controller called freeze or
    fallback; ``outcome`` records which) → transferred/failed."""
    job_id: str
    at_step: int
    src_host: Optional[str] = None
    dst_host: Optional[str] = None
    state: str = "pending"
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    rounds: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    outcome: Optional[str] = None   # "converged" | "fallback" | None


class Orchestrator:
    def __init__(self, run_dir: str, specs: List[JobSpec],
                 workload_factory: Optional[Callable] = None,
                 config: Optional[OrchestratorConfig] = None,
                 options=None, device=None,
                 clock: Callable[[], float] = time.perf_counter):
        self.run_dir = run_dir
        self.cfg = config or OrchestratorConfig()
        self.clock = clock
        self.factory = workload_factory or make_workload_factory(
            run_dir, options=options, device=device)
        self.channel = SignalChannel()
        self.scheduler = Scheduler(self.cfg.capacity, self.channel)
        self.detector = FailureDetector(self.cfg.heartbeat_deadline_s)
        for s in specs:
            if s.devices > self.cfg.capacity:
                raise ValueError(
                    f"job {s.job_id!r} demands {s.devices} device(s) but "
                    f"the cluster has {self.cfg.capacity}: it could never "
                    f"be scheduled")
        self.hosts: List[str] = (
            [f"host{i:02d}" for i in range(self.cfg.hosts)]
            if self.cfg.hosts > 1 else [])
        self.migrations: Dict[str, MigrationPlan] = {
            s.job_id: MigrationPlan(s.job_id, s.migrate_at_step)
            for s in specs if s.migrate_at_step is not None}
        if self.migrations and len(self.hosts) < 2:
            raise ValueError(
                "jobs with migrate_at_step need a multi-host cluster "
                f"(OrchestratorConfig(hosts=2+), got {self.cfg.hosts})")
        self.records: Dict[str, JobRecord] = {
            s.job_id: JobRecord(s, run_dir) for s in specs}
        for rec in self.records.values():
            rec.save()
        self.workloads: Dict[str, Any] = {}
        self.planners: Dict[str, IntervalPlanner] = {
            s.job_id: IntervalPlanner(
                mtbf_guess_s=self.cfg.mtbf_guess_s,
                min_interval_s=self.cfg.planner_min_interval_s)
            for s in specs}
        self.stragglers: Dict[str, StragglerMonitor] = {
            s.job_id: StragglerMonitor(min_samples=4) for s in specs}
        self._last_jit: Dict[str, int] = {}
        self._crash_t: Dict[str, float] = {}
        # live pre-copy state per migrating job: replicator + convergence
        # controller + CAS ledger tag (the durable half lives in the
        # destination CAS, so a killed source resumes from there)
        self._precopy: Dict[str, Dict[str, Any]] = {}
        self.final: Dict[str, Dict[str, Any]] = {}
        self.ticks = 0
        self.t0: Optional[float] = None

    # ---------------------------------------------------------- lifecycle
    def _all_settled(self) -> bool:
        return all(r.terminal or r.exhausted for r in self.records.values())

    def run(self) -> Dict[str, Any]:
        self.t0 = self.clock()
        while self.ticks < self.cfg.max_ticks and not self._all_settled():
            self._tick(self.ticks)
            self.ticks += 1
        for job_id, wl in list(self.workloads.items()):
            try:
                wl.finish()
            except Exception as e:          # drain failure on exit: the
                self.records[job_id].events.append(  # record says why
                    {"t": self.clock(), "drain_error": repr(e)})
                self.records[job_id].save()
        return self.summary()

    # --------------------------------------------------------------- tick
    def _tick(self, tick: int) -> None:
        if chaos_hooks.INJECTOR is not None:
            # chaos: the campaign's tick hook — delivers deferred signals and
            # fires progress-anchored events (kills, eviction walls)
            chaos_hooks.fire("orch.tick", orch=self, tick=tick)
        # every live workload beats at tick start: a crashed "process"
        # (its workload object is gone) cannot, so only real deaths age
        # past the deadline — another job's long slice or a checkpoint
        # write in *this* process must never read as a missed beat
        for job_id in self._running_jobs():
            self.detector.heartbeat(job_id)
        self._detect_failures()
        self._schedule(tick)
        ran = self._run_slices()
        if not ran:
            # nothing runnable this tick (e.g. waiting out the heartbeat
            # deadline of a crashed job) — don't hot-spin the loop
            time.sleep(self.cfg.idle_sleep_s)

    # ------------------------------------------------- failure detection
    def _detect_failures(self) -> None:
        now = self.clock()
        for job_id in self.detector.dead_workers():
            rec = self.records.get(job_id)
            self.detector.unregister(job_id)
            if rec is None or rec.state != JobState.RUNNING:
                continue
            rec.recovery.open(
                "failure",
                t_interrupt=self._crash_t.pop(job_id, now),
                t_detect=now, step_at_interrupt=rec.step,
                last_ckpt_step=rec.last_ckpt_step)
            rec.transition(JobState.FAILED, detected="heartbeat")
            self._evict(job_id)

    def _evict(self, job_id: str) -> None:
        self.scheduler.release(job_id)
        self.channel.unregister(job_id)
        self.detector.unregister(job_id)
        self._drop(job_id)

    def _drop(self, job_id: str) -> None:
        """The job's workload leaves the device: forget it and release its
        device state (params, optimizer state, caches, engine
        references), so its memory is free for the next tenant."""
        wl = self.workloads.pop(job_id, None)
        release = getattr(wl, "release", None)
        if release is not None:
            release()

    # --------------------------------------------------------- scheduling
    def _schedule(self, tick: int) -> None:
        decision = self.scheduler.plan(self.records, tick)
        for job_id in decision.admit:
            rec = self.records[job_id]
            self.scheduler.allocate(job_id, rec.spec.devices)
            if rec.state == JobState.PENDING:
                self._start_fresh(rec)
            else:
                self._restore_job(rec)

    def _host_load(self) -> Dict[str, int]:
        load: Dict[str, int] = {}
        for rec in self.records.values():
            if rec.host is not None and not rec.terminal:
                load[rec.host] = load.get(rec.host, 0) + 1
        return load

    def _make_workload(self, rec: JobRecord):
        """Instantiate the job's workload on its assigned host.  The
        host kwarg is only passed when placement is active so custom
        two-argument factories (tests, embedders) keep working."""
        if rec.host is not None:
            return self.factory(rec.spec, rec.attempt, host=rec.host)
        return self.factory(rec.spec, rec.attempt)

    def _start_fresh(self, rec: JobRecord) -> None:
        if self.hosts and rec.host is None:
            rec.host = Scheduler.place(self.hosts, self._host_load())
        wl = self._make_workload(rec)
        wl.start()
        self._register(rec, wl)
        rec.transition(JobState.RUNNING)

    def _restore_job(self, rec: JobRecord) -> None:
        now = self.clock()
        rec.recovery.mark_scheduled(now)
        rec.transition(JobState.RESTORING)
        rec.attempt += 1
        wl = self._make_workload(rec)
        t0 = self.clock()
        # job attribution: every span the restore emits (restore.critical,
        # restore.background, pack reads) inherits this job id
        with obs_trace.context(job=rec.spec.job_id):
            try:
                restored_step = wl.restore()
            except FileNotFoundError:
                # interrupted before any image existed: cold restart
                wl.start()
                restored_step = 0
        restore_s = self.clock() - t0
        rec.step = restored_step
        meta = {"restore_wall_s": restore_s}
        if getattr(wl, "session", None) is not None:
            stats = wl.session.last_stats
            meta.update({k: stats[k] for k in
                         ("read_s", "decompress_s", "place_s",
                          "topology_mode", "restore_mode",
                          "restore_critical_s", "critical_bytes",
                          "critical_entries", "restored_from_replica")
                         if k in stats})
        # under a lazy restore wl.restore() returned on the critical set:
        # t_restored is the RESUME point, and the background stream is
        # closed out by _update_materialized once the workload joins it
        rec.recovery.mark_restored(self.clock(),
                                   restored_step=restored_step, **meta)
        self._register(rec, wl)
        rec.transition(JobState.RUNNING)
        inc = rec.recovery.current
        if inc is not None and restored_step >= inc["step_at_interrupt"]:
            # dump landed exactly at the interrupt step: nothing to replay
            rec.recovery.mark_caught_up(self.clock())
        rec.save()

    def _register(self, rec: JobRecord, wl) -> None:
        job_id = rec.spec.job_id
        self.workloads[job_id] = wl
        self.detector.register(job_id)
        # signal-handler tier: delivery is timestamped into the job
        # record the moment the scheduler sends it, so `repro jobs`
        # shows who was asked to yield even before the poll-side ack
        self.channel.register(
            job_id, lambda sig, rec=rec: rec.events.append(
                {"t": self.clock(), "signal": sig.value,
                 "step": rec.step}))
        if getattr(wl, "session", None) is not None:
            # glue: measured frozen windows feed τ* with no hand-wiring
            wl.session.set_planner(self.planners[job_id])

    # ------------------------------------------------------------- slices
    def _running_jobs(self) -> List[str]:
        return [j for j, r in self.records.items()
                if r.state == JobState.RUNNING and j in self.workloads]

    def _run_slices(self) -> int:
        from repro_torch.api.session import SnapshotWriteFailed
        from repro_torch.core.lazy import LazyRestoreError
        from repro_torch.runtime.fault import SimulatedFailure
        ran = 0
        for job_id in self._running_jobs():
            rec = self.records[job_id]
            wl = self.workloads[job_id]
            now = self.clock()
            if self.channel.pending(job_id) == Signal.KILL:
                # no grace window: the job just disappears; the detector
                # notices via the missed heartbeats
                self.channel.consume(job_id)
                self._crash_t[job_id] = now
                self._drop(job_id)
                continue
            prev_step = rec.step
            try:
                # dump/pack spans emitted inside the slice (planner-driven
                # checkpoints) carry the owning job id
                with obs_trace.context(job=job_id):
                    out = wl.run_slice(self.cfg.slice_steps,
                                       preempt=self.channel.checker(job_id))
            except SnapshotWriteFailed as e:
                # in-band abort: a background dump failed; the job stops
                # promptly instead of trusting phantom checkpoints
                self._fail_write_error(rec, now, e)
                continue
            except LazyRestoreError as e:
                # the lazy background stream died (torn cold chunk, no
                # replica): this job is half-restored and must stop —
                # never the whole loop; its retry falls back eagerly
                self._fail_write_error(rec, now, e, cause="restore_error")
                continue
            except SimulatedFailure:
                # crash: the "process" dies silently — heartbeats stop,
                # detection happens at the deadline like a real dead node.
                # Record the true progress at death so the incident's
                # replay accounting covers the partially-executed slice.
                rec.step = wl.step
                rec.save()
                self._crash_t[job_id] = self.clock()
                self._drop(job_id)
                continue
            ran += 1
            rec.step = wl.step
            rec.goodput.record_slice(prev_step, rec.step, out["wall_s"])
            self.detector.heartbeat(job_id)
            self._update_materialized(rec, wl)
            self._update_catch_up(rec)
            if out.get("preempted"):
                self._freeze_and_yield(rec, wl, out)
                continue
            self._maybe_signal_migration(rec)
            if getattr(wl, "session", None) is not None:
                latest = wl.session.latest_step()
                if latest is not None:
                    rec.last_ckpt_step = max(rec.last_ckpt_step or 0, latest)
            if wl.done:
                try:
                    wl.finish()            # drain pending async writes
                except Exception as e:
                    # the job's last dump never committed: this is a
                    # write_error fault, not a completed job
                    self._fail_write_error(rec, now, e)
                    continue
                self.final[job_id] = {"digest": wl.digest(),
                                      "step": rec.step,
                                      "jit_triggers": getattr(
                                          wl, "jit_triggers", 0)}
                rec.transition(JobState.DONE)
                self._evict(job_id)
                continue
            try:
                self._maybe_checkpoint(rec, wl, out)
            except Exception as e:
                # a dump that fails at freeze/commit time (e.g. a pending
                # async failure re-raised by wait_pending) is the same
                # fault as an in-slice write_error: stop the job promptly
                self._fail_write_error(rec, now, e)
                continue
            rec.save()
        return ran

    def _fail_write_error(self, rec: JobRecord, t_interrupt: float,
                          exc: BaseException,
                          cause: str = "write_error") -> None:
        """A snapshot write (or lazy restore stream) failed for this job:
        open an incident, mark it FAILED, and release its resources —
        never the whole loop."""
        rec.recovery.open(cause, t_interrupt=t_interrupt,
                          t_detect=self.clock(),
                          step_at_interrupt=rec.step,
                          last_ckpt_step=rec.last_ckpt_step)
        rec.transition(JobState.FAILED, write_error=repr(exc))
        self._evict(rec.spec.job_id)

    def _update_materialized(self, rec: JobRecord, wl) -> None:
        """Close the restore-background phase once the workload's
        first-touch join has drained the lazy stream (the session records
        ``restore_background_s`` at the barrier)."""
        session = getattr(wl, "session", None)
        if session is None:
            return
        bg = session.last_stats.get("restore_background_s")
        if bg is None or session.lazy_pending:
            return
        incs = rec.recovery.incidents
        if incs and incs[-1].get("t_restored") is not None \
                and incs[-1].get("t_materialized") is None:
            # anchor at t_restored + the measured stream wall rather than
            # "now": the barrier happened inside the workload's slice, and
            # this stays correct under injected test clocks
            rec.recovery.mark_materialized(
                incs[-1]["t_restored"] + bg, restore_background_s=bg,
                background_bytes=session.last_stats.get(
                    "background_bytes"))

    def _update_catch_up(self, rec: JobRecord) -> None:
        inc = rec.recovery.current
        if (inc is not None and inc["t_restored"] is not None
                and rec.step >= inc["step_at_interrupt"]):
            rec.recovery.mark_caught_up(self.clock())

    def _maybe_signal_migration(self, rec: JobRecord) -> None:
        """Drive a due migration.  Stop-and-copy: deliver a PREEMPT — the
        job checkpoints-on-signal and yields through the normal freeze
        path, where the pending plan routes it to :meth:`_migrate`.
        With a pre-copy policy the plan first enters the live ``precopy``
        phase: one delta round per tick while the job keeps stepping,
        until the convergence controller calls freeze (residual fits the
        blackout budget) or fallback (a cap tripped) — only then is the
        PREEMPT sent, and :meth:`_migrate` pushes just the residual."""
        job_id = rec.spec.job_id
        plan = self.migrations.get(job_id)
        if plan is None:
            return
        wl = self.workloads.get(job_id)
        if plan.state == "pending" and rec.step >= plan.at_step:
            policy = self.cfg.transfer_policy or TransferPolicy(mode="delta")
            if (policy.precopy_enabled
                    and getattr(wl, "session", None) is not None
                    and len(self.hosts) >= 2):
                self._begin_precopy(rec, wl, plan, policy)
            else:
                plan.state = "signalled"
                self.channel.send(job_id, Signal.PREEMPT)
                return
        if plan.state == "precopy" and wl is not None:
            self._advance_precopy(rec, wl, plan)

    def _begin_precopy(self, rec: JobRecord, wl, plan: MigrationPlan,
                       policy) -> None:
        """Open the live pre-copy phase: pick the destination now (rounds
        need a stable target CAS), build the round-capable replicator,
        and seed the convergence controller from any ledger a previous
        source incarnation left in that CAS — resumed rounds re-negotiate
        have/want and ship nothing twice."""
        from repro_torch.orchestrator.workloads import (host_cas_dir,
                                                        job_dir_for)
        from repro_torch.transfer import DeltaReplicator, PrecopyController
        job_id = rec.spec.job_id
        plan.src_host = rec.host
        plan.dst_host = Scheduler.place(self.hosts, self._host_load(),
                                        avoid=rec.host)
        rep = DeltaReplicator(
            job_dir_for(self.run_dir, job_id, plan.dst_host),
            cas_dir=host_cas_dir(self.run_dir, plan.dst_host),
            workers=policy.workers)
        if not rep.supports_rounds:     # Replicator-protocol capability
            plan.state = "signalled"    # gate, not isinstance
            self.channel.send(job_id, Signal.PREEMPT)
            return
        ctrl = PrecopyController(policy)
        tag = f"{job_id}-mig{plan.at_step}"
        ledger = rep.round_state(tag)
        if ledger:
            ctrl.seed(ledger)
            plan.rounds = [dict(r) for r in ledger
                           if not r.get("residual")]
        self._precopy[job_id] = {"rep": rep, "ctrl": ctrl, "tag": tag,
                                 "errors": 0}
        plan.state = "precopy"
        rec.events.append({"t": self.clock(), "precopy_begin": rec.step,
                           "dst_host": plan.dst_host,
                           "resumed_rounds": len(plan.rounds)})

    def _advance_precopy(self, rec: JobRecord, wl,
                         plan: MigrationPlan) -> None:
        """One live round: snapshot-while-running, push the delta to the
        destination CAS, feed the controller, and either keep stepping or
        send the freeze signal.  A round that dies (e.g. a CAS partition)
        is retried next tick — the CAS ledger plus have/want negotiation
        make the retry incremental; two consecutive failures abandon
        convergence and fall back to stop-and-copy."""
        from repro_torch.orchestrator.workloads import job_dir_for
        job_id = rec.spec.job_id
        ctx = self._precopy[job_id]
        src_dir = job_dir_for(self.run_dir, job_id, rec.host)
        try:
            with obs_trace.context(job=job_id):
                wl.checkpoint_running(rec.step)
                # async engines commit in the background; a round can
                # only ship an image whose manifest has landed
                wl.session.wait_pending()
                rec.last_ckpt_step = rec.step
                record = ctx["rep"].push_round(src_dir, rec.step,
                                               ctx["tag"])
        except Exception as e:
            ctx["errors"] += 1
            rec.events.append({"t": self.clock(), "step": rec.step,
                               "precopy_round_error": repr(e)})
            if ctx["errors"] >= 2:
                # the transfer plane is not coming back this migration:
                # stop iterating and take the stop-and-copy freeze
                plan.outcome = "fallback"
                plan.stats["fallback_reason"] = (
                    f"{ctx['errors']} consecutive round failures: "
                    f"{e!r}")
                plan.state = "signalled"
                self.channel.send(job_id, Signal.PREEMPT)
            return
        ctx["errors"] = 0
        plan.rounds.append(record)
        ctx["ctrl"].observe(record)
        decision = ctx["ctrl"].decide()
        rec.events.append({"t": self.clock(), "step": rec.step,
                           "precopy_round": record["round"],
                           "bytes_sent": record["bytes_sent"],
                           "decision": decision.action})
        if decision.action == "continue":
            return
        plan.outcome = ("converged" if decision.action == "freeze"
                        else "fallback")
        plan.stats.update(
            {"decision_reason": decision.reason,
             "predicted_residual_bytes":
                 decision.predicted_residual_bytes,
             "predicted_blackout_ms": decision.predicted_blackout_ms})
        plan.state = "signalled"
        self.channel.send(job_id, Signal.PREEMPT)

    def _freeze_and_yield(self, rec: JobRecord, wl, out) -> None:
        job_id = rec.spec.job_id
        sig = self.channel.consume(job_id)
        rec.transition(JobState.FREEZING, signal=getattr(sig, "value", sig),
                       ckpt_path=out.get("ckpt_path"))
        try:
            with obs_trace.context(job=job_id):
                wl.finish()           # drain async writers: image committed
        except Exception as e:
            # the checkpoint-on-signal never landed: the job yields as
            # FAILED and its restore falls back to the previous image
            self._fail_write_error(rec, self.clock(), e)
            return
        rec.last_ckpt_step = rec.step
        plan = self.migrations.get(job_id)
        if plan is not None and plan.state == "signalled":
            self._migrate(rec, wl, plan)
            return
        now = self.clock()
        rec.recovery.open("preemption", t_interrupt=now, t_detect=now,
                          step_at_interrupt=rec.step,
                          last_ckpt_step=rec.step)
        rec.transition(JobState.PREEMPTED)
        self._evict(job_id)

    # ---------------------------------------------------------- migration
    def _migrate(self, rec: JobRecord, wl, plan: MigrationPlan) -> None:
        """The job is frozen with a committed image on its source host:
        pick a destination, delta-transfer the image there, and yield as
        PREEMPTED with ``rec.host`` rebound — the next scheduling round
        restores it on the new host, step-exact."""
        from repro_torch.orchestrator.workloads import job_dir_for
        from repro_torch.transfer.precopy import summarize_rounds
        job_id = rec.spec.job_id
        now = self.clock()
        rec.recovery.open("migration", t_interrupt=now, t_detect=now,
                          step_at_interrupt=rec.step,
                          last_ckpt_step=rec.step)
        ctx = self._precopy.pop(job_id, None)
        if ctx is None:
            plan.src_host = rec.host
            plan.dst_host = Scheduler.place(self.hosts, self._host_load(),
                                            avoid=rec.host)
        src_dir = job_dir_for(self.run_dir, job_id, plan.src_host)
        dst_dir = job_dir_for(self.run_dir, job_id, plan.dst_host)
        t0 = self.clock()
        try:
            with obs_trace.context(job=job_id):
                if ctx is not None:
                    # pre-copy handoff: the job is frozen, push only the
                    # residual delta (everything else landed live)
                    step = wl.session.latest_step()
                    if step is None:
                        raise FileNotFoundError(
                            f"no image to migrate under {src_dir}")
                    residual = ctx["rep"].push_round(
                        src_dir, step, ctx["tag"], residual=True)
                    plan.rounds.append(residual)
                    stats = dict(ctx["rep"].stats, mode="delta-precopy",
                                 outcome=plan.outcome,
                                 **summarize_rounds(plan.rounds))
                    ctx["rep"].clear_rounds(ctx["tag"])
                else:
                    stats = self._transfer_image(wl, src_dir, dst_dir,
                                                 plan.dst_host)
        except Exception as e:
            # the image never reached the destination: stay on the source
            # host (its image is intact) and recover like a preemption.
            # A pre-copy ledger (and every landed chunk) stays in the
            # destination CAS: a retried migration resumes the rounds.
            plan.state = "failed"
            plan.stats = dict(plan.stats, error=repr(e))
            rec.events.append({"t": self.clock(), "migration_error": repr(e)})
        else:
            plan.state = "transferred"
            plan.stats = dict(plan.stats, **stats)
            rounds = list(plan.rounds)
            if not rounds:
                # stop-and-copy: the whole transfer is one frozen
                # residual round — recorded in the same per-round shape
                rounds = [{"round": 0, "residual": True,
                           "bytes_sent": stats.get(
                               "bytes_sent", stats.get("bytes_copied", 0)),
                           "wall_s": self.clock() - t0}]
            rec.recovery.mark_transfer(
                t0, self.clock(), rounds=rounds,
                **{k: stats[k] for k in
                   ("bytes_sent", "bytes_reused", "bytes_copied",
                    "chunks_sent", "chunks_reused",
                    "precopy_bytes", "residual_bytes", "blackout_s",
                    "outcome") if k in stats})
            rec.host = plan.dst_host
            rec.events.append({
                "t": self.clock(), "step": rec.step,
                "migrated": {"from": plan.src_host, "to": plan.dst_host,
                             "bytes_sent": stats.get("bytes_sent",
                                                     stats.get("bytes", 0)),
                             "bytes_reused": stats.get("bytes_reused", 0),
                             "rounds": len(plan.rounds)}})
        rec.transition(JobState.PREEMPTED)
        self._evict(job_id)

    def _transfer_image(self, wl, src_dir: str, dst_dir: str,
                        dst_host: str) -> Dict[str, Any]:
        """Move one job's checkpoint state between host directories.
        Session-backed workloads go through the content-addressed
        :class:`DeltaReplicator` (or whole-file copy when configured);
        sessionless baselines (interception) copy their replay logs."""
        if getattr(wl, "session", None) is None:
            import shutil
            os.makedirs(dst_dir, exist_ok=True)
            nbytes, nfiles = 0, 0
            for name in sorted(os.listdir(src_dir)):
                p = os.path.join(src_dir, name)
                if os.path.isfile(p):
                    shutil.copy2(p, os.path.join(dst_dir, name))
                    nbytes += os.path.getsize(p)
                    nfiles += 1
            return {"mode": "full-copy", "bytes_copied": nbytes,
                    "files_copied": nfiles}
        step = wl.session.latest_step()
        if step is None:
            raise FileNotFoundError(f"no image to migrate under {src_dir}")
        policy = self.cfg.transfer_policy or TransferPolicy(mode="delta")
        if policy.mode == "delta":
            from repro_torch.orchestrator.workloads import host_cas_dir
            from repro_torch.transfer import DeltaReplicator
            rep = DeltaReplicator(
                dst_dir, cas_dir=host_cas_dir(self.run_dir, dst_host),
                workers=policy.workers)
            return dict(rep.push(src_dir, step), mode="delta")
        # whole-file copy: the closure still has to move (an incremental
        # child is unrestorable without its parents)
        from repro_torch.core.replication import DirReplicator
        from repro_torch.transfer.delta import transfer_closure
        rep = DirReplicator(dst_dir)
        total = {"mode": "copy", "bytes_copied": 0, "files_copied": 0,
                 "bytes_skipped": 0, "files_skipped": 0}
        for s in transfer_closure(wl.session.store, step):
            st = rep.push(src_dir, s)
            for k in ("bytes_copied", "files_copied",
                      "bytes_skipped", "files_skipped"):
                total[k] += st[k]
        return total

    # ----------------------------------------------------------- cadence
    def _maybe_checkpoint(self, rec: JobRecord, wl, out) -> None:
        job_id = rec.spec.job_id
        last = rec.last_ckpt_step or 0
        since = rec.step - last
        step_time = out["wall_s"] / max(out.get("steps", 1), 1)
        due = False
        jit = False
        if rec.spec.ckpt_every > 0:
            due = since >= rec.spec.ckpt_every
        else:
            # τ*-driven cadence: the planner's cost estimate tracks the
            # session's measured frozen windows (set_planner glue)
            due = since >= self.planners[job_id].steps_between_checkpoints(
                step_time)
        if self.stragglers[job_id].record(step_time):
            cool = rec.step - self._last_jit.get(job_id, -10**9)
            if cool >= self.cfg.jit_cooldown_steps:
                due = jit = True
                self._last_jit[job_id] = rec.step
        if due and since > 0:
            wl.checkpoint(rec.step)
            rec.last_ckpt_step = rec.step
            rec.events.append({"t": self.clock(), "checkpoint": rec.step,
                               "jit": jit})

    # ----------------------------------------------------------- summary
    def summary(self) -> Dict[str, Any]:
        now = self.clock()
        wall = now - (self.t0 if self.t0 is not None else now)
        jobs = {}
        useful_s = 0.0
        for job_id, rec in self.records.items():
            job_wall = ((rec.finished_t or now) - rec.created_t) or 1e-9
            useful_s += rec.goodput.useful_step_seconds()
            plan = self.migrations.get(job_id)
            jobs[job_id] = {
                "kind": rec.spec.kind,
                "priority": rec.spec.priority,
                "state": rec.state.value,
                "host": rec.host,
                "migration": (None if plan is None else
                              {"state": plan.state, "from": plan.src_host,
                               "to": plan.dst_host,
                               "outcome": plan.outcome,
                               "rounds": [dict(r) for r in plan.rounds],
                               **plan.stats}),
                "step": rec.step,
                "total_steps": rec.spec.total_steps,
                "attempts": rec.attempt + 1,
                "restarts": rec.restarts,
                "goodput": rec.goodput.goodput(job_wall),
                "recovery": rec.recovery.breakdown(),
                "recovery_totals": rec.recovery.totals(),
                "checkpoints": sum(1 for e in rec.events
                                   if "checkpoint" in e),
                "jit_checkpoints": (
                    sum(1 for e in rec.events if e.get("jit"))
                    + self.final.get(job_id, {}).get("jit_triggers", 0)),
                "last_ckpt_step": rec.last_ckpt_step,
                "digest": self.final.get(job_id, {}).get("digest"),
            }
        return {"wall_s": wall, "ticks": self.ticks,
                "capacity": self.cfg.capacity,
                "hosts": max(self.cfg.hosts, 1),
                "cluster_goodput": useful_s / wall if wall > 0 else 0.0,
                "all_done": all(r.state == JobState.DONE
                                for r in self.records.values()),
                "jobs": jobs}
