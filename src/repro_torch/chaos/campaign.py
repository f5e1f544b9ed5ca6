"""Survivability campaigns: a seeded fault plan against a simulated fleet.

``run_campaign`` drives N sim jobs across H simulated hosts under the
orchestrator with a :class:`FaultInjector` installed, then holds the
fleet to the campaign invariant:

    every job either finishes **bit-exact** (its digest equals the
    digest of an unfaulted in-process replay) or lands in *diagnosable
    quarantine* (restart budget exhausted, with a complete RecoveryLog
    incident saying what happened and when it was detected).

Anything else — a hung job, a DONE job with the wrong digest (silent
corruption), a planned fault that never fired — is a **violation** and
fails the campaign.  The report aggregates per-fault-class survivability
(injected / recovered / healed / quarantined / MTTR) and exposes:

  * ``table_markdown()`` — the README survivability table,
  * ``metrics()`` — the flat metrics dict, the JAX package's names
    (``*_ratio`` metrics are 0-is-healthy),
  * ``fingerprint()`` — a digest over seed, per-class outcome counts and
    per-job digests (times excluded), so "same seed, same table" is one
    string comparison.

A port of the JAX package's campaign: the fleet's jobs hold their state
on ``device`` (``cuda`` unless the caller passes ``"cpu"``), and each
job's digest is held to an unfaulted replay on that device.  On the CPU
a seed gives the JAX package's fingerprint; on a card the digests are
the card's own (``repro_torch.chaos.sim``), while every row and outcome
stays the CPU's, since fault triggers anchor on job progress.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.api import TransferPolicy
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.orchestrator.job import JobSpec
from repro_torch.orchestrator.orchestrator import (Orchestrator,
                                                   OrchestratorConfig)
from repro_torch.orchestrator.workloads import job_dir_for
from repro_torch.transfer.cas import ChunkStore, default_cas_dir

from .injector import FaultInjector
from .plan import ChaosConfig, generate_plan, parse_fault_spec
from .sim import make_sim_factory, reference_digest, warm_up

DEFAULT_TOTAL_STEPS = 12
DEFAULT_CKPT_EVERY = 3
DEFAULT_MAX_RESTARTS = 6


def make_specs(jobs: int, total_steps: int = DEFAULT_TOTAL_STEPS,
               ckpt_every: int = DEFAULT_CKPT_EVERY,
               max_restarts: int = DEFAULT_MAX_RESTARTS) -> List[JobSpec]:
    return [JobSpec(job_id=f"j{i:03d}", kind="sim",
                    total_steps=total_steps, ckpt_every=ckpt_every,
                    max_restarts=max_restarts)
            for i in range(jobs)]


@dataclasses.dataclass
class CampaignReport:
    seed: int
    jobs: int
    hosts: int
    fault_spec: str
    wall_s: float
    ticks: int
    planned: Dict[str, int]                  # class -> events planned
    rows: Dict[str, Dict[str, Any]]          # class -> survivability row
    outcomes: Dict[str, str]                 # job -> recovered|quarantined|…
    digests: Dict[str, Optional[str]]        # job -> final digest (DONE only)
    violations: List[Dict[str, Any]]
    capture: str = "sync"                    # dump capture mode swept

    @property
    def ok(self) -> bool:
        return not self.violations

    def fingerprint(self) -> str:
        """Deterministic campaign identity: same seed -> same string.

        Covers per-class outcome counts, per-job outcomes and digests;
        excludes wall-clock, tick counts and MTTR (machine-speed noise).
        """
        stable_rows = {
            cls: {k: row[k] for k in
                  ("planned", "injected", "recovered", "healed",
                   "quarantined")}
            for cls, row in sorted(self.rows.items())}
        blob = json.dumps(
            {"seed": self.seed, "jobs": self.jobs, "hosts": self.hosts,
             "fault_spec": self.fault_spec, "capture": self.capture,
             "rows": stable_rows,
             "outcomes": self.outcomes, "digests": self.digests,
             "violation_reasons": sorted(
                 v["reason"] for v in self.violations)},
            sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()

    def table_markdown(self) -> str:
        out = ["| fault class | injected | recovered | healed | "
               "quarantined | MTTR (s) |",
               "|---|---|---|---|---|---|"]
        for cls in sorted(self.rows):
            r = self.rows[cls]
            mttr = "—" if r["mttr_s"] is None else f"{r['mttr_s']:.3f}"
            out.append(
                f"| {cls} | {r['injected']}/{r['planned']} | "
                f"{r['recovered']} | {r['healed']} | {r['quarantined']} | "
                f"{mttr} |")
        out.append(
            f"\n{self.jobs} jobs × {self.hosts} hosts, seed {self.seed}, "
            f"faults `{self.fault_spec}`, capture `{self.capture}`: "
            + ("**invariant held** (every job bit-exact or diagnosably "
               "quarantined)" if self.ok else
               f"**{len(self.violations)} invariant violation(s)**"))
        return "\n".join(out)

    def metrics(self) -> Dict[str, Any]:
        """Flat metrics dict (the JAX package's names).  The
        ``*_ratio`` metrics are 0 when healthy."""
        m: Dict[str, Any] = {
            "chaos.workload.jobs": self.jobs,
            "chaos.workload.hosts": self.hosts,
            "chaos.workload.seed": self.seed,
            "chaos.invariant.violation_ratio":
                len(self.violations) / max(self.jobs, 1),
            "chaos.campaign.wall_s": self.wall_s,
        }
        for cls, r in sorted(self.rows.items()):
            planned, targets = r["planned"], max(r["targets"], 1)
            m[f"chaos.{cls}.missed_injection_ratio"] = (
                (planned - r["injected"]) / planned if planned else 0.0)
            survived = r["recovered"] + r["quarantined"]
            m[f"chaos.{cls}.unsurvived_ratio"] = (
                (r["targets"] - survived) / targets)
            m[f"chaos.{cls}.quarantined_ratio"] = r["quarantined"] / targets
            m[f"chaos.{cls}.injected"] = r["injected"]
            m[f"chaos.{cls}.healed"] = r["healed"]
            if r["mttr_s"] is not None:
                m[f"chaos.{cls}.mttr_s"] = r["mttr_s"]
        return m

    def to_dict(self) -> Dict[str, Any]:
        return {"format": 1,
                "seed": self.seed, "jobs": self.jobs, "hosts": self.hosts,
                "fault_spec": self.fault_spec, "capture": self.capture,
                "ok": self.ok,
                "wall_s": self.wall_s, "ticks": self.ticks,
                "fingerprint": self.fingerprint(),
                "rows": self.rows, "outcomes": self.outcomes,
                "digests": self.digests, "violations": self.violations}


def run_campaign(run_dir: str, jobs: int = 100, hosts: int = 20,
                 seed: int = 0, faults: str = "all=1",
                 total_steps: int = DEFAULT_TOTAL_STEPS,
                 ckpt_every: int = DEFAULT_CKPT_EVERY,
                 max_ticks: int = 4000,
                 capture: str = "sync",
                 log: Optional[Callable[[str], None]] = None,
                 device: DeviceLike = None) -> CampaignReport:
    """Run one seeded survivability campaign under ``run_dir``, every
    job's state on `device` (``cuda`` unless the caller passes ``"cpu"``).

    ``capture="concurrent"`` sweeps the fleet's dumps through the
    soft-freeze path and enables the ``dirty_burst`` fault class; under
    sync capture that class is dropped from the plan (it can only fire
    inside a speculation window).  ``dirty_burst`` sits last in
    ``FAULT_CLASSES``, so dropping it leaves the seeded schedule of every
    other class bit-identical to a pre-concurrent campaign.
    """
    say = log or (lambda _msg: None)
    dev = resolve_device(device)
    specs = make_specs(jobs, total_steps=total_steps,
                       ckpt_every=ckpt_every)
    counts = parse_fault_spec(faults)
    if capture != "concurrent":
        counts.pop("dirty_burst", None)
    plan = generate_plan(seed, specs, hosts, counts)

    # exhaust targets get a restart budget of exactly 1: two kills land
    # them in quarantine, which is the outcome the class asserts
    exhaust_jobs = set(plan.targets("exhaust"))
    specs = [dataclasses.replace(s, max_restarts=1)
             if s.job_id in exhaust_jobs else s for s in specs]

    # torn/dropped-write targets write self-contained images: a torn
    # historical pack must not be referenced by later incremental
    # children (see make_sim_factory)
    non_inc = set(plan.targets("torn_write")) | set(
        plan.targets("fsync_drop"))

    say(f"chaos plan: seed={seed} events={len(plan.events)} "
        f"classes={sorted(plan.counts)} capture={capture}")
    factory = make_sim_factory(run_dir, non_incremental=non_inc,
                               capture=capture, device=dev)
    cfg = OrchestratorConfig(
        capacity=max(2, min(jobs, 2 * hosts)), slice_steps=2,
        heartbeat_deadline_s=0.05, hosts=hosts,
        transfer_policy=TransferPolicy(mode="delta", workers=1),
        max_ticks=max_ticks)
    injector = FaultInjector(plan, clock=time.perf_counter)
    orch = Orchestrator(run_dir, specs, workload_factory=factory,
                        config=cfg)
    # the first slice must not pay CUDA's context or first launch inside
    # the 50 ms heartbeat deadline
    warm_up(dev)
    with injector.installed():
        summary = orch.run()

    say(f"fleet settled after {summary['ticks']} ticks "
        f"({summary['wall_s']:.2f}s); evaluating {jobs} jobs")
    report = _evaluate(run_dir, plan, injector, orch, summary,
                       {s.job_id: s for s in specs},
                       jobs=jobs, hosts=hosts, seed=seed,
                       fault_spec=faults, capture=capture, device=dev)
    return report


# --------------------------------------------------------------- evaluate
def _evaluate(run_dir: str, plan: ChaosConfig, injector: FaultInjector,
              orch: Orchestrator, summary: Dict[str, Any],
              by_id: Dict[str, JobSpec], jobs: int, hosts: int,
              seed: int, fault_spec: str,
              capture: str = "sync",
              device: DeviceLike = None) -> CampaignReport:
    outcomes: Dict[str, str] = {}
    digests: Dict[str, Optional[str]] = {}
    violations: List[Dict[str, Any]] = []

    for job_id, spec in sorted(by_id.items()):
        ref = reference_digest(spec, device)
        info = summary["jobs"][job_id]
        digests[job_id] = info["digest"]
        if info["state"] == "done":
            if info["digest"] == ref:
                outcomes[job_id] = "recovered"
            else:
                outcomes[job_id] = "corrupt"
                violations.append({
                    "job": job_id, "reason": "silent_corruption",
                    "detail": f"digest {info['digest']} != reference "
                              f"{ref} after recovery"})
        elif _is_quarantined(orch.records[job_id]):
            inc = orch.records[job_id].recovery.incidents[-1]
            if _diagnosable(inc):
                outcomes[job_id] = "quarantined"
            else:
                outcomes[job_id] = "undiagnosed"
                violations.append({
                    "job": job_id, "reason": "undiagnosed_quarantine",
                    "detail": f"incomplete RecoveryLog incident: {inc}"})
        else:
            outcomes[job_id] = "hung"
            violations.append({
                "job": job_id, "reason": "hung",
                "detail": f"state={info['state']} step={info['step']}/"
                          f"{info['total_steps']} after "
                          f"{summary['ticks']} ticks"})

    for ev in plan.events:
        if ev.state == "pending":
            violations.append({
                "job": ev.job_id, "reason": "event_never_fired",
                "detail": ev.key()})

    rows = {cls: _class_row(cls, plan, orch, outcomes, run_dir)
            for cls in sorted(plan.counts)}
    return CampaignReport(
        seed=seed, jobs=jobs, hosts=hosts, fault_spec=fault_spec,
        capture=capture,
        wall_s=summary["wall_s"], ticks=summary["ticks"],
        planned={cls: len(plan.events_for(cls)) for cls in plan.counts},
        rows=rows, outcomes=outcomes, digests=digests,
        violations=violations)


def _is_quarantined(rec) -> bool:
    return rec.exhausted


def _diagnosable(inc: Dict[str, Any]) -> bool:
    """A quarantine incident must say *what* (cause), *where*
    (step_at_interrupt) and *when it was noticed* (t_detect)."""
    return (inc.get("cause") is not None
            and inc.get("t_detect") is not None
            and inc.get("t_interrupt") is not None
            and inc.get("step_at_interrupt") is not None)


def _class_row(cls: str, plan: ChaosConfig, orch, outcomes: Dict[str, str],
               run_dir: str) -> Dict[str, Any]:
    events = plan.events_for(cls)
    targets = plan.targets(cls)
    injected = sum(1 for e in events if e.state != "pending")
    recovered = sum(1 for j in targets if outcomes.get(j) == "recovered")
    quarantined = sum(1 for j in targets
                      if outcomes.get(j) == "quarantined")
    healed = _healed_count(cls, targets, orch, run_dir)
    mttrs = [m for m in (_event_mttr(e, orch) for e in events)
             if m is not None]
    return {"planned": len(events), "targets": len(targets),
            "injected": injected, "recovered": recovered,
            "healed": healed, "quarantined": quarantined,
            "mttr_s": (sum(mttrs) / len(mttrs)) if mttrs else None}


def _healed_count(cls: str, targets: Sequence[str], orch,
                  run_dir: str) -> int:
    """Self-healing events that recovered data *without* a job restart:
    CAS objects healed from source during materialization (cas_corrupt)
    and restores served from the replica store (fsync_drop)."""
    healed = 0
    if cls == "cas_corrupt":
        for job_id in targets:
            rec = orch.records[job_id]
            replica = job_dir_for(run_dir, job_id, rec.host) + "_replica"
            store = ChunkStore(default_cas_dir(replica))
            healed += sum(int(t.get("corrupt_objects_healed", 0))
                          for t in store.transfer_log())
    else:
        for job_id in targets:
            for inc in orch.records[job_id].recovery.incidents:
                if inc.get("meta", {}).get("restored_from_replica"):
                    healed += 1
    return healed


def _event_mttr(ev, orch) -> Optional[float]:
    """Injection -> recovered (caught up) or diagnosed (detected), using
    the injector's clock == the orchestrator's clock."""
    if ev.t_injected is None:
        return None
    rec = orch.records.get(ev.job_id)
    if rec is None:
        return None
    eps = 1e-6
    for inc in rec.recovery.incidents:
        if inc.get("t_detect") is None or \
                inc["t_detect"] < ev.t_injected - eps:
            continue
        if inc.get("t_caught_up") is not None:
            return max(0.0, inc["t_caught_up"] - ev.t_injected)
        if rec.exhausted and inc is rec.recovery.incidents[-1]:
            return max(0.0, inc["t_detect"] - ev.t_injected)
    return None


def write_bench_json(report: CampaignReport, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report.metrics(), f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
