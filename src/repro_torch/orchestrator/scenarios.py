"""Reproducible scenario matrix — the bench/CI entry points.

A scenario is a deterministic multi-tenant script: which jobs exist, who
arrives when, and which faults are injected.  The matrix is the JAX
package's, job for job, so a scenario run in either package schedules,
interrupts and recovers the same jobs at the same steps.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.orchestrator.job import JobSpec
from repro_torch.orchestrator.orchestrator import (Orchestrator,
                                                   OrchestratorConfig)
from repro_torch.orchestrator.workloads import (WorkloadConfig,
                                                make_workload_factory)

SCENARIOS = ("preemption", "failure", "straggler", "migrate", "mixed")


def scenario_specs(name: str, total_steps: int = 10,
                   kind: str = "train") -> List[JobSpec]:
    """Job set for one named scenario (deterministic by construction)."""
    if name == "preemption":
        # low-priority job is mid-run when a high-priority job arrives;
        # capacity 1 forces checkpoint-on-signal + reschedule
        return [
            JobSpec("lo", kind=kind, priority=0, total_steps=total_steps,
                    ckpt_every=0),
            JobSpec("hi", kind=kind, priority=5,
                    total_steps=max(total_steps // 2, 2), arrive_tick=2),
        ]
    if name == "failure":
        # periodic checkpoints + a mid-run crash; heartbeat detection,
        # restore from the newest image, replay the gap
        return [
            JobSpec("crashy", kind=kind, priority=1,
                    total_steps=total_steps, ckpt_every=2,
                    fail_at_step=total_steps // 2 + 1),
        ]
    if name == "straggler":
        # injected stall -> StragglerMonitor flags it -> JIT checkpoint;
        # the stall lands late enough that the monitors have their minimum
        # sample history (8 steps) but with slices to spare afterwards so
        # the orchestrator-level trigger also gets a turn
        return [
            JobSpec("slowpoke", kind=kind, priority=1,
                    total_steps=max(total_steps, 12),
                    straggle_at_step=8),
        ]
    if name == "migrate":
        # live cross-host migration: the job checkpoints-on-signal on
        # host A mid-run, its image delta-transfers to host B's CAS, and
        # it restores there step-exact (periodic checkpoints beforehand
        # build the incremental chain the delta transfer dedups against)
        return [
            JobSpec("mover", kind=kind, priority=1,
                    total_steps=max(total_steps, 6), ckpt_every=2,
                    migrate_at_step=max(total_steps // 2, 3)),
        ]
    if name == "mixed":
        # the CI smoke: one preemption + one injected failure sharing
        # the cluster — both must recover step-exact
        return [
            JobSpec("lo", kind=kind, priority=0, total_steps=total_steps,
                    ckpt_every=2, fail_at_step=None),
            JobSpec("crashy", kind=kind, priority=1,
                    total_steps=total_steps, ckpt_every=2,
                    fail_at_step=total_steps // 2 + 1),
            JobSpec("hi", kind=kind, priority=5,
                    total_steps=max(total_steps // 2, 2), arrive_tick=2),
        ]
    raise ValueError(f"unknown scenario {name!r}; pick from {SCENARIOS}")


def run_scenario(name: str, run_dir: str, options=None, device=None,
                 total_steps: int = 10, kind: str = "train",
                 capacity: Optional[int] = None, hosts: Optional[int] = None,
                 config: Optional[OrchestratorConfig] = None,
                 transfer_policy=None,
                 workload: Optional[WorkloadConfig] = None) -> Dict:
    """Build and run one scenario on `device` (``cuda`` unless the caller
    passes ``"cpu"``); returns the orchestrator summary.

    ``transfer_policy`` (an :class:`repro_torch.api.TransferPolicy`)
    configures the migration data path of the default-built config — e.g.
    pre-copy live migration with a blackout budget for the ``migrate``
    scenario.  Ignored when an explicit ``config`` is passed (set it
    there).  ``workload`` sets the model and the train and serve shapes
    (default: the JAX package's smoke workloads)."""
    from repro_torch.orchestrator.job import jobs_dir
    import os
    if os.path.isdir(jobs_dir(run_dir)):
        # stale job records + images from a previous invocation would be
        # restored silently (restore picks the newest image in the job's
        # dir) — a scenario is only reproducible in a fresh run_dir
        raise ValueError(
            f"{run_dir!r} already holds an orchestrator run "
            f"({jobs_dir(run_dir)} exists); pick a fresh run_dir")
    specs = scenario_specs(name, total_steps=total_steps, kind=kind)
    if config is None:
        # capacity 1 for single-job scenarios exercises nothing extra but
        # keeps wall time down; preemption scenarios need contention;
        # migration needs somewhere else to land (hosts >= 2)
        cap = capacity if capacity is not None else (
            1 if name in ("preemption", "failure", "straggler", "migrate")
            else 2)
        n_hosts = hosts if hosts is not None else (
            2 if name == "migrate" else 1)
        config = OrchestratorConfig(capacity=cap, slice_steps=2,
                                    hosts=n_hosts,
                                    transfer_policy=transfer_policy)
    orch = Orchestrator(run_dir, specs,
                        workload_factory=make_workload_factory(
                            run_dir, options=options, device=device,
                            workload=workload),
                        config=config)
    return orch.run()
