"""Seeded fault plans: what to break, where, and when.

A :class:`ChaosConfig` is generated from ``(seed, job specs, hosts, fault
spec)`` by a deterministic PRNG — the same seed always produces the same
events against the same fleet, which is what makes a chaos campaign a
*regression test* rather than a dice roll.  The PRNG is numpy's
``default_rng``, drawn in the JAX package's order, so a seed plans the
same events, event for event, in both packages.

Fault taxonomy (one event class per failure mode the stack claims to
survive):

=================  ============================================================
``torn_write``     flip a byte of a freshly written pack chunk mid-dump
                   (detected by per-chunk CRC at the replication read)
``commit_kill``    kill the dump between phase-2 payload rename and the
                   MANIFEST write (image must be invisible to restore)
``fsync_drop``     corrupt a *committed* local pack after the replica push
                   (models lost writeback; restore falls back to an older
                   image) followed by a host kill
``cas_corrupt``    corrupt a CAS object on the replica right after it lands
                   (healed from source by the materializer)
``cas_partition``  fail a CAS put mid-push (models a network partition;
                   the next push resumes from the chunks that landed)
``host_kill``      correlated kill of every job on one simulated host
``degraded_io``    slow every sim step on one job for a window (straggler;
                   the JIT checkpoint policy should fire)
``eviction_wall``  HTCondor-style eviction: freeze + migrate the job to
                   another simulated host (requires >= 2 hosts)
``signal_dup``     the PREEMPT signal for one job is delivered twice
``signal_delay``   the PREEMPT signal for one job is delayed two ticks
``exhaust``        repeated kills against a job with ``max_restarts=1``
                   until it lands in diagnosable quarantine
``dirty_burst``    mutate a live state leaf *during* a concurrent
                   (soft-freeze) capture's speculation window — the dirty
                   protocol must invalidate the stale shard and the commit
                   must stay bit-exact (only fires when the campaign runs
                   with ``capture="concurrent"``)
=================  ============================================================
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

FAULT_CLASSES = (
    "torn_write",
    "commit_kill",
    "fsync_drop",
    "cas_corrupt",
    "cas_partition",
    "host_kill",
    "degraded_io",
    "eviction_wall",
    "signal_dup",
    "signal_delay",
    "exhaust",
    # keep dirty_burst last: sync campaigns zero its count, and a
    # trailing zero-count class leaves the PRNG draw order (and so every
    # pre-existing seeded plan) unchanged
    "dirty_burst",
)

# Classes that anchor on a checkpoint commit: the event fires inside the
# first commit whose step is >= at_step (commit hooks), so at_step must
# leave at least one earlier committed image to fall back to.
COMMIT_ANCHORED = ("torn_write", "commit_kill", "fsync_drop",
                   "cas_corrupt", "cas_partition", "dirty_burst")

# Classes that cost the target job a restart when they fire.
KILLING = ("torn_write", "commit_kill", "fsync_drop", "cas_partition",
           "host_kill")


class ChaosInjectedFault(RuntimeError):
    """Raised by the injector where the modelled fault would crash."""


class ChaosPartition(IOError):
    """Raised by the injector where the modelled fault is a network cut."""


@dataclasses.dataclass
class FaultEvent:
    """One planned incident against one target job."""
    kind: str
    job_id: str
    at_step: int                 # trigger: target job reaches this step
    seq: int                     # stable ordinal within the plan
    detail: Dict = dataclasses.field(default_factory=dict)
    # -- mutable runtime bookkeeping (owned by the injector) --
    state: str = "pending"       # pending -> (armed ->) injected
    injected_step: Optional[int] = None
    t_injected: Optional[float] = None

    def key(self) -> str:
        return f"{self.kind}#{self.seq}@{self.job_id}"


@dataclasses.dataclass
class ChaosConfig:
    """A fully materialized, seeded fault schedule."""
    seed: int
    hosts: int
    counts: Dict[str, int]
    events: List[FaultEvent] = dataclasses.field(default_factory=list)

    def events_for(self, kind: str) -> List[FaultEvent]:
        return [e for e in self.events if e.kind == kind]

    def targets(self, kind: str) -> List[str]:
        return sorted({e.job_id for e in self.events if e.kind == kind})


def parse_fault_spec(spec: str) -> Dict[str, int]:
    """``"all=1"`` / ``"host_kill=3,torn_write=2"`` -> {class: count}.

    ``all=N`` seeds every class with N and may be refined by later
    entries; unknown classes are an error so typos fail loudly.
    """
    counts: Dict[str, int] = {}
    spec = (spec or "all=1").strip()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, _, num = part.partition("=")
            name, num = name.strip(), int(num)
        else:
            name, num = part, 1
        if name == "all":
            for cls in FAULT_CLASSES:
                counts[cls] = num
        elif name in FAULT_CLASSES:
            counts[name] = num
        else:
            raise ValueError(
                f"unknown fault class {name!r}; choose from "
                f"{', '.join(FAULT_CLASSES)} or 'all'")
    return {k: v for k, v in counts.items() if v > 0}


def generate_plan(seed: int, specs: Sequence, hosts: int,
                  counts: Dict[str, int]) -> ChaosConfig:
    """Deterministically assign fault events to jobs.

    ``specs`` are orchestrator JobSpecs (only ``job_id`` / ``total_steps``
    / ``ckpt_every`` / ``max_restarts`` are consulted).  Rules that keep
    every planned event actually injectable:

    * ``exhaust`` targets are exclusive — no other event may hit them
      (their restart budget is 1 by construction).
    * killing events are capped per job below its restart budget.
    * commit-anchored events pick ``at_step`` so the triggering commit
      has at least one earlier committed image to fall back to.
    * ``eviction_wall`` events are dropped (with a note in ``counts``)
      when the fleet has fewer than two hosts.
    * ``dirty_burst`` events avoid ``torn_write``/``fsync_drop`` targets:
      those jobs write self-contained (non-incremental) images, which
      forces ``capture="sync"`` where a burst could never fire.
    """
    rng = np.random.default_rng(seed)
    counts = dict(counts)
    if hosts < 2 and counts.get("eviction_wall"):
        counts["eviction_wall"] = 0

    by_id = {s.job_id: s for s in specs}
    order = sorted(by_id)
    rng.shuffle(order)

    events: List[FaultEvent] = []
    seq = 0
    kill_load: Dict[str, int] = {j: 0 for j in order}
    exhaust_jobs: List[str] = []

    # exhaust targets first, so they can be excluded from everything else
    for _ in range(counts.get("exhaust", 0)):
        pool = [j for j in order if j not in exhaust_jobs]
        if not pool:
            break
        job = pool[int(rng.integers(len(pool)))]
        exhaust_jobs.append(job)
        spec = by_id[job]
        lo, hi = _kill_window(spec)
        events.append(FaultEvent("exhaust", job,
                                 int(rng.integers(lo, hi + 1)), seq))
        seq += 1

    cursor = 0
    for kind in FAULT_CLASSES:
        if kind == "exhaust":
            continue
        avoid: set = set()
        if kind == "dirty_burst":
            # torn_write/fsync_drop targets run non-incremental
            # (self-contained images), which forces capture="sync" on
            # them — a burst planned there could never fire
            avoid = {e.job_id for e in events
                     if e.kind in ("torn_write", "fsync_drop")}
        for _ in range(counts.get(kind, 0)):
            job = None
            for _probe in range(len(order)):
                cand = order[cursor % len(order)]
                cursor += 1
                if cand in exhaust_jobs or cand in avoid:
                    continue
                if kind in KILLING and \
                        kill_load[cand] + 1 >= by_id[cand].max_restarts:
                    continue
                job = cand
                break
            if job is None:       # fleet too small for the spec
                counts[kind] = counts.get(kind, 0) - 1
                continue
            spec = by_id[job]
            if kind in COMMIT_ANCHORED:
                lo, hi = _commit_window(spec)
            elif kind == "degraded_io":
                lo, hi = max(2, spec.total_steps - 5), spec.total_steps - 4
            else:
                lo, hi = _kill_window(spec)
            at = int(rng.integers(lo, max(lo, hi) + 1))
            detail: Dict = {}
            if kind == "degraded_io":
                detail = {"window": 4, "delay_s": 0.12}
            events.append(FaultEvent(kind, job, at, seq, detail))
            if kind in KILLING:
                kill_load[job] += 1
            seq += 1

    cfg = ChaosConfig(seed=seed, hosts=hosts,
                      counts={k: v for k, v in counts.items() if v > 0},
                      events=events)
    return cfg


def _commit_window(spec):
    """at_step range targeting a commit that is not the job's first.

    With slice-quantised stepping the triggering commit is the first one
    at step >= at_step; keeping at_step past the first checkpoint
    guarantees a fallback image exists.
    """
    lo = spec.ckpt_every + 2
    hi = max(lo, spec.total_steps - 5)
    return lo, hi


def _kill_window(spec):
    """at_step range for driver-triggered events (kills, signals, walls).

    Lower bound past the first checkpoint so the restart restores rather
    than cold-starts; upper bound leaves slack before completion so the
    trigger is observed while the job is still RUNNING.
    """
    lo = spec.ckpt_every + 2
    hi = max(lo, spec.total_steps - 3)
    return lo, hi
