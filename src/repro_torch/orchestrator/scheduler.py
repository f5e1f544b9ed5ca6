"""Priority scheduler over simulated device capacity.

The cluster is abstracted to one number — ``capacity`` device slots — and
jobs demand ``spec.devices`` of them.  Policy (the common preemptive
priority discipline GPU clusters run):

  * admission: waiting jobs (pending / preempted / failed-with-budget) in
    priority order, FIFO within a priority, first-fit into free capacity;
  * preemption: a waiting job may evict strictly-lower-priority running
    jobs when evicting the *lowest*-priority victims frees enough slots.
    Victims get a :class:`Signal.PREEMPT` on the injectable channel and
    keep their slots until they acknowledge (checkpoint-on-signal takes
    real time; capacity is released only after the dump commits).

The scheduler owns no job state beyond the allocation table — lifecycle
transitions stay in the orchestrator, so the policy is unit-testable with
bare :class:`JobRecord`-likes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.orchestrator.job import JobRecord, JobState
from repro_torch.orchestrator.signals import Signal, SignalChannel


@dataclasses.dataclass
class Decision:
    """One planning round: who to admit, who was signalled to yield."""
    admit: List[str] = dataclasses.field(default_factory=list)
    preempt: List[str] = dataclasses.field(default_factory=list)


class Scheduler:
    def __init__(self, capacity: int, channel: SignalChannel):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.channel = channel
        self.allocations: Dict[str, int] = {}     # job_id -> devices held
        self._preempting: set = set()             # signalled, not yet freed
        self._arrival: Dict[str, int] = {}        # job_id -> FIFO order
        self._next_arrival = 0

    # ------------------------------------------------------- accounting
    def free_capacity(self) -> int:
        return self.capacity - sum(self.allocations.values())

    def allocate(self, job_id: str, devices: int) -> None:
        if devices > self.free_capacity():
            raise RuntimeError(
                f"allocating {devices} for {job_id} exceeds free capacity "
                f"{self.free_capacity()}/{self.capacity}")
        self.allocations[job_id] = devices

    def release(self, job_id: str) -> None:
        self.allocations.pop(job_id, None)
        self._preempting.discard(job_id)

    # ------------------------------------------------------- placement
    @staticmethod
    def place(hosts: Sequence[str], load: Dict[str, int],
              avoid: Optional[str] = None) -> str:
        """Pick the host a (re)started job lands on: least-loaded wins,
        ties broken by host order (deterministic).  `avoid` excludes a
        host — a migration must restore somewhere *else* — unless it is
        the only one."""
        candidates = [h for h in hosts if h != avoid] or list(hosts)
        return min(candidates, key=lambda h: (load.get(h, 0),
                                              list(hosts).index(h)))

    # ------------------------------------------------------- planning
    def _waiting(self, records: Dict[str, JobRecord],
                 tick: int) -> List[JobRecord]:
        out = []
        for rec in records.values():
            if rec.spec.arrive_tick > tick:
                continue
            if rec.state == JobState.PENDING or \
               rec.state == JobState.PREEMPTED or \
               (rec.state == JobState.FAILED and not rec.exhausted):
                if rec.spec.job_id not in self._arrival:
                    self._arrival[rec.spec.job_id] = self._next_arrival
                    self._next_arrival += 1
                out.append(rec)
        out.sort(key=lambda r: (-r.spec.priority,
                                self._arrival[r.spec.job_id]))
        return out

    def plan(self, records: Dict[str, JobRecord], tick: int = 0) -> Decision:
        """One scheduling round; sends PREEMPT signals for chosen victims."""
        decision = Decision()
        free = self.free_capacity()
        # slots held by signalled-but-not-yet-frozen victims are already
        # on their way back — count them as incoming, never evict for
        # capacity that an in-flight preemption will free anyway
        incoming = sum(self.allocations.get(v, 0)
                       for v in self._preempting)
        for rec in self._waiting(records, tick):
            need = rec.spec.devices
            if need > self.capacity:
                continue                        # can never fit; skip
            if need <= free:
                decision.admit.append(rec.spec.job_id)
                free -= need
                continue
            shortfall = need - free - incoming
            if shortfall <= 0:
                # served from free + in-flight slots: reserve both sides
                take = min(free, need)
                free -= take
                incoming -= need - take
                continue                        # wait for the freeze
            # try preemption: evict lowest-priority strictly-below us
            victims = self._pick_victims(records, rec.spec.priority,
                                         shortfall)
            if victims:
                for v in victims:
                    self._preempting.add(v)
                    self.channel.send(v, Signal.PREEMPT)
                    decision.preempt.append(v)
                    incoming += self.allocations.get(v, 0)
                take = min(free, need)          # reserve for this job
                free -= take
                incoming -= need - take
                # capacity arrives only after the victims freeze; the
                # waiting job is admitted on a later round
        return decision

    def _pick_victims(self, records: Dict[str, JobRecord],
                      priority: int, needed: int) -> List[str]:
        candidates = [
            (records[j].spec.priority, self._arrival.get(j, 0), j, dev)
            for j, dev in self.allocations.items()
            if j not in self._preempting
            and j in records and records[j].spec.priority < priority
        ]
        candidates.sort()                       # lowest priority first
        victims, freed = [], 0
        for _, _, j, dev in candidates:
            victims.append(j)
            freed += dev
            if freed >= needed:
                return victims
        return []                               # cannot free enough
