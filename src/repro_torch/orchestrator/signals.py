"""Injectable signal channel — the SIGTERM-of-the-cluster analogue.

Kubernetes sends SIGTERM and gives the pod a grace window; CRIUgpu's
answer is "dump inside the window, exit clean".  Here the scheduler posts
a :class:`Signal` onto the channel; delivery is two-tier:

  * an optional registered handler fires synchronously at send time (the
    signal-handler analogue — the orchestrator uses it to timestamp the
    delivery into the job's event record), and
  * the workload's step loop polls ``pending()`` between steps (the
    in-band check the dump actually hangs off — ``Trainer.run_until``'s
    ``preempt=`` callable).

Everything is in-process and deterministic so tests and the bench can
script exact preemption points, but the interface is what a real signal
path (signalfd / SIGTERM trap) would present to the orchestrator.
"""
from __future__ import annotations

import enum
from typing import Callable, Dict, List, Optional

from repro_torch.chaos import hooks as chaos_hooks


class Signal(str, enum.Enum):
    PREEMPT = "SIGPREEMPT"          # checkpoint then yield the devices
    KILL = "SIGKILL"                # no grace: drop without dumping


class SignalChannel:
    def __init__(self) -> None:
        self._pending: Dict[str, List[Signal]] = {}
        self._handlers: Dict[str, Callable[[Signal], None]] = {}
        self.sent: List[tuple] = []          # (job_id, signal) audit trail

    def register(self, job_id: str,
                 handler: Callable[[Signal], None]) -> None:
        self._handlers[job_id] = handler

    def unregister(self, job_id: str) -> None:
        self._handlers.pop(job_id, None)
        self._pending.pop(job_id, None)

    def send(self, job_id: str, sig: Signal = Signal.PREEMPT) -> None:
        if chaos_hooks.INJECTOR is not None:
            # chaos: flaky-delivery site — a handler may duplicate this
            # signal (it appends the extra copy itself) or defer it
            # (returns "defer"; the injector redelivers it later)
            if chaos_hooks.fire("signal.send", channel=self,
                                job_id=job_id, sig=sig) == "defer":
                return
        self._pending.setdefault(job_id, []).append(sig)
        self.sent.append((job_id, sig))
        handler = self._handlers.get(job_id)
        if handler is not None:
            handler(sig)

    def pending(self, job_id: str) -> Optional[Signal]:
        """Peek (non-destructive): the oldest undelivered signal."""
        q = self._pending.get(job_id)
        return q[0] if q else None

    def consume(self, job_id: str) -> Optional[Signal]:
        """Pop the oldest signal (the workload acknowledged it)."""
        q = self._pending.get(job_id)
        if not q:
            return None
        sig = q.pop(0)
        if not q:
            self._pending.pop(job_id, None)
        return sig

    def checker(self, job_id: str) -> Callable[[], bool]:
        """Zero-arg predicate for ``Trainer.run_until(preempt=...)``."""
        return lambda: self.pending(job_id) is not None
