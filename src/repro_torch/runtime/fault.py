"""Failure detection + straggler mitigation (cluster-runtime substrate).

At 1000+-node scale the checkpoint engine is driven by signals from a
failure detector (heartbeats) and a straggler monitor (step-time outliers).
Both are implemented host-side and deterministic enough to unit-test:

  * ``FailureDetector`` — heartbeat registry with deadlines; a worker that
    stops beating is reported dead and the runtime restarts from the newest
    valid unified snapshot (paper §7 "Deciding when to Checkpoint").
  * ``StragglerMonitor`` — robust (median + MAD) step-time outlier
    detection; on detection it can trigger a *just-in-time* checkpoint
    (Gupta et al., EuroSys'24 — the paper positions CRIUgpu as the
    mechanism under exactly this policy).

A copy of the JAX package's ``runtime/fault.py`` (host only), with the
injected-failure exception that the trainer and the server both raise.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional


class SimulatedFailure(RuntimeError):
    """An injected crash (``fail_at``) of a training or serving loop."""


class FailureDetector:
    """Each death is reported exactly once: :meth:`dead_workers` returns a
    worker the first time it ages past the deadline, then suppresses it
    until a fresh heartbeat (or re-registration) proves it alive again —
    an evicted-but-not-unregistered worker cannot re-trigger a detection
    storm every tick.  Callers that evict a worker for good should
    :meth:`unregister` it."""

    def __init__(self, deadline_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline_s = deadline_s
        self.clock = clock
        self.last_beat: Dict[str, float] = {}
        self._reported: set = set()

    def register(self, worker: str) -> None:
        self.last_beat[worker] = self.clock()
        self._reported.discard(worker)

    def heartbeat(self, worker: str) -> None:
        self.last_beat[worker] = self.clock()
        self._reported.discard(worker)

    def unregister(self, worker: str) -> None:
        """Forget the worker entirely (evicted / quarantined): it is
        neither tracked nor ever re-reported until re-registered."""
        self.last_beat.pop(worker, None)
        self._reported.discard(worker)

    def _past_deadline(self) -> List[str]:
        now = self.clock()
        return [w for w, t in self.last_beat.items()
                if now - t > self.deadline_s]

    def dead_workers(self) -> List[str]:
        fresh = [w for w in self._past_deadline()
                 if w not in self._reported]
        self._reported.update(fresh)
        return fresh

    def healthy(self) -> bool:
        """Liveness view (non-mutating): no tracked worker is currently
        past its deadline, reported or not."""
        return not self._past_deadline()


class StragglerMonitor:
    def __init__(self, window: int = 32, threshold: float = 3.0,
                 min_samples: int = 8):
        self.window = window
        self.threshold = threshold
        self.min_samples = min_samples
        self.times: List[float] = []
        self.flagged_steps: List[int] = []
        self._step = 0

    def record(self, step_time_s: float) -> bool:
        """Returns True if this step is a straggler."""
        self._step += 1
        history = self.times[-self.window:]
        self.times.append(step_time_s)
        if len(history) < self.min_samples:
            return False
        srt = sorted(history)
        med = srt[len(srt) // 2]
        mad = sorted(abs(t - med) for t in history)[len(history) // 2]
        is_straggler = step_time_s > med + self.threshold * max(mad, 0.05 * med)
        if is_straggler:
            self.flagged_steps.append(self._step)
        return is_straggler

    @property
    def median(self) -> Optional[float]:
        if not self.times:
            return None
        srt = sorted(self.times)
        return srt[len(srt) // 2]


class JITCheckpointPolicy:
    """Just-in-time checkpointing: snapshot when an anomaly signal fires
    (straggler flagged / peer failure reported) instead of on a period."""

    def __init__(self, engine, cooldown_steps: int = 16):
        self.engine = engine
        self.cooldown = cooldown_steps
        self._last = -10**9
        self.triggered: List[int] = []

    def on_signal(self, step: int) -> bool:
        if step - self._last < self.cooldown:
            return False
        self.engine.checkpoint(step)
        self._last = step
        self.triggered.append(step)
        return True
