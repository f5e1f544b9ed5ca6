"""Optimal checkpoint-interval policy (paper §7 "Deciding when to
Checkpoint").

Periodic checkpointing trades runtime overhead (checkpoint cost δ every τ
seconds) against expected rework after a failure (τ/2 on average).  The
Young/Daly first-order optimum is

    τ* = sqrt(2 · δ · MTBF)

With CRIUgpu-class numbers the point of the paper becomes quantitative:
the *frozen* window δ is what matters for overhead, and the async engine
shrinks δ from full-write cost to device→host copy cost — so τ* drops and
expected lost work falls with it.  ``IntervalPlanner`` feeds live
measurements (engine.last_stats + a failure estimate from the
FailureDetector/cluster telemetry) back into τ*.

LLaMA-3.1 anchor from the paper's §1: 419 interruptions / 54 days / 16k
GPUs → per-job MTBF ≈ 11.1 h; with a 77 s frozen window (paper Table 2,
H100) τ* ≈ 41 min; with our async engine's ~1 s blocked window τ* ≈ 4.7
min and expected lost work per failure drops ~9×.

A copy of the JAX package's ``runtime/interval.py`` (pure Python): the
same inputs give the same intervals in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Mapping, Optional

# preference order for the measured blocked window in an engine stats
# dict: async dumps block only for the device→host copy (locked_total_s),
# sync dumps for the whole dump+write (total_s); frozen_s (capture phase
# only) is the floor either way
_WINDOW_KEYS = ("locked_total_s", "total_s", "frozen_s")


def frozen_window_s(stats: Mapping[str, Any]) -> Optional[float]:
    """Extract the job-blocked window δ from ``engine.last_stats``."""
    for k in _WINDOW_KEYS:
        v = stats.get(k)
        if v is not None:
            return float(v)
    return None


def young_daly(ckpt_cost_s: float, mtbf_s: float) -> float:
    """τ* = sqrt(2 δ M) (guarded for degenerate inputs)."""
    if ckpt_cost_s <= 0:
        return float("inf") if mtbf_s <= 0 else max(mtbf_s * 1e-3, 1e-3)
    if mtbf_s <= 0:
        return float("inf")
    return math.sqrt(2.0 * ckpt_cost_s * mtbf_s)


def expected_overhead_fraction(interval_s: float, ckpt_cost_s: float,
                               mtbf_s: float) -> float:
    """First-order expected overhead (checkpointing + rework) as a fraction
    of runtime: δ/τ + τ/(2M)."""
    if interval_s <= 0 or mtbf_s <= 0:
        return float("inf")
    return ckpt_cost_s / interval_s + interval_s / (2.0 * mtbf_s)


@dataclasses.dataclass
class IntervalPlanner:
    """Adaptive τ*: tracks measured checkpoint cost and failure spacing."""

    mtbf_guess_s: float = 6 * 3600.0
    min_interval_s: float = 30.0
    max_interval_s: float = 24 * 3600.0
    _costs: List[float] = dataclasses.field(default_factory=list)
    _failure_times: List[float] = dataclasses.field(default_factory=list)

    def record_checkpoint_cost(self, blocked_s: float) -> None:
        self._costs.append(float(blocked_s))

    def observe(self, stats: Mapping[str, Any]) -> Optional[float]:
        """Feed one dump's measured stats (``engine.last_stats``) — the
        blocked window is extracted with the async/sync preference above.
        ``CheckpointSession.set_planner`` calls this after every dump."""
        w = frozen_window_s(stats)
        if w is not None:
            self.record_checkpoint_cost(w)
        return w

    def record_failure(self, t_s: float) -> None:
        self._failure_times.append(float(t_s))

    @property
    def ckpt_cost_s(self) -> float:
        if not self._costs:
            return 60.0                     # pessimistic default
        tail = self._costs[-8:]
        return sum(tail) / len(tail)

    @property
    def mtbf_s(self) -> float:
        if len(self._failure_times) < 2:
            return self.mtbf_guess_s
        ts = sorted(self._failure_times)
        gaps = [b - a for a, b in zip(ts, ts[1:]) if b > a]
        return sum(gaps) / len(gaps) if gaps else self.mtbf_guess_s

    def interval_s(self) -> float:
        tau = young_daly(self.ckpt_cost_s, self.mtbf_s)
        return min(max(tau, self.min_interval_s), self.max_interval_s)

    def steps_between_checkpoints(self, step_time_s: float) -> int:
        if step_time_s <= 0:
            return 1
        return max(1, int(round(self.interval_s() / step_time_s)))
