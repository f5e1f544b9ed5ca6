"""Pre-copy convergence controller — when to stop iterating and freeze.

Port of the reference's ``transfer/precopy.py``.

VM-style iterative pre-copy (and CRIUgpu's preemption-with-a-deadline
motivation) turns migration blackout from O(image) into O(residual): the
job keeps stepping while delta rounds push changed chunks to the target
CAS, and the source only freezes for the *final residual* round once that
residual is predictably small.  The controller here makes exactly that
call after every round, from three observables the round ledger already
records — bytes shipped, wall time, and the bandwidth they imply:

  freeze     a round shipped zero new bytes (the target is current), or
             the predicted residual-push wall fits ``max_blackout_ms``,
             or (no budget set) the rounds stopped shrinking — more
             iteration cannot help.
  fallback   the round cap (``precopy_rounds``) or the cumulative byte
             cap (``residual_bytes_cap``) tripped: the workload dirties
             faster than the link drains, so iterating further only burns
             bandwidth.  The migration degrades to stop-and-copy — freeze
             now and push everything residual, correctness intact, budget
             not guaranteed.
  continue   none of the above; run another live round.

The prediction is deliberately simple and conservative: the next frozen
round ships roughly what the last live round shipped (the dirty rate is
step-driven and the job steps at a steady clip), at the bandwidth the
completed rounds actually achieved.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.api.options import TransferPolicy

# freezing is never byte-free: manifest commit + negotiation overhead make
# a zero-byte residual round still cost a (small) round-trip, so predicted
# blackout gets the observed minimum round wall as a floor
_MIN_WALL_FLOOR = True


@dataclasses.dataclass(frozen=True)
class RoundDecision:
    """What to do after a completed pre-copy round."""
    action: str                    # "continue" | "freeze" | "fallback"
    reason: str
    predicted_residual_bytes: int
    predicted_blackout_ms: Optional[float]   # None until bandwidth is known


class PrecopyController:
    """Feeds on per-round (bytes_sent, wall_s) records; answers
    continue / freeze / fallback after each one.

    Stateless with respect to the transfer itself — rehydrate one from a
    CAS round ledger (``seed()``) to resume an interrupted migration's
    convergence where it left off.
    """

    def __init__(self, policy: TransferPolicy):
        if not policy.precopy_enabled:
            raise ValueError(
                "PrecopyController needs TransferPolicy.precopy_rounds > 0 "
                f"and mode='delta', got {policy!r}")
        self.policy = policy
        self.rounds: List[Dict[str, Any]] = []

    def seed(self, ledger: List[Dict[str, Any]]) -> None:
        """Adopt previously completed rounds (resume from CAS state);
        residual rounds are convergence-terminal and are not replayed."""
        for rec in ledger:
            if not rec.get("residual"):
                self.observe(rec)

    def observe(self, record: Dict[str, Any]) -> None:
        """Record one completed live round ({"bytes_sent", "wall_s", ...})."""
        self.rounds.append({"bytes_sent": int(record.get("bytes_sent", 0)),
                            "wall_s": float(record.get("wall_s", 0.0))})

    # ------------------------------------------------------------ model
    def bandwidth_bytes_per_s(self) -> Optional[float]:
        """Achieved push bandwidth over rounds that moved bytes."""
        moved = [(r["bytes_sent"], r["wall_s"]) for r in self.rounds
                 if r["bytes_sent"] > 0 and r["wall_s"] > 0]
        if not moved:
            return None
        total_b = sum(b for b, _w in moved)
        total_w = sum(w for _b, w in moved)
        return total_b / total_w if total_w > 0 else None

    def predicted_residual_bytes(self) -> int:
        return self.rounds[-1]["bytes_sent"] if self.rounds else 0

    def predicted_blackout_ms(self) -> Optional[float]:
        bw = self.bandwidth_bytes_per_s()
        if bw is None:
            return None
        ms = self.predicted_residual_bytes() / bw * 1000.0
        if _MIN_WALL_FLOOR and self.rounds:
            floor = min(r["wall_s"] for r in self.rounds) * 1000.0
            ms = max(ms, floor)
        return ms

    def cumulative_bytes(self) -> int:
        return sum(r["bytes_sent"] for r in self.rounds)

    # --------------------------------------------------------- decision
    def decide(self) -> RoundDecision:
        pol = self.policy
        pred_b = self.predicted_residual_bytes()
        pred_ms = self.predicted_blackout_ms()
        last = self.rounds[-1] if self.rounds else None

        def _d(action: str, reason: str) -> RoundDecision:
            return RoundDecision(action=action, reason=reason,
                                 predicted_residual_bytes=pred_b,
                                 predicted_blackout_ms=pred_ms)

        if last is not None and last["bytes_sent"] == 0:
            return _d("freeze", "converged: last round shipped 0 bytes")
        if pol.max_blackout_ms is not None and pred_ms is not None \
                and pred_ms <= pol.max_blackout_ms:
            return _d("freeze",
                      f"predicted residual {pred_ms:.1f}ms fits the "
                      f"{pol.max_blackout_ms:.0f}ms blackout budget")
        if pol.residual_bytes_cap is not None \
                and self.cumulative_bytes() > pol.residual_bytes_cap:
            return _d("fallback",
                      f"cumulative pre-copy bytes "
                      f"{self.cumulative_bytes()} exceeded the "
                      f"{pol.residual_bytes_cap}-byte cap")
        if len(self.rounds) >= pol.precopy_rounds:
            return _d("fallback",
                      f"round cap {pol.precopy_rounds} reached without "
                      f"convergence")
        if pol.max_blackout_ms is None and len(self.rounds) >= 2 \
                and self.rounds[-1]["bytes_sent"] >= \
                self.rounds[-2]["bytes_sent"]:
            return _d("freeze",
                      "no budget set and rounds stopped shrinking — "
                      "further iteration cannot reduce the residual")
        return _d("continue", "residual still shrinking")


def summarize_rounds(ledger: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Roll a round ledger up into the stats migration records expose."""
    live = [r for r in ledger if not r.get("residual")]
    resid = [r for r in ledger if r.get("residual")]
    out: Dict[str, Any] = {
        "rounds_completed": len(live),
        "precopy_bytes": sum(int(r.get("bytes_sent", 0)) for r in live),
        "residual_bytes": sum(int(r.get("bytes_sent", 0)) for r in resid),
        "blackout_s": sum(float(r.get("wall_s", 0.0)) for r in resid),
    }
    return out
