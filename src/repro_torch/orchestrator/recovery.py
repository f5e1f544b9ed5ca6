"""Recovery-time accounting: per-incident phase breakdown + goodput.

The paper's headline numbers are *recovery time* and *steady-state
overhead*; a multi-tenant cluster adds the phases around the mechanism.
Each interruption (preemption, failure, straggler-triggered JIT dump that
turned into a reschedule) becomes one ``incident`` with four measured
phases:

    detect_s    interruption happened -> orchestrator noticed
                (signal delivery is ~0; heartbeat death costs the deadline)
    transfer_s  image moved to the host the job restarts on (cross-host
                migration: the delta-replication push; zero-width when the
                job comes back where its image already is)
    schedule_s  noticed -> scheduler found capacity again
    restore_s   restore started -> the job RESUMED.  Under a lazy
                (resume-before-read) restore this is the *critical* set
                only — the job is running again while the cold tail
                still streams; also surfaced as ``restore_critical_s``
                in the breakdown
    restore_background_s
                resumed -> the background stream finished materializing
                the rest of the image (zero-width for eager restores).
                Overlaps replay, which is exactly why GoodputMeter
                credits the earlier resume: replayed steps start
                accruing at t_restored, not at full materialization
    replay_s    restored step -> step at interruption re-reached (work
                lost since the last checkpoint, re-executed)

Goodput is useful-step-seconds / wall-clock: a step's cost counts as
useful once — re-executions of replayed steps count only against the
denominator.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.obs import journal as obs_journal
from repro_torch.obs import trace as obs_trace

PHASES = ("detect_s", "transfer_s", "schedule_s", "restore_s",
          "restore_background_s", "replay_s")


class RecoveryLog:
    """Timestamped incidents for one job; at most one open at a time.

    Every phase mark doubles as a retroactive span (``recovery.detect``,
    ``recovery.transfer``, ``recovery.schedule``, ``recovery.restore``,
    ``recovery.restore_background``, ``recovery.replay``) when the obs
    plane is installed — the incident dict stays the persisted record,
    but the *trace* is the first-class timeline: each phase is one block,
    attributed to ``job_id``."""

    def __init__(self, job_id: Optional[str] = None) -> None:
        self.incidents: List[Dict[str, Any]] = []
        self.job_id = job_id

    def _span(self, inc: Dict[str, Any], name: str,
              ta: Optional[float], tb: Optional[float],
              **attrs: Any) -> None:
        if obs_trace.TRACER is None or ta is None or tb is None:
            return
        obs_trace.record(name, ta, tb, job=self.job_id,
                         cause=inc.get("cause"), **attrs)

    # ------------------------------------------------------------ record
    def open(self, cause: str, t_interrupt: float, t_detect: float,
             step_at_interrupt: int,
             last_ckpt_step: Optional[int]) -> Dict[str, Any]:
        inc = {"cause": cause,
               "t_interrupt": t_interrupt,
               "t_detect": t_detect,
               "t_transfer_start": None,
               "t_transfer_end": None,
               "t_scheduled": None,
               "t_restored": None,
               "t_materialized": None,
               "t_caught_up": None,
               "step_at_interrupt": step_at_interrupt,
               "last_ckpt_step": last_ckpt_step,
               "restored_step": None,
               "meta": {}}
        self.incidents.append(inc)
        self._span(inc, "recovery.detect", t_interrupt, t_detect,
                   step=step_at_interrupt)
        obs_journal.emit("recovery", "incident_open", job=self.job_id,
                         cause=cause, step=step_at_interrupt,
                         last_ckpt_step=last_ckpt_step)
        return inc

    @property
    def current(self) -> Optional[Dict[str, Any]]:
        if self.incidents and self.incidents[-1]["t_caught_up"] is None:
            return self.incidents[-1]
        return None

    def mark_transfer(self, t_start: float, t_end: float,
                      rounds: Optional[List[Dict[str, Any]]] = None,
                      **meta: Any) -> None:
        """Record the cross-host image-transfer window (between detect
        and schedule: the orchestrator pre-stages the image on the
        destination before the scheduler re-admits the job).

        ``rounds`` attributes the window: one entry per transfer round
        ({"round", "bytes_sent", "wall_s", "residual", ...}).  Pre-copy
        migrations record every live round plus the frozen residual;
        stop-and-copy records a single residual round.  The per-round
        ledger is what makes a blackout regression attributable — which
        round grew, not just that the lump sum did."""
        if self.current is not None:
            inc = self.current
            inc["t_transfer_start"] = t_start
            inc["t_transfer_end"] = t_end
            if rounds is not None:
                inc["transfer_rounds"] = [dict(r) for r in rounds]
            inc["meta"].update(meta)
            self._span(inc, "recovery.transfer", t_start, t_end,
                       rounds=len(rounds) if rounds else 0)

    def mark_scheduled(self, t: float) -> None:
        if self.current is not None:
            inc = self.current
            inc["t_scheduled"] = t
            # transfer (if any) happens inside the detect->schedule
            # window; the schedule span starts where it ended so the
            # trace rows butt up instead of overlapping
            anchor = (inc["t_transfer_end"]
                      if inc.get("t_transfer_end") is not None
                      else inc["t_detect"])
            self._span(inc, "recovery.schedule", anchor, t)

    def mark_restored(self, t: float, restored_step: int,
                      **meta: Any) -> None:
        if self.current is not None:
            inc = self.current
            inc["t_restored"] = t
            inc["restored_step"] = restored_step
            inc["meta"].update(meta)
            self._span(inc, "recovery.restore", inc.get("t_scheduled"), t,
                       restored_step=restored_step)

    def mark_materialized(self, t: float, **meta: Any) -> None:
        """The lazy background stream finished: the whole image is on
        devices.  May legitimately land *after* catch-up (replay overlaps
        the stream), so this targets the newest incident that restored
        but has no materialization timestamp yet."""
        for inc in reversed(self.incidents):
            if inc.get("t_restored") is not None \
                    and inc.get("t_materialized") is None:
                inc["t_materialized"] = t
                inc["meta"].update(meta)
                self._span(inc, "recovery.restore_background",
                           inc["t_restored"], t)
                return

    def mark_caught_up(self, t: float) -> None:
        if self.current is not None:
            inc = self.current
            inc["t_caught_up"] = t
            self._span(inc, "recovery.replay", inc.get("t_restored"), t,
                       step=inc["step_at_interrupt"])
            obs_journal.emit("recovery", "incident_closed",
                             job=self.job_id, cause=inc["cause"],
                             step=inc["step_at_interrupt"],
                             restored_step=inc["restored_step"])

    # ------------------------------------------------------------ report
    @staticmethod
    def _breakdown(inc: Dict[str, Any]) -> Dict[str, Any]:
        def gap(a, b):
            # .get: records persisted before the transfer phase existed
            # have no t_transfer_* keys
            ta, tb = inc.get(a), inc.get(b)
            if ta is None or tb is None:
                return None
            return max(0.0, tb - ta)

        transfer_s = gap("t_transfer_start", "t_transfer_end")
        # the transfer (if any) happens inside the detect→schedule window;
        # account it separately so schedule_s stays pure queueing time
        schedule_anchor = ("t_transfer_end"
                           if inc.get("t_transfer_end") is not None
                           else "t_detect")
        restore_s = gap("t_scheduled", "t_restored")
        out = {"cause": inc["cause"],
               "detect_s": gap("t_interrupt", "t_detect"),
               "transfer_s": transfer_s,
               "schedule_s": gap(schedule_anchor, "t_scheduled"),
               # restore_s ends at RESUME: under a lazy restore that is
               # the critical set only (alias restore_critical_s);
               # the background tail is accounted separately and
               # overlaps replay
               "restore_s": restore_s,
               "restore_critical_s": restore_s,
               "restore_background_s": gap("t_restored",
                                           "t_materialized"),
               "replay_s": gap("t_restored", "t_caught_up"),
               "total_s": gap("t_interrupt", "t_caught_up"),
               "steps_replayed": None,
               # per-round transfer attribution (pre-copy migrations);
               # [] for incidents recorded before rounds existed
               "transfer_rounds": [dict(r) for r in
                                   inc.get("transfer_rounds", [])],
               "meta": dict(inc["meta"])}
        if inc["restored_step"] is not None:
            out["steps_replayed"] = (inc["step_at_interrupt"]
                                     - inc["restored_step"])
        return out

    def breakdown(self) -> List[Dict[str, Any]]:
        return [self._breakdown(i) for i in self.incidents]

    def totals(self) -> Dict[str, float]:
        """Phase sums across closed incidents (the bench's table rows)."""
        tot = {k: 0.0 for k in PHASES + ("total_s",)}
        tot["incidents"] = 0
        for b in self.breakdown():
            if b["total_s"] is None:
                continue
            tot["incidents"] += 1
            for k in PHASES + ("total_s",):
                if b[k] is not None:
                    tot[k] += b[k]
        return tot

    # ------------------------------------------------------- persistence
    def to_list(self) -> List[Dict[str, Any]]:
        return [dict(i) for i in self.incidents]

    @classmethod
    def from_list(cls, items: List[Dict[str, Any]]) -> "RecoveryLog":
        log = cls()
        log.incidents = [dict(i) for i in items]
        return log


class GoodputMeter:
    """Useful-step-seconds / wall-clock, replay-aware.

    ``record_slice(start_step, end_step, wall_s)`` attributes the slice's
    wall time to the steps in ``[start_step, end_step)``; a step index
    executed more than once (replay after restoring to an older
    checkpoint) is useful only once.
    """

    def __init__(self) -> None:
        self.step_seconds = 0.0         # cost of every executed step
        self.steps_executed = 0         # including re-executions
        self.max_step = 0               # highest step index completed

    def record_slice(self, start_step: int, end_step: int,
                     wall_s: float) -> None:
        n = max(0, end_step - start_step)
        if n == 0:
            return
        self.steps_executed += n
        self.step_seconds += wall_s
        self.max_step = max(self.max_step, end_step)

    @property
    def useful_steps(self) -> int:
        return self.max_step

    def useful_step_seconds(self) -> float:
        if self.steps_executed == 0:
            return 0.0
        return self.step_seconds * (self.useful_steps
                                    / self.steps_executed)

    def goodput(self, wall_clock_s: float) -> float:
        if wall_clock_s <= 0:
            return 0.0
        return self.useful_step_seconds() / wall_clock_s

    # ------------------------------------------------------- persistence
    def to_dict(self) -> Dict[str, float]:
        return {"step_seconds": self.step_seconds,
                "steps_executed": self.steps_executed,
                "max_step": self.max_step}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GoodputMeter":
        m = cls()
        m.step_seconds = d.get("step_seconds", 0.0)
        m.steps_executed = d.get("steps_executed", 0)
        m.max_step = d.get("max_step", 0)
        return m
