"""Job lifecycle: spec, state machine, and JSON persistence.

A job is one checkpointable workload (training run or decode-serving
session) owned by the orchestrator.  Its lifecycle mirrors what a cluster
scheduler sees of a CRIUgpu-managed container:

    pending -> running -> freezing -> preempted -> restoring -> running -> done
                      \\-> failed ----------------^

Every transition is timestamped and the whole record is persisted as one
JSON file under ``<run_dir>/jobs/<job_id>.json`` (atomic rename), so a
cluster's jobs can be inspected without the owning process.  The record
is the JAX package's format: ``python -m repro jobs RUN_DIR`` reads the
port's records, and each package loads the other's.
"""
from __future__ import annotations

import dataclasses
import enum
import os
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs import journal as obs_journal
from repro_torch.orchestrator.recovery import GoodputMeter, RecoveryLog
from repro_torch.serialization.integrity import atomic_write_json, read_json


class JobState(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    FREEZING = "freezing"          # checkpoint-on-signal in progress
    PREEMPTED = "preempted"
    FAILED = "failed"
    RESTORING = "restoring"
    DONE = "done"


# state machine: pending → running → freezing → preempted/failed →
# restoring → running → done
VALID_TRANSITIONS = {
    JobState.PENDING: {JobState.RUNNING},
    JobState.RUNNING: {JobState.FREEZING, JobState.FAILED, JobState.DONE},
    JobState.FREEZING: {JobState.PREEMPTED, JobState.FAILED},
    JobState.PREEMPTED: {JobState.RESTORING},
    JobState.FAILED: {JobState.RESTORING},
    JobState.RESTORING: {JobState.RUNNING, JobState.FAILED},
    JobState.DONE: set(),
}

TERMINAL_STATES = {JobState.DONE}


class InvalidTransition(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """Immutable description of one job (the scheduler's admission unit)."""

    job_id: str
    kind: str = "train"             # "train" | "serve" | "intercept"
    priority: int = 0               # higher preempts lower
    devices: int = 1                # simulated device demand
    total_steps: int = 8            # steps to train / tokens to decode
    ckpt_every: int = 0             # 0 = planner-driven cadence
    arrive_tick: int = 0            # scheduler ignores the job before this
    fail_at_step: Optional[int] = None      # injected crash
    straggle_at_step: Optional[int] = None  # injected stall
    migrate_at_step: Optional[int] = None   # live-migrate to another host
    max_restarts: int = 3

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "JobSpec":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def jobs_dir(run_dir: str) -> str:
    return os.path.join(run_dir, "jobs")


def job_record_path(run_dir: str, job_id: str) -> str:
    return os.path.join(jobs_dir(run_dir), f"{job_id}.json")


class JobRecord:
    """Mutable runtime state of one job, persisted on every transition."""

    def __init__(self, spec: JobSpec, run_dir: Optional[str] = None,
                 clock=time.monotonic):
        self.spec = spec
        self.run_dir = run_dir          # orchestrator run dir (persistence)
        self.clock = clock
        self.state = JobState.PENDING
        self.step = 0
        self.host: Optional[str] = None  # placement (multi-host clusters)
        self.attempt = 0                # workload incarnations so far
        self.restarts = 0               # recoveries (preempt or failure)
        self.last_ckpt_step: Optional[int] = None
        self.events: List[Dict[str, Any]] = []
        self.recovery = RecoveryLog(job_id=spec.job_id)
        self.goodput = GoodputMeter()
        self.created_t = self.clock()
        self.finished_t: Optional[float] = None

    # ------------------------------------------------------- transitions
    def transition(self, to: JobState, **meta: Any) -> None:
        if to not in VALID_TRANSITIONS[self.state]:
            raise InvalidTransition(
                f"job {self.spec.job_id}: {self.state.value} -> {to.value} "
                f"is not a legal transition")
        now = self.clock()
        self.events.append({"t": now, "from": self.state.value,
                            "to": to.value, "step": self.step, **meta})
        obs_journal.emit("job", "transition", job=self.spec.job_id,
                         frm=self.state.value, to=to.value,
                         step=self.step)
        self.state = to
        if to == JobState.RESTORING:
            self.restarts += 1
        if to == JobState.DONE:
            self.finished_t = now
        self.save()

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def exhausted(self) -> bool:
        """Failed with no restart budget left (effectively terminal)."""
        return (self.state == JobState.FAILED
                and self.restarts >= self.spec.max_restarts)

    # ------------------------------------------------------- persistence
    def to_dict(self) -> Dict[str, Any]:
        return {
            "format": 1,
            "spec": self.spec.to_dict(),
            "state": self.state.value,
            "step": self.step,
            "host": self.host,
            "attempt": self.attempt,
            "restarts": self.restarts,
            "last_ckpt_step": self.last_ckpt_step,
            "created_t": self.created_t,
            "finished_t": self.finished_t,
            "events": self.events,
            "recovery": self.recovery.to_list(),
            "goodput": self.goodput.to_dict(),
        }

    def save(self) -> None:
        if self.run_dir is None:
            return
        os.makedirs(jobs_dir(self.run_dir), exist_ok=True)
        atomic_write_json(job_record_path(self.run_dir, self.spec.job_id),
                          self.to_dict())

    @classmethod
    def load(cls, run_dir: str, job_id: str) -> "JobRecord":
        d = read_json(job_record_path(run_dir, job_id))
        rec = cls(JobSpec.from_dict(d["spec"]), run_dir=None)
        rec.run_dir = run_dir
        rec.state = JobState(d["state"])
        rec.step = d["step"]
        rec.host = d.get("host")
        rec.attempt = d["attempt"]
        rec.restarts = d["restarts"]
        rec.last_ckpt_step = d.get("last_ckpt_step")
        rec.created_t = d.get("created_t", 0.0)
        rec.finished_t = d.get("finished_t")
        rec.events = list(d.get("events", []))
        rec.recovery = RecoveryLog.from_list(d.get("recovery", []))
        rec.recovery.job_id = rec.spec.job_id
        rec.goodput = GoodputMeter.from_dict(d.get("goodput", {}))
        return rec


def list_job_records(run_dir: str) -> List[JobRecord]:
    """All persisted job records under `run_dir` (offline inspection)."""
    d = jobs_dir(run_dir)
    if not os.path.isdir(d):
        return []
    out = []
    for name in sorted(os.listdir(d)):
        if name.endswith(".json"):
            out.append(JobRecord.load(run_dir, name[:-len(".json")]))
    return out
