"""Run journal: append-only JSONL event log per run directory.

One file — ``<run_dir>/obs/journal.jsonl`` — captures everything the
plane sees: finished spans, chaos injections, job state transitions,
stall events, and a metrics snapshot at close, so a post-mortem can
reconstruct an incident timeline with zero live telemetry.

Each line is one JSON object.  Common fields:

    v       journal format version (1)
    cls     event class: dump | restore | transfer | fault | job |
            recovery | pack | metrics | meta
    kind    event kind within the class ("span", "transition",
            "injection", "pending_stall", "snapshot", ...)
    t       seconds since journal open (monotonic clock)
    wall    absolute unix time (float seconds)

Span events add ``name/ts/dur/thread/span_id/parent_id/attrs`` where
``ts`` is span start in journal-relative monotonic seconds.  The opening
``meta/journal_open`` line records ``t0_perf`` (the journal's monotonic
epoch) so timestamps taken elsewhere on the same clock — the
orchestrator's incident marks — can be translated into journal time.

Crash-safety: every event is written and ``flush()``ed as one line, so
an abrupt process death loses at most the final partial line; the reader
tolerates (and reports) a torn tail.

No imports from outside ``repro_torch.obs`` — every layer may depend on this
module without cycles.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

JOURNAL: Optional["RunJournal"] = None

VERSION = 1
CLASSES = ("dump", "restore", "transfer", "fault", "job", "recovery",
           "pack", "orch", "metrics", "meta")


class RunJournal:
    def __init__(self, run_dir: str,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.run_dir = run_dir
        self.path = journal_path(run_dir)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.clock = clock
        self.t0 = clock()
        self._lock = threading.Lock()
        self._f = open(self.path, "a", encoding="utf-8")
        self.event("meta", "journal_open", v=VERSION, t0_perf=self.t0,
                   pid=os.getpid())

    def event(self, cls: str, kind: str, **fields: Any) -> None:
        rec = {"v": VERSION, "cls": cls, "kind": kind,
               "t": self.clock() - self.t0, "wall": time.time()}
        rec.update(fields)
        line = json.dumps(rec, sort_keys=False, default=repr)
        with self._lock:
            f = self._f
            if f.closed:
                return
            f.write(line + "\n")
            f.flush()

    def sync(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._f.close()


# ------------------------------------------------------------- module API
def emit(cls: str, kind: str, **fields: Any) -> None:
    """Append one event to the installed journal (no-op when off).

    Events emitted inside a ``trace.context(job=...)`` block inherit
    the job attribution unless the caller passed ``job=`` explicitly —
    so ``python -m repro_torch events --job J`` lines journal events up with spans."""
    j = JOURNAL
    if j is None:
        return
    if "job" not in fields:
        from repro_torch.obs import trace as _trace
        tr = _trace.TRACER
        if tr is not None:
            job = tr._ctx().get("job")
            if job is not None:
                fields["job"] = job
    j.event(cls, kind, **fields)


def install(jrn: RunJournal) -> None:
    global JOURNAL
    if JOURNAL is not None and JOURNAL is not jrn:
        raise RuntimeError("a run journal is already installed; "
                           "uninstall it first")
    JOURNAL = jrn


def uninstall() -> None:
    global JOURNAL
    JOURNAL = None


# --------------------------------------------------------------- reading
def journal_path(run_dir: str) -> str:
    return os.path.join(run_dir, "obs", "journal.jsonl")


def read_events(run_dir: str) -> Iterator[Dict[str, Any]]:
    """Yield journal events; a torn final line (crash mid-write) is
    skipped rather than fatal."""
    with open(journal_path(run_dir), encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                # torn tail from a crashed writer: drop it
                continue
