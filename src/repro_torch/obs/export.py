"""Exporters: run journal -> Chrome trace / filtered timeline / metrics.

The journal (``obs/journal.jsonl``) is the single substrate; everything
here is a pure read-side transform:

  ``to_chrome_trace``     trace-event JSON (``{"traceEvents": [...]}``)
                          loadable in Perfetto / chrome://tracing.  Spans
                          become complete ("X") events laid out per
                          thread; faults and job transitions become
                          instant ("i") markers.
  ``filter_events``       the ``python -m repro_torch events`` timeline:
                          by job and/or event class
                          (dump|restore|transfer|fault|...).
  ``metrics_from_journal``the final metrics snapshot flattened to one
                          ``{name: value}`` dict (``python -m
                          repro_torch metrics --json``).
  ``validate_journal``    schema check (empty list = valid).

The journal format (``VERSION``, ``CLASSES``) is the JAX package's, so
each package's exporters read the other's journals.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.obs.journal import CLASSES, VERSION, read_events


def load_journal(run_dir: str) -> List[Dict[str, Any]]:
    return list(read_events(run_dir))


def _event_job(ev: Dict[str, Any]) -> Optional[str]:
    job = ev.get("job")
    if job is not None:
        return job
    attrs = ev.get("attrs")
    if isinstance(attrs, dict):
        return attrs.get("job")
    return None


def _event_t(ev: Dict[str, Any]) -> float:
    ts = ev.get("ts")           # spans: start time beats emit time
    if isinstance(ts, (int, float)):
        return ts
    return ev.get("t", 0.0)


def filter_events(events: List[Dict[str, Any]],
                  job: Optional[str] = None,
                  cls: Optional[str] = None) -> List[Dict[str, Any]]:
    out = []
    for ev in events:
        if ev.get("cls") == "meta":
            continue
        if cls is not None and ev.get("cls") != cls:
            continue
        if job is not None and _event_job(ev) != job:
            continue
        out.append(ev)
    out.sort(key=_event_t)
    return out


# --------------------------------------------------------- chrome export
def to_chrome_trace(events: List[Dict[str, Any]],
                    process_name: str = "repro_torch") -> Dict[str, Any]:
    """Chrome trace-event JSON.  Timestamps are journal-relative
    microseconds; one tid per producing thread plus marker rows for
    faults and job transitions."""
    trace_events: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}

    def tid_for(thread: str) -> int:
        if thread not in tids:
            tids[thread] = len(tids) + 1
            trace_events.append({
                "ph": "M", "pid": 1, "tid": tids[thread],
                "name": "thread_name", "args": {"name": thread}})
        return tids[thread]

    trace_events.append({"ph": "M", "pid": 1, "tid": 0,
                         "name": "process_name",
                         "args": {"name": process_name}})

    for ev in events:
        cls = ev.get("cls")
        kind = ev.get("kind")
        if kind == "span":
            attrs = ev.get("attrs") or {}
            trace_events.append({
                "name": ev.get("name", "?"),
                "cat": cls or "span",
                "ph": "X",
                "ts": round(float(ev.get("ts", 0.0)) * 1e6, 3),
                "dur": round(float(ev.get("dur", 0.0)) * 1e6, 3),
                "pid": 1,
                "tid": tid_for(ev.get("thread", "?")),
                "args": dict(attrs, span_id=ev.get("span_id"),
                             parent_id=ev.get("parent_id")),
            })
        elif cls == "fault":
            trace_events.append({
                "name": f"fault:{kind}",
                "cat": "fault",
                "ph": "i", "s": "g",
                "ts": round(float(ev.get("t", 0.0)) * 1e6, 3),
                "pid": 1,
                "tid": tid_for("faults"),
                "args": {k: v for k, v in ev.items()
                         if k not in ("v", "cls", "kind", "wall")},
            })
        elif cls == "job" and kind == "transition":
            trace_events.append({
                "name": f"{ev.get('job', '?')}: "
                        f"{ev.get('frm', '?')}->{ev.get('to', '?')}",
                "cat": "job",
                "ph": "i", "s": "t",
                "ts": round(float(ev.get("t", 0.0)) * 1e6, 3),
                "pid": 1,
                "tid": tid_for("jobs"),
                "args": {"job": ev.get("job"), "step": ev.get("step")},
            })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


# --------------------------------------------------------------- metrics
def metrics_from_journal(events: List[Dict[str, Any]]) -> Dict[str, float]:
    """Flatten the last metrics snapshot into ``{name: value}``."""
    snap: Optional[Dict[str, Any]] = None
    for ev in events:
        if ev.get("cls") == "metrics" and ev.get("kind") == "snapshot":
            snap = ev
    if snap is None:
        return {}
    out: Dict[str, float] = {}
    for name, v in (snap.get("counters") or {}).items():
        out[f"obs.counter.{name}"] = v
    for name, v in (snap.get("gauges") or {}).items():
        out[f"obs.gauge.{name}"] = v
    for name, h in (snap.get("histograms") or {}).items():
        for stat in ("count", "sum", "min", "max"):
            out[f"obs.hist.{name}.{stat}"] = h.get(stat)
    return out


# ------------------------------------------------------------ validation
def validate_journal(events: List[Dict[str, Any]]) -> List[str]:
    """Schema problems (empty list = valid)."""
    problems: List[str] = []
    if not events:
        return ["journal is empty"]
    head = events[0]
    if head.get("cls") != "meta" or head.get("kind") != "journal_open":
        problems.append("first event is not meta/journal_open")
    elif head.get("v") != VERSION:
        problems.append(f"unknown journal version {head.get('v')!r}")
    for i, ev in enumerate(events):
        where = f"event {i}"
        cls = ev.get("cls")
        if cls not in CLASSES:
            problems.append(f"{where}: unknown cls {cls!r}")
        if not isinstance(ev.get("kind"), str):
            problems.append(f"{where}: missing kind")
        if not isinstance(ev.get("t"), (int, float)):
            problems.append(f"{where}: missing monotonic t")
        if ev.get("kind") == "span":
            for field in ("name", "ts", "dur", "thread", "span_id"):
                if field not in ev:
                    problems.append(f"{where}: span missing {field!r}")
    return problems
