"""ObservabilityPlane: one run directory's tracer + registry + journal,
wired together and installed/uninstalled as a unit.

The tracer's sink is the journal, so every finished span becomes one
JSONL event immediately (crash-safe: the journal flushes per line).  At
``close()`` the plane journals a final metrics snapshot — the flat dict
``python -m repro_torch metrics`` reads back.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional

from repro_torch.obs import journal as journal_mod
from repro_torch.obs import metrics as metrics_mod
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.journal import RunJournal
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Span, Tracer


class ObservabilityPlane:
    def __init__(self, run_dir: str, detail: bool = False) -> None:
        self.run_dir = run_dir
        self.journal = RunJournal(run_dir)
        self.tracer = Tracer(sink=self._on_span, detail=detail,
                             clock=self.journal.clock)
        self.registry = MetricsRegistry()
        self._installed = False

    # ------------------------------------------------------------- wiring
    def _on_span(self, sp: Span) -> None:
        j = self.journal
        cls = sp.name.split(".", 1)[0]
        if cls not in journal_mod.CLASSES:
            cls = "orch"
        t_end: float = sp.t_end if sp.t_end is not None else sp.t_start
        j.event(cls, "span", name=sp.name,
                ts=sp.t_start - j.t0, dur=t_end - sp.t_start,
                thread=sp.thread, span_id=sp.span_id,
                parent_id=sp.parent_id, attrs=sp.attrs)

    # ---------------------------------------------------------- lifecycle
    def install(self) -> "ObservabilityPlane":
        trace_mod.install(self.tracer)
        metrics_mod.install(self.registry)
        journal_mod.install(self.journal)
        self._installed = True
        return self

    def close(self) -> None:
        snap = self.registry.snapshot()
        self.journal.event("metrics", "snapshot", **snap)
        if self._installed:
            trace_mod.uninstall()
            metrics_mod.uninstall()
            journal_mod.uninstall()
            self._installed = False
        self.journal.close()


@contextmanager
def observed(run_dir: str,
             detail: bool = False) -> Iterator[Optional[ObservabilityPlane]]:
    """Install a plane for ``run_dir`` for the duration of the block."""
    plane = ObservabilityPlane(run_dir, detail=detail)
    plane.install()
    try:
        yield plane
    finally:
        plane.close()
