"""Phase tracing: nested spans with thread attribution, zero-overhead
when disabled.

Mirrors ``repro_torch.chaos.hooks``: a module-global ``TRACER`` that is
``None`` until ``install()``.  ``span()`` is safe to call unconditionally
on warm paths — when no tracer is installed it returns a shared no-op
singleton (one function call, one attribute load, no per-call state).
Hot per-chunk paths (the pack writer's worker loops) additionally guard
with ``if trace.TRACER is not None and trace.TRACER.detail:`` so the
disabled cost there is a single pointer read.

Spans nest per-thread: a span opened while another is live on the same
thread records that span as its parent, which is what makes the pack
pipeline legible — each compress/append worker carries its own stack, and
the exporter lays them out as Chrome trace rows keyed by thread name.

``record()`` emits a retroactive span from explicit timestamps; the
orchestrator's ``RecoveryLog`` uses it so every recovery phase
(detect/transfer/schedule/restore/background/replay) appears in the
trace as a first-class span instead of parallel bookkeeping.

This module deliberately imports nothing else from ``repro_torch`` so every layer
(serialization, transfer, orchestrator) can depend on it without cycles.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

TRACER: Optional["Tracer"] = None

# span name -> (layer, description); the stable schema the docs table and
# the exporter's class filter (`python -m repro_torch events --class`) key off.  A span's
# event class is its name's first dotted component.
SPAN_SCHEMA: Dict[str, tuple] = {
    "dump.pause": ("engine", "device quiesce: PAUSE_DEVICES hooks"),
    "dump.capture": ("engine", "device->host state capture"),
    "dump.ext_state": ("engine", "host-side external state dump"),
    "dump.write": ("engine", "serialize + commit to storage"),
    "dump.wait_pending": ("engine", "join of the async writer thread"),
    "dump.speculate": ("engine", "concurrent capture: speculative pass"),
    "dump.validate": ("engine", "concurrent capture: validate pause"),
    "dump.patch": ("engine", "concurrent capture: dirty-entry recapture"),
    "dump.commit": ("engine", "manifest + meta commit"),
    "dump.replicate": ("engine", "post-commit replication push"),
    "pack.compress": ("serialization", "one chunk through the codec "
                                       "(detail mode only)"),
    "pack.append": ("serialization", "one chunk appended to its stripe "
                                     "(detail mode only)"),
    "pack.flush": ("serialization", "pipeline drain barrier"),
    "restore.critical": ("engine", "restore() critical path: scan, read, "
                                   "place, resume"),
    "restore.critical_place": ("engine", "critical-set entry placement "
                                         "(inside restore.critical)"),
    "restore.background": ("engine", "lazy background stream"),
    "restore.entry": ("engine", "one background entry "
                                "(detail mode only)"),
    "transfer.push": ("transfer", "full delta-replication push"),
    "transfer.round": ("transfer", "one pre-copy migration round "
                                   "(live or frozen residual)"),
    "transfer.negotiate": ("transfer", "CAS have/want round"),
    "transfer.ship": ("transfer", "missing chunks over the wire"),
    "transfer.materialize": ("transfer", "peer-side pack rebuild"),
    "recovery.detect": ("orchestrator", "interrupt -> noticed"),
    "recovery.transfer": ("orchestrator", "image pre-stage to new host"),
    "recovery.schedule": ("orchestrator", "noticed -> capacity found"),
    "recovery.restore": ("orchestrator", "restore start -> RUNNING"),
    "recovery.restore_background": ("orchestrator",
                                    "resume -> fully materialized"),
    "recovery.replay": ("orchestrator", "restored step -> caught up"),
    "fleet.boot": ("orchestrator", "image -> serving replica "
                                   "(the TTFT window)"),
    "fleet.serve": ("orchestrator", "bursty request trace against the "
                                    "fleet (autoscale inside)"),
}


class _NoopSpan:
    """Shared do-nothing span returned when no tracer is installed."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """One live span; finished (and sunk) when its ``with`` block exits."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "thread",
                 "t_start", "t_end", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any],
                 span_id: int, parent_id: Optional[int]) -> None:
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = span_id
        self.parent_id = parent_id
        self.thread = threading.current_thread().name
        self.t_start = tracer.clock()
        self.t_end: Optional[float] = None

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._finish(self)
        return False


class Tracer:
    """Collects spans; per-thread stacks give nesting, ``sink`` (set by
    the plane) forwards each finished span to the run journal."""

    def __init__(self, sink: Optional[Callable[[Span], None]] = None,
                 detail: bool = False,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.sink = sink
        self.detail = detail       # opt-in per-chunk spans on hot paths
        self.clock = clock
        self.t0 = clock()
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)

    # ------------------------------------------------------------- stacks
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _ctx(self) -> Dict[str, Any]:
        ctx = getattr(self._tls, "ctx", None)
        if ctx is None:
            ctx = self._tls.ctx = {}
        return ctx

    # -------------------------------------------------------------- spans
    def begin(self, name: str, attrs: Dict[str, Any]) -> Span:
        ctx = self._ctx()
        if ctx:
            merged = dict(ctx)
            merged.update(attrs)
            attrs = merged
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        sp = Span(self, name, attrs, next(self._ids), parent)
        stack.append(sp)
        return sp

    def _finish(self, sp: Span) -> None:
        sp.t_end = self.clock()
        stack = self._stack()
        if sp in stack:                      # tolerate exits out of order
            stack.remove(sp)
        with self._lock:
            self.spans.append(sp)
        if self.sink is not None:
            self.sink(sp)

    def record(self, name: str, t_start: float, t_end: float,
               attrs: Dict[str, Any]) -> Span:
        """Retroactive span from explicit (tracer-clock) timestamps."""
        sp = Span(self, name, dict(attrs), next(self._ids), None)
        sp.t_start = t_start
        sp.t_end = max(t_start, t_end)
        with self._lock:
            self.spans.append(sp)
        if self.sink is not None:
            self.sink(sp)
        return sp

    # ------------------------------------------------------------ context
    class _Ctx:
        __slots__ = ("_tracer", "_saved")

        def __init__(self, tracer: "Tracer", attrs: Dict[str, Any]) -> None:
            self._tracer = tracer
            ctx = tracer._ctx()
            self._saved = dict(ctx)
            ctx.update(attrs)

        def __enter__(self) -> "Tracer._Ctx":
            return self

        def __exit__(self, *exc: Any) -> bool:
            self._tracer._tls.ctx = self._saved
            return False


class _NoopCtx:
    __slots__ = ()

    def __enter__(self) -> "_NoopCtx":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NOOP_CTX = _NoopCtx()


# ------------------------------------------------------------- module API
def span(name: str, **attrs: Any):
    """Open a span, or return the shared no-op when tracing is off."""
    tr = TRACER
    if tr is None:
        return NOOP_SPAN
    return tr.begin(name, attrs)


def record(name: str, t_start: float, t_end: float, **attrs: Any) -> None:
    """Emit a retroactive span (no-op when tracing is off)."""
    tr = TRACER
    if tr is not None:
        tr.record(name, t_start, t_end, attrs)


def context(**attrs: Any):
    """Attach attrs (e.g. ``job=...``) to every span opened on this
    thread inside the ``with`` block.  No-op when tracing is off."""
    tr = TRACER
    if tr is None:
        return _NOOP_CTX
    return Tracer._Ctx(tr, attrs)


def current_context() -> Dict[str, Any]:
    """Copy of the calling thread's span context — capture it before
    spawning a worker thread, re-apply inside with ``context(**saved)``
    so spans the worker emits keep e.g. their job attribution."""
    tr = TRACER
    if tr is None:
        return {}
    return dict(tr._ctx())


def install(tracer: Tracer) -> None:
    global TRACER
    if TRACER is not None and TRACER is not tracer:
        raise RuntimeError("a tracer is already installed; "
                           "uninstall it first")
    TRACER = tracer


def uninstall() -> None:
    global TRACER
    TRACER = None
