"""Metrics registry: counters / gauges / histograms behind a stable
name schema, zero-overhead when disabled.

Same discipline as ``repro_torch.obs.trace``: the module-global ``REGISTRY``
is ``None`` until installed, and the module-level helpers
(``counter_add`` / ``gauge_set`` / ``observe``) are safe to call
unconditionally — disabled cost is one attribute load + ``None`` check.

Histograms are summaries (count/sum/min/max), not bucketed: the journal
stores one snapshot per plane lifetime and the consumers (bench tables,
``python -m repro_torch metrics``) want totals and extremes, not percentiles.

``warn_once`` is the one piece that works without installation: it
flags configuration holes (a replicator with no ``last_stats``) exactly
once per process instead of silently dropping counters.

No other ``repro_torch`` imports — every layer may depend on this module.
"""
from __future__ import annotations

import threading
import warnings
from typing import Any, Dict, Optional

REGISTRY: Optional["MetricsRegistry"] = None

# name -> (type, unit, description): the stable schema table.  Docs and
# tests key off this; add the row when adding a call site.
METRIC_SCHEMA: Dict[str, tuple] = {
    "dump.count": ("counter", "dumps", "checkpoints committed"),
    "dump.bytes_written": ("counter", "bytes", "new pack bytes on disk"),
    "dump.bytes_deduped": ("counter", "bytes",
                           "chunk-grain dedup savings at commit"),
    "dump.frozen_s": ("histogram", "s", "stop-the-world frozen window"),
    "dump.pending_stall_s": ("histogram", "s",
                             "async writer join timeouts "
                             "(PendingWriteStalled)"),
    "pack.chunks": ("counter", "chunks", "chunks through the pipeline"),
    "pack.queue_depth": ("gauge", "chunks",
                         "compress-queue depth at last sample"),
    "restore.count": ("counter", "restores", "restores completed"),
    "restore.critical_s": ("histogram", "s",
                           "lock-held critical restore phase"),
    "restore.heal_events": ("counter", "events",
                            "corrupt entries healed during lazy "
                            "materialization"),
    "replica.push_count": ("counter", "pushes",
                           "replication pushes attempted"),
    "replica.missing_stats": ("counter", "pushes",
                              "pushes whose replicator exposed no "
                              "last_stats (silent-loss guard)"),
    # replica.<k> mirrors every numeric counter a replicator reports in
    # last_stats (bytes_sent, chunks_reused, ...): dynamic keys, one
    # schema row.
    "replica.*": ("counter", "mixed", "replicator last_stats mirror"),
    "chaos.injections": ("counter", "events", "faults actually armed"),
    "fleet.replicas_booted": ("counter", "replicas",
                              "fleet boots attempted"),
    "fleet.replicas_serving": ("gauge", "replicas",
                               "replicas currently serving"),
    "fleet.ttft_s": ("histogram", "s",
                     "per-replica time-to-first-token"),
    "fleet.restore_bytes": ("counter", "bytes",
                            "delta bytes shipped booting replicas"),
    "fleet.requests_served": ("counter", "requests",
                              "requests completed by the fleet"),
}


class MetricsRegistry:
    """Thread-safe in-process registry; ``snapshot()`` is what the plane
    journals at close."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Dict[str, float]] = {}

    def counter_add(self, name: str, v: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + v

    def gauge_set(self, name: str, v: float) -> None:
        with self._lock:
            self.gauges[name] = v

    def observe(self, name: str, v: float) -> None:
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = {"count": 0, "sum": 0.0,
                                        "min": v, "max": v}
            h["count"] += 1
            h["sum"] += v
            h["min"] = min(h["min"], v)
            h["max"] = max(h["max"], v)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"counters": dict(self.counters),
                    "gauges": dict(self.gauges),
                    "histograms": {k: dict(v)
                                   for k, v in self.hists.items()}}


# ------------------------------------------------------------- module API
def counter_add(name: str, v: float = 1.0) -> None:
    reg = REGISTRY
    if reg is not None:
        reg.counter_add(name, v)


def gauge_set(name: str, v: float) -> None:
    reg = REGISTRY
    if reg is not None:
        reg.gauge_set(name, v)


def observe(name: str, v: float) -> None:
    reg = REGISTRY
    if reg is not None:
        reg.observe(name, v)


_warned: set = set()
_warned_lock = threading.Lock()


def warn_once(key: str, message: str) -> None:
    """Emit ``message`` as a RuntimeWarning once per process per key,
    with or without an installed registry."""
    with _warned_lock:
        if key in _warned:
            return
        _warned.add(key)
    warnings.warn(message, RuntimeWarning, stacklevel=3)


def install(registry: MetricsRegistry) -> None:
    global REGISTRY
    if REGISTRY is not None and REGISTRY is not registry:
        raise RuntimeError("a metrics registry is already installed; "
                           "uninstall it first")
    REGISTRY = registry


def uninstall() -> None:
    global REGISTRY
    REGISTRY = None
