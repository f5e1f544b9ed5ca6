"""Chaos hook plane — the zero-overhead seam the fault injector plugs into.

Production code calls ``fire(site, **ctx)`` at a handful of narrow
instrumentation points (pack stripe writes, snapshot commit, CAS put/get,
signal delivery, the orchestrator tick).  Every call site guards with

    if hooks.INJECTOR is not None:
        hooks.fire("site.name", ...)

so the steady-state cost is one module-attribute load and a ``None``
check — the same design discipline as the paper's no-interception
argument: when no fault injector is installed,
the dump/restore path is byte-for-byte the code that ran before the
chaos subsystem existed, and injection adds zero entries to any stats.

This module deliberately imports nothing else from ``repro_torch`` so that every
layer (serialization, transfer, core, orchestrator) can import it
without cycles.
"""
from __future__ import annotations

from typing import Any, Optional

# The installed FaultInjector, or None (chaos disabled — the default).
INJECTOR: Optional[Any] = None


def fire(site: str, **ctx: Any) -> Any:
    """Dispatch one hook to the installed injector (no-op when none).

    Returns whatever the injector's handler returns; call sites that
    honor a return value (e.g. ``"defer"`` from ``signal.send``) document
    it at the site.  Handlers may also raise — an injected fault
    propagates exactly like the real failure it models.
    """
    inj = INJECTOR
    if inj is None:
        return None
    return inj.on(site, **ctx)


def install(injector: Any) -> None:
    global INJECTOR
    if INJECTOR is not None and INJECTOR is not injector:
        raise RuntimeError("a chaos injector is already installed; "
                           "uninstall it first")
    INJECTOR = injector


def uninstall() -> None:
    global INJECTOR
    INJECTOR = None
