"""repro_torch.chaos — seeded fault injection + fleet survivability
campaigns.

Layers:

  * :mod:`repro_torch.chaos.hooks` — the zero-overhead instrumentation
    seam (production code guards every firing on
    ``hooks.INJECTOR is None``);
  * :mod:`repro_torch.chaos.plan` — fault taxonomy + seeded plan
    generation;
  * :mod:`repro_torch.chaos.injector` — matches hook firings against the
    plan and mutates real state (torn bytes, kills, partitions, signals,
    a flipped byte of a live tensor);
  * :mod:`repro_torch.chaos.sim` — a cheap deterministic session-backed
    workload whose bit-exact reference digest is computable in-process;
  * :mod:`repro_torch.chaos.campaign` — drives an orchestrator fleet
    through a fault schedule and asserts the survivability invariant.

This ``__init__`` stays import-light (submodules load lazily): the hook
plane is imported by hot production modules (engine, pack, CAS) and must
not drag the orchestrator stack in with it.
"""
from __future__ import annotations

from repro_torch.chaos import hooks  # noqa: F401  (dependency-free hook plane)

_LAZY = {
    "FAULT_CLASSES": "plan", "ChaosConfig": "plan", "FaultEvent": "plan",
    "ChaosInjectedFault": "plan", "ChaosPartition": "plan",
    "parse_fault_spec": "plan", "generate_plan": "plan",
    "FaultInjector": "injector",
    "SimWorkload": "sim", "make_sim_factory": "sim",
    "reference_digest": "sim",
    "run_campaign": "campaign", "CampaignReport": "campaign",
}

__all__ = ["hooks"] + sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.chaos' has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f"repro_torch.chaos.{mod}"), name)
