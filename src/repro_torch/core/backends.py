"""Versioned device-backend registry — the CUDA/ROCm plugin split.

CRIUgpu registers its device plugins against the CRIU plugin API with a
version stamp, so a CRIU built for another plugin ABI refuses them (paper
§3.1.3).  As in the reference, a backend is a named, versioned,
feature-stamped plugin that owns the device side of the dump/restore hook
sequence:

  "torch" — tensors on one device, CUDA or CPU (``TorchBackend``): device
            lock, pinned D2H capture, H2D restore.  The default.
  "host"  — captures like "torch" but restores host numpy arrays without
            touching a device: image surgery and dry-run restores.

A registration with another ``api_version`` is rejected.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, FrozenSet, Iterable

from repro_torch.core.device_plugin import (TORCH_BACKEND_FEATURES,
                                            TorchBackend)
from repro_torch.core.plugins import (PLUGIN_API_VERSION, HookContext,
                                      Plugin, PluginVersionError)


class BackendError(RuntimeError):
    """Unknown backend name or invalid registration."""


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str
    factory: Callable[..., Plugin]
    api_version: int
    features: FrozenSet[str]
    description: str = ""


_REGISTRY: Dict[str, BackendSpec] = {}


def register_backend(name: str, factory: Callable[..., Plugin], *,
                     api_version: int,
                     features: Iterable[str] = (),
                     description: str = "",
                     override: bool = False) -> BackendSpec:
    """Register a device backend under `name`; rejects (PluginVersionError)
    an api_version other than the one this engine speaks."""
    if api_version != PLUGIN_API_VERSION:
        raise PluginVersionError(
            f"backend {name!r} declares api_version={api_version}; "
            f"this engine speaks api_version={PLUGIN_API_VERSION}")
    if name in _REGISTRY and not override:
        raise BackendError(f"backend {name!r} already registered")
    spec = BackendSpec(name=name, factory=factory, api_version=api_version,
                       features=frozenset(features),
                       description=description)
    _REGISTRY[name] = spec
    return spec


def create_backend(name: str, **kwargs) -> Plugin:
    """Instantiate a registered backend by name."""
    try:
        spec = _REGISTRY[name]
    except KeyError:
        raise BackendError(
            f"unknown device backend {name!r}; "
            f"registered: {sorted(_REGISTRY)}") from None
    plugin = spec.factory(**kwargs)
    if getattr(plugin, "api_version", None) != PLUGIN_API_VERSION:
        raise PluginVersionError(
            f"backend {name!r} produced a plugin with "
            f"api_version={getattr(plugin, 'api_version', None)!r}")
    plugin.backend_name = name       # registry name (plugin.name may differ)
    return plugin


def available_backends() -> Dict[str, Dict[str, Any]]:
    """name -> {api_version, features, description} for capability reports."""
    return {n: {"api_version": s.api_version,
                "features": sorted(s.features),
                "description": s.description}
            for n, s in sorted(_REGISTRY.items())}


class HostNumpyBackend(TorchBackend):
    """Restores host numpy arrays and leaves placement to the caller."""

    name = "host"
    features = frozenset({"host_arrays", "dry_run_restore",
                          "chunked_packs", "pipelined_io",
                          "dirty_tracking"})

    def __init__(self, lock_timeout_s: float = 10.0,
                 restore_threads: int = 0, device=None):
        super().__init__(lock_timeout_s, restore_threads, device=None)

    def update_topology_map(self, ctx: HookContext) -> None:
        ctx.topology_map["mode"] = "host"
        ctx.topology_map["target"] = None

    def _target(self):
        return None


register_backend(
    "torch", TorchBackend, api_version=PLUGIN_API_VERSION,
    features=TORCH_BACKEND_FEATURES,
    description="torch-tensor device backend (lock, pinned capture, "
                "restore onto the device) — the CUDA-plugin analogue")

register_backend(
    "host", HostNumpyBackend, api_version=PLUGIN_API_VERSION,
    features=HostNumpyBackend.features,
    description="host-numpy restore without touching devices (dry-run, "
                "image surgery)")
