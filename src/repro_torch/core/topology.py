"""Topology fingerprints (the GPUID-translation analogue), one device.

The manifest records where an image was taken so a restore can tell an
identical target from a translated or resharded one (the reference
fingerprints JAX meshes).  The port runs on one device and no mesh yet:
``mesh_fingerprint(None)`` names the device kind (the CUDA device name, or
``"cpu"``), and every tensor's sharding descriptor is the reference's
"other" (not a named sharding), which its restore places whole.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.devices import device_kind


def mesh_fingerprint(mesh: None = None,
                     device: Optional[torch.device] = None) -> Dict[str, Any]:
    if mesh is not None:
        raise NotImplementedError("device meshes are not ported yet")
    return {"kind": device_kind(device), "n_devices": 1,
            "mesh_shape": None, "mesh_axes": None, "process_count": 1}


def compatibility(saved: Dict[str, Any], target: Dict[str, Any]) -> str:
    if saved == target:
        return "identical"
    if (saved.get("mesh_shape") == target.get("mesh_shape")
            and saved.get("mesh_axes") == target.get("mesh_axes")):
        return "translated"
    return "resharded"


def sharding_descriptor(t: torch.Tensor) -> Dict[str, Any]:
    """A whole tensor on one device: the reference's non-named sharding."""
    return {"type": "other", "mesh": None, "spec": None}
