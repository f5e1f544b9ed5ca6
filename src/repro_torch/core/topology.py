"""Topology fingerprints + translation (the GPUID-translation analogue).

The manifest records where an image was taken so a restore can tell an
identical target from a translated or resharded one.  As in the
reference, a fingerprint names the mesh (shape, axis names, device kind,
process count) and a restore runs in one of three modes:

  identical   — same fingerprint: each saved block is placed straight
                into the device tensor at its index
  translated  — same logical mesh, another device: the same placement
  resharded   — a different mesh (elastic restore): the tensor is
                assembled from its saved blocks on the host and copied
                to the device once

The port's meshes are grids of slots on one device
(:mod:`repro_torch.launch.mesh`); a mesh's ``n_devices`` counts its
slots, so a (4, 2) mesh of the port and one of the reference's 8 CPU
devices fingerprint the same.  With no mesh, ``mesh_fingerprint`` names
the one device (the CUDA device name, or ``"cpu"``).  A tensor given no
sharding carries the reference's "other" descriptor, which a restore
places whole.  A process mesh (one rank per card) counts its ranks as
both its devices and its ``process_count``, as the reference counts
``jax.process_count()``; :func:`process_info` reports this process's
rank among them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.devices import device_kind
from repro_torch.sharding.policy import NamedSharding, PartitionSpec


def mesh_fingerprint(mesh=None, device: Optional[torch.device] = None
                     ) -> Dict[str, Any]:
    if mesh is None:
        return {"kind": device_kind(device), "n_devices": 1,
                "mesh_shape": None, "mesh_axes": None, "process_count": 1}
    return {"kind": device_kind(mesh.device),
            "n_devices": mesh.size,
            "mesh_shape": [int(s) for s in mesh.devices.shape],
            "mesh_axes": list(mesh.axis_names),
            "process_count": (mesh.world if getattr(
                mesh, "is_process_mesh", False) else 1)}


def process_info() -> Dict[str, int]:
    """This process's place in its ``torch.distributed`` group, 0 of 1
    outside one (the reference's ``jax.process_index()`` /
    ``jax.process_count()``)."""
    import torch.distributed as tdist
    if tdist.is_available() and tdist.is_initialized():
        return {"process_index": tdist.get_rank(),
                "process_count": tdist.get_world_size()}
    return {"process_index": 0, "process_count": 1}


def compatibility(saved: Dict[str, Any], target: Dict[str, Any]) -> str:
    if saved == target:
        return "identical"
    if (saved.get("mesh_shape") == target.get("mesh_shape")
            and saved.get("mesh_axes") == target.get("mesh_axes")):
        return "translated"
    return "resharded"


# ---------------------------------------------------------------- specs
def spec_to_json(spec: PartitionSpec) -> list:
    out = []
    for e in tuple(spec):
        if e is None:
            out.append(None)
        elif isinstance(e, (tuple, list)):
            out.append(list(e))
        else:
            out.append([e])
    return out


def spec_from_json(j) -> PartitionSpec:
    ents = []
    for e in j:
        if e is None:
            ents.append(None)
        elif len(e) == 1:
            ents.append(e[0])
        else:
            ents.append(tuple(e))
    return PartitionSpec(*ents)


def sharding_descriptor(t: torch.Tensor,
                        sharding: Optional[NamedSharding] = None
                        ) -> Dict[str, Any]:
    """"named" for a tensor given a sharding; else the reference's
    non-named descriptor (a whole tensor on one device)."""
    if sharding is not None:
        return {"type": "named",
                "mesh": mesh_fingerprint(sharding.mesh),
                "spec": spec_to_json(sharding.spec)}
    return {"type": "other", "mesh": None, "spec": None}


def resolve_sharding(desc: Dict[str, Any], target_mesh
                     ) -> Optional[NamedSharding]:
    """Translate a saved sharding descriptor onto the target mesh (the
    UPDATE_TOPOLOGY_MAP step), dropping axes the target mesh lacks.
    None when no mapping is possible (placed whole)."""
    if target_mesh is None or desc.get("type") != "named":
        return None
    axes = set(target_mesh.axis_names)
    ents = []
    for e in tuple(spec_from_json(desc["spec"])):
        if e is None:
            ents.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a in axes)
            ents.append(kept if kept else None)
        else:
            ents.append(e if e in axes else None)
    return NamedSharding(target_mesh, PartitionSpec(*ents))
