"""Meshes of the port: a named grid of slots on one device.

``jax.sharding.Mesh`` lets one process address many devices; torch has
no such thing.  ``torch.distributed``'s ``DeviceMesh`` / DTensor need one
process per device and a process group, so on one card every axis of
such a mesh would have size 1 and nothing could be resharded.  The
reference's own tests run their multi-device layouts on one host's CPU
repeated 8 times (``--xla_force_host_platform_device_count=8``); the
port takes the same posture on the device it runs on:

  * a :class:`Mesh` is a named grid of *slots* that all name one
    ``torch.device`` (the card, or the CPU); building one whose slots
    name more than one device raises;
  * compute runs on whole tensors on that device;
  * a tensor's ``NamedSharding(mesh, spec)``
    (:mod:`repro_torch.sharding.policy`) decides what an image holds (one
    block per distinct shard, replica 0 only) and how a restore places
    it.

A :class:`ProcessMesh` spans the ranks of a process group
(:class:`repro_torch.distributed.Group`, one process per card) and
carries it: slot ``i`` names rank ``i``'s device, and this process holds
``local_slots``.  Its tensors hold only this rank's block of each
sharding; the sharding's block arithmetic is the same
(``repro_torch.sharding.policy``), and images are committed through
``core/multihost.py``.  ``make_host_mesh(..., group=)`` builds one with
a slot per rank, row-major (the launchers' ``data = world size``,
``model = 1``, as the reference's launchers lay their devices; a
caller asks for ``model > 1`` through the API, as in JAX).  Built, it
splits the group into a subgroup per set of its axes
(:meth:`ProcessMesh.axis_group`: the ranks that share every other
coordinate), every rank making every subgroup in one order, and gives
this rank's coordinate over any of them (:meth:`ProcessMesh.coord`;
over a policy's data-parallel axes: the rows of a batch a rank takes).

The reference's JAX-version shims (``_axis_type_support``,
``AXIS_TYPE`` / ``HAS_AXIS_TYPES``, ``use_mesh``) have no torch meaning
and are left out.  ``make_production_mesh`` gives the dry run's meshes
(:mod:`repro_torch.launch.dryrun`): with ``device="meta"`` every slot
names the meta device, so a 256- or 512-slot layout is laid out and
traced without touching a card.  Functions, not module-level constants:
importing this module touches no device.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.distributed import Group


class Mesh:
    """A named grid of slots on one device.  ``shape`` maps axis name to
    size, in axis order, as JAX's ``Mesh.shape`` does; ``devices`` is an
    object ndarray of ``torch.device`` (one per slot)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of rank {devices.ndim} given "
                             f"{len(axis_names)} axis names {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        if devices.size == 0:
            raise ValueError("a mesh needs at least one slot")
        self._check_devices(devices)
        self.devices = devices
        self.axis_names = axis_names

    #: a mesh over the ranks of a process group (:class:`ProcessMesh`)
    is_process_mesh = False

    @staticmethod
    def _check_devices(devices: np.ndarray) -> None:
        distinct = {torch.device(d) for d in devices.flat}
        if len(distinct) != 1:
            raise ValueError(
                f"a mesh's slots must all name one device, got "
                f"{sorted(map(str, distinct))}: a mesh across several "
                f"devices needs one process per device")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        return self.devices.flat[0]

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.device == other.device)

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape, str(self.device)))

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return f"Mesh({axes}; {self.device})"


class ProcessMesh(Mesh):
    """A named grid whose slot ``i`` (row-major) is rank ``i`` of
    `group`: ``devices`` holds each rank's device, ``rank`` is this
    process's rank, ``local_slots`` the slots it holds (one: its rank).
    ``device`` is this process's device.  Building one makes the
    group's subgroup for every set of its axes (see the module
    docstring): every rank of the group must build the same meshes in
    one order."""

    is_process_mesh = True

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 group: Group):
        super().__init__(devices, axis_names)
        if self.size != group.world:
            raise ValueError(f"a mesh of {self.size} slots over a group of "
                             f"{group.world} ranks")
        self.group = group
        self._axis_groups: Dict[Tuple[str, ...], Group] = {}
        for n in range(len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                # every rank makes each subgroup of the partition, in
                # the order of their first ranks
                for members in self._partition(axes):
                    sub = group.subgroup(members)
                    if self.rank in members:
                        self._axis_groups[axes] = sub

    def _partition(self, axes: Tuple[str, ...]):
        """The ranks grouped by their coordinates off `axes`: each group
        varies over `axes` alone, in rank order."""
        grid = np.arange(self.size).reshape(self.devices.shape)
        keep = [i for i, a in enumerate(self.axis_names) if a in axes]
        rest = [i for i in range(grid.ndim) if i not in keep]
        grid = np.transpose(grid, rest + keep).reshape(
            -1, math.prod(grid.shape[i] for i in keep))
        return [tuple(int(r) for r in row) for row in grid]

    def axis_group(self, axes: Sequence[str]) -> Group:
        """This rank's subgroup over the mesh axes `axes` (any order;
        names not in the mesh are dropped): the ranks that share every
        other coordinate.  No axes: this rank alone; every axis: the
        group."""
        key = tuple(a for a in self.axis_names if a in tuple(axes))
        return self._axis_groups[key]

    def coord(self, axes: Sequence[str]) -> Tuple[int, int]:
        """(this rank's index, the count) over the mesh axes `axes`: its
        coordinates on them, row-major in mesh order (names not in the
        mesh are dropped)."""
        idx, n = 0, 1
        for a, c in zip(self.axis_names, self.local_coord):
            if a in tuple(axes):
                size = self.shape[a]
                idx, n = idx * size + c, n * size
        return idx, n

    @staticmethod
    def _check_devices(devices: np.ndarray) -> None:
        pass                     # each slot is a process of its own

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def world(self) -> int:
        return self.group.world

    @property
    def local_slots(self) -> Tuple[int, ...]:
        return (self.rank,)

    @property
    def local_coord(self) -> Tuple[int, ...]:
        """This process's slot as a mesh coordinate."""
        return tuple(int(i) for i in np.unravel_index(
            self.rank, self.devices.shape))

    @property
    def device(self) -> torch.device:
        return self.devices.flat[self.rank]

    def __eq__(self, other) -> bool:
        return (isinstance(other, ProcessMesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.rank == other.rank
                and list(self.devices.flat) == list(other.devices.flat))

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape, self.rank))

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return f"ProcessMesh({axes}; rank {self.rank} on {self.device})"


def make_mesh(shape: Tuple[int, ...], axis_names: Sequence[str], *,
              devices=None) -> Mesh:
    """A mesh of `shape` slots.  `devices`: None (the card; raises
    without one), one device for every slot, or one device per slot in
    row-major order."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None or isinstance(devices, (str, torch.device)):
        devs = [resolve_device(devices)] * n
    else:
        devs = [resolve_device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"mesh {shape} has {n} slots, got "
                             f"{len(devs)} devices")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        grid[i] = d
    return Mesh(grid.reshape(shape), axis_names)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   device: DeviceLike = None,
                   group: Optional[Group] = None) -> Mesh:
    """The small mesh of the launchers and tests: ``("data", "model")``,
    or ``("pod", "data", "model")`` with `pod`.  With `group`, a
    :class:`ProcessMesh` over its ranks (`device`, if given, must be this
    rank's); otherwise slots on `device`."""
    shape, axes = (((pod, data, model), ("pod", "data", "model")) if pod
                   else ((data, model), ("data", "model")))
    if group is not None:
        if device is not None and resolve_device(device) != group.device:
            raise ValueError(f"rank {group.rank} runs on {group.device}, "
                             f"not {device}")
        grid = np.empty(math.prod(shape), dtype=object)
        for r in range(grid.size):         # one host: rank r on cuda:r
            grid[r] = (torch.device(group.device.type, r)
                       if group.device.type == "cuda" else group.device)
        return ProcessMesh(grid.reshape(shape), axes, group)
    return make_mesh(shape, axes, devices=device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """The reference's production layout: ``(16, 16)`` slots on
    ``("data", "model")``, or ``(2, 16, 16)`` on ``("pod", "data",
    "model")`` with `multi_pod`.  ``device="meta"`` is the dry run's mesh
    (no allocation); None resolves to the card and raises without one."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=device)
