"""A process group of one job: one process per card, ``torch.distributed``.

JAX lays a job over every device of the host from one process; in torch
one process drives one device, so the port's counterpart is one process
per card.  :func:`init` joins this process to the group and returns its
:class:`Group`: its rank, the world size, its device, the backend and
the timeout that bounds every collective.  A ``launch.mesh.ProcessMesh``
carries its group, and the layers that act across ranks (the trainer's
step, the server, the engine's commit, the policy's gathers) take rank,
world and collectives from the mesh they are given.  Spawning the ranks
is ``repro_torch.launch.dist``'s.

  * NCCL on ``cuda:{rank}`` (one host: the local rank is the rank), gloo
    on the CPU.  On a card :func:`init` selects the rank's card before
    any other CUDA call and then sets the deterministic flags
    (:func:`repro_torch.devices.set_deterministic`); the NCCL init is
    eager, so a failure raises: nothing falls back to gloo or the CPU.
  * The group meets through a file store (``init_method=file://…``): no
    TCP port, nothing on the network.

The collectives are the library's: communication, not kernels.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List

import torch

from repro_torch.devices import resolve_device, set_deterministic

#: seconds: a group's collective timeout and the commit barrier's
#: deadline unless the launcher is given another
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the job -- its rank, the world size, its
    device, the backend (``nccl`` or ``gloo``) and the seconds that bound
    each collective -- and the collectives over its ranks."""
    rank: int
    world: int
    device: torch.device
    backend: str
    timeout_s: float = DEFAULT_TIMEOUT_S

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `t` (equal shapes), in rank order."""
        import torch.distributed as tdist
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        tdist.all_gather(parts, t)
        return parts

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """`flat` is the world's blocks laid end to end, in rank order,
        each of one size; returns this rank's block summed over the
        ranks."""
        import torch.distributed as tdist
        out = torch.empty(flat.numel() // self.world, dtype=flat.dtype,
                          device=flat.device)
        tdist.reduce_scatter_tensor(out, flat.contiguous())
        return out

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`t` reduced over the ranks in place (``sum``, ``max`` or
        ``min``); returns it."""
        import torch.distributed as tdist
        tdist.all_reduce(t, op={"sum": tdist.ReduceOp.SUM,
                                "max": tdist.ReduceOp.MAX,
                                "min": tdist.ReduceOp.MIN}[op])
        return t

    def any_rank(self, flag: bool) -> bool:
        """True on every rank when `flag` is true on any: a decision
        every rank must act on together (a checkpoint, a preemption)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        return bool(self.all_reduce(t, "max").item())

    def all_ranks(self, flag: bool) -> bool:
        """True on every rank when `flag` is true on all of them."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        return bool(self.all_reduce(t, "min").item())

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's picklable `obj`, in rank order."""
        import torch.distributed as tdist
        out: List[Any] = [None] * self.world
        tdist.all_gather_object(out, obj)
        return out

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's `obj` on every rank."""
        import torch.distributed as tdist
        box = [obj]
        tdist.broadcast_object_list(box, src=0)
        return box[0]


def init(rank: int, world: int, device_type: str, init_file: str,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> Group:
    """Join the group as `rank` of `world`: NCCL on ``cuda:{rank}``, gloo
    on the CPU, meeting through the file store `init_file`."""
    import torch.distributed as tdist
    kwargs = {}
    if device_type == "cuda":
        resolve_device("cuda")                 # raises without a card
        if rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs cuda:{rank}; this host "
                               f"has {torch.cuda.device_count()} card(s)")
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)          # before any other CUDA call
        set_deterministic()
        backend = "nccl"
        kwargs["device_id"] = device           # eager init: failures raise
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
        if world > 1 and "OMP_NUM_THREADS" not in os.environ:
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        raise ValueError(f"device type must be cuda or cpu, got "
                         f"{device_type!r}")
    tdist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
        **kwargs)
    return Group(rank, world, device, backend, float(timeout_s))


def shutdown() -> None:
    """Leave the group (a no-op without one)."""
    import torch.distributed as tdist
    if tdist.is_initialized():
        tdist.destroy_process_group()

