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
  * A mesh over the ranks (``launch.mesh.ProcessMesh``) splits them into
    one subgroup per mesh axis, and per set of axes: the ranks that share
    every coordinate but those axes' (:meth:`Group.subgroup`; the
    mesh's ``axis_group(("model",))``).  torch needs every rank to create every
    subgroup, the ones it is not in too, in one order: the mesh creates
    them all when it is built, in its axes' order, over the same backend
    and store.  A subgroup of one rank runs no collective.
  * Forming the group and each subgroup (the store's waits, the
    backend's connections) is bounded by :func:`rendezvous_s`, which is
    never shorter than :data:`DEFAULT_TIMEOUT_S`: a rank that starts
    late on a loaded host still joins.  Once formed, every collective
    of the group keeps the group's own `timeout_s`.

The collectives are the library's: communication, not kernels.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.devices import resolve_device, set_deterministic

#: seconds: a group's collective timeout and the commit barrier's
#: deadline unless the launcher is given another
DEFAULT_TIMEOUT_S = 300.0


def rendezvous_s(timeout_s: float) -> float:
    """Seconds a rank waits for the others to form a group or subgroup
    whose collectives are bounded by `timeout_s`."""
    return max(float(timeout_s), DEFAULT_TIMEOUT_S)


def _formed(pg, timeout_s: float):
    """`pg`, made under the rendezvous bound, with its collectives bounded
    by `timeout_s` from now on (None: the job's own group)."""
    from torch.distributed import distributed_c10d as c10d
    c10d._set_pg_timeout(datetime.timedelta(seconds=timeout_s), pg)
    return pg


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the job -- its rank, the world size, its
    device, the backend (``nccl`` or ``gloo``) and the seconds that bound
    each collective -- and the collectives over its ranks.  A subgroup
    (:meth:`subgroup`) is a Group too: its `rank` and `world` count its
    own members (`members`, the job's ranks in order), and its
    collectives run over its process group `pg`."""
    rank: int
    world: int
    device: torch.device
    backend: str
    timeout_s: float = DEFAULT_TIMEOUT_S
    #: the job's ranks of this group, in order (empty: every rank)
    members: Tuple[int, ...] = ()
    #: torch's process group of a subgroup (None: the job's own)
    pg: Any = dataclasses.field(default=None, compare=False, repr=False)
    #: the subgroups made over this job's ranks, by their members
    _subgroups: Dict[Tuple[int, ...], "Group"] = dataclasses.field(
        default_factory=dict, compare=False, repr=False, hash=False)

    @property
    def ranks(self) -> Tuple[int, ...]:
        """The job's ranks in this group, in its rank order."""
        return self.members or tuple(range(self.world))

    def _kw(self) -> Dict[str, Any]:
        return {} if self.pg is None else {"group": self.pg}

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `t` (equal shapes), in rank order."""
        if self.world == 1:
            return [t]
        import torch.distributed as tdist
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        tdist.all_gather(parts, t, **self._kw())
        return parts

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """`flat` is the world's blocks laid end to end, in rank order,
        each of one size; returns this rank's block summed over the
        ranks."""
        if self.world == 1:
            return flat
        import torch.distributed as tdist
        out = torch.empty(flat.numel() // self.world, dtype=flat.dtype,
                          device=flat.device)
        tdist.reduce_scatter_tensor(out, flat.contiguous(), **self._kw())
        return out

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`t` reduced over the ranks in place (``sum``, ``max`` or
        ``min``); returns it.  Every rank gets the same bytes."""
        if self.world == 1:
            return t
        import torch.distributed as tdist
        tdist.all_reduce(t, op={"sum": tdist.ReduceOp.SUM,
                                "max": tdist.ReduceOp.MAX,
                                "min": tdist.ReduceOp.MIN}[op],
                         **self._kw())
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
        if self.world == 1:
            return [obj]
        import torch.distributed as tdist
        out: List[Any] = [None] * self.world
        tdist.all_gather_object(out, obj, **self._kw())
        return out

    def broadcast_object(self, obj: Any) -> Any:
        """The first rank's `obj` on every rank."""
        if self.world == 1:
            return obj
        import torch.distributed as tdist
        box = [obj]
        tdist.broadcast_object_list(box, src=self.ranks[0], **self._kw())
        return box[0]

    # ------------------------------------------------------- subgroups
    def subgroup(self, members: Sequence[int]) -> "Group":
        """The group of this group's ranks `members`: made once, then the
        same object.  Every rank must ask for every subgroup in one
        order, including those it is not in (its `rank` there is -1); a
        subgroup of one rank or of every rank makes no process group.  A
        subgroup's own subgroups are itself and its single ranks (a mesh
        of one axis over it)."""
        members = tuple(sorted(int(r) for r in members))
        if members == tuple(range(self.world)):
            return self
        if self.members:
            if len(members) > 1:
                raise ValueError("subgroups are made from the job's "
                                 "group")
            return Group(0, 1, self.device, self.backend, self.timeout_s,
                         (self.members[members[0]],))
        got = self._subgroups.get(members)
        if got is None:
            pg = None
            if len(members) > 1:
                import torch.distributed as tdist
                pg = tdist.new_group(
                    list(members), backend=self.backend,
                    timeout=datetime.timedelta(
                        seconds=rendezvous_s(self.timeout_s)))
                if self.rank in members:
                    _formed(pg, self.timeout_s)
            got = Group(members.index(self.rank) if self.rank in members
                        else -1, len(members), self.device, self.backend,
                        self.timeout_s, members, pg)
            self._subgroups[members] = got
        return got


class AllReduce(torch.autograd.Function):
    """``apply(t, group)``: `t` summed over `group`'s ranks, into a new
    tensor.  The backward sums the grads over the ranks the same way, as
    the transpose of JAX's ``psum`` does: a rank's grad of the sum is
    every rank's share of the loss, so its inputs' grads count them all."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.clone()), None


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
        world_size=world,
        timeout=datetime.timedelta(seconds=rendezvous_s(timeout_s)),
        **kwargs)
    _formed(None, timeout_s)
    return Group(rank, world, device, backend, float(timeout_s))


def shutdown() -> None:
    """Leave the group (a no-op without one)."""
    import torch.distributed as tdist
    if tdist.is_initialized():
        tdist.destroy_process_group()

