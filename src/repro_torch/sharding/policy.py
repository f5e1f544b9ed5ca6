"""Logical-axis -> mesh-axis sharding policies, and named shardings.

Port of the reference's ``sharding/policy.py``.  Every parameter and
cache leaf of the model zoo is annotated with *logical* axis names
("batch", "heads", "d_ff", "experts", ...); a :class:`ShardingPolicy`
maps them onto mesh axes.  The tables, the first-dim-wins rule for a
contested axis and the divisibility fit are the reference's, so a
policy gives the same ``PartitionSpec`` in both packages.

On the port's slot meshes (grids of slots on one device,
:mod:`repro_torch.launch.mesh`) compute runs on whole tensors, and a
:class:`NamedSharding` decides what an image holds and how a restore
places it.  On a ``ProcessMesh`` (one rank per slot) a tensor holds only
its rank's block: :func:`local_block` cuts it from the whole,
:func:`gather_leaf` rebuilds the whole from every rank's block and
:func:`scatter_grad` sums a whole gradient over the ranks into each
rank's block, by the same block arithmetic and the collectives of the
mesh's group.  :func:`gather_leaves` and :func:`scatter_grads` do the
same for many leaves at once and over any set of the mesh's axes (the
subgroup of the ranks that share the other coordinates): a leaf
gathered over ``data`` alone keeps its ``model`` block.  The backward's
sum runs one axis at a time, so that every rank of a replicated block
gets the same bytes.  :class:`GatherLeaves` is the two as one
differentiable op over a layer's leaves (one all-gather forward and one
reduce-scatter backward per axis set), and :func:`param_gather` the
models' ``gather``: a model calls it on each layer's params where it
reads them (inside its remat unit, so the backward's recompute gathers
again) and on the top-level leaves once a call, so a rank holds its
blocks plus one super-block's weights, never a whole copy of the params
(with remat off the backward saves every gathered layer: correct, but
no saving).  A leaf the policy splits over its tensor-parallel axes
(``heads``, ``kv_heads``, ``d_ff``, ``vocab`` over ``tp``, where the
fitted spec keeps them and they divide the heads) is gathered over its
other axes alone, so that a rank computes its own heads, ``d_ff``
columns and vocab rows (the gather carries its :class:`TensorShard`);
expert leaves over the data axes alone, so that a rank holds its own
experts whole and the MoE block runs expert-parallel (the gather carries
its :class:`ExpertShard`); every other leaf is gathered whole.
:data:`GATHERED` counts the gathered bytes of a step or serving call.  The block arithmetic is
JAX's: a dim sharded over the axes ``(a, b)`` is cut into ``|a|·|b|``
equal blocks with ``a`` the major axis; a slot's replica id counts, in
mesh order, the slots before it that hold the same block.  The
reference's ``constrain`` (``with_sharding_constraint``) has nothing to
do on whole tensors and is left out.

Baseline policy (production posture):
  - DP over ("pod", "data")        — batch dim of activations
  - FSDP (ZeRO-3) over ("data",)   — "d_model"-like param dims
  - TP over ("model",)             — heads / d_ff / vocab param dims
  - EP over ("model",)             — MoE expert dim
  - sequence-sharding over ("data",) for long-context decode caches
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Axes = Optional[Tuple[str, ...]]
PyTree = Any


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or
    a tuple of names (major first).  Dims past its length replicate."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """`spec` laid over `mesh`'s slots (a plain class, not a dataclass:
    trees of shardings flatten with it as a leaf)."""

    def __init__(self, mesh, spec: Union[PartitionSpec, tuple]):
        spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)
        used: List[str] = []
        for entry in spec:
            for a in _axes_of(entry):
                if a not in mesh.axis_names:
                    raise ValueError(f"spec {spec} names axis {a!r}, not "
                                     f"in mesh axes {mesh.axis_names}")
                if a in used:
                    raise ValueError(f"spec {spec} uses axis {a!r} twice")
                used.append(a)
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding)
                and self.mesh == other.mesh
                and tuple(self.spec) == tuple(other.spec))

    def __hash__(self) -> int:
        return hash((self.mesh, tuple(self.spec)))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def _dim_axes(self, ndim: int) -> List[Tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} is longer than the "
                             f"tensor's rank {ndim}")
        return [_axes_of(e) for e in tuple(self.spec)
                + (None,) * (ndim - len(self.spec))]

    def shard_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The shape of one slot's block of a `shape` tensor (JAX's
        ``NamedSharding.shard_shape``): each dim over the product of its
        axes' sizes, which must divide it."""
        sizes = self.mesh.shape
        out = []
        for d, axes in enumerate(self._dim_axes(len(shape))):
            n = math.prod(sizes[a] for a in axes)
            if shape[d] % n:
                raise ValueError(f"dim {d} of shape {tuple(shape)} does not "
                                 f"divide into {n} blocks over mesh axes "
                                 f"{axes}")
            out.append(shape[d] // n)
        return tuple(out)

    def devices_indices_map(self, shape: Tuple[int, ...]
                            ) -> Dict[Tuple[int, ...], Tuple[slice, ...]]:
        """Mesh coordinate -> the block of a `shape` tensor its slot
        holds, in mesh order (every slot names the same device, so the
        map is keyed by coordinate where JAX's is keyed by device).  An
        unsharded dim is ``slice(None)``, as in JAX."""
        shape = tuple(int(s) for s in shape)
        sizes = self.mesh.shape
        dims = self._dim_axes(len(shape))
        ways = [math.prod(sizes[a] for a in axes) for axes in dims]
        for d, (n, axes) in enumerate(zip(ways, dims)):
            if n > 1 and shape[d] % n:
                raise ValueError(
                    f"dim {d} of shape {shape} does not divide into "
                    f"{n} blocks over mesh axes {axes} (fit the spec "
                    f"first: fit_sharding)")
        out: Dict[Tuple[int, ...], Tuple[slice, ...]] = {}
        for coord in _mesh_coords(self.mesh):
            pos = dict(zip(self.mesh.axis_names, coord))
            idx = []
            for d, (n, axes) in enumerate(zip(ways, dims)):
                if n == 1:
                    idx.append(slice(None))
                    continue
                block = 0
                for a in axes:                        # first axis major
                    block = block * sizes[a] + pos[a]
                step = shape[d] // n
                idx.append(slice(block * step, (block + 1) * step))
            out[coord] = tuple(idx)
        return out

    def replica_ids(self, shape: Tuple[int, ...]) -> Dict[Tuple[int, ...],
                                                           int]:
        """Mesh coordinate -> replica id of its block: the slots before
        it, in mesh order, that hold the same block (JAX's
        ``device_replica_id_map``)."""
        seen: collections.Counter = collections.Counter()
        out: Dict[Tuple[int, ...], int] = {}
        for coord, idx in self.devices_indices_map(shape).items():
            key = _index_key(idx, shape)
            out[coord] = seen[key]
            seen[key] += 1
        return out

    def shard_indices(self, shape: Tuple[int, ...]) -> List[Tuple[slice,
                                                                  ...]]:
        """The distinct blocks (replica 0 only), in mesh order: what an
        image holds, in the order the reference's capture writes them."""
        idx_map = self.devices_indices_map(shape)
        rids = self.replica_ids(shape)
        return [idx_map[c] for c in idx_map if rids[c] == 0]


# ----------------------------------------------------------------------
# blocks on a process mesh (one rank per slot)
# ----------------------------------------------------------------------
def is_process_sharding(sharding) -> bool:
    return sharding is not None and getattr(sharding.mesh,
                                            "is_process_mesh", False)


def global_shape(sharding: NamedSharding, local_shape) -> Tuple[int, ...]:
    """The whole tensor's shape, from the shape of one rank's block."""
    sizes = sharding.mesh.shape
    return tuple(int(n) * math.prod(sizes[a] for a in axes)
                 for n, axes in zip(local_shape,
                                    sharding._dim_axes(len(local_shape))))


def rank_index(sharding: NamedSharding, shape, rank: Optional[int] = None
               ) -> Tuple[slice, ...]:
    """The block of a `shape` tensor that `rank`'s slot holds (default:
    this process's)."""
    mesh = sharding.mesh
    rank = mesh.rank if rank is None else rank
    coord = tuple(int(i) for i in np.unravel_index(rank, mesh.devices.shape))
    return sharding.devices_indices_map(tuple(shape))[coord]


def local_layout(sharding: NamedSharding, local_shape
                 ) -> Tuple[Tuple[int, ...], List[Tuple[slice, ...]],
                            Optional[int]]:
    """(whole shape, the distinct blocks in mesh order, the position in
    them of the block this process writes, or None when another rank
    holds its replica 0)."""
    shape = global_shape(sharding, local_shape)
    blocks = sharding.shard_indices(shape)
    mine = None
    if sharding.replica_ids(shape)[sharding.mesh.local_coord] == 0:
        key = _index_key(rank_index(sharding, shape), shape)
        mine = [_index_key(b, shape) for b in blocks].index(key)
    return shape, blocks, mine


def local_block(t, sharding: NamedSharding):
    """This rank's block of the whole tensor `t`, as a tensor of its own."""
    return t[rank_index(sharding, tuple(t.shape))].contiguous().clone()


def _whole(index, shape) -> bool:
    return all(x == (0, int(d)) for x, d in
               zip(_index_key(index, shape), shape))


def gather_leaf(t, sharding: NamedSharding):
    """The whole tensor from every rank's block `t` (an all-gather, each
    block placed at its index); a replicated leaf is `t` itself."""
    shape = global_shape(sharding, tuple(t.shape))
    if _whole(rank_index(sharding, shape), shape):
        return t
    parts = sharding.mesh.group.all_gather(t)
    out = t.new_empty(shape)
    for r, part in enumerate(parts):
        out[rank_index(sharding, shape, r)] = part
    GATHERED.add(out)
    return out


def scatter_grad(g, sharding: NamedSharding):
    """This rank's block of the sum over the ranks of the whole tensors
    `g`: a reduce-scatter of the blocks laid out in rank order, or an
    all-reduce for a replicated leaf."""
    group = sharding.mesh.group
    shape = tuple(g.shape)
    idx = [rank_index(sharding, shape, r) for r in range(sharding.mesh.size)]
    if all(_whole(i, shape) for i in idx):
        return group.all_reduce(g.contiguous())
    flat = torch.cat([g[i].reshape(-1) for i in idx])
    return group.reduce_scatter(flat).view(sharding.shard_shape(shape))


class GatherCounter:
    """The whole tensors :func:`gather_leaf` and :func:`gather_leaves`
    made in one step or serving call: the bytes alive now (each counted
    from its gather until it is freed), their peak and the bytes
    gathered since :meth:`begin`.  A leaf every rank holds whole is not
    gathered and not counted, nor is a gather's receive buffer."""

    def __init__(self):
        # a backward on a card frees tensors on autograd's device thread
        self._lock = threading.Lock()
        self.live = 0
        self.peak = 0
        self.total = 0

    def begin(self) -> None:
        """Start a step or serving call: the peak from the bytes alive
        now, the total from 0."""
        with self._lock:
            self.peak, self.total = self.live, 0

    def add(self, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        with self._lock:
            self.live += n
            self.total += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n).atexit = False

    def _free(self, n: int) -> None:
        with self._lock:
            self.live -= n

    def read(self) -> Dict[str, int]:
        """``gathered_peak_bytes`` and ``gathered_bytes`` since
        :meth:`begin`."""
        with self._lock:
            return {"gathered_peak_bytes": self.peak,
                    "gathered_bytes": self.total}


#: this process's count (one rank is one process)
GATHERED = GatherCounter()


def drop_axes(sharding: NamedSharding, axes) -> NamedSharding:
    """`sharding` with the mesh axes `axes` taken off every dim: the
    layout of a leaf gathered over them."""
    return NamedSharding(sharding.mesh, PartitionSpec(*(
        _spec_entry(tuple(a for a in _axes_of(e) if a not in axes))
        for e in sharding.spec)))


def _spec_entry(axes: Tuple[str, ...]):
    return None if not axes else axes[0] if len(axes) == 1 else axes


def gather_axes(mesh, axes=None) -> Optional[Tuple[str, ...]]:
    """The mesh axes a gather over `axes` (None: every axis) runs over,
    those of one slot left out; None when that is every rank."""
    axes = mesh.axis_names if axes is None else tuple(axes)
    key = tuple(a for a in mesh.axis_names
                if a in axes and mesh.shape[a] > 1)
    if key == tuple(a for a in mesh.axis_names if mesh.shape[a] > 1):
        return None
    return key


class _Layout(collections.namedtuple(
        "_Layout", "members shape index mine whole")):
    """A leaf's gather over a set of mesh axes: the ranks that gather
    together (`members`, rank order), the gathered tensor's `shape`, each
    member's block as an index into it (`index`), this rank's position
    in `members` (`mine`) and whether every member holds all of it
    (`whole`: nothing to gather)."""


@functools.lru_cache(maxsize=4096)
def _gather_layout(sharding: NamedSharding, shape: Tuple[int, ...],
                   axes: Optional[Tuple[str, ...]]) -> _Layout:
    """The :class:`_Layout` of a `shape` leaf sharded by `sharding`,
    gathered over `axes` (:func:`gather_axes`; cached: a model asks
    again for each layer at every call)."""
    mesh = sharding.mesh
    over = mesh.axis_names if axes is None else axes
    members = [r for r in range(mesh.size)
               if all(int(c) == int(m) for a, c, m in zip(
                   mesh.axis_names,
                   np.unravel_index(r, mesh.devices.shape),
                   mesh.local_coord) if a not in over)]
    target = drop_axes(sharding, over)
    start = [a for a, _ in _index_key(rank_index(target, shape), shape)]
    index = []
    for r in members:
        key = _index_key(rank_index(sharding, shape, r), shape)
        index.append(tuple(slice(a - s0, b - s0)
                           for (a, b), s0 in zip(key, start)))
    tshape = target.shard_shape(shape)
    return _Layout(tuple(members), tshape, tuple(index),
                   members.index(mesh.rank),
                   all(_whole(i, tshape) for i in index))


def gather_leaves(ts, shardings, axes, count: bool = True
                  ) -> List[torch.Tensor]:
    """:func:`gather_leaf` of every block of `ts` (one sharding each),
    each over the mesh axes of `axes` (one entry a leaf, None: every
    axis; :func:`gather_axes`), by one all-gather per dtype and axis set:
    the blocks laid end to end, each rank's part placed at its indices.
    A leaf gathered over axes it is not split on is `t` itself.  The
    receive buffers live for the call only.  `count`: add the gathered
    tensors to :data:`GATHERED` (a param's; not a cache's)."""
    out = list(ts)
    todo: Dict[Any, list] = collections.defaultdict(list)
    for i, (t, sh) in enumerate(zip(ts, shardings)):
        ax = gather_axes(sh.mesh, axes[i])
        lay = _gather_layout(sh, global_shape(sh, tuple(t.shape)), ax)
        if not lay.whole:
            todo[(t.dtype, ax)].append((i, lay))
    for (_, ax), members in todo.items():
        mesh = shardings[members[0][0]].mesh
        parts = _group(mesh, ax).all_gather(
            torch.cat([ts[i].reshape(-1) for i, _ in members]))
        off = 0
        for i, lay in members:
            t, n = ts[i], ts[i].numel()
            whole = t.new_empty(lay.shape)
            for r, part in enumerate(parts):
                whole[lay.index[r]] = part[off:off + n].view(t.shape)
            off += n
            if count:
                GATHERED.add(whole)
            out[i] = whole
    return out


def scatter_grads(gs, shardings, axes) -> List[torch.Tensor]:
    """:func:`scatter_grad` of every gathered grad of `gs`, each summed
    over the ranks it was gathered from (`axes` as for
    :func:`gather_leaves`) into this rank's block.  The sum runs one
    mesh axis at a time, the last first, over that axis's subgroup: per
    dtype and axis set, one reduce-scatter of the pieces of every grad
    split over the axis, laid end to end in rank order, and one
    all-reduce of those of the grads not split over it (their ranks hold
    one block), so that every rank of a block gets the same bytes.  On a
    ``(data, model)`` mesh the ranks of a data row add their shares
    first, then the rows are added, as one rank a row would."""
    out: List[Any] = [None] * len(gs)
    todo: Dict[Any, list] = collections.defaultdict(list)
    for i, (g, sh) in enumerate(zip(gs, shardings)):
        ax = gather_axes(sh.mesh, axes[i])
        todo[(g.dtype, ax)].append(i)
    for (_, ax), members in todo.items():
        mesh = shardings[members[0]].mesh
        rem = [a for a in mesh.axis_names if mesh.shape[a] > 1
               and (ax is None or a in ax)]
        held = {}                     # leaf -> {coords over rem: piece}
        for i in members:
            shape = _gathered_shape(shardings[i], tuple(gs[i].shape), ax)
            lay = _gather_layout(shardings[i], shape, ax)
            held[i] = {_coords(mesh, r, rem): gs[i][idx]
                       for r, idx in zip(lay.members, lay.index)}
        for x in reversed(list(rem)):
            k, at = mesh.shape[x], rem.index(x)
            mine = dict(zip(mesh.axis_names, mesh.local_coord))[x]
            rem = rem[:at] + rem[at + 1:]
            keys = sorted({c[:at] + c[at + 1:] for c in held[members[0]]})

            def piece(i, c, j):
                return held[i][c[:at] + (j,) + c[at:]]
            split = [i for i in members if x in _spec_axes(shardings[i])]
            whole = [i for i in members if i not in split]
            group = mesh.axis_group((x,))
            new = {i: {} for i in members}
            if split:
                summed = group.reduce_scatter(torch.cat([
                    piece(i, c, j).reshape(-1) for j in range(k)
                    for i in split for c in keys]))
                _unpack(summed, split, keys, held, new,
                        lambda i, c: piece(i, c, mine))
            if whole:
                summed = group.all_reduce(torch.cat([
                    piece(i, c, mine).reshape(-1)
                    for i in whole for c in keys]))
                _unpack(summed, whole, keys, held, new,
                        lambda i, c: piece(i, c, mine))
            held = new
        for i in members:
            out[i] = held[i][()]
    return out


def _coords(mesh, rank: int, axes) -> Tuple[int, ...]:
    """`rank`'s coordinates on the mesh axes `axes`."""
    pos = dict(zip(mesh.axis_names, (int(c) for c in np.unravel_index(
        rank, mesh.devices.shape))))
    return tuple(pos[a] for a in axes)


def _spec_axes(sharding: NamedSharding) -> set:
    return {a for e in sharding.spec for a in _axes_of(e)}


def _unpack(flat, leaves, keys, held, new, like) -> None:
    """Cut `flat` (the pieces of `leaves` at `keys`, in that order) back
    into pieces shaped as `like(i, key)`, into `new`."""
    off = 0
    for i in leaves:
        for c in keys:
            shape = tuple(like(i, c).shape)
            n = math.prod(shape)
            new[i][c] = flat[off:off + n].view(shape)
            off += n


def block_of(t, sharding: NamedSharding, axes) -> torch.Tensor:
    """This rank's block of `t`, its leaf gathered over the mesh axes
    `axes` (:func:`gather_leaves`'s inverse): a view of `t`."""
    ax = gather_axes(sharding.mesh, axes)
    lay = _gather_layout(sharding, _gathered_shape(sharding, tuple(t.shape),
                                                   ax), ax)
    return t[lay.index[lay.mine]]


def _group(mesh, axes: Optional[Tuple[str, ...]]):
    """This rank's group over `axes` (None: every rank)."""
    return mesh.axis_group(mesh.axis_names if axes is None else axes)


def _gathered_shape(sharding: NamedSharding, shape: Tuple[int, ...],
                    axes: Optional[Tuple[str, ...]]) -> Tuple[int, ...]:
    """The whole leaf's shape from the shape of its gather over `axes`."""
    over = sharding.mesh.axis_names if axes is None else axes
    kept = drop_axes(sharding, over)
    sizes = sharding.mesh.shape
    return tuple(int(n) * math.prod(sizes[a] for a in ax)
                 for n, ax in zip(shape, kept._dim_axes(len(shape))))


class GatherLeaves(torch.autograd.Function):
    """:func:`gather_leaves` with a gradient: ``apply((shardings, axes),
    *blocks)`` all-gathers the blocks over their axes (`axes`: one entry
    a leaf, None for every axis), and the backward sums the gathered
    tensors' grads over the same ranks into the blocks
    (:func:`scatter_grads`): one collective each way for a layer and
    axis set.  Gather f32 blocks and cast after: a leaf read twice (the
    tied embedding) must be gathered once, so that autograd sums its
    grads on the gathered tensor before the one reduce-scatter."""

    @staticmethod
    def forward(ctx, plan, *blocks):
        ctx.plan = plan
        return tuple(w.view_as(w) if w is t else w for w, t in
                     zip(gather_leaves(blocks, *plan), blocks))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *scatter_grads(grads, *ctx.plan))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """`tree`'s structure over the iterator `leaves`, in `_leaves`'s
    order."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    return next(leaves)


def layer_sharding(sharding: NamedSharding, ndim: int) -> NamedSharding:
    """The sharding of an `ndim`-dim tensor of a leaf sharded by
    `sharding`: the leaf's own, or, for one layer of a stacked leaf (one
    dim fewer than the spec, which a params sharding gives for every
    dim), the spec without its leading ``"layers"`` dim, which is never
    sharded."""
    spec = tuple(sharding.spec)
    if ndim == len(spec):
        return sharding
    if ndim != len(spec) - 1 or _axes_of(spec[0]):
        raise ValueError(f"a {ndim}-dim tensor is neither a leaf nor one "
                         f"layer of a stacked leaf sharded by {spec}")
    return NamedSharding(sharding.mesh, PartitionSpec(*spec[1:]))


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """Where a rank's MoE block stands on a process mesh: the ranks that
    split the experts (`group`, over the experts dim's mesh axes; None
    when one rank holds them all), this rank's `index` of their expert
    ranges, the data-parallel ranks (`data`, None at one) over which
    the aux loss is averaged, and the reference's token shards of this
    rank's tokens (`token_shards`): where a batch's rows do not split
    over every data-parallel axis (:func:`row_axes`), the reference still
    splits the flat tokens over those axes when they divide them
    (``src/repro/models/moe.py:140-146``), routing each shard on its own."""
    group: Any
    index: int
    data: Any
    token_shards: int = 1


#: the logical axes a tensor-parallel policy splits a rank's compute
#: over (``tp``): attention's heads, the MLP's hidden and the vocab
TP_KINDS = ("heads", "kv_heads", "d_ff", "vocab")


@dataclasses.dataclass(frozen=True)
class Split:
    """One logical axis cut over the tensor-parallel ranks: the mesh axes
    that cut it (major first, as the spec names them), the ranks' group
    (None where one process emulates a rank: the layers then run no
    collective and refuse to sum over the ranks, ``layers.row_sum``),
    this rank's block and the number of blocks."""
    axes: Tuple[str, ...]
    group: Any
    index: int
    size: int


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """Where a rank's dense compute stands on a mesh: the :class:`Split`
    of each of :data:`TP_KINDS` (None: computed whole).  ``kv_heads``
    splits only with ``heads``, over the same axes, so that a rank's key
    heads are those its query heads pair with."""
    heads: Optional[Split] = None
    kv_heads: Optional[Split] = None
    d_ff: Optional[Split] = None
    vocab: Optional[Split] = None


def tp_axes(shardings, logical, units=None) -> Dict[str, Tuple[str, ...]]:
    """Kind -> the mesh axes (of more than one slot) that cut each of
    :data:`TP_KINDS` on this mesh: those the fitted spec keeps on the
    kind's dim, where their product also divides the kind's `units`
    (``{"heads": H, "kv_heads": KV}``: a dim of H·hd columns splits by
    whole heads alone).  A kind absent, cut by no axis, or kept on axes
    that do not divide its units is computed whole."""
    units = units or {}
    mesh = _first(shardings).mesh
    out: Dict[str, Tuple[str, ...]] = {}
    for sh, ax in zip(_leaves(shardings), _leaves(logical)):
        for kind in TP_KINDS:
            if kind in out or not isinstance(ax, tuple) or kind not in ax:
                continue
            d = ax.index(kind)
            spec = tuple(sh.spec)
            axes = tuple(a for a in (_axes_of(spec[d]) if d < len(spec)
                                     else ()) if mesh.shape[a] > 1)
            n = math.prod(mesh.shape[a] for a in axes)
            if kind in units and units[kind] % n:
                axes = ()
            out[kind] = axes
    if out.get("kv_heads") != out.get("heads"):
        out["kv_heads"] = ()
    return {k: v for k, v in out.items() if v}


def tensor_shard(shardings, logical, units=None, rank: Optional[int] = None
                 ) -> Optional[TensorShard]:
    """The :class:`TensorShard` of `rank` (default: this process's, on a
    process mesh, with its groups; a given rank's carries no group: a
    caller emulating the ranks in one process takes their partial
    outputs before the sum and adds them itself).  None where nothing
    is cut."""
    cut = tp_axes(shardings, logical, units)
    if not cut:
        return None
    mesh = _first(shardings).mesh
    own = rank is None
    rank = mesh.rank if own else rank
    pos = dict(zip(mesh.axis_names, (int(c) for c in np.unravel_index(
        rank, mesh.devices.shape))))
    splits = {}
    for kind, axes in cut.items():
        index, size = 0, 1
        for a in axes:                          # first axis major
            index, size = index * mesh.shape[a] + pos[a], \
                size * mesh.shape[a]
        splits[kind] = Split(axes, mesh.axis_group(axes) if own else None,
                             index, size)
    return TensorShard(**splits)


def leaf_gather_axes(sharding: NamedSharding, logical,
                     tensor: Optional[TensorShard] = None
                     ) -> Optional[Tuple[str, ...]]:
    """The axes a leaf is gathered over: every axis (None), or every axis
    but those that cut the leaf's :data:`TP_KINDS` dim where `tensor`
    cuts it (a rank keeps its heads, ``d_ff`` or vocab block) or, for an
    expert leaf, its experts dim's, so that a rank holds its own experts
    whole (the reference's FSDP gather of its local experts,
    ``src/repro/models/moe.py:59-63``)."""
    keep = _expert_axes(sharding, logical)
    if not keep and tensor is not None and isinstance(logical, tuple):
        for kind in TP_KINDS:
            split = getattr(tensor, kind)
            if kind in logical and split is not None:
                keep = split.axes
    if not keep:
        return None
    return tuple(a for a in sharding.mesh.axis_names if a not in keep)


def rank_gathered(t, sharding: NamedSharding, axes, rank: int):
    """What `rank`'s gather of the whole `t` over `axes` (None: every
    axis) holds: its block over the other axes.  One process emulates a
    rank's view of a whole tensor with it."""
    over = sharding.mesh.axis_names if axes is None else axes
    return t[rank_index(drop_axes(sharding, over), tuple(t.shape), rank)]


def rank_view(tree, logical, mesh, rank: int, units=None, policy=None):
    """Rank `rank`'s view of the whole params `tree` (logical axes
    `logical`) laid over `mesh` (a mesh of slots) by `policy` (default
    ``"baseline"``): its :class:`TensorShard` (no groups) and the tree as
    its gather gives it, the leaves the ``tp`` axes cut as its blocks
    and every other leaf whole.  One process emulates the ranks of a
    tensor-parallel block with it: the sum of their partial outputs is
    the all-reduce's arithmetic."""
    pol = get_policy(policy or "baseline").for_mesh(mesh)
    sh = map_tree(lambda ax, t: fit_sharding(pol.sharding(mesh, *ax),
                                             tuple(t.shape)), logical, tree)
    tp = tensor_shard(sh, logical, units, rank)
    return tp, map_tree(lambda t, s, ax: rank_gathered(
        t, s, leaf_gather_axes(s, ax, tp), rank), tree, sh, logical)


class ParamGather:
    """The models' ``gather`` over a process mesh (:func:`param_gather`):
    ``gather(tree, *path)`` is the gathered `tree`, a rank's blocks of
    the params' subtree at `path` (keys from the root) or of one layer
    of it, by one :class:`GatherLeaves`; ``experts`` is the MoE block's
    :class:`ExpertShard` (None without experts), ``tensor`` the dense
    layers' :class:`TensorShard` (None: computed whole)."""

    def __init__(self, shardings, logical, dp, rows=None, units=None):
        self.shardings = shardings
        mesh = _first(shardings).mesh
        self.tensor = tensor_shard(shardings, logical, units)
        dp_rows = tuple(a for a in dp if a in mesh.axis_names
                        and (rows is None or a in rows))
        cut = {a for kind in TP_KINDS
               for s in [getattr(self.tensor, kind, None)] if s
               for a in s.axes}
        if cut & set(dp_rows):
            # the ranks of a block would hold different rows, and the
            # sum of their partial outputs would mix them
            raise ValueError(
                f"the tensor-parallel axes {sorted(cut)} also split the "
                f"batch's rows (over {dp_rows}): a rank's heads, d_ff and "
                f"vocab blocks need the same rows on every rank of a block")
        # each leaf's gather axes (None: every axis)
        self.axes = map_tree(
            lambda sh, ax: leaf_gather_axes(sh, ax, self.tensor),
            shardings, logical)
        self.plans: Dict[Tuple[str, ...], tuple] = {}
        self.experts = None
        for sh, ax in zip(_leaves(shardings), _leaves(logical)):
            ep = _expert_axes(sh, ax)
            if ep is None:
                continue
            ep = tuple(a for a in ep if mesh.shape[a] > 1)
            index, size = mesh.coord(ep)
            dp_axes = tuple(a for a in dp if a in mesh.axis_names
                            and mesh.shape[a] > 1)
            if set(ep) & set(dp_axes):
                # the model ranks would hold different tokens, and the
                # sum of their partial outputs would mix them
                raise ValueError(
                    f"the experts' mesh axes {ep} also split the batch "
                    f"(data-parallel axes {dp_axes}): expert parallelism "
                    f"needs each rank of an expert group to hold the "
                    f"same rows")
            split = math.prod(mesh.shape[a] for a in dp_axes)
            whole = math.prod(mesh.shape[a] for a in dp_axes
                              if rows is None or a in rows)
            self.experts = ExpertShard(
                mesh.axis_group(ep) if size > 1 else None, index,
                mesh.axis_group(dp_axes) if dp_axes else None,
                split // whole)
            break

    def __call__(self, tree, *path):
        plan = self.plans.get(path)
        if plan is None:
            sh, ax = self.shardings, self.axes
            for k in path:
                sh, ax = sh[k], ax[k]
            pairs = _leaves(map_tree(
                lambda t, s, a: (layer_sharding(s, t.ndim), a), tree, sh, ax))
            plan = self.plans[path] = ([p for p, _ in pairs],
                                       [a for _, a in pairs])
        return _rebuild(tree, iter(GatherLeaves.apply(plan,
                                                      *_leaves(tree))))


def _first(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _expert_axes(sharding: NamedSharding, logical) -> Optional[Tuple[str,
                                                                     ...]]:
    """The mesh axes of an expert leaf's experts dim (logical axes with
    ``"experts"``), or None for any other leaf."""
    if not isinstance(logical, tuple) or "experts" not in logical:
        return None
    d = logical.index("experts")
    spec = tuple(sharding.spec)
    return _axes_of(spec[d]) if d < len(spec) else ()


def param_gather(shardings, logical, dp, rows=None, units=None):
    """The models' ``gather`` over a process mesh, `shardings` the
    params' named shardings, `logical` their logical axes (the model's
    ``param_axes()``: expert leaves are gathered over every axis but
    their experts dim's, and the gather carries the MoE block's
    :class:`ExpertShard`; the leaves of a kind the tensor-parallel axes
    cut over every axis but those, and the gather carries the
    :class:`TensorShard`), `dp` the policy's data-parallel axes (the
    aux loss is averaged over them), `rows` those the batch's rows split
    over (:func:`row_axes`; None: every axis of `dp`), `units` the heads
    of the attention (``layers.tp_units``; None: attention computed
    whole): a :class:`ParamGather`.  None on a mesh of one slot, where
    every block is its whole leaf."""
    if _first(shardings).mesh.size == 1:
        return None
    return ParamGather(shardings, logical, dp, rows, units)


def _mesh_coords(mesh) -> List[Tuple[int, ...]]:
    return [tuple(int(i) for i in c) for c in np.ndindex(*mesh.devices.shape)]


def index_to_json(index: Tuple[slice, ...], shape) -> List[List[int]]:
    """A block's slices as the image's ``[[start, stop], ...]``."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = int(dim) if sl.stop is None else int(sl.stop)
        out.append([start, stop])
    return out


def _index_key(index, shape) -> Tuple[Tuple[int, int], ...]:
    return tuple(tuple(x) for x in index_to_json(index, shape))


# ----------------------------------------------------------------------
# policies
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    name: str
    # physical mesh axes per role
    dp: Tuple[str, ...] = ("pod", "data")     # batch data-parallel
    fsdp: Tuple[str, ...] = ("data",)         # param sharding (ZeRO-3)
    tp: Tuple[str, ...] = ("model",)          # tensor parallel
    ep: Tuple[str, ...] = ("model",)          # expert parallel
    seq: Tuple[str, ...] = ("data",)          # sequence/cache sharding (decode)
    sp: Tuple[str, ...] = ()                  # Megatron-style sequence parallel
    shard_seq_decode: bool = True             # shard KV cache seq dim in decode
    zero_stage: int = 3                       # 3: shard params; 1: only opt state

    # ---- logical -> physical table ------------------------------------
    def table(self) -> Dict[str, Axes]:
        fsdp = self.fsdp if self.zero_stage >= 3 else ()
        return {
            # activations
            "batch": self.dp,
            "seq": self.sp or None,   # SP shards activations between blocks
            "logit_seq": None,        # logits seq dim: never SP (vocab wins)
            "act_d": None,
            "frames": None,
            "patches": None,
            "cache_seq": self.seq if self.shard_seq_decode else None,
            # params
            "d_model": fsdp,
            "heads": self.tp,
            "kv_heads": self.tp,
            "head_dim": None,
            "d_ff": self.tp,
            "vocab": self.tp,
            "experts": self.ep,
            "moe_ff": None,
            "ssm_inner": self.tp,
            "ssm_heads": self.tp,
            "state": None,
            "conv": None,
            "layers": None,           # stacked leading dim
            "replicated": None,
        }

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        """PartitionSpec for a tuple of logical axis names (None =
        replicated).  A mesh axis shards at most one dim: when two
        logical axes of one tensor resolve to the same mesh axis (e.g.
        "batch"->data and "cache_seq"->data on a decode cache), the first
        dim wins and the later dim drops the contested axis."""
        t = self.table()
        used: set = set()
        out = []
        for name in logical:
            if name is None:
                out.append(None)
                continue
            if name not in t:
                raise KeyError(f"unknown logical axis {name!r}")
            ax = tuple(a for a in (t[name] or ()) if a not in used)
            used.update(ax)
            if len(ax) == 0:
                out.append(None)
            elif len(ax) == 1:
                out.append(ax[0])
            else:
                out.append(tuple(ax))
        return PartitionSpec(*out)

    def sharding(self, mesh, *logical: Optional[str]) -> NamedSharding:
        return NamedSharding(mesh, self.spec(*logical))

    def for_mesh(self, mesh) -> "ShardingPolicy":
        """Drop mesh axes this mesh does not have (e.g. 'pod' on 1-pod)."""
        names = set(mesh.axis_names)
        f = lambda axes: tuple(a for a in axes if a in names)  # noqa: E731
        return dataclasses.replace(
            self, dp=f(self.dp), fsdp=f(self.fsdp), tp=f(self.tp),
            ep=f(self.ep), seq=f(self.seq))


def logical_spec(policy: ShardingPolicy,
                 axes: Tuple[Optional[str], ...]) -> PartitionSpec:
    return policy.spec(*axes)


def fit_spec(spec: PartitionSpec, shape: Tuple[int, ...],
             axis_sizes: Dict[str, int]) -> PartitionSpec:
    """Drop mesh axes from dims they do not divide, keeping the largest
    dividing prefix of each dim's axes (partial sharding)."""
    new = []
    for i, axes in enumerate(tuple(spec) + (None,) * (len(shape)
                                                      - len(spec))):
        if axes is None:
            new.append(None)
            continue
        keep, prod = [], 1
        for a in _axes_of(axes):
            n = axis_sizes[a]
            if shape[i] % (prod * n) == 0:
                keep.append(a)
                prod *= n
        if not keep:
            new.append(None)
        elif len(keep) == 1:
            new.append(keep[0])
        else:
            new.append(tuple(keep))
    return PartitionSpec(*new)


def row_axes(mesh, dp: Sequence[str], rows: int) -> Tuple[str, ...]:
    """The data-parallel axes of `dp` that a global batch of `rows` rows
    splits over on `mesh`: those :func:`fit_spec` keeps on its batch dim,
    as the reference lays a batch out.  Every axis of `dp` on the mesh
    where they divide it; () where none does, and every rank then takes
    the batch whole."""
    axes = tuple(a for a in dp if a in mesh.axis_names)
    if not axes:
        return ()
    return _axes_of(tuple(fit_spec(PartitionSpec(axes), (rows,),
                                   dict(mesh.shape)))[0])


def fit_sharding(sh: NamedSharding, shape: Tuple[int, ...],
                 mesh=None) -> NamedSharding:
    """Drop mesh axes from dims they do not divide.  E.g. a KV cache with
    8 kv-heads on a 16-way model axis: the heads dim replicates across
    TP (the serving posture when KV heads < TP degree)."""
    mesh = sh.mesh if mesh is None else mesh
    return NamedSharding(mesh, fit_spec(sh.spec, shape, dict(mesh.shape)))


def map_tree(fn, *trees):
    """`fn` over the leaves of nested dicts that share the first tree's
    structure; tuples are leaves (logical axes)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def fit_shardings_tree(sh_tree, abstract_tree, mesh=None):
    """fit_sharding over a shardings tree and a tree of tensors (meta or
    real) of the same structure."""
    return map_tree(lambda sh, ab: fit_sharding(sh, tuple(ab.shape), mesh),
                    sh_tree, abstract_tree)


def cache_policy(policy: ShardingPolicy, mesh, batch: Optional[int]
                 ) -> ShardingPolicy:
    """Batch- or sequence-sharding for the decode cache (the reference's
    ``models/lm.py`` ``_cache_policy``): when the global batch divides
    the DP extent the cache shards its batch dim; otherwise the DP axes
    go to the cache's sequence dim (the long-context decode posture)."""
    if batch is None or mesh is None:
        return policy
    dp = tuple(a for a in policy.dp if a in mesh.axis_names)
    dp_size = math.prod(mesh.shape[a] for a in dp) if dp else 1
    if dp_size > 1 and batch % dp_size == 0:
        return dataclasses.replace(policy, shard_seq_decode=False)
    return dataclasses.replace(policy, dp=(), seq=dp, shard_seq_decode=True)


# ----------------------------------------------------------------------
# Named policies.  The non-baseline entries are the hillclimb levers.
# ----------------------------------------------------------------------
POLICIES: Dict[str, ShardingPolicy] = {
    # paper-faithful production baseline: DP×FSDP×TP
    "baseline": ShardingPolicy(name="baseline"),
    # pure tensor-parallel (params replicated over data) — ZeRO-1 posture
    "tp_only": ShardingPolicy(name="tp_only", fsdp=(), zero_stage=1),
    # FSDP also across pods (ZeRO-3 over DCN; higher comm, lowest memory)
    "fsdp_pod": ShardingPolicy(name="fsdp_pod", fsdp=("pod", "data")),
    # two-axis tensor parallel: TP over both data+model (long-context decode)
    "tp_wide": ShardingPolicy(
        name="tp_wide", dp=("pod",), fsdp=(), tp=("data", "model"),
        ep=("data", "model"), seq=(), shard_seq_decode=False, zero_stage=1),
    # keep KV cache unsharded along seq (decode alternative)
    "noseq": ShardingPolicy(name="noseq", shard_seq_decode=False),
    # Megatron-style sequence parallelism: activations shard their seq dim
    # over the TP axis between attention/MLP blocks
    "seq_par": ShardingPolicy(name="seq_par", sp=("model",)),
    # pure ZeRO-3 over both mesh axes, no tensor parallelism; MoE keeps
    # EP over "model"
    "fsdp_all": ShardingPolicy(
        name="fsdp_all", dp=("pod", "data", "model"),
        fsdp=("data", "model"), tp=(), ep=("model",), seq=("data",)),
}


def get_policy(name: Union[str, ShardingPolicy]) -> ShardingPolicy:
    if isinstance(name, ShardingPolicy):
        return name
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; known: {list(POLICIES)}")
    return POLICIES[name]


# ----------------------------------------------------------------------
# the models' state, laid over a mesh
# ----------------------------------------------------------------------
def state_shardings(model, mesh, policy: Union[str, ShardingPolicy,
                                               None] = None, *,
                    batch: Optional[int] = None,
                    max_seq: Optional[int] = None) -> Dict[str, Any]:
    """Named shardings of a model's state on `mesh`, each fitted to its
    concrete shape (the reference's ``param_shardings``,
    ``_opt_shardings`` and batch-aware ``cache_shardings``):
    ``{"params": tree, "opt": OptState(step=P(), m=params, v=params)}``,
    and ``"cache"`` when `batch` and `max_seq` are given.  `policy`
    defaults to ``"baseline"``: the port's models carry none."""
    from repro_torch.optim.adamw import OptState
    pol = get_policy(policy if policy is not None else "baseline")
    pol = pol.for_mesh(mesh)

    def over(p, axes_tree, abstract):
        sh = map_tree(lambda ax: p.sharding(mesh, *ax), axes_tree)
        return fit_shardings_tree(sh, abstract, mesh)

    params = over(pol, model.param_axes(), model.init_abstract())
    out: Dict[str, Any] = {
        "params": params,
        "opt": OptState(step=NamedSharding(mesh, PartitionSpec()),
                        m=params, v=params)}
    if batch is not None and max_seq is not None:
        out["cache"] = over(cache_policy(pol, mesh, batch),
                            model.cache_axes(),
                            model.cache_abstract(batch, max_seq))
    return out
