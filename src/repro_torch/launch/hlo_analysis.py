"""Op analysis of a traced step: the torch counterpart of compiled HLO.

The reference's ``launch/hlo_analysis.py`` parses XLA's compiled,
SPMD-partitioned HLO text: it multiplies ``while`` bodies by their trip
counts, counts bytes at fusion boundaries and reads the partitioner's
collectives.  Torch has no HLO, no partitioner and no ``while`` loops;
this module analyses an **aten op trace** instead:

  * :class:`OpTrace`, a ``TorchDispatchMode``, records every aten op a
    step runs (on the ``meta`` device for the dry run, or on a card) as
    an :class:`OpRecord`: the op, the shapes, dtypes and sharding tags
    (and so the per-slot split) of its inputs and outputs, its FLOPs and
    its bytes.  Eager execution
    runs every layer (and, under remat, every recomputed layer), so no
    trip counts are needed.  Records hold shapes, never tensors.
  * FLOPs: ``torch.utils.flop_counter``'s formulas for matmuls (``mm``,
    ``addmm``, ``bmm``, ``baddbmm``: kind ``dot``) and convolutions
    (``convolution_backward`` included: kind ``convolution``); 1 per
    output element for elementwise ops and 2 for transcendental ones
    (kind ``elemwise``), as the reference counts.
  * Bytes: inputs plus outputs of each op.  Eager torch fuses nothing,
    so this is an unfused upper bound where the reference counts XLA's
    fusion boundaries.  Views, ``expand``, ``t`` / ``transpose``,
    ``detach``, ``alias`` and the analogues of the reference's
    ``_NO_TRAFFIC`` (``arange``, ``empty``, ...) move none; slicing,
    ``unbind``, ``index_select`` and gathers count twice their result,
    in-place index writes twice the update.  ``score_bytes`` follows the
    reference's shape rule for attention score/prob blocks.
  * Sharding: every tensor carries *tags*, for each dim the mesh axes
    that shard it.  They come from the fitted ``NamedSharding``s of the
    arguments (a parameter in compute carries its tp / ep axes: its fsdp
    axes are gathered) and pass through views, casts, elementwise ops,
    reductions, matmuls and convolutions.  An op's per-slot FLOPs are its
    FLOPs over the slots that split its operands (the product of the
    sizes of the axes its inputs carry); its per-slot bytes are each
    tensor's bytes over its own split.  An op the rules do not know
    counts whole on every slot, and is counted in ``unmodelled_ops``.
  * Collectives: a **model** of the census, not a measurement (no
    partitioner runs).  A matmul whose contraction dim is sharded over
    the tp axes all-reduces its output (under sequence parallelism an
    all-gather and a reduce-scatter instead); an expert product whose
    weights are sharded over the ep axes all-to-alls its tokens in
    (dispatch) and a scatter back to the tokens all-to-alls them out
    (combine).  The parameters' roles (fsdp all-gathers, the gradients'
    reduce-scatters and data-parallel all-reduces) are added by
    :func:`role_census`.  Wire bytes per slot follow the reference's ring
    formulas (:func:`ring_wire_bytes`).
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

# the reference's table (XLA's type names), and torch's dtypes onto it
DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1,
    "u4": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16, "token": 0,
}
DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

Tag = Tuple[Tuple[Tuple[str, int], ...], ...]   # see "tag rules"


def dtype_name(dtype: torch.dtype) -> str:
    return DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def dtype_bytes(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def ring_wire_bytes(op: str, nbytes: float, group: int) -> float:
    """Bytes one slot puts on the wire for a ring collective of `nbytes`
    (the result's bytes; a reduce-scatter's result is the scattered
    shard) over `group` slots: the reference's formulas."""
    g = max(int(group), 1)
    if op == "all-gather":
        return nbytes * (g - 1) / g
    if op == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(nbytes * (g - 1))
    if op == "all-to-all":
        return nbytes * (g - 1) / g
    return float(nbytes)                          # collective-permute


# ----------------------------------------------------------------- records
@dataclasses.dataclass(frozen=True)
class TensorInfo:
    dtype: str
    shape: Tuple[int, ...]
    axes: Tuple[Tuple[str, ...], ...]   # per dim, the mesh axes sharding it
    split: int                 # slots that split it (1: whole on each)

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * DTYPE_BYTES.get(self.dtype, 4)

    @property
    def slot_bytes(self) -> float:
        return self.nbytes / self.split

    def __str__(self) -> str:
        s = f"{self.dtype}[{','.join(map(str, self.shape))}]"
        return s if self.split == 1 else f"{s}/{self.split}"


@dataclasses.dataclass
class OpRecord:
    op: str                    # the aten op, e.g. "mm" or "add"
    kind: str                  # dot | convolution | elemwise | view | other
    inputs: Tuple[TensorInfo, ...]
    outputs: Tuple[TensorInfo, ...]
    flops: float               # the op's whole FLOPs
    split: int                 # slots that split its work
    bytes: float               # per-slot bytes moved
    modelled: bool = True

    @property
    def slot_flops(self) -> float:
        return self.flops / self.split

    def describe(self) -> str:
        ins = ", ".join(map(str, self.inputs))
        outs = ", ".join(map(str, self.outputs))
        return f"{self.op}({ins}) -> {outs}"


@dataclasses.dataclass
class Collective:
    op: str                    # one of COLLECTIVES
    nbytes: float              # per slot, the result's bytes (see above)
    axes: Tuple[str, ...]      # the mesh axes of its group
    group: int                 # slots in the group
    role: str                  # what it models
    count: float = 1.0

    @property
    def wire_bytes(self) -> float:
        return self.count * ring_wire_bytes(self.op, self.nbytes, self.group)


# ------------------------------------------------------------------ op sets
_DOT = {"mm", "addmm", "bmm", "baddbmm"}
_CONV = {"convolution", "_convolution", "convolution_backward",
         "cudnn_convolution", "convolution_overrideable"}
_TRANSCEND = {"exp", "exp2", "log", "log2", "rsqrt", "sqrt", "tanh",
              "sigmoid", "pow", "sin", "cos", "expm1", "log1p", "silu",
              "softplus", "erf", "gelu", "_softmax", "_log_softmax",
              "logsumexp"}
_ELEMWISE_1 = {"add", "sub", "rsub", "mul", "div", "maximum", "minimum",
               "eq", "ne", "lt", "le", "gt", "ge", "where", "bitwise_and",
               "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and",
               "logical_or", "logical_not", "neg", "abs", "clamp",
               "clamp_min", "clamp_max", "reciprocal", "sign", "floor",
               "ceil", "round", "silu_backward", "sigmoid_backward",
               "tanh_backward", "softplus_backward", "threshold_backward",
               "_softmax_backward_data", "_log_softmax_backward_data",
               "masked_fill", "fill", "lerp", "addcmul", "addcdiv",
               "remainder", "fmod"}
# ops that keep the shape and pass tags through, without FLOPs
_PASS = {"_to_copy", "clone", "contiguous", "copy", "detach", "alias",
         "lift_fresh", "lift_fresh_copy", "_unsafe_view", "roll", "cumsum",
         "flip", "zeros_like", "ones_like", "empty_like", "full_like",
         "rand_like", "randn_like", "zero", "_conj", "resolve_conj",
         "resolve_neg", "view_as_real", "triu", "tril"}
# views and their kin: no bytes of their own
_NO_BYTES = {"view", "_unsafe_view", "reshape", "alias", "expand",
             "expand_as", "t", "transpose", "permute", "detach",
             "unsqueeze", "squeeze", "as_strided", "lift_fresh",
             "_reshape_alias", "view_as", "unflatten", "flatten", "arange",
             "empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "scalar_tensor", "_local_scalar_dense",
             "split", "split_with_sizes", "chunk", "narrow"}
# slicing and gathers: twice their result (read the slice, write it)
_SLICING = {"slice", "select", "unbind", "index", "index_select",
            "gather", "embedding", "diagonal"}
# index writes (in place or not): twice the update
_INDEX_WRITE = {"index_put", "_index_put_impl_", "index_add", "index_copy",
                "scatter", "scatter_add", "slice_scatter", "select_scatter",
                "masked_scatter"}
# broadcasts and fills: an untagged result takes a layout by its shape
_BROADCASTS = {"expand", "ones", "zeros", "full", "empty", "empty_strided",
               "new_zeros", "new_ones", "new_full", "new_empty",
               "new_empty_strided", "zeros_like", "ones_like", "empty_like",
               "full_like"}
_RESHAPES = {"view", "_unsafe_view", "reshape", "_reshape_alias",
             "unsqueeze", "squeeze", "flatten", "unflatten", "view_as"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp",
           "prod", "norm", "linalg_vector_norm", "any", "all", "var",
           "std", "argmax", "argmin"}
_CREATE = {"arange", "zeros", "ones", "full", "empty", "empty_strided",
           "scalar_tensor", "new_zeros", "new_ones", "new_empty",
           "new_full", "new_empty_strided", "rand", "randn", "linspace",
           "eye", "_local_scalar_dense"}


def _base(name: str) -> str:
    """In-place and out-of-place forms share rules: ``add_`` -> ``add``."""
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


# ------------------------------------------------------------- tag rules
# A tag has one entry per dim: the (mesh axis, extent) pairs that shard
# it, major first.  An axis of n slots with extent m splits the dim's
# index i into blocks (i // m) % n: from a spec, a dim of size D over
# axes (a, b) gives a extent D / n_a and b extent D / (n_a n_b).  The
# extents carry a split through a reshape that merges dims and a later
# one that splits them again.
def _names(entry) -> Tuple[str, ...]:
    return tuple(a for a, _ in entry)


def _union(*entries) -> Tuple[Tuple[str, int], ...]:
    out: List[Tuple[str, int]] = []
    for entry in entries:
        for a, m in entry:
            if a not in _names(out):
                out.append((a, m))
    return tuple(out)


def _untagged(ndim: int) -> Tag:
    return ((),) * ndim


def _fresh(shape: Sequence[int], axes: Sequence[Sequence[str]],
           sizes: Dict[str, int]) -> Tag:
    """The tag of a spec: per dim, its axes with their extents."""
    tag = []
    for n, names in zip(shape, axes):
        entry, ways = [], 1
        for a in names:
            ways *= sizes.get(a, 1)
            entry.append((a, max(n // ways, 1)))
        tag.append(tuple(entry))
    return tuple(tag)


def _broadcast(tags: Sequence[Tuple[Tag, Tuple[int, ...]]],
               shape: Tuple[int, ...]) -> Tag:
    """Right-aligned union of the inputs' tags onto `shape`: a dim of
    size 1 broadcast to a larger one brings none."""
    out: List[Tuple[Tuple[str, int], ...]] = [()] * len(shape)
    for tag, ishape in tags:
        off = len(shape) - len(ishape)
        if off < 0:
            continue
        for d, (entry, n) in enumerate(zip(tag, ishape)):
            if entry and n == shape[off + d]:
                out[off + d] = _union(out[off + d], entry)
    return _dedupe(out)


def _dedupe(tag) -> Tag:
    """A mesh axis shards at most one dim: the first (major) keeps it."""
    seen: set = set()
    out = []
    for entry in tag:
        keep = tuple((a, m) for a, m in entry if a not in seen)
        seen.update(_names(keep))
        out.append(keep)
    return tuple(out)


def _reshape(tag: Tag, ishape: Tuple[int, ...], oshape: Tuple[int, ...],
             sizes: Dict[str, int]) -> Tag:
    """Tags through a reshape: each axis's blocks, in units of the
    flattened index, land on the output dim they split cleanly (an axis
    whose blocks straddle dims is dropped: that result counts whole)."""
    def minors(shape):
        return [math.prod(shape[d + 1:]) for d in range(len(shape))]
    imin, omin = minors(ishape), minors(oshape)
    out: List[List[Tuple[str, int]]] = [[] for _ in oshape]
    for d, entry in enumerate(tag):
        for a, m in entry:
            mf, n = m * imin[d], sizes.get(a, 1)
            for j, size in enumerate(oshape):
                if (size > 1 and omin[j] <= mf < omin[j] * size
                        and mf % omin[j] == 0
                        and size % (mf // omin[j] * n) == 0):
                    out[j].append((a, mf // omin[j]))
                    break
    return tuple(tuple(e) for e in out)


def _norm_dims(dims, ndim: int) -> List[int]:
    if dims is None:
        return list(range(ndim))
    if isinstance(dims, int):
        dims = [dims]
    return sorted(d % ndim for d in dims) if ndim else []


# ------------------------------------------------------------------- trace
class OpTrace(TorchDispatchMode):
    """Records every aten op run under it (see the module docstring).

    `mesh`: the mesh whose axes the tags name (None: every tensor whole);
    `tp`, `ep`, `sp`: the policy's tensor-, expert- and sequence-parallel
    axes on that mesh; `batch_axes`: the axes the batch dim is sharded
    over (those a dispatched expert's capacity dim takes).  Arguments
    are tagged with :meth:`tag_tree` before the step runs; their storages
    are not counted in ``peak_temp_bytes``, the peak of the per-slot
    bytes of live storages the trace allocated."""

    def __init__(self, mesh=None, tp: Sequence[str] = (),
                 ep: Sequence[str] = (), sp: Sequence[str] = (),
                 batch_axes: Sequence[str] = ()):
        super().__init__()
        self.sizes: Dict[str, int] = dict(mesh.shape) if mesh else {}
        self.tp, self.ep, self.sp = tuple(tp), tuple(ep), tuple(sp)
        self.batch_axes = tuple(batch_axes)
        self.records: List[OpRecord] = []
        self.collectives: List[Collective] = []
        self._tags = WeakIdKeyDictionary()
        self._storages = WeakIdKeyDictionary()
        self.live_bytes = 0.0
        self.peak_temp_bytes = 0.0
        self._dispatched = WeakIdKeyDictionary()   # a2a'd expert inputs
        self._by_shape: Dict[Tuple[int, ...], Tag] = {}

    # ---- tags ---------------------------------------------------------
    def _split_of(self, axes: Iterable[str]) -> int:
        return math.prod(self.sizes.get(a, 1) for a in set(axes))

    def tag_of(self, t: torch.Tensor) -> Tag:
        tag = self._tags.get(t)
        if tag is None or len(tag) != t.dim():
            return _untagged(t.dim())
        return tag

    def set_tag(self, t: torch.Tensor, tag) -> None:
        self._tags[t] = _dedupe(tuple(tuple(e) for e in tag))

    def _spec_tag(self, sharding, shape, drop: Sequence[str] = ()) -> Tag:
        spec = tuple(sharding.spec)
        axes = []
        for entry in (spec + (None,) * len(shape))[:len(shape)]:
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            axes.append(tuple(a for a in names if a not in drop))
        return _fresh(shape, axes, self.sizes)

    def tag_tree(self, tree, shardings, drop: Sequence[str] = ()) -> None:
        """Tag every tensor of the argument `tree` by its sharding in
        `shardings` (a tree of the same structure, ``NamedSharding``
        leaves), leaving out the axes in `drop` (a parameter's fsdp axes,
        gathered for compute).  Argument storages are not temporaries."""
        from repro_torch.core.device_plugin import flatten_with_paths
        sh = flatten_with_paths(shardings)
        for path, t in flatten_with_paths(tree).items():
            self.set_tag(t, self._spec_tag(sh[path], tuple(t.shape), drop))
            self._storages[t.untyped_storage()] = None
            self._layouts([t], adopt=False)

    def retag(self, t: torch.Tensor, sharding) -> None:
        """Lay a temporary (a gradient) out by `sharding`, its storage's
        per-slot bytes with it."""
        self._relayout(t, self._spec_tag(sharding, tuple(t.shape)))

    def _relayout(self, t: torch.Tensor, tag) -> None:
        self.set_tag(t, tag)
        cell = self._storages.get(t.untyped_storage())
        if cell is not None:
            new = t.untyped_storage().nbytes() / self.split(t)
            self.live_bytes += new - cell[0]
            cell[0] = new

    def split(self, t: torch.Tensor) -> int:
        return self._split_of(a for e in self.tag_of(t) for a in _names(e))

    # ---- memory ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        cell = [st.nbytes() / self.split(t)]
        self._storages[st] = cell
        self.live_bytes += cell[0]
        self.peak_temp_bytes = max(self.peak_temp_bytes, self.live_bytes)
        weakref.finalize(st, self._free, cell)

    def _free(self, cell: List[float]) -> None:
        self.live_bytes -= cell[0]

    # ---- the mode -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        try:
            self._record(func, args, kwargs, out)
        except Exception as e:                 # a rule's own fault
            raise RuntimeError(f"op trace: recording {func} failed: "
                               f"{e}") from e
        return out

    def _record(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        base = _base(name)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        modelled = self._propagate(name, base, args, kwargs, ins, outs)
        self._layouts(outs, adopt=base in _BROADCASTS)
        in_axes = {a for t in ins for e in self.tag_of(t) for a in _names(e)}
        split = self._split_of(in_axes) if modelled else 1
        for t in outs:
            self._track(t)
        flops, kind = self._flops(func, base, args, kwargs, out, outs)
        self.records.append(OpRecord(
            op=name, kind=kind,
            inputs=tuple(self._info(t) for t in ins),
            outputs=tuple(self._info(t) for t in outs),
            flops=flops, split=split,
            bytes=self._bytes(name, base, args, ins, outs),
            modelled=modelled))

    def _layouts(self, outs, adopt: bool) -> None:
        """Remember the layout of each tagged result by its shape; with
        `adopt` (a broadcast or a fill), give an untagged result of two
        or more dims the layout of the last tagged tensor of its shape.
        The backward's gradients start from a scalar, and broadcasts of
        it carry no tags, yet each mirrors a forward tensor of its shape
        and layout."""
        for t in outs:
            shape = tuple(t.shape)
            tag = self.tag_of(t)
            if any(tag):
                self._by_shape[shape] = tag
            elif adopt and t.dim() >= 2 and shape in self._by_shape:
                self.set_tag(t, self._by_shape[shape])

    def _info(self, t: torch.Tensor) -> TensorInfo:
        return TensorInfo(dtype_name(t.dtype), tuple(t.shape),
                          tuple(_names(e) for e in self.tag_of(t)),
                          self.split(t))

    # ---- FLOPs ----------------------------------------------------------
    def _flops(self, func, base, args, kwargs, out, outs
               ) -> Tuple[float, str]:
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        if base in _DOT or base in _CONV:
            fn = flop_registry.get(packet)
            f = float(fn(*args, **kwargs, out_val=out)) if fn else 0.0
            return f, "dot" if base in _DOT else "convolution"
        n = float(sum(t.numel() for t in outs))
        if base in _TRANSCEND:
            return 2.0 * n, "elemwise"
        if base in _ELEMWISE_1:
            return n, "elemwise"
        if base in _NO_BYTES:
            return 0.0, "view"
        return 0.0, "other"

    # ---- bytes ----------------------------------------------------------
    def _bytes(self, name, base, args, ins, outs) -> float:
        if base in _NO_BYTES or name in _NO_BYTES:
            return 0.0
        def slot(t):
            return t.numel() * t.element_size() / self.split(t)
        if base in _SLICING:
            return 2.0 * sum(slot(t) for t in outs)
        if base in _INDEX_WRITE:                  # the update: last input
            return 2.0 * slot(ins[-1])
        return float(sum(slot(t) for t in ins) + sum(slot(t) for t in outs))

    # ---- tag propagation ------------------------------------------------
    def _propagate(self, name, base, args, kwargs, ins, outs) -> bool:
        """Tag the outputs; returns whether the rules know the op (an op
        they do not know leaves its outputs whole)."""
        sz = self.sizes
        if not outs:
            return True
        x = args[0] if args and isinstance(args[0], torch.Tensor) else None
        xt = self.tag_of(x) if x is not None else ()
        o = outs[0]
        if base in _RESHAPES:
            self.set_tag(o, _reshape(xt, tuple(x.shape), tuple(o.shape), sz))
        elif base == "permute":
            self.set_tag(o, tuple(xt[d % x.dim()] for d in args[1]))
        elif base in ("t", "transpose"):
            d0, d1 = (0, 1) if base == "t" or x.dim() < 2 else (
                args[1] % x.dim(), args[2] % x.dim())
            tag = list(xt)
            if len(tag) >= 2:
                tag[d0], tag[d1] = tag[d1], tag[d0]
            self.set_tag(o, tag)
        elif base in ("expand", "expand_as"):
            # a broadcast dim takes the layout a tensor of this shape had
            # (the backward of a reduction expands its grad back over the
            # reduced dims)
            tag = list(_broadcast([(xt, tuple(x.shape))], tuple(o.shape)))
            seen = self._by_shape.get(tuple(o.shape), ())
            off = o.dim() - x.dim()
            for d in range(len(seen)):
                if not tag[d] and (d < off or x.shape[d - off] == 1):
                    tag[d] = seen[d]
            self.set_tag(o, tag)
        elif base in ("select", "unbind"):
            dim = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) \
                % x.dim()
            tag = xt[:dim] + xt[dim + 1:]
            for t in outs:
                self.set_tag(t, tag)
        elif base in ("slice", "narrow", "split", "split_with_sizes",
                      "chunk", "roll", "flip", "cumsum", "triu", "tril",
                      "constant_pad_nd", "repeat_interleave", "as_strided",
                      "diagonal"):
            for t in outs:
                self.set_tag(t, xt if t.dim() == x.dim()
                             else _untagged(t.dim()))
        elif base == "index":
            idx = [i for i in args[1] if i is not None]
            if (len(idx) == 1 and args[1][0] is not None
                    and o.dim() == idx[0].dim() + x.dim() - 1):
                it = self.tag_of(idx[0])
                if idx[0].dim() == 1 and not any(it):
                    it = self._rows(x, 0, o.shape[0])
                self.set_tag(o, it + xt[1:])
            else:
                self.set_tag(o, _untagged(o.dim()))
        elif base == "index_select":
            d = args[1] % x.dim()
            it = self.tag_of(args[2])
            it = it if any(it) else self._rows(x, d, o.shape[d])
            self.set_tag(o, xt[:d] + it + xt[d + 1:])
        elif base in ("gather", "embedding"):
            self.set_tag(o, _untagged(o.dim()))
        elif base in _INDEX_WRITE:
            src = ins[-1]
            moved = tuple(a for a in _names(self.tag_of(src)[0])
                          if a in self.ep and a not in _names(xt[0])) \
                if src.dim() and x.dim() else ()
            if moved and len(self._dispatched) and (
                    base == "index_add" or kwargs.get("accumulate") or (
                        len(args) > 3 and args[3] is True)):
                # MoE combine: expert rows scattered back to the tokens
                self._collective("all-to-all", src, moved, "moe combine")
            for t in outs:
                self.set_tag(t, xt if t.dim() == x.dim()
                             else _untagged(t.dim()))
        elif base in _DOT:
            self._matmul(base, args, o)
        elif base in ("convolution", "_convolution", "cudnn_convolution",
                      "convolution_overrideable"):
            w = args[1]
            wt = self.tag_of(w)
            groups = args[8] if len(args) > 8 else kwargs.get("groups", 1)
            ch = _union(wt[0], xt[1] if groups > 1 else ())
            self.set_tag(o, (xt[0], ch) + xt[2:])
        elif base == "convolution_backward":
            # (grad_input, grad_weight, grad_bias) as output_mask asks
            w = args[2]
            tags = [self.tag_of(args[1]), self.tag_of(w),
                    (self.tag_of(w)[0],)]
            for t, tag in zip(outs, [tg for m, tg in zip(args[-1], tags)
                                     if m]):
                self.set_tag(t, tag)
        elif base in _REDUCE:
            dims = args[1] if len(args) > 1 and not isinstance(
                args[1], bool) else kwargs.get("dim")
            keep = kwargs.get("keepdim", False) or (
                len(args) > 2 and args[2] is True)
            red = _norm_dims(dims, x.dim())
            tag = [(() if d in red else a) for d, a in enumerate(xt)]
            if not keep:
                tag = [a for d, a in enumerate(tag) if d not in red]
            for t in outs:
                self.set_tag(t, tag if len(tag) == t.dim()
                             else _untagged(t.dim()))
        elif base in ("sort", "topk", "_softmax", "_log_softmax"):
            for t in outs:
                self.set_tag(t, xt if t.dim() == x.dim()
                             else _untagged(t.dim()))
        elif base in ("cat", "stack"):
            ts = args[0]
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            tag = _broadcast([(self.tag_of(t), tuple(t.shape))
                              for t in ts if t.dim() == ts[0].dim()],
                             tuple(ts[0].shape)) if ts else ()
            if base == "cat":
                d = dim % max(o.dim(), 1)
                tag = tag[:d] + ((),) + tag[d + 1:]
            else:
                d = dim % o.dim()
                tag = tag[:d] + ((),) + tag[d:]
            self.set_tag(o, tag)
        elif base in _CREATE:
            for t in outs:
                self.set_tag(t, _untagged(t.dim()))
        elif base == "slice_backward":          # the grad, zero-padded
            self.set_tag(o, xt)
        elif base == "select_backward":
            d = args[2] % o.dim()
            self.set_tag(o, xt[:d] + ((),) + xt[d:])
        elif base in ("one_hot", "repeat"):
            self.set_tag(o, _untagged(o.dim()))
        elif base in _ELEMWISE_1 or base in _TRANSCEND or base in _PASS:
            tag = _broadcast([(self.tag_of(t), tuple(t.shape)) for t in ins],
                             tuple(o.shape))
            for t in outs:
                self.set_tag(t, tag if t.shape == o.shape
                             else _untagged(t.dim()))
        else:
            for t in outs:
                self.set_tag(t, _untagged(t.dim()))
            return False
        return True

    def _rows(self, x: torch.Tensor, d: int, n: int) -> Tag:
        """The layout of n rows gathered along dim d of x by an index of
        no known layout (the MoE dispatch table): each slot gathers the
        rows of its own batch shard, as a grouped dispatch does."""
        names = tuple(a for a in _names(self.tag_of(x)[d])
                      if a in self.batch_axes)
        return _fresh((n,), (names,), self.sizes)

    def _matmul(self, base, args, o) -> None:
        """Tags of a matmul's output, and the collectives the policy's
        roles give it: an all-reduce of the output when the contraction
        dim is sharded over tp (an all-gather and a reduce-scatter under
        sp); an all-to-all of an expert product's tokens when its weights
        are sharded over ep and its tokens are not yet."""
        a, b = (args[1], args[2]) if base in ("addmm", "baddbmm") \
            else (args[0], args[1])
        at, bt = self.tag_of(a), self.tag_of(b)
        if base in ("bmm", "baddbmm"):
            moved = tuple(x for x in _names(bt[0]) if x in self.ep
                          and x not in _names(at[0]))
            if moved and a not in self._dispatched:   # MoE dispatch over ep
                # the tokens land expert-sharded, each slot's capacity
                # rows from its own batch shard: the all-to-all moves the
                # slot's share of that layout
                rest = tuple(x for x in self.batch_axes if x not in moved)
                at = _fresh(a.shape[:2], (moved, rest), self.sizes) + at[2:]
                self._relayout(a, at)
                self._dispatched[a] = True
                self._collective("all-to-all", a, moved, "moe dispatch")
            tag = (_union(at[0], bt[0]), at[1], bt[2])
            contract = _names(at[2]) + _names(bt[1])
        else:
            tag = (at[0], bt[1])
            contract = _names(at[1]) + _names(bt[0])
        self.set_tag(o, tag)
        over = tuple(dict.fromkeys(x for x in contract if x in self.tp))
        if over:
            if self.sp:
                self._collective("all-gather", o, over, "sp matmul")
                self._collective("reduce-scatter", o, over, "sp matmul",
                                 scattered=True)
            else:
                self._collective("all-reduce", o, over, "tp matmul")

    def _collective(self, op: str, t: torch.Tensor, axes: Tuple[str, ...],
                    role: str, scattered: bool = False) -> None:
        g = self._split_of(axes)
        if g <= 1:
            return
        nbytes = t.numel() * t.element_size() / self.split(t)
        self.collectives.append(Collective(
            op, nbytes / g if scattered else nbytes, axes, g, role))


# ------------------------------------------------------------ role census
def role_census(param_axes, params, shardings, *, fsdp: Sequence[str],
                batch_axes: Sequence[str], sizes: Dict[str, int],
                train: bool, remat: bool, gather_dtype=None,
                grad_dtype=None) -> List[Collective]:
    """The parameters' collectives, modelled from the policy's roles: for
    each parameter sharded over fsdp an all-gather in the forward (and
    another in the backward under remat), one per stacked layer, moving
    `gather_dtype` (its own by default); in training its gradient
    reduce-scatters over those fsdp axes and all-reduces over the batch
    axes that shard neither it nor its gradient, in `grad_dtype` (its own
    by default)."""
    from repro_torch.core.device_plugin import flatten_with_paths
    sh = flatten_with_paths(shardings)
    out: List[Collective] = []
    for path, p in flatten_with_paths(params).items():
        spec = tuple(sh[path].spec)
        used = [a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)]
        gathered = tuple(a for a in used if a in fsdp)
        axes = param_axes
        for k in path.split("/"):              # a leaf's axes: a tuple
            axes = axes[k]
        layers = p.shape[0] if axes[:1] == ("layers",) else 1
        full = p.numel()
        rest = math.prod(sizes[a] for a in used if a not in gathered)
        g = math.prod(sizes[a] for a in gathered)
        if g > 1:
            nb = full / rest * dtype_bytes(gather_dtype or p.dtype)
            passes = 2 if (train and remat) else 1
            out.append(Collective("all-gather", nb / layers, gathered, g,
                                  f"fsdp gather {path}",
                                  count=float(passes * layers)))
        if not train:
            continue
        gb = full / rest / max(g, 1) * dtype_bytes(grad_dtype or p.dtype)
        if g > 1:
            out.append(Collective("reduce-scatter", gb / layers, gathered,
                                  g, f"grad reduce-scatter {path}",
                                  count=float(layers)))
        ar = tuple(a for a in batch_axes if a not in used)
        n = math.prod(sizes[a] for a in ar)
        if n > 1:
            out.append(Collective("all-reduce", gb, ar, n,
                                  f"grad all-reduce {path}"))
    return out


# ----------------------------------------------------------------- analysis
def _score_bytes(info: TensorInfo, cutoff: int,
                 seq_len: Optional[int]) -> float:
    """The reference's shape rule: with `seq_len`, trailing dim ==
    seq_len and second-to-last >= 256; else square trailing dims >=
    `cutoff`."""
    s = info.shape
    if len(s) < 2:
        return 0.0
    hit = (s[-1] == seq_len and s[-2] >= 256) if seq_len is not None \
        else (s[-1] == s[-2] and s[-1] >= cutoff)
    return info.slot_bytes if hit else 0.0


def analyze_trace(trace: OpTrace, n_devices: int = 1,
                  score_cutoff: int = 1024,
                  seq_len: Optional[int] = None) -> Dict[str, Any]:
    """The reference's ``analyze_hlo`` record over an op trace: per-slot
    FLOPs, bytes, score bytes, their breakdowns, the heaviest ops and
    collectives, and the census (modelled: see the module docstring).
    `n_devices` is the mesh's slot count, kept in the record."""
    flops = bytes_ = score = 0.0
    flop_by_kind: Dict[str, float] = {}
    bytes_by_kind: Dict[str, float] = {}
    byte_tops: List[Tuple[float, int]] = []
    unmodelled: Dict[str, int] = {}
    for i, r in enumerate(trace.records):
        if r.flops:
            f = r.slot_flops
            flops += f
            key = r.kind if r.kind in ("dot", "convolution") else "elemwise"
            flop_by_kind[key] = flop_by_kind.get(key, 0.0) + f
        if r.bytes:
            bytes_ += r.bytes
            bytes_by_kind[r.op] = bytes_by_kind.get(r.op, 0.0) + r.bytes
            byte_tops.append((r.bytes, i))
            score += min(r.bytes, sum(
                _score_bytes(t, score_cutoff, seq_len)
                for t in r.inputs + r.outputs))
        if not r.modelled:
            unmodelled[r.op] = unmodelled.get(r.op, 0) + 1
    coll = {op: {"count": 0.0, "bytes": 0.0, "wire_bytes": 0.0}
            for op in COLLECTIVES}
    for c in trace.collectives:
        coll[c.op]["count"] += c.count
        coll[c.op]["bytes"] += c.count * c.nbytes
        coll[c.op]["wire_bytes"] += c.wire_bytes
    byte_tops.sort(key=lambda t: -t[0])
    coll_tops = sorted(trace.collectives, key=lambda c: -c.wire_bytes)
    return {
        "flops": flops,
        "bytes": bytes_,
        "score_bytes": score,
        "flops_by_kind": flop_by_kind,
        "bytes_by_kind": bytes_by_kind,
        "top_traffic": [(b, trace.records[i].describe()[:140])
                        for b, i in byte_tops[:10]],
        "top_collectives": [
            (c.wire_bytes, f"x{c.count:.0f} {c.op} {c.nbytes:.0f} B over "
             f"{'x'.join(c.axes)} ({c.group}): {c.role}"[:140])
            for c in coll_tops[:10]],
        "collectives": coll,
        "collective_wire_bytes": sum(v["wire_bytes"] for v in coll.values()),
        "collective_count": sum(v["count"] for v in coll.values()),
        "n_ops": len(trace.records),
        "n_devices": n_devices,
        "unmodelled_ops": unmodelled,
        "peak_temp_bytes": trace.peak_temp_bytes,
    }


def top_buffers(trace: OpTrace, k: int = 12) -> List[Tuple[float, str]]:
    """The largest single op results of the trace, per slot (MiB, the op):
    the memory-debugging view."""
    out = []
    for r in trace.records:
        if r.kind == "view":
            continue
        for t in r.outputs:
            if t.slot_bytes > 0:
                out.append((t.slot_bytes / 2**20, r.describe()[:140]))
    out.sort(key=lambda t: -t[0])
    return out[:k]
