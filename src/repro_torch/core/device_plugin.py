"""Device plugin: transparent capture/restore of torch device state.

The cuda-checkpoint analogue for tensors (the reference's
``core/device_plugin.py`` does it for ``jax.Array``s):

  PAUSE_DEVICES        quiesce: drain the device's streams (DeviceLock),
                       and report device memory outside the registered
                       roots (the NVML-leftover analogue, paper §4.4) as a
                       warning;
  CHECKPOINT_DEVICES   device -> host: every CUDA leaf's copy is issued,
                       non-blocking, into a freshly allocated pinned buffer
                       on a side stream before any is waited on; the copies
                       finish before the dump unlocks, because torch code
                       (the decode loop's KV cache) updates tensors in
                       place where JAX rebinds them.  CPU leaves are copied
                       for the same reason;
  RESUME_DEVICES_LATE  host -> device: each entry is rebuilt and placed on
                       the backend's device; a lazy restore places the
                       critical set and leaves the rest to a
                       ``core.lazy.LazyMaterializer``.

Concurrent capture (``capture="concurrent"``) uses the single-leaf
``capture_entry``, the keyed view ``flatten_keys`` and the dirty-tracking
hooks ``begin_tracking``/``end_tracking``.  At the pin, an event is
recorded on the compute stream; every speculation copy runs on a side
stream that waits on it, as ``capture_tree``'s copies wait on the compute
stream.

Entries keep the reference's layout (``kind``/``shape``/``dtype``/
``sharding``/``shards``), so either package restores the other's images.
A tensor carries no sharding: the caller gives a tree of
``NamedSharding``s beside its state (``engine.attach(provider,
shardings=...)``).  A tensor given one is written as one shard per
distinct block (replica 0 only, in mesh order), each block's D2H copy
into its own pinned buffer; a block that is not contiguous (a dim other
than the leading one is sharded) is first staged contiguous on the
device, on the same side stream, so its copy stays one asynchronous
DMA.  A tensor given none is one whole shard with the "other"
descriptor.  A restore given a target mesh or shardings places each
saved block straight into the device tensor at its index when the
target's blocks are the saved ones, and otherwise assembles the tensor
on the host and copies it once (``ctx.stats["placed_blocks"]`` and
``["assembled_entries"]`` count the two).

On a process mesh (``launch.mesh.ProcessMesh``, one rank per card) a
tensor is this rank's block: its entry names every distinct block of the
whole tensor, and this rank holds the bytes of its own block only when
its slot holds the block's replica 0 (the rank whose pack writes it).  A
restore onto a process mesh reads only the saved blocks that overlap
this rank's block and places them; the block is cut from them when the
layouts differ (:func:`needed_pack_entries` names what a rank reads).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lock import DeviceLock
from repro_torch.core.plugins import PLUGIN_API_VERSION, HookContext, Plugin
from repro_torch.core.topology import (compatibility, mesh_fingerprint,
                                       resolve_sharding, sharding_descriptor)
from repro_torch.devices import resolve_device
from repro_torch.serialization.pack import (dtype_from_str, host_numpy,
                                            numpy_to_tensor, tensor_dtype_str)
from repro_torch.sharding.policy import (fit_sharding, index_to_json,
                                         is_process_sharding, local_layout,
                                         rank_index)

PyTree = Any

#: Feature flags of the "torch" backend.
TORCH_BACKEND_FEATURES = frozenset({
    "device_arrays", "pinned_capture", "parallel_restore", "chunked_packs",
    "pipelined_io", "dirty_tracking"})


# ---------------------------------------------------------------- paths
def _is_dataclass(tree: Any) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def flatten_with_paths(tree: PyTree, prefix: str = "") -> Dict[str, Any]:
    """'a/b/c' -> leaf, dict keys in sorted order (the order of JAX's
    pytree flattening); a dataclass (``OptState``) contributes its fields
    by name in declaration order, as JAX names a registered dataclass's
    fields (``opt/step``, ``opt/m/…``); None is an empty subtree, as in
    JAX."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten_with_paths(tree[k], f"{prefix}{k}/"))
    elif _is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(flatten_with_paths(getattr(tree, f.name),
                                          f"{prefix}{f.name}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_with_paths(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def unflatten_paths(flat: Dict[str, Any]) -> Dict[str, Any]:
    """'a/b/c' -> nested dicts (CRIU-image-style raw view of the tree)."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def unflatten_like(template: PyTree, flat: Dict[str, Any],
                   prefix: str = "") -> PyTree:
    """The inverse of :func:`flatten_with_paths` for `template`'s
    structure: dicts, dataclasses (rebuilt as the same class), lists and
    tuples, with every leaf taken from `flat` by its path."""
    if isinstance(template, dict):
        return {k: unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if _is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: unflatten_like(getattr(template, f.name), flat,
                                   f"{prefix}{f.name}/")
            for f in dataclasses.fields(template)})
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten_like(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    if template is None:
        return None
    return flat[prefix[:-1]]


def flatten_shardings(shardings: Optional[Dict[str, PyTree]]
                      ) -> Dict[str, Dict[str, Any]]:
    """{state: tree of NamedSharding} -> {state: {path: sharding}}; a
    None subtree (or leaf) means "no sharding" there."""
    return {name: flatten_with_paths(tree)
            for name, tree in (shardings or {}).items()}


# ---------------------------------------------------------------- entries
def _blocks(t: torch.Tensor, sharding) -> List[tuple]:
    """The index tuples (into `t`) of the blocks `t` is written as: one
    per distinct block of `sharding`, or the whole tensor; on a process
    mesh, all of `t` when this rank writes its block, else none."""
    whole = tuple(slice(0, int(s)) for s in t.shape)
    if sharding is None:
        return [whole]
    if is_process_sharding(sharding):
        return [] if local_layout(sharding, tuple(t.shape))[2] is None \
            else [whole]
    return sharding.shard_indices(tuple(t.shape))


def tensor_entry(t: torch.Tensor, hosts: List[torch.Tensor],
                 sharding=None) -> Dict[str, Any]:
    """Image entry for `t`, whose blocks' bytes are already in the host
    tensors `hosts` (one per block of `sharding`, in its order).  On a
    process mesh the entry is the whole tensor's: every distinct block,
    with bytes (``data``) only for the one this rank writes."""
    if is_process_sharding(sharding):
        shape, blocks, mine = local_layout(sharding, tuple(t.shape))
        shards = [{"index": index_to_json(idx, shape),
                   "data": host_numpy(hosts[0]) if i == mine else None}
                  for i, idx in enumerate(blocks)]
    else:
        shape = tuple(int(s) for s in t.shape)
        shards = [{"index": index_to_json(idx, shape),
                   "data": host_numpy(h)}
                  for idx, h in zip(_blocks(t, sharding), hosts)]
    return {
        "kind": "device_array",
        "shape": list(shape),
        "dtype": tensor_dtype_str(t),
        "sharding": sharding_descriptor(t, sharding),
        "shards": shards,
    }


def _copy_blocks(leaf: torch.Tensor, sharding, side,
                 staged: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each block of `leaf` into a host tensor of its own.  CUDA blocks
    go into fresh pinned buffers, the copies issued on `side` and not
    waited for (a strided block is staged contiguous on the device
    first, kept alive in `staged` until the caller syncs `side`)."""
    src = leaf.detach()
    out = []
    for idx in _blocks(leaf, sharding):
        view = src[idx]
        if not leaf.is_cuda:
            out.append(view.clone(memory_format=torch.contiguous_format))
            continue
        buf = torch.empty(view.shape, dtype=view.dtype, pin_memory=True)
        with torch.cuda.stream(side):
            if not view.is_contiguous():
                view = view.contiguous()
                staged.append(view)
            buf.copy_(view, non_blocking=True)
        out.append(buf)
    return out


def _side_stream(device: torch.device, after) -> "torch.cuda.Stream":
    """A fresh side stream on `device` ordered after `after` (an event,
    or a stream)."""
    side = torch.cuda.Stream(device)
    if isinstance(after, torch.cuda.Event):
        side.wait_event(after)
    else:
        side.wait_stream(after)
    return side


def leaf_entry(leaf: Any) -> Dict[str, Any]:
    if isinstance(leaf, np.ndarray):
        return {"kind": "np", "data": leaf.copy()}
    return {"kind": "host", "value": leaf}


def capture_tree(roots: Dict[str, PyTree],
                 shardings: Optional[Dict[str, Dict[str, Any]]] = None
                 ) -> Dict[str, Dict[str, Any]]:
    """name -> {path -> entry}; `shardings` is {name: {path: sharding}}
    (:func:`flatten_shardings`).  Every CUDA block's D2H copy is issued
    on a side stream into its own pinned buffer before the first wait, so
    the copies overlap each other; the side stream is drained before
    return."""
    flat = {name: flatten_with_paths(tree) for name, tree in roots.items()}
    shardings = shardings or {}
    hosts: Dict[tuple, List[torch.Tensor]] = {}
    streams: Dict[torch.device, torch.cuda.Stream] = {}
    staged: List[torch.Tensor] = []
    for name, leaves in flat.items():
        for path, leaf in leaves.items():
            if not isinstance(leaf, torch.Tensor):
                continue
            key = (id(leaf), shardings.get(name, {}).get(path))
            if key in hosts:
                continue
            side = None
            if leaf.is_cuda:
                side = streams.get(leaf.device)
                if side is None:
                    side = streams[leaf.device] = _side_stream(
                        leaf.device, torch.cuda.current_stream(leaf.device))
            hosts[key] = _copy_blocks(leaf, key[1], side, staged)
    for side in streams.values():
        side.synchronize()                 # capture complete before unlock
    del staged
    out: Dict[str, Dict[str, Any]] = {}
    for name, leaves in flat.items():
        sh = shardings.get(name, {})
        out[name] = {
            path: (tensor_entry(leaf, hosts[(id(leaf), sh.get(path))],
                                sh.get(path))
                   if isinstance(leaf, torch.Tensor) else leaf_entry(leaf))
            for path, leaf in leaves.items()}
    return out


def assemble_global(entry: Dict[str, Any]) -> np.ndarray:
    """The full logical array from saved shards (storage dtype: bf16 as
    uint16 bits)."""
    shape = tuple(entry["shape"])
    shards = entry["shards"]
    if len(shards) == 1 and [tuple(i) for i in shards[0]["index"]] == \
            [(0, s) for s in shape]:
        return np.asarray(shards[0]["data"]).reshape(shape)
    out = np.empty(shape, dtype=dtype_from_str(entry["dtype"]))
    for sh in shards:
        idx = tuple(slice(a, b) for a, b in sh["index"])
        piece = tuple(s.stop - s.start for s in idx)
        out[idx] = np.asarray(sh["data"]).reshape(piece)
    return out


def _to_device(t: torch.Tensor, device: torch.device,
               non_blocking: bool) -> torch.Tensor:
    if non_blocking and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def place_blocks(entry: Dict[str, Any], sharding, device: torch.device,
                 non_blocking: bool = False) -> Optional[torch.Tensor]:
    """The tensor of `entry` on `device`, each saved block copied
    straight to its index, when `sharding`'s blocks are among the saved
    ones (the identical / translated fast path); None otherwise."""
    shape = tuple(entry["shape"])
    saved = {tuple(map(tuple, sh["index"])): sh for sh in entry["shards"]}
    want = [index_to_json(idx, shape)
            for idx in fit_sharding(sharding, shape).shard_indices(shape)]
    if any(tuple(map(tuple, w)) not in saved for w in want):
        return None
    out = None
    for w in want:
        piece = tuple(b - a for a, b in w)
        host = numpy_to_tensor(np.asarray(saved[tuple(map(tuple, w))]
                                          ["data"]).reshape(piece),
                               entry["dtype"])
        if out is None:
            out = torch.empty(shape, dtype=host.dtype, device=device)
        dst = out[tuple(slice(a, b) for a, b in w)]
        if device.type != "cuda":
            dst.copy_(host)
        elif dst.is_contiguous():
            dst.copy_(host.pin_memory() if non_blocking else host,
                      non_blocking=non_blocking)
        else:
            # a strided block: one contiguous H2D, then a device copy
            dst.copy_(_to_device(host, device, non_blocking))
    return out


def _overlap(a, b) -> Optional[List[List[int]]]:
    """The intersection of two ``[[start, stop], ...]`` blocks, or None."""
    out = [[max(x0, y0), min(x1, y1)] for (x0, x1), (y0, y1) in zip(a, b)]
    return out if all(lo < hi for lo, hi in out) else None


def process_region(entry: Dict[str, Any], sharding) -> Optional[list]:
    """The block (``[[start, stop], ...]``) of `entry`'s tensor this rank
    holds under `sharding`, when that is a process mesh's; else None."""
    if entry["kind"] != "device_array" or not is_process_sharding(sharding):
        return None
    shape = tuple(entry["shape"])
    return index_to_json(rank_index(fit_sharding(sharding, shape), shape),
                         shape)


def place_region(entry: Dict[str, Any], region: list,
                 device: torch.device, non_blocking: bool = False
                 ) -> Tuple[torch.Tensor, bool]:
    """The `region` block of `entry`'s tensor on `device`, and whether it
    was one saved block placed as it is (else cut from the saved blocks
    that overlap it, which must have been loaded)."""
    piece = tuple(b - a for a, b in region)
    for sh in entry["shards"]:
        if [list(x) for x in sh["index"]] == region:
            host = numpy_to_tensor(np.asarray(sh["data"]).reshape(piece),
                                   entry["dtype"])
            return _to_device(host, device, non_blocking), True
    out = np.empty(piece, dtype=dtype_from_str(entry["dtype"]))
    for sh in entry["shards"]:
        hit = _overlap(sh["index"], region)
        if hit is None:
            continue
        src_shape = tuple(b - a for a, b in sh["index"])
        src = tuple(slice(lo - a, hi - a)
                    for (lo, hi), (a, _) in zip(hit, sh["index"]))
        dst = tuple(slice(lo - a, hi - a)
                    for (lo, hi), (a, _) in zip(hit, region))
        out[dst] = np.asarray(sh["data"]).reshape(src_shape)[src]
    return _to_device(numpy_to_tensor(out, entry["dtype"]), device,
                      non_blocking), False


def _entry_value(entry: Dict[str, Any], device: Optional[torch.device],
                 non_blocking: bool = False, sharding=None,
                 stats: Optional[Dict[str, float]] = None):
    """The restored leaf of `entry` on `device` (None: host numpy).  With
    `non_blocking` a CUDA copy is enqueued on the current stream from
    pinned memory and not waited on.  With a target `sharding` whose
    blocks are the saved ones, each block is placed at its index;
    otherwise the tensor is assembled on the host and copied once."""
    if entry["kind"] == "device_array":
        region = process_region(entry, sharding)
        if region is not None and device is not None:
            t, placed = place_region(entry, region, device, non_blocking)
            if stats is not None:
                key = "placed_blocks" if placed else "assembled_entries"
                stats[key] = stats.get(key, 0.0) + 1
            return t
        if device is not None and sharding is not None:
            t = place_blocks(entry, sharding, device, non_blocking)
            if t is not None:
                if stats is not None:
                    stats["placed_blocks"] = (stats.get("placed_blocks", 0.0)
                                              + len(entry["shards"]))
                return t
        if stats is not None and len(entry["shards"]) > 1:
            stats["assembled_entries"] = (
                stats.get("assembled_entries", 0.0) + 1)
        arr = assemble_global(entry)
        if device is None:
            return arr
        return _to_device(numpy_to_tensor(arr, entry["dtype"]), device,
                          non_blocking)
    if entry["kind"] == "np":
        return entry["data"]
    return entry["value"]


# ---------------------------------------------------------------- plugins
class StreamBoundary:
    """The CRAC-style capture boundary: every pause drains the injectable
    fake streams (``repro_torch.core.streams``) and fails fast with
    ``UnsafeOpInFlight`` on an op that cannot be quiesced.  During a
    concurrent capture, stream retirements feed the dirty tracker."""

    streams = None            # Optional[repro_torch.core.streams.StreamSet]

    def attach_streams(self, streams) -> None:
        self.streams = streams

    def begin_tracking(self, tracker) -> None:
        """Route stream retirements into the dirty set for the duration
        of a concurrent capture."""
        if self.streams is not None:
            self.streams.on_retire = (
                lambda op: tracker.note_many(op.targets))

    def end_tracking(self) -> None:
        if self.streams is not None:
            self.streams.on_retire = None

    @staticmethod
    def flatten_keys(roots: Dict[str, PyTree]) -> Dict[str, Any]:
        """roots -> {"state::path": leaf} in capture order."""
        return {f"{name}::{key}": leaf
                for name, tree in roots.items()
                for key, leaf in flatten_with_paths(tree).items()}

    def drain_streams(self) -> None:
        if self.streams is None:
            return
        from repro_torch.core.streams import UnsafeOpInFlight
        stuck = self.streams.drain()
        if stuck:
            raise UnsafeOpInFlight(stuck)


class TorchBackend(StreamBoundary, Plugin):
    """The "torch" device backend: tensors on `device` (CUDA or CPU)."""

    name = "device"
    api_version = PLUGIN_API_VERSION
    features = TORCH_BACKEND_FEATURES

    def __init__(self, lock_timeout_s: float = 10.0,
                 restore_threads: int = 0,
                 device: Optional[torch.device] = None):
        self.device = resolve_device(device) if device is not None \
            else None
        self.lock = DeviceLock(lock_timeout_s, self.device)
        self.restore_threads = restore_threads
        self._pin_event = None

    # --- concurrent capture ---
    def begin_tracking(self, tracker) -> None:
        """Also mark the pin on the compute stream: the speculation's
        copies are ordered after it."""
        super().begin_tracking(tracker)
        if self.device is not None and self.device.type == "cuda":
            self._pin_event = torch.cuda.Event()
            self._pin_event.record(torch.cuda.current_stream(self.device))

    def end_tracking(self) -> None:
        super().end_tracking()
        self._pin_event = None

    def capture_entry(self, leaf: Any, sharding=None) -> Dict[str, Any]:
        """Capture one leaf (the concurrent speculation loop and the
        validate patch), as one block per distinct block of `sharding`.
        A CUDA tensor is copied on a side stream that waits on the pin's
        event (or on the compute stream outside a capture) into fresh
        pinned buffers, and the copies have completed on return."""
        if not isinstance(leaf, torch.Tensor):
            return leaf_entry(leaf)
        side = None
        if leaf.is_cuda:
            after = self._pin_event if self._pin_event is not None \
                else torch.cuda.current_stream(leaf.device)
            side = _side_stream(leaf.device, after)
        staged: List[torch.Tensor] = []
        hosts = _copy_blocks(leaf, sharding, side, staged)
        if side is not None:
            side.synchronize()
        return tensor_entry(leaf, hosts, sharding)

    # --- dump ---
    def pause_devices(self, ctx: HookContext) -> None:
        ctx.stats["lock_s"] = self.lock.lock()
        self.drain_streams()       # CRAC boundary: may raise UnsafeOp
        if self.device is None or self.device.type != "cuda":
            return
        seen: set = set()
        root_bytes = 0
        for tree in getattr(ctx, "roots", {}).values():
            for leaf in flatten_with_paths(tree).values():
                if (isinstance(leaf, torch.Tensor) and leaf.is_cuda
                        and leaf.untyped_storage().data_ptr() not in seen):
                    seen.add(leaf.untyped_storage().data_ptr())
                    root_bytes += leaf.untyped_storage().nbytes()
        leftover = torch.cuda.memory_allocated(self.device) - root_bytes
        ctx.stats["leftover_device_bytes"] = float(max(leftover, 0))
        if leftover > 0:
            ctx.warnings.append(
                f"{leftover} bytes of device memory outside the registered "
                f"roots (temporaries, caches); these are re-creatable and "
                f"excluded from the image")

    def checkpoint_devices(self, ctx: HookContext) -> None:
        t0 = time.perf_counter()
        dev_bytes = 0
        for name, cap in capture_tree(getattr(ctx, "roots", {}),
                                      getattr(ctx, "shardings", None)
                                      ).items():
            ctx.device_snapshot[name] = cap
            for e in cap.values():
                if e["kind"] == "device_array":
                    dev_bytes += sum(s["data"].nbytes for s in e["shards"]
                                     if s["data"] is not None)
        ctx.stats["device_to_host_s"] = time.perf_counter() - t0
        ctx.stats["capture_s"] = ctx.stats["device_to_host_s"]
        ctx.stats["device_bytes"] = float(dev_bytes)

    # --- restore ---
    def update_topology_map(self, ctx: HookContext) -> None:
        saved = ctx.manifest.get("topology", {})
        target = mesh_fingerprint(getattr(ctx, "target_mesh", None),
                                  self.device)
        ctx.topology_map["mode"] = compatibility(saved, target)
        ctx.topology_map["target"] = target

    def _target(self) -> Optional[torch.device]:
        """Where restored arrays go (None: stay numpy)."""
        return self.device

    @staticmethod
    def _layout(ctx: HookContext):
        """A restore's target: (mesh, {state: {path: sharding}})."""
        return (getattr(ctx, "target_mesh", None),
                flatten_shardings(getattr(ctx, "target_shardings", None)))

    @staticmethod
    def _target_sharding(layout, state: str, path: str,
                         entry: Dict[str, Any]):
        """The layout `entry` is placed in: the caller's sharding for
        this leaf, else its saved descriptor resolved on the target
        mesh, else None (whole)."""
        mesh, flat = layout
        sh = flat.get(state, {}).get(path)
        if sh is None and entry["kind"] == "device_array":
            sh = resolve_sharding(entry["sharding"] or {}, mesh)
        return sh

    def _placer(self, ctx: HookContext):
        """Load + rebuild one leaf — the unit the lazy materializer
        streams; a CUDA copy is enqueued on the current stream from
        pinned memory.  The function holds the layout and the stats
        dict, not `ctx`: the materializer it goes into hangs off `ctx`,
        and a cycle would keep the restored tensors alive until a
        collection."""
        layout, stats = self._layout(ctx), ctx.stats

        def place(reader, state: str, path: str):
            entry, sh = self._load(reader, layout, state, path)
            return _entry_value(entry, self._target(), non_blocking=True,
                                sharding=sh, stats=stats)
        return place

    @classmethod
    def _load(cls, reader, layout, state: str, path: str):
        """One leaf's entry, read for the target `layout` (on a process
        mesh, only the saved blocks that overlap this rank's), and the
        sharding it is placed in."""
        meta = reader.meta[state][path]
        sh = cls._target_sharding(layout, state, path, meta)
        region = process_region(meta, sh)
        return reader.load_entry(state, path, region=region), sh

    @classmethod
    def needed_pack_entries(cls, reader, mesh, shardings,
                            leaves=None) -> List[str]:
        """The pack entries a restore onto `mesh` with `shardings`
        ({state: tree}) reads: on a process mesh, this rank's blocks'
        (what it verifies before it trusts an image); with `leaves` (a
        set of (state, path): a lazy restore's critical set), only
        theirs."""
        layout = (mesh, flatten_shardings(shardings))
        names = ["__meta__", "__host__"]
        for state in reader.state_names():
            for path, meta in reader.meta[state].items():
                if leaves is not None and (state, path) not in leaves:
                    continue
                sh = cls._target_sharding(layout, state, path, meta)
                names += reader.pack_entries(
                    state, path, region=process_region(meta, sh))
        return names

    def resume_devices_late(self, ctx: HookContext) -> None:
        """host -> device restore; with restore_threads > 1 worker threads
        read pack entries while the main thread places them.  Lazy mode
        (resume-before-read): only the critical set is placed here; the
        rest is handed to a LazyMaterializer the engine starts after the
        job is unlocked."""
        t0 = time.perf_counter()
        reader = ctx.reader
        threads = getattr(ctx, "restore_threads", 0) or self.restore_threads
        if getattr(ctx, "lazy", False):
            from repro_torch.core.lazy import resume_with_schedule
            target = self._target()
            resume_with_schedule(ctx, self._placer(ctx), threads, target)
            if target is not None and target.type == "cuda":
                # the critical copies were enqueued non-blocking
                torch.cuda.synchronize(target)
            self.lock.unlock()                    # resume on criticals
            ctx.stats["host_to_device_s"] = time.perf_counter() - t0
            ctx.stats["place_s"] = ctx.stats.get("place_critical_s", 0.0)
            return
        place_s = 0.0
        layout = self._layout(ctx)
        for name in reader.state_names():
            keys = reader.entry_names(name)
            if threads > 1 and len(keys) > 1:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(max_workers=threads) as ex:
                    loaded = list(ex.map(
                        lambda k: self._load(reader, layout, name, k), keys))
            else:
                loaded = [self._load(reader, layout, name, k) for k in keys]
            t_place = time.perf_counter()
            restored = {key: _entry_value(entry, self._target(),
                                          sharding=sh, stats=ctx.stats)
                        for key, (entry, sh) in zip(keys, loaded)}
            place_s += time.perf_counter() - t_place
            ctx.restored[name] = unflatten_paths(restored)
        self.lock.unlock()
        ctx.stats["host_to_device_s"] = time.perf_counter() - t0
        ctx.stats["place_s"] = place_s
