"""Snapshot store: on-disk layout, writer, reader — the reference's layout.

Layout:
  run_dir/snapshots/step_00000123/
    MANIFEST.json         — committed last (atomic rename) = the image is valid
    host0000.pack.0..N-1  — this host's payloads, striped (pack v2)
    host0000.pack         — v1 single-file layout (``pack_format=1``)

Incremental mode (Check-N-Run-style): unchanged entries (by content CRC)
are not rewritten; the manifest's ``locations`` point them at the pack of
an earlier image, forming a delta chain that the reader resolves.
Partially changed entries dedup at chunk grain: unchanged chunks (matched
by their raw CRC, which doubles as the content hash) become ``ref``
records into the parent's stripes.

The writer is the serialization stage of the pipelined data plane: entries
are chunked and handed to ``serialization.pack.PackWriterV2``, whose
compress workers and per-stripe appenders overlap CRC/compression with
file I/O.  The reader follows the manifest's ``locations`` and fans chunk
reads out to ``io_threads``; it also serves the lazy restore's schedule
(``restore_order``, ``entry_schedule``, ``verify_entries``).

Host blobs (``__meta__``, ``__host__``) are msgpack with numpy arrays as
``{"__np__": True, "dtype", "shape", "data"}`` maps — the reference's
``_mp_default`` encoding — through the port's ``msgpack_lite``.

Across the ranks of a process group (a writer given a ``barrier``, a
``core.multihost.MultiHostCommit``) each rank writes its own
``host{rank:04d}.pack`` with the blocks it holds; rank 0 adds the blobs
(``__meta__`` lists every block of every leaf) and, once every rank has
prepared, the manifest, whose ``locations`` table covers every rank's
entries.  A reader follows ``locations`` whatever pack an entry is in,
and a rank restoring its own block reads only the blocks that overlap it
(``load_entry(..., region=)``).  An incremental image across ranks has
one parent, which every rank was given (the merged manifest checks that
they agree); each rank dedups its blocks against the parent's entries
of the same name and the same extent (``prev_meta``, the parent's block
layout), so a block is never taken for another block of the same name
after a restore onto another world size.

"""
from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.chaos import hooks as chaos_hooks
from repro_torch.obs import trace as obs_trace
from repro_torch.serialization import msgpack_lite
from repro_torch.serialization.integrity import (atomic_write_json, crc32,
                                                 crc32_many, read_json)
from repro_torch.serialization.pack import (DEFAULT_CHUNK_BYTES, PackWriter,
                                            PackWriterV2, open_pack)

MANIFEST = "MANIFEST.json"


def auto_io_threads() -> int:
    """The io_threads=0 auto-sizing policy (as in the reference)."""
    return min(8, max(2, os.cpu_count() or 2))


# ------------------------------------------------------------- msgpack np
def _mp_default(obj):
    if isinstance(obj, np.ndarray):
        return {"__np__": True, "dtype": obj.dtype.str,
                "shape": list(obj.shape), "data": obj.tobytes()}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    raise TypeError(f"not msgpack-able: {type(obj)}")


def _mp_hook(obj):
    if "__np__" in obj:
        return np.frombuffer(obj["data"], np.dtype(obj["dtype"])
                             ).reshape(obj["shape"]).copy()
    return obj


def pack_host_blob(obj: Any) -> bytes:
    return msgpack_lite.packb(obj, default=_mp_default)


def unpack_host_blob(raw: bytes) -> Any:
    return msgpack_lite.unpackb(raw, object_hook=_mp_hook)


def snapshot_dir(run_dir: str, step: int) -> str:
    return os.path.join(run_dir, "snapshots", f"step_{step:08d}")


def _overlaps(index, region) -> bool:
    """Whether a saved block ``[[start, stop], ...]`` meets `region`."""
    return all(max(a, c) < min(b, d)
               for (a, b), (c, d) in zip(index, region))


def _extent(index) -> list:
    """A block's ``[[start, stop], ...]`` as plain ints (a capture's and
    a stored ``__meta__``'s compare equal)."""
    return [[int(a), int(b)] for a, b in index]


def _loc_step(loc: str) -> int:
    """'step_00000042/host0000.pack' -> 42."""
    return int(loc.split("/")[0][5:])


# ---------------------------------------------------------------- writer
_NEVER_SPECULATED = object()


class SnapshotWriter:
    def __init__(self, run_dir: str, step: int, host_id: int = 0,
                 compress: bool = False,
                 prev_manifest: Optional[Dict[str, Any]] = None,
                 prev_meta: Optional[Dict[str, Any]] = None,
                 pack_format: int = 2,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 stripes: int = 2, io_threads: int = 0, barrier=None):
        if pack_format not in (1, 2):
            raise ValueError(f"pack_format must be 1 or 2, got {pack_format}")
        self.run_dir = run_dir
        self.step = step
        self.format = pack_format
        self.dir = snapshot_dir(run_dir, step)
        os.makedirs(self.dir, exist_ok=True)
        # across ranks: rank 0 writes the blobs and commits the manifest
        self.barrier = barrier
        self.primary = host_id == 0
        self.barrier_wait_s = 0.0
        self.pack_bytes = 0
        self.pack_name = f"host{host_id:04d}.pack"
        self._loc = os.path.join(f"step_{step:08d}", self.pack_name)
        base = os.path.join(self.dir, self.pack_name)
        if pack_format == 1:
            self._writer: Any = PackWriter(base, compress=compress)
            self.files = [self.pack_name]
        else:
            self._writer = PackWriterV2(base, compress=compress,
                                        chunk_bytes=chunk_bytes,
                                        stripes=stripes,
                                        workers=io_threads
                                        or auto_io_threads())
            self.files = [f"{self.pack_name}.{k}" for k in range(stripes)]
        self.chunk_bytes = chunk_bytes
        self.stripes = stripes if pack_format == 2 else 1
        self.locations: Dict[str, str] = {}
        self.meta: Dict[str, Any] = {}
        # incremental: entry -> (crc, location) in the parent image
        self._prev: Dict[str, Any] = {}
        self.parent_step: Optional[int] = None
        if prev_manifest is not None:
            self.parent_step = prev_manifest["step"]
            self._prev = {
                name: {"crc": crc, "loc": prev_manifest["locations"][name]}
                for name, crc in prev_manifest.get("entry_crcs", {}).items()}
        # the parent's block extent of each device entry (None: unknown,
        # names alone decide, as on one process)
        self._prev_extent: Optional[Dict[str, list]] = None
        if prev_meta is not None:
            self._prev_extent = {
                f"{state}::{path}::s{i}": _extent(idx)
                for state, leaves in prev_meta.items()
                for path, m in leaves.items()
                if m.get("kind") == "device_array"
                for i, idx in enumerate(m["shards"])}
        self._parent_packs: Dict[str, Any] = {}      # loc -> reader | None
        self.entry_crcs: Dict[str, int] = {}
        self.reused_bytes = 0
        self.written_bytes = 0
        self._hash_s = 0.0
        # restore-priority hint: entry names in registration order, with
        # per-entry raw sizes (the lazy restore's schedule)
        self.restore_order: List[str] = []
        self.entry_bytes: Dict[str, int] = {}
        # per-entry chunk CRCs as speculated/written — the concurrent
        # validate pass compares live bytes against these (None marks a
        # v1-parent reuse where only the whole-entry CRC is known)
        self.spec_crcs: Dict[str, Optional[List[int]]] = {}

    # --------------------------------------------------- chunk-level dedup
    def _parent_entry(self, name: str) -> Optional[Tuple[Dict[str, Any],
                                                          str]]:
        """(parent entry record, parent pack loc) if the parent holds this
        entry in a v2 pack with matching chunking, else None."""
        prev = self._prev.get(name)
        if prev is None:
            return None
        loc = prev["loc"]
        if loc not in self._parent_packs:
            reader = None
            try:
                r = open_pack(os.path.join(self.run_dir, "snapshots", loc))
                if r.format == 2 and r.chunk_bytes == self.chunk_bytes:
                    reader = r
                else:
                    r.close()
            except (OSError, ValueError):
                reader = None
            self._parent_packs[loc] = reader
        reader = self._parent_packs[loc]
        if reader is None or name not in reader.index:
            return None
        return reader.entry(name), loc

    def _chunk_crcs(self, flat) -> List[int]:
        t0 = time.perf_counter()
        mv = memoryview(flat).cast("B")
        C = self.chunk_bytes
        crcs = crc32_many([mv[o:o + C] for o in range(0, len(mv), C)])
        self._hash_s += time.perf_counter() - t0
        return crcs

    def _whole_crc(self, flat) -> int:
        t0 = time.perf_counter()
        c = crc32(memoryview(flat).cast("B"))
        self._hash_s += time.perf_counter() - t0
        return c

    def _reuse(self, name: str, crc: int, nbytes: int,
               spec: Optional[List[int]]) -> None:
        self.entry_crcs[name] = crc
        self.locations[name] = self._prev[name]["loc"]   # delta: entry reuse
        self.reused_bytes += nbytes
        self.spec_crcs[name] = spec

    def _put(self, name: str, data: np.ndarray, dtype: str,
             index: Optional[list] = None) -> None:
        """Write one pack entry, or reuse the parent's: hash once, at
        chunk grain, and make both reuse decisions from that single pass
        (whole-entry reuse = every chunk matches; partial = the pack
        writer refs the matching chunks).  `index`: the block's extent;
        a parent entry of the same name over another extent is not a
        parent of this one."""
        raw, flat = PackWriterV2._flat(data)
        self.restore_order.append(name)
        self.entry_bytes[name] = int(raw.nbytes)
        prev = self._prev.get(name)
        if (prev is not None and self._prev_extent is not None
                and index is not None
                and self._prev_extent.get(name) != _extent(index)):
            self._prev.pop(name)
            prev = None
        if self.format == 1:
            # v1: whole-entry reuse only; the entry CRC is of the raw
            # bytes (the pack index's CRC covers the stored ones)
            c = self._whole_crc(flat)
            if prev is not None and prev["crc"] == c:
                self._reuse(name, c, raw.nbytes, None)
                return
            self._writer.add(name, raw, dtype=dtype)
            self._record_written(name, raw, crc=c)
            return
        parent = self._parent_entry(name) if prev is not None else None
        if parent is not None:
            crcs = self._chunk_crcs(flat)
            pchunks = parent[0]["chunks"]
            if (parent[0]["raw_nbytes"] == raw.nbytes
                    and len(crcs) == len(pchunks)
                    and all(c == p.get("raw_crc32")
                            for c, p in zip(crcs, pchunks))):
                self._reuse(name, parent[0]["crc32"], raw.nbytes, crcs)
                return
            self._writer.add(name, raw, dtype=dtype, parent=parent,
                             chunk_crcs=crcs)
        elif prev is not None:
            # parent exists but is v1 / differently chunked: the
            # whole-entry CRC is all the dedup available
            c = self._whole_crc(flat)
            if prev["crc"] == c:
                self._reuse(name, c, raw.nbytes, None)
                return
            self._writer.add(name, raw, dtype=dtype)
        else:
            self._writer.add(name, raw, dtype=dtype)
        self._record_written(name, raw)
        self.spec_crcs[name] = self._writer.raw_crcs(name)

    def _record_written(self, name: str, raw: np.ndarray,
                        crc: Optional[int] = None) -> None:
        self.entry_crcs[name] = (crc if crc is not None
                                 else self._writer.entry_crc(name))
        self.locations[name] = self._loc
        self.written_bytes += raw.nbytes

    def _pieces(self, state: str, path: str, e: Dict[str, Any]
                ) -> List[Tuple[str, np.ndarray, Optional[str],
                                Optional[list]]]:
        """(pack entry name, data, stored dtype, block extent) of one
        captured leaf: the blocks this writer holds bytes of (all but
        another rank's), and a host array on rank 0 only."""
        if e["kind"] == "device_array":
            return [(f"{state}::{path}::s{i}", s["data"], e["dtype"],
                     s["index"])
                    for i, s in enumerate(e["shards"])
                    if s["data"] is not None]
        if e["kind"] == "np" and self.primary:
            return [(f"{state}::{path}::np", e["data"], None, None)]
        return []

    def _set_meta(self, state: str, path: str, e: Dict[str, Any]) -> None:
        meta = self.meta.setdefault(state, {})
        if e["kind"] == "device_array":
            meta[path] = {
                "kind": "device_array", "shape": e["shape"],
                "dtype": e["dtype"], "sharding": e["sharding"],
                "shards": [s["index"] for s in e["shards"]],
            }
        elif e["kind"] == "np":
            meta[path] = {"kind": "np"}
        else:
            meta[path] = {"kind": "host", "value": e["value"]}

    def put_state_entry(self, state: str, path: str,
                        e: Dict[str, Any]) -> None:
        """Write one captured leaf (the concurrent speculation loop streams
        entries one at a time; write_states is the batch form)."""
        self._set_meta(state, path, e)
        for name, data, dtype, index in self._pieces(state, path, e):
            self._put(name, data, dtype, index)

    def write_states(self, device_snapshot: Dict[str, Dict[str, Any]]) -> None:
        """device_snapshot: state_name -> {leafpath -> captured entry}."""
        for state, entries in device_snapshot.items():
            self.meta.setdefault(state, {})
            for path, e in entries.items():
                self.put_state_entry(state, path, e)

    def flush(self) -> None:
        """Drain the pack pipeline without closing it: every speculated
        chunk record is populated, the stripe set stays open for
        re-capture (concurrent capture's validate/patch boundary)."""
        if self.format == 2:
            self._writer.flush()

    def reput_state_entry(self, state: str, path: str,
                          e: Dict[str, Any]) -> int:
        """Validate one dirtied leaf against the speculated image and
        patch only the pieces whose content hash changed (the patch phase
        of concurrent capture).  Returns the raw bytes re-captured (0 =
        the speculation validated bit-exact).  Call flush() first."""
        if e["kind"] == "host":
            # host leaves are tiny python values: always refresh
            self._set_meta(state, path, e)
            return 0
        recaptured = 0
        for name, data, dtype, index in self._pieces(state, path, e):
            raw, flat = PackWriterV2._flat(data)
            crcs = self._chunk_crcs(flat)
            spec = self.spec_crcs.get(name, _NEVER_SPECULATED)
            if (spec is not _NEVER_SPECULATED and spec is not None
                    and crcs == spec
                    and self.entry_bytes.get(name) == raw.nbytes):
                continue                     # speculation validated
            if spec is None and self._whole_crc(flat) == \
                    self.entry_crcs.get(name):
                continue                     # v1-parent reuse still valid
            if spec is _NEVER_SPECULATED:
                # structural drift: a leaf that did not exist at pin
                self._put(name, raw, dtype, index)
            elif self.locations.get(name) != self._loc:
                # was reused from the parent image: pull it into this
                # pack now (the parent copy no longer matches)
                self.reused_bytes -= self.entry_bytes.get(name, raw.nbytes)
                self._writer.add(name, raw, dtype=dtype,
                                 parent=self._parent_entry(name),
                                 chunk_crcs=crcs)
                self._record_written(name, raw)
                self.spec_crcs[name] = crcs
            else:
                # speculated into this pack: append-only patch, with the
                # old record as dedup parent so untouched chunks stay as
                # self-references
                self._writer.replace(name, raw, dtype=dtype,
                                     own_loc=self._loc, chunk_crcs=crcs)
                self.entry_crcs[name] = self._writer.entry_crc(name)
                self.spec_crcs[name] = crcs
            recaptured += raw.nbytes
            self.entry_bytes[name] = int(raw.nbytes)
        # refresh shape/sharding metadata alongside the patched bytes
        self._set_meta(state, path, e)
        return recaptured

    def drop_state_entry(self, state: str, path: str) -> None:
        """Remove a leaf from the image metadata (concurrent capture: the
        entry vanished from the live tree between pin and validate).  Any
        speculated bytes stay in the pack as dead data; restore only
        follows the metadata."""
        self.meta.get(state, {}).pop(path, None)

    @property
    def superseded_bytes(self) -> int:
        return getattr(self._writer, "superseded_bytes", 0)

    def write_host_state(self, host_state: Dict[str, Any]) -> None:
        if not self.primary:
            return                      # rank 0's pack holds the blobs
        blob = pack_host_blob(host_state)
        self._writer.add_bytes("__host__", blob)
        self.locations["__host__"] = self._loc
        # host blobs restore last in the lazy schedule (coldest priority)
        self.restore_order.append("__host__")
        self.entry_bytes["__host__"] = len(blob)

    def _close_parent_packs(self) -> None:
        for r in self._parent_packs.values():
            if r is not None:
                r.close()
        self._parent_packs.clear()

    def commit(self, topology: Dict[str, Any],
               stats: Optional[Dict[str, Any]] = None,
               extra: Optional[Dict[str, Any]] = None) -> str:
        with obs_trace.span("dump.commit", step=self.step):
            if self.primary:
                self._writer.add_bytes("__meta__", pack_host_blob(self.meta))
                self.locations["__meta__"] = self._loc
            self._writer.close()
            self.pack_bytes = sum(
                os.path.getsize(os.path.join(self.dir, f))
                for f in self.files
                if os.path.exists(os.path.join(self.dir, f)))
            self._close_parent_packs()
            reused_chunks = getattr(self._writer, "reused_chunk_bytes", 0)
            self.written_bytes -= reused_chunks
            self.reused_bytes += reused_chunks
            # every step this image's bytes live in (locations = entry
            # reuse; chunk refs = chunk reuse): GC keeps them all
            ref_steps = {_loc_step(loc) for loc in self.locations.values()}
            ref_steps.update(_loc_step(loc)
                             for loc in getattr(self._writer, "ref_locs", ()))
            manifest = {
                "format": self.format,
                "step": self.step,
                "timestamp": time.time(),
                "topology": topology,
                "has_device_state": True,      # inventory flag (paper §3.1.1)
                "states": sorted(self.meta),
                "parent": self.parent_step,
                "locations": self.locations,
                "entry_crcs": self.entry_crcs,
                "files": self.files,
                "stats": dict(stats or {}),
                "reused_bytes": self.reused_bytes,
                "written_bytes": self.written_bytes,
                "ref_steps": sorted(ref_steps),
                "restore_order": self.restore_order,
                "entry_bytes": self.entry_bytes,
            }
            if self.format == 2:
                manifest["chunk_bytes"] = self.chunk_bytes
                manifest["stripes"] = self.stripes
            if extra:
                manifest.update(extra)
            if self.barrier is not None:
                return self._commit_across_ranks(manifest)
            self._write_manifest(manifest)
        return self.dir

    def _write_manifest(self, manifest: Dict[str, Any]) -> None:
        if chaos_hooks.INJECTOR is not None:
            # chaos: commit-kill site — payload in place, no manifest yet
            chaos_hooks.fire("snapshot.pre_manifest", step=self.step,
                             path=self.dir)
        atomic_write_json(os.path.join(self.dir, MANIFEST), manifest)

    #: a rank's part of the manifest, carried in its PREPARED marker
    _RANK_KEYS = ("locations", "entry_crcs", "files", "states",
                  "restore_order", "entry_bytes", "written_bytes",
                  "reused_bytes", "ref_steps", "parent")

    def _commit_across_ranks(self, manifest: Dict[str, Any]) -> str:
        """The two-phase commit (``core/multihost.py``): this rank's pack
        is closed; it prepares with its part of the manifest, then rank 0
        waits for every rank's marker and writes the merged manifest,
        while the others wait for it.  ``barrier_wait_s`` is the wait."""
        from repro_torch.core.multihost import merge_host_manifests
        b = self.barrier
        if chaos_hooks.INJECTOR is not None:
            # chaos: rank-loss site — this rank's pack written, no marker
            chaos_hooks.fire("multihost.prepare", step=self.step,
                             host_id=b.host_id, path=self.dir)
        b.prepare({k: manifest[k] for k in self._RANK_KEYS})
        t0 = time.perf_counter()
        if not b.is_coordinator:
            b.wait_committed()
            self.barrier_wait_s = time.perf_counter() - t0
            return self.dir

        def write() -> str:
            self.barrier_wait_s = time.perf_counter() - t0
            parts = b.prepared_meta()
            parents = {parts[h].get("parent") for h in parts}
            if len(parents) > 1:
                # the engine broadcasts rank 0's parent: a rank that
                # deduped against another image would point into it
                raise RuntimeError(f"step {self.step}: the ranks wrote "
                                   f"against different parents {parents}")
            merged = merge_host_manifests(self.run_dir, self.step,
                                          b.num_hosts, manifest["topology"],
                                          parts)
            out = dict(manifest, num_hosts=b.num_hosts,
                       locations=merged["locations"],
                       entry_crcs=merged["entry_crcs"],
                       files=merged["files"], states=merged["states"],
                       attempt=b.attempt)
            hosts = [parts[h] for h in sorted(parts)]
            out["restore_order"] = [n for m in hosts
                                    for n in m["restore_order"]]
            out["entry_bytes"] = {k: v for m in hosts
                                  for k, v in m["entry_bytes"].items()}
            out["ref_steps"] = sorted({s for m in hosts
                                       for s in m["ref_steps"]})
            for k in ("written_bytes", "reused_bytes"):
                out[k] = sum(m[k] for m in hosts)
            self._write_manifest(out)
            return self.dir
        return b.commit(write)

    # ------------------------------------------------------ pipeline stats
    @property
    def compress_s(self) -> float:
        return self._writer.compress_s

    @property
    def io_s(self) -> float:
        return self._writer.io_s

    @property
    def hash_s(self) -> float:
        """Caller-thread time spent CRC-ing raw bytes (the dedup pass and
        the pack writer's chunk and entry CRCs); compress workers' CRCs of
        the stored bytes are in neither this nor io_s."""
        return self._hash_s + getattr(self._writer, "hash_s", 0.0)

    @property
    def stripe_bytes(self) -> List[int]:
        return list(getattr(self._writer, "stripe_bytes", ()))

    def abort(self) -> None:
        self._close_parent_packs()
        self._writer.abort()


# ---------------------------------------------------------------- reader
class SnapshotReader:
    """Thread-safe: v1 packs get one reader per thread (their single file
    handle seeks), v2 packs share one reader (per-thread stripe handles
    inside).  `io_threads` > 1 fans the chunks of each v2 entry out to a
    shared executor."""

    def __init__(self, run_dir: str, step: int, verify: bool = True,
                 io_threads: int = 0):
        self.run_dir = run_dir
        self.step = step
        self.dir = snapshot_dir(run_dir, step)
        self.manifest = read_json(os.path.join(self.dir, MANIFEST))
        self._tls = threading.local()
        self._all_packs: List[Any] = []
        self._shared_packs: Dict[str, Any] = {}
        self._packs_lock = threading.Lock()
        self._verify = verify
        self._io_threads = io_threads
        # entries a keeping verify pass read (name -> raw bytes), each
        # handed once to the read that asks for it
        self._kept: Dict[str, np.ndarray] = {}
        self._keeping = False
        self._executor = None
        if io_threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._executor = ThreadPoolExecutor(
                max_workers=io_threads, thread_name_prefix="repro-chunk-io")
        self.meta: Dict[str, Any] = unpack_host_blob(self._read("__meta__"))

    def _pack_for(self, loc: str):
        with self._packs_lock:
            shared = self._shared_packs.get(loc)
        if shared is not None:
            return shared
        packs = getattr(self._tls, "packs", None)
        if packs is None:
            packs = self._tls.packs = {}
        if loc not in packs:
            path = os.path.join(self.run_dir, "snapshots", loc)
            r = open_pack(path, verify=self._verify,
                          executor=self._executor)
            with self._packs_lock:
                if r.format == 2:
                    # v2 readers are thread-safe; share one
                    if loc in self._shared_packs:
                        r.close()
                        return self._shared_packs[loc]
                    self._shared_packs[loc] = r
                self._all_packs.append(r)
            if r.format == 2:
                return r
            packs[loc] = r
        return packs[loc]

    def _take_kept(self, name: str) -> Optional[np.ndarray]:
        with self._packs_lock:
            return self._kept.pop(name, None)

    def _read(self, name: str) -> bytes:
        raw = self._take_kept(name)
        if raw is not None:
            return raw.tobytes()
        loc = self.manifest["locations"][name]
        return self._pack_for(loc).read_bytes(name)

    def _read_array(self, name: str) -> np.ndarray:
        loc = self.manifest["locations"][name]
        raw = self._take_kept(name)
        if raw is not None:
            return self._pack_for(loc).array_of(name, raw)
        return self._pack_for(loc).read_array(name)

    def state_names(self) -> List[str]:
        return list(self.manifest["states"])

    def entry_names(self, state: str) -> List[str]:
        return list(self.meta[state])

    # ------------------------------------------------------- lazy schedule
    def restore_order(self) -> List[str]:
        """Pack-entry names, most-critical first: the manifest's
        ``restore_order`` hint (dump-time registration order), derived
        from the meta tables for images that predate the hint."""
        order = self.manifest.get("restore_order")
        if order:
            return list(order)
        out: List[str] = []
        for state in self.state_names():
            for path in self.meta[state]:
                out.extend(self.pack_entries(state, path))
        out.append("__host__")
        return out

    def pack_entries(self, state: str, path: str,
                     region: Optional[list] = None) -> List[str]:
        """The pack-entry names backing one logical (state, path) leaf
        (with `region`, the blocks that overlap it)."""
        m = self.meta[state][path]
        if m["kind"] == "device_array":
            return [f"{state}::{path}::s{i}"
                    for i, idx in enumerate(m["shards"])
                    if region is None or _overlaps(idx, region)]
        if m["kind"] == "np":
            return [f"{state}::{path}::np"]
        return []                          # host value: lives in the meta

    def entry_schedule(self) -> List[Tuple[str, str]]:
        """Every logical (state, path) leaf, ordered by restore priority —
        the lazy materializer's streaming order.  Meta-resident host
        values sort first (they cost no I/O)."""
        prio = {n: i for i, n in enumerate(self.restore_order())}
        items: List[Tuple[str, str, int]] = []
        for state in self.state_names():
            for path in self.meta[state]:
                names = self.pack_entries(state, path)
                items.append((state, path, min(
                    (prio.get(n, len(prio)) for n in names), default=-1)))
        items.sort(key=lambda t: t[2])
        return [(s, p) for s, p, _ in items]

    def entry_nbytes(self, state: str, path: str) -> int:
        """Raw payload bytes of one logical leaf (0 for meta-resident
        host values)."""
        sizes = self.manifest.get("entry_bytes", {})
        total = 0
        for n in self.pack_entries(state, path):
            if n in sizes:
                total += int(sizes[n])
            else:                          # image without the hint
                pack = self._pack_for(self.manifest["locations"][n])
                total += int(pack.entry_nbytes(n)) \
                    if pack.format == 2 else 0
        return total

    def load_entry(self, state: str, path: str,
                   region: Optional[list] = None) -> Dict[str, Any]:
        """One leaf's entry; with `region` (``[[start, stop], ...]``)
        only the blocks that overlap it are read (the others' ``data``
        is None)."""
        m = self.meta[state][path]
        if m["kind"] == "device_array":
            shards = [{"index": idx,
                       "data": (self._read_array(f"{state}::{path}::s{i}")
                                if region is None or _overlaps(idx, region)
                                else None)}
                      for i, idx in enumerate(m["shards"])]
            return {"kind": "device_array", "shape": m["shape"],
                    "dtype": m["dtype"], "sharding": m["sharding"],
                    "shards": shards}
        if m["kind"] == "np":
            return {"kind": "np",
                    "data": self._read_array(f"{state}::{path}::np")}
        return {"kind": "host", "value": m["value"]}

    def host_state(self) -> Dict[str, Any]:
        return unpack_host_blob(self._read("__host__"))

    def _verify_one(self, name: str) -> None:
        pack = self._pack_for(self.manifest["locations"][name])
        if pack.format == 2 and self._keeping:
            raw = pack.read_raw_verified(name)    # v2: CRC'd and decoded
            with self._packs_lock:
                self._kept[name] = raw
        elif pack.format == 2:
            pack.verify_entry(name)       # v2: CRC stored chunks, no decode
        else:
            pack.read_bytes(name)         # v1: CRC implies full decode

    def verify_all(self, keep: bool = False) -> None:
        """CRC-check every entry the manifest references, so a torn image
        is rejected before restore chooses it (`keep`: see
        `verify_entries`)."""
        self.verify_entries(list(self.manifest["locations"]), keep)

    def verify_entries(self, names: List[str], keep: bool = False) -> None:
        """CRC-check a subset of pack entries.  The lazy restore
        pre-verifies only the critical set (plus ``__host__`` and
        ``__meta__``) before resuming the job; background entries keep
        the same guarantee because every chunk read re-checks its CRC.
        With `keep`, each v2 entry's verified bytes stay in this reader
        for the read that follows (a restore reads each byte from disk
        once); `close()` drops what no read took."""
        self._keeping = keep
        try:
            if self._io_threads > 1 and len(names) > 1:
                from concurrent.futures import ThreadPoolExecutor
                # a pool distinct from the chunk executor: entry tasks
                # block on chunk futures, so sharing one pool could
                # starve itself
                with ThreadPoolExecutor(
                        max_workers=min(4, self._io_threads)) as ex:
                    for _ in ex.map(self._verify_one, names):
                        pass
            else:
                for name in names:
                    self._verify_one(name)
        finally:
            self._keeping = False

    def io_stats(self) -> Dict[str, float]:
        out = {"read_s": 0.0, "decompress_s": 0.0, "read_bytes": 0.0}
        with self._packs_lock:
            packs = list(self._all_packs)
        for p in packs:
            for k, v in p.io_stats().items():
                out[k] = out.get(k, 0.0) + v
        return out

    def close(self):
        with self._packs_lock:
            for p in self._all_packs:
                p.close()
            self._all_packs.clear()
            self._shared_packs.clear()
            self._kept.clear()
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None


# ---------------------------------------------------------------- store
class SnapshotStore:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self.root = os.path.join(run_dir, "snapshots")
        # serializes gc against restore scans on this store (the async
        # writer thread gc's while restore() may be reading)
        self.lock = threading.RLock()
        # steps a lazy restore stream still reads from: gc keeps them (and
        # their parents) without blocking behind a long-running restore
        self._pins: Dict[int, int] = {}

    def pin(self, step: int) -> None:
        with self.lock:
            self._pins[step] = self._pins.get(step, 0) + 1

    def unpin(self, step: int) -> None:
        with self.lock:
            n = self._pins.get(step, 0) - 1
            if n <= 0:
                self._pins.pop(step, None)
            else:
                self._pins[step] = n

    def list_steps(self) -> List[int]:
        try:
            names = sorted(os.listdir(self.root))
        except FileNotFoundError:
            return []
        return sorted(int(d[5:]) for d in names
                      if d.startswith("step_") and os.path.exists(
                          os.path.join(self.root, d, MANIFEST)))

    def latest_step(self) -> Optional[int]:
        s = self.list_steps()
        return s[-1] if s else None

    def reader(self, step: Optional[int] = None, verify: bool = True,
               io_threads: int = 0) -> SnapshotReader:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no snapshots under {self.root}")
        return SnapshotReader(self.run_dir, step, verify=verify,
                              io_threads=io_threads)

    def manifest(self, step: int) -> Dict[str, Any]:
        return read_json(os.path.join(snapshot_dir(self.run_dir, step),
                                      MANIFEST))

    def referenced_steps(self, manifest: Dict[str, Any]) -> set:
        """Every step whose packs this image reads from."""
        refs = {_loc_step(loc) for loc in manifest["locations"].values()}
        refs.update(manifest.get("ref_steps", []))
        return refs

    def gc(self, keep: int = 3) -> List[int]:
        """Remove old snapshots, never breaking a parent chain that a kept
        image still reads from (entry- or chunk-level), and never a step
        a lazy restore has pinned.  The manifest is unlinked before the
        payload, so other readers see an image vanish whole rather than
        turn corrupt."""
        with self.lock:
            steps = self.list_steps()
            if len(steps) <= keep:
                return []
            keep_steps = set(steps[-keep:])
            keep_steps.update(s for s in self._pins if s in steps)
            changed = True
            while changed:
                changed = False
                for s in list(keep_steps):
                    try:
                        needed = self.referenced_steps(self.manifest(s))
                    except FileNotFoundError:          # pragma: no cover
                        continue
                    if not needed <= keep_steps:
                        keep_steps |= needed
                        changed = True
            removed = []
            for s in steps:
                if s not in keep_steps:
                    d = snapshot_dir(self.run_dir, s)
                    try:
                        os.remove(os.path.join(d, MANIFEST))
                    except OSError:
                        pass
                    shutil.rmtree(d, ignore_errors=True)
                    removed.append(s)
            return removed
