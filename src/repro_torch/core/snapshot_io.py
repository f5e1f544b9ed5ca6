"""Snapshot store: on-disk layout, writer, reader — the reference's layout.

Layout:
  run_dir/snapshots/step_00000123/
    MANIFEST.json         — committed last (atomic rename) = the image is valid
    host0000.pack.0..N-1  — this host's payloads, striped (pack v2)
    host0000.pack         — legacy v1 single-file layout (read only)

The writer is the serialization stage of the pipelined data plane: entries
are chunked and handed to ``serialization.pack.PackWriterV2``, whose
compress workers and per-stripe appenders overlap CRC/compression with
file I/O.  The reader follows the manifest's ``locations`` (so incremental
images the JAX package wrote, whose entries live in earlier steps' packs,
restore too) and fans chunk reads out to ``io_threads``.

Host blobs (``__meta__``, ``__host__``) are msgpack with numpy arrays as
``{"__np__": True, "dtype", "shape", "data"}`` maps — the reference's
``_mp_default`` encoding — through the port's ``msgpack_lite``.

Not ported yet: incremental writes (chunk dedup against a parent image),
the concurrent-capture patch path, and the lazy-restore schedule.
"""
from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.chaos import hooks as chaos_hooks
from repro_torch.obs import trace as obs_trace
from repro_torch.serialization import msgpack_lite
from repro_torch.serialization.integrity import atomic_write_json, read_json
from repro_torch.serialization.pack import (DEFAULT_CHUNK_BYTES, PackWriterV2,
                                            open_pack)

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


def _loc_step(loc: str) -> int:
    """'step_00000042/host0000.pack' -> 42."""
    return int(loc.split("/")[0][5:])


# ---------------------------------------------------------------- writer
class SnapshotWriter:
    def __init__(self, run_dir: str, step: int, host_id: int = 0,
                 compress: bool = False,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 stripes: int = 2, io_threads: int = 0):
        self.run_dir = run_dir
        self.step = step
        self.dir = snapshot_dir(run_dir, step)
        os.makedirs(self.dir, exist_ok=True)
        self.pack_name = f"host{host_id:04d}.pack"
        self._loc = os.path.join(f"step_{step:08d}", self.pack_name)
        self._writer = PackWriterV2(os.path.join(self.dir, self.pack_name),
                                    compress=compress,
                                    chunk_bytes=chunk_bytes, stripes=stripes,
                                    workers=io_threads or auto_io_threads())
        self.files = [f"{self.pack_name}.{k}" for k in range(stripes)]
        self.chunk_bytes = chunk_bytes
        self.stripes = stripes
        self.locations: Dict[str, str] = {}
        self.meta: Dict[str, Any] = {}
        self.entry_crcs: Dict[str, int] = {}
        self.written_bytes = 0
        # restore-priority hint: entry names in registration order, with
        # per-entry raw sizes (read by the reference's lazy restore)
        self.restore_order: List[str] = []
        self.entry_bytes: Dict[str, int] = {}

    def _put(self, name: str, data: np.ndarray, dtype: str) -> None:
        self._writer.add(name, data, dtype=dtype)
        self.restore_order.append(name)
        self.entry_bytes[name] = int(data.nbytes)
        self.entry_crcs[name] = self._writer.entry_crc(name)
        self.locations[name] = self._loc
        self.written_bytes += data.nbytes

    def put_state_entry(self, state: str, path: str,
                        e: Dict[str, Any]) -> None:
        meta = self.meta.setdefault(state, {})
        if e["kind"] == "device_array":
            meta[path] = {
                "kind": "device_array", "shape": e["shape"],
                "dtype": e["dtype"], "sharding": e["sharding"],
                "shards": [s["index"] for s in e["shards"]],
            }
            for i, s in enumerate(e["shards"]):
                self._put(f"{state}::{path}::s{i}", s["data"], e["dtype"])
        elif e["kind"] == "np":
            meta[path] = {"kind": "np"}
            self._put(f"{state}::{path}::np", e["data"], None)
        else:
            meta[path] = {"kind": "host", "value": e["value"]}

    def write_states(self, device_snapshot: Dict[str, Dict[str, Any]]) -> None:
        """device_snapshot: state_name -> {leafpath -> captured entry}."""
        for state, entries in device_snapshot.items():
            self.meta.setdefault(state, {})
            for path, e in entries.items():
                self.put_state_entry(state, path, e)

    def write_host_state(self, host_state: Dict[str, Any]) -> None:
        blob = pack_host_blob(host_state)
        self._writer.add_bytes("__host__", blob)
        self.locations["__host__"] = self._loc
        self.restore_order.append("__host__")
        self.entry_bytes["__host__"] = len(blob)

    def commit(self, topology: Dict[str, Any],
               stats: Optional[Dict[str, Any]] = None,
               extra: Optional[Dict[str, Any]] = None) -> str:
        with obs_trace.span("dump.commit", step=self.step):
            self._writer.add_bytes("__meta__", pack_host_blob(self.meta))
            self.locations["__meta__"] = self._loc
            self._writer.close()
            manifest = {
                "format": 2,
                "step": self.step,
                "timestamp": time.time(),
                "topology": topology,
                "has_device_state": True,      # inventory flag (paper §3.1.1)
                "states": sorted(self.meta),
                "parent": None,
                "locations": self.locations,
                "entry_crcs": self.entry_crcs,
                "files": self.files,
                "stats": dict(stats or {}),
                "reused_bytes": 0,
                "written_bytes": self.written_bytes,
                "ref_steps": [self.step],
                "restore_order": self.restore_order,
                "entry_bytes": self.entry_bytes,
                "chunk_bytes": self.chunk_bytes,
                "stripes": self.stripes,
            }
            if extra:
                manifest.update(extra)
            if chaos_hooks.INJECTOR is not None:
                # chaos: commit-kill site — payload in place, no manifest yet
                chaos_hooks.fire("snapshot.pre_manifest", step=self.step,
                                 path=self.dir)
            atomic_write_json(os.path.join(self.dir, MANIFEST), manifest)
        return self.dir

    # ------------------------------------------------------ pipeline stats
    @property
    def compress_s(self) -> float:
        return self._writer.compress_s

    @property
    def io_s(self) -> float:
        return self._writer.io_s

    def abort(self) -> None:
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

    def _read(self, name: str) -> bytes:
        loc = self.manifest["locations"][name]
        return self._pack_for(loc).read_bytes(name)

    def _read_array(self, name: str) -> np.ndarray:
        loc = self.manifest["locations"][name]
        return self._pack_for(loc).read_array(name)

    def state_names(self) -> List[str]:
        return list(self.manifest["states"])

    def entry_names(self, state: str) -> List[str]:
        return list(self.meta[state])

    def load_entry(self, state: str, path: str) -> Dict[str, Any]:
        m = self.meta[state][path]
        if m["kind"] == "device_array":
            shards = [{"index": idx,
                       "data": self._read_array(f"{state}::{path}::s{i}")}
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
        if pack.format == 2:
            pack.verify_entry(name)       # v2: CRC stored chunks, no decode
        else:
            pack.read_bytes(name)         # v1: CRC implies full decode

    def verify_all(self) -> None:
        """CRC-check every entry the manifest references, so a torn image
        is rejected before restore chooses it."""
        names = list(self.manifest["locations"])
        if self._io_threads > 1 and len(names) > 1:
            from concurrent.futures import ThreadPoolExecutor
            # a pool distinct from the chunk executor: entry tasks block on
            # chunk futures, so sharing one pool could starve itself
            with ThreadPoolExecutor(
                    max_workers=min(4, self._io_threads)) as ex:
                for _ in ex.map(self._verify_one, names):
                    pass
        else:
            for name in names:
                self._verify_one(name)

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
        image (a JAX-written incremental one) still reads from.  The
        manifest is unlinked before the payload, so other readers see an
        image vanish whole rather than turn corrupt."""
        with self.lock:
            steps = self.list_steps()
            if len(steps) <= keep:
                return []
            keep_steps = set(steps[-keep:])
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
