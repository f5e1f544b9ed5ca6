"""Pack formats for snapshot payloads, byte-compatible with the JAX package.

v1 — single file:  [8-byte magic "RPRPACK1"][8-byte LE index offset]
[blob...][msgpack index].  The index maps entry name -> {offset, nbytes,
crc32, dtype, shape, codec, meta}.  Written by :class:`PackWriter` (the
serial-compat ``pack_format=1``), read by :class:`PackReader`.

v2 — chunked + striped:  an entry's raw bytes are split into fixed-size
chunks; each chunk carries its own CRC and codec and is appended to one of
N stripe files (``<base>.0 .. <base>.N-1``, round-robin).  Stripe 0's
footer holds the full logical index::

    {"format": 2, "stripes": N, "chunk_bytes": C,
     "entries": {name: {dtype, shape, meta, raw_nbytes, crc32,
                        chunks: [{stripe, offset, nbytes, raw_nbytes,
                                  crc32, raw_crc32, codec, ref?}, ...]}}}

A chunk with a ``ref`` lives in another image's pack (an incremental
image, or this pack's own earlier record after a concurrent capture's
patch); the reader follows it.  Given the same-named entry of a parent
pack, :class:`PackWriterV2` writes a chunk whose raw CRC matches the
parent's as a ``ref`` record and no bytes.  It runs a bounded pipeline
(caller thread chunks + hashes -> compress/CRC workers -> one appender
thread per stripe), so compression overlaps file I/O.  Each raw byte is
hashed once: the caller hashes a batch of chunks across threads and
combines the entry's CRC from theirs, and a chunk stored raw keeps its raw
CRC as its stored one.

The chunk is also the unit of cross-host transfer:
:meth:`PackReaderV2.own_chunks` lists the chunks a pack stores itself,
:meth:`PackReaderV2.read_stored_chunk` reads one as stored, and
:func:`write_pack_v2_from_chunks` rebuilds a stripe set byte for byte from
its footer and a chunk source.

Differences from the reference: indexes go through the port's own
``msgpack_lite`` (the same bytes); the codec is zlib only, and a
zstd-compressed image raises a clear error; bf16 arrays travel as their
``uint16`` bit pattern under the dtype name ``"bfloat16"`` — the name the
reference writes for ``ml_dtypes.bfloat16`` — so no ``ml_dtypes`` is needed.
"""
from __future__ import annotations

import os
import queue
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.chaos import hooks as chaos_hooks
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serialization import msgpack_lite
from repro_torch.serialization.integrity import (CRC_THREADS, crc32,
                                                crc32_combine, crc32_many)

MAGIC = b"RPRPACK1"
MAGIC2 = b"RPRPACK2"
DEFAULT_CHUNK_BYTES = 4 << 20
BF16 = "bfloat16"


# ----------------------------------------------------------------- dtypes
def dtype_to_str(dt) -> str:
    """numpy dtype -> image dtype string (``.str``, e.g. ``"<f4"``)."""
    dt = np.dtype(dt)
    return dt.name if dt.kind == "V" else dt.str


def dtype_from_str(s: str) -> np.dtype:
    """Image dtype string -> the numpy dtype its bytes are read as.
    ``"bfloat16"`` reads as its ``uint16`` bit pattern."""
    if s == BF16:
        return np.dtype(np.uint16)
    try:
        return np.dtype(s)
    except TypeError:
        raise ValueError(f"image dtype {s!r} is not supported by the port "
                         f"(bfloat16 and numpy dtypes are)") from None


def tensor_dtype_str(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return BF16
    return dtype_to_str(torch.empty((), dtype=t.dtype).numpy().dtype)


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor's storage as numpy (shared, not copied); bf16 as its
    uint16 bit pattern."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def numpy_to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """Inverse of :func:`host_numpy` (shares memory with `arr`).  A 0-d
    array stays 0-d (``ascontiguousarray`` alone returns it as (1,))."""
    shape = np.shape(arr)
    arr = np.ascontiguousarray(arr)
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).reshape(shape)
    return torch.from_numpy(arr).reshape(shape)


# ------------------------------------------------------------------ codec
def _compress_chunk(raw, level: int) -> Tuple[bytes, str]:
    return zlib.compress(raw, min(level, 9)), "zlib"


def _decompress_blob(raw: bytes, codec: str) -> bytes:
    if codec == "zlib":
        return zlib.decompress(raw)
    if codec == "raw":
        return raw
    raise IOError(f"codec {codec!r} is not supported by the port: write the "
                  f"image uncompressed or with zlib (the JAX package "
                  f"compresses with zstd when zstandard is installed)")


# ------------------------------------------------------------------ files
def stripe_path(base: str, stripe: int) -> str:
    return f"{base}.{stripe}"


def pack_exists(base: str) -> bool:
    return os.path.exists(base) or os.path.exists(stripe_path(base, 0))


def pack_files(base: str) -> List[str]:
    """Physical files of the pack at `base` (v1: one file; v2: stripes)."""
    if os.path.exists(base):
        return [base]
    out = []
    k = 0
    while os.path.exists(stripe_path(base, k)):
        out.append(stripe_path(base, k))
        k += 1
    if not out:
        raise FileNotFoundError(f"no pack at {base} (nor {base}.0)")
    return out


def _remove_stale_layout(base: str, stripes: int) -> None:
    """After committing a pack, remove files of the other layout (and
    surplus stripes) left by an earlier write of the same step: the
    existence-sniffing reader must never find a stale sibling.
    `stripes=0` means a v1 single-file pack was just committed."""
    if stripes > 0:
        try:
            os.remove(base)                          # stale v1 single file
        except OSError:
            pass
    k = stripes
    while True:
        try:
            os.remove(stripe_path(base, k))
        except OSError:
            return
        k += 1


class PackWriter:
    """v1 single-file serial writer (``pack_format=1``): byte-identical to
    the reference's writer for raw entries; compressed entries use zlib
    (the reference picks zstd when it is installed)."""

    def __init__(self, path: str, compress: bool = False, level: int = 3):
        self.path = path
        self.tmp = path + ".tmp"
        self._f = open(self.tmp, "wb")
        self._f.write(MAGIC)
        self._f.write(struct.pack("<Q", 0))          # index placeholder
        self._index: Dict[str, Dict[str, Any]] = {}
        self._compress = compress
        self._level = level
        self._closed = False
        self.compress_s = 0.0
        self.io_s = 0.0

    def _append(self, name: str, raw, dtype: Optional[str],
                shape: Optional[list], codec: str) -> None:
        if self._closed:
            raise RuntimeError(f"{self.path}: pack already closed")
        t0 = time.perf_counter()
        off = self._f.tell()
        self._f.write(raw)
        self.io_s += time.perf_counter() - t0
        self._index[name] = {
            "offset": off, "nbytes": len(raw), "crc32": crc32(raw),
            "dtype": dtype, "shape": shape, "codec": codec, "meta": {},
        }

    def add(self, name: str, array: np.ndarray,
            dtype: Optional[str] = None) -> None:
        """Append one array; `dtype` overrides the stored dtype name (a
        bf16 tensor arrives as uint16 bits with dtype ``"bfloat16"``)."""
        arr = np.asarray(array, order="C")   # (keeps a 0-d array 0-d)
        raw = arr.tobytes()
        codec = "raw"
        if self._compress:
            # the reference's zlib branch: v1 doubles the level (tuned for
            # ratio; the v2 pipeline maps it 1:1 for speed)
            t0 = time.perf_counter()
            comp = zlib.compress(raw, min(self._level * 2, 9))
            self.compress_s += time.perf_counter() - t0
            if len(comp) < len(raw) * 0.9:
                raw, codec = comp, "zlib"
        self._append(name, raw, dtype or dtype_to_str(arr.dtype),
                     list(arr.shape), codec)

    def add_bytes(self, name: str, raw: bytes) -> None:
        self._append(name, raw, None, None, "raw")

    def entry_crc(self, name: str) -> int:
        return self._index[name]["crc32"]

    def close(self) -> Dict[str, Any]:
        if self._closed:
            raise RuntimeError(f"{self.path}: pack already closed")
        idx = msgpack_lite.packb(self._index)
        idx_off = self._f.tell()
        self._f.write(idx)
        self._f.seek(len(MAGIC))
        self._f.write(struct.pack("<Q", idx_off))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.rename(self.tmp, self.path)
        _remove_stale_layout(self.path, 0)
        self._closed = True
        return self._index

    def abort(self) -> None:
        """Failed write: close and remove the temp file, commit nothing."""
        if self._closed:
            return
        self._closed = True
        self._f.close()
        try:
            os.remove(self.tmp)
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            if not self._closed:
                self.close()
        else:
            self.abort()


class PackReader:
    """v1 single-file reader (one OS file handle; not thread-safe)."""

    format = 1

    def __init__(self, path: str, verify: bool = True):
        self.path = path
        self._f = open(path, "rb")
        magic = self._f.read(8)
        if magic != MAGIC:
            self._f.close()
            raise ValueError(f"{path}: bad magic {magic!r}")
        (idx_off,) = struct.unpack("<Q", self._f.read(8))
        self._f.seek(idx_off)
        self.index: Dict[str, Dict[str, Any]] = msgpack_lite.unpackb(
            self._f.read())
        self._verify = verify

    def read_bytes(self, name: str) -> bytes:
        e = self.index[name]
        self._f.seek(e["offset"])
        raw = self._f.read(e["nbytes"])
        if self._verify and crc32(raw) != e["crc32"]:
            raise IOError(f"{self.path}:{name}: CRC mismatch (torn write?)")
        return _decompress_blob(raw, e["codec"])

    def read_array(self, name: str) -> np.ndarray:
        e = self.index[name]
        return np.frombuffer(self.read_bytes(name),
                             dtype=dtype_from_str(e["dtype"])
                             ).reshape(e["shape"]).copy()

    def io_stats(self) -> Dict[str, float]:
        return {}

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ------------------------------------------------------------------ v2
_DONE = object()          # queue sentinel


class PackWriterV2:
    """Chunked, striped, pipelined pack writer.

    The caller thread (``add``/``add_bytes``) slices entries into chunks,
    CRCs the raw bytes, and feeds a bounded queue.  `workers` compress+CRC
    threads drain it and route finished chunks to per-stripe appender
    threads.  ``close()`` drains the pipeline, writes the logical index
    into stripe 0's footer, fsyncs, and renames every stripe into place,
    stripe 0 last (a crash mid-write leaves only ``*.tmp`` litter).
    """

    def __init__(self, base_path: str, compress: bool = False,
                 level: int = 4, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 stripes: int = 2, workers: int = 2):
        if chunk_bytes < 1:
            raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
        if stripes < 1:
            raise ValueError(f"stripes must be >= 1, got {stripes}")
        self.base = base_path
        self.chunk_bytes = chunk_bytes
        self.stripes = stripes
        self._compress = compress
        self._level = level
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._closed = False
        self._errors: List[BaseException] = []
        self._rr = 0                                  # round-robin stripe
        self.reused_chunk_bytes = 0
        self.ref_locs: set = set()
        self.compress_s = 0.0
        self.io_s = 0.0
        self.hash_s = 0.0                # caller-thread raw-byte CRCs
        self.stripe_bytes = [0] * stripes
        self._stats_lock = threading.Lock()
        # per-entry raw chunk CRCs, kept out of the records (the footer
        # serializes _entries verbatim); the concurrent-capture validate
        # pass re-hashes live bytes against these
        self._raw_crcs: Dict[str, List[int]] = {}
        self.superseded_bytes = 0        # dead bytes left by replace()
        self._outstanding = 0            # chunks still in the pipeline
        self._flush_cv = threading.Condition()

        workers = max(1, workers)
        self._comp_q: "queue.Queue" = queue.Queue(maxsize=workers * 4)
        self._stripe_qs: List["queue.Queue"] = [
            queue.Queue(maxsize=4) for _ in range(stripes)]
        self._files = [open(stripe_path(base_path, k) + ".tmp", "wb")
                       for k in range(stripes)]
        for f in self._files:
            f.write(MAGIC2)
            f.write(struct.pack("<Q", 0))            # index placeholder
        self._obs_ctx = obs_trace.current_context()
        self._comp_threads = [
            threading.Thread(target=self._compress_loop, daemon=True,
                             name=f"repro-pack-compress-{i}")
            for i in range(workers)]
        self._stripe_threads = [
            threading.Thread(target=self._stripe_loop, args=(k,),
                             daemon=True, name=f"repro-pack-stripe-{k}")
            for k in range(stripes)]
        for t in self._comp_threads + self._stripe_threads:
            t.start()

    # ----------------------------------------------------------- pipeline
    def _put(self, q: "queue.Queue", item) -> None:
        """Bounded put that aborts instead of deadlocking if a downstream
        thread has died with an error."""
        while True:
            if self._errors:
                raise self._errors[0]
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _compress_one(self, part) -> Tuple[Any, str]:
        data, codec = part, "raw"
        if self._compress:
            t0 = time.perf_counter()
            comp, cname = _compress_chunk(part, self._level)
            if len(comp) < len(part) * 0.9:
                data, codec = comp, cname
            with self._stats_lock:
                self.compress_s += time.perf_counter() - t0
        return data, codec

    def _compress_loop(self) -> None:
        try:
            with obs_trace.context(**self._obs_ctx):
                while True:
                    item = self._comp_q.get()
                    if item is _DONE:
                        return
                    rec, j, part, stripe, rcrc = item
                    if self._errors:
                        self._chunk_done()
                        continue                       # drain without work
                    data, codec = self._compress_one(part)
                    # a raw chunk is stored as it is: its stored CRC is
                    # its raw one
                    scrc = rcrc if codec == "raw" else crc32(data)
                    self._put(self._stripe_qs[stripe],
                              (rec, j, data, len(part), scrc, rcrc, codec))
        except BaseException as e:                     # pragma: no cover
            self._errors.append(e)

    def _stripe_loop(self, k: int) -> None:
        try:
            with obs_trace.context(**self._obs_ctx):
                f = self._files[k]
                while True:
                    item = self._stripe_qs[k].get()
                    if item is _DONE:
                        return
                    rec, j, data, raw_n, scrc, rcrc, codec = item
                    if self._errors:
                        self._chunk_done()
                        continue
                    t0 = time.perf_counter()
                    off = f.tell()
                    f.write(data)
                    if chaos_hooks.INJECTOR is not None:
                        # chaos: torn-write site (the handler must restore
                        # the file position)
                        chaos_hooks.fire("pack.chunk", file=f, offset=off,
                                         data=data, dtype=rec["dtype"],
                                         stripe=k, base=self.base)
                    with self._stats_lock:
                        self.io_s += time.perf_counter() - t0
                        self.stripe_bytes[k] += len(data)
                    rec["chunks"][j] = {
                        "stripe": k, "offset": off, "nbytes": len(data),
                        "raw_nbytes": raw_n, "crc32": scrc,
                        "raw_crc32": rcrc, "codec": codec,
                    }
                    obs_metrics.counter_add("pack.chunks")
                    self._chunk_done()
        except BaseException as e:                     # pragma: no cover
            self._errors.append(e)

    def _chunk_done(self) -> None:
        with self._flush_cv:
            self._outstanding -= 1
            self._flush_cv.notify_all()

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every enqueued chunk has landed in its stripe file
        (records fully populated) without closing the pack: the
        concurrent-capture validate pass needs the speculated chunk
        records while the stripe set stays open for re-capture."""
        deadline = (time.perf_counter() + timeout) if timeout else None
        with obs_trace.span("pack.flush", outstanding=self._outstanding), \
                self._flush_cv:
            while self._outstanding > 0 and not self._errors:
                if deadline is not None and time.perf_counter() > deadline:
                    raise TimeoutError(
                        f"{self.base}: flush timed out with "
                        f"{self._outstanding} chunk(s) still in flight")
                self._flush_cv.wait(timeout=0.1)
        if self._errors:
            raise self._errors[0]

    # ---------------------------------------------------------------- add
    def _add_blob(self, name: str, raw, dtype: Optional[str],
                  shape: Optional[list],
                  parent: Optional[Tuple[Dict[str, Any], str]] = None,
                  chunk_crcs: Optional[List[int]] = None) -> None:
        """`parent` = (the same-named entry's record in a parent pack, that
        pack's location "step_XXXXXXXX/hostYYYY.pack"), offered only when
        the parent is v2 with the same chunk size: a chunk whose raw CRC
        and size match the parent's becomes a ``ref`` record and no bytes
        are written for it."""
        if self._closed:
            raise RuntimeError(f"{self.base}: pack already closed")
        if self._errors:
            raise self._errors[0]
        mv = memoryview(raw).cast("B")
        n = len(mv)
        C = self.chunk_bytes
        nchunks = (n + C - 1) // C
        rec: Dict[str, Any] = {
            "dtype": dtype, "shape": shape, "meta": {},
            "raw_nbytes": n, "crc32": 0, "chunks": [None] * nchunks,
        }
        self._entries[name] = rec
        prev_chunks = parent[0]["chunks"] if parent else []
        running = 0
        raw_crcs: List[int] = []
        hash_s = 0.0
        batch = 4 * CRC_THREADS
        for j in range(nchunks):
            part = mv[j * C:(j + 1) * C]
            if j % batch == 0:
                # one pass over the bytes: the next `batch` chunks hashed
                # across threads, the entry's CRC combined from theirs
                t0 = time.perf_counter()
                crcs = (chunk_crcs[j:j + batch] if chunk_crcs else
                        crc32_many([mv[k * C:(k + 1) * C] for k in
                                    range(j, min(j + batch, nchunks))]))
                hash_s += time.perf_counter() - t0
            rcrc = crcs[j % batch]
            t0 = time.perf_counter()
            running = (crc32_combine(running, rcrc, C) if len(part) == C
                       else crc32(part, running))
            hash_s += time.perf_counter() - t0
            raw_crcs.append(rcrc)
            p = prev_chunks[j] if j < len(prev_chunks) else None
            if (p is not None and p.get("raw_crc32") == rcrc
                    and p["raw_nbytes"] == len(part)):
                c = dict(p)                           # chunk-level dedup
                c.setdefault("ref", parent[1])
                rec["chunks"][j] = c
                self.reused_chunk_bytes += len(part)
                self.ref_locs.add(c["ref"])
                continue
            stripe = self._rr
            self._rr = (self._rr + 1) % self.stripes
            with self._flush_cv:
                self._outstanding += 1
            self._put(self._comp_q, (rec, j, part, stripe, rcrc))
        rec["crc32"] = running            # == crc32 of the full raw bytes
        self._raw_crcs[name] = raw_crcs
        self.hash_s += hash_s

    @staticmethod
    def _flat(array: np.ndarray):
        arr = np.asarray(array, order="C")   # (keeps a 0-d array 0-d)
        return arr, (arr.reshape(-1).view(np.uint8) if arr.size else b"")

    def add(self, name: str, array: np.ndarray,
            dtype: Optional[str] = None,
            parent: Optional[Tuple[Dict[str, Any], str]] = None,
            chunk_crcs: Optional[List[int]] = None) -> None:
        """Append one array; `dtype` overrides the stored dtype name (a
        bf16 tensor arrives as uint16 bits with dtype ``"bfloat16"``).
        `parent` enables chunk-level dedup (see ``_add_blob``);
        `chunk_crcs` lets a caller that already hashed the chunks skip
        the second CRC pass.  The array's buffer is read by the pipeline
        threads until ``close()``: the caller must not change it before
        then."""
        arr, flat = self._flat(array)
        self._add_blob(name, flat, dtype or dtype_to_str(arr.dtype),
                       list(arr.shape), parent, chunk_crcs)

    def add_bytes(self, name: str, raw: bytes) -> None:
        self._add_blob(name, raw, None, None)

    def entry_crc(self, name: str) -> int:
        return self._entries[name]["crc32"]

    def raw_crcs(self, name: str) -> List[int]:
        """Per-chunk raw-byte CRCs of an entry as written — the content
        hashes the validate pass compares live bytes against."""
        return list(self._raw_crcs[name])

    def replace(self, name: str, array: np.ndarray,
                dtype: Optional[str] = None,
                own_loc: Optional[str] = None,
                chunk_crcs: Optional[List[int]] = None) -> None:
        """Re-capture an entry into the open stripe set (concurrent
        capture's patch phase).  The old record becomes the dedup parent
        of the new one, so chunks the mutation did not touch stay as
        references to the bytes already on disk (``own_loc`` is this
        pack's own location) and only invalidated chunks are appended.
        Call ``flush()`` first.  Superseded chunks stay in the stripe
        files as dead bytes (``superseded_bytes``)."""
        if self._closed:
            raise RuntimeError(f"{self.base}: pack already closed")
        old = self._entries.get(name)
        if old is None:
            raise KeyError(f"replace of unknown entry {name!r}")
        if any(c is None for c in old["chunks"]):
            raise RuntimeError(
                f"replace({name!r}) before flush(): speculated chunks "
                f"still in flight")
        arr, flat = self._flat(array)
        n = len(memoryview(flat).cast("B"))
        C = self.chunk_bytes
        if chunk_crcs is None:
            mv = memoryview(flat).cast("B")
            chunk_crcs = crc32_many([mv[o:o + C] for o in range(0, n, C)])
        # dead bytes = chunks written into this pack whose content no
        # longer matches (self-referenced unchanged chunks stay live)
        with self._stats_lock:
            self.superseded_bytes += sum(
                c["nbytes"] for j, c in enumerate(old["chunks"])
                if "ref" not in c
                and (j >= len(chunk_crcs)
                     or chunk_crcs[j] != c.get("raw_crc32")
                     or c["raw_nbytes"] != min(C, n - j * C)))
        self._add_blob(name, flat, dtype or dtype_to_str(arr.dtype),
                       list(arr.shape), (old, own_loc) if own_loc else None,
                       chunk_crcs)

    # -------------------------------------------------------------- close
    def _post_done(self, q: "queue.Queue") -> None:
        """Deliver a sentinel even if the consumer died with the queue
        full (blocking put() would deadlock close()/abort())."""
        while True:
            try:
                q.put(_DONE, timeout=0.1)
                return
            except queue.Full:
                if self._errors:
                    try:
                        q.get_nowait()           # make room ourselves
                    except queue.Empty:
                        pass

    def _drain(self) -> None:
        for _ in self._comp_threads:
            self._post_done(self._comp_q)
        for t in self._comp_threads:
            t.join()
        for q in self._stripe_qs:
            self._post_done(q)
        for t in self._stripe_threads:
            t.join()

    def close(self) -> Dict[str, Any]:
        if self._closed:
            raise RuntimeError(f"{self.base}: pack already closed")
        self._drain()
        if self._errors:
            self._abort_files()
            raise self._errors[0]
        for rec in self._entries.values():
            if any(c is None for c in rec["chunks"]):   # pragma: no cover
                self._abort_files()
                raise IOError(f"{self.base}: pipeline lost a chunk")
        footer0 = {"format": 2, "stripes": self.stripes,
                   "chunk_bytes": self.chunk_bytes,
                   "entries": self._entries}
        for k, f in enumerate(self._files):
            idx = msgpack_lite.packb(
                footer0 if k == 0 else {"format": 2, "stripe": k})
            idx_off = f.tell()
            f.write(idx)
            f.seek(len(MAGIC2))
            f.write(struct.pack("<Q", idx_off))
            f.flush()
            os.fsync(f.fileno())
            f.close()
        # stripe 0 (holding the index) renamed last: readers only see a
        # complete stripe set once the index is durable
        for k in range(self.stripes - 1, -1, -1):
            p = stripe_path(self.base, k)
            os.rename(p + ".tmp", p)
        _remove_stale_layout(self.base, self.stripes)
        self._closed = True
        return self._entries

    def _abort_files(self) -> None:
        self._closed = True
        for f in self._files:
            f.close()
        for k in range(self.stripes):
            try:
                os.remove(stripe_path(self.base, k) + ".tmp")
            except OSError:
                pass

    def abort(self) -> None:
        if self._closed:
            return
        self._errors.append(RuntimeError("aborted"))
        try:
            self._drain()
        finally:
            self._errors.clear()
            self._abort_files()


class PackReaderV2:
    """Chunked/striped pack reader with parallel chunk placement.

    Thread-safe: every thread gets its own file handle per stripe.  With
    an `executor`, the chunks of one entry are read + CRC'd + decoded in
    parallel, each landing in its slice of one preallocated buffer.
    """

    format = 2

    def __init__(self, base: str, verify: bool = True, executor=None):
        self.base = base
        # refs point at packs of other steps, relative to snapshots/
        self.root = os.path.dirname(os.path.dirname(os.path.abspath(base)))
        self._verify = verify
        self._executor = executor
        self._tls = threading.local()
        self._all_handles: List[Any] = []
        self._handles_lock = threading.Lock()
        self._stats = {"read_s": 0.0, "decompress_s": 0.0,
                       "read_bytes": 0.0}
        with open(stripe_path(base, 0), "rb") as f:
            magic = f.read(8)
            if magic != MAGIC2:
                raise ValueError(f"{base}.0: bad magic {magic!r}")
            (idx_off,) = struct.unpack("<Q", f.read(8))
            f.seek(idx_off)
            footer = msgpack_lite.unpackb(f.read())
        self.index: Dict[str, Dict[str, Any]] = footer["entries"]
        self.stripes: int = footer["stripes"]
        self.chunk_bytes: int = footer["chunk_bytes"]

    def entry(self, name: str) -> Dict[str, Any]:
        return self.index[name]

    def entry_nbytes(self, name: str) -> int:
        """Raw (decoded) payload size of one entry."""
        return int(self.index[name]["raw_nbytes"])

    def _chunk_file(self, c: Dict[str, Any]) -> str:
        ref = c.get("ref")
        if ref:
            return stripe_path(os.path.join(self.root, ref), c["stripe"])
        return stripe_path(self.base, c["stripe"])

    def _handle(self, path: str):
        handles = getattr(self._tls, "handles", None)
        if handles is None:
            handles = self._tls.handles = {}
        f = handles.get(path)
        if f is None:
            f = handles[path] = open(path, "rb")
            with self._handles_lock:
                self._all_handles.append(f)
        return f

    def _read_stored(self, name: str, c: Dict[str, Any],
                     verify: Optional[bool] = None) -> bytes:
        """One chunk's stored bytes, length-checked, and CRC-checked
        unless `verify` (default: the reader's setting) is False."""
        path = self._chunk_file(c)
        t0 = time.perf_counter()
        try:
            f = self._handle(path)
        except FileNotFoundError:
            raise IOError(
                f"{self.base}:{name}: chunk file missing ({path}) — "
                f"referenced pack was deleted (broken incremental chain?)")
        f.seek(c["offset"])
        data = f.read(c["nbytes"])
        with self._handles_lock:
            self._stats["read_s"] += time.perf_counter() - t0
            self._stats["read_bytes"] += c["nbytes"]
        if len(data) != c["nbytes"]:
            raise IOError(
                f"{path}:{name}: chunk truncated at offset {c['offset']} "
                f"(got {len(data)} of {c['nbytes']} bytes)")
        if (self._verify if verify is None else verify) \
                and crc32(data) != c["crc32"]:
            raise IOError(
                f"{path}:{name}: chunk CRC mismatch at offset "
                f"{c['offset']} (torn write?)")
        return data

    def _read_chunk_into(self, name: str, c: Dict[str, Any],
                         out: np.ndarray, raw_off: int,
                         verify: Optional[bool] = None) -> None:
        data = self._read_stored(name, c, verify)
        t1 = time.perf_counter()
        if c["codec"] != "raw":
            data = _decompress_blob(data, c["codec"])
        with self._handles_lock:
            self._stats["decompress_s"] += time.perf_counter() - t1
        if len(data) != c["raw_nbytes"]:
            raise IOError(f"{self.base}:{name}: chunk decoded to "
                          f"{len(data)} bytes, expected {c['raw_nbytes']}")
        out[raw_off:raw_off + len(data)] = np.frombuffer(data, np.uint8)

    def _for_chunks(self, fn, name: str, chunks, *args) -> None:
        if self._executor is not None and len(chunks) > 1:
            futs = [self._executor.submit(fn, name, c, *a)
                    for c, *a in zip(chunks, *args)]
            for fu in futs:
                fu.result()
        else:
            for c, *a in zip(chunks, *args):
                fn(name, c, *a)

    def _read_raw(self, name: str, verify: Optional[bool] = None
                  ) -> np.ndarray:
        rec = self.index[name]
        out = np.empty(rec["raw_nbytes"], np.uint8)
        offs = np.cumsum([0] + [c["raw_nbytes"] for c in rec["chunks"]])
        if offs[-1] != rec["raw_nbytes"]:
            raise IOError(f"{self.base}:{name}: chunk sizes sum to "
                          f"{offs[-1]}, index says {rec['raw_nbytes']}")
        self._for_chunks(self._read_chunk_into, name, rec["chunks"],
                         [out] * len(rec["chunks"]),
                         [int(o) for o in offs[:-1]],
                         [verify] * len(rec["chunks"]))
        return out

    def read_bytes(self, name: str) -> bytes:
        return self._read_raw(name).tobytes()

    def read_array(self, name: str) -> np.ndarray:
        return self.array_of(name, self._read_raw(name))

    def read_raw_verified(self, name: str) -> np.ndarray:
        """One entry's raw bytes with every stored chunk CRC-checked,
        whatever the reader's own setting: a verify pass that keeps what
        it read (`array_of` views it as the entry's array)."""
        return self._read_raw(name, verify=True)

    def array_of(self, name: str, raw: np.ndarray) -> np.ndarray:
        rec = self.index[name]
        return raw.view(dtype_from_str(rec["dtype"])).reshape(rec["shape"])

    def read_stored_chunk(self, c: Dict[str, Any]) -> bytes:
        """The stored (possibly compressed) bytes of one chunk record, the
        unit of cross-host transfer, CRC-checked so a torn stripe never
        ships."""
        return self._read_stored("<chunk>", c, verify=True)

    def own_chunks(self) -> List[Tuple[str, int, Dict[str, Any]]]:
        """(entry, chunk index, record) for every chunk stored in THIS
        pack's stripes (``ref`` chunks live in another pack and are that
        pack's to export)."""
        return [(name, j, c) for name, rec in self.index.items()
                for j, c in enumerate(rec["chunks"]) if not c.get("ref")]

    def verify_entry(self, name: str) -> None:
        """Integrity-check one entry without decoding it (chunk CRCs
        cover the stored bytes)."""
        self._for_chunks(self._read_stored, name,
                         self.index[name]["chunks"])

    def io_stats(self) -> Dict[str, float]:
        with self._handles_lock:
            return dict(self._stats)

    def close(self):
        with self._handles_lock:
            for f in self._all_handles:
                f.close()
            self._all_handles.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_pack(base: str, verify: bool = True, executor=None):
    """Open the pack at `base`, sniffing v1 (single file) vs v2 (stripe
    set)."""
    if os.path.exists(base):
        return PackReader(base, verify=verify)
    if os.path.exists(stripe_path(base, 0)):
        return PackReaderV2(base, verify=verify, executor=executor)
    raise FileNotFoundError(f"no pack at {base} (nor {base}.0)")


# ------------------------------------------------------------ v2 assembly
HEADER_BYTES = len(MAGIC2) + 8        # magic + index-offset placeholder


def write_pack_v2_from_chunks(base: str, footer: Dict[str, Any],
                              fetch) -> None:
    """Re-materialize a v2 pack from its logical index plus a chunk
    source: the receive side of a cross-host transfer.

    `footer` is the stripe-0 footer of the source pack (``entries`` with
    every chunk's stripe/offset/nbytes/crc32); ``fetch(chunk_record)``
    returns that chunk's stored bytes.  Stripes are rebuilt byte for byte
    at the recorded offsets, so children whose ``ref`` chunks point into
    this pack keep resolving and every CRC in the index stays valid.
    Stripe 0's footer is re-encoded from `footer` (``msgpack_lite``
    round-trips every footer either package writes byte for byte).  As
    in :class:`PackWriterV2`, every stripe is written to ``*.tmp`` and
    fsynced, and stripe 0 (the index) is renamed last.
    """
    stripes = footer["stripes"]
    per_stripe: List[List[Dict[str, Any]]] = [[] for _ in range(stripes)]
    for rec in footer["entries"].values():
        for c in rec["chunks"]:
            if not c.get("ref"):
                per_stripe[c["stripe"]].append(c)
    files = []
    try:
        for k in range(stripes):
            f = open(stripe_path(base, k) + ".tmp", "wb")
            files.append(f)
            f.write(MAGIC2)
            f.write(struct.pack("<Q", 0))
            pos = HEADER_BYTES
            for c in sorted(per_stripe[k], key=lambda c: c["offset"]):
                if c["offset"] != pos:
                    raise IOError(
                        f"{base}.{k}: non-contiguous chunk layout "
                        f"(offset {c['offset']}, expected {pos}): the "
                        f"source index is corrupt")
                data = fetch(c)
                if len(data) != c["nbytes"] or crc32(data) != c["crc32"]:
                    raise IOError(
                        f"{base}.{k}: fetched chunk does not match the "
                        f"index at offset {c['offset']} (corrupt source "
                        f"or chunk store)")
                f.write(data)
                pos += c["nbytes"]
            f.write(msgpack_lite.packb(
                footer if k == 0 else {"format": 2, "stripe": k}))
            f.seek(len(MAGIC2))
            f.write(struct.pack("<Q", pos))
            f.flush()
            os.fsync(f.fileno())
            f.close()
    except BaseException:
        for f in files:
            f.close()
        for k in range(stripes):
            try:
                os.remove(stripe_path(base, k) + ".tmp")
            except OSError:
                pass
        raise
    for k in range(stripes - 1, -1, -1):
        p = stripe_path(base, k)
        os.rename(p + ".tmp", p)
    _remove_stale_layout(base, stripes)
