"""Integrity + atomic-commit primitives for snapshot files.

A snapshot is only valid once its MANIFEST.json exists; the manifest is
written to a temp file and ``os.rename``d into place (atomic on POSIX), so a
crash mid-checkpoint can never leave a manifest pointing at torn data —
the restore path simply falls back to the previous committed snapshot.
"""
from __future__ import annotations

import functools
import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Sequence

# chunks hashed at once by `crc32_many` (zlib releases the GIL while it
# hashes a buffer)
CRC_THREADS = max(1, min(4, os.cpu_count() or 1))


def crc32(data: bytes, value: int = 0) -> int:
    return zlib.crc32(data, value) & 0xFFFFFFFF


def crc32_many(parts: Sequence, threads: int = CRC_THREADS) -> List[int]:
    """The CRC-32 of each buffer of `parts`, hashed by up to `threads`
    threads."""
    if threads < 2 or len(parts) < 2:
        return [crc32(p) for p in parts]
    with ThreadPoolExecutor(max_workers=min(threads, len(parts))) as ex:
        return list(ex.map(crc32, parts))


def _gf2_times(mat: Sequence[int], vec: int) -> int:
    s, i = 0, 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_mul(a: Sequence[int], b: Sequence[int]) -> List[int]:
    return [_gf2_times(a, b[n]) for n in range(32)]


@functools.lru_cache(maxsize=8)
def _zeros_op(nbytes: int) -> tuple:
    """The GF(2) operator that carries a CRC-32 register over `nbytes`
    zero bytes (zlib's ``crc32_combine``)."""
    op = [0xEDB88320] + [1 << (n - 1) for n in range(1, 32)]  # one bit
    for _ in range(3):
        op = _gf2_mul(op, op)                                    # one byte
    out = [1 << n for n in range(32)]
    while nbytes:
        if nbytes & 1:
            out = _gf2_mul(op, out)
        op = _gf2_mul(op, op)
        nbytes >>= 1
    return tuple(out)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC-32 of A + B from crc32(A), crc32(B) and len(B), without reading
    either (the operator is cached per length: use it for a few lengths,
    such as a pack's chunk size)."""
    return _gf2_times(_zeros_op(len2), crc1) ^ crc2


def file_crc32(path: str, bufsize: int = 1 << 20) -> int:
    c = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(bufsize)
            if not b:
                break
            c = crc32(b, c)
    return c


def atomic_write_bytes(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def atomic_write_json(path: str, obj: Dict[str, Any]) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=1, sort_keys=True
                                        ).encode())


def read_json(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return json.load(f)
