"""Integrity + atomic-commit primitives for snapshot files.

A snapshot is only valid once its MANIFEST.json exists; the manifest is
written to a temp file and ``os.rename``d into place (atomic on POSIX), so a
crash mid-checkpoint can never leave a manifest pointing at torn data —
the restore path simply falls back to the previous committed snapshot.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict


def crc32(data: bytes, value: int = 0) -> int:
    return zlib.crc32(data, value) & 0xFFFFFFFF


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
