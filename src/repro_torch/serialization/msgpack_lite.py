"""The msgpack subset snapshot images use, with no third-party package.

Covers nil, bool, int (up to 64 bits), float64, str, bin, array and map.
``packb`` produces the bytes ``msgpack.packb(obj, use_bin_type=True)``
produces (smallest encoding of each int, str8 allowed, floats always
float64, tuples as arrays, maps in insertion order); ``unpackb`` reads
them back like ``msgpack.unpackb(raw, raw=False, strict_map_key=False)``.
Both take the hooks of the reference's host-blob codec (``default`` /
``object_hook``).  Ext types, float32 and timestamps are not used by
images and raise.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, Optional


def packb(obj: Any, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    out = bytearray()
    _pack(obj, out, default)
    return bytes(out)


def _pack(obj: Any, out: bytearray, default) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 0x100:
            out += bytes((0xD9, n))
        elif n < 0x10000:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        n = len(b)
        if n < 0x100:
            out += bytes((0xC4, n))
        elif n < 0x10000:
            out += b"\xc5" + struct.pack(">H", n)
        else:
            out += b"\xc6" + struct.pack(">I", n)
        out += b
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 0x10000:
            out += b"\xdc" + struct.pack(">H", n)
        else:
            out += b"\xdd" + struct.pack(">I", n)
        for item in obj:
            _pack(item, out, default)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 0x10000:
            out += b"\xde" + struct.pack(">H", n)
        else:
            out += b"\xdf" + struct.pack(">I", n)
        for k, v in obj.items():
            _pack(k, out, default)
            _pack(v, out, default)
    elif default is not None:
        _pack(default(obj), out, None)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 0x100:
            out += bytes((0xCC, v))
        elif v < 0x10000:
            out += b"\xcd" + struct.pack(">H", v)
        elif v < 0x100000000:
            out += b"\xce" + struct.pack(">I", v)
        elif v < 0x10000000000000000:
            out += b"\xcf" + struct.pack(">Q", v)
        else:
            raise OverflowError(f"int {v} does not fit in 64 bits")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -0x80:
        out += b"\xd0" + struct.pack(">b", v)
    elif v >= -0x8000:
        out += b"\xd1" + struct.pack(">h", v)
    elif v >= -0x80000000:
        out += b"\xd2" + struct.pack(">i", v)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"int {v} does not fit in 64 bits")


def unpackb(raw: bytes,
            object_hook: Optional[Callable[[dict], Any]] = None) -> Any:
    mv = memoryview(raw)
    obj, pos = _unpack(mv, 0, object_hook)
    if pos != len(mv):
        raise ValueError(f"msgpack: {len(mv) - pos} extra bytes after the "
                         f"object")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
          0xCA: ">f", 0xCB: ">d"}


def _take(mv: memoryview, pos: int, n: int):
    end = pos + n
    if end > len(mv):
        raise ValueError("msgpack: data truncated")
    return mv[pos:end], end


def _unpack(mv: memoryview, pos: int, hook):
    if pos >= len(mv):
        raise ValueError("msgpack: data truncated")
    b = mv[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        s, pos = _take(mv, pos, b & 0x1F)
        return str(s, "utf-8"), pos
    if 0x90 <= b <= 0x9F:
        return _unpack_array(mv, pos, b & 0x0F, hook)
    if 0x80 <= b <= 0x8F:
        return _unpack_map(mv, pos, b & 0x0F, hook)
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in _FIXED:
        fmt = _FIXED[b]
        s, pos = _take(mv, pos, struct.calcsize(fmt))
        return struct.unpack(fmt, s)[0], pos
    if b in (0xD9, 0xDA, 0xDB, 0xC4, 0xC5, 0xC6):
        fmt = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
               0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]
        s, pos = _take(mv, pos, struct.calcsize(fmt))
        data, pos = _take(mv, pos, struct.unpack(fmt, s)[0])
        if b in (0xD9, 0xDA, 0xDB):
            return str(data, "utf-8"), pos
        return bytes(data), pos
    if b in (0xDC, 0xDD, 0xDE, 0xDF):
        fmt = ">H" if b in (0xDC, 0xDE) else ">I"
        s, pos = _take(mv, pos, struct.calcsize(fmt))
        n = struct.unpack(fmt, s)[0]
        if b in (0xDC, 0xDD):
            return _unpack_array(mv, pos, n, hook)
        return _unpack_map(mv, pos, n, hook)
    raise ValueError(f"msgpack: unsupported type byte 0x{b:02x} "
                     f"(ext types are not used by snapshot images)")


def _unpack_array(mv, pos, n, hook):
    items = []
    for _ in range(n):
        item, pos = _unpack(mv, pos, hook)
        items.append(item)
    return items, pos


def _unpack_map(mv, pos, n, hook):
    d = {}
    for _ in range(n):
        k, pos = _unpack(mv, pos, hook)
        d[k], pos = _unpack(mv, pos, hook)
    return (hook(d) if hook is not None else d), pos
