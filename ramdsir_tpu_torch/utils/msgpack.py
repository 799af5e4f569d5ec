"""The subset of msgpack that flax's checkpoints use, read and written with
numpy alone (the port keeps its own copy: no msgpack package is needed).

Types: nil, bool, int, float, str, bin, arrays, maps, and two of flax's
extension types (`flax.serialization._MsgpackExtType`): 1, an ndarray, and
3, a numpy scalar.  Both carry a msgpack array [shape, dtype name, the
C-order bytes]; an ndarray of shape () is a 0-d array, a numpy scalar is
read back as one.  Writing takes the format's smallest encodings and sorts
map keys, as flax's `msgpack_serialize` does, so the same tree gives the
same bytes, and `flax.serialization.msgpack_restore` reads what `packb`
writes.  flax splits leaves over 1 GiB into chunk maps; no
leaf of this model comes near that size.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _head(out: bytearray, n: int, fix: Tuple[int, int], codes: Tuple[int, ...]) -> None:
    """A length header: `fix` = (base, largest n it holds) or (0, -1) for
    none; `codes` the 8-, 16- and 32-bit forms (bin/str/ext) or the 16- and
    32-bit forms (array/map)."""
    base, fix_max = fix
    if n <= fix_max:
        out.append(base | n)
        return
    widths = ((0xFF, "B"), (0xFFFF, ">H"), (0xFFFFFFFF, ">I"))[3 - len(codes):]
    for code, (limit, fmt) in zip(codes, widths):
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack("b" if v < 0 else "B", v)
        return
    forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if v >= 0 else (
        (0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
    for code, fmt in forms:
        try:
            packed = struct.pack(fmt, v)
        except struct.error:
            continue
        out.append(code)
        out += packed
        return
    raise ValueError(f"msgpack: integer {v} does not fit 64 bits")


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise TypeError(f"msgpack: cannot write an array of dtype {arr.dtype}")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):  # before float: np.float64 is a float
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), (0xA0, 31), (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _head(out, len(raw), (0, -1), (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), (0x90, 15), (0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), (0x80, 15), (0xDE, 0xDF))
        for k in sorted(obj):  # flax's tree_map sorts dict keys before it packs
            _pack(k, out)
            _pack(obj[k], out)
    else:
        raise TypeError(f"msgpack: cannot write {type(obj).__name__}")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    if len(data) in _FIXEXT:
        out.append(_FIXEXT[len(data)])
    else:
        _head(out, len(data), (0, -1), (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def packb(obj: Any) -> bytes:
    """obj (nested dicts, lists, scalars, str, bytes, numpy arrays) -> bytes."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        self.pos += n
        return self.data[self.pos - n : self.pos]

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F or b >= 0xE0:
            return b if b <= 0x7F else b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: ">H", 0xC6: ">I", 0xD9: "B", 0xDA: ">H", 0xDB: ">I"}
        if b in sized:
            raw = bytes(self.take(self.unpack(sized[b])))
            return raw if b <= 0xC6 else raw.decode("utf-8")
        ext = {0xC7: "B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self.ext(self.unpack(ext[b]))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack("b")
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: extension type {code} is not a flax array")
        shape, dtype, raw = unpackb(data)
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr[()] if code == EXT_NPSCALAR else arr


def unpackb(data: bytes) -> Any:
    """bytes -> the object `packb` (or flax's `msgpack_serialize`) wrote."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the object")
    return obj
