"""The port's PNG codec, on the standard library's zlib and numpy.

The fundus trees are PNG files, and the machine with the card has no image
library, so the port reads and writes them itself.

`decode` reads a file (or its bytes) into a `PNGImage` whose `array` is what
`np.asarray(PIL.Image.open(path))` gives for the same file, under PIL's mode:

  colour type, bit depth    mode     array
  0 gray, 1                 "1"      (H, W) bool
  0 gray, 2 / 4 / 8         "L"      (H, W) uint8, 2- and 4-bit values scaled to 0..255
  0 gray, 16                "I;16"   (H, W) uint16
  2 RGB, 8 / 16             "RGB"    (H, W, 3) uint8 (16-bit: the high bytes)
  3 palette, 1 / 2 / 4 / 8  "P"      (H, W) uint8 indices, `palette` (n, 3) uint8
  4 gray + alpha, 8         "LA"     (H, W, 2) uint8
  4 gray + alpha, 16        "RGBA"   (H, W, 4) uint8, gray replicated (high bytes)
  6 RGBA, 8 / 16            "RGBA"   (H, W, 4) uint8 (16-bit: the high bytes)

It checks every chunk's CRC, reads IHDR, PLTE, tRNS and IDAT, skips
ancillary chunks, and undoes Adam7 interlacing.  Rows are unfiltered by the
host C++ library (`native/png.cpp`); `unfilter_plain` is its numpy version,
for the tests.  Anything malformed raises ValueError naming the file.
`ops.image.convert` turns a `PNGImage` into the "L" or "RGB" array PIL's
`convert` gives.

`encode` writes 8-bit L, RGB, RGBA and P images, not interlaced, with the
row filter chosen by the caller (one of the five, or per row the one whose
bytes have the least sum of absolute values as signed bytes).  Forward
filtering reads only unfiltered bytes, so it runs on whole images in numpy.
"""
from __future__ import annotations

import dataclasses
import struct
import sys
import zlib
from typing import List, Optional, Tuple, Union

import numpy as np


SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTERS = ("none", "sub", "up", "average", "paeth")  # filter type = index
ADAPTIVE = "adaptive"
# (x0, y0, dx, dy) of the seven Adam7 passes
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_COLOUR_TYPES = {"L": 0, "RGB": 2, "P": 3, "RGBA": 6}


@dataclasses.dataclass
class PNGImage:
    """A decoded PNG: PIL's `mode`, the pixel `array`, the `palette`
    ((n, 3) uint8, mode "P" only) and the raw tRNS chunk, if any."""

    mode: str
    array: np.ndarray
    palette: Optional[np.ndarray] = None
    transparency: Optional[bytes] = None
    name: str = "<bytes>"


def _passes(width: int, height: int, interlace: bool) -> List[Tuple[int, int, int, int, int, int]]:
    """(x0, y0, dx, dy, pass width, pass height) of each non-empty pass."""
    if not interlace:
        return [(0, 0, 1, 1, width, height)]
    out = []
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


def _chunks(data: bytes, name: str):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated before IEND")
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{name}: chunk {ctype!r} is truncated")
        body = data[pos + 8 : end]
        (crc,) = struct.unpack(">I", data[end : end + 4])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{name}: CRC mismatch in chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4


def unfilter_plain(filtered: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """`native.png_unfilter` in numpy, row by row (the tests' version)."""
    src = np.asarray(filtered, np.uint8).reshape(height, rowbytes + 1)
    out = np.zeros((height, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.int64)
    for y in range(height):
        kind, f = int(src[y, 0]), src[y, 1:].astype(np.int64)
        if kind == 0:
            row = f
        elif kind == 2:
            row = (f + prev) & 255
        elif kind in (1, 3, 4):
            row = np.zeros(rowbytes, np.int64)
            for x in range(rowbytes):
                a = row[x - bpp] if x >= bpp else 0
                b, c = prev[x], (prev[x - bpp] if x >= bpp else 0)
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                row[x] = (f[x] + pred) & 255
        else:
            raise ValueError(f"unfilter_plain: row {y} has filter type {kind}")
        out[y] = row
        prev = row
    return out


def _unpack(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """(h, rowbytes) unfiltered bytes -> (h, width, channels) samples,
    uint8 (depth <= 8) or uint16."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, width, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, : width * channels].reshape(h, width, channels).astype(np.uint8)


def decode(source: Union[str, bytes], name: Optional[str] = None) -> PNGImage:
    """Decode a PNG file (a path, or the file's bytes); the span
    `ramdsir.data.decode` under a profiler.  A process that has not imported
    torch (a host loader's worker) has no profiler: it reads without
    importing torch."""
    if "torch" not in sys.modules:
        return _decode(source, name)
    from ramdsir_tpu_torch.utils.profiler import span

    with span("ramdsir.data.decode"):
        return _decode(source, name)


def _decode(source: Union[str, bytes], name: Optional[str]) -> PNGImage:
    if isinstance(source, (bytes, bytearray, memoryview)):
        data, name = bytes(source), name or "<bytes>"
    else:
        name = name or str(source)
        with open(source, "rb") as f:
            data = f.read()
    ihdr, plte, trns, idat = None, None, None, []
    for ctype, body in _chunks(data, name):
        if ihdr is None and ctype != b"IHDR":
            raise ValueError(f"{name}: the first chunk is {ctype!r}, not IHDR")
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{name}: IHDR holds {len(body)} bytes, not 13")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            if len(body) % 3 or not 0 < len(body) <= 768:
                raise ValueError(f"{name}: PLTE of {len(body)} bytes")
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype != b"IEND" and not ctype[0] & 0x20:
            raise ValueError(f"{name}: unknown critical chunk {ctype!r}")
    width, height, depth, ctype, compression, filter_method, interlace = ihdr
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{name}: colour type {ctype} with bit depth {depth} is not a PNG format")
    if compression != 0 or filter_method != 0 or interlace not in (0, 1):
        raise ValueError(f"{name}: compression {compression}, filter method {filter_method}, interlace {interlace}")
    if width == 0 or height == 0:
        raise ValueError(f"{name}: empty image {width} x {height}")
    if ctype == 3 and plte is None:
        raise ValueError(f"{name}: a palette image without PLTE")
    if not idat:
        raise ValueError(f"{name}: no IDAT chunk")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt image data: {e}") from e

    from ramdsir_tpu_torch import native

    channels = _CHANNELS[ctype]
    bits = channels * depth
    bpp = max(1, bits // 8)
    samples = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph in _passes(width, height, interlace == 1):
        rowbytes = (pw * bits + 7) // 8
        n = ph * (rowbytes + 1)
        if pos + n > raw.size:
            raise ValueError(f"{name}: image data holds {raw.size} bytes, expected at least {pos + n}")
        try:
            rows = native.png_unfilter(raw[pos : pos + n], ph, rowbytes, bpp)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from e
        samples[y0::dy, x0::dx] = _unpack(rows, pw, channels, depth)
        pos += n
    return PNGImage(*_pil_form(samples, ctype, depth), palette=plte, transparency=trns, name=name)


def _pil_form(samples: np.ndarray, ctype: int, depth: int) -> Tuple[str, np.ndarray]:
    """(mode, array) as PIL opens the file (see the module's table)."""
    if ctype == 0:
        g = samples[..., 0]
        if depth == 1:
            return "1", g.astype(bool)
        if depth < 8:
            return "L", (g * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return ("L", g) if depth == 8 else ("I;16", g)
    if ctype == 3:
        return "P", samples[..., 0]
    if depth == 16:
        samples = (samples >> 8).astype(np.uint8)
        if ctype == 4:
            return "RGBA", samples[..., [0, 0, 0, 1]]
    return {2: "RGB", 4: "LA", 6: "RGBA"}[ctype], samples


def filter_rows(rows: np.ndarray, bpp: int, filter_type: Union[int, str] = ADAPTIVE) -> np.ndarray:
    """Filter (h, rowbytes) uint8 rows: (h, 1 + rowbytes), each row led by
    its filter type.  `filter_type` is 0..4 (or its name in FILTERS), or
    ADAPTIVE: per row the filter whose output has the least sum of
    |signed byte|, ties to the lower type."""
    x = np.ascontiguousarray(rows, np.uint8)
    if filter_type == ADAPTIVE:
        kinds_wanted = range(5)
    else:
        kind = FILTERS.index(filter_type) if isinstance(filter_type, str) else int(filter_type)
        if not 0 <= kind <= 4:
            raise ValueError(f"filter_rows: no filter type {filter_type!r}")
        kinds_wanted = (kind,)
    a = np.zeros_like(x)  # left, up and upper-left neighbours (0 off the image)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cands = []
    for kind in kinds_wanted:  # uint8 arithmetic wraps modulo 256, as PNG's does
        if kind == 0:
            cands.append(x)
        elif kind == 1:
            cands.append(x - a)
        elif kind == 2:
            cands.append(x - b)
        elif kind == 3:
            cands.append(x - ((a.astype(np.uint16) + b) >> 1).astype(np.uint8))
        else:
            c = np.zeros_like(x)
            c[1:, bpp:] = x[:-1, :-bpp]
            ai, bi, ci = (t.astype(np.int16) for t in (a, b, c))
            pa, pb, pc = np.abs(bi - ci), np.abs(ai - ci), np.abs(ai + bi - 2 * ci)
            cands.append(x - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)))
    if len(cands) == 1:
        kinds, body = np.full(x.shape[0], kinds_wanted[0]), cands[0]
    else:
        # |signed byte| of a uint8 v is min(v, 256 - v)
        score = np.stack([np.minimum(t, 0 - t).sum(axis=1, dtype=np.int64) for t in cands])
        kinds = np.argmin(score, axis=0)
        body = np.stack(cands)[kinds, np.arange(x.shape[0])]
    return np.concatenate([kinds.astype(np.uint8)[:, None], body], axis=1)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def encode(
    array: np.ndarray,
    *,
    palette: Optional[np.ndarray] = None,
    filter_type: Union[int, str] = ADAPTIVE,
) -> bytes:
    """The PNG bytes of an 8-bit image: (H, W) gray ("L"), (H, W, 3) RGB,
    (H, W, 4) RGBA, or (H, W) palette indices with `palette` (n <= 256, 3)
    uint8 ("P")."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        raise TypeError(f"encode: 8-bit images only, got {a.dtype}")
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        if a.ndim != 2 or palette.ndim != 2 or palette.shape[1] != 3 or not 0 < len(palette) <= 256:
            raise ValueError(f"encode: palette {palette.shape} for an image of shape {a.shape}")
        if a.size and int(a.max()) >= len(palette):
            raise ValueError(f"encode: index {int(a.max())} past a palette of {len(palette)}")
        mode = "P"
    elif a.ndim == 2:
        mode = "L"
    elif a.ndim == 3 and a.shape[2] in (3, 4):
        mode = "RGB" if a.shape[2] == 3 else "RGBA"
    else:
        raise ValueError(f"encode: cannot write an image of shape {a.shape}")
    height, width = a.shape[:2]
    if width == 0 or height == 0:
        raise ValueError(f"encode: empty image {a.shape}")
    channels = 1 if a.ndim == 2 else a.shape[2]
    rows = filter_rows(a.reshape(height, width * channels), channels, filter_type)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, _COLOUR_TYPES[mode], 0, 0, 0)
    out = [SIGNATURE, _chunk(b"IHDR", ihdr)]
    if palette is not None:
        out.append(_chunk(b"PLTE", palette.tobytes()))
    out += [_chunk(b"IDAT", zlib.compress(rows.tobytes())), _chunk(b"IEND", b"")]
    return b"".join(out)


def write(path: str, array: np.ndarray, **kwargs) -> str:
    """`encode` into a file; returns the path."""
    data = encode(array, **kwargs)
    with open(path, "wb") as f:
        f.write(data)
    return path
