"""ctypes bindings for the port's two host libraries: the post-processing
and surface-distance library (`postproc.cpp`, the port's own copy of the
JAX package's) and the PNG row unfilter (`png.cpp`, for `data/png.py`).

Each library (`POSTPROC`, `PNG`) is compiled with g++ at first use, not at
import, by `native/build.py`.  There is no fallback: a failed build raises,
the eval path never takes scipy in its place, nor the PNG decoder its numpy
loop.  The plain versions (`ops.postprocess.*_plain`,
`ops.metrics.surface_distances_plain`, `data.png.unfilter_plain`) are for
the tests and the card's smoke run, which hold the libraries to them.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ramdsir_tpu_torch.native.build import Library

_HERE = os.path.dirname(os.path.abspath(__file__))
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_U8P, _I64P = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)
POSTPROC = Library(os.path.join(_HERE, "postproc.cpp"), CXX, CXX_FLAGS, {
    "largest_cc_fillhole": (None, [_U8P, ctypes.c_int, ctypes.c_int, _U8P]),
    "largest_cc_nd": (None, [_U8P, _I64P, ctypes.c_int, _U8P]),
    "surface_distances": (ctypes.c_int64, [_U8P, _U8P, _I64P, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
                                           ctypes.c_int64]),
})
PNG = Library(os.path.join(_HERE, "png.cpp"), CXX, CXX_FLAGS, {
    "png_unfilter": (ctypes.c_int64, [_U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _U8P]),
})


def png_unfilter(filtered: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """The (height, rowbytes) uint8 rows of a filtered PNG stream of
    height * (1 + rowbytes) bytes, each row led by its filter type; bpp is
    the filter's byte distance, 1..8.  An unknown filter type raises."""
    src = np.ascontiguousarray(filtered, dtype=np.uint8).reshape(-1)
    if src.size != height * (rowbytes + 1):
        raise ValueError(f"png_unfilter: {src.size} bytes for {height} rows of {rowbytes} + 1")
    if not 1 <= bpp <= 8:
        raise ValueError(f"png_unfilter: bpp {bpp} is outside [1, 8]")
    out = np.empty((height, rowbytes), np.uint8)
    err = PNG.load().png_unfilter(_ptr(src, ctypes.c_uint8), height, rowbytes, bpp, _ptr(out, ctypes.c_uint8))
    if err != 0:
        row = -err - 1
        raise ValueError(f"png_unfilter: row {row} has filter type {src[row * (rowbytes + 1)]}")
    return out


def _u8(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a) != 0, dtype=np.uint8)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check_rank(a: np.ndarray, low: int, high: int, what: str) -> None:
    if not low <= a.ndim <= high:
        raise ValueError(f"{what}: rank {a.ndim} is outside [{low}, {high}]")


def largest_cc_fillhole(mask: np.ndarray) -> np.ndarray:
    """Largest 8-connected component of a 2-D mask, holes filled (int64 0/1)."""
    m = _u8(mask)
    _check_rank(m, 2, 2, "largest_cc_fillhole")
    out = np.zeros_like(m)
    POSTPROC.load().largest_cc_fillhole(_ptr(m, ctypes.c_uint8), m.shape[0], m.shape[1], _ptr(out, ctypes.c_uint8))
    return out.astype(np.int64)


def largest_cc_nd(mask: np.ndarray) -> np.ndarray:
    """Largest connectivity-1 component of a rank-1..4 mask (uint8 0/1);
    an empty mask gives all zeros."""
    m = _u8(mask)
    _check_rank(m, 1, 4, "largest_cc_nd")
    dims = np.asarray(m.shape, np.int64)
    out = np.zeros_like(m)
    POSTPROC.load().largest_cc_nd(_ptr(m, ctypes.c_uint8), _ptr(dims, ctypes.c_int64), m.ndim, _ptr(out, ctypes.c_uint8))
    return out


def surface_distances(result: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Directed surface distances result -> reference (float64), in the
    result border's C order."""
    r, g = _u8(result), _u8(reference)
    _check_rank(r, 1, 4, "surface_distances")
    if r.shape != g.shape:
        raise ValueError(f"surface_distances: shapes {r.shape} and {g.shape} differ")
    dims = np.asarray(r.shape, np.int64)
    out = np.empty(r.size, np.float64)
    n = POSTPROC.load().surface_distances(
        _ptr(r, ctypes.c_uint8), _ptr(g, ctypes.c_uint8), _ptr(dims, ctypes.c_int64), r.ndim,
        _ptr(out, ctypes.c_double), r.size,
    )
    if n == -1:
        raise RuntimeError("The first input does not contain any binary object.")
    if n == -2:
        raise RuntimeError("The second input does not contain any binary object.")
    if not 0 <= n <= r.size:
        raise RuntimeError(f"surface_distances: the library returned {n} for {r.size} elements")
    return out[:n].copy()
