"""NIfTI-1 single-file volumes (.nii / .nii.gz), read and written without
SimpleITK (own copy of `ramdsir_tpu/data/nifti.py`).

`read_nifti` returns the array in (z, y, x) order, as
`sitk.GetArrayFromImage` does, with `scl_slope`/`scl_inter` applied; only the
single-file layout (magic "n+1"/"ni1") is read, the one the prostate volumes
ship in.
"""
from __future__ import annotations

import gzip
import struct
import sys
from typing import Tuple

import numpy as np


_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str, mode: str):
    return gzip.open(path, mode) if path.endswith(".gz") else open(path, mode)


def read_nifti(path: str) -> np.ndarray:
    """A NIfTI-1 volume as (z, y, x[, t...]), like SimpleITK; the span
    `ramdsir.data.decode` under a profiler.  A process that has not imported
    torch (a host loader's worker) has no profiler: it reads without
    importing torch."""
    if "torch" not in sys.modules:
        return _read_nifti(path)
    from ramdsir_tpu_torch.utils.profiler import span

    with span("ramdsir.data.decode"):
        return _read_nifti(path)


def _read_nifti(path: str) -> np.ndarray:
    with _open(path, "rb") as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        order = "<"
        if struct.unpack("<i", hdr[0:4])[0] != 348:
            if struct.unpack(">i", hdr[0:4])[0] != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file")
            order = ">"
        dim = struct.unpack(f"{order}8h", hdr[40:56])
        datatype = struct.unpack(f"{order}h", hdr[70:72])[0]
        vox_offset, scl_slope, scl_inter = struct.unpack(f"{order}3f", hdr[108:120])
        if hdr[344:347] not in (b"n+1", b"ni1"):
            raise ValueError(f"{path}: bad NIfTI magic {hdr[344:348]!r}")
        shape = tuple(int(d) for d in dim[1 : 1 + dim[0]])
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder(order)
        f.seek(int(vox_offset))
        count = int(np.prod(shape))
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
    # x varies fastest on disk: a C reshape to the reversed dims is sitk's order
    arr = data.reshape(shape[::-1])
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        arr = arr.astype(np.float32) * (scl_slope if scl_slope != 0.0 else 1.0) + scl_inter
    return np.ascontiguousarray(arr)


def write_nifti(path: str, array_zyx: np.ndarray, voxel_size: Tuple[float, ...] = (1.0, 1.0, 1.0)) -> None:
    """Write a (z, y, x) array as a single-file NIfTI-1 volume; bool is
    stored as uint8 and a type NIfTI has no code for as float32."""
    arr = np.asarray(array_zyx)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype not in _CODES:
        arr = arr.astype(np.float32)
    shape_xyz = arr.shape[::-1]
    ndim = len(shape_xyz)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, ndim, *shape_xyz, *[1] * (7 - ndim))
    struct.pack_into("<h", hdr, 70, _CODES[arr.dtype])
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *voxel_size[:ndim], *[1.0] * (7 - ndim))
    struct.pack_into("<3f", hdr, 108, 352.0, 1.0, 0.0)  # vox_offset, scl_slope, scl_inter
    hdr[344:348] = b"n+1\x00"
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # no extension
        f.write(np.ascontiguousarray(arr).tobytes())  # C order == x fastest for the reversed dims
