"""K1: the RAM amplitude band-mix, a hand-written CUDA kernel and its plain
PyTorch version.

The kernel (`csrc/ram_mix.cu`) replaces the TPU kernel
`ramdsir_tpu/ops/ram_pallas.py::_mix_kernel`.  It is built with nvcc into a
shared library with a plain C interface at first use on the card, keyed on
the source's hash, into `ramdsir_tpu_torch/_build/`, and bound with ctypes.

`mix_spectrum` is the only entry point.  It takes the plain version for
tensors on the CPU (the tests) and launches the kernel for CUDA tensors; a
CUDA tensor it cannot take raises, it never falls back.  `launches` counts
kernel launches, so a run can show that it went through the kernel.

Layouts (element strides, any memory order):
  re, im   (N, C, H, Wh) float32 planes of one rfft2 half-spectrum; they may
           alias one complex tensor through `torch.view_as_real`.
  amp_t    full mode: (N, C, H, Wh).  Band mode: (N, C, 2b+1, b+1), rows
           [0..b] then [h-b..h-1], as `ops.ram.banded_amplitude_spectrum`
           lays them out.
  ratio    (N,) float32, one mix ratio per sample.
In band mode re/im are either a whole spectrum (its band rows past b sit at
H-b..H-1) or a compact (N, C, 2b+1, b+1) block.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "ram_mix.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
FLT_MIN = float(torch.finfo(torch.float32).tiny)

launches = 0  # kernel launches; mix_spectrum adds one per launch
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: K1 (csrc/ram_mix.cu) is compiled on the machine with the card")


def build_library() -> str:
    """Compile csrc/ram_mix.cu unless a library built from the same source
    and flags exists; returns the library's path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libram_mix_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name and rename: a concurrent build never loads
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        fn = lib.ram_mix_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _band_rows(h: int, band: int, device) -> torch.Tensor:
    return torch.cat([torch.arange(band + 1, device=device), torch.arange(h - band, h, device=device)])


def mix_spectrum_plain(
    re: torch.Tensor,
    im: torch.Tensor,
    amp_t: torch.Tensor,
    ratio: torch.Tensor,
    band: int,
    *,
    full: bool,
    delta: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch (`_mix_spectrum`,
    `_mix_block` and ram.py:241-248 of the JAX package), same contract as
    `mix_spectrum`."""
    h, wh = re.shape[-2:]
    r = ratio.reshape(-1, 1, 1, 1)
    if full:
        zr, zi = re, im
        rows = torch.arange(h, device=re.device)
        cols = torch.arange(wh, device=re.device)
        mask = ((rows <= band) | (rows >= h - band))[:, None] & (cols <= band)[None, :]
    else:
        idx = _band_rows(h, band, re.device)
        zr = re[:, :, idx, : band + 1]
        zi = im[:, :, idx, : band + 1]
        mask = None
    amp = torch.sqrt(zr * zr + zi * zi)
    mixed = r * amp + (1.0 - r) * amp_t
    new = mixed if mask is None else torch.where(mask, mixed, amp)
    f = new / torch.clamp_min(amp, FLT_MIN)
    zero = amp == 0.0
    if delta:
        f = f - 1.0
    out_re = torch.where(zero, new, zr * f)
    out_im = torch.where(zero, torch.zeros_like(zi), zi * f)
    if delta:
        return out_re, out_im
    if full:
        re.copy_(out_re)
        im.copy_(out_im)
    else:
        re[:, :, : band + 1, : band + 1] = out_re[:, :, : band + 1]
        re[:, :, h - band :, : band + 1] = out_re[:, :, band + 1 :]
        im[:, :, : band + 1, : band + 1] = out_im[:, :, : band + 1]
        im[:, :, h - band :, : band + 1] = out_im[:, :, band + 1 :]
    return re, im


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"ram_mix: {name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"ram_mix: {name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ram_mix: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if any(s < 0 for s in t.stride()):
        raise ValueError(f"ram_mix: {name} has a negative stride")


def mix_spectrum(
    re: torch.Tensor,
    im: torch.Tensor,
    amp_t: torch.Tensor,
    ratio: torch.Tensor,
    band: int,
    *,
    full: bool,
    delta: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Amplitude band-mix of the spectrum planes (re, im).

    full=True: every (H, Wh) element, the band taken from the indices, amp_t
    a whole plane (`ram_mixup`).  full=False: only the in-band elements,
    amp_t the (2b+1, b+1) band (`ram_mixup_banded`, `ram_mixup_banded_dft`).
    Both write the mixed spectrum into re/im in place and return them.
    delta=True (band mode only) leaves re/im alone and returns new compact
    (N, C, 2b+1, b+1) planes holding the mixed minus the original spectrum.
    """
    if delta and full:
        raise ValueError("ram_mix: the delta output is a band-mode output")
    if re.device.type == "cpu":
        return mix_spectrum_plain(re, im, amp_t, ratio, band, full=full, delta=delta)
    if re.device.type != "cuda":
        raise ValueError(f"ram_mix: no kernel for device {re.device}")

    n, c, h, wh = re.shape
    if band < 0 or 2 * band + 1 > h or band + 1 > wh:
        raise ValueError(f"ram_mix: band half-width {band} does not fit a ({h}, {wh}) spectrum")
    rows, cols = (h, wh) if full else (2 * band + 1, band + 1)
    dev = re.device
    _check("re", re, (n, c, h, wh), dev)
    _check("im", im, (n, c, h, wh), dev)
    if re.stride() != im.stride():
        raise ValueError("ram_mix: re and im must share strides")
    _check("amp_t", amp_t, (n, c, rows, cols), dev)
    _check("ratio", ratio, (n,), dev)
    if not ratio.is_contiguous():
        raise ValueError("ram_mix: ratio must be contiguous")
    if n * c > 65535:
        raise ValueError(f"ram_mix: {n * c} planes exceed the grid's 65535")
    if delta:
        out_re = torch.empty((n, c, rows, cols), dtype=torch.float32, device=dev)
        out_im = torch.empty_like(out_re)
    else:
        out_re, out_im = re, im

    global launches
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _library().ram_mix_launch(
            re.data_ptr(), im.data_ptr(), amp_t.data_ptr(), ratio.data_ptr(),
            out_re.data_ptr(), out_im.data_ptr(),
            *re.stride(), *amp_t.stride(), *out_re.stride(),
            n, c, rows, cols, band, h, int(full), int(delta), stream,
        )
    if err != 0:
        raise RuntimeError(f"ram_mix kernel launch failed: CUDA error {err}")
    launches += 1
    return out_re, out_im
