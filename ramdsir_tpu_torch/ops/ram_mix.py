"""K1: the RAM amplitude band-mix, a hand-written CUDA kernel and its plain
PyTorch version.

The kernel (`csrc/ram_mix.cu`) replaces the TPU kernel
`ramdsir_tpu/ops/ram_pallas.py::_mix_kernel`.  It is built with nvcc into a
shared library with a plain C interface at first use on the card and bound
with ctypes (`ops/cuda_build.py`).

`mix_spectrum` is the only entry point.  It takes the plain version for
tensors on the CPU (the tests) and launches the kernel for CUDA tensors; a
CUDA tensor it cannot take raises, it never falls back.  The kernel counts
its runs on the card by code path (`_path`), a graph's replays included:
`cuda_build.launch_counts()["ram_mix.<path>"]`.

Layouts (element strides, any memory order):
  re, im   (N, C, H, Wh) float32 planes of one rfft2 half-spectrum; they may
           alias one complex tensor through `torch.view_as_real`.
  amp_t    full mode: (N, C, H, Wh).  Band mode: (N, C, 2b+1, b+1), rows
           [0..b] then [h-b..h-1], as `ops.ram.banded_amplitude_spectrum`
           lays them out.
  ratio    (N,) float32, one mix ratio per sample.
In band mode re/im are either a whole spectrum (its band rows past b sit at
H-b..H-1) or a compact (N, C, 2b+1, b+1) block.  The kernel has a float4
path for full mode on the interleaved spectrum, a flat path for the DFT
path's compact delta blocks and an element-strided path for the rest;
`_layout` and `_path` choose it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ramdsir_tpu_torch.ops import cuda_build

SOURCE = cuda_build.source_path("ram_mix.cu")
FLT_MIN = float(torch.finfo(torch.float32).tiny)

PATHS = ("strided", "full_vec", "delta_flat")  # the codes of ram_mix_launch
LIBRARY = cuda_build.kernel_library(SOURCE, {
    "ram_mix_launch": [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 8,
})


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


def _dense(t: torch.Tensor, strides) -> bool:
    """t has these element strides on every axis longer than 1."""
    return all(n == 1 or s == want for n, s, want in zip(t.shape, t.stride(), strides))


def _layout(re: torch.Tensor, im: torch.Tensor) -> str:
    """How the kernel may walk the (N, C, H, Wh) planes:

    'interleaved'  re/im are `view_as_real` of one contiguous complex tensor
                   (im 4 bytes after re, element stride 2), based on 16 bytes;
    'planar'       two contiguous float32 tensors;
    'strided'      anything else, walked by element strides.
    """
    n, c, h, wh = re.shape
    if (
        im.data_ptr() == re.data_ptr() + 4
        and _dense(re, (2 * c * h * wh, 2 * h * wh, 2 * wh, 2))
        and re.data_ptr() % 16 == 0
    ):
        return "interleaved"
    if re.is_contiguous() and im.is_contiguous():
        return "planar"
    return "strided"


def _path(layout: str, full: bool, delta: bool, compact: bool) -> str:
    """The kernel's code path for a layout and mode: float4 pairs of an
    interleaved spectrum (full mode), flat indices into compact planar
    blocks (delta mode; `compact`: re/im are the (N, C, 2b+1, b+1) band), or
    element strides (band mode in place, and every other layout)."""
    if full:
        return "full_vec" if layout == "interleaved" else "strided"
    return "delta_flat" if delta and compact and layout == "planar" else "strided"


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
    if n * c * h * wh >= 2**31:
        raise ValueError(f"ram_mix: {n * c * h * wh} elements exceed the kernel's 32-bit indices")
    path = _path(_layout(re, im), full, delta, compact=(h, wh) == (rows, cols))
    if delta:
        out_re = torch.empty((n, c, rows, cols), dtype=torch.float32, device=dev)
        out_im = torch.empty_like(out_re)
    else:
        out_re, out_im = re, im
    _launch(path, re, im, amp_t, ratio, band, out_re, out_im, full=full, delta=delta)
    return out_re, out_im


def _launch(path, re, im, amp_t, ratio, band, out_re, out_im, *, full, delta) -> None:
    """Launch one code path of K1 on tensors `mix_spectrum` has checked."""
    n, c, h, _ = re.shape
    rows, cols = amp_t.shape[-2:]
    cuda_build.launch(
        LIBRARY, "ram_mix_launch", f"ram_mix.{path}", re.device,
        PATHS.index(path), re.data_ptr(), im.data_ptr(), amp_t.data_ptr(), ratio.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(),
        *re.stride(), *amp_t.stride(), *out_re.stride(),
        n, c, rows, cols, band, h, int(full), int(delta),
    )
