"""K2: the deterministic backward of the bilinear x2 upsample, a hand-written
CUDA kernel and its plain PyTorch version, and the autograd Function that
uses it.

torch's CUDA backward of `F.interpolate(..., mode="bilinear")` adds with
atomics, so it is not repeatable, and under
`torch.use_deterministic_algorithms(True)` torch refuses it.  K2
(`csrc/upsample2x.cu`) computes the same gradient as a gather with fixed
weights and a fixed summation order.  It has no TPU counterpart: the JAX
package's upsample (`jax.image.resize`) is differentiated by XLA.  It is
built with nvcc at first use on the card into `ramdsir_tpu_torch/_build/`
(`ops/cuda_build.py`) and bound with ctypes.

`upsample2x_backward` takes the plain version for tensors on the CPU (the
tests) and launches the kernel for CUDA tensors; a CUDA tensor it cannot
take raises, it never falls back.  `launches` counts kernel launches.
`Upsample2x` is the upsample with this backward; `models/unet.upsample2x`
takes it while torch's deterministic mode is on.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ramdsir_tpu_torch.ops import cuda_build

SOURCE = cuda_build.source_path("upsample2x.cu")
DTYPES = (torch.float32, torch.bfloat16)  # the codes of upsample2x_backward_launch

launches = 0  # kernel launches; upsample2x_backward adds one per launch
_lib: Optional[ctypes.CDLL] = None


def build_library() -> str:
    """Compile csrc/upsample2x.cu unless a library built from the same
    source and flags exists; returns the library's path."""
    return cuda_build.build_library(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        fn = lib.upsample2x_backward_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _axis_backward(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The gather of one axis (`dim`, of length 2n) in the kernel's order:
    input i sums 0.25*g[2i-1] + 0.75*g[2i] + 0.75*g[2i+1] + 0.25*g[2i+2],
    left to right, without the terms that fall off the ends; the edge
    weights are 1 (g[0] for input 0, g[2n-1] for input n-1)."""
    g = g.movedim(dim, -1)
    n = g.shape[-1] // 2
    even, odd = g[..., 0::2], g[..., 1::2]
    acc = 0.75 * even
    acc[..., 0] = even[..., 0]
    if n > 1:
        acc[..., 1:] = 0.25 * odd[..., :-1] + acc[..., 1:]
    last = odd[..., -1:].clone()
    acc = acc + torch.cat([0.75 * odd[..., :-1], last], dim=-1)
    if n > 1:
        acc[..., :-1] = acc[..., :-1] + 0.25 * even[..., 1:]
    return acc.movedim(-1, dim)


def upsample2x_backward_plain(grad: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: (N, C, 2H, 2W) -> (N, C, H,
    W), accumulated in float32 (float64 for a float64 gradient) along the
    columns, then the rows, and rounded once to the gradient's dtype."""
    acc_dtype = torch.promote_types(grad.dtype, torch.float32)
    g = grad.to(acc_dtype)
    return _axis_backward(_axis_backward(g, -1), -2).to(grad.dtype)


def _check(grad: torch.Tensor) -> None:
    if grad.dim() != 4 or grad.shape[2] % 2 or grad.shape[3] % 2 or 0 in grad.shape[2:]:
        raise ValueError(f"upsample2x_backward: expected (N, C, 2H, 2W), got {tuple(grad.shape)}")


def upsample2x_backward(grad: torch.Tensor) -> torch.Tensor:
    """The input gradient (N, C, H, W) of the bilinear x2 upsample
    (align_corners=False) from its output gradient (N, C, 2H, 2W)."""
    _check(grad)
    if grad.device.type == "cpu":
        return upsample2x_backward_plain(grad)
    if grad.device.type != "cuda":
        raise ValueError(f"upsample2x_backward: no kernel for device {grad.device}")
    if grad.dtype not in DTYPES:
        raise TypeError(f"upsample2x_backward: float32 or bfloat16 gradients only, got {grad.dtype}")
    if not grad.is_contiguous():
        raise ValueError("upsample2x_backward: the gradient must be NCHW contiguous")
    n, c, h2, w2 = grad.shape
    if n * c * (h2 // 2) * (w2 // 2) >= 2**31:
        raise ValueError(f"upsample2x_backward: {n * c * h2 * w2 // 4} elements exceed the kernel's 32-bit indices")
    out = torch.empty((n, c, h2 // 2, w2 // 2), dtype=grad.dtype, device=grad.device)
    _launch(grad, out)
    return out


def _launch(grad: torch.Tensor, out: torch.Tensor) -> None:
    """Launch K2 on tensors `upsample2x_backward` has checked."""
    global launches
    n, c, h, w = out.shape
    dev = grad.device
    with torch.cuda.device(dev):
        err = _library().upsample2x_backward_launch(
            DTYPES.index(grad.dtype), grad.data_ptr(), out.data_ptr(), n * c, h, w,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"upsample2x_backward kernel launch failed: CUDA error {err}")
    launches += 1


class Upsample2x(torch.autograd.Function):
    """Bilinear x2 (align_corners=False): the forward is aten's
    `upsample_bilinear2d` with the arguments `F.interpolate(x,
    scale_factor=2, mode="bilinear")` passes it (a gather, deterministic),
    the backward `upsample2x_backward` on the gradient made NCHW contiguous.
    The forward calls aten itself because under deterministic mode
    `F.interpolate` swaps in a decomposition of index and add kernels for a
    CUDA input: 8.0 ms of a fundus step's device time against the aten
    kernel's 5.5 ms (chip_smoke.py's profile, NVIDIA H100 80GB HBM3,
    700.00 W)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return torch.ops.aten.upsample_bilinear2d.vec(x, None, False, [2.0, 2.0])

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return upsample2x_backward(grad.contiguous())
