"""K2 and K3: the bilinear x2 upsample (align_corners=False) both ways,
hand-written CUDA kernels and their plain PyTorch versions, and the autograd
Function that uses them.

torch's CUDA backward of `F.interpolate(..., mode="bilinear")` adds with
atomics, so it is not repeatable, and under
`torch.use_deterministic_algorithms(True)` torch refuses it.  K2
(`csrc/upsample2x.cu`) computes the same gradient as a gather with fixed
weights and a fixed summation order.  K3, in the same source, is the
forward: aten's nested bilinear form computed exactly, in place of aten's
NCHW forward kernel, which spreads the planes over too few threads.
Neither has a TPU counterpart: the JAX package's upsample
(`jax.image.resize`) is differentiated by XLA.  They are built with nvcc at
first use on the card and bound with ctypes (`ops/cuda_build.py`).

`upsample2x_forward` and `upsample2x_backward` take the plain versions for
tensors on the CPU (the tests) and launch the kernels for CUDA tensors; a
CUDA tensor they cannot take raises, they never fall back.  Each kernel
counts its runs on the card, a graph's replays included:
`cuda_build.launch_counts()["upsample2x.backward"]` (K2) and
`["upsample2x.forward"]` (K3).  `Upsample2x` is the upsample with both
kernels on the card; `models/unet.upsample2x` takes it for every
tensor `kernels_take` accepts, and for every tensor while torch's
deterministic mode is on.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ramdsir_tpu_torch.ops import cuda_build

SOURCE = cuda_build.source_path("upsample2x.cu")
DTYPES = (torch.float32, torch.bfloat16)  # the codes of the launch functions
VEC_COLUMNS = {torch.float32: 4, torch.bfloat16: 8}  # input columns a thread takes on the 16-byte path
ENTRIES = {  # C entry: its counter
    "upsample2x_backward_launch": "upsample2x.backward",
    "upsample2x_forward_launch": "upsample2x.forward",
}
LIBRARY = cuda_build.kernel_library(SOURCE, dict.fromkeys(ENTRIES, [
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]))


# --- plain versions ----------------------------------------------------------------


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


def _axis_taps(n: int, dtype: torch.dtype, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """aten's source indices and weights for the 2n outputs of an axis of
    n inputs: s = max(0, (o + 0.5)/2 - 0.5), i0 = floor(s), i1 = min(i0 + 1,
    n - 1), l1 = s - i0, l0 = 1 - l1 (all exact: l1 is 0, 0.25 or 0.75)."""
    o = torch.arange(2 * n, dtype=torch.float64, device=device)
    s = ((o + 0.5) / 2 - 0.5).clamp(min=0)
    i0 = s.floor()
    l1 = s - i0
    i0 = i0.long()
    return i0, (i0 + 1).clamp(max=n - 1), (1 - l1).to(dtype), l1.to(dtype)


def upsample2x_forward_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: (N, C, H, W) -> (N, C, 2H,
    2W), y = lh0*(lw0*x[i0,j0] + lw1*x[i0,j1]) + lh1*(lw0*x[i1,j0] +
    lw1*x[i1,j1]) with aten's indices and weights, each product and sum
    rounded on its own, zero-weight terms kept, accumulated in float32
    (float64 for a float64 input) and rounded once to the input's dtype."""
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xa = x.to(acc_dtype)
    h0, h1, lh0, lh1 = _axis_taps(x.shape[-2], acc_dtype, x.device)
    w0, w1, lw0, lw1 = _axis_taps(x.shape[-1], acc_dtype, x.device)

    def columns(rows: torch.Tensor) -> torch.Tensor:
        return lw0 * rows[..., w0] + lw1 * rows[..., w1]

    top, bottom = columns(xa[..., h0, :]), columns(xa[..., h1, :])
    return (lh0[:, None] * top + lh1[:, None] * bottom).to(x.dtype)


# --- the wrappers --------------------------------------------------------------------


def _refusal(t: torch.Tensor, elements: int) -> Optional[Exception]:
    """Why the wrappers refuse the tensor `t` as it lies, or None.
    `elements` is the input-side count (N*C*H*W), which the kernels index
    in 32 bits.  A CPU tensor takes the plain versions (float64 too);
    anywhere else only K2 and K3 do, on a CUDA tensor in float32 or
    bfloat16, NCHW contiguous."""
    dtypes = "float32 or bfloat16 tensors only (float64 on the CPU)"
    if t.dtype not in DTYPES + (torch.float64,):
        return TypeError(f"{dtypes}, got {t.dtype}")
    if elements >= 2**31:
        return ValueError(f"{elements} elements exceed the kernel's 32-bit indices")
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        return ValueError(f"no kernel for device {t.device}")
    if t.dtype not in DTYPES:
        return TypeError(f"{dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        return ValueError("the tensor must be NCHW contiguous")
    return None


def _check(t: torch.Tensor, name: str, elements: int) -> None:
    err = _refusal(t, elements)
    if err is not None:
        raise type(err)(f"{name}: {err}")


def kernels_take(x: torch.Tensor) -> bool:
    """Whether K3 and K2 take the input `x` as it lies: a non-empty 4-D
    CUDA tensor that the wrappers accept (`_refusal`).  A channels-last
    tensor (eval's activations) is not taken: aten's NHWC kernel reads it
    without a transpose."""
    return x.device.type == "cuda" and x.dim() == 4 and x.numel() > 0 and _refusal(x, x.numel()) is None


def vector_path(t: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether a launch on input `t` and output `out` takes the 16-byte
    path: the input's width a multiple of the columns a thread takes and
    both pointers on 16 bytes.  Otherwise it takes the scalar edge path of
    the same kernel."""
    w = min(t.shape[-1], out.shape[-1])  # the input side's width
    return w % VEC_COLUMNS[t.dtype] == 0 and t.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0


def upsample2x_backward(grad: torch.Tensor) -> torch.Tensor:
    """The input gradient (N, C, H, W) of the bilinear x2 upsample
    (align_corners=False) from its output gradient (N, C, 2H, 2W)."""
    if grad.dim() != 4 or grad.shape[2] % 2 or grad.shape[3] % 2 or 0 in grad.shape[2:]:
        raise ValueError(f"upsample2x_backward: expected (N, C, 2H, 2W), got {tuple(grad.shape)}")
    n, c, h2, w2 = grad.shape
    _check(grad, "upsample2x_backward", n * c * (h2 // 2) * (w2 // 2))
    if grad.device.type == "cpu":
        return upsample2x_backward_plain(grad)
    out = torch.empty((n, c, h2 // 2, w2 // 2), dtype=grad.dtype, device=grad.device)
    _launch("upsample2x_backward_launch", grad, out)
    return out


def upsample2x_forward(x: torch.Tensor) -> torch.Tensor:
    """The bilinear x2 upsample (align_corners=False) of (N, C, H, W) to
    (N, C, 2H, 2W), as `F.interpolate(x, scale_factor=2, mode="bilinear")`
    computes it."""
    if x.dim() != 4 or 0 in x.shape[2:]:
        raise ValueError(f"upsample2x_forward: expected (N, C, H, W) with H, W >= 1, got {tuple(x.shape)}")
    n, c, h, w = x.shape
    _check(x, "upsample2x_forward", n * c * h * w)
    if x.device.type == "cpu":
        return upsample2x_forward_plain(x)
    out = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    _launch("upsample2x_forward_launch", x, out)
    return out


def _launch(entry: str, src: torch.Tensor, dst: torch.Tensor) -> None:
    """Launch K2 or K3 (`entry`) on tensors its wrapper has checked; the
    input side (N, C, H, W) is the smaller of the two."""
    small = src if src.numel() <= dst.numel() else dst
    n, c, h, w = small.shape
    cuda_build.launch(LIBRARY, entry, ENTRIES[entry], src.device,
                      DTYPES.index(src.dtype), int(vector_path(src, dst)), src.data_ptr(), dst.data_ptr(), n * c, h, w)


class Upsample2x(torch.autograd.Function):
    """Bilinear x2 (align_corners=False): on CUDA tensors K3 forward and K2
    backward, the input and the gradient made NCHW contiguous (a
    channels-last input reaches it only under deterministic mode: eval's
    activations, from the predict path's permuted NHWC images).  On CPU tensors the
    forward stays aten's, the one `F.interpolate` runs on the default path,
    and the backward is K2's plain version: on the CPU the mode then changes
    only the backward's summation order, as before K3 existed (a training
    step's gradients move far more under ulp-level changes of its forward
    than under that order, tests/test_torch_port_upsample.py).  On the card
    it does not call `F.interpolate`, because under deterministic mode that
    swaps in a decomposition of index and add kernels (8.0 ms of a fundus
    step's device time against aten's kernel's 5.5 ms, chip_smoke.py's
    profile), and aten's NCHW forward kernel itself runs at ~4% of its
    bytes bound: a fundus float32 step's 8 forwards take 6.26 ms there
    against K3's 0.34 ms and a bound of 0.23 ms (tools/upsample_study.py,
    kernels back to back; NVIDIA H100 80GB HBM3, 700.00 W)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return torch.ops.aten.upsample_bilinear2d.vec(x, None, False, [2.0, 2.0])
        return upsample2x_forward(x.contiguous())

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return upsample2x_backward(grad.contiguous())
