"""The port's CUDA kernels: their libraries, their launch and their launch
counts.

Each kernel source `csrc/<name>.cu` is built with nvcc for sm_90a into a
shared library with a plain C interface, at first use on the machine with
the card, never at import (`native/build.py`), and loaded with ctypes.
Every C entry takes, after its own arguments, the address of its slot in
the launch counter on its device and the stream; `launch` appends both.

The launch counter is one int64 tensor a device with a slot a kernel
(`COUNTERS`): each kernel adds one to its slot as it runs, so a CUDA
graph's replays count too.  An entry whose kernels run in sequence takes
the first of their consecutive slots.  `launch_counts()` reads them summed
over devices, `zero_launch_counts()` sets them to 0.
"""
from __future__ import annotations

import ctypes
import os
import shutil
from typing import Dict, Mapping, Sequence

import torch

from ramdsir_tpu_torch.native.build import Library

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
COUNTERS = (
    "ram_mix.strided", "ram_mix.full_vec", "ram_mix.delta_flat",  # K1, by code path
    "upsample2x.backward", "upsample2x.forward",  # K2, K3
    "batch_norm.stats", "batch_norm.forward", "batch_norm.backward_reduce", "batch_norm.backward",
)
_counts: Dict[torch.device, torch.Tensor] = {}  # per device, (len(COUNTERS),) int64


def source_path(name: str) -> str:
    """The path of csrc/<name>."""
    return os.path.join(_PKG, "csrc", name)


def nvcc() -> str:
    """The nvcc to build with: $CUDA_HOME's, the one on PATH, or the
    toolkit's default install."""
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    return "nvcc"


def kernel_library(source: str, entries: Mapping[str, Sequence]) -> Library:
    """The nvcc library of the kernel source at `source`, binding each C
    entry of `entries` with its own argument types, then the counter slot's
    address and the stream, returning a CUDA error code."""
    tail = [ctypes.c_void_p, ctypes.c_void_p]
    return Library(source, nvcc(), NVCC_FLAGS, {e: (ctypes.c_int, [*args, *tail]) for e, args in entries.items()})


def launch(library: Library, entry: str, counter: str, device: torch.device, *args) -> None:
    """Call the C entry `entry` of `library` on `device` with `args`, the
    address of the slot `counter` of the device's launch counter and the
    current stream; a nonzero return raises."""
    counts = _counts.get(device)
    if counts is None:
        # a CUDA graph keeps the counter's address, so it is made before a
        # capture: made during one, its zeroing would be captured too
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the launch counter is made before a CUDA graph capture, not during one")
        counts = _counts[device] = torch.zeros(len(COUNTERS), dtype=torch.int64, device=device)
    slot = counts.data_ptr() + COUNTERS.index(counter) * counts.element_size()
    with torch.cuda.device(device):
        err = getattr(library.load(), entry)(*args, slot, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed, CUDA error {err}")


def launch_counts() -> Dict[str, int]:
    """How often each kernel ran on the card (`COUNTERS`), summed over
    devices; reading them waits for the devices."""
    totals = dict.fromkeys(COUNTERS, 0)
    for device, counts in _counts.items():
        torch.cuda.synchronize(device)
        for name, k in zip(COUNTERS, counts.tolist()):
            totals[name] += k
    return totals


def zero_launch_counts() -> None:
    """Set every launch count to 0, after the kernels already launched."""
    for device, counts in _counts.items():
        torch.cuda.synchronize(device)
        counts.zero_()
