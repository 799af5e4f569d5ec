"""Building the port's CUDA kernels: nvcc for sm_90a into a shared library
with a plain C interface, loaded with ctypes by the kernel's wrapper.

A library is built at first use on the machine with the card, never at
import, into `ramdsir_tpu_torch/_build/`, keyed on a hash of the source and
the flags.  It is compiled under a private name and renamed, so processes
building at once never load a half-written file.  A failed build raises.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def source_path(name: str) -> str:
    """The path of csrc/<name>."""
    return os.path.join(_PKG, "csrc", name)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels (csrc/*.cu) are compiled on the machine with the card")


def build_library(source: str) -> str:
    """Compile `source` unless a library built from the same source and
    flags exists; returns the library's path."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, source], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path
