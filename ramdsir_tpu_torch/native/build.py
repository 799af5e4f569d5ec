"""Building and loading the port's native libraries: the host libraries of
`native/` (g++) and the CUDA kernels of `csrc/` (nvcc, `ops/cuda_build.py`).

A library is compiled at first use, never at import, into
`ramdsir_tpu_torch/_build/`, keyed on a hash of its source, the compiler
and the flags.  It is compiled under a private name and renamed, so
processes building at once never load a half-written file.  There is no
fallback: a compiler that cannot run, or a failed build, raises.  This
module imports no torch: the loader workers import it through `data/png.py`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Any, Mapping, Optional, Sequence, Tuple

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_lock = threading.Lock()


def build_library(source: str, compiler: str, flags: Sequence[str]) -> str:
    """Compile `source` with `compiler` and `flags` into a shared library
    unless one built from the same source, compiler and flags exists;
    returns the library's path."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join((compiler, *flags)).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([compiler, *flags, source, "-o", tmp], capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"cannot run {compiler} to build {source}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed on {source}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@dataclasses.dataclass
class Library:
    """The library built from `source` by `compiler` with `flags`, loaded
    once at first use; `signatures` holds (restype, argtypes) of each C
    function it binds."""

    source: str
    compiler: str
    flags: Tuple[str, ...]
    signatures: Mapping[str, Tuple[Any, Sequence[Any]]]
    _cdll: Optional[ctypes.CDLL] = dataclasses.field(default=None, init=False, repr=False, compare=False)

    def path(self) -> str:
        """Build the library unless it is built; returns its path."""
        return build_library(self.source, self.compiler, self.flags)

    def load(self) -> ctypes.CDLL:
        """The loaded library, built on first use."""
        if self._cdll is None:
            with _lock:
                if self._cdll is None:
                    lib = ctypes.CDLL(self.path())
                    for name, (restype, argtypes) in self.signatures.items():
                        fn = getattr(lib, name)
                        fn.restype, fn.argtypes = restype, list(argtypes)
                    self._cdll = lib
        return self._cdll
