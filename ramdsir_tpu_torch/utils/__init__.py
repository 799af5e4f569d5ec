"""The logging and profiling helpers
re-exported as the JAX package's `ramdsir_tpu/utils/__init__.py` re-exports
them, where the port has the counterpart.  Each resolves at first access
(PEP 562).
"""
import importlib

_EXPORTS = {
    "MetricsWriter": "ramdsir_tpu_torch.utils.logging",
    "make_grid": "ramdsir_tpu_torch.utils.logging",
    "StepTimer": "ramdsir_tpu_torch.utils.profiler",
    "trace_context": "ramdsir_tpu_torch.utils.profiler",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)
