"""The datasets and loaders
re-exported as the JAX package's `ramdsir_tpu/data/__init__.py` re-exports
them, where the port has the counterpart.  Each resolves at first access
(PEP 562): the loader workers import `data.transforms` through this package and
load no more than they use.
"""
import importlib

_EXPORTS = {
    "FundusDataset": "ramdsir_tpu_torch.data.fundus",
    "FundusMultiDataset": "ramdsir_tpu_torch.data.fundus",
    "ProstateDataset": "ramdsir_tpu_torch.data.prostate",
    "ProstateMultiDataset": "ramdsir_tpu_torch.data.prostate",
    "DataLoader": "ramdsir_tpu_torch.data.loaders",
    "MultiDomainIterator": "ramdsir_tpu_torch.data.loaders",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)
