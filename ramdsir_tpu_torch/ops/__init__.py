"""The losses and RAM functions
re-exported as the JAX package's `ramdsir_tpu/ops/__init__.py` re-exports
them, where the port has the counterpart.  Each resolves at first access
(PEP 562): the loader workers import `ops.image` and must not import torch.
"""
import importlib

_EXPORTS = {
    "bce_loss": "ramdsir_tpu_torch.ops.losses",
    "cross_entropy_loss": "ramdsir_tpu_torch.ops.losses",
    "dice_loss": "ramdsir_tpu_torch.ops.losses",
    "dice_loss_multi": "ramdsir_tpu_torch.ops.losses",
    "kd_loss": "ramdsir_tpu_torch.ops.losses",
    "mse_loss": "ramdsir_tpu_torch.ops.losses",
    "amplitude_spectrum": "ramdsir_tpu_torch.ops.ram",
    "low_freq_band_mask": "ramdsir_tpu_torch.ops.ram",
    "ram_mixup": "ramdsir_tpu_torch.ops.ram",
    "sample_ram_ratios": "ramdsir_tpu_torch.ops.ram",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)
