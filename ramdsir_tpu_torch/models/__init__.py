"""The models
re-exported as the JAX package's `ramdsir_tpu/models/__init__.py` re-exports
them, where the port has the counterpart.  Each resolves at first access
(PEP 562).
"""
import importlib

_EXPORTS = {
    "ConvD": "ramdsir_tpu_torch.models.unet",
    "ConvU": "ramdsir_tpu_torch.models.unet",
    "ConvURec": "ramdsir_tpu_torch.models.unet",
    "Decoder": "ramdsir_tpu_torch.models.unet",
    "Discriminator": "ramdsir_tpu_torch.models.unet",
    "Encoder": "ramdsir_tpu_torch.models.unet",
    "RecDecoder": "ramdsir_tpu_torch.models.unet",
    "Unet2D": "ramdsir_tpu_torch.models.unet",
    "Unet2DDS": "ramdsir_tpu_torch.models.unet",
    "Unet2DMS": "ramdsir_tpu_torch.models.unet",
    "Unet2DMT": "ramdsir_tpu_torch.models.unet",
    "count_params": "ramdsir_tpu_torch.models.unet",
    "BatchNorm": "ramdsir_tpu_torch.models.norm",
    "DomainSpecificBatchNorm": "ramdsir_tpu_torch.models.norm",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)
