"""Weights between the JAX package's parameter trees and this package's
modules, and the reference's checkpoint format (PyTorch port of
`ramdsir_tpu/utils/torch_compat.py`).

The JAX trees are nested dicts of numpy arrays, NHWC, conv kernels
(kh, kw, in, out), norms under flax's auto-named submodules
(`bn1.BatchNorm_0.scale`, DSBN banks stacked as (domains, C)).  The torch
state dicts are NCHW, kernels (out, in, kh, kw), `bn1.weight`,
`bn1.bns.{d}.weight`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# flax names norm submodules by class: a path part with one of these
# prefixes belongs to a norm layer, everything else is a conv
_NORM_MODULE_PREFIXES = (
    "BatchNorm",
    "DomainSpecificBatchNorm",
    "GroupNorm",
    "InstanceNorm",
    "LayerNorm",
)


def _is_norm_path(parts) -> bool:
    return any(p.startswith(_NORM_MODULE_PREFIXES) for p in parts)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _norm_entries(parts, arr: np.ndarray, suffix: str, path: str) -> Dict[str, np.ndarray]:
    base = ".".join(p for p in parts[:-1] if not p.startswith(_NORM_MODULE_PREFIXES))
    if "DomainSpecificBatchNorm" in path:
        return {f"{base}.bns.{d}.{suffix}": arr[d] for d in range(arr.shape[0])}
    return {f"{base}.{suffix}": arr}


def flax_module_to_torch_sd(params: Mapping, batch_stats: Mapping) -> Dict[str, np.ndarray]:
    """One module's {params, batch_stats} trees -> a torch-layout state dict
    of numpy arrays."""
    sd: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(params).items():
        parts = path.split(".")
        if parts[-1] == "kernel":  # conv: (kh, kw, in, out) -> (out, in, kh, kw)
            sd[".".join(parts[:-1]) + ".weight"] = arr.transpose(3, 2, 0, 1)
        elif parts[-1] in ("scale", "bias") and _is_norm_path(parts):
            sd.update(_norm_entries(parts, arr, "weight" if parts[-1] == "scale" else "bias", path))
        else:
            sd[path] = arr
    for path, arr in _flatten(batch_stats).items():
        parts = path.split(".")
        suffix = "running_mean" if parts[-1] == "mean" else "running_var"
        sd.update(_norm_entries(parts, arr, suffix, path))
    return sd


def jax_params_to_torch(params: Mapping, batch_stats: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX TrainState's params and batch_stats (as numpy trees) ->
    {encoder, seg_decoder, rec_decoder: state_dict} for load_state_dict."""
    return {
        name: {
            k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flax_module_to_torch_sd(params[name], batch_stats.get(name, {})).items()
        }
        for name in params
    }


def export_torch_checkpoint(path: str, models: Mapping[str, torch.nn.Module]) -> None:
    """Write the reference's checkpoint format:
    {"<name>_state_dict": state_dict} for each of the given modules, on the
    CPU."""
    payload: Dict[str, Any] = {
        f"{name}_state_dict": {k: v.detach().cpu() for k, v in m.state_dict().items()}
        for name, m in models.items()
    }
    torch.save(payload, path)
