"""Weights between the JAX package's parameter trees and this package's
modules, and the reference's checkpoint format (PyTorch port of
`ramdsir_tpu/utils/torch_compat.py`).

The JAX trees are nested dicts of numpy arrays, NHWC, conv kernels
(kh, kw, in, out), norms under flax's auto-named submodules
(`bn1.BatchNorm_0.scale`, `bn1.GroupNorm_0.scale`, DSBN banks stacked as
(domains, C); InstanceNorm has no entry).  The torch state dicts are NCHW,
kernels (out, in, kh, kw), `bn1.weight`, `bn1.bns.{d}.weight`.  A TransUNet
(`models/transunet.py`, which the JAX package lacks) is written the same
way: dense kernels (in, out), `LayerNorm_0` / `GroupNorm_0` norms, bias-free
convs without a bias leaf, its position table as the bare leaf
`position_embeddings`.

Both ways: `jax_params_to_torch` / `load_jax_params` read the JAX trees,
`torch_to_jax_params` writes them from the modules (the trainer's
{encoder, seg_decoder, rec_decoder}, or one zoo model of `models/unet.py`,
whose tree is its own: `Discriminator`'s InstanceNorms have no entry), and
`torch_adam_to_jax` / `jax_adam_to_torch` carry Adam's moments as optax's
`ScaleByAdamState` ({count, mu, nu}, the moments in the params tree's
layout; count is torch's per-parameter `step`: a CPU tensor in the plain
Adam, a float32 tensor on the parameters' card in the capturable one that
`train.state.init_state` builds there).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ramdsir_tpu_torch.models.norm import BatchNorm, DomainSpecificBatchNorm

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
        if parts[-1] == "kernel":  # conv: (kh, kw, in, out) -> (out, in, kh, kw); dense: (in, out) -> (out, in)
            sd[".".join(parts[:-1]) + ".weight"] = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
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


def load_jax_params(models: Union[nn.Module, Mapping[str, nn.Module]], params: Mapping, batch_stats: Mapping) -> None:
    """Load the JAX trees into `models` in place, strictly per module;
    modules that were not built (the eval CLIs build no rec decoder) are
    not read.  `models` one module (a zoo model): the trees are that
    module's own, {encoder, decoder, ...}."""
    if isinstance(models, nn.Module):
        models = {"model": models}
        params, batch_stats = {"model": params}, {"model": batch_stats}
    sds = jax_params_to_torch({name: params[name] for name in models}, batch_stats)
    for name, module in models.items():
        module.load_state_dict(sds[name], strict=True)


_LAYERS = (nn.Conv2d, nn.Linear, BatchNorm, DomainSpecificBatchNorm, nn.GroupNorm, nn.LayerNorm)


def _layers(module: nn.Module, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Optional[nn.Module]]]:
    """(path, layer) of every conv, linear and norm with parameters under
    `module` (a DSBN bank is one layer), and (path, None) of a parameter
    held by a module that is no such layer (TransUNet's position table)."""
    for name, _ in module.named_parameters(recurse=False):
        yield prefix + (name,), None
    for name, child in module.named_children():
        path = prefix + (name,)
        if isinstance(child, _LAYERS):
            yield path, child
        else:
            yield from _layers(child, path)


def _put(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


# torch name -> (collection, flax name) of a norm's tensors
_NORM_FIELDS = (("weight", "params", "scale"), ("bias", "params", "bias"),
                ("running_mean", "batch_stats", "mean"), ("running_var", "batch_stats", "var"))


def _module_to_flax(module: nn.Module, values: Mapping[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """`values` keyed by the module's torch names (its state dict, or one
    Adam moment a parameter, with no running statistics) -> its (params,
    batch_stats) trees in the JAX layout, the inverse of
    `flax_module_to_torch_sd`."""
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for path, layer in _layers(module):
        key = ".".join(path)
        if layer is None:
            _put(trees["params"], path, values[key])
            continue
        if isinstance(layer, (nn.Conv2d, nn.Linear)):  # (out, in, kh, kw) -> (kh, kw, in, out); (out, in) -> (in, out)
            _put(trees["params"], path + ("kernel",), values[f"{key}.weight"].T if isinstance(layer, nn.Linear)
                 else values[f"{key}.weight"].transpose(2, 3, 1, 0))
            if layer.bias is not None:
                _put(trees["params"], path + ("bias",), values[f"{key}.bias"])
            continue
        dsbn = isinstance(layer, DomainSpecificBatchNorm)
        sub = f"{type(layer).__name__}_0"  # flax's auto-name of the norm
        for src, collection, dst in _NORM_FIELDS:
            keys = [f"{key}.bns.{d}.{src}" for d in range(len(layer.bns))] if dsbn else [f"{key}.{src}"]
            if keys[0] in values:  # a DSBN bank is stacked to (domains, C)
                arr = np.stack([values[k] for k in keys]) if dsbn else values[keys[0]]
                _put(trees[collection], path + (sub, dst), arr)
    return trees["params"], trees["batch_stats"]


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def torch_to_jax_params(models: Union[nn.Module, Mapping[str, nn.Module]]) -> Tuple[Dict, Dict]:
    """The modules -> the JAX TrainState's (params, batch_stats) trees of
    numpy arrays, keyed as `ramdsir_tpu.train.state.init_state` keys them;
    one module (a zoo model) -> its own trees."""
    if isinstance(models, nn.Module):
        return _module_to_flax(models, {k: _numpy(v) for k, v in models.state_dict().items()})
    params, batch_stats = {}, {}
    for name, module in models.items():
        sd = {k: _numpy(v) for k, v in module.state_dict().items()}
        params[name], batch_stats[name] = _module_to_flax(module, sd)
    return params, batch_stats


def torch_adam_to_jax(models: Mapping[str, nn.Module], optimizer: torch.optim.Adam) -> Dict[str, Any]:
    """The Adam state of `models`' parameters as optax's {count, mu, nu};
    a parameter with no state yet (a fresh optimizer) gives zero moments,
    and count is 0 when none has any.  The step count is read wherever it
    lies (on the card for a capturable Adam)."""
    count = 0
    mu, nu = {}, {}
    for name, module in models.items():
        moments: Dict[str, Dict[str, np.ndarray]] = {"exp_avg": {}, "exp_avg_sq": {}}
        for key, p in module.named_parameters():
            st = optimizer.state.get(p)
            if st:
                count = int(st["step"].item())
            for field, values in moments.items():
                values[key] = _numpy(st[field]) if st else np.zeros(tuple(p.shape), np.float32)
        mu[name] = _module_to_flax(module, moments["exp_avg"])[0]
        nu[name] = _module_to_flax(module, moments["exp_avg_sq"])[0]
    return {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}


def jax_adam_to_torch(models: Mapping[str, nn.Module], optimizer: torch.optim.Adam, opt_state: Mapping) -> None:
    """Load optax's {count, mu, nu} into `optimizer`, which holds one param
    group a module in `models`' order (`train.state.init_state`).  count 0
    leaves the optimizer's state empty, as a fresh one is.  The step count
    goes where the optimizer keeps it: a float32 tensor on the parameter's
    device for a capturable Adam (torch's `load_state_dict` puts it there),
    a CPU tensor otherwise."""
    groups = optimizer.state_dict()["param_groups"]
    if len(groups) != len(models):
        raise ValueError(f"{len(groups)} param groups for {len(models)} modules")
    count = int(opt_state["count"])
    mu = jax_params_to_torch({name: opt_state["mu"][name] for name in models}, {})
    nu = jax_params_to_torch({name: opt_state["nu"][name] for name in models}, {})
    state = {}
    for group, (name, module) in zip(groups, models.items()):
        keys = [key for key, _ in module.named_parameters()]
        if len(keys) != len(group["params"]):
            raise ValueError(f"{name}: {len(group['params'])} parameters in its group, {len(keys)} in the module")
        if count:
            for idx, key in zip(group["params"], keys):
                state[idx] = {"step": torch.tensor(float(count)), "exp_avg": mu[name][key], "exp_avg_sq": nu[name][key]}
    optimizer.load_state_dict({"state": state, "param_groups": groups})


def export_torch_checkpoint(path: str, models: Mapping[str, torch.nn.Module]) -> None:
    """Write the reference's checkpoint format:
    {"<name>_state_dict": state_dict} for each of the given modules, on the
    CPU."""
    payload: Dict[str, Any] = {
        f"{name}_state_dict": {k: v.detach().cpu() for k, v in m.state_dict().items()}
        for name, m in models.items()
    }
    torch.save(payload, path)
