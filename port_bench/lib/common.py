"""What the cell runners share: the port's configuration from a family's
fields and a configuration file's `program` options, its weights from the
benchmark's, device helpers and the comparison arithmetic."""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from port_bench.lib.spec import RunFailed


def port_config(c: Mapping, fields: Mapping):
    """The port's TrainConfig from a family's `fields` (`families/<reference>.py`'s
    `program_config`) and, on top, configuration file `c`'s `program`
    object, each key a TrainConfig field passed as given.  The run fails on
    a key that names no field or that the family already sets, and on a
    TrainConfig attribute that differs from the file's top-level key of the
    same name (`batch_size_list`, which `global_batch` changes, included):
    the counts and the reference read the file."""
    from ramdsir_tpu_torch.config import TrainConfig

    program = dict(c.get("program") or {})
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    for k in program:
        if k not in known:
            raise RunFailed(f"the configuration's program option {k!r} names no field of the port's TrainConfig")
        if k in fields:
            raise RunFailed(f"the configuration's program option {k!r} is a field its model family sets")
    cfg = TrainConfig(**dict(fields, **program))
    for k, want in c.items():
        if k == "program" or not hasattr(cfg, k) or callable(getattr(cfg, k)):
            continue
        got = getattr(cfg, k)
        if (list(got) if isinstance(got, tuple) else got) != want:
            raise RunFailed(f"the port's TrainConfig has {k} = {got!r} where the configuration file states {want!r}")
    return cfg


def load_weights(models: Mapping[str, torch.nn.Module], weights: Mapping[str, torch.Tensor], strict=True) -> None:
    """Named weights ("encoder.convd1.conv1.weight", ...) into the port's
    modules; with strict, every module's every entry."""
    for name, m in models.items():
        part = {k[len(name) + 1 :]: v for k, v in weights.items() if k.startswith(name + ".")}
        if part or strict:
            m.load_state_dict(part, strict=strict)


def named_state(models: Mapping[str, torch.nn.Module]) -> Dict[str, torch.Tensor]:
    """Parameters and buffers of the port's modules under the weights' names."""
    out = {}
    for name, m in models.items():
        out.update({f"{name}.{k}": v for k, v in m.state_dict().items()})
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def leaf_gaps(program: Mapping[str, torch.Tensor], reference: Mapping[str, torch.Tensor],
              names: Sequence[str]) -> list:
    """Per leaf | |p| - |r| | / max(|r|, median leaf |r|), the norms the
    leaves' Frobenius norms: the gap of the norms, not the norm of the
    difference, against the larger of the leaf's and the median leaf's."""
    pn = {k: float(torch.linalg.vector_norm(program[k].double())) for k in names}
    rn = {k: float(torch.linalg.vector_norm(reference[k].double())) for k in names}
    med = statistics.median(rn.values())
    return [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names]


def counted_leaves(ref_grads: Mapping[str, torch.Tensor]) -> list:
    """The parameters whose reference gradient norm is at least a thousandth
    of the median leaf's: the others (biases under batch norm) move under
    Adam by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref_grads.items()}
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= 1e-3 * med]


def finite(x: float) -> float:
    return float(x) if np.isfinite(x) else float("inf")
