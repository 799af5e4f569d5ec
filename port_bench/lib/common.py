"""What the cell runners share: the port's configuration from a
configuration file, its weights from the benchmark's, device helpers and
the comparison arithmetic."""
from __future__ import annotations

import statistics
from typing import Dict, Mapping, Sequence

import numpy as np
import torch


def train_config(c: Mapping, device: str, save_path: str, data_root: str = "unused"):
    """The port's TrainConfig for configuration file `c`, one process."""
    from ramdsir_tpu_torch.config import TrainConfig

    return TrainConfig(
        data_root=data_root, dataset=c["dataset"], lr=c["lr"], epochs=c["epochs"],
        domain_idxs=tuple(c["domain_idxs"]), test_domain_idx=c["test_domain_idx"],
        in_channels=c["in_channels"], num_classes=c["num_classes"], lambda_rec=c["lambda_rec"],
        ram=c["ram"], rec=c["rec"], is_out_domain=c["is_out_domain"], consistency=c["consistency"],
        consistency_type=c["consistency_type"], image_size=c["image_size"], compute_dtype=c["compute_dtype"],
        test_batch_size=c["test_batch_size"], log_images_every=c["log_images_every"], num_devices=1,
        save_path=save_path, device=device,
    )


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
