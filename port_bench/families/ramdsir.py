"""The RAM-DSIR model family: what the train and eval kinds take from a
configuration whose `reference` is "ramdsir" (the U-Net of
`reference/ramdsir.py`).

A family is a module port_bench/families/<reference>.py, found by the
configuration's `reference` name, with:

  program_config(c, device, save_path, data_root)  the port's TrainConfig
  make_data(c, seed, device)                       the train stack
  step_draws(c, gen, b)                            one step's draws, in the
                                                   program's order
  reference_data(c, data)                          the stack as the
                                                   reference reads it
  step_counts(c)                                   a step's work: `flops`
                                                   (the model's FLOPs, read
                                                   by step_mfu.train) and
                                                   the bytes the family's
                                                   rooflines read"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from port_bench.lib import common, synth
from port_bench.lib.counts import step_counts  # noqa: F401  (every convolution both ways; the rooflines' bytes)


def program_config(c: Mapping, device: str, save_path: str, data_root: str = "unused"):
    """The port's TrainConfig for configuration file `c`, one process: these
    keys of the file, then its `program` object (`common.port_config`)."""
    return common.port_config(c, dict(
        data_root=data_root, dataset=c["dataset"], lr=c["lr"], epochs=c["epochs"],
        domain_idxs=tuple(c["domain_idxs"]), test_domain_idx=c["test_domain_idx"],
        in_channels=c["in_channels"], num_classes=c["num_classes"], lambda_rec=c["lambda_rec"],
        ram=c["ram"], rec=c["rec"], is_out_domain=c["is_out_domain"], consistency=c["consistency"],
        consistency_type=c["consistency_type"], image_size=c["image_size"], compute_dtype=c["compute_dtype"],
        test_batch_size=c["test_batch_size"], log_images_every=c["log_images_every"], num_devices=1,
        save_path=save_path, device=device,
    ))


def make_data(c: Mapping, seed: int, device) -> Dict[str, np.ndarray]:
    """The train stack on the host, drawn on `device`: images, masks and the
    rows of each source domain (`sizes`)."""
    s = c["image_size"]
    sizes = [int(n) for n in c["train_per_domain"]]
    if c["dataset"] == "fundus":
        images, masks = synth.fundus_pairs(seed, sum(sizes), s, device)
    else:
        images, masks = synth.prostate_slices(seed, sum(sizes), s, device)
    return {"images": images, "masks": masks, "sizes": sizes}


def step_draws(c: Mapping, gen: torch.Generator, b: int) -> Dict[str, torch.Tensor]:
    """One step's draws in the order the program draws them (a frozen copy
    of `train.steps.sample_step_draws`): the scale-crop's apply, factors
    and offsets (fundus), then the RAM ratios randint(1, 10) / 10."""
    d = {}
    if c["dataset"] == "fundus":
        d["crop_apply"] = torch.rand(b, generator=gen) < 0.5
        d["crop_u"] = 1.0 + 0.5 * torch.rand(b, 2, generator=gen)
        d["crop_off"] = torch.rand(b, 2, generator=gen)
    d["ratio"] = torch.randint(1, 11, (b,), generator=gen).float() / 10.0
    return d


def reference_data(c: Mapping, data: Mapping) -> Dict[str, torch.Tensor]:
    out = {"images": torch.from_numpy(data["images"]), "masks": torch.from_numpy(data["masks"])}
    if c["dataset"] == "fundus":
        out["donors"] = out["images"]
    return out
