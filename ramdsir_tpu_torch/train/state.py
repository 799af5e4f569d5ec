"""Train state: the three modules, Adam, and the step counter (PyTorch port
of `ramdsir_tpu/train/state.py`).

The modules and the optimizer update in place; `TrainState.step` counts the
optimizer steps taken.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch
import torch.nn as nn

from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.models.unet import Decoder, Encoder, RecDecoder, init_weights
from ramdsir_tpu_torch.utils.device import resolve_device

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # reference train.py:573-587


@dataclasses.dataclass
class TrainState:
    models: Dict[str, nn.Module]  # encoder, seg_decoder[, rec_decoder]
    optimizer: torch.optim.Adam  # one param group per module, in models' order
    step: int = 0


def build_models(cfg: TrainConfig) -> Dict[str, nn.Module]:
    """Encoder / Decoder / RecDecoder at width n=16 (reference train.py:568-572)."""
    models: Dict[str, nn.Module] = {
        "encoder": Encoder(
            c=cfg.in_channels, norm=cfg.norm, activation=cfg.activation, s2d_levels=cfg.s2d_levels
        ),
        "seg_decoder": Decoder(
            num_classes=cfg.num_classes, norm=cfg.norm, activation=cfg.activation,
            s2d_levels=cfg.s2d_levels,
        ),
    }
    if cfg.rec:
        models["rec_decoder"] = RecDecoder(
            num_classes=cfg.in_channels, norm="dsbn", activation=cfg.activation,
            num_domains=cfg.num_domains, s2d_levels=cfg.s2d_levels,
        )
    return models


def init_state(
    cfg: TrainConfig, generator: torch.Generator, device: Union[str, torch.device] = "cuda"
) -> TrainState:
    """Models initialised from `generator` (on the CPU, so the weights do not
    depend on the device), moved to `device`, with Adam over them.  Each
    module is one param group; the train step sets each group's lr every
    step (poly schedule, encoder x0.5 under --rec)."""
    dev = resolve_device(device)
    cfg = cfg.resolve()
    models = build_models(cfg)
    for m in models.values():
        init_weights(m, generator)
        m.to(dev).train()
    optimizer = torch.optim.Adam(
        [{"params": m.parameters(), "lr": cfg.lr} for m in models.values()],
        lr=cfg.lr, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
    )
    return TrainState(models=models, optimizer=optimizer)
