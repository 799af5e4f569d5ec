"""Train state: the three modules, Adam, and the step counter (PyTorch port
of `ramdsir_tpu/train/state.py`).

The modules and the optimizer update in place; `TrainState.step` counts the
optimizer steps taken.  `state_to_tree` and `load_state_tree` convert the
whole state to and from the layout of the JAX package's
`flax.serialization.to_state_dict(TrainState)`: {params, batch_stats,
opt_state: {count, mu, nu}, step}, numpy leaves.

On a CUDA device Adam is built capturable (`capturable=True`, each
group's lr a 0-d float32 tensor on the card, its step count a float32
tensor there), so that the train step, Adam's update included, can be
captured into a CUDA graph and replayed (`train.steps`); the eager steps on
the card use the same optimizer, so both run the same kernels.  On the CPU
Adam is the plain one, with float lrs and CPU step counts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
import torch.nn as nn

from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.models import transunet
from ramdsir_tpu_torch.models.unet import Decoder, Encoder, RecDecoder, init_weights
from ramdsir_tpu_torch.utils.device import resolve_device
from ramdsir_tpu_torch.utils.torch_compat import (
    jax_adam_to_torch,
    load_jax_params,
    torch_adam_to_jax,
    torch_to_jax_params,
)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # reference train.py:573-587


@dataclasses.dataclass
class TrainState:
    models: Dict[str, nn.Module]  # encoder, seg_decoder[, rec_decoder]
    optimizer: torch.optim.Adam  # one param group per module, in models' order
    step: int = 0


def build_models(cfg: TrainConfig) -> Dict[str, nn.Module]:
    """Encoder / Decoder / RecDecoder at width n=16 (reference train.py:568-572);
    with cfg.model a TransUNet (`models/transunet.py`), its encoder and CUP
    decoder in the first two slots and the RecDecoder at n = hidden / 16,
    its stages checkpointed under cfg.remat."""
    if cfg.model != "unet":
        encoder, decoder, tcfg = transunet.build(cfg.model, cfg.image_size, cfg.num_classes, remat=cfg.remat)
        models: Dict[str, nn.Module] = {"encoder": encoder, "seg_decoder": decoder}
        n = tcfg.rec_width
    else:
        models = {
            "encoder": Encoder(
                c=cfg.in_channels, norm=cfg.norm, activation=cfg.activation, s2d_levels=cfg.s2d_levels
            ),
            "seg_decoder": Decoder(
                num_classes=cfg.num_classes, norm=cfg.norm, activation=cfg.activation,
                s2d_levels=cfg.s2d_levels,
            ),
        }
        n = 16
    if cfg.rec:
        models["rec_decoder"] = RecDecoder(
            n=n, num_classes=cfg.in_channels, norm="dsbn", activation=cfg.activation,
            num_domains=cfg.num_domains, s2d_levels=cfg.s2d_levels,
        )
    return models


def init_state(
    cfg: TrainConfig, generator: torch.Generator, device: Union[str, torch.device] = "cuda"
) -> TrainState:
    """Models initialised from `generator` (on the CPU, so the weights do not
    depend on the device; a TransUNet's encoder and decoder as TransUNet
    initialises them, `models.transunet.init_weights`), moved to `device`,
    with Adam over them (capturable on a CUDA device, the module docstring).  Each module is one param
    group; the train step sets each group's lr every step (poly schedule,
    encoder x0.5 under --rec)."""
    dev = resolve_device(device)
    cfg = cfg.resolve()
    models = build_models(cfg)
    for name, m in models.items():
        (transunet.init_weights if cfg.model != "unet" and name != "rec_decoder" else init_weights)(m, generator)
        m.to(dev).train()
    capturable = dev.type == "cuda"
    lr = lambda: torch.tensor(cfg.lr, dtype=torch.float32, device=dev) if capturable else cfg.lr
    optimizer = torch.optim.Adam(
        [{"params": m.parameters(), "lr": lr()} for m in models.values()],
        lr=cfg.lr, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS, capturable=capturable,
    )
    return TrainState(models=models, optimizer=optimizer)


def state_to_tree(state: TrainState) -> Dict[str, Any]:
    """The whole state as the JAX TrainState's state dict."""
    params, batch_stats = torch_to_jax_params(state.models)
    return {
        "params": params,
        "batch_stats": batch_stats,
        "opt_state": torch_adam_to_jax(state.models, state.optimizer),
        "step": np.asarray(state.step, np.int32),
    }


def load_state_tree(state: TrainState, tree: Mapping[str, Any]) -> None:
    """Load a JAX TrainState's state dict into `state` in place.  A tree
    without an optimizer state (a weights-only checkpoint) keeps `state`'s
    own, as the JAX package's `load_checkpoint` keeps its template's."""
    load_jax_params(state.models, tree["params"], tree["batch_stats"])
    if tree.get("opt_state"):
        jax_adam_to_torch(state.models, state.optimizer, tree["opt_state"])
    state.step = int(tree["step"])
