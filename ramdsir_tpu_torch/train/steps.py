"""The train step and the predictor (PyTorch port of
`ramdsir_tpu/train/steps.py:50-436` and `:509-553`), fundus and prostate.

One call covers the reference's hot-loop iteration (code/train.py:223-331
fundus, :393-498 prostate): RAM on the clean batch, one encoder +
seg-decoder forward over the concatenation [clean; RAM] with per-half BN
statistics, the supervised losses on both halves, 0.5 x KD consistency, the
restoration decoder with domain-specific BN over the whole RAM bottleneck,
and Adam with the poly LR (encoder at lr x 0.5 under --rec).

Heads: fundus has two sigmoid channels (BCE + dice).  Prostate's 2-class
softmax head is computed from the logit difference l = logits[:, 1] -
logits[:, 0], flattened to (B, H*W): cross-entropy over two classes is BCE
on l, the class-1 dice is the dice of sigmoid(l), and the KD / MSE
consistency has its binary form (ops/losses.py), as in the JAX package.

Randomness: every draw of a step (the RAM ratios and, with the fundus device
pipeline, the scale-crop's apply/factor/offset draws) comes from
`sample_step_draws`, in one place, from one Generator; a caller may pass the
draws instead (the tests pass the numbers the JAX functions drew).

Layout: batch dicts are NHWC as in the JAX package; the step works on NCHW
from the encoder on.

Precision (`--compute_dtype`): RAM, and with it K1, runs in float32; only
the encoder's input is cast to the compute dtype, so the U-Net's activations
are bfloat16 under `bfloat16`.  The logits and the restoration output go
back to float32 before the losses, and the restoration MSE reads the
uncast float32 image (`ramdsir_tpu/train/steps.py:114`, `:242`, `:330`).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from ramdsir_tpu_torch.config import CONSISTENCY_WEIGHT, POLY_POWER, TrainConfig
from ramdsir_tpu_torch.data.device_pipeline import gather_and_augment, gather_prostate, sample_crop_draws
from ramdsir_tpu_torch.models.norm import batch_statistics
from ramdsir_tpu_torch.ops.losses import (
    bce_with_logits_loss,
    binary_kd_loss,
    binary_mse_consistency,
    dice_loss,
    kd_loss,
    mse_loss,
)
from ramdsir_tpu_torch.ops.ram import (
    ram_augment_fundus,
    ram_augment_fundus_banded,
    ram_augment_prostate,
    ram_augment_prostate_banded,
    sample_ram_ratios,
)
from ramdsir_tpu_torch.train.state import TrainState


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a --compute_dtype / predict_dtype value."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"unknown dtype {name!r} (use 'float32' or 'bfloat16')")
    return dtypes[name]


def check_supported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for what this port does not run yet, naming
    the ROADMAP.md item."""
    unported = [
        (cfg.dataset != "fundus" and cfg.num_classes != 2,
         f"--dataset {cfg.dataset} --num_classes {cfg.num_classes} (the softmax head)", "off-path variants"),
        (bool(cfg.num_devices) and cfg.num_devices > 1, "--num_devices > 1", "Multi-GPU DDP"),
        (cfg.remat, "--remat", "off-path variants"),
        (bool(cfg.trace_dir), "--trace_dir", "the port's own benchmark"),
        (cfg.norm != "bn", f"--norm {cfg.norm}", "off-path variants"),
        (bool(cfg.global_batch), "--global_batch", "Multi-GPU DDP"),
        (not (cfg.fused_dual and cfg.fused_dsbn), "the non-fused forward", "off-path variants"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md: {item})")
    torch_dtype(cfg.compute_dtype)
    if cfg.consistency and cfg.consistency_type not in ("mse", "kd"):
        raise ValueError(f"unknown consistency_type {cfg.consistency_type!r} (use 'mse' or 'kd')")


def sample_step_draws(
    generator: torch.Generator, batch: int, device: torch.device, crop: bool = True
) -> Dict[str, torch.Tensor]:
    """All of one step's random draws, on `device`: the RAM ratios and, with
    crop=True, the scale-crop's draws."""
    draws = sample_crop_draws(generator, batch) if crop else {}
    draws["ratio"] = sample_ram_ratios(generator, batch)
    return {k: v.to(device) for k, v in draws.items()}


def poly_lr(base_lr: float, step: int, total_iters: int) -> float:
    """The reference sets the schedule after optimizer.step() from the
    pre-increment counter, so step i runs at lr(max(i-1, 0))."""
    return base_lr * (1.0 - max(step - 1, 0) / total_iters) ** POLY_POWER


def make_train_step(
    cfg: TrainConfig,
    total_iters: int,
    batch_size_list: Optional[List[int]] = None,
    device_data: Optional[Mapping[str, torch.Tensor]] = None,
    debug_grads: bool = False,
) -> Callable:
    """Build `train_step(state, batch, generator=None, draws=None) -> metrics`.

    batch (NHWC), fundus: img (B,H,W,3) float [0,255], mask (B,H,W,2) float,
    and either donor_amp (B,2b+1,b+1,3) banded donor amplitudes or donor
    (B,H,W,3) [0,255] donor images.  Prostate: img and donor in [-1, 1],
    mask (B,H,W) integer labels.  With `device_data` (the device pipeline's
    arrays) batch is instead {img_idx, donor_idx} index rows, and the step
    gathers (and for fundus scale-crops) on the device.

    The step updates `state` in place (modules, BN running statistics, Adam,
    state.step) and returns its metrics as 0-d tensors under the JAX
    package's keys; debug_grads=True adds the raw gradients under "_grads".
    """
    cfg = cfg.resolve()
    check_supported(cfg)
    is_fundus = cfg.dataset == "fundus"
    bsl = list(batch_size_list or cfg.batch_size_list)[: len(cfg.domain_idxs)]
    b_real = sum(bsl)
    domains = np.repeat(np.arange(len(bsl)), bsl)  # per-sample DSBN labels
    base_lr = float(cfg.lr)
    compute_dtype = torch_dtype(cfg.compute_dtype)
    group_factor = {"encoder": 0.5 if cfg.rec else 1.0}
    seg_cache: Dict[tuple, torch.Tensor] = {}

    def rec_weights(shape, device) -> torch.Tensor:
        """(D, B) segment matrix with each domain's 1/(bs*C*H*W): per-domain
        mean squared errors as one product."""
        key = (tuple(shape), device)
        if key not in seg_cache:
            seg = np.zeros((len(bsl), b_real), np.float32)
            left = 0
            for d, bs in enumerate(bsl):
                seg[d, left : left + bs] = 1.0 / (bs * float(np.prod(shape[1:])))
                left += bs
            seg_cache[key] = torch.from_numpy(seg).to(device)
        return seg_cache[key]

    def nchw(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 3, 1, 2).contiguous()

    def seg_head(logits: torch.Tensor, mask: torch.Tensor):
        """(repr, supervised loss, dice loss) of NCHW logits; `repr` feeds
        the consistency loss: fundus sigmoid probabilities, prostate the
        flat (B, H*W) logit-difference map."""
        if is_fundus:
            logits = logits.float()
            pred = torch.sigmoid(logits)
            return pred, bce_with_logits_loss(logits, mask), dice_loss(pred, mask)
        l = (logits[:, 1].float() - logits[:, 0].float()).reshape(logits.shape[0], -1)
        m = mask.reshape(mask.shape[0], -1)
        return l, bce_with_logits_loss(l, m), dice_loss(torch.sigmoid(l), m == 1)

    def consistency(repr2: torch.Tensor, repr1: torch.Tensor) -> torch.Tensor:
        if cfg.consistency_type == "kd":
            # eps guards the log against float32 saturation
            return (kd_loss if is_fundus else binary_kd_loss)(repr2, repr1, eps=1e-8)
        return (mse_loss if is_fundus else binary_mse_consistency)(repr2, repr1)

    sup_tag = "loss_bce" if is_fundus else "loss_ce"

    def loss_fn(state: TrainState, batch, draws):
        enc = state.models["encoder"]
        dec = state.models["seg_decoder"]
        metrics: Dict[str, torch.Tensor] = {}
        if cfg.ram:
            if "donor_amp" in batch:
                aug = ram_augment_fundus_banded if is_fundus else ram_augment_prostate_banded
                img, img_freq = aug(batch["img"], batch["donor_amp"], draws["ratio"], use_dft=cfg.ram_banded_dft)
            else:
                aug = ram_augment_fundus if is_fundus else ram_augment_prostate
                img, img_freq = aug(batch["img"], batch["donor"], draws["ratio"])
        else:
            img, img_freq = (batch["img"] / 127.5 - 1.0 if is_fundus else batch["img"].float()), None
        img = nchw(img)  # float32: RAM ran in float32 and the restoration MSE reads img
        mask = (nchw(batch["mask"]) if is_fundus else batch["mask"])[:b_real]

        if cfg.ram:
            # one forward over [clean; RAM]: per-half BN statistics, the two
            # running-stat updates in order (models/norm.py)
            half = img.shape[0]
            feats = enc(torch.cat([img, nchw(img_freq)]).to(compute_dtype), dual=True)
            logits_all = dec(feats, dual=True)
            logits1, logits2 = logits_all[:b_real], logits_all[half : half + b_real]
            feats_f_last = feats[-1][half:]
        else:
            logits1 = dec(enc(img.to(compute_dtype)))[:b_real]

        pred1, loss_sup1, loss_dice1 = seg_head(logits1, mask)
        loss = loss_sup1 + loss_dice1
        metrics.update({f"{sup_tag}_1": loss_sup1, "loss_dice_1": loss_dice1})

        if cfg.ram:
            pred2, loss_sup2, loss_dice2 = seg_head(logits2, mask)
            loss = loss + loss_sup2 + loss_dice2
            loss_cons = consistency(pred2, pred1) if cfg.consistency else img.new_zeros(())
            loss = loss + CONSISTENCY_WEIGHT * loss_cons
            avg_rec = img.new_zeros(())
            if cfg.rec:
                # one rec-decoder pass over the whole RAM bottleneck, DSBN in
                # segment mode; per-domain MSE through the segment matrix
                rec_soft = torch.tanh(state.models["rec_decoder"](feats_f_last, domain=domains).float())
                per_row = torch.sum(torch.square(rec_soft[:b_real] - img[:b_real]), dim=(1, 2, 3))
                loss_rec_d = rec_weights(rec_soft[:b_real].shape, img.device) @ per_row
                avg_rec = torch.sum(loss_rec_d)
                loss = loss + cfg.lambda_rec * avg_rec
            metrics.update({
                f"{sup_tag}_2": loss_sup2,
                "loss_dice_2": loss_dice2,
                "loss_consistency": loss_cons,
                "loss_rec": avg_rec / 4.0,  # the reference logs avg_rec_loss/4
            })
        metrics["loss"] = loss
        return loss, metrics

    def train_step(
        state: TrainState,
        batch: Mapping,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> Dict:
        device = next(state.models["encoder"].parameters()).device
        if draws is None:
            if generator is None:
                raise ValueError("train_step needs a generator or precomputed draws")
            draws = sample_step_draws(generator, b_real, device, crop=device_data is not None and is_fundus)
        if device_data is not None:
            idx = {k: torch.as_tensor(np.asarray(v), dtype=torch.long).to(device) for k, v in batch.items()}
            if is_fundus:
                batch = gather_and_augment(device_data, idx["img_idx"], idx["donor_idx"], draws, cfg.image_size)
            else:
                batch = gather_prostate(device_data, idx["img_idx"], idx["donor_idx"])
        for m in state.models.values():
            m.train()
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state, batch, draws)
        loss.backward()
        if debug_grads:
            metrics["_grads"] = {
                name: {k: p.grad.detach().clone() for k, p in m.named_parameters()}
                for name, m in state.models.items()
            }
        lr = poly_lr(base_lr, state.step, total_iters)
        for name, group in zip(state.models, opt.param_groups):
            group["lr"] = lr * group_factor.get(name, 1.0)
        opt.step()
        state.step += 1
        metrics = {k: (v if k == "_grads" else v.detach()) for k, v in metrics.items()}
        metrics["lr"] = torch.tensor(lr)
        return metrics

    return train_step


def make_predict_fn(cfg: TrainConfig, models: Mapping[str, torch.nn.Module], bn_adapt: bool = False) -> Callable:
    """Build `predict(img, n_valid=None) -> probabilities`, the counterpart of
    the JAX package's `make_predict_fn` (`train/steps.py:509-553`).

    img: (B, H, W, C) images in [0, 255] (numpy or a tensor, any real dtype);
    returns (B, num_classes, H, W) float32 probabilities on the models'
    device, NCHW (sigmoid for fundus, softmax over classes otherwise), from
    the encoder and seg decoder under no_grad.

    bn_adapt=False normalises with the running statistics.  bn_adapt=True is
    the eval CLIs' BN adaptation: every norm uses the test batch's own
    statistics; no running statistic and no train flag changes, so `fit`
    trains on after an eval exactly as before it.  The port runs a tail
    batch as it is; n_valid (the JAX package pads to one compiled shape and
    passes the real row count) is accepted for parity: with it, the batch
    statistics come from the first n_valid rows.

    cfg.predict_dtype="bfloat16" runs the forward in bfloat16 (the input is
    cast after its normalisation, BN statistics are float32) and returns
    float32 probabilities, as the JAX package does.
    """
    cfg = cfg.resolve()
    pdt = torch_dtype(cfg.predict_dtype)
    is_fundus = cfg.dataset == "fundus"
    enc, dec = models["encoder"], models["seg_decoder"]

    def predict(img, n_valid: Optional[int] = None) -> torch.Tensor:
        device = next(enc.parameters()).device
        x = torch.as_tensor(img).to(device=device, dtype=torch.float32).permute(0, 3, 1, 2)
        if is_fundus:
            x = x / 127.5 - 1.0
        x = x.to(pdt)
        with torch.no_grad():
            if bn_adapt:
                with batch_statistics(enc, dec):
                    logits = dec(enc(x, n_valid=n_valid), n_valid=n_valid)
            else:
                training = {m: m.training for m in (enc, dec)}
                enc.eval(), dec.eval()
                try:
                    logits = dec(enc(x))
                finally:
                    for m, flag in training.items():
                        m.train(flag)
        logits = logits.float()
        if is_fundus:
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=1)

    return predict
