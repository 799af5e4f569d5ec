"""The losses the train step uses (PyTorch port of `ramdsir_tpu/ops/losses.py`).

Every loss reduces over the whole batch, like the reference's torch losses
(global sums and means, not per-sample means), so values compare
step for step.  Reductions are global, so layout does not matter except for
the class axis of `dice_loss_multi` and `cross_entropy_loss`, which is the
last one (NHWC), as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip as max-then-min: like JAX, torch.maximum/minimum split the
    gradient evenly at a tie, where torch.clamp passes all of it."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def bce_with_logits_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCE on logits through softplus: mean of t*softplus(-x) + (1-t)*softplus(x)."""
    logits = logits.float()
    target = target.float()
    return torch.mean(target * F.softplus(-logits) + (1.0 - target) * F.softplus(logits))


def dice_loss(score: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft dice with a squared-sum denominator, smooth 1e-5."""
    score = score.float()
    target = target.float()
    smooth = 1e-5
    intersect = torch.sum(score * target)
    y_sum = torch.sum(target * target)
    z_sum = torch.sum(score * score)
    return 1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)


def dice_loss_multi(
    score: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: int = 255
) -> torch.Tensor:
    """Per-class soft dice of (B, H, W, C) probabilities against a (B, H, W)
    integer mask; the class `ignore_index` is skipped."""
    score = score.float()
    smooth = 1e-5
    loss = score.new_zeros(())
    count = 0
    for i in range(num_classes):
        if i == ignore_index:
            continue
        count += 1
        t = (target == i).float()
        s = score[..., i]
        intersect = torch.sum(s * t)
        y_sum = torch.sum(t)
        z_sum = torch.sum(s * s)
        loss = loss + 1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)
    return loss / count


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """nn.CrossEntropyLoss (mean) on (..., C) logits and integer targets."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(target.long(), logits.shape[-1]).float()
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def _kl_div_mean(log_input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """nn.KLDivLoss(reduction='mean'): mean of t*(log t - log_input), 0*log 0 := 0."""
    return torch.mean(torch.xlogy(target, target) - target * log_input)


def kd_loss(p: torch.Tensor, q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Symmetric KL consistency KLDiv(log p, q) + KLDiv(log q, p) on
    probabilities; eps > 0 clips them to [eps, 1] first."""
    p = p.float()
    q = q.float()
    if eps:
        p = _clip(p, eps, 1.0)
        q = _clip(q, eps, 1.0)
    return _kl_div_mean(torch.log(p), q) + _kl_div_mean(torch.log(q), p)


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """nn.MSELoss (mean)."""
    return torch.mean(torch.square(a.float() - b.float()))


def binary_kd_loss(l_p: torch.Tensor, l_q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """`kd_loss(softmax(p), softmax(q))` of a 2-class head from its
    logit-difference maps l = logits[..., 1] - logits[..., 0]."""
    l_p = l_p.float()
    l_q = l_q.float()
    p1, p0 = torch.sigmoid(l_p), torch.sigmoid(-l_p)
    q1, q0 = torch.sigmoid(l_q), torch.sigmoid(-l_q)
    if eps:
        p1, p0 = _clip(p1, eps, 1.0), _clip(p0, eps, 1.0)
        q1, q0 = _clip(q1, eps, 1.0), _clip(q0, eps, 1.0)
    pointwise = (
        (torch.xlogy(q1, q1) - q1 * torch.log(p1))
        + (torch.xlogy(q0, q0) - q0 * torch.log(p0))
        + (torch.xlogy(p1, p1) - p1 * torch.log(q1))
        + (torch.xlogy(p0, p0) - p0 * torch.log(q0))
    )
    return torch.mean(pointwise) / 2.0


def binary_mse_consistency(l_p: torch.Tensor, l_q: torch.Tensor) -> torch.Tensor:
    """`mse_loss(softmax(p), softmax(q))` of a 2-class head from its
    logit-difference maps."""
    d = torch.sigmoid(l_p.float()) - torch.sigmoid(l_q.float())
    return torch.mean(torch.square(d))
