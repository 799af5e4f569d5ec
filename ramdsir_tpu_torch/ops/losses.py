"""The loss library (PyTorch port of `ramdsir_tpu/ops/losses.py`): the losses
the train step uses, and the rest of the reference's library, which no
entry point calls (`bce_loss` on probabilities, `dice_loss1`, the entropy
losses, the softmax dice / MSE / KL losses, `symmetric_mse_loss`,
`focal_loss`).  Those are plain differentiable torch functions with the
class axis last, as the JAX package's; they reduce over the local tensor.

Every loss reduces over the whole batch, like the reference's torch losses
(global sums and means, not per-sample means), so values compare
step for step.  Reductions are global, so layout does not matter except for
the class axis of `dice_loss_multi` and `cross_entropy_loss`, which is the
last one (NHWC), as in the JAX package.

Under a process group (data-parallel training) "the whole batch" is the
global batch: each rank passes its real rows, and every mean and every
dice sum is reduced over the ranks before it is divided (`_mean`, `_sums`),
so a loss is the single-process loss of the global batch, the same on every
rank.  Without a group they are the plain torch reductions.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ramdsir_tpu_torch.parallel.distributed import in_group
from ramdsir_tpu_torch.parallel.mesh import all_reduce_sum


def _mean(t: torch.Tensor) -> torch.Tensor:
    """torch.mean(t); under a process group the mean over every rank's
    elements (the sum and the count reduced together, in float64)."""
    if not in_group():
        return torch.mean(t)
    count = torch.full((), float(t.numel()), dtype=torch.float64, device=t.device)  # no host-to-device copy
    tot = all_reduce_sum(torch.stack([torch.sum(t).double(), count]))
    return (tot[0] / tot[1]).to(t.dtype)


def _sums(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """torch.sum of each; under a process group summed over the ranks too,
    in one all-reduce."""
    sums = tuple(torch.sum(t) for t in ts)
    if not in_group():
        return sums
    return tuple(all_reduce_sum(torch.stack(sums)).unbind())


def _scalar(x: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-d tensor of x's dtype on x's device, filled there: no copy from
    the host, which a CUDA-graph capture refuses and an eager step waits for."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip as max-then-min: like JAX, torch.maximum/minimum split the
    gradient evenly at a tie, where torch.clamp passes all of it."""
    return torch.minimum(torch.maximum(x, _scalar(x, lo)), _scalar(x, hi))


def bce_with_logits_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCE on logits through softplus: mean of t*softplus(-x) + (1-t)*softplus(x)."""
    logits = logits.float()
    target = target.float()
    return _mean(target * F.softplus(-logits) + (1.0 - target) * F.softplus(logits))


def dice_loss(score: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft dice with a squared-sum denominator, smooth 1e-5."""
    score = score.float()
    target = target.float()
    smooth = 1e-5
    intersect, y_sum, z_sum = _sums(score * target, target * target, score * score)
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
        intersect, y_sum, z_sum = _sums(s * t, t, s * s)
        loss = loss + 1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)
    return loss / count


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """nn.CrossEntropyLoss (mean) on (..., C) logits and integer targets."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(target.long(), logits.shape[-1]).float()
    return -_mean(torch.sum(onehot * logp, dim=-1))


def _kl_div_mean(log_input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """nn.KLDivLoss(reduction='mean'): mean of t*(log t - log_input), 0*log 0 := 0."""
    return _mean(torch.xlogy(target, target) - target * log_input)


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
    return _mean(torch.square(a.float() - b.float()))


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
    return _mean(pointwise) / 2.0


def binary_mse_consistency(l_p: torch.Tensor, l_q: torch.Tensor) -> torch.Tensor:
    """`mse_loss(softmax(p), softmax(q))` of a 2-class head from its
    logit-difference maps."""
    d = torch.sigmoid(l_p.float()) - torch.sigmoid(l_q.float())
    return _mean(torch.square(d))


# --- the rest of the reference's loss library (no entry point calls these)


def bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """nn.BCELoss on probabilities (mean); each log floored at the smallest
    normal float32, where torch clamps it at -100."""
    pred = pred.float()
    target = target.float()
    floor = 1.18e-38
    log_p = torch.log(torch.maximum(pred, _scalar(pred, floor)))
    log_1p = torch.log(torch.maximum(1.0 - pred, _scalar(pred, floor)))
    return -torch.mean(target * log_p + (1.0 - target) * log_1p)


def dice_loss1(score: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft dice with a linear denominator, smooth 1e-5."""
    score = score.float()
    target = target.float()
    smooth = 1e-5
    intersect = torch.sum(score * target)
    return 1.0 - (2.0 * intersect + smooth) / (torch.sum(score) + torch.sum(target) + smooth)


def _entropy(p: torch.Tensor, keepdim: bool) -> torch.Tensor:
    p = p.float()
    return -torch.sum(p * torch.log(p + 1e-6), dim=-1, keepdim=keepdim)


def entropy_loss(p: torch.Tensor, num_classes: int = 2) -> torch.Tensor:
    """Mean entropy of (..., C) probabilities over log(num_classes)."""
    return torch.mean(_entropy(p, False) / math.log(num_classes))


def entropy_loss_map(p: torch.Tensor, num_classes: int = 2) -> torch.Tensor:
    """Pixelwise entropy over log(num_classes), (..., 1)."""
    return _entropy(p, True) / math.log(num_classes)


def entropy_minimization(p: torch.Tensor) -> torch.Tensor:
    """Mean entropy, unnormalised."""
    return torch.mean(_entropy(p, False))


def entropy_map(p: torch.Tensor) -> torch.Tensor:
    """Pixelwise entropy, unnormalised, (..., 1)."""
    return _entropy(p, True)


def softmax_dice_loss(input_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """Mean over classes of dice_loss1 between the two softmaxes."""
    ps = torch.softmax(input_logits.float(), dim=-1)
    pt = torch.softmax(target_logits.float(), dim=-1)
    n = ps.shape[-1]
    return sum(dice_loss1(ps[..., i], pt[..., i]) for i in range(n)) / n


def softmax_mse_loss(input_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """(softmax(a) - softmax(b))^2, unreduced."""
    return torch.square(torch.softmax(input_logits.float(), dim=-1) - torch.softmax(target_logits.float(), dim=-1))


def softmax_kl_loss(input_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """Pointwise KL(target softmax || input softmax), unreduced."""
    logp = torch.log_softmax(input_logits.float(), dim=-1)
    pt = torch.softmax(target_logits.float(), dim=-1)
    return torch.xlogy(pt, pt) - pt * logp


def symmetric_mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared difference, with gradients to both sides."""
    return torch.mean(torch.square(a.float() - b.float()))


def focal_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    gamma: float = 2.0,
    alpha: Optional[Union[float, Sequence[float]]] = None,
    size_average: bool = True,
) -> torch.Tensor:
    """Multi-class focal loss of (..., C) logits and integer targets: the
    weight (1 - p_t)^gamma taken without gradient; a scalar alpha weighs
    classes 0 and 1 by alpha and 1 - alpha."""
    logits = logits.float().reshape(-1, logits.shape[-1])
    target = target.reshape(-1).long()
    logpt = torch.log_softmax(logits, dim=-1).gather(1, target[:, None])[:, 0]
    pt = torch.exp(logpt.detach())
    if alpha is not None:
        a = torch.as_tensor(alpha, dtype=torch.float32, device=logits.device)
        if a.ndim == 0:
            a = torch.stack([a, 1.0 - a])
        logpt = logpt * a[target]
    loss = -((1.0 - pt) ** gamma) * logpt
    return torch.mean(loss) if size_average else torch.sum(loss)
