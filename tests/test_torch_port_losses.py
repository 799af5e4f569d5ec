"""The port's losses against the JAX package: value and gradient, on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ramdsir_tpu.ops import losses as jl
from ramdsir_tpu_torch.ops import losses as tl
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

SHAPE = (2, 16, 16, 2)


def _inputs(name, seed=0):
    """Numpy inputs per loss: the differentiated arrays first, then the
    fixed ones, as the step calls each loss."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=3.0, size=SHAPE).astype(np.float32)
    logits2 = rng.normal(scale=3.0, size=SHAPE).astype(np.float32)
    sig = lambda x: (1.0 / (1.0 + np.exp(-x))).astype(np.float32)
    target = (rng.uniform(size=SHAPE) > 0.5).astype(np.float32)
    labels = rng.integers(0, 3, SHAPE[:3]).astype(np.int32)
    soft = lambda x: (np.exp(x) / np.exp(x).sum(-1, keepdims=True)).astype(np.float32)
    logits3 = rng.normal(size=SHAPE[:3] + (3,)).astype(np.float32)
    return {
        "bce_with_logits_loss": ((logits,), (target,), {}),
        "dice_loss": ((sig(logits),), (target,), {}),
        "dice_loss_multi": ((soft(logits3),), (labels,), {"num_classes": 3, "ignore_index": 0}),
        "cross_entropy_loss": ((logits3,), (labels,), {}),
        "kd_loss": ((sig(logits), sig(logits2)), (), {"eps": 1e-8}),
        "mse_loss": ((sig(logits), sig(logits2)), (), {}),
        "binary_kd_loss": ((logits[..., 0], logits2[..., 0]), (), {"eps": 1e-8}),
        "binary_mse_consistency": ((logits[..., 0], logits2[..., 0]), (), {}),
    }[name]


NAMES = [
    "bce_with_logits_loss", "dice_loss", "dice_loss_multi", "cross_entropy_loss",
    "kd_loss", "mse_loss", "binary_kd_loss", "binary_mse_consistency",
]


@pytest.mark.parametrize("name", NAMES)
def test_loss_value_and_gradient_match_jax(name):
    diff, fixed, kw = _inputs(name)
    jfn, tfn = getattr(jl, name), getattr(tl, name)

    jval, jgrads = jax.value_and_grad(
        lambda *d: jfn(*d, *map(jnp.asarray, fixed), **kw), argnums=tuple(range(len(diff)))
    )(*map(jnp.asarray, diff))

    targs = [torch.from_numpy(d.copy()).requires_grad_() for d in diff]
    tval = tfn(*targs, *map(torch.from_numpy, fixed), **kw)
    tval.backward()

    # float32 reductions over 1k elements in two summation orders
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5, atol=1e-6)
    for t, g in zip(targs, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-4, atol=1e-6 * max(1.0, float(np.abs(g).max())))


def test_kd_clip_splits_the_gradient_at_a_tie():
    """At p == 1 (a saturated sigmoid) jnp.clip hands half the gradient on;
    the port's clip does the same, where torch.clamp would hand all of it."""
    p = np.array([1.0, 0.3, 1e-9], np.float32)
    q = np.array([0.5, 0.5, 0.5], np.float32)
    jg = np.asarray(jax.grad(lambda a: jl.kd_loss(a, jnp.asarray(q), eps=1e-8))(jnp.asarray(p)))
    tp = torch.from_numpy(p.copy()).requires_grad_()
    tl.kd_loss(tp, torch.from_numpy(q), eps=1e-8).backward()
    np.testing.assert_allclose(tp.grad.numpy(), jg, rtol=1e-5)
