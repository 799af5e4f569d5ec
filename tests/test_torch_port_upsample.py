"""K2's plain version (the deterministic bilinear x2 backward,
`ops/upsample.py`) against torch's autograd and the JAX package's VJP, the
autograd Function, a fundus step under `deterministic_mode`, and the
keep-best file carried over from the JAX package.  The kernel itself runs
on the card only (tests/test_torch_port_cuda.py, chip_smoke.py)."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ramdsir_tpu.config import TrainConfig as JConfig
from ramdsir_tpu.models.unet import upsample2x as jupsample2x
from ramdsir_tpu.ops.ram import banded_amplitude_spectrum, sample_ram_ratios
from ramdsir_tpu.train.state import init_state as jinit_state
from ramdsir_tpu.train.steps import make_train_step as jmake_train_step
from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.ops import upsample
from ramdsir_tpu_torch.ops.upsample import Upsample2x, upsample2x_backward, upsample2x_backward_plain
from ramdsir_tpu_torch.train.loop import deterministic_mode
from ramdsir_tpu_torch.train.state import init_state
from ramdsir_tpu_torch.train.steps import make_train_step
from ramdsir_tpu_torch.utils.torch_compat import jax_params_to_torch
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)
from tests.test_torch_port_step import (
    check_params_and_running_stats,
    check_step_metrics,
)

# (N, C, H, W) of the input: the edges (H or W of 1 and 2), odd sizes, and
# a U-Net stage's shape at a small width
SHAPES = [(2, 3, 1, 1), (2, 3, 1, 2), (2, 3, 2, 1), (2, 3, 2, 2), (1, 4, 5, 7), (2, 8, 33, 9), (4, 16, 16, 16)]


def _grads(shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    g = torch.from_numpy(rng.standard_normal(shape[:2] + (2 * shape[2], 2 * shape[3]))).to(dtype)
    return x, g


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{s[2]}x{s[3]}" for s in SHAPES])
def test_plain_backward_matches_torch_autograd(shape):
    """The gradient of F.interpolate (torch's CPU autograd, another
    summation order): measured at most 1.5e-7 of the largest element, held
    to 1e-6; in float64 to 1e-14."""
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-14)):
        x, g = _grads(shape, dtype)
        x.requires_grad_(True)
        y = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        (want,) = torch.autograd.grad(y, x, g)
        got = upsample2x_backward(g)
        assert got.dtype == dtype and got.shape == x.shape
        assert float((got - want).abs().max()) <= tol * float(want.abs().max()), dtype


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{s[2]}x{s[3]}" for s in SHAPES])
def test_plain_backward_matches_jax_vjp(shape):
    """`jax.vjp` of the JAX package's upsample2x (NHWC, jax.image.resize,
    which renormalises the edge weights where torch clamps: the same
    function) on the CPU, in float32: within 1e-6 of the largest element
    (measured at most 2.4e-7)."""
    x, g = _grads(shape)
    _, vjp = jax.vjp(jupsample2x, jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    (want,) = vjp(jnp.asarray(g.permute(0, 2, 3, 1).numpy()))
    want = np.asarray(want).transpose(0, 3, 1, 2)
    got = upsample2x_backward(g).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_function_gradcheck_float64():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 4, 5))).requires_grad_(True)
    assert torch.autograd.gradcheck(Upsample2x.apply, (x,))
    x1 = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 2, 1, 2))).requires_grad_(True)
    assert torch.autograd.gradcheck(Upsample2x.apply, (x1,))
    # the forward is F.interpolate's
    torch.testing.assert_close(Upsample2x.apply(x), F.interpolate(x, scale_factor=2, mode="bilinear"), rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES[3:], ids=[f"{s[2]}x{s[3]}" for s in SHAPES[3:]])
def test_bf16_rounds_once_from_float32(shape):
    """A bfloat16 gradient is accumulated in float32 and rounded once: the
    float32 result rounded to bfloat16, bit for bit, so within bfloat16's
    half-ulp (2^-8 relative) of the float32 result."""
    _, g = _grads(shape)
    g16 = g.to(torch.bfloat16)
    got = upsample2x_backward(g16)
    want32 = upsample2x_backward(g16.float())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want32.to(torch.bfloat16), rtol=0, atol=0)
    assert bool(((got.float() - want32).abs() <= 2.0**-8 * want32.abs()).all())


def test_wrapper_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match=r"\(N, C, 2H, 2W\)"):
        upsample2x_backward(torch.zeros(1, 2, 3, 4))
    with pytest.raises(ValueError, match=r"\(N, C, 2H, 2W\)"):
        upsample2x_backward(torch.zeros(2, 4, 4))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        upsample2x_backward(torch.zeros(1, 2, 4, 4, device="meta"))


# --- a fundus step under deterministic_mode -------------------------------------------

HW = 64
BSL = [2, 2, 2]
B = sum(BSL)
NAMES = ("encoder", "seg_decoder", "rec_decoder")
CFG = dict(
    dataset="fundus", ram=True, rec=True, consistency=True, consistency_type="kd",
    image_size=HW, domain_idxs=(0, 1, 2), test_domain_idx=0, log_images_every=0,
)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_deterministic_step_matches_the_default_step_and_jax(monkeypatch):
    """One fundus step at 64^2 (banded-DFT RAM, --rec, KD) from the JAX
    package's initial weights: under deterministic_mode it takes K2's
    plain backward 8 times (4 upsamples of the seg decoder over the dual
    batch, 4 of the rec decoder) and torch's otherwise.  Both steps agree
    with the JAX step within the step-parity bounds of
    tests/test_torch_port_step.py (metrics; params and running statistics),
    and with each other within those, and every gradient within 1e-4 of its
    tensor's largest element (on the CPU only the upsample's summation order
    differs: measured 1.5e-5 at most).  The conv biases ahead of a BN have
    mathematically zero gradients: rounding noise, below 1.3e-6 in every
    run seen, held under 1e-5.  The mode is gone after the context."""
    from ramdsir_tpu.utils.torch_compat import flax_module_to_torch_sd

    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (B, HW, HW, 3)).astype(np.float32)
    donor = rng.uniform(0, 255, (B, HW, HW, 3)).astype(np.float32)
    batch = {"img": img, "mask": (rng.uniform(size=(B, HW, HW, 2)) > 0.5).astype(np.float32),
             "donor_amp": np.array(banded_amplitude_spectrum(jnp.asarray(donor)))}
    jcfg = JConfig(**CFG, device_data=False).resolve()
    jstate, models = jinit_state(jcfg, jax.random.PRNGKey(0))
    tcfg = TrainConfig(**CFG, device="cpu").resolve()
    key = jax.random.PRNGKey(11)
    ratio = torch.from_numpy(np.array(sample_ram_ratios(key, B)))
    sds = jax_params_to_torch(_np(jstate.params), _np(jstate.batch_stats))

    calls = []
    monkeypatch.setattr(upsample, "upsample2x_backward", lambda g: calls.append(g.shape) or upsample2x_backward_plain(g))
    before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    port = {}
    for det in (False, True):
        state = init_state(tcfg, torch.Generator().manual_seed(0), "cpu")
        for name in NAMES:
            state.models[name].load_state_dict(sds[name], strict=True)
        step = make_train_step(tcfg, total_iters=10, batch_size_list=BSL, debug_grads=True)
        calls.clear()
        with deterministic_mode(det):
            assert torch.are_deterministic_algorithms_enabled() == det
            m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, draws={"ratio": ratio})
        assert len(calls) == (8 if det else 0), calls
        params = {n: {k: v.detach().numpy().copy() for k, v in state.models[n].state_dict().items()} for n in NAMES}
        port[det] = (m, params)
    assert not torch.are_deterministic_algorithms_enabled()
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == before

    jstep = jmake_train_step(jcfg, models, total_iters=10, batch_size_list=BSL)
    jstate, jm, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jparams = {n: flax_module_to_torch_sd(_np(jstate.params[n]), _np(jstate.batch_stats[n])) for n in NAMES}
    for det in (False, True):
        m, params = port[det]
        check_step_metrics(jm, {k: v for k, v in m.items() if k != "_grads"})
        check_params_and_running_stats(jparams, params, tcfg.lr)
    (m0, p0), (m1, p1) = port[False], port[True]
    check_step_metrics(m0, m1)
    check_params_and_running_stats(p0, p1, tcfg.lr)
    for name in NAMES:
        for k, want in m0["_grads"][name].items():
            got = m1["_grads"][name][k]
            if re.search(r"\.conv\d\.bias$", k):  # a conv ahead of a BN: zero but for rounding
                assert float(got.abs().max()) <= 1e-5 and float(want.abs().max()) <= 1e-5, f"{name}.{k}"
                continue
            err = float((got - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), f"{name}.{k}: {err:.2e}"


# --- the keep-best file --------------------------------------------------------------


def test_best_keeper_adopts_a_jax_ckpt_by_score(tmp_path):
    """A JAX run's weights-only `model_71.20.ckpt` beside a port
    `model_70.00.pth`: the port's keeper starts at 71.20 from the .ckpt; a
    lower score saves nothing; a higher one writes `.pth` and removes only
    the file it adopted."""
    from ramdsir_tpu.train.checkpoint import BestKeeper as JBestKeeper
    from ramdsir_tpu_torch.train.checkpoint import BestKeeper, load_any_checkpoint
    from ramdsir_tpu_torch.train.state import build_models
    from ramdsir_tpu_torch.utils.torch_compat import export_torch_checkpoint

    jcfg = JConfig(dataset="fundus", image_size=32, rec=False, ram=False).resolve()
    jstate, _ = jinit_state(jcfg, jax.random.PRNGKey(0))
    assert JBestKeeper(str(tmp_path)).update(71.2, jstate)
    tcfg = TrainConfig(dataset="fundus", image_size=32, rec=False, ram=False, device="cpu").resolve()
    models = build_models(tcfg)
    export_torch_checkpoint(str(tmp_path / "model_70.00.pth"), models)

    keeper = BestKeeper(str(tmp_path))
    assert keeper.best == pytest.approx(71.2) and keeper.best_path == str(tmp_path / "model_71.20.ckpt")
    load_any_checkpoint(keeper.best_path, build_models(tcfg))  # the adopted file loads into the port
    assert not keeper.update(71.0, models)
    assert keeper.update(72.5, models)
    assert sorted(os.listdir(tmp_path)) == ["model_70.00.pth", "model_72.50.pth"]
    assert keeper.best == 72.5
