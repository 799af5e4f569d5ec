"""K3's plain version (the bilinear x2 forward, `ops/upsample.py`) against
aten's CPU forward and the JAX package's upsample, the wrappers' checks and
path choice, and the autograd Function's CPU forward.  The kernel itself
runs on the card only (tests/test_torch_port_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ramdsir_tpu.models.unet import upsample2x as jupsample2x
from ramdsir_tpu_torch.ops import cuda_build, upsample
from ramdsir_tpu_torch.ops.upsample import (
    Upsample2x,
    upsample2x_backward,
    upsample2x_forward,
    vector_path,
)
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)
from tests.test_torch_port_upsample import SHAPES

IDS = [f"{s[2]}x{s[3]}" for s in SHAPES]


def _x(shape, dtype=torch.float64, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


def _aten(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_forward_matches_aten_cpu(shape):
    """Against aten's CPU forward.  In bfloat16 (aten computes in float32
    and rounds once, as the plain version does) bit for bit.  In float64
    within 1e-15 of the largest element (measured at most 1.7e-16): aten's
    CPU kernel is compiled with FMA contraction (an element of the 5 x 7
    case equals fma(x0, 0.75, 0.25*x1), not 0.75*x0 + 0.25*x1), which the
    plain version, every product rounded, does not take.  In float32
    within 1e-6 (measured at most 1.3e-7 of the largest element)."""
    x = _x(shape)
    got, want = upsample2x_forward(x), _aten(x)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-15 * float(x.abs().max())
    x32 = x.float()
    assert float((upsample2x_forward(x32) - _aten(x32)).abs().max()) <= 1e-6 * float(x32.abs().max())
    x16 = x.to(torch.bfloat16)
    assert torch.equal(upsample2x_forward(x16), _aten(x16))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_forward_matches_jax(shape):
    """The JAX package's upsample2x (NHWC, jax.image.resize, which
    renormalises the edge weights where aten clamps: the same function) on
    the CPU in float32, within 1e-6 of the largest element (measured at most
    1.3e-7)."""
    x = _x(shape, torch.float32)
    want = np.asarray(jupsample2x(jnp.asarray(x.permute(0, 2, 3, 1).numpy()))).transpose(0, 3, 1, 2)
    got = upsample2x_forward(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(x.abs().max()))


@pytest.mark.parametrize("shape", SHAPES[3:], ids=IDS[3:])
def test_bf16_forward_rounds_once_from_float32(shape):
    """A bfloat16 input is combined in float32 and rounded once: the float32
    result of the same values rounded to bfloat16, bit for bit."""
    x16 = _x(shape, torch.float32).to(torch.bfloat16)
    got = upsample2x_forward(x16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, upsample2x_forward(x16.float()).to(torch.bfloat16))


def test_zero_weight_terms_spread_inf_and_nan_as_aten():
    """The zero-weight terms stay in the sum: an inf or NaN reaches the
    outputs that weigh it by 0, exactly where aten's forward puts NaN."""
    x = torch.tensor([[[[float("inf"), 1.0, 2.0], [3.0, float("nan"), 4.0], [5.0, 6.0, -float("inf")]]]])
    got, want = upsample2x_forward(x), _aten(x)
    assert torch.equal(got.isnan(), want.isnan())
    finite = ~want.isnan()
    assert torch.equal(got[finite], want[finite])


def test_function_on_cpu_keeps_aten_forward_and_launches_nothing():
    """`Upsample2x.apply` on CPU tensors: aten's forward (the default path's,
    so on the CPU the mode moves only the backward's summation order) and
    K2's plain backward, float64 gradcheck; no kernel launch counted.  The
    plain forward, which K3 is held to on the card, is the wrapper's."""
    before = cuda_build.launch_counts()
    x = _x((2, 3, 4, 5), seed=1).requires_grad_(True)
    assert torch.equal(Upsample2x.apply(x), _aten(x.detach()))
    assert torch.autograd.gradcheck(Upsample2x.apply, (x,))
    x1 = _x((1, 2, 1, 2), seed=2).requires_grad_(True)
    assert torch.autograd.gradcheck(Upsample2x.apply, (x1,))
    assert cuda_build.launch_counts() == before
    with pytest.raises(ValueError, match="upsample2x_forward: no kernel for device meta"):
        Upsample2x.apply(torch.zeros(1, 2, 4, 4, device="meta"))


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_default_upsample_on_cpu_is_aten_both_ways(dtype, layout):
    """Without deterministic mode, `models.unet.upsample2x` on a CPU tensor
    is `F.interpolate` forward and backward, bit for bit, and launches
    neither kernel (the launch counts stay); a channels-last input gives a
    channels-last output, as aten's own does."""
    from ramdsir_tpu_torch.models.unet import upsample2x

    assert not torch.are_deterministic_algorithms_enabled()
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    x = _x((2, 8, 6, 10), torch.float32, seed=3).to(dtype).contiguous(memory_format=fmt)
    g = _x((2, 8, 12, 20), torch.float32, seed=4).to(dtype)
    assert not upsample.kernels_take(x)
    before = cuda_build.launch_counts()
    out = {}
    for name, fn in (("port", upsample2x), ("aten", _aten)):
        xi = x.clone().requires_grad_(True)
        y = fn(xi)
        out[name] = (y, *torch.autograd.grad(y, xi, g))
    (y, dx), (want_y, want_dx) = out["port"], out["aten"]
    assert y.dtype == dtype and torch.equal(y, want_y) and torch.equal(dx, want_dx)
    assert cuda_build.launch_counts() == before
    assert y.is_contiguous(memory_format=fmt) and y.is_contiguous() == (layout == "nchw")


def test_wrappers_refuse_what_they_cannot_take():
    for fn in (upsample2x_forward, upsample2x_backward):
        name = fn.__name__
        with pytest.raises(TypeError, match=f"{name}: float32 or bfloat16"):
            fn(torch.zeros(1, 2, 4, 4, dtype=torch.float16))
        with pytest.raises(ValueError, match=f"{name}: no kernel for device meta"):
            fn(torch.zeros(1, 2, 4, 4, device="meta"))
        # 2^31 input-side elements (no storage: a meta tensor), refused before the device
        big = (2**15, 2**16, 1, 1) if fn is upsample2x_forward else (2**15, 2**16, 2, 2)
        with pytest.raises(ValueError, match="exceed the kernel's 32-bit indices"):
            fn(torch.empty(big, device="meta"))
    with pytest.raises(ValueError, match=r"expected \(N, C, H, W\)"):
        upsample2x_forward(torch.zeros(2, 4, 4))
    with pytest.raises(ValueError, match=r"expected \(N, C, H, W\)"):
        upsample2x_forward(torch.zeros(1, 2, 0, 4))


def _at(dtype, shape, offset):
    """An uninitialised tensor of `shape` whose first element lies `offset`
    elements past a 16-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.empty(n + offset + 16, dtype=dtype)
    start = (-(buf.data_ptr() % 16) // buf.element_size()) % (16 // buf.element_size()) + offset
    out = buf[start : start + n].view(shape)
    assert out.data_ptr() % 16 == offset * buf.element_size() % 16
    return out


@pytest.mark.parametrize("dtype,width,offset,vec", [
    (torch.float32, 8, 0, True), (torch.float32, 4, 0, True), (torch.float32, 6, 0, False),
    (torch.float32, 8, 1, False), (torch.bfloat16, 16, 0, True), (torch.bfloat16, 8, 0, True),
    (torch.bfloat16, 12, 0, False), (torch.bfloat16, 16, 4, False), (torch.bfloat16, 16, 8, True),
], ids=lambda v: str(v).replace("torch.", ""))
def test_vector_path_needs_whole_groups_and_16_byte_pointers(dtype, width, offset, vec):
    """The 16-byte path takes an input-side width that is a multiple of the
    columns a thread owns (4 in float32, 8 in bfloat16) and 16-byte aligned
    pointers on both sides; anything else takes the scalar edge path, for
    K3 (input x, output 2x) and K2 (input 2x gradient, output x) alike."""
    x = _at(dtype, (2, 3, 5, width), offset)
    assert vector_path(x, torch.empty(2, 3, 10, 2 * width, dtype=dtype)) == vec
    g = _at(dtype, (2, 3, 10, 2 * width), offset)
    assert vector_path(g, torch.empty(2, 3, 5, width, dtype=dtype)) == vec


def test_deterministic_step_through_both_kernels_arithmetic_matches_jax(monkeypatch):
    """The slice as a whole: one fundus step at 64^2 (banded-DFT RAM, --rec,
    KD) from the JAX package's initial weights under deterministic_mode,
    with the upsample computed as on the card, K3's arithmetic forward (its
    plain version; on CPU tensors `Upsample2x` otherwise keeps aten's) and
    K2's backward, 8 of each, against the JAX step within the step-parity
    bounds of tests/test_torch_port_step.py (metrics; params and running
    statistics)."""
    import jax

    from ramdsir_tpu.config import TrainConfig as JConfig
    from ramdsir_tpu.ops.ram import banded_amplitude_spectrum, sample_ram_ratios
    from ramdsir_tpu.train.state import init_state as jinit_state
    from ramdsir_tpu.train.steps import make_train_step as jmake_train_step
    from ramdsir_tpu.utils.torch_compat import flax_module_to_torch_sd
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.train.loop import deterministic_mode
    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step
    from ramdsir_tpu_torch.utils.torch_compat import jax_params_to_torch
    from tests.test_torch_port_step import check_params_and_running_stats, check_step_metrics
    from tests.test_torch_port_upsample import B, BSL, CFG, HW, NAMES, _np

    rng = np.random.default_rng(6)
    batch = {"img": rng.uniform(0, 255, (B, HW, HW, 3)).astype(np.float32),
             "mask": (rng.uniform(size=(B, HW, HW, 2)) > 0.5).astype(np.float32),
             "donor_amp": np.array(banded_amplitude_spectrum(jnp.asarray(
                 rng.uniform(0, 255, (B, HW, HW, 3)).astype(np.float32))))}
    jcfg = JConfig(**CFG, device_data=False).resolve()
    jstate, models = jinit_state(jcfg, jax.random.PRNGKey(0))
    tcfg = TrainConfig(**CFG, device="cpu").resolve()
    key = jax.random.PRNGKey(12)
    sds = jax_params_to_torch(_np(jstate.params), _np(jstate.batch_stats))
    state = init_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    for name in NAMES:
        state.models[name].load_state_dict(sds[name], strict=True)

    calls = []
    monkeypatch.setattr(Upsample2x, "forward", staticmethod(
        lambda ctx, x: calls.append("k3") or upsample.upsample2x_forward_plain(x)))
    plain_backward = upsample.upsample2x_backward
    monkeypatch.setattr(upsample, "upsample2x_backward", lambda g: calls.append("k2") or plain_backward(g))
    step = make_train_step(tcfg, total_iters=10, batch_size_list=BSL)
    with deterministic_mode(True):
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                 draws={"ratio": torch.from_numpy(np.array(sample_ram_ratios(key, B)))})
    assert sorted(calls) == ["k2"] * 8 + ["k3"] * 8
    params = {n: {k: v.detach().numpy().copy() for k, v in state.models[n].state_dict().items()} for n in NAMES}

    jstep = jmake_train_step(jcfg, models, total_iters=10, batch_size_list=BSL)
    jstate, jm, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    check_step_metrics(jm, m)
    check_params_and_running_stats(
        {n: flax_module_to_torch_sd(_np(jstate.params[n]), _np(jstate.batch_stats[n])) for n in NAMES}, params, tcfg.lr)
