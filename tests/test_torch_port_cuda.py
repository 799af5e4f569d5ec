"""K1 and K2 on the card against their plain versions, the eval path on
the card against the CPU, a bfloat16 step through K1, a `.ckpt` round trip
of a card state, and deterministic steps that repeat bit for bit (marker
`cuda`; skipped without a card).

These tests import neither JAX nor the JAX package, so they also run where
JAX is not installed; the root conftest.py imports JAX, so run them there
with `python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py`.
"""
import pytest
import torch

from ramdsir_tpu_torch.ops import ram as tram
from ramdsir_tpu_torch.ops import ram_mix
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 are CUDA kernels with no CPU build")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, n, h, w, c=3):
    x = torch.rand((n, c, h, w), generator=gen, device="cuda") * 255.0
    donor = torch.rand((n, h, w, c), generator=gen, device="cuda") * 255.0
    ratio = torch.randint(1, 11, (n,), generator=gen, device="cuda").float() / 10.0
    return torch.fft.rfft2(x), donor, ratio


def _at_offset(t, offset):
    """A copy of t that starts `offset` elements into its storage."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _mix(fn, z, amp, ratio, band, full, delta, offset=0):
    if delta:
        re, im = _at_offset(z.real.contiguous(), offset), _at_offset(z.imag.contiguous(), offset)
    else:
        zv = torch.view_as_real(_at_offset(z, offset))
        re, im = zv[..., 0], zv[..., 1]
    out = fn(re, im, amp, ratio, band, full=full, delta=delta)
    return torch.stack(out)


# amplitudes whose squares underflow (below 2^-75), whose squares are
# subnormal, zero and signed zero, out of the band and in it
TINY = torch.tensor([1e-23, -2e-23 + 1e-24j, 3e-23, 1e-20j, 0.0, -0.0, 1e-30 - 1e-30j], dtype=torch.complex64)


@pytest.mark.parametrize("variant", ["aligned", "misaligned", "single_plane", "tiny"])
@pytest.mark.parametrize("h,w", [(64, 64), (65, 63), (65, 64), (256, 256)])
@pytest.mark.parametrize("mode", ["full", "band", "delta"])
def test_kernel_matches_plain(gen, h, w, mode, variant):
    """Every code path against the plain version: the mode's own path on the
    layouts the RAM functions make, the strided path on a spectrum one
    element off 16 bytes (the delta blocks need no alignment), a single
    plane (at 65x64 an odd element count), and tiny amplitudes (equal bit
    for bit)."""
    z, donor, ratio = _inputs(gen, 1, h, w, c=1) if variant == "single_plane" else _inputs(gen, 4, h, w)
    b = tram.band_halfwidth(h, w)
    if variant == "tiny":
        z[:, :, h // 2, b + 1 : b + 1 + len(TINY)] = TINY.cuda()
        z[:, :, 1, 1 : 1 + len(TINY)] = TINY.cuda()
    if mode == "full":
        amp = tram.amplitude_spectrum(donor).permute(0, 3, 1, 2)
    else:
        amp = tram.banded_amplitude_spectrum(donor).permute(0, 3, 1, 2)
    if mode == "delta":
        rows = torch.cat([torch.arange(b + 1), torch.arange(h - b, h)]).cuda()
        z = z[:, :, rows, : b + 1]
    args = (z, amp, ratio, b, mode == "full", mode == "delta", 1 if variant == "misaligned" else 0)
    path = {"full": "full_vec", "band": "strided", "delta": "delta_flat"}[mode]
    if variant == "misaligned" and mode != "delta":
        path = "strided"
    before, before_path = ram_mix.launches, ram_mix.launches_by_path[path]
    got = _mix(ram_mix.mix_spectrum, *args)
    want = _mix(ram_mix.mix_spectrum_plain, *args)
    torch.cuda.synchronize()
    assert ram_mix.launches == before + 1
    assert ram_mix.launches_by_path[path] == before_path + 1
    # the same IEEE operations in the same order: equal to a rounding of the largest value
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    if variant == "tiny":
        assert torch.equal(got, want)


def test_ram_functions_run_through_the_kernel(gen):
    z, donor, ratio = _inputs(gen, 2, 64, 64)
    src = torch.fft.irfft2(z, s=(64, 64)).permute(0, 2, 3, 1)
    before = ram_mix.launches
    outs = [
        tram.ram_mixup(src, tram.amplitude_spectrum(donor), ratio),
        tram.ram_mixup_banded(src, tram.banded_amplitude_spectrum(donor), ratio),
        tram.ram_mixup_banded_dft(src, tram.banded_amplitude_spectrum(donor), ratio),
    ]
    torch.cuda.synchronize()
    assert ram_mix.launches == before + 3
    for out in outs[1:]:
        assert float((out - outs[0]).abs().max()) < 1e-2  # O(255) images, float32 FFT vs DFT rounding


def test_wrapper_refuses_what_the_kernel_cannot_take(gen):
    z, donor, ratio = _inputs(gen, 2, 32, 32)
    zv = torch.view_as_real(z)
    amp = tram.amplitude_spectrum(donor).permute(0, 3, 1, 2)
    with pytest.raises(ValueError):
        ram_mix.mix_spectrum(zv[..., 0], zv[..., 1], amp.cpu(), ratio, 3, full=True)
    with pytest.raises(TypeError):
        ram_mix.mix_spectrum(zv[..., 0], zv[..., 1], amp.double(), ratio, 3, full=True)
    with pytest.raises(ValueError):
        ram_mix.mix_spectrum(zv[..., 0], zv[..., 1], amp[:, :, :5], ratio, 3, full=True)


# --- eval on the card against the CPU ---------------------------------------------

EVAL_S = 64  # image size of the eval card tests


@pytest.fixture(scope="module")
def eval_models():
    """The same random weights on the card and on the CPU, float32 with TF32
    off and deterministic cuDNN (restored afterwards)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the eval forward is compared between the card and the CPU")
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.models.unet import init_weights
    from ramdsir_tpu_torch.train.state import build_models

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = TrainConfig(image_size=EVAL_S, rec=False, ram=False, device="cpu").resolve()
    out = {}
    for dev in ("cpu", "cuda"):
        models = build_models(cfg)
        for m in models.values():
            init_weights(m, torch.Generator().manual_seed(3))
            m.to(dev).train()
        out[dev] = models
    yield cfg, out
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.deterministic = saved


@pytest.mark.parametrize("bn_adapt", [False, True])
def test_predict_on_card_matches_cpu(eval_models, bn_adapt):
    """Probabilities within 1e-4 for a full batch and an unpadded tail of 2;
    the BN-adapted call leaves every running statistic and flag alone."""
    import numpy as np

    from ramdsir_tpu_torch.train.steps import make_predict_fn

    cfg, models = eval_models
    img = np.random.default_rng(0).integers(0, 256, (8, EVAL_S, EVAL_S, 3)).astype(np.uint8)
    before = {k: v.clone() for k, v in models["cuda"]["encoder"].state_dict().items()}
    for batch in (img, img[:2]):
        got = make_predict_fn(cfg, models["cuda"], bn_adapt=bn_adapt)(batch)
        want = make_predict_fn(cfg, models["cpu"], bn_adapt=bn_adapt)(batch)
        assert got.is_cuda and got.shape == (len(batch), 2, EVAL_S, EVAL_S)
        assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert models["cuda"]["encoder"].training
    for k, v in models["cuda"]["encoder"].state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("bn_adapt", [False, True])
def test_eval_fundus_on_card_matches_cpu(eval_models, bn_adapt):
    """eval_fundus on an in-memory split of 10 images at 96^2 (test batch 4,
    a tail of 2): Dice within 1e-3, distances from the same host library."""
    from ramdsir_tpu_torch.data.synthetic import fundus_test_samples
    from ramdsir_tpu_torch.train.evaluate import eval_fundus
    from ramdsir_tpu_torch.train.steps import make_predict_fn

    cfg, models = eval_models
    samples = fundus_test_samples(num=10, size=96, image_size=EVAL_S, seed=1)
    res = {
        dev: eval_fundus(make_predict_fn(cfg, models[dev], bn_adapt=bn_adapt), samples, 0,
                         batch_size=4, image_size=EVAL_S, with_distances=True)
        for dev in ("cuda", "cpu")
    }
    assert res["cuda"].num == res["cpu"].num == 10 and res["cuda"].timing["batches"] == 3
    assert abs(res["cuda"].cup_dice - res["cpu"].cup_dice) <= 1e-3
    assert abs(res["cuda"].disc_dice - res["cpu"].disc_dice) <= 1e-3


@pytest.mark.parametrize("bn_adapt", [False, True])
def test_predict_volume_on_card_matches_cpu(eval_models, bn_adapt):
    """A prostate volume of 12 slices at 64^2 in window batches of 4 (the
    last with 2 zero rows): labels equal but for at most 1e-4 of the voxels,
    volume Dice within 1e-3."""
    import numpy as np

    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.synthetic import prostate_volumes
    from ramdsir_tpu_torch.train.evaluate import eval_prostate_volumes, predict_volume
    from ramdsir_tpu_torch.train.steps import make_predict_fn

    _, models = eval_models
    cfg = TrainConfig(dataset="prostate", rec=False, ram=False, device="cpu").resolve()
    volumes = prostate_volumes(per_domain=1, depth=12, size=EVAL_S, seed=2, domains=["HK"])["HK"]
    _, vol, mask = volumes[0]
    image = vol.astype(np.float64)
    image = (2.0 * (image - image.min()) / (image.max() - image.min()) - 1.0).astype(np.float32)
    predict = {dev: make_predict_fn(cfg, models[dev], bn_adapt=bn_adapt) for dev in ("cuda", "cpu")}
    labels = {dev: predict_volume(p, image, mask, batch_size=4) for dev, p in predict.items()}
    assert float(np.mean(labels["cuda"] != labels["cpu"])) <= 1e-4
    res = {dev: eval_prostate_volumes(p, volumes, 5, batch_size=4) for dev, p in predict.items()}
    assert res["cuda"].num == 1 and res["cuda"].timing["batches"] == 3
    assert abs(res["cuda"].dice - res["cpu"].dice) <= 1e-3


# --- a bfloat16 step and a checkpoint round trip on the card ---------------------


def _card_step(compute_dtype):
    """A fundus RAM-DSIR state at 64^2 on the card after one step of the
    device pipeline, and K1's launches during that step by code path."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.synthetic import fundus_arrays
    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
                      is_out_domain=True, consistency=True, consistency_type="kd", image_size=64,
                      compute_dtype=compute_dtype, device="cuda").resolve()
    pipe = DeviceFundusPipeline.from_arrays(
        fundus_arrays(per_domain_train=8, size=64), cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
        is_out_domain=True, seed=0, precompute_donor_amp=cfg.ram_precompute_donor_amp, device="cuda",
    )
    state = init_state(cfg, torch.Generator().manual_seed(0), "cuda")
    step = make_train_step(cfg, total_iters=10, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data)
    before = dict(ram_mix.launches_by_path)
    metrics = step(state, next(iter(pipe)), torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    launched = {p: k - before.get(p, 0) for p, k in ram_mix.launches_by_path.items() if k != before.get(p, 0)}
    return cfg, state, metrics, launched


def test_bf16_step_on_card_launches_k1_once(gen):
    """A bfloat16 step runs RAM in float32 through K1, once, on the
    band-delta path; its losses are finite float32 and the weights, BN
    statistics and Adam moments stay float32."""
    _, state, metrics, launched = _card_step("bfloat16")
    assert launched == {"delta_flat": 1}
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v)) for v in metrics.values())
    assert all(t.dtype == torch.float32 and t.is_cuda for m in state.models.values() for t in m.state_dict().values())
    assert all(v.dtype == torch.float32 for s in state.optimizer.state.values() for k, v in s.items() if k != "step")


def test_ckpt_round_trip_of_card_state_is_bit_equal(gen, tmp_path):
    """A card state after a step, written as a .ckpt and loaded into a fresh
    state on the card: every parameter, buffer and Adam moment bit-equal,
    and the step."""
    from ramdsir_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from ramdsir_tpu_torch.train.state import init_state

    cfg, a, _, _ = _card_step("float32")
    save_checkpoint(str(tmp_path / "a.ckpt"), a)
    b = init_state(cfg, torch.Generator().manual_seed(9), "cuda")
    load_checkpoint(str(tmp_path / "a.ckpt"), b)
    assert a.step == b.step == 1
    for name, m in a.models.items():
        for k, v in m.state_dict().items():
            assert v.is_cuda and torch.equal(v, b.models[name].state_dict()[k]), f"{name}.{k}"
    pa = [p for m in a.models.values() for p in m.parameters()]
    pb = [p for m in b.models.values() for p in m.parameters()]
    for p, q in zip(pa, pb):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa)


# --- K2, the deterministic upsample backward, and a deterministic step --------------

# (N, C, H, W) of the input: edges, odd sizes, and two U-Net stages of the
# fundus main path (seg decoder over the dual batch of 32: 256 ch at 16^2,
# 32 ch at 128^2)
K2_SHAPES = [(2, 3, 1, 1), (2, 3, 2, 1), (1, 4, 5, 7), (3, 5, 33, 17), (32, 256, 16, 16), (32, 32, 128, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", K2_SHAPES, ids=[f"{s[0]}x{s[1]}x{s[2]}x{s[3]}" for s in K2_SHAPES])
def test_k2_matches_plain(gen, shape, dtype):
    """K2 against its plain version on the card, bit for bit; one launch."""
    from ramdsir_tpu_torch.ops import upsample

    n, c, h, w = shape
    g = torch.randn((n, c, 2 * h, 2 * w), generator=gen, device="cuda").to(dtype)
    before = upsample.launches
    got = upsample.upsample2x_backward(g)
    want = upsample.upsample2x_backward_plain(g)
    torch.cuda.synchronize()
    assert upsample.launches == before + 1
    assert got.dtype == dtype and got.shape == (n, c, h, w)
    assert torch.equal(got, want)


def test_k2_refuses_what_it_cannot_take(gen):
    from ramdsir_tpu_torch.ops import upsample

    g = torch.randn((2, 4, 8, 6), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="NCHW contiguous"):
        upsample.upsample2x_backward(g.transpose(2, 3))
    with pytest.raises(ValueError, match="NCHW contiguous"):
        upsample.upsample2x_backward(g.contiguous(memory_format=torch.channels_last))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        upsample.upsample2x_backward(g.double())


def _deterministic_steps(cfg, steps=2):
    """`steps` steps of a fresh state and a fresh pipeline from one seed
    under deterministic_mode; the state, the metrics and K2's launches."""
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.synthetic import fundus_arrays
    from ramdsir_tpu_torch.ops import upsample
    from ramdsir_tpu_torch.train.loop import deterministic_mode
    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step

    pipe = DeviceFundusPipeline.from_arrays(
        fundus_arrays(per_domain_train=8, size=64), cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
        is_out_domain=True, seed=0, precompute_donor_amp=cfg.ram_precompute_donor_amp, device="cuda",
    )
    state = init_state(cfg, torch.Generator().manual_seed(0), "cuda")
    step = make_train_step(cfg, total_iters=10, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data)
    gen, rows, metrics = torch.Generator().manual_seed(1), iter(pipe), []
    before = upsample.launches
    with deterministic_mode(True):
        for _ in range(steps):
            metrics.append({k: v.clone() for k, v in step(state, next(rows), gen).items()})
    torch.cuda.synchronize()
    return state, metrics, upsample.launches - before


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_deterministic_steps_repeat_bit_for_bit(gen, compute_dtype):
    """Two runs of two fundus steps from one seed under deterministic_mode:
    parameters, BN statistics, Adam moments and losses bit-equal; K2
    launched 8 times a step; the mode is off afterwards."""
    from ramdsir_tpu_torch.config import TrainConfig

    cfg = TrainConfig(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
                      is_out_domain=True, consistency=True, consistency_type="kd", image_size=64,
                      compute_dtype=compute_dtype, device="cuda").resolve()
    (a, ma, ka), (b, mb, kb) = _deterministic_steps(cfg), _deterministic_steps(cfg)
    assert not torch.are_deterministic_algorithms_enabled()
    assert ka == kb == 2 * 8
    for x, y in zip(ma, mb):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    for name, m in a.models.items():
        for k, v in m.state_dict().items():
            assert torch.equal(v, b.models[name].state_dict()[k]), f"{name}.{k}"
    pa = [p for m in a.models.values() for p in m.parameters()]
    pb = [p for m in b.models.values() for p in m.parameters()]
    for p, q in zip(pa, pb):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
