"""K1, K2 and K3 on the card against their plain versions, the grouped batch
norm's kernels against their float64 plain version at every norm shape of
both steps (and a train step's norms counted through graph replays), the
eval path on the card against the CPU, a bfloat16 step through K1, a `.ckpt` round trip
of a card state (capturable Adam), deterministic steps that repeat bit for
bit, two graph windows bit-equal to single steps, a window's replays as
spans under the profiler, the GN / IN
forwards against the CPU, --remat bit-equal to no remat, the host input
path on the card: the host-to-device stream, the viz ring, `fit` on the
host loaders, data-parallel steps on the card: one NCCL rank, and two
gloo ranks sharing cuda:0, against the single-process step, and TransUNet's
attention on SDPA's memory-efficient kernel (no fallback) and its graph
window against eager steps (marker `cuda`; skipped without a card).

These tests import neither JAX nor the JAX package, so they also run where
JAX is not installed; the root conftest.py imports JAX, so run them there
with `python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py`.
"""
import numpy as np
import pytest
import torch

from ramdsir_tpu_torch.ops import cuda_build
from ramdsir_tpu_torch.ops import ram as tram
from ramdsir_tpu_torch.ops import ram_mix
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1, K2 and K3 are CUDA kernels with no CPU build")
    return torch.Generator(device="cuda").manual_seed(0)


def _launched(before):
    """The kernels that ran on the card since `before` (a
    `cuda_build.launch_counts()`), with their runs; reading waits for the card."""
    return {k: n - before[k] for k, n in cuda_build.launch_counts().items() if n != before[k]}


def _k1(counts):
    """K1's runs in launch counts (`_launched`'s or `launch_counts()`'s), over its paths."""
    return sum(n for k, n in counts.items() if k.startswith("ram_mix."))


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
    before = cuda_build.launch_counts()
    got = _mix(ram_mix.mix_spectrum, *args)
    want = _mix(ram_mix.mix_spectrum_plain, *args)
    assert _launched(before) == {f"ram_mix.{path}": 1}
    # the same IEEE operations in the same order: equal to a rounding of the largest value
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    if variant == "tiny":
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["full", "band", "delta"])
def test_kernel_counts_its_runs_on_the_card_through_graph_replays(gen, mode):
    """K1's counter on the card moves by one at each eager launch and at
    each replay of a graph that holds one launch, in its path's slot."""
    z, donor, ratio = _inputs(gen, 2, 64, 64)
    amp = (tram.amplitude_spectrum(donor) if mode == "full" else tram.banded_amplitude_spectrum(donor)).permute(0, 3, 1, 2)
    b = tram.band_halfwidth(64, 64)
    if mode == "delta":
        z = z[:, :, torch.cat([torch.arange(b + 1), torch.arange(64 - b, 64)]).cuda(), : b + 1]
    path = {"full": "full_vec", "band": "strided", "delta": "delta_flat"}[mode]
    run = lambda: _mix(ram_mix.mix_spectrum, z, amp, ratio, b, mode == "full", mode == "delta")
    run()  # the library, the counter and the kernel's first launch, before the capture
    torch.cuda.synchronize()
    cuda_build.zero_launch_counts()
    run()
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert cuda_build.launch_counts() == {k: 4 if k == f"ram_mix.{path}" else 0 for k in cuda_build.COUNTERS}


def test_ram_functions_run_through_the_kernel(gen):
    z, donor, ratio = _inputs(gen, 2, 64, 64)
    src = torch.fft.irfft2(z, s=(64, 64)).permute(0, 2, 3, 1)
    before = cuda_build.launch_counts()
    outs = [
        tram.ram_mixup(src, tram.amplitude_spectrum(donor), ratio),
        tram.ram_mixup_banded(src, tram.banded_amplitude_spectrum(donor), ratio),
        tram.ram_mixup_banded_dft(src, tram.banded_amplitude_spectrum(donor), ratio),
    ]
    assert _k1(_launched(before)) == 3
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
def test_predict_on_card_keeps_atens_channels_last_upsample(eval_models, bn_adapt):
    """The predict path's forward (NHWC images permuted: channels-last
    activations) takes aten's NHWC upsample, not K3 or K2, with and without
    BN adaptation: neither kernel runs on the card."""
    from ramdsir_tpu_torch.train.steps import make_predict_fn

    cfg, models = eval_models
    img = np.random.default_rng(1).integers(0, 256, (4, EVAL_S, EVAL_S, 3)).astype(np.uint8)
    predict = make_predict_fn(cfg, models["cuda"], bn_adapt=bn_adapt)
    before = cuda_build.launch_counts()
    predict(img)
    assert not any(k.startswith("upsample2x.") for k in _launched(before))


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
    before = cuda_build.launch_counts()
    metrics = step(state, next(iter(pipe)), torch.Generator().manual_seed(1))
    launched = {k.split(".", 1)[1]: n for k, n in _launched(before).items() if k.startswith("ram_mix.")}
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


def test_capturable_adam_state_through_ckpt(gen, tmp_path):
    """On the card Adam is capturable: each group's lr a 0-d float32 tensor
    on the card, each step count a float32 tensor there.  The .ckpt tree
    reads the count (1 after a step), a loaded state keeps it on the card,
    and one more step from the original and from the loaded state is bit
    for bit the same under deterministic_mode."""
    from ramdsir_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from ramdsir_tpu_torch.train.loop import deterministic_mode
    from ramdsir_tpu_torch.train.state import init_state, state_to_tree

    cfg, a, _, _ = _card_step("float32")
    assert a.optimizer.defaults["capturable"]
    assert all(torch.is_tensor(g["lr"]) and g["lr"].is_cuda and g["lr"].dtype == torch.float32
               for g in a.optimizer.param_groups)
    assert int(state_to_tree(a)["opt_state"]["count"]) == 1
    save_checkpoint(str(tmp_path / "a.ckpt"), a)
    b = init_state(cfg, torch.Generator().manual_seed(9), "cuda")
    load_checkpoint(str(tmp_path / "a.ckpt"), b)
    steps = [s["step"] for s in b.optimizer.state.values()]
    assert steps and all(t.is_cuda and t.dtype == torch.float32 and float(t) == 1.0 for t in steps)
    out = []
    for state in (a, b):
        from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
        from ramdsir_tpu_torch.data.synthetic import fundus_arrays
        from ramdsir_tpu_torch.train.steps import make_train_step

        pipe = DeviceFundusPipeline.from_arrays(
            fundus_arrays(per_domain_train=8, size=64), cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
            is_out_domain=True, seed=0, precompute_donor_amp=cfg.ram_precompute_donor_amp, device="cuda")
        step = make_train_step(cfg, total_iters=10, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data)
        with deterministic_mode(True):
            m = step(state, next(iter(pipe)), torch.Generator().manual_seed(3))
        out.append(({k: v.clone() for k, v in m.items()}, {f"{n}.{k}": v.clone() for n, mod in state.models.items()
                                                           for k, v in mod.state_dict().items()}))
    (ma, sa), (mb, sb) = out
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert [k for k in sa if not torch.equal(sa[k], sb[k])] == []


def test_graph_windows_match_single_steps_on_card(gen):
    """Two windows of 3 fundus steps at 64^2 (the first: 2 eager steps, the
    capture, a replay; the second: 3 replays) against 6 single steps from
    the same seed, under deterministic_mode: parameters, BN statistics,
    Adam moments and every step's metrics bit-equal; K1 run 6 times (once
    a step) and K2 and K3 8 times a step both ways, as the kernels count
    themselves on the card; 4 replays."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.synthetic import fundus_arrays
    from ramdsir_tpu_torch.train.loop import deterministic_mode
    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
                      is_out_domain=True, consistency=True, consistency_type="kd", image_size=64,
                      device="cuda").resolve()
    runs = {}
    for name in ("single", "graph"):
        pipe = DeviceFundusPipeline.from_arrays(
            fundus_arrays(per_domain_train=8, size=64), cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
            is_out_domain=True, seed=0, precompute_donor_amp=cfg.ram_precompute_donor_amp, device="cuda")
        plans = [pipe.epoch_plan() for _ in range(6)]  # batch 16 = 3+6+7 of 8 images a domain: 1 step an epoch
        plan = {k: np.concatenate([p[k] for p in plans])[:6] for k in plans[0]}
        state = init_state(cfg, torch.Generator().manual_seed(0), "cuda")
        g = torch.Generator().manual_seed(1)
        torch.cuda.synchronize()
        cuda_build.zero_launch_counts()
        with deterministic_mode(True):
            if name == "single":
                step = make_train_step(cfg, 20, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data)
                ms = [step(state, {k: v[i] for k, v in plan.items()}, g) for i in range(6)]
                metrics = {k: torch.stack([m[k].float() for m in ms]) for k in ms[0]}
                replays = 0
            else:
                window = make_train_step(cfg, 20, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data,
                                         scan=True, window=3)
                tables = [window(state, {k: v[i:i + 3] for k, v in plan.items()}, g)[0] for i in (0, 3)]
                metrics = {k: torch.cat([t[k] for t in tables]) for k in tables[0]}
                assert window.graphed()
                replays = window.replays
        counts = cuda_build.launch_counts()
        launched = (_k1(counts), counts["upsample2x.backward"], counts["upsample2x.forward"])
        runs[name] = (state, metrics, launched, replays)
    (a, ma, la, _), (b, mb, lb, replays) = runs["single"], runs["graph"]
    assert la == lb == (6, 48, 48) and replays == 4 and a.step == b.step == 6
    assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)
    for name, m in a.models.items():
        for k, v in m.state_dict().items():
            assert torch.equal(v, b.models[name].state_dict()[k]), f"{name}.{k}"
    pa = [p for m in a.models.values() for p in m.parameters()]
    pb = [p for m in b.models.values() for p in m.parameters()]
    for p, q in zip(pa, pb):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_default_graph_window_runs_k3_and_k2_eight_times_a_step(gen):
    """Two windows of 3 fundus steps at 64^2 without deterministic_mode (2
    eager steps, the capture and 4 replays): K3 and K2 run 8 times a step
    each, 48 in all, as the kernels count themselves on the card."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.synthetic import fundus_arrays
    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
                      is_out_domain=True, consistency=True, consistency_type="kd", image_size=64,
                      device="cuda").resolve()
    pipe = DeviceFundusPipeline.from_arrays(
        fundus_arrays(per_domain_train=8, size=64), cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
        is_out_domain=True, seed=0, precompute_donor_amp=cfg.ram_precompute_donor_amp, device="cuda")
    plans = [pipe.epoch_plan() for _ in range(6)]
    plan = {k: np.concatenate([p[k] for p in plans])[:6] for k in plans[0]}
    state = init_state(cfg, torch.Generator().manual_seed(0), "cuda")
    window = make_train_step(cfg, 20, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data,
                             scan=True, window=3)
    torch.cuda.synchronize()
    cuda_build.zero_launch_counts()
    g = torch.Generator().manual_seed(1)
    tables = [window(state, {k: v[i:i + 3] for k, v in plan.items()}, g)[0] for i in (0, 3)]
    counts = cuda_build.launch_counts()
    assert not torch.are_deterministic_algorithms_enabled() and window.graphed() and window.replays == 4
    assert (counts["upsample2x.backward"], counts["upsample2x.forward"]) == (48, 48)
    assert all(bool(torch.isfinite(t["loss"]).all()) for t in tables)


def test_replays_show_as_spans_on_card(gen):
    """A graph window of 3 fundus steps at 64^2 under torch.profiler, after
    the window that captured the graph: one `ramdsir.train.replay` span a
    replay the window made, all inside its `ramdsir.train.window`, and no
    eager step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.synthetic import fundus_arrays
    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
                      is_out_domain=True, consistency=True, consistency_type="kd", image_size=64,
                      device="cuda").resolve()
    pipe = DeviceFundusPipeline.from_arrays(
        fundus_arrays(per_domain_train=8, size=64), cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
        is_out_domain=True, seed=0, precompute_donor_amp=cfg.ram_precompute_donor_amp, device="cuda")
    plans = [pipe.epoch_plan() for _ in range(6)]
    plan = {k: np.concatenate([p[k] for p in plans])[:6] for k in plans[0]}
    state = init_state(cfg, torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    window = make_train_step(cfg, 20, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data,
                             scan=True, window=3)
    window(state, {k: v[:3] for k, v in plan.items()}, g)  # 2 eager steps, the capture, a replay
    before = window.replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window(state, {k: v[3:] for k, v in plan.items()}, g)
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("ramdsir.train."):
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    (w0, w1), = spans["ramdsir.train.window"]
    assert len(spans["ramdsir.train.replay"]) == window.replays - before == 3
    assert all(w0 <= s and e <= w1 for s, e in spans["ramdsir.train.replay"])
    assert "ramdsir.train.eager" not in spans and "ramdsir.train.capture" not in spans


# --- K2 and K3, the deterministic upsample, and a deterministic step ---------------

# (N, C, H, W) of the input: edges, odd sizes, and two U-Net stages of the
# fundus main path (seg decoder over the dual batch of 32: 256 ch at 16^2,
# 32 ch at 128^2); then the edges of the kernels' tiling (a thread owns 4
# float32 or 8 bfloat16 columns): W = 2, 3, 9 and 12 (not a multiple of 4 or
# 8: the scalar path), odd H, 4 planes of 4 x 8 (fewer threads than a
# block), W = 24 (3 bfloat16 column groups a row, rows across warp edges),
# and the prostate path's largest stages (seg decoder over 20 rows, rec
# decoder over 10, at 192^2)
K2_SHAPES = [(2, 3, 1, 1), (2, 3, 2, 1), (1, 4, 5, 7), (3, 5, 33, 17), (32, 256, 16, 16), (32, 32, 128, 128),
             (1, 2, 7, 2), (1, 3, 5, 3), (2, 2, 9, 9), (2, 3, 11, 12), (1, 4, 4, 8), (3, 5, 24, 24),
             (20, 32, 192, 192), (10, 16, 192, 192)]
SHAPE_IDS = [f"{s[0]}x{s[1]}x{s[2]}x{s[3]}" for s in K2_SHAPES]
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])


@DTYPES
@pytest.mark.parametrize("shape", K2_SHAPES, ids=SHAPE_IDS)
def test_k2_matches_plain(gen, shape, dtype):
    """K2 against its plain version on the card, bit for bit; one launch."""
    from ramdsir_tpu_torch.ops import upsample

    n, c, h, w = shape
    g = torch.randn((n, c, 2 * h, 2 * w), generator=gen, device="cuda").to(dtype)
    before = cuda_build.launch_counts()
    got = upsample.upsample2x_backward(g)
    want = upsample.upsample2x_backward_plain(g)
    assert _launched(before) == {"upsample2x.backward": 1}
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


@DTYPES
@pytest.mark.parametrize("shape", K2_SHAPES, ids=SHAPE_IDS)
def test_k3_matches_plain(gen, shape, dtype):
    """K3 against its plain version on the card, bit for bit; one launch,
    counted apart from K2's."""
    from ramdsir_tpu_torch.ops import upsample

    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    before = cuda_build.launch_counts()
    got = upsample.upsample2x_forward(x)
    want = upsample.upsample2x_forward_plain(x)
    assert _launched(before) == {"upsample2x.forward": 1}
    n, c, h, w = shape
    assert got.dtype == dtype and got.shape == (n, c, 2 * h, 2 * w)
    assert torch.equal(got, want)


@DTYPES
@pytest.mark.parametrize("offset", [1, 3])
def test_k2_and_k3_take_a_view_off_16_bytes(gen, dtype, offset):
    """An input `offset` elements into its storage (so not on 16 bytes)
    takes the scalar edge path of each kernel, bit-equal to the plain
    version; the same values on 16 bytes take the vector path, equal too."""
    from ramdsir_tpu_torch.ops import upsample

    x = torch.randn((4, 8, 16, 32), generator=gen, device="cuda").to(dtype)
    g = torch.randn((4, 8, 32, 64), generator=gen, device="cuda").to(dtype)
    xo, go = _at_offset(x, offset), _at_offset(g, offset)
    assert not upsample.vector_path(xo, torch.empty_like(g)) and upsample.vector_path(x, torch.empty_like(g))
    assert not upsample.vector_path(go, torch.empty_like(x)) and upsample.vector_path(g, torch.empty_like(x))
    want_y, want_g = upsample.upsample2x_forward_plain(x), upsample.upsample2x_backward_plain(g)
    for fwd, bwd in ((xo, go), (x, g)):
        y, dx = upsample.upsample2x_forward(fwd), upsample.upsample2x_backward(bwd)
        torch.cuda.synchronize()
        assert torch.equal(y, want_y) and torch.equal(dx, want_g)


def test_upsample_function_takes_channels_last_through_k3(gen):
    """`Upsample2x.apply` on a channels-last input (eval's activations: the
    predict path permutes NHWC images) makes it contiguous and launches K3
    once, bit-equal to the plain forward; its backward launches K2 once."""
    from ramdsir_tpu_torch.ops import upsample

    x = torch.randn((2, 16, 12, 16), generator=gen, device="cuda").contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    before = cuda_build.launch_counts()
    y = upsample.Upsample2x.apply(x)
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert _launched(before) == {"upsample2x.forward": 1, "upsample2x.backward": 1}
    assert torch.equal(y, upsample.upsample2x_forward_plain(x.detach()))
    assert torch.equal(dx, upsample.upsample2x_backward_plain(torch.ones_like(y)))


def test_k3_refuses_what_it_cannot_take(gen):
    from ramdsir_tpu_torch.ops import upsample

    x = torch.randn((2, 4, 8, 6), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="NCHW contiguous"):
        upsample.upsample2x_forward(x.transpose(2, 3))
    with pytest.raises(ValueError, match="NCHW contiguous"):
        upsample.upsample2x_forward(x.contiguous(memory_format=torch.channels_last))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        upsample.upsample2x_forward(x.double())


def _fundus_steps(cfg, steps=2, deterministic=True):
    """`steps` steps of a fresh state and a fresh pipeline from one seed,
    under deterministic_mode or without it; the state, the metrics and K2's
    and K3's launches."""
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.synthetic import fundus_arrays
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
    before = cuda_build.launch_counts()
    with deterministic_mode(deterministic):
        for _ in range(steps):
            metrics.append({k: v.clone() for k, v in step(state, next(rows), gen).items()})
    launched = _launched(before)
    return state, metrics, (launched.get("upsample2x.backward", 0), launched.get("upsample2x.forward", 0))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_deterministic_steps_repeat_bit_for_bit(gen, compute_dtype):
    """Two runs of two fundus steps from one seed under deterministic_mode:
    parameters, BN statistics, Adam moments and losses bit-equal; K2 and K3
    launched 8 times a step each; the mode is off afterwards."""
    from ramdsir_tpu_torch.config import TrainConfig

    cfg = TrainConfig(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
                      is_out_domain=True, consistency=True, consistency_type="kd", image_size=64,
                      compute_dtype=compute_dtype, device="cuda").resolve()
    (a, ma, ka), (b, mb, kb) = _fundus_steps(cfg), _fundus_steps(cfg)
    assert not torch.are_deterministic_algorithms_enabled()
    assert ka == kb == (2 * 8, 2 * 8)
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


def test_default_step_matches_the_step_on_atens_upsample(gen, monkeypatch):
    """One fundus step at 64^2 from one seed without deterministic_mode
    (TF32 off), on the default route (K3 forward, K2 backward, 8 launches
    each) and with every x2 upsample sent to aten's kernels instead (none):
    the losses within tests/test_torch_port_step.py's metric bound (rtol
    2e-4, atol 2e-5), each gradient (Adam's first moment over 1 - beta1)
    within its check_step_gradients rule (3e-4 + 2% of the largest element;
    at most 1e-4 of the elements past it, none past 5 times it; cosine over
    all > 0.9999), parameters within 2.5*lr and running statistics at rtol
    1e-4, atol 1e-5."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.models import unet

    cfg = TrainConfig(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
                      is_out_domain=True, consistency=True, consistency_type="kd", image_size=64,
                      device="cuda").resolve()
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a, (ma,), ka = _fundus_steps(cfg, steps=1, deterministic=False)
        monkeypatch.setattr(unet, "kernels_take", lambda x: False)
        b, (mb,), kb = _fundus_steps(cfg, steps=1, deterministic=False)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert ka == (8, 8) and kb == (0, 0)
    assert ma.keys() == mb.keys()
    for k in ma:
        torch.testing.assert_close(ma[k].float(), mb[k].float(), rtol=2e-4, atol=2e-5, msg=k)
    beta1 = a.optimizer.param_groups[0]["betas"][0]
    dots = norm_a = norm_b = 0.0
    for name, m in a.models.items():
        other = dict(b.models[name].named_parameters())
        for k, p in m.named_parameters():
            got, want = (s.optimizer.state[t]["exp_avg"].double() / (1 - beta1) for s, t in ((a, p), (b, other[k])))
            tol = 3e-4 + 2e-2 * float(want.abs().max())
            err = (got - want).abs()
            assert float((err > tol).double().mean()) <= 1e-4 and float(err.max()) <= 5 * tol, f"{name}.{k}"
            dots += float((got * want).sum())
            norm_a += float((got * got).sum())
            norm_b += float((want * want).sum())
        for k, v in m.state_dict().items():
            tol = dict(rtol=1e-4, atol=1e-5) if "running" in k else dict(rtol=0, atol=2.5 * cfg.lr)
            torch.testing.assert_close(v, b.models[name].state_dict()[k], **tol, msg=f"{name}.{k}")
    assert dots / (norm_a * norm_b) ** 0.5 > 0.9999


# --- the single-card variants ---------------------------------------------------------


@pytest.mark.parametrize("norm", ["gn", "in"])
def test_norm_forward_on_card_matches_cpu(gen, norm):
    """The encoder + seg decoder with GroupNorm / InstanceNorm in train mode,
    the same weights on the card and on the CPU (float32, TF32 off): logits
    within the models' feature bound of tests/test_torch_port_models.py
    (FEAT_TOL, atol 5e-4, rtol 1e-3; InstanceNorm's statistics over the 4x4
    bottleneck put the two 3.3e-4 apart at most)."""
    from ramdsir_tpu_torch.models.unet import Decoder, Encoder, init_weights

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = torch.randn((4, 3, 64, 64), generator=torch.Generator().manual_seed(2))
        out = {}
        for dev in ("cpu", "cuda"):
            enc, dec = Encoder(norm=norm), Decoder(norm=norm)
            for m in (enc, dec):
                init_weights(m, torch.Generator().manual_seed(3))
                m.to(dev).train()
            with torch.no_grad():
                out[dev] = dec(enc(x.to(dev))).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=5e-4, rtol=1e-3)


def test_remat_on_card_is_bit_equal_under_deterministic(gen):
    """Two fundus steps with and without --remat under deterministic_mode:
    the running statistics (which the recompute must not update again), the
    parameters, the Adam moments and the losses bit-equal."""
    from ramdsir_tpu_torch.config import TrainConfig

    base = dict(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True, is_out_domain=True,
                consistency=True, consistency_type="kd", image_size=64, device="cuda")
    (a, ma, _), (b, mb, _) = (_fundus_steps(TrainConfig(**base, remat=r).resolve()) for r in (False, True))
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


def _host_batches(n, seed=0):
    """Fundus-like host batches as the loaders give them: uint8 img, donor
    and mask at 16 x 256^2."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"img": rng.integers(0, 256, (16, 256, 256, 3), dtype=np.uint8),
             "donor": rng.integers(0, 256, (16, 256, 256, 3), dtype=np.uint8),
             "mask": rng.integers(0, 2, (16, 256, 256, 2), dtype=np.uint8)} for _ in range(n)]


def test_host_to_device_stream_copies_beside_the_compute_stream(gen):
    """HostToDevice yields each host batch's values on the card with no
    synchronise in the iteration (torch's sync debug mode raises on one),
    and its copies run on a stream of their own: with the compute stream
    held busy, the next batch's copy completes meanwhile."""
    from ramdsir_tpu_torch.train.loop import HostToDevice

    batches = _host_batches(5)
    stream = HostToDevice(batches, torch.device("cuda"), depth=2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        it = iter(stream)
        got = [next(it)]
        torch.cuda._sleep(int(2e9))  # about a second of the compute stream
        busy = torch.cuda.Event()
        busy.record()
        got.append(next(it))  # queues the third batch's copy
        torch.cuda.set_sync_debug_mode(0)
        stream._events[2][1].synchronize()
        assert not busy.query(), "the copy waited for the compute stream"
        torch.cuda.set_sync_debug_mode("error")
        got += list(it)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(got) == 5 and len(stream.wait_ms) == 5 and len(stream.h2d_ms()) == 5
    for g, b in zip(got, batches):
        assert set(g) == set(b)
        for k, v in b.items():
            assert g[k].is_cuda and g[k].dtype == torch.uint8
            assert torch.equal(g[k].cpu(), torch.from_numpy(v)), k


def test_viz_ring_append_does_not_synchronise(gen):
    from ramdsir_tpu_torch.utils.logging import DeviceVizRing

    viz = {"image": torch.rand((3, 64, 64, 3), generator=gen, device="cuda"),
           "mask": torch.randint(0, 2, (3, 64, 64), generator=gen, device="cuda", dtype=torch.int32)}
    ring, got = DeviceVizRing(), []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ring.append(7, viz)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ring.flush(lambda v, s: got.append((v, s)))
    assert len(got) == 1 and got[0][1] == 7
    for k, v in viz.items():
        assert torch.equal(torch.from_numpy(got[0][0][k]), v.cpu()), k


@pytest.mark.parametrize("loader", ["thread", "process"])
def test_fit_on_host_loaders_on_card(gen, tmp_path, loader):
    """fit(device_data=False) on the card: two steps from a small PNG tree,
    one K1 launch (full mode) a step, finite losses, the copies' time in
    the epoch's input row, the image grids of step 0."""
    import json
    import math
    import os

    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.synthetic import make_fundus_tree
    from ramdsir_tpu_torch.train.loop import fit

    make_fundus_tree(str(tmp_path / "data"), per_domain_train=8, per_domain_test=2, size=80)
    cfg = TrainConfig(data_root=str(tmp_path / "data"), dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0,
                      image_size=64, is_out_domain=True, epochs=1, save_path=str(tmp_path / "run"), device="cuda",
                      device_data=False, loader=loader, num_workers=2, test_batch_size=2)
    before = cuda_build.launch_counts()
    summary = fit(cfg, max_steps=2)
    launched = _launched(before)
    assert summary["steps"] == 2 and _k1(launched) == 2 and launched["ram_mix.full_vec"] == 2
    rows = [json.loads(line) for line in open(os.path.join(cfg.save_path, "log", "metrics.jsonl"))]
    losses = [v for r in rows for k, v in r.items() if k.startswith("loss/")]
    assert len(losses) == 14 and all(math.isfinite(v) for v in losses)
    (inp,) = [r for r in rows if "input/h2d_ms" in r]
    assert inp["input/h2d_ms"] > 0 and inp["input/device_peak_bytes"] > 0
    assert len(os.listdir(os.path.join(cfg.save_path, "log", "images"))) == 7


# --- data-parallel steps on the card ------------------------------------------------


def _ddp_inputs(b, hw, seed=0):
    import numpy as np

    from ramdsir_tpu_torch.ops.ram import banded_amplitude_spectrum

    rng = np.random.default_rng(seed)
    donor = torch.from_numpy(rng.uniform(0, 255, (b, hw, hw, 3)).astype(np.float32))
    batch = {
        "img": rng.uniform(0, 255, (b, hw, hw, 3)).astype(np.float32),
        "mask": (rng.uniform(size=(b, hw, hw, 2)) > 0.5).astype(np.float32),
        "donor_amp": banded_amplitude_spectrum(donor).numpy(),
    }
    return batch, rng.uniform(0, 1, b).astype(np.float32)


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")], ids=["nccl_world1", "gloo_world2_one_card"])
def test_ddp_step_on_card_matches_single_process(gen, world, backend):
    """One fundus step (batch 3+6+7 at 64^2) on `world` ranks on cuda:0
    against the same step without a process group, TF32 off: step_parity's
    bounds (losses within 1e-5 relative, parameters within 2.5 lr, running
    statistics rtol 1e-4 / atol 1e-5), the replicas bit-equal, K1 launched
    once on every rank."""
    import tests._ddp_ranks as ranks
    from ramdsir_tpu_torch.parallel import distributed

    cfg = dict(dataset="fundus", image_size=64, domain_idxs=(0, 1, 2), test_domain_idx=3, log_images_every=0)
    batch, ratio = _ddp_inputs(16, 64)
    case = dict(cfg_kw=cfg, bsl=[3, 6, 7], batches=[batch], ratios=[ratio])
    got = distributed.launch(ranks.run_cases, world, devices=["cuda:0"] * world, backend=backend,
                             args=([("step", "step", case)],), timeout_s=300.0)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    ranks.exact_float32()
    try:
        want = ranks.step_case(**case, device="cuda")
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = saved
    lr = 2e-3
    for r in got:
        res = r["step"]
        assert res["k1_launches"] == 1
        for k, w in want["metrics"][0].items():
            assert abs(res["metrics"][0][k] - w) <= 1e-5 * max(abs(w), 1e-6), (k, res["metrics"][0][k], w)
        for name, sd in want["state0"].items():
            for k, w in sd.items():
                tol = dict(rtol=1e-4, atol=1e-5) if "running" in k else dict(rtol=0, atol=2.5 * lr)
                assert np.allclose(res["state0"][name][k], w, **tol), f"{name}.{k}"
    assert len({r["step"]["digests"][0] for r in got}) == 1


# --- the grouped batch norm (csrc/batch_norm.cu) ----------------------------------------


def _bn_step_cases():
    """(config, (rows, C, side, groups)) of every distinct norm of a fundus
    and a prostate training step at the benchmark's shapes."""
    import json

    from tools.batch_norm_study import CONFIGS, step_norms

    out = []
    for name, path in CONFIGS.items():
        with open(path) as f:
            out += [(name, key) for key in sorted(step_norms(json.load(f)))]
    return out


BN_CASES = _bn_step_cases()
BN_IDS = [f"{c}-{k[0]}x{k[1]}x{k[2]}-{'+'.join(str(g[0]) for g in k[3])}" for c, k in BN_CASES]
# float32 kernels against the float64 plain version, as a share of each
# result's largest magnitude: the largest reading over both steps' norms on
# an H100 was 8.7e-7 (dweight, sums over up to 1.5M values a channel); 5e-6
# leaves room for other draws and stays far below what a wrong count, a
# skipped unit or a stale partial gives (0.4 to 1e12)
BN_TOL = 5e-6


@pytest.mark.parametrize("config, key", BN_CASES, ids=BN_IDS)
def test_batch_norm_kernels_match_plain_at_step_shapes(gen, config, key):
    """The forward and backward kernels at every norm shape of both steps
    (dual halves and DSBN domains) against the plain version in float64 on
    the same inputs: y, dx, dweight, dbias, mean, invstd and the running
    buffers within BN_TOL; two runs bit for bit."""
    from ramdsir_tpu_torch.ops import batch_norm as bn
    from tools.batch_norm_study import case_inputs, check_case

    rows, c, side, groups = key
    x, dy, w, b, rm, rv = case_inputs(torch, gen, rows, c, side, groups)
    res = check_case(torch, bn, x, dy, bn.Layout(groups), w, b, rm, rv)
    assert res.pop("repeat_equal")
    assert max(res.values()) <= BN_TOL, res


@pytest.mark.parametrize("shape, offset", [((7, 5, 6, 5), 0), ((6, 8, 8, 8), 1), ((6, 8, 8, 8), 0)],
                         ids=["hw30", "off16", "vec"])
def test_batch_norm_kernels_scalar_and_vector_paths(gen, shape, offset):
    """H*W % 4 != 0 and a tensor off 16 bytes take the 1-float path, an
    aligned one the 16-byte path; each within BN_TOL of the float64 plain
    version, with n_valid padding rows in each of two groups and a third
    group of its own slot."""
    from ramdsir_tpu_torch.ops import batch_norm as bn
    from tools.batch_norm_study import check_case

    n = shape[0]
    layout = bn.Layout(((n // 2, n // 2 - 1, 0), (n // 2 - 1, 1, 0), (n - 2 * (n // 2) + 1, 1, 1)))
    x = _at_offset(torch.randn(shape, generator=gen, device="cuda") * 3 + 1, offset)
    dy = _at_offset(torch.randn(shape, generator=gen, device="cuda"), offset)
    assert bn._plan_for(x, layout, dy).vec == (shape[2] * shape[3] % 4 == 0 and offset == 0)
    c = shape[1]
    w = [torch.rand(c, generator=gen, device="cuda") + 0.5 for _ in range(2)]
    b = [torch.randn(c, generator=gen, device="cuda") for _ in range(2)]
    rm, rv = [torch.zeros(c, device="cuda")] * 2, [torch.ones(c, device="cuda")] * 2
    res = check_case(torch, bn, x, dy, layout, w, b, rm, rv)
    assert res.pop("repeat_equal")
    assert max(res.values()) <= BN_TOL, res


def test_batch_norm_graph_replays_match_eager_and_count(gen):
    """The module's forward and backward captured in a CUDA graph: each
    replay bit-equal to the eager call, running statistics included; the
    kernels' device counter moves by one a kernel at the eager call and at
    each of 3 replays."""
    from ramdsir_tpu_torch.models.norm import BatchNorm

    m = BatchNorm(16).cuda().train()
    x = torch.randn((8, 16, 32, 32), generator=gen, device="cuda", requires_grad=True)
    dy = torch.randn((8, 16, 32, 32), generator=gen, device="cuda")

    def run():
        y = m(x, dual=True)
        return (y, *torch.autograd.grad(y, [x, m.weight, m.bias], dy))

    start = [t.clone() for t in (m.running_mean, m.running_var)]
    # as train.steps.ScanTrainSteps: the eager calls on the side stream that
    # then captures (autograd's backward must not touch the default stream)
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()  # the library and the device counter, before the capture
        torch.cuda.synchronize()
        for t, s in zip((m.running_mean, m.running_var), start):
            t.copy_(s)
        cuda_build.zero_launch_counts()
        eager = [t.clone() for t in run()] + [m.running_mean.clone(), m.running_var.clone()]
        with torch.cuda.graph(graph, stream=side):
            outs = run()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        for t, s in zip((m.running_mean, m.running_var), start):
            t.copy_(s)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(eager, [*outs, m.running_mean, m.running_var]))
    assert {k: n for k, n in cuda_build.launch_counts().items() if k.startswith("batch_norm.")} == dict.fromkeys(
        ("batch_norm.stats", "batch_norm.forward", "batch_norm.backward_reduce", "batch_norm.backward"), 4)


def test_batch_norm_wrapper_refuses_what_the_kernels_cannot_take(gen):
    from ramdsir_tpu_torch.ops import batch_norm as bn

    x = torch.randn((4, 3, 8, 8), generator=gen, device="cuda")
    w, b = [torch.ones(3, device="cuda")], [torch.zeros(3, device="cuda")]
    layout = bn.halves(4, 1)
    run = lambda t, w=w: bn.grouped_batch_norm(t, layout, w, b, [None], [None], 0.1, 1e-5)
    with pytest.raises(TypeError, match="float32 tensors only"):
        run(x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="NCHW contiguous"):
        run(x.contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError, match="NCHW contiguous"):
        run(x.transpose(2, 3))
    with pytest.raises(ValueError, match="weights, biases and running buffers"):
        run(x, [torch.ones(3)])
    with pytest.raises(ValueError, match="1 to 8 groups"):
        bn.grouped_batch_norm(x.repeat(3, 1, 1, 1), bn.halves(1, 12), w, b, [None], [None], 0.1, 1e-5)


def test_train_step_runs_every_norm_through_the_kernels(gen):
    """Two graph windows of 3 fundus steps at 64^2 (2 eager steps, the
    capture and 4 replays): each of the four kernels runs once for each of
    the step's 38 norms (26 dual BatchNorms, 12 segment DSBNs) every step,
    as the kernels count themselves on the card."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.synthetic import fundus_arrays
    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
                      is_out_domain=True, consistency=True, consistency_type="kd", image_size=64,
                      device="cuda").resolve()
    pipe = DeviceFundusPipeline.from_arrays(
        fundus_arrays(per_domain_train=8, size=64), cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
        is_out_domain=True, seed=0, precompute_donor_amp=cfg.ram_precompute_donor_amp, device="cuda")
    plans = [pipe.epoch_plan() for _ in range(6)]
    plan = {k: np.concatenate([p[k] for p in plans])[:6] for k in plans[0]}
    state = init_state(cfg, torch.Generator().manual_seed(0), "cuda")
    window = make_train_step(cfg, 20, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data,
                             scan=True, window=3)
    torch.cuda.synchronize()
    cuda_build.zero_launch_counts()
    g = torch.Generator().manual_seed(1)
    for i in (0, 3):
        window(state, {k: v[i:i + 3] for k, v in plan.items()}, g)
    counts = cuda_build.launch_counts()
    assert window.graphed() and window.replays == 4
    assert {k: n for k, n in counts.items() if k.startswith("batch_norm.")} == dict.fromkeys(
        ("batch_norm.stats", "batch_norm.forward", "batch_norm.backward_reduce", "batch_norm.backward"), 6 * 38)


def test_transunet_attention_runs_the_memory_efficient_kernel(gen):
    """TransUNet's attention on the card enables SDPA's memory-efficient
    backend alone, so that a result is that kernel's: float32 at ViT-B/16's
    heads at 512^2 (12 of 64 over 1,024 tokens) within 2e-5 of the float64
    product; an input that backend refuses (float64) raises rather than fall
    back to the math backend, which would have run it.  (The benchmark's
    trace names the kernels, `fmha_cutlass{F,B}`; this test reads no trace,
    since the profiler drops kernel records on this card.)"""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from ramdsir_tpu_torch.models.transunet import attention

    q, k, v = (torch.randn(2, 12, 1024, 64, device="cuda", generator=gen) for _ in range(3))
    out = attention(q, k, v)
    want = torch.softmax(q.double() @ k.double().transpose(-1, -2) / 8.0, -1) @ v.double()
    assert (out.double() - want).abs().max().item() < 2e-5
    with sdpa_kernel([SDPBackend.MATH]):  # the math backend takes float64 ...
        torch.nn.functional.scaled_dot_product_attention(q.double(), k.double(), v.double())
    with pytest.raises(RuntimeError):  # ... and attention() does not fall back to it
        attention(q.double(), k.double(), v.double())


def test_transunet_graph_window_matches_eager_steps(gen, monkeypatch):
    """Two windows of 3 tiny TransUNet steps at 64^2 (2 eager steps, the
    capture, 4 replays) against 6 single eager steps from the same seed, at
    lr 0, so that every step's loss is its forward's on the same weights
    (the memory-efficient attention's and the align_corners upsample's
    backwards add with atomics, which a trained state would carry into the
    next step's loss): each step's loss equal within 1e-6 (a replay that
    reused another step's dropout seeds or rows would part by ~1e-2), the
    six losses unlike each other (every step its own draws), K1 run once a
    step on the card, 4 replays, and the counters: the tokens of a step's
    two halves through the memory-efficient attention."""
    from ramdsir_tpu_torch.config import TrainConfig
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.synthetic import fundus_arrays
    from ramdsir_tpu_torch.models.transunet import counters
    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step
    from tests._transunet_tiny import register

    cfg = TrainConfig(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True,
                      is_out_domain=True, consistency=True, consistency_type="kd", image_size=64, lr=0.0,
                      model=register(monkeypatch), s2d_levels=0, device="cuda").resolve()
    losses = {}
    for name in ("single", "graph"):
        pipe = DeviceFundusPipeline.from_arrays(
            fundus_arrays(per_domain_train=8, size=64), cfg.domain_idxs, cfg.batch_size_list, cfg.test_domain_idx,
            is_out_domain=True, seed=0, precompute_donor_amp=cfg.ram_precompute_donor_amp, device="cuda")
        plans = [pipe.epoch_plan() for _ in range(6)]
        plan = {k: np.concatenate([p[k] for p in plans])[:6] for k in plans[0]}
        state = init_state(cfg, torch.Generator().manual_seed(0), "cuda")
        g = torch.Generator().manual_seed(1)
        torch.cuda.synchronize()
        cuda_build.zero_launch_counts()
        if name == "single":
            step = make_train_step(cfg, 20, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data)
            losses[name] = torch.stack([step(state, {k: v[i] for k, v in plan.items()}, g)["loss"] for i in range(6)])
        else:
            window = make_train_step(cfg, 20, batch_size_list=cfg.batch_size_list, device_data=pipe.device_data,
                                     scan=True, window=3)
            losses[name] = torch.cat([window(state, {k: v[i:i + 3] for k, v in plan.items()}, g)[0]["loss"]
                                      for i in (0, 3)])
            assert window.graphed() and window.replays == 4
        assert _k1(cuda_build.launch_counts()) == 6 and state.step == 6
        enc = state.models["encoder"]
        assert counters(enc) == {"vit_tokens": 2 * sum(cfg.batch_size_list) * enc.grid ** 2, "attn_backend": "efficient"}
    a, b = losses["single"].double().cpu(), losses["graph"].double().cpu()
    assert torch.isfinite(a).all() and ((a - b).abs() / a.abs()).max().item() < 1e-6, (a, b)
    assert len(set(a.tolist())) == 6, a
