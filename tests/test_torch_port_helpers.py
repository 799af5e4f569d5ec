"""The port's helper modules against the JAX package's on the CPU: the rest
of the loss library (`ops/losses.py`, within 1e-6 relative, gradients
within 1e-5 relative L2), the metrics (`ops/metrics.py`, equal), the viz
writers (`utils/viz.py`: pixels read back with the port's decoder equal to
JAX's read with PIL; the JET table equal to cv2's), `utils/nn_utils.py`,
`utils/data_utils.py`, `utils/od_coords.py` (equal), the small API gaps
(`StepTimer.steps_per_sec`, `trace_context`, `MetricsWriter.add_scalar`)
and the packages' re-exports.  Inputs come from numpy seeds."""
import json
import logging
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import ramdsir_tpu.ops.losses as jl
import ramdsir_tpu.ops.metrics as jm
import ramdsir_tpu.utils.data_utils as jdu
import ramdsir_tpu.utils.nn_utils as jnu
import ramdsir_tpu.utils.od_coords as joc
import ramdsir_tpu.utils.viz as jviz
import ramdsir_tpu_torch.ops.losses as tl
import ramdsir_tpu_torch.ops.metrics as tm
import ramdsir_tpu_torch.utils.data_utils as tdu
import ramdsir_tpu_torch.utils.nn_utils as tnu
import ramdsir_tpu_torch.utils.od_coords as toc
import ramdsir_tpu_torch.utils.viz as tviz
from ramdsir_tpu_torch.data import png
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

LOSS_REL = 1e-6
GRAD_REL_L2 = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _probs(rng, shape):
    e = np.exp(rng.normal(size=shape))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# --- losses -------------------------------------------------------------------


def _loss_cases():
    """name -> (inputs as numpy, kwargs); class axis last, (2, 6, 5, C)."""
    rng = _rng(0)
    logits_a = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
    logits_b = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
    p3 = _probs(rng, (2, 6, 5, 3))
    p2 = _probs(rng, (2, 6, 5, 2))
    pred = rng.uniform(0.0, 1.0, (2, 6, 5, 2)).astype(np.float32)
    pred[0, 0, 0] = [0.0, 1.0]  # saturated: the floored logs
    target = (rng.uniform(size=(2, 6, 5, 2)) > 0.5).astype(np.float32)
    labels = rng.integers(0, 3, (2, 6, 5))
    return {
        "bce_loss": ((pred, target), {}),
        "dice_loss1": ((pred, target), {}),
        "entropy_loss": ((p2,), {}),
        "entropy_loss[C=3]": ((p3,), {"num_classes": 3}),
        "entropy_loss_map": ((p3,), {"num_classes": 3}),
        "entropy_minimization": ((p3,), {}),
        "entropy_map": ((p2,), {}),
        "softmax_dice_loss": ((logits_a, logits_b), {}),
        "softmax_mse_loss": ((logits_a, logits_b), {}),
        "softmax_kl_loss": ((logits_a, logits_b), {}),
        "symmetric_mse_loss": ((logits_a, logits_b), {}),
        "focal_loss": ((logits_a, labels), {}),
        "focal_loss[gamma=0.5, sum]": ((logits_a, labels), {"gamma": 0.5, "size_average": False}),
        "focal_loss[alpha=0.25]": ((logits_a[..., :2], labels % 2), {"alpha": 0.25}),
        "focal_loss[alpha=list]": ((logits_a, labels), {"alpha": [0.2, 0.3, 0.5]}),
    }


LOSS_CASES = _loss_cases()


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_its_gradient_equal_jax(case):
    """The value (or the unreduced map) within 1e-6 relative of JAX's, and
    the gradient of its sum with respect to every float input within 1e-5
    relative L2."""
    name = case.split("[")[0]
    args, kw = LOSS_CASES[case]
    floats = [i for i, a in enumerate(args) if a.dtype == np.float32]

    def jax_total(*fargs):
        full = list(args)
        for i, a in zip(floats, fargs):
            full[i] = a
        return jnp.sum(getattr(jl, name)(*[jnp.asarray(a) for a in full], **kw))

    want = np.asarray(getattr(jl, name)(*[jnp.asarray(a) for a in args], **kw))
    jgrads = jax.grad(jax_total, argnums=tuple(range(len(floats))))(*[jnp.asarray(args[i]) for i in floats])

    targs = [torch.tensor(a, requires_grad=a.dtype == np.float32) for a in args]
    got = getattr(tl, name)(*targs, **kw)
    assert tuple(got.shape) == want.shape
    err = float(np.max(np.abs(got.detach().numpy() - want)))
    assert err <= LOSS_REL * max(float(np.max(np.abs(want))), 1e-30), (err, want)
    torch.sum(got).backward()
    for i, g in zip(floats, jgrads):
        g = np.asarray(g)
        ours = targs[i].grad.numpy()
        assert np.linalg.norm(ours - g) <= GRAD_REL_L2 * np.linalg.norm(g), (case, i)


# --- metrics ------------------------------------------------------------------


def _blobs(seed, shape=(40, 36)):
    rng = _rng(seed)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    out = np.zeros(shape, bool)
    for _ in range(3):
        cy, cx, r = rng.uniform(6, shape[0] - 6), rng.uniform(6, shape[1] - 6), rng.uniform(2, 7)
        out |= np.hypot(yy - cy, xx - cx) < r
    return out


def test_binary_metrics_equal_jax():
    """jaccard_binary, assd and calculate_metric_percase, bit-equal (float64
    host math) on 2-D and 3-D cases, empty ones included."""
    cases = [(_blobs(s), _blobs(s + 100)) for s in range(6)]
    cases.append((np.stack([_blobs(1), _blobs(2)]), np.stack([_blobs(3), _blobs(4)])))
    for pred, gt in cases:
        assert tm.jaccard_binary(pred, gt) == jm.jaccard_binary(pred, gt)
        assert tm.assd(pred, gt) == jm.assd(pred, gt)
        assert tm.calculate_metric_percase(pred, gt) == jm.calculate_metric_percase(pred, gt)
    empty = np.zeros((8, 8), bool)
    assert tm.jaccard_binary(empty, empty) == jm.jaccard_binary(empty, empty) == 0.0
    with pytest.raises(RuntimeError, match="first input"):
        tm.assd(empty, np.ones((8, 8), bool))


def test_dice_multi_class_and_segmentation_metric_equal_jax():
    rng = _rng(3)
    for num_classes, ignore in ((3, None), (3, 0), (4, 2)):
        pred = rng.integers(0, num_classes, (2, 9, 7))
        target = rng.integers(0, num_classes, (2, 9, 7))
        assert tm.dice_multi_class(pred, target, num_classes, ignore) == \
            jm.dice_multi_class(pred, target, num_classes, ignore)
    ours, want = tm.SegmentationMetric(3), jm.SegmentationMetric(3)
    for _ in range(3):
        pred = rng.integers(0, 3, (11, 13))
        label = rng.integers(-1, 4, (11, 13))  # labels outside [0, 3) are skipped
        ours.update(pred, label)
        want.update(pred, label)
    np.testing.assert_array_equal(ours.hist, want.hist)
    np.testing.assert_array_equal(ours.iou(), want.iou())
    assert ours.mean_iou() == want.mean_iou()
    # tests/test_metrics.py's case
    m = tm.SegmentationMetric(2)
    m.update(np.array([[0, 1], [1, 1]]), np.array([[0, 1], [0, 1]]))
    assert abs(m.iou()[1] - 2 / 3) < 1e-12


# --- viz ----------------------------------------------------------------------


def test_jet_table_equals_cv2_for_every_value():
    want = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_JET)[:, 0]
    np.testing.assert_array_equal(tviz.JET_BGR, want)


def test_viz_writers_equal_jax(tmp_path):
    """construct_color_img, entropy_map, mask_contour and untransform equal;
    draw_ent / draw_mask / draw_boundary write the pixels JAX writes (the
    port's files read with its decoder, JAX's with PIL)."""
    rng = _rng(5)
    for shape in ((17, 23, 2), (16, 16, 3)):
        probs = _probs(rng, shape)
        np.testing.assert_array_equal(tviz.entropy_map(probs), jviz.entropy_map(probs))
        np.testing.assert_array_equal(tviz.construct_color_img(probs[..., -1]), jviz.construct_color_img(probs[..., -1]))
        mask = _blobs(int(shape[0]), shape[:2])
        np.testing.assert_array_equal(tviz.mask_contour(mask), jviz.mask_contour(mask))
        for fn, arg in ((tviz.draw_ent, probs), (tviz.draw_mask, probs), (tviz.draw_mask, probs[..., 0]),
                        (tviz.draw_boundary, mask)):
            ours = fn(arg, str(tmp_path / "port"), "case.png")
            want = getattr(jviz, fn.__name__)(arg, str(tmp_path / "jax"), "case.png")
            assert os.path.basename(ours) == os.path.basename(want)
            np.testing.assert_array_equal(png.decode(ours).array, np.asarray(Image.open(want)))
    flat = np.full((5, 5), 0.3, np.float32)  # max == min
    np.testing.assert_array_equal(tviz.construct_color_img(flat), jviz.construct_color_img(flat))
    img = rng.uniform(-1, 1, (3, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(tviz.untransform(img), jviz.untransform(img))
    np.testing.assert_array_equal(tviz.untransform_prostate(img), jviz.untransform_prostate(img))


# --- nn_utils -----------------------------------------------------------------


def _nhwc_to_nchw(a):
    return torch.from_numpy(np.array(np.moveaxis(np.asarray(a), -1, 1)))


def test_nn_utils_probability_prediction_one_hot_equal_jax():
    rng = _rng(6)
    for channels in (1, 2, 5):
        logits = rng.normal(size=(2, 7, 6, channels)).astype(np.float32)
        want = np.asarray(jnu.get_probability(jnp.asarray(logits)))
        for axis, x in ((1, _nhwc_to_nchw(logits)), (-1, torch.from_numpy(logits))):
            got = tnu.get_probability(x, axis=axis).numpy()
            np.testing.assert_allclose(np.moveaxis(got, 1, -1) if axis == 1 else got, want, rtol=1e-6, atol=1e-7)
        probs = np.array(want)
        wpred = np.asarray(jnu.get_prediction(jnp.asarray(probs)))
        for axis, x in ((1, _nhwc_to_nchw(probs)), (-1, torch.from_numpy(probs))):
            got = tnu.get_prediction(x, axis=axis).numpy()
            got = np.moveaxis(got, 1, -1) if axis == 1 and got.ndim == 4 else got
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, wpred)
    labels = rng.integers(-1, 4, (3, 5))  # -1 and 3 outside [0, 3): zero rows
    want = np.asarray(jnu.to_one_hot(jnp.asarray(labels), 3))
    np.testing.assert_array_equal(tnu.to_one_hot(torch.from_numpy(labels), 3, axis=-1).numpy(), want)
    np.testing.assert_array_equal(tnu.to_one_hot(torch.from_numpy(labels), 3, axis=1).numpy(), np.moveaxis(want, -1, 1))


@pytest.mark.parametrize("src,dst", [((4, 4), (16, 16)), ((16, 12), (5, 7)), ((9, 9), (9, 4)), ((6, 10), (13, 3))],
                         ids=["up", "down", "down_one_axis", "mixed"])
def test_make_same_size_equals_jax_both_ways(src, dst):
    """Bilinear with antialiasing where a side shrinks, as jax.image.resize."""
    x = _rng(7).normal(size=(2, *src, 3)).astype(np.float32)
    ref = np.zeros((2, *dst, 1), np.float32)
    want = np.asarray(jnu.make_same_size(jnp.asarray(x), jnp.asarray(ref)))
    got = tnu.make_same_size(_nhwc_to_nchw(x), _nhwc_to_nchw(ref)).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), want, rtol=1e-5, atol=1e-5)


def test_sgd_fast_weights_timer_mkdir_logger(tmp_path):
    rng = _rng(8)
    p = {"w": rng.normal(size=(3, 2)).astype(np.float32), "b": rng.normal(size=3).astype(np.float32)}
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    want = jnu.sgd_fast_weights({k: jnp.asarray(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in g.items()}, 0.1)
    got = tnu.sgd_fast_weights({k: torch.from_numpy(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in g.items()}, 0.1)
    for k in p:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    lst = tnu.sgd_fast_weights([torch.from_numpy(p["w"])], [torch.from_numpy(g["w"])], 0.1)
    np.testing.assert_array_equal(lst[0].numpy(), np.asarray(want["w"]))
    with tnu.Timer("t") as t:
        pass
    assert t.elapsed >= 0.0
    assert tnu.mkdir(str(tmp_path / "a" / "b")) == str(tmp_path / "a" / "b") and os.path.isdir(tmp_path / "a" / "b")
    log_file = str(tmp_path / "logs" / "x.log")
    logger = tnu.get_logger("ramdsir_tpu_torch.test_helpers", log_file, logging.INFO)
    logger.info("hello")
    assert len(tnu.get_logger("ramdsir_tpu_torch.test_helpers").handlers) == 2
    for h in logger.handlers:
        h.flush()
    assert "hello" in open(log_file).read()
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


def _collectives(rank, device):
    x = torch.tensor([float(rank + 1), 10.0 * rank], requires_grad=True)
    mean = tnu.all_reduce_mean(x)
    mean.sum().backward()
    return mean.detach().numpy().tolist(), tnu.all_gather(x.detach()).numpy().tolist(), x.grad.numpy().tolist()


def test_all_reduce_mean_and_all_gather_over_two_gloo_ranks():
    """Without a group: the mean is x, the gather x[None].  Over two gloo
    ranks: the mean of both, every rank's x in rank order, and the mean's
    gradient on each rank the sum of both ranks' cotangents over 2."""
    from ramdsir_tpu_torch.parallel.distributed import launch

    x = torch.tensor([1.0, 2.0])
    assert torch.equal(tnu.all_reduce_mean(x), x)
    assert torch.equal(tnu.all_gather(x), x[None])
    results = launch(_collectives, 2, devices=["cpu", "cpu"], backend="gloo")
    for rank, (mean, gathered, grad) in enumerate(results):
        assert mean == [1.5, 5.0]
        assert gathered == [[1.0, 0.0], [2.0, 10.0]]
        assert grad == [1.0, 1.0]


# --- data_utils ---------------------------------------------------------------


def test_data_utils_equal_jax(tmp_path):
    rng = _rng(9)
    for it in (0, 1, 50, 99):
        assert tdu.lr_poly(2e-3, it, 100) == jdu.lr_poly(2e-3, it, 100)
    logits = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    t = rng.integers(0, 3, (2, 4, 4))
    assert tdu.cross_entropy2d(logits, t) == jdu.cross_entropy2d(logits, t)
    cases = [(np.array([[0, 1], [1, 1]]), np.array([[0, 1], [0, 1]]), 2)]  # tests/test_misc_utils.py's
    cases += [(rng.integers(0, 4, (9, 9)), rng.integers(0, 4, (9, 9)), 5)]  # class 4 in neither: nan
    for pred, gt, n in cases:
        np.testing.assert_array_equal(tdu.get_iou(pred, gt, n), jdu.get_iou(pred, gt, n))
        np.testing.assert_array_equal(tdu.get_dice(pred, gt, n), jdu.get_dice(pred, gt, n))
        assert tdu.get_mc_dice(pred, gt, n) == jdu.get_mc_dice(pred, gt, n)
    assert tdu.get_mc_dice(np.zeros((3, 3)), np.zeros((3, 3)), 2) == jdu.get_mc_dice(np.zeros((3, 3)), np.zeros((3, 3)), 2)
    np.testing.assert_array_equal(tdu.pascal_colormap(), jdu.pascal_colormap())
    np.testing.assert_array_equal(tdu.pascal_colormap(21), jdu.pascal_colormap(21))
    path = tmp_path / "x.json"
    path.write_text(json.dumps({"a": [1, 2], "b": {"c": 3.5}}))
    assert tdu.json_load(str(path)) == jdu.json_load(str(path))
    assert tdu.untransform is tviz.untransform and tdu.untransform_prostate is tviz.untransform_prostate


# --- od_coords ------------------------------------------------------------------


def _gaussian_blob(size, cy, cx, sigma, amp=1.0):
    y, x = np.mgrid[:size, :size]
    return amp * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * sigma**2))


def test_od_coords_peaks_equal_jax():
    """tests/test_od_coords.py's peak cases, equal to JAX's arrays."""
    cases = [
        (_gaussian_blob(512, 120, 140, 12, 1.0) + _gaussian_blob(512, 360, 380, 12, 0.8), {"min_distance": 50, "num_peaks": 2}),
        (_gaussian_blob(128, 60, 60, 5, 1.0) + _gaussian_blob(128, 70, 60, 5, 0.9), {"min_distance": 30, "num_peaks": 2}),
        (_gaussian_blob(128, 10, 64, 4, 1.0) + _gaussian_blob(128, 64, 64, 4, 0.5), {"min_distance": 30, "num_peaks": 2}),
        (_gaussian_blob(128, 10, 64, 4, 1.0) + _gaussian_blob(128, 64, 64, 4, 0.5),
         {"min_distance": 30, "num_peaks": 2, "exclude_border": False}),
        (np.zeros((16, 16)), {}),
        (_rng(10).uniform(size=(40, 40)), {"min_distance": 3}),
    ]
    for img, kw in cases:
        ours, want = toc.peak_local_max(img, **kw), joc.peak_local_max(img, **kw)
        assert ours.dtype == want.dtype
        np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(toc.find_od_f(cases[0][0]), joc.find_od_f(cases[0][0]))


def test_od_coords_blobs_and_geometry_equal_jax():
    for blobs in (np.array([[50.0, 50.0, 10.0], [52.0, 52.0, 5.0]]), np.array([[50.0, 50.0, 5.0], [200.0, 200.0, 5.0]]),
                  np.array([[10.0, 10.0, 4.0], [14.0, 10.0, 4.0], [30.0, 30.0, 2.0]])):
        np.testing.assert_array_equal(toc._prune_blobs(blobs, 0.5), joc._prune_blobs(blobs, 0.5))
    for args in ((10.0, 5.0, 2.0), (5.0, 5.0, 20.0), (5.0, 5.0, 5.0), (3.0, 4.0, 5.5)):
        assert toc._disk_overlap(*args) == joc._disk_overlap(*args)
    img = np.zeros((512, 512, 3))
    img[:, :, 1] = _gaussian_blob(512, 100, 100, 20, 200)
    for coords in (np.array([[400, 400], [100, 100]]), np.array([[0, 0], [511, 511]])):
        for o, w in zip(toc.determine_od(img, coords), joc.determine_od(img, coords)):
            np.testing.assert_array_equal(o, w)
    mask = np.zeros((64, 64), dtype=np.uint8)
    mask[20:41, 10:51] = 1
    mask[30, 30] = 0
    assert toc.get_diameters(mask) == joc.get_diameters(mask)
    for fill in (True, False):
        assert toc.get_centroid(mask, fill=fill) == joc.get_centroid(mask, fill=fill)
    assert toc.distance_metric((0, 0), (3, 4)) == joc.distance_metric((0, 0), (3, 4))
    assert toc.distance_error((0, 0), (3, 4), od_radius=10.0) == joc.distance_error((0, 0), (3, 4), od_radius=10.0)
    assert toc.get_new_peaks((256, 128), (1024, 1024)) == joc.get_new_peaks((256, 128), (1024, 1024))


def test_od_coords_blob_log_and_peak_coordinates_equal_jax():
    """blob_log and get_peak_coordinates (its threshold back-off and the
    centre fallback, the two reference bugs fixed), as
    tests/test_od_coords.py but at 160^2 and 24^2 (its sigmas 10-50 over
    512^2, and 24 back-off rounds on an empty 512^2, take a minute a
    package)."""
    img = np.zeros((160, 160, 3))
    for ch in range(3):
        img[:, :, ch] = _gaussian_blob(160, 50, 50, 12, 1.0) + _gaussian_blob(160, 110, 110, 12, 0.9)
    ours = toc.get_peak_coordinates(img, threshold=0.05)
    np.testing.assert_array_equal(ours, joc.get_peak_coordinates(img, threshold=0.05))
    assert len(ours) >= 2
    zeros = np.zeros((24, 24, 3))
    ours = toc.get_peak_coordinates(zeros, threshold=0.2)
    np.testing.assert_array_equal(ours, joc.get_peak_coordinates(zeros, threshold=0.2))
    assert (256, 256) in {tuple(c) for c in ours}
    gray = _gaussian_blob(96, 30, 40, 6, 1.0) + _gaussian_blob(96, 70, 60, 9, 0.7)
    np.testing.assert_array_equal(toc.blob_log(gray, min_sigma=2, max_sigma=12, num_sigma=5, threshold=0.05),
                                  joc.blob_log(gray, min_sigma=2, max_sigma=12, num_sigma=5, threshold=0.05))


# --- small gaps and re-exports ------------------------------------------------


def test_step_timer_steps_per_sec_and_metrics_writer_add_scalar(tmp_path):
    from ramdsir_tpu.utils.profiler import StepTimer as JStepTimer
    from ramdsir_tpu_torch.utils.logging import MetricsWriter
    from ramdsir_tpu_torch.utils.profiler import StepTimer

    for timer in (StepTimer(warmup=2), JStepTimer(warmup=2)):
        assert timer.steps_per_sec == 0.0
        for _ in range(5):
            timer.tick(4)
        timer.mark()
        assert timer.steps_per_sec == pytest.approx(3 / timer.elapsed)
        assert timer.items_per_sec == pytest.approx(4 * timer.steps_per_sec)
    writer = MetricsWriter(str(tmp_path))
    writer.add_scalar("train/loss", torch.tensor(0.25), 7)
    writer.add_scalar("lr", np.float32(1e-3), 8)
    writer.close()
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [(r["step"], r.get("train/loss", r.get("lr"))) for r in rows] == [(7, 0.25), (8, float(np.float32(1e-3)))]


def test_trace_context_writes_a_chrome_trace_or_nothing(tmp_path):
    from ramdsir_tpu_torch.utils.profiler import trace_context

    with trace_context(None) as path:
        torch.ones(4).sum()
    assert path is None
    with trace_context(str(tmp_path / "trace")) as path:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    trace = json.load(open(path))
    assert os.path.dirname(path) == str(tmp_path / "trace")
    assert any("mm" in str(e.get("name", "")) for e in trace["traceEvents"])


def test_package_reexports_match_the_jax_packages():
    """Every name a JAX package's __init__ re-exports that the port has,
    from the port's package of the same name; the ones it has not are named."""
    import importlib

    no_counterpart = {"models": {"Norm"}, "ops": set(), "utils": set(), "data": set()}
    for pkg, missing in no_counterpart.items():
        jpkg = importlib.import_module(f"ramdsir_tpu.{pkg}")
        tpkg = importlib.import_module(f"ramdsir_tpu_torch.{pkg}")
        jnames = {n for n in vars(jpkg) if not n.startswith("_") and not isinstance(vars(jpkg)[n], type(jpkg))}
        assert set(tpkg.__all__) == jnames - missing, pkg
        for n in tpkg.__all__:
            assert getattr(tpkg, n) is getattr(importlib.import_module(tpkg._EXPORTS[n]), n)
    with pytest.raises(AttributeError):
        importlib.import_module("ramdsir_tpu_torch.ops").no_such_name
