"""The port's fundus evaluation against the JAX package on the CPU.

Host modules (resize, metrics, post-processing through the port's C++ and
through its scipy plain versions), the uint16 quantisation, the predictor in
both BN modes with its tail batch, BestKeeper and the `.pth` loader, the
test-split reader and batching, and eval_fundus as a whole on one tiny PNG
tree.  Weights go across through the port's `jax_params_to_torch`; inputs
are made with numpy from seeds; the U-Net runs at n=16 on 32^2.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ramdsir_tpu.config import TrainConfig as JConfig
from ramdsir_tpu.data.fundus import FundusDataset as JFundusDataset
from ramdsir_tpu.data.loaders import DataLoader as JDataLoader
from ramdsir_tpu.data.transforms import Compose, Resize
from ramdsir_tpu.ops import metrics as jmetrics
from ramdsir_tpu.ops import postprocess as jpost
from ramdsir_tpu.ops.resize import bilinear_resize_chw as jresize
from ramdsir_tpu.train import evaluate as jeval
from ramdsir_tpu.train.state import init_state as jinit_state
from ramdsir_tpu.train.steps import _apply_with_stats
from ramdsir_tpu.train.steps import make_predict_fn as jmake_predict_fn
from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.data.fundus import FundusDataset
from ramdsir_tpu_torch.data.loaders import sequential_batches
from ramdsir_tpu_torch.data.synthetic import fundus_test_samples, make_fundus_tree
from ramdsir_tpu_torch.ops import metrics, postprocess
from ramdsir_tpu_torch.ops.resize import bilinear_resize_chw
from ramdsir_tpu_torch.train import evaluate
from ramdsir_tpu_torch.train.checkpoint import BestKeeper, load_any_checkpoint, load_torch_checkpoint
from ramdsir_tpu_torch.train.state import build_models
from ramdsir_tpu_torch.train.steps import make_predict_fn
from ramdsir_tpu_torch.utils.torch_compat import export_torch_checkpoint, jax_params_to_torch
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

S = 32
# the repo's tolerance for probabilities of one float32 forward computed two
# ways (tests/test_evaluate.py:112-114)
PROB_TOL = dict(rtol=1e-4, atol=5e-5)
HEAD_SCALE = 2.0
RESULT_FIELDS = ("cup_dice", "disc_dice", "hd_oc", "hd_od", "asd_oc", "asd_od", "num")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --- host modules --------------------------------------------------------------


@pytest.mark.parametrize("shape,out", [((2, 32, 32), (40, 40)), ((2, 32, 32), (20, 20)),
                                       ((3, 24, 32), (37, 19)), ((2, 2, 17, 9), (9, 30))])
def test_bilinear_resize_matches_jax(shape, out):
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    got = bilinear_resize_chw(x, *out)
    assert got.dtype == np.float32 and got.shape == shape[:-2] + out
    np.testing.assert_array_equal(got, jresize(x, *out))


def _masks(rng, n, shape, p_lo=0.3, p_hi=0.8):
    return [rng.uniform(size=shape) > rng.uniform(p_lo, p_hi) for _ in range(n)]


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    for a, b in zip(_masks(rng, 6, (2, 30, 26)), _masks(rng, 6, (2, 30, 26))):
        assert metrics.dice_coeff_2label(a, b) == jmetrics.dice_coeff_2label(a, b)
        for ch in range(2):
            assert metrics.dice_binary(a[ch], b[ch]) == jmetrics.dice_binary(a[ch], b[ch])
            assert abs(metrics.hd95(a[ch], b[ch]) - jmetrics.hd95(a[ch], b[ch])) <= 1e-12
            assert abs(metrics.asd(a[ch], b[ch]) - jmetrics.asd(a[ch], b[ch])) <= 1e-12
    batch_a, batch_b = np.stack(_masks(rng, 3, (2, 16, 16))), np.stack(_masks(rng, 3, (2, 16, 16)))
    assert metrics.dice_coeff_2label(batch_a, batch_b) == jmetrics.dice_coeff_2label(batch_a, batch_b)
    empty, full = np.zeros((12, 12), bool), np.ones((12, 12), bool)
    assert metrics.dice_binary(empty, empty) == jmetrics.dice_binary(empty, empty) == 0.0
    assert metrics.dice_coefficient(empty, empty) == jmetrics.dice_coefficient(empty, empty) == 1.0
    for fn in ("hd95", "asd", "surface_distances"):
        for args, which in (((empty, full), "first"), ((full, empty), "second")):
            with pytest.raises(RuntimeError, match=f"The {which} input") as ours:
                getattr(metrics, fn)(*args)
            with pytest.raises(RuntimeError) as theirs:
                getattr(jmetrics, fn)(*args)
            assert str(ours.value) == str(theirs.value)


def test_surface_distances_library_equals_plain():
    rng = np.random.default_rng(2)
    for shape in ((40, 33), (5, 12, 14)):
        for a, b in zip(_masks(rng, 5, shape), _masks(rng, 5, shape)):
            got, want = metrics.surface_distances(a, b), metrics.surface_distances_plain(a, b)
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["library", "plain"])
def test_postprocess_matches_jax(impl):
    largest = postprocess.get_largest_fillhole if impl == "library" else postprocess.get_largest_fillhole_plain
    region = (postprocess.connectivity_region_analysis if impl == "library"
              else postprocess.connectivity_region_analysis_plain)
    rng = np.random.default_rng(3)
    for m in _masks(rng, 8, (36, 31), 0.4, 0.7) + [np.zeros((9, 9), bool)]:
        got, want = largest(m), jpost.get_largest_fillhole(m)
        np.testing.assert_array_equal(got, np.asarray(want, np.int64))
    for _ in range(4):
        prob = rng.uniform(size=(2, 30, 34)).astype(np.float32)
        for dataset in ("G", "fundus", "Drishti"):
            got = postprocess.postprocessing(prob, threshold=0.75, dataset=dataset, largest=largest)
            want = jpost.postprocessing(prob, threshold=0.75, dataset=dataset)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for vol in _masks(rng, 4, (5, 14, 12), 0.5, 0.7) + [np.zeros((3, 6, 6), np.uint8)]:
        vol = vol.astype(np.uint8)
        got, want = region(vol), jpost.connectivity_region_analysis(vol)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert region(np.zeros((3, 6, 6), np.uint8)).sum() == 0  # the deliberate all-zeros divergence


def test_q16_matches_jax():
    rng = np.random.default_rng(4)
    # exact half steps: float32 p whose p * 65535 is k + 0.5 exactly
    k = np.arange(0, 65535, 7, dtype=np.float64)
    cand = ((k + 0.5) / 65535).astype(np.float32)
    halves = cand[cand * np.float32(65535.0) == (k + 0.5).astype(np.float32)]
    assert len(halves) > 100
    p = np.concatenate([rng.uniform(0, 1, 5000).astype(np.float32), halves,
                        np.float32([0.0, 1.0, 0.5, 0.75, 1e-9, 1 - 1e-7])])
    got = evaluate._q16(torch.from_numpy(p))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), np.asarray(jeval._q16(jnp.asarray(p))))


# --- the predictor -------------------------------------------------------------


def _calibrated(cfg, state, models, rng, x=None):
    """Running statistics set to one batch's own statistics (x, NHWC in
    [-1, 1], or 8 uniform images), so that eval mode normalises activations
    to O(1) and probabilities are not saturated."""
    if x is None:
        x = rng.uniform(0, 255, (8, S, S, 3)).astype(np.float32) / 127.5 - 1.0

    @jax.jit
    def updated(params, batch_stats, x):
        feats, enc_stats = _apply_with_stats(models["encoder"], params["encoder"],
                                             batch_stats["encoder"], x, train=True)
        _, dec_stats = _apply_with_stats(models["seg_decoder"], params["seg_decoder"],
                                         batch_stats["seg_decoder"], feats, train=True)
        return {"encoder": enc_stats, "seg_decoder": dec_stats}

    new = updated(state.params, state.batch_stats, jnp.asarray(x))
    # the update was new = 0.9 * old + 0.1 * batch
    stats = jax.tree.map(lambda n, o: (n - 0.9 * o) / 0.1, new, {k: state.batch_stats[k] for k in new})
    return state.replace(batch_stats=dict(state.batch_stats, **stats))


def _weights(head_scale):
    """JAX state with calibrated statistics and the seg head's kernel times
    head_scale, and its torch state dicts."""
    cfg = JConfig(dataset="fundus", image_size=S, save_path="unused", rec=False, ram=False).resolve()
    state, models = jinit_state(cfg, jax.random.PRNGKey(0))
    state = _calibrated(cfg, state, models, np.random.default_rng(10))
    params = _np(state.params)
    params["seg_decoder"]["out1"]["kernel"] = params["seg_decoder"]["out1"]["kernel"] * head_scale
    state = state.replace(params=jax.tree.map(jnp.asarray, params))
    sd = jax_params_to_torch(_np(state.params), _np(state.batch_stats))
    return cfg, state, models, sd


@pytest.fixture(scope="module")
def weights():
    return _weights(1.0)


@pytest.fixture(scope="module")
def slice_weights():
    """A head scaled so that post-processed masks at 0.75 are neither empty
    nor full on the slice test's images."""
    return _weights(HEAD_SCALE)


@pytest.fixture(scope="module")
def jpredict(weights):
    cfg, _, models, _ = weights
    return {bn: jmake_predict_fn(cfg, models, bn_adapt=bn) for bn in (False, True)}


def _port_models(sd, train=True):
    cfg = TrainConfig(dataset="fundus", image_size=S, rec=False, ram=False, device="cpu").resolve()
    models = build_models(cfg)
    for name, m in models.items():
        m.load_state_dict(sd[name], strict=True)
        m.train(train)
    return cfg, models


def _snapshot(models):
    return ({f"{n}.{k}": v.clone() for n, m in models.items() for k, v in m.state_dict().items()},
            {f"{n}.{k}": sub.training for n, m in models.items() for k, sub in m.named_modules()})


@pytest.mark.parametrize("bn_adapt", [False, True])
@pytest.mark.parametrize("train_flag", [True, False])
def test_predict_matches_jax(weights, jpredict, bn_adapt, train_flag):
    _, state, _, sd = weights
    cfg, models = _port_models(sd, train=train_flag)
    img = np.random.default_rng(5).integers(0, 256, (8, S, S, 3)).astype(np.uint8)
    before = _snapshot(models)
    got = make_predict_fn(cfg, models, bn_adapt=bn_adapt)(img)
    want = np.asarray(jpredict[bn_adapt](state, img))
    assert got.shape == (8, 2, S, S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, **PROB_TOL)
    assert 0.05 < float((got > 0.75).float().mean()) < 0.95  # not saturated
    after = _snapshot(models)
    assert after[1] == before[1]  # every train flag as it was
    for k, v in before[0].items():
        assert torch.equal(after[0][k], v), k  # every weight and running statistic


@pytest.mark.parametrize("bn_adapt", [False, True])
def test_predict_tail_matches_jax_padded(weights, jpredict, bn_adapt):
    """The port runs a tail of 3 as it is; JAX pads it to 8 and passes
    n_valid=3.  The port's own n_valid on the padded batch agrees too."""
    _, state, _, sd = weights
    cfg, models = _port_models(sd)
    real = np.random.default_rng(6).integers(0, 256, (3, S, S, 3)).astype(np.uint8)
    padded = np.concatenate([real, np.zeros((5, S, S, 3), np.uint8)])
    predict = make_predict_fn(cfg, models, bn_adapt=bn_adapt)
    want = np.asarray(jpredict[bn_adapt](state, padded, n_valid=3))[:3]
    got = predict(real).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, **PROB_TOL)
    np.testing.assert_allclose(predict(padded, n_valid=3)[:3].numpy().transpose(0, 2, 3, 1), want, **PROB_TOL)
    if bn_adapt:  # the padded rows would move the batch statistics
        assert np.abs(predict(padded)[:3].numpy().transpose(0, 2, 3, 1) - want).max() > 1e-3


# --- checkpoints ---------------------------------------------------------------


def test_best_keeper(tmp_path, weights):
    _, _, _, sd = weights
    _, models = _port_models(sd)
    keeper = BestKeeper(str(tmp_path))
    assert keeper.best == 0.0
    assert keeper.update(0.0, models)  # the first eval always saves
    assert sorted(os.listdir(tmp_path)) == ["model_0.00.pth"]
    assert not keeper.update(-1.0, models)
    assert keeper.update(9.5, models)
    assert sorted(os.listdir(tmp_path)) == ["model_9.50.pth"]  # the old best is gone
    mtime = os.stat(tmp_path / "model_9.50.pth").st_mtime_ns
    os.utime(tmp_path / "model_9.50.pth", ns=(mtime - 10**9, mtime - 10**9))
    assert keeper.update(9.5, models)  # a tie rewrites the file
    assert os.stat(tmp_path / "model_9.50.pth").st_mtime_ns > mtime - 10**9
    assert not keeper.update(9.0, models)
    # adoption by numeric order: 12.00 beats 9.50, though "9" > "1"
    export_torch_checkpoint(str(tmp_path / "model_12.00.pth"), models)
    adopted = BestKeeper(str(tmp_path))
    assert adopted.best == 12.0 and adopted.best_path == str(tmp_path / "model_12.00.pth")
    assert not adopted.update(11.0, models)

    # the file loads strictly into freshly built modules
    cfg, fresh = _port_models({n: {k: torch.zeros_like(v) for k, v in d.items()} for n, d in sd.items()})
    load_torch_checkpoint(keeper.best_path, fresh)
    for name, m in fresh.items():
        for k, v in m.state_dict().items():
            assert torch.equal(v, sd[name][k]), f"{name}.{k}"
    payload = torch.load(keeper.best_path, map_location="cpu")
    assert set(payload) == {"encoder_state_dict", "seg_decoder_state_dict"}
    # a missing module, or a module whose keys differ, raises
    models_rec = build_models(TrainConfig(image_size=S, rec=True, device="cpu").resolve())
    with pytest.raises(KeyError, match="rec_decoder_state_dict"):
        load_torch_checkpoint(keeper.best_path, models_rec)
    torch.save({"encoder_state_dict": {}, "seg_decoder_state_dict": payload["seg_decoder_state_dict"]},
               tmp_path / "partial.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_torch_checkpoint(str(tmp_path / "partial.pth"), fresh)
    # the eval CLIs' loader takes a .pth through the same strict path
    with pytest.raises(RuntimeError, match="Missing key"):
        load_any_checkpoint(str(tmp_path / "partial.pth"), fresh)


# --- data -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fundus_tree"))
    make_fundus_tree(root, per_domain_train=2, per_domain_test=3, size=40, seed=1)
    return root


def test_test_split_and_batches_match_jax(tree):
    base = os.path.join(tree, "fundus")
    ours = FundusDataset(base, 0, S)
    theirs = JFundusDataset(base, 0, split="test", transform=Compose([Resize((S, S))]))
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b) and a["id"] == b["id"]
        for k in ("img", "mask", "mask_orig"):
            assert a[k].dtype == b[k].dtype == np.uint8
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got = list(sequential_batches(ours, 2))
    want = list(JDataLoader(theirs, batch_size=2, shuffle=False, drop_last=False))
    assert [g["img"].shape[0] for g in got] == [w["img"].shape[0] for w in want] == [2, 1]
    for g, w in zip(got, want):
        assert list(g["id"]) == list(w["id"])
        for k in ("img", "mask", "mask_orig"):
            np.testing.assert_array_equal(g[k], w[k])
    assert len(FundusDataset(base, 0, S, num=2)) == 2


def test_fundus_test_samples():
    samples = fundus_test_samples(num=3, size=40, image_size=S, seed=0)
    assert len(samples) == 3 and len({s["id"] for s in samples}) == 3
    for s in samples:
        assert s["img"].shape == (S, S, 3) and s["img"].dtype == np.uint8
        assert s["mask"].shape == (S, S) and s["mask"].dtype == np.uint8
        assert s["mask_orig"].shape == (40, 40, 2) and s["mask_orig"].dtype == np.uint8
        assert s["mask_orig"][..., 1].any() and s["mask_orig"][..., 0].any()  # a disc and a cup
        # the nearest-resized gray mask decodes to the original's classes
        assert set(np.unique(s["mask"])) <= {0, 128, 255}


# --- the slice as a whole ---------------------------------------------------------


def _recording(monkeypatch, module, store):
    orig = module.postprocessing

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        store.append(np.array(out))
        return out

    monkeypatch.setattr(module, "postprocessing", wrapped)


@pytest.mark.parametrize("bn_adapt", [False, True])
def test_eval_fundus_matches_jax(tree, slice_weights, jpredict, monkeypatch, bn_adapt):
    """3 test images at 40^2, image_size 32, test batch 2 (a tail of 1),
    with distances: the same post-processed masks and results."""
    _, state, _, sd = slice_weights
    cfg, models = _port_models(sd)
    ours_masks, theirs_masks = [], []
    _recording(monkeypatch, evaluate, ours_masks)
    _recording(monkeypatch, jeval, theirs_masks)
    kw = dict(test_domain_idx=0, batch_size=2, image_size=S, with_distances=True)
    rng_before = torch.random.get_rng_state()
    got = evaluate.eval_fundus(make_predict_fn(cfg, models, bn_adapt=bn_adapt), tree, **kw)
    assert torch.equal(torch.random.get_rng_state(), rng_before)  # eval draws no random number
    want = jeval.eval_fundus(jpredict[bn_adapt], state, tree, **kw)
    assert len(ours_masks) == len(theirs_masks) == 3
    for a, b in zip(ours_masks, theirs_masks):
        assert a.shape == (2, 40, 40)
        for ch in range(2):
            assert 0 < a[ch].sum() < a[ch].size, "an empty or full mask tests nothing"
        np.testing.assert_array_equal(a, b)
    for f in RESULT_FIELDS:
        assert abs(getattr(got, f) - getattr(want, f)) <= 1e-6, f
    assert got.timing["batches"] == 2
    # in-memory samples give the same result as the tree they were read from
    again = evaluate.eval_fundus(make_predict_fn(cfg, models, bn_adapt=bn_adapt),
                                 list(FundusDataset(os.path.join(tree, "fundus"), 0, S)), **kw)
    assert all(getattr(again, f) == getattr(got, f) for f in RESULT_FIELDS)
