"""The host input path end to end on the CPU: one train step on a loader
batch against the JAX package's step on its loader's (bit-equal) batch,
with the ratios injected, the viz slices beside JAX's; `fit` on the host
loaders (fundus with thread and process workers, prostate); a loader that
fails fails `fit`; and the image grids against JAX's `_log_viz` as
tensorboardX would store them.  The loaders alone are in
tests/test_torch_port_loaders.py.
"""
import io
import json
import multiprocessing
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ramdsir_tpu.config import TrainConfig as JConfig
from ramdsir_tpu.data import loaders as jloaders
from ramdsir_tpu.data.fundus import FundusMultiDataset as JFundusMultiDataset
from ramdsir_tpu.data.synthetic import make_fundus_tree, make_prostate_tree, make_prostate_volumes
from ramdsir_tpu.data.transforms import ScaleCropAug as JScaleCropAug
from ramdsir_tpu.ops.ram import sample_ram_ratios
from ramdsir_tpu.train.state import init_state as jinit_state
from ramdsir_tpu.train.steps import make_train_step as jmake_train_step
from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.data import loaders, png
from ramdsir_tpu_torch.data.fundus import FundusMultiDataset
from ramdsir_tpu_torch.data.transforms import ScaleCropAug
from ramdsir_tpu_torch.train import loop
from ramdsir_tpu_torch.train.state import init_state
from ramdsir_tpu_torch.train.steps import make_train_step
from ramdsir_tpu_torch.utils.logging import DeviceVizRing, MetricsWriter, decode_seg_map, make_grid
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)
from tests.test_torch_port_step import (
    CFG,
    HW,
    METRICS,
    _port_state,
    _snapshot,
    check_gradients_within_jax_spread,
    check_params_and_running_stats,
    check_step_metrics,
)

STEP_BSL = [2, 2, 2]  # tests/test_torch_port_step.py's batch, from the loaders
SOURCES, TARGET = (1, 2, 3), 0
KEYS = ("img", "donor", "mask")
FUNDUS_TAGS = {"train/Image", "train/Image_Freq", "train/Image_Rec", "train/Soft_Predicted_OC",
               "train/Soft_Predicted_OD", "train/GT_OC", "train/GT_OD"}
PROSTATE_TAGS = {"train/Image", "train/Image_Freq", "train/Image_Rec", "train/Predicted", "train/GT"}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Fundus 48^2 (7 train and 2 test pairs a domain) and prostate 32^2
    (4 slices a domain, two 6-slice test volumes a domain), from the JAX
    package's synthetic writers."""
    root = tmp_path_factory.mktemp("fit_trees")
    make_fundus_tree(str(root), per_domain_train=7, per_domain_test=2, size=48, seed=5)
    make_prostate_tree(str(root), per_domain=4, size=HW, seed=5)
    make_prostate_volumes(str(root), per_domain=2, depth=6, size=HW, seed=5)
    return str(root)


def _datasets(base, cls, aug):
    return [cls(base, [d], np_transform=aug(HW), is_freq=True, is_out_domain=True, test_domain_idx=TARGET,
                donor_size=HW, rng=np.random.default_rng(3 + i), resize_to=HW) for i, d in enumerate(SOURCES)]


# --- one step on a loader batch ---------------------------------------------------------


@pytest.fixture(scope="module")
def host_step(trees):
    """The first loader batch of each package (uint8 on the wire, equal),
    one step each from the same weights: JAX's with device_data=False and
    its plain mix, the port's with the ratios JAX drew and viz=True."""
    base = os.path.join(trees, "fundus")
    want = next(iter(jloaders.FusedMultiDomainLoader(_datasets(base, JFundusMultiDataset, JScaleCropAug),
                                                     STEP_BSL, KEYS, seed=5, num_workers=2)))
    got = next(iter(loaders.FusedMultiDomainLoader(_datasets(base, FundusMultiDataset, ScaleCropAug),
                                                   STEP_BSL, KEYS, seed=5, num_workers=2)))
    assert all(got[k].dtype == np.uint8 and np.array_equal(got[k], want[k]) for k in KEYS)
    cfg = {**CFG, "log_images_every": 1}
    jcfg = JConfig(**cfg, device_data=False).resolve()
    jstate, models = jinit_state(jcfg, jax.random.PRNGKey(0))
    tcfg = TrainConfig(**cfg, device="cpu", device_data=False).resolve()
    tstate = _port_state(tcfg, jstate)
    key = jax.random.PRNGKey(11)

    def jax_step(pallas, batch):
        c = JConfig(**cfg, device_data=False, ram_use_pallas=pallas).resolve()
        step = jmake_train_step(c, models, total_iters=10, batch_size_list=STEP_BSL, debug_grads=True)
        return step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    jstate1, jm, jviz = jax_step(False, want)
    tstep = make_train_step(tcfg, total_iters=10, batch_size_list=STEP_BSL, debug_grads=True)
    ratio = torch.from_numpy(np.array(sample_ram_ratios(key, sum(STEP_BSL))))
    tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in got.items()}, draws={"ratio": ratio}, viz=True)
    return dict(jm=jm, tm=tm, jviz=jviz, params=_snapshot(jstate1, tstate), lr=tcfg.lr,
                pallas_grads=lambda: jax_step(True, want)[1]["_grads"])


def test_host_step_metrics(host_step):
    check_step_metrics(host_step["jm"], {k: v for k, v in host_step["tm"].items() if k != "_viz"}, METRICS)


def test_host_step_gradients(host_step):
    check_gradients_within_jax_spread(host_step["jm"]["_grads"], host_step["tm"]["_grads"], host_step["pallas_grads"])


def test_host_step_params_and_running_stats(host_step):
    check_params_and_running_stats(*host_step["params"], host_step["lr"])


def test_host_step_viz_equals_jax(host_step):
    """The viz slices: batch[0:9:4] of the clean and RAM images and of the
    mask, sigmoid probabilities, and the first restoration sample of each
    domain, NHWC as JAX returns them.  The images to float32 rounding, the
    mask exactly, the probabilities to 1e-4; the restoration samples to
    2e-3: the rec decoder's DSBN normalises each domain's 2 samples over a
    2x2 bottleneck here, which lifts float32 noise to ~1e-3 (9.3e-4
    measured), where a wrong row or domain would move them by O(1)."""
    jviz, tviz = host_step["jviz"], host_step["tm"]["_viz"]
    assert set(tviz) == set(jviz) == {"image", "image_freq", "image_rec", "pred", "mask"}
    atol = {"image": 1e-5, "image_freq": 1e-5, "mask": 0.0, "pred": 1e-4, "image_rec": 2e-3}
    for k, w in jviz.items():
        w, g = np.asarray(w), tviz[k].numpy()
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=atol[k], rtol=0, err_msg=k)
    assert tviz["image"].shape[0] == 2 and tviz["image_rec"].shape[0] == 3


# --- fit on the host loaders --------------------------------------------------------------


def _host_cfg(trees, tmp_path, dataset, loader, **kw):
    data = dict(domain_idxs=(1, 2, 3), test_domain_idx=0, image_size=HW, is_out_domain=True) if dataset == "fundus" \
        else dict(domain_idxs=(0, 1, 2, 3, 4), test_domain_idx=5)
    return TrainConfig(data_root=trees, dataset=dataset, save_path=str(tmp_path / "run"), device="cpu",
                       device_data=False, loader=loader, num_workers=2, test_batch_size=2, log_images_every=2,
                       **data, **kw)


@pytest.mark.parametrize("dataset,loader", [("fundus", "thread"), ("fundus", "process"), ("prostate", "process")])
def test_fit_on_host_loaders(trees, tmp_path, dataset, loader):
    """Two epochs (fundus, batch 3+6+7 over 7 images a domain: 2 steps an
    epoch) or two steps (prostate, 2 x 5): finite losses every step, an
    "input/" row an epoch, the summary's host_input, one PNG per tag at
    each logged step, no worker left; fundus step 0's losses equal one step
    of the same seed on the loader's first batch."""
    epochs = 2 if dataset == "fundus" else 1
    cfg = _host_cfg(trees, tmp_path, dataset, loader, epochs=epochs)
    summary = loop.fit(cfg, max_steps=None if dataset == "fundus" else 2)
    steps = 4 if dataset == "fundus" else 2
    assert summary["steps"] == steps
    assert summary["host_input"]["loader"] == loader and summary["host_input"]["epochs"] == epochs
    rows = [json.loads(line) for line in open(os.path.join(cfg.save_path, "log", "metrics.jsonl"))]
    losses = [r for r in rows if "loss/loss" in r]
    assert [r["step"] for r in losses] == list(range(steps))
    assert all(np.isfinite(v) for r in losses for k, v in r.items() if k.startswith("loss/"))
    inputs = [r for r in rows if "input/host_wait_ms" in r]
    assert [r["input/epoch"] for r in inputs] == list(range(epochs))
    assert {"input/median_step_ms", "input/images_per_sec", "input/host_peak_rss_bytes"} <= set(inputs[0])
    tags = FUNDUS_TAGS if dataset == "fundus" else PROSTATE_TAGS
    images = os.path.join(cfg.save_path, "log", "images")
    assert sorted(os.listdir(images)) == sorted(t.replace("/", "_") for t in tags)
    logged = [s for s in range(steps) if s % cfg.log_images_every == 0]
    for tag in os.listdir(images):
        assert sorted(os.listdir(os.path.join(images, tag))) == sorted(f"{s}.png" for s in logged), tag
        grid = png.decode(os.path.join(images, tag, "0.png"))
        assert grid.mode == "RGB" and grid.array.shape[1] == 3 * HW
    assert not [p for p in multiprocessing.active_children() if p.is_alive()]
    if dataset == "fundus" and loader == "thread":
        tcfg = cfg.resolve()
        gen = torch.Generator().manual_seed(tcfg.seed)
        state = init_state(tcfg, gen, "cpu")
        pipe = loop.build_train_pipeline(tcfg, os.path.join(trees, "fundus"))
        step = make_train_step(tcfg, len(pipe) * tcfg.epochs, batch_size_list=pipe.batch_sizes)
        m = step(state, {k: torch.from_numpy(v) for k, v in next(iter(pipe)).items()}, gen)
        for k, v in losses[0].items():
            if k.startswith("loss/"):
                assert float(m[k[len("loss/"):]]) == v, k


@pytest.mark.parametrize("loader", ["thread", "process"])
def test_a_failing_loader_fails_fit(trees, tmp_path, loader):
    """An image that cannot be decoded raises out of `fit` (nothing carries
    on without it), and the process workers are stopped."""
    root = tmp_path / "data"
    shutil.copytree(os.path.join(trees, "fundus"), root / "fundus")
    for line in FundusMultiDataset(str(root / "fundus"), [2]).id_path:
        with open(os.path.join(root, "fundus", line.split(" ")[0]), "wb") as f:
            f.write(b"not a png")
    cfg = _host_cfg(str(root), tmp_path, "fundus", loader, epochs=1)
    with pytest.raises(RuntimeError if loader == "process" else ValueError):
        loop.fit(cfg)
    assert not [p for p in multiprocessing.active_children() if p.is_alive()]


def test_unknown_loader_raises(trees, tmp_path):
    with pytest.raises(ValueError, match="unknown loader 'fork'"):
        loop.fit(_host_cfg(trees, tmp_path, "fundus", "fork", epochs=1))


# --- the image grids ---------------------------------------------------------------------


def test_make_grid_and_decode_seg_map_equal_jax():
    from ramdsir_tpu.utils.logging import decode_seg_map as jdecode
    from ramdsir_tpu.utils.logging import make_grid as jgrid

    rng = np.random.default_rng(2)
    for shape in ((3, 8, 8, 3), (3, 8, 6), (2, 5, 7, 1), (4, 3, 3, 3)):
        x = rng.normal(size=shape).astype(np.float32)
        for normalize in (True, False):
            np.testing.assert_array_equal(make_grid(x, normalize=normalize), jgrid(x, normalize=normalize))
    labels = rng.integers(0, 8, (9, 11))
    np.testing.assert_array_equal(decode_seg_map(labels), jdecode(labels))
    np.testing.assert_array_equal(decode_seg_map(labels, 3), jdecode(labels, 3))


class RecordingWriter:
    """The JAX `_log_viz`'s writer: records its add_image calls."""

    def __init__(self):
        self.images = {}

    def add_image(self, tag, image, step):
        self.images[(tag, step)] = np.asarray(image)


def _prostate_viz():
    """A prostate step's viz slices (binary logit-difference head) at 32^2."""
    cfg = TrainConfig(dataset="prostate", domain_idxs=(0, 1, 2, 3, 4), test_domain_idx=5, device="cpu",
                      device_data=False).resolve()
    state = init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    batch = {"img": rng.uniform(-1, 1, (10, HW, HW, 3)).astype(np.float32),
             "donor": rng.uniform(-1, 1, (10, HW, HW, 3)).astype(np.float32),
             "mask": rng.integers(0, 2, (10, HW, HW)).astype(np.int32)}
    step = make_train_step(cfg, 10)
    m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator().manual_seed(1), viz=True)
    return cfg, m["_viz"]


@pytest.mark.parametrize("dataset", ["fundus", "prostate"])
def test_log_viz_pngs_equal_jax(host_step, tmp_path, dataset):
    """The same viz arrays (through DeviceVizRing, which gives them back
    unchanged) into JAX's `_log_viz` with a recording writer and into the
    port's: the same tags, and every PNG the port writes holds the pixels
    tensorboardX would store for JAX's grid."""
    from tensorboardX import summary as tb_summary
    from PIL import Image

    from ramdsir_tpu.train.loop import _log_viz as jlog_viz

    if dataset == "fundus":
        cfg, viz = TrainConfig(**CFG, device="cpu").resolve(), host_step["tm"]["_viz"]
    else:
        cfg, viz = _prostate_viz()
    ring, got = DeviceVizRing(), []
    ring.append(4, viz)
    ring.flush(lambda v, s: got.append((v, s)))
    (arrays, step), = got
    assert step == 4 and all(np.array_equal(arrays[k], viz[k].numpy()) for k in viz)
    recorder = RecordingWriter()
    jlog_viz(recorder, arrays, step, JConfig(dataset=dataset).resolve())
    writer = MetricsWriter(str(tmp_path / "log"))
    loop._log_viz(writer, arrays, step, cfg)
    writer.close()
    tags = {t for t, _ in recorder.images}
    assert tags == (FUNDUS_TAGS if dataset == "fundus" else PROSTATE_TAGS)
    assert sorted(os.listdir(tmp_path / "log" / "images")) == sorted(t.replace("/", "_") for t in tags)
    for (tag, s), image in recorder.images.items():
        encoded = tb_summary.image(tag, image.transpose(2, 0, 1)).value[0].image.encoded_image_string
        want = np.asarray(Image.open(io.BytesIO(encoded)))
        got_png = png.decode(writer.image_path(tag, s))
        np.testing.assert_array_equal(got_png.array, want, err_msg=tag)
