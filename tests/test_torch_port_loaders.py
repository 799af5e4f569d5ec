"""The port's host input path against the JAX package's, on the CPU: the
cv2-equal resizes against cv2, the training scale-crop and the datasets'
items for the same Generator seeds, the fused loaders (thread and process
workers) batch for batch over two epochs and a wrap-reshuffle, a `rows`
slice, DataLoader / MultiDomainIterator, and the loaders' failures.  The
train step on a loader batch, `fit` on the host loaders and the image grids
are in tests/test_torch_port_loaders_fit.py.
"""
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from ramdsir_tpu.data import loaders as jloaders
from ramdsir_tpu.data.fundus import FundusMultiDataset as JFundusMultiDataset
from ramdsir_tpu.data.prostate import ProstateMultiDataset as JProstateMultiDataset
from ramdsir_tpu.data.synthetic import make_fundus_tree, make_prostate_tree
from ramdsir_tpu.data.transforms import ScaleCropAug as JScaleCropAug
from ramdsir_tpu.data.transforms import np_random_scale_crop as jscale_crop
from ramdsir_tpu_torch.data import loaders
from ramdsir_tpu_torch.data.fundus import FundusMultiDataset, _DecodeCache
from ramdsir_tpu_torch.data.prostate import ProstateMultiDataset
from ramdsir_tpu_torch.data.transforms import ScaleCropAug, np_random_scale_crop
from ramdsir_tpu_torch.ops.image import cv_resize
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 32  # image_size of the loaders
SOURCES, TARGET = (1, 2, 3), 0  # fundus
BSL = [3, 2, 3]  # 7 images a domain: the 3-image domains wrap and reshuffle each epoch
KEYS = ("img", "donor", "mask")
P_SOURCES, P_TARGET, P_BSL = (0, 1, 2, 3, 4), 5, [2] * 5


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The JAX package's synthetic trees (written with PIL): fundus 48^2,
    7 train and 2 test pairs a domain; prostate 24^2, 5 slices a domain."""
    root = tmp_path_factory.mktemp("host_trees")
    fundus = make_fundus_tree(str(root), per_domain_train=7, per_domain_test=2, size=48, seed=3)
    prostate = make_prostate_tree(str(root), per_domain=5, size=24, seed=3)
    return fundus, prostate


def fundus_datasets(base, cls, aug, is_out_domain=True):
    """One dataset per source domain as the train loop builds them."""
    return [
        cls(base, [d], np_transform=aug(S), is_freq=True, is_out_domain=is_out_domain, test_domain_idx=TARGET,
            donor_size=S, rng=np.random.default_rng(7 + i), resize_to=S)
        for i, d in enumerate(SOURCES)
    ]


def prostate_datasets(base, cls, is_out_domain=True):
    return [
        cls(base, [d], is_freq=True, is_out_domain=is_out_domain, test_domain_idx=P_TARGET,
            rng=np.random.default_rng(7 + i))
        for i, d in enumerate(P_SOURCES)
    ]


def assert_items_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, str):
            assert got[k] == w, k
            continue
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


# --- cv_resize ----------------------------------------------------------------------

# (source h, w, output h, w): scale-ups to 1.5x and downs to 0.5x, an exact
# halving (cv2 takes its 2x2 mean there), one axis kept, 1-pixel edges
RESIZE_CASES = [
    (32, 32, 48, 48), (32, 48, 40, 57), (64, 64, 96, 96), (256, 256, 384, 300), (256, 256, 128, 200),
    (32, 32, 16, 16), (100, 37, 150, 37), (131, 77, 66, 39), (1, 1, 5, 3), (7, 1, 1, 9), (33, 45, 1, 1),
]


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("h,w,out_h,out_w", RESIZE_CASES, ids=lambda v: str(v))
def test_cv_resize_equals_cv2(h, w, out_h, out_w, channels):
    rng = np.random.default_rng(h * 1000 + w)
    a = rng.integers(0, 256, (h, w) + ((channels,) if channels == 3 else ()), dtype=np.uint8)
    for interp, name in ((cv2.INTER_LINEAR, "linear"), (cv2.INTER_NEAREST, "nearest")):
        want = cv2.resize(a, (out_w, out_h), interpolation=interp)
        got = cv_resize(a, (out_w, out_h), name)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_cv_resize_sweep_equals_cv2():
    """300 random sizes from 32 to 256 scaled by 0.5-1.5 on each axis, one
    and three channels: every pixel equal."""
    rng = np.random.default_rng(11)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(32, 257, 2))
        out_h, out_w = (max(1, int(v * rng.uniform(0.5, 1.5))) for v in (h, w))
        a = rng.integers(0, 256, (h, w, 3) if rng.random() < 0.5 else (h, w), dtype=np.uint8)
        for interp, name in ((cv2.INTER_LINEAR, "linear"), (cv2.INTER_NEAREST, "nearest")):
            np.testing.assert_array_equal(cv_resize(a, (out_w, out_h), name),
                                          cv2.resize(a, (out_w, out_h), interpolation=interp),
                                          err_msg=f"{name} {a.shape} -> {(out_h, out_w)}")


def test_cv_resize_refuses_what_cv2_would_not_take():
    with pytest.raises(ValueError, match="uint8"):
        cv_resize(np.zeros((4, 4), np.float32), (2, 2), "linear")
    with pytest.raises(ValueError, match="interpolation"):
        cv_resize(np.zeros((4, 4), np.uint8), (2, 2), "cubic")
    with pytest.raises(ValueError, match="size"):
        cv_resize(np.zeros((4, 4), np.uint8), (0, 2), "nearest")


# --- the scale-crop and the datasets ------------------------------------------------


def test_np_random_scale_crop_equals_jax():
    """The same crops from the same Generator seeds, and the same draws
    consumed (the next draw agrees); both branches are taken."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
    mask = rng.integers(0, 256, (48, 48), dtype=np.uint8)
    scaled = 0
    for seed in range(40):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = np_random_scale_crop(img, mask, S, r1), jscale_crop(img, mask, S, r2)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.flags.c_contiguous
            np.testing.assert_array_equal(g, w)
        assert r1.random() == r2.random()
        scaled += np.random.default_rng(seed).random() > 0.5
    assert 5 < scaled < 35
    crop = ScaleCropAug(S)
    assert pickle.loads(pickle.dumps(crop)).size == S
    for g, w in zip(crop(img, mask, np.random.default_rng(3)), JScaleCropAug(S)(img, mask, np.random.default_rng(3))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("is_out_domain", [True, False], ids=["out_domain", "in_domain"])
def test_fundus_get_item_equals_jax(trees, is_out_domain):
    """Every train item for three sample seeds: the cached resize, the
    scale-crop, the uint8 multilabel mask, the domain and the donor; then
    `__getitem__` from the datasets' own Generators."""
    base = trees[0]
    ours = fundus_datasets(base, FundusMultiDataset, ScaleCropAug, is_out_domain)
    theirs = fundus_datasets(base, JFundusMultiDataset, JScaleCropAug, is_out_domain)
    for a, b in zip(ours, theirs):
        assert a.id_path == b.id_path and len(a) == 7
        for seed in range(3):
            for i in range(len(a)):
                got = a.get_item(i, np.random.default_rng((seed, i)))
                assert got["img"].dtype == np.uint8 and got["mask"].shape == (S, S, 2)
                assert_items_equal(got, b.get_item(i, np.random.default_rng((seed, i))))
        for i in (3, 0, 6, 3):
            assert_items_equal(a[i], b[i])


def test_fundus_test_split_and_options_equal_jax(trees):
    """The test split at the original size with mask_orig and id, `num`,
    is_freq=False and no resize or transform."""
    base = trees[0]
    a, b = FundusMultiDataset(base, [0, 2], split="test"), JFundusMultiDataset(base, [0, 2], split="test")
    assert a.id_path == b.id_path and len(a) == 4
    for i in range(len(a)):
        assert_items_equal(a.get_item(i), b.get_item(i))
    a = FundusMultiDataset(base, [1, 2], num=9, is_freq=False, cache=False)
    b = JFundusMultiDataset(base, [1, 2], num=9, is_freq=False, cache=False)
    assert len(a) == 9 and a.id_path == b.id_path
    for i in (0, 8):  # a multi-domain set names each item's own domain
        assert_items_equal(a.get_item(i, np.random.default_rng(1)), b.get_item(i, np.random.default_rng(1)))


def test_decode_cache_pickles_its_configuration_not_its_contents():
    cache = _DecodeCache(max_items=2)
    calls = []

    def build(v):
        calls.append(v)
        return np.full(3, v)

    assert cache.get("a", lambda: build(1))[0] == 1 and cache.get("a", lambda: build(9))[0] == 1
    cache.get("b", lambda: build(2))
    cache.get("c", lambda: build(3))  # over max_items: built, not kept
    cache.get("c", lambda: build(4))
    assert calls == [1, 2, 3, 4]
    copy = pickle.loads(pickle.dumps(cache))
    assert copy.max_items == 2 and copy.get("a", lambda: build(5))[0] == 5
    # from many threads at once, every caller gets the value of its key
    shared, seen = _DecodeCache(), []
    threads = [threading.Thread(target=lambda k=k: seen.append((k, shared.get(k % 4, lambda: k % 4))))
               for k in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(seen) == 64 and all(v == k % 4 for k, v in seen)


@pytest.mark.parametrize("is_out_domain", [True, False], ids=["out_domain", "in_domain"])
def test_prostate_get_item_equals_jax(trees, is_out_domain):
    base = trees[1]
    ours, theirs = prostate_datasets(base, ProstateMultiDataset, is_out_domain), prostate_datasets(
        base, JProstateMultiDataset, is_out_domain)
    for a, b in zip(ours, theirs):
        assert a.id_path == b.id_path and len(a) == 5
        for seed in range(3):
            for i in range(len(a)):
                got = a.get_item(i, np.random.default_rng((seed, i)))
                assert got["img"].dtype == np.float32 and got["mask"].dtype == np.int32
                assert_items_equal(got, b.get_item(i, np.random.default_rng((seed, i))))
        assert_items_equal(a[2], b[2])


# --- the fused loaders -----------------------------------------------------------------


def _epochs(loader, n):
    out = [batch for _ in range(n) for batch in loader]
    getattr(loader, "shutdown", lambda: None)()
    return out


@pytest.mark.parametrize("kind", ["thread", "process"])
def test_fused_loader_batches_equal_jax(trees, kind):
    """Two epochs of the reference fundus keys and of prostate, batch for
    batch: the same plan, reshuffles and per-sample draws; uint8 fundus
    batches, float32 / int32 prostate ones."""
    base_f, base_p = trees
    if kind == "thread":
        make = lambda mod, ds, bsl, keys: mod.FusedMultiDomainLoader(ds, bsl, keys, seed=5, num_workers=3, prefetch=2)
    else:
        make = lambda mod, ds, bsl, keys: mod.ProcessFusedMultiDomainLoader(ds, bsl, keys, seed=5, num_workers=2)
    runs = [
        (fundus_datasets(base_f, FundusMultiDataset, ScaleCropAug), fundus_datasets(
            base_f, JFundusMultiDataset, JScaleCropAug), BSL, KEYS, np.uint8),
        (prostate_datasets(base_p, ProstateMultiDataset), prostate_datasets(base_p, JProstateMultiDataset),
         P_BSL, KEYS, np.float32),
    ]
    for ours, theirs, bsl, keys, img_dtype in runs:
        got = _epochs(make(loaders, ours, bsl, keys), 2)
        want = _epochs(make(jloaders, theirs, bsl, keys), 2)
        assert len(got) == len(want) == 2 * max(len(d) // b for d, b in zip(ours, bsl))
        assert got[0]["img"].dtype == img_dtype and got[0]["img"].shape[0] == sum(bsl)
        for g, w in zip(got, want):
            assert_items_equal(g, w)
        assert not np.array_equal(got[0]["img"], got[len(got) // 2]["img"])  # epochs differ


def test_rows_slice_equals_jax_and_the_full_build(trees):
    """A data-parallel rank's rows 3..6 of each batch: JAX's rows build, and
    those rows of the full batch."""
    base = trees[0]
    build = lambda mod, cls, aug, rows: mod.FusedMultiDomainLoader(
        fundus_datasets(base, cls, aug), BSL, KEYS, seed=9, num_workers=2, rows=rows)
    got = _epochs(build(loaders, FundusMultiDataset, ScaleCropAug, slice(3, 7)), 2)
    want = _epochs(build(jloaders, JFundusMultiDataset, JScaleCropAug, slice(3, 7)), 2)
    full = _epochs(build(loaders, FundusMultiDataset, ScaleCropAug, None), 2)
    for g, w, f in zip(got, want, full):
        assert g["img"].shape[0] == 4
        assert_items_equal(g, w)
        assert_items_equal(g, {k: v[3:7] for k, v in f.items()})


def _producers_settled(started):
    """True when every DataLoader producer thread in `started` has stopped
    drawing: it has ended, or it waits in Queue.put on a full queue (with
    its consumer gone, nothing takes from it; the JAX package's producer
    stays blocked there)."""
    frames = sys._current_frames()
    for t in started:
        frame = frames.get(t.ident) if t.is_alive() else None
        while frame is not None and not (frame.f_code.co_name == "put" and frame.f_code.co_filename.endswith("queue.py")):
            frame = frame.f_back
        if t.is_alive() and (frame is None or not frame.f_locals["self"].full()):
            return False
    return True


def _settle_producers(before, timeout=60.0):
    """Wait until the DataLoader producers started since `before` (a set of
    threads) have stopped drawing.  A pass of MultiDomainIterator leaves a
    wrapped loader's next-epoch producer prefetching; it draws donors from
    the same dataset Generator as the next pass's producer, in either
    package, so the order of their draws would depend on thread timing."""
    started = [t for t in threading.enumerate() if t not in before and t.name.endswith("(producer)")]
    deadline = time.monotonic() + timeout
    while not _producers_settled(started):
        assert time.monotonic() < deadline, f"loader producers still drawing after {timeout} s"
        time.sleep(0.01)


def test_dataloader_and_multidomain_iterator_equal_jax(trees):
    """Per-domain DataLoaders (one worker thread, so the datasets' own
    Generators draw in order) zipped by MultiDomainIterator over two passes:
    the same batches, the cycling of the shorter loaders across the pass
    boundary, concat_domain_batches.  Each pass's abandoned prefetching
    producers stop drawing before the next pass starts (_settle_producers),
    in both packages."""
    base = trees[0]

    def iterate(mod, cls, aug):
        dls = [mod.DataLoader(ds, bs, num_workers=1, seed=4 + i)
               for i, (ds, bs) in enumerate(zip(fundus_datasets(base, cls, aug), [2, 3, 2]))]
        it = mod.MultiDomainIterator(dls)
        assert len(it) == 3 and [len(dl) for dl in dls] == [3, 2, 3]
        steps = []
        for _ in range(2):
            before = set(threading.enumerate())
            steps += [mod.concat_domain_batches(step, KEYS + ("domain",)) for step in it]
            _settle_producers(before)
        return steps

    got, want = iterate(loaders, FundusMultiDataset, ScaleCropAug), iterate(jloaders, JFundusMultiDataset, JScaleCropAug)
    assert len(got) == 6
    for g, w in zip(got, want):
        assert_items_equal(g, w)
    # domain 1 (3 rows, 2 batches an epoch) wraps at each pass's third step
    # and starts a reshuffled epoch at each pass
    d1 = slice(2, 5)
    for i, j in ((0, 2), (0, 3), (2, 5)):
        assert not np.array_equal(got[i]["img"][d1], got[j]["img"][d1]), (i, j)
    ds = fundus_datasets(base, FundusMultiDataset, ScaleCropAug)[0]
    tail = list(loaders.DataLoader(ds, 3, shuffle=False, drop_last=False, num_workers=1))
    assert [len(b["img"]) for b in tail] == [3, 3, 1]
    # a consumer that stops early leaves no producer thread behind
    before = threading.active_count()
    it = iter(loaders.DataLoader(ds, 1, num_workers=1, prefetch=1, seed=0))
    next(it)
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before


def test_a_domain_smaller_than_its_batch_raises(trees):
    ds = fundus_datasets(trees[0], FundusMultiDataset, ScaleCropAug)
    with pytest.raises(ValueError, match="domain 1: dataset size 7 < batch size 8"):
        loaders.FusedMultiDomainLoader(ds, [3, 8, 3], KEYS, seed=0)
    with pytest.raises(ValueError, match="loader 2 yields 0 batches"):
        loaders.MultiDomainIterator([loaders.DataLoader(d, bs) for d, bs in zip(ds, [3, 3, 9])])
    with pytest.raises(ValueError, match="3 datasets for 2 batch sizes"):
        loaders.FusedMultiDomainLoader(ds, [3, 3], KEYS, seed=0)


def test_worker_failures_raise(trees, tmp_path):
    """A sample that cannot be built raises in the caller with the worker's
    traceback, from thread and process workers; a worker that dies raises
    too, and shutdown leaves no worker behind."""
    import multiprocessing
    import shutil

    base = str(tmp_path / "fundus")
    shutil.copytree(trees[0], base)
    for line in FundusMultiDataset(base, [SOURCES[1]]).id_path:  # every image of a source domain
        with open(os.path.join(base, line.split(" ")[0]), "wb") as f:
            f.write(b"not a png")
    ds = lambda: fundus_datasets(base, FundusMultiDataset, ScaleCropAug)
    with pytest.raises(ValueError):
        _epochs(loaders.FusedMultiDomainLoader(ds(), BSL, KEYS, seed=0, num_workers=2), 1)
    proc = loaders.ProcessFusedMultiDomainLoader(ds(), BSL, KEYS, seed=0, num_workers=2)
    with pytest.raises(RuntimeError, match="loader worker failed"):
        _epochs(proc, 1)
    proc.shutdown()
    proc = loaders.ProcessFusedMultiDomainLoader(
        fundus_datasets(trees[0], FundusMultiDataset, ScaleCropAug), BSL, KEYS, seed=0, num_workers=2, prefetch=1)
    it = iter(proc)
    next(it)
    for p in proc._pool:
        p.kill()
    with pytest.raises(RuntimeError, match="loader worker died"):
        next(it)
    proc.shutdown()
    assert not [p for p in multiprocessing.active_children() if p.is_alive()]


NO_TORCH = r"""
import os, sys
import numpy as np
from ramdsir_tpu_torch.data.fundus import FundusMultiDataset
from ramdsir_tpu_torch.data.loaders import ProcessFusedMultiDomainLoader
from ramdsir_tpu_torch.data.prostate import ProstateMultiDataset
from ramdsir_tpu_torch.data.transforms import ScaleCropAug

fundus, prostate = sys.argv[1:3]
ds = [FundusMultiDataset(fundus, [d], np_transform=ScaleCropAug(32), test_domain_idx=0, donor_size=32,
                         rng=np.random.default_rng(d), resize_to=32) for d in (1, 2, 3)]
pds = [ProstateMultiDataset(prostate, [d], test_domain_idx=5) for d in range(5)]
n = 0
for datasets, bsl in ((ds, [3, 2, 3]), (pds, [2] * 5)):
    loader = ProcessFusedMultiDomainLoader(datasets, bsl, ("img", "donor", "mask"), seed=1, num_workers=2)
    n += sum(1 for _ in loader)
    loader.shutdown()
print(n, sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "ramdsir_tpu", "PIL", "cv2")))
"""


def test_process_workers_never_import_torch(trees, tmp_path):
    """The process loader and its workers run with a `torch`, a `PIL` and a
    `cv2` on the path that raise when imported (the card has no PIL or
    cv2): a worker that imported one would fail its task and the parent
    would raise.  The parent imports none of them, nor JAX or the JAX
    package."""
    for name in ("torch", "PIL", "cv2"):
        fake = tmp_path / "poisoned" / name
        fake.mkdir(parents=True)
        (fake / "__init__.py").write_text(f"raise ImportError('a loader worker imported {name}')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path / "poisoned"), REPO, env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", NO_TORCH, *trees], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "5 []", proc.stdout  # 3 fundus and 2 prostate batches
