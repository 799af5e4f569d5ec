"""The port's transform library (`data/transforms.py`) and its PIL filters
(`ops/image.py`: rotate, gaussian_blur, sharpness, solarize), held bit for
bit to the JAX package's PIL-based transforms on the same arrays and the
same Generator seeds.  PIL is the oracle here, in the tests only: the port
never imports it."""
import numpy as np
import pytest
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

import ramdsir_tpu.data.transforms as jt
import ramdsir_tpu_torch.data.transforms as tt
from ramdsir_tpu_torch.ops import image
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

SIZES = ((47, 61), (61, 47), (32, 32), (5, 3))  # (height, width): non-square, odd, tiny
SEEDS = range(12)


def _arrays(h, w, seed=0):
    """An RGB image and a fundus-style gray mask (0 / 128 / 255 blobs) of
    one size."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:h, :w]
    r = np.hypot(yy - h / 2, xx - w / 2)
    mask = np.where(r < min(h, w) / 5, 0, np.where(r < min(h, w) / 3, 128, 255)).astype(np.uint8)
    return img, mask


def _pil_sample(img, mask, freq=None):
    s = {"img": Image.fromarray(img), "mask": Image.fromarray(mask)}
    if freq is not None:
        s["img_freq"] = Image.fromarray(freq)
    return s


def _np_sample(img, mask, freq=None):
    s = {"img": img.copy(), "mask": mask.copy()}
    if freq is not None:
        s["img_freq"] = freq.copy()
    return s


def _assert_samples_equal(ours, want):
    assert sorted(ours) == sorted(want)
    for k, v in want.items():
        w = np.asarray(v)
        o = ours[k]
        assert isinstance(o, np.ndarray), k
        assert o.dtype == w.dtype and o.shape == w.shape, (k, o.dtype, o.shape, w.dtype, w.shape)
        np.testing.assert_array_equal(o, w, err_msg=k)


# --- the PIL filters, case by case ------------------------------------------


@pytest.mark.parametrize("h,w", SIZES, ids=str)
def test_rotate_equals_pil_at_every_angle(h, w):
    img, mask = _arrays(h, w)
    for angle in range(-20, 21):
        for src in (img, mask):
            want = np.asarray(Image.fromarray(src).rotate(angle, Image.BILINEAR))
            np.testing.assert_array_equal(image.rotate(src, angle, "bilinear"), want, err_msg=f"bilinear {angle}")
        want = np.asarray(Image.fromarray(mask).rotate(angle, Image.NEAREST, fillcolor=255))
        np.testing.assert_array_equal(image.rotate(mask, angle, "nearest", fill=255), want, err_msg=f"nearest {angle}")
        want = np.asarray(Image.fromarray(img).rotate(angle, Image.NEAREST))
        np.testing.assert_array_equal(image.rotate(img, angle, "nearest"), want, err_msg=f"nearest rgb {angle}")


def test_rotate_past_the_fixed_point_range_equals_pil():
    """A corner coordinate at 32768 or more: PIL's NEAREST steps in double."""
    mask = np.random.default_rng(1).integers(0, 256, (3, 40000), dtype=np.uint8)
    for angle in (-3, 5):
        want = np.asarray(Image.fromarray(mask).rotate(angle, Image.NEAREST, fillcolor=255))
        np.testing.assert_array_equal(image.rotate(mask, angle, "nearest", fill=255), want)


# radii across Blur's U(0.1, 2.0), with the box-size boundary at sqrt(2)
# (the box radius l steps from 0 to 1 there) on both sides of it
BLUR_RADII = [*np.linspace(0.1, 2.0, 39), np.sqrt(2.0), np.nextafter(np.sqrt(2.0), 0.0),
              np.nextafter(np.sqrt(2.0), 2.0), np.float32(np.sqrt(2.0)), 1.0, 0.5, 1.999999]


@pytest.mark.parametrize("h,w", SIZES, ids=str)
def test_gaussian_blur_equals_pil(h, w):
    img, mask = _arrays(h, w)
    for radius in BLUR_RADII:
        for src in (img, mask):
            want = np.asarray(Image.fromarray(src).filter(ImageFilter.GaussianBlur(float(radius))))
            np.testing.assert_array_equal(image.gaussian_blur(src, float(radius)), want, err_msg=str(radius))


@pytest.mark.parametrize("h,w", SIZES, ids=str)
def test_sharpness_and_solarize_equal_pil(h, w):
    img, mask = _arrays(h, w)
    for factor in np.linspace(0.05, 0.95, 31):
        for src in (img, mask):
            want = np.asarray(ImageEnhance.Sharpness(Image.fromarray(src)).enhance(float(factor)))
            np.testing.assert_array_equal(image.sharpness(src, float(factor)), want, err_msg=str(factor))
    for t in range(257):
        np.testing.assert_array_equal(image.solarize(img, t), np.asarray(ImageOps.solarize(Image.fromarray(img), t)))


def test_filters_refuse_what_they_do_not_compute():
    with pytest.raises(ValueError, match="uint8"):
        image.rotate(np.zeros((4, 4), np.float32), 3, "bilinear")
    with pytest.raises(ValueError, match="resample"):
        image.rotate(np.zeros((4, 4), np.uint8), 3, "bicubic")
    with pytest.raises(ValueError, match="alpha"):
        image.sharpness(np.zeros((4, 4), np.uint8), 1.5)


# --- the transforms against the JAX classes ---------------------------------


def _both(make, sample_args, seeds=SEEDS, freq=False):
    """Run the JAX transform (PIL images) and the port's (arrays), each
    built by make(module, rng) from one seed, and compare the samples."""
    img, mask = sample_args
    f = (255 - img) if freq else None
    for seed in seeds:
        want = make(jt, np.random.default_rng(seed))(_pil_sample(img, mask, f))
        ours = make(tt, np.random.default_rng(seed))(_np_sample(img, mask, f))
        _assert_samples_equal(ours, want)


RANDOM_TRANSFORMS = {
    "RandomCrop": lambda m, rng: m.RandomCrop((40, 30), rng),
    "RandomCrop_pad": lambda m, rng: m.RandomCrop((70, 66), rng),
    "RandomScaleCrop": lambda m, rng: m.RandomScaleCrop((40, 30), rng),
    "Hflip": lambda m, rng: m.Hflip(rng),
    "RandomResize": lambda m, rng: m.RandomResize(rng=rng),
    "RandomResize_base": lambda m, rng: m.RandomResize(base_long_size=50, scale_range=(0.5, 1.5), rng=rng),
    "Rotate": lambda m, rng: m.Rotate(rng),
    "Blur": lambda m, rng: m.Blur(rng),
    "Sharpness": lambda m, rng: m.Sharpness(p=0.6, rng=rng),
    "Solarize": lambda m, rng: m.Solarize(p=0.6, rng=rng),
}


@pytest.mark.parametrize("h,w", SIZES[:2], ids=str)
@pytest.mark.parametrize("name", sorted(RANDOM_TRANSFORMS))
def test_random_transform_equals_jax(name, h, w):
    """Same draws, same arrays, with and without an 'img_freq' image."""
    args = _arrays(h, w)
    _both(RANDOM_TRANSFORMS[name], args)
    if name != "RandomCrop_pad":
        _both(RANDOM_TRANSFORMS[name], args, seeds=range(3), freq=True)


@pytest.mark.parametrize("h,w", SIZES[:2], ids=str)
def test_deterministic_transforms_equal_jax(h, w):
    args = _arrays(h, w)
    for make in (lambda m, rng: m.Resize((36, 40)), lambda m, rng: m.CenterCrop((40, 30)),
                 lambda m, rng: m.CenterCrop((70, 66)), lambda m, rng: m.ResizeRatio(25),
                 lambda m, rng: m.Compose([m.Resize((36, 40)), m.Hflip(rng), m.RandomScaleCrop((32, 32), rng)])):
        _both(make, args, seeds=range(4))
    img, mask = args
    want = jt.Normalize()(_pil_sample(img, mask, 255 - img))
    _assert_samples_equal(tt.Normalize()(_np_sample(img, mask, 255 - img)), want)
    no_mask = tt.Normalize()({"img": img, "mask": None})
    assert sorted(no_mask) == ["img"]


def test_rotate_covers_every_angle_through_the_class():
    """The class's draws reach all 41 angles over the seeds, each equal."""
    img, mask = _arrays(47, 61)
    angles = set()
    for seed in range(400):
        angles.add(int(np.random.default_rng(seed).integers(-20, 21)))
    assert angles == set(range(-20, 21))
    _both(RANDOM_TRANSFORMS["Rotate"], (img, mask), seeds=range(40))


@pytest.mark.parametrize("pixel_level", [True, False], ids=["pixel_level", "scalar"])
def test_cutout_equals_jax(pixel_level):
    for h, w in SIZES[:3]:
        img, mask = _arrays(h, w)
        _both(lambda m, rng: m.CutOut(p=1.0, pixel_level=pixel_level, rng=rng), (img, mask), seeds=range(20))
        _both(lambda m, rng: m.CutOut(p=1.0, pixel_level=pixel_level, rng=rng), (mask, mask), seeds=range(5))
    _both(lambda m, rng: m.CutOut(rng=rng), _arrays(47, 61), seeds=range(10))  # p = 0.5


@pytest.mark.parametrize("rate", [1.0, 0.0, 0.8], ids=["in_painting", "out_painting", "default"])
def test_get_pair_equals_jax(rate):
    for h, w in SIZES[:3]:
        _both(lambda m, rng: m.GetPair(inpaint_rate=rate, rng=rng), _arrays(h, w), seeds=range(10))


PAINTERS = ("image_in_painting", "image_in_painting_constant", "image_in_painting_rand_constant",
            "image_out_painting", "image_out_painting_constant", "image_out_painting_rand_constant")


@pytest.mark.parametrize("name", PAINTERS)
def test_painting_functions_equal_jax(name):
    for h, w in SIZES[:3]:
        img, mask = _arrays(h, w)
        for src in (img, mask):
            for seed in range(6):
                want = getattr(jt, name)(src, np.random.default_rng(seed))
                ours = getattr(tt, name)(src, np.random.default_rng(seed))
                assert ours.dtype == want.dtype
                np.testing.assert_array_equal(ours, want)


def test_boundary_and_contour_transforms_equal_jax():
    _, gray = _arrays(47, 61)
    for dtype in (np.float32, np.uint8):
        mask = jt.fundus_multilabel(gray).astype(dtype)
        for name, args in (("GetBoundary", (5,)), ("GetBoundary", (2,)), ("GetContourBg", (5, 1)),
                           ("GetContourBg", (3, 2))):
            want, ours = getattr(jt, name)(*args)(mask), getattr(tt, name)(*args)(mask)
            for o, w in zip(np.atleast_1d(ours) if isinstance(ours, np.ndarray) else ours,
                            np.atleast_1d(want) if isinstance(want, np.ndarray) else want):
                assert o.dtype == w.dtype
                np.testing.assert_array_equal(o, w)
        plane = mask[:, :, 1]
        np.testing.assert_array_equal(tt.GetBoundary_Single(3)(plane), jt.GetBoundary_Single(3)(plane))
        for o, w in zip(tt.GetContourBg_Single(4, 2)(plane), jt.GetContourBg_Single(4, 2)(plane)):
            assert o.dtype == w.dtype
            np.testing.assert_array_equal(o, w)


def test_reference_chains_equal_jax():
    """The reference's training chain (Resize, RandomScaleCrop) and test
    chain (Resize, Normalize), and a chain of every random transform."""
    img, mask = _arrays(61, 47)
    _both(lambda m, rng: m.Compose([m.Resize((40, 40)), m.RandomScaleCrop((40, 40), rng)]), (img, mask))
    _both(lambda m, rng: m.Compose([m.Resize((40, 40)), m.Normalize()]), (img, mask), seeds=range(1))
    _both(lambda m, rng: m.Compose([m.RandomScaleCrop((40, 36), rng), m.Rotate(rng), m.Hflip(rng), m.Blur(rng),
                                    m.Sharpness(0.5, rng), m.Solarize(0.5, rng), m.CutOut(rng=rng),
                                    m.GetPair(rng=rng)]), (img, mask))
