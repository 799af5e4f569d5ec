"""Host-side sample transforms (PyTorch port of `ramdsir_tpu/data/transforms.py`):
the reference's transform library and the training loaders' scale-crop.

Samples are dicts {'img', 'mask', optional 'img_freq'} of numpy uint8
arrays: (H, W, 3) images and (H, W) masks, the arrays `np.asarray` gives of
the PIL images the JAX package passes.  Every transform returns the arrays
that `np.asarray` gives of the JAX package's PIL result, bit for bit: the
PIL operations are `ops/image.py`'s (`resize`, `rotate`, `gaussian_blur`,
`sharpness`, `solarize`, measured equal to Pillow 12.1.0), `ImageOps.expand`
and `crop` are numpy pads and slices.  Randomness flows through an explicit
numpy Generator, drawn in the JAX classes' order with the same calls, so
one seed gives the same samples in both packages.

The loaders' scale-crop (`np_random_scale_crop`) resizes with
`ops.image.cv_resize`, equal to cv2's INTER_LINEAR / INTER_NEAREST, the
branch the JAX package takes where cv2 is installed.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ramdsir_tpu_torch.ops import image
from ramdsir_tpu_torch.ops.image import cv_resize

Sample = Dict[str, object]


def to_multilabel(class_mask: np.ndarray, classes: int = 2) -> np.ndarray:
    """Class map {0: bg, 1: disc, 2: cup} -> (H, W, 2) float32 [cup, disc]:
    disc = [0, 1], cup = [1, 1]."""
    mask = np.zeros((class_mask.shape[0], class_mask.shape[1], classes), np.float32)
    mask[class_mask == 1] = [0, 1]
    mask[class_mask == 2] = [1, 1]
    return mask


def decode_fundus_mask(gray: np.ndarray) -> np.ndarray:
    """Gray-value mask -> class map: >200 bg(0), 51..200 disc(1), <=50 cup(2)."""
    gray = np.asarray(gray).astype(np.uint8)
    out = np.full(gray.shape, 2, np.uint8)
    out[gray > 200] = 0
    out[(gray > 50) & (gray < 201)] = 1
    return out


def fundus_multilabel(gray: np.ndarray) -> np.ndarray:
    """(H, W) gray mask -> (H, W, 2) float32 [cup, disc]."""
    return to_multilabel(decode_fundus_mask(gray))


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: Sample) -> Sample:
        for t in self.transforms:
            sample = t(sample)
        return sample


def _apply_imgs(sample: Sample, fn: Callable[[np.ndarray], np.ndarray]) -> Sample:
    out = dict(sample)
    out["img"] = fn(sample["img"])
    if "img_freq" in sample:
        out["img_freq"] = fn(sample["img_freq"])
    return out


def _resize_sample(sample: Sample, width: int, height: int) -> Sample:
    """Bilinear images, nearest mask (PIL's resize)."""
    out = _apply_imgs(sample, lambda im: image.resize(im, (width, height), "bilinear"))
    out["mask"] = image.resize(sample["mask"], (width, height), "nearest")
    return out


def _size(a: np.ndarray) -> Tuple[int, int]:
    """PIL's (width, height) of an image array."""
    return a.shape[1], a.shape[0]


def _expand(a: np.ndarray, padw: int, padh: int, fill: int) -> np.ndarray:
    """`ImageOps.expand(im, border=(0, 0, padw, padh), fill)`: pad right and bottom."""
    pad = [(0, padh), (0, padw)] + [(0, 0)] * (a.ndim - 2)
    return np.pad(a, pad, constant_values=fill)


def _crop(a: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    x0, y0, x1, y1 = box
    return np.ascontiguousarray(a[y0:y1, x0:x1])


class Resize:
    """Bilinear image / nearest mask resize to target_size = (width, height)."""

    def __init__(self, target_size: Tuple[int, int]):
        self.target_size = target_size

    def __call__(self, sample: Sample) -> Sample:
        return _resize_sample(sample, self.target_size[0], self.target_size[1])


class RandomCrop:
    """Pad to size (mask with 255), then a random crop."""

    def __init__(self, output_size: Tuple[int, int], rng: Optional[np.random.Generator] = None):
        self.output_size = output_size
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Sample) -> Sample:
        img, mask = sample["img"], sample["mask"]
        w, h = _size(img)
        padw = max(self.output_size[0] - w, 0)
        padh = max(self.output_size[1] - h, 0)
        if padw or padh:
            img = _expand(img, padw, padh, 0)
            mask = _expand(mask, padw, padh, 255)
        w, h = _size(img)
        x = int(self.rng.integers(0, w - self.output_size[0] + 1))
        y = int(self.rng.integers(0, h - self.output_size[1] + 1))
        box = (x, y, x + self.output_size[0], y + self.output_size[1])
        out = {"img": _crop(img, box), "mask": _crop(mask, box)}
        if "img_freq" in sample:
            f = sample["img_freq"]
            if padw or padh:
                f = _expand(f, padw, padh, 0)
            out["img_freq"] = _crop(f, box)
        return out


class CenterCrop:
    """Pad to size (mask with 255), then the centre crop."""

    def __init__(self, output_size: Tuple[int, int]):
        self.output_size = output_size

    def __call__(self, sample: Sample) -> Sample:
        img, mask = sample["img"], sample["mask"]
        w, h = _size(img)
        padw = max(self.output_size[0] - w, 0)
        padh = max(self.output_size[1] - h, 0)
        if padw or padh:
            img = _expand(img, padw, padh, 0)
            mask = _expand(mask, padw, padh, 255)
        w, h = _size(img)
        x = (w - self.output_size[0]) // 2
        y = (h - self.output_size[1]) // 2
        box = (x, y, x + self.output_size[0], y + self.output_size[1])
        return {"img": _crop(img, box), "mask": _crop(mask, box)}


class RandomScaleCrop:
    """With probability 0.5 upscale by U(1, 1.5) on each axis, then RandomCrop."""

    def __init__(self, size: Tuple[int, int], rng: Optional[np.random.Generator] = None):
        self.size = size
        self.rng = rng or np.random.default_rng()
        self.crop = RandomCrop(size, self.rng)

    def __call__(self, sample: Sample) -> Sample:
        if self.rng.random() > 0.5:
            w0, h0 = _size(sample["img"])
            w = int(self.rng.uniform(1.0, 1.5) * w0)
            h = int(self.rng.uniform(1.0, 1.5) * h0)
            sample = _resize_sample(sample, w, h)
        return self.crop(sample)


class Hflip:
    """Horizontal flip with probability 0.5."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Sample) -> Sample:
        if self.rng.random() < 0.5:
            flip = lambda a: np.ascontiguousarray(a[:, ::-1])
            out = _apply_imgs(sample, flip)
            out["mask"] = flip(sample["mask"])
            return out
        return sample


class RandomResize:
    """Aspect-preserving random rescale: the short side (or
    `base_long_size`) times scale_range gives the integer range of the
    target side, drawn inclusively; the other side scales by the same
    ratio, truncated."""

    def __init__(
        self,
        base_long_size: Optional[int] = None,
        scale_range=(0.75, 1.20),
        rng: Optional[np.random.Generator] = None,
    ):
        self.base_long_size = base_long_size
        self.scale_range = scale_range
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Sample) -> Sample:
        w, h = _size(sample["img"])
        origin = self.base_long_size if self.base_long_size is not None else min(w, h)
        lo, hi = int(origin * self.scale_range[0]), int(origin * self.scale_range[1])
        target = int(self.rng.integers(lo, hi + 1))
        if w < h:
            oh = target
            ow = int(w * (oh / h))
        else:
            ow = target
            oh = int(h * (ow / w))
        return _resize_sample(sample, ow, oh)


class ResizeRatio:
    """Resize the short side to `size`, keeping the aspect."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, sample: Sample) -> Sample:
        w, h = _size(sample["img"])
        if w < h:
            nw, nh = self.size, int(h * self.size / w)
        else:
            nw, nh = int(w * self.size / h), self.size
        return _resize_sample(sample, nw, nh)


class Rotate:
    """Rotate by an integer degree in [-20, 20]: images bilinear, the mask
    nearest with fill 255 (the fundus background, not cup)."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Sample) -> Sample:
        angle = int(self.rng.integers(-20, 21))
        out = _apply_imgs(sample, lambda im: image.rotate(im, angle, "bilinear"))
        out["mask"] = image.rotate(sample["mask"], angle, "nearest", fill=255)
        return out


class Blur:
    """Gaussian blur of radius U(0.1, 2.0) with probability 0.5."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Sample) -> Sample:
        if self.rng.random() < 0.5:
            radius = float(self.rng.uniform(0.1, 2.0))
            return _apply_imgs(sample, lambda im: image.gaussian_blur(im, radius))
        return sample


class Sharpness:
    """Sharpness enhance with factor U(0.05, 0.95), with probability p."""

    def __init__(self, p: float = 0.2, rng: Optional[np.random.Generator] = None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Sample) -> Sample:
        if self.rng.random() < self.p:
            v = float(self.rng.uniform(0.05, 0.95))
            return _apply_imgs(sample, lambda im: image.sharpness(im, v))
        return sample


class Solarize:
    """Solarize with threshold randint(0, 256) inclusive, with probability
    p (threshold 256 leaves every uint8 pixel as it is)."""

    def __init__(self, p: float = 0.2, rng: Optional[np.random.Generator] = None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Sample) -> Sample:
        if self.rng.random() < self.p:
            t = int(self.rng.integers(0, 257))
            return _apply_imgs(sample, lambda im: image.solarize(im, t))
        return sample


class CutOut:
    """With probability p erase a random rectangle, the mask set to 255
    (ignored) inside it.  As the reference: (size, ratio, x, y) are redrawn
    together until the box fits (rejection), and the hole holds per-pixel
    U(value_min, value_max) noise when pixel_level, else one draw."""

    def __init__(
        self,
        p: float = 0.5,
        size_min: float = 0.02,
        size_max: float = 0.4,
        ratio_1: float = 0.3,
        ratio_2: float = 1 / 0.3,
        value_min: float = 0,
        value_max: float = 255,
        pixel_level: bool = True,
        rng: Optional[np.random.Generator] = None,
    ):
        self.p = p
        self.size_min, self.size_max = size_min, size_max
        self.ratio_1, self.ratio_2 = ratio_1, ratio_2
        self.value_min, self.value_max = value_min, value_max
        self.pixel_level = pixel_level
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Sample) -> Sample:
        if self.rng.random() >= self.p:
            return sample
        img = np.array(sample["img"])
        mask = np.array(sample["mask"])
        h, w = img.shape[:2]
        c = img.shape[2] if img.ndim == 3 else 1
        while True:
            size = self.rng.uniform(self.size_min, self.size_max) * h * w
            ratio = self.rng.uniform(self.ratio_1, self.ratio_2)
            erase_w = int(np.sqrt(size / ratio))
            erase_h = int(np.sqrt(size * ratio))
            x = int(self.rng.integers(0, w))
            y = int(self.rng.integers(0, h))
            if x + erase_w <= w and y + erase_h <= h:
                break
        if self.pixel_level:
            value = self.rng.uniform(self.value_min, self.value_max, (erase_h, erase_w, c))
            if img.ndim == 2:
                value = value[..., 0]
        else:
            value = self.rng.uniform(self.value_min, self.value_max)
        img[y : y + erase_h, x : x + erase_w] = value
        mask[y : y + erase_h, x : x + erase_w] = 255
        out = dict(sample)
        out["img"] = img.astype(np.uint8)
        out["mask"] = mask.astype(np.uint8)
        return out


class GetPair:
    """In/out-painting pretext pair: with probability `inpaint_rate` the
    corrupted copy is in-painted, else out-painted; it goes under 'img_aug'
    beside the untouched 'img' and 'mask'."""

    def __init__(self, inpaint_rate: float = 0.8, rng: Optional[np.random.Generator] = None):
        self.inpaint_rate = inpaint_rate
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Sample) -> Sample:
        img = np.array(sample["img"])
        if self.rng.random() < self.inpaint_rate:
            aug = image_in_painting(img, self.rng)
        else:
            aug = image_out_painting(img, self.rng)
        out = dict(sample)
        out["img_aug"] = aug.astype(np.uint8)
        return out


def _in_painting(img: np.ndarray, rng: np.random.Generator, fill) -> np.ndarray:
    """Up to 5 interior blocks, each further one with probability 0.95;
    side randint(S//6, S//3), offset randint(3, S - side - 3), both
    inclusive; `fill(bx, by)` gives a block's contents."""
    out = np.array(img, copy=True)
    rows, cols = out.shape[:2]
    cnt = 5
    while cnt > 0 and rng.random() < 0.95:
        bx = int(rng.integers(rows // 6, rows // 3 + 1))
        by = int(rng.integers(cols // 6, cols // 3 + 1))
        x = int(rng.integers(3, rows - bx - 3 + 1))
        y = int(rng.integers(3, cols - by - 3 + 1))
        val = fill(bx, by)
        if isinstance(val, np.ndarray) and out.ndim == 3:
            val = val[..., None]
        out[x : x + bx, y : y + by] = val
        cnt -= 1
    return out


def image_in_painting(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Blocks of uniform noise (x255), one (h, w) plane for every channel."""
    dtype = np.asarray(img).dtype
    return _in_painting(img, rng, lambda bx, by: (rng.random((bx, by)) * 255).astype(dtype))


def image_in_painting_constant(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Blocks of constant 255."""
    return _in_painting(img, rng, lambda bx, by: 255)


def image_in_painting_rand_constant(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Blocks of one constant 255 * U(0, 1) a block."""
    dtype = np.asarray(img).dtype
    return _in_painting(img, rng, lambda bx, by: (np.ones((bx, by)) * 255 * rng.random()).astype(dtype))


def _out_painting(img: np.ndarray, rng: np.random.Generator, canvas) -> np.ndarray:
    """Everything replaced by `canvas(shape)`, then 1 + up to 4 original
    blocks restored (each further one with probability 0.95); side
    S - randint(3S//7, 4S//7), offset randint(3, S - side - 3)."""
    src = np.array(img, copy=True)
    rows, cols = src.shape[:2]
    out = canvas(src.shape).astype(src.dtype)

    def restore():
        bx = rows - int(rng.integers(3 * rows // 7, 4 * rows // 7 + 1))
        by = cols - int(rng.integers(3 * cols // 7, 4 * cols // 7 + 1))
        x = int(rng.integers(3, rows - bx - 3 + 1))
        y = int(rng.integers(3, cols - by - 3 + 1))
        out[x : x + bx, y : y + by] = src[x : x + bx, y : y + by]

    restore()
    cnt = 4
    while cnt > 0 and rng.random() < 0.95:
        restore()
        cnt -= 1
    return out


def image_out_painting(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A canvas of per-channel uniform noise (x255)."""
    return _out_painting(img, rng, lambda shape: rng.random(shape) * 255)


def image_out_painting_constant(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A canvas of 255."""
    return _out_painting(img, rng, lambda shape: np.ones(shape) * 255)


def image_out_painting_rand_constant(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A canvas of one constant 255 * U(0, 1)."""
    return _out_painting(img, rng, lambda shape: np.ones(shape) * 255 * rng.random())


def _boundary_band(plane: np.ndarray, width: int) -> np.ndarray:
    """dilate^width + erode^width with the == 2 interior zeroed: the
    reference's symmetric boundary band."""
    from scipy import ndimage

    dila = ndimage.binary_dilation(plane, iterations=width).astype(plane.dtype)
    eros = ndimage.binary_erosion(plane, iterations=width).astype(plane.dtype)
    band = dila + eros
    band[band == 2] = 0
    return band


class GetBoundary:
    """(H, W, 2) [cup, disc] multilabel -> uint8 union of the two boundary bands."""

    def __init__(self, width: int = 5):
        self.width = width

    def __call__(self, mask: np.ndarray) -> np.ndarray:
        cup = _boundary_band(mask[:, :, 0], self.width)
        disc = _boundary_band(mask[:, :, 1], self.width)
        return ((cup + disc) > 0).astype(np.uint8)


class GetBoundary_Single:
    """The boundary band of one plane."""

    def __init__(self, width: int = 5):
        self.width = width

    def __call__(self, mask: np.ndarray) -> np.ndarray:
        return (_boundary_band(mask, self.width) > 0).astype(np.uint8)


def _contour_bg(plane: np.ndarray, bg_width: int, ct_width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(plane - erode^ct_width, dilate^bg_width - plane) in the plane's dtype."""
    from scipy import ndimage

    dila = ndimage.binary_dilation(plane, iterations=bg_width).astype(plane.dtype)
    eros = ndimage.binary_erosion(plane, iterations=ct_width).astype(plane.dtype)
    return plane - eros, dila - plane


class GetContourBg:
    """(H, W, 2) [cup, disc] multilabel -> (cup_contour, cup_bg,
    disc_contour, disc_bg)."""

    def __init__(self, bg_width: int = 5, ct_width: int = 1):
        self.bg_width = bg_width
        self.ct_width = ct_width

    def __call__(self, mask: np.ndarray):
        cup = _contour_bg(mask[:, :, 0], self.bg_width, self.ct_width)
        disc = _contour_bg(mask[:, :, 1], self.bg_width, self.ct_width)
        return cup[0], cup[1], disc[0], disc[1]


class GetContourBg_Single:
    """(contour, bg) of one plane."""

    def __init__(self, bg_width: int = 5, ct_width: int = 1):
        self.bg_width = bg_width
        self.ct_width = ct_width

    def __call__(self, mask: np.ndarray):
        return _contour_bg(mask, self.bg_width, self.ct_width)


class Normalize:
    """A fundus sample as float32 arrays: images in [0, 255] (the [-1, 1]
    scaling happens in the step), the mask decoded to the (H, W, 2)
    [cup, disc] multilabel."""

    def __call__(self, sample: Sample) -> Sample:
        out: Sample = {"img": np.asarray(sample["img"]).astype(np.float32)}
        if "img_freq" in sample:
            out["img_freq"] = np.asarray(sample["img_freq"]).astype(np.float32)
        if sample.get("mask") is not None:
            out["mask"] = fundus_multilabel(np.asarray(sample["mask"]))
        return out


def np_random_scale_crop(img: np.ndarray, mask: np.ndarray, size: int, rng: np.random.Generator):
    """With probability 0.5 upscale by U(1, 1.5) on each axis (bilinear
    image, nearest mask), then a random size x size crop; the draws in the
    JAX package's order."""
    if rng.random() > 0.5:
        h0, w0 = img.shape[:2]
        w = int(rng.uniform(1.0, 1.5) * w0)
        h = int(rng.uniform(1.0, 1.5) * h0)
        img = cv_resize(img, (w, h), "linear")
        mask = cv_resize(mask, (w, h), "nearest")
    h0, w0 = img.shape[:2]
    y = int(rng.integers(0, h0 - size + 1))
    x = int(rng.integers(0, w0 - size + 1))
    return (
        np.ascontiguousarray(img[y : y + size, x : x + size]),
        np.ascontiguousarray(mask[y : y + size, x : x + size]),
    )


class ScaleCropAug:
    """`np_random_scale_crop` at one size, as a picklable callable for
    process workers: (img, mask, rng) -> (img, mask)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img, mask, rng):
        return np_random_scale_crop(img, mask, self.size, rng)


class CreateOnehotLabel:
    """Integer mask -> one-hot channels under "onehot_label"."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def __call__(self, sample: Sample) -> Sample:
        mask = np.asarray(sample["mask"]).astype(np.int64)
        onehot = np.stack([(mask == i) for i in range(self.num_classes)], -1).astype(np.float32)
        out = dict(sample)
        out["onehot_label"] = onehot
        return out
