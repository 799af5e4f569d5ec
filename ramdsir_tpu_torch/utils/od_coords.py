"""OD / fovea localisation helpers (own copy of the numpy/scipy module
`ramdsir_tpu/utils/od_coords.py`, the reference's utils/od_coords.py, which
nothing imports): peak localisation, OD-vs-fovea disambiguation, mask
diameters and centroids.

`peak_local_max` (skimage.feature) and `blob_log` (Laplacian-of-Gaussian
blob detection) are re-implemented on scipy.ndimage with the semantics the
reference relies on: peaks are strict plateaus of a (2*min_distance+1)
maximum filter ranked by intensity, and blobs are scale-space maxima of the
scale-normalised -LoG response.

Two reference bugs are fixed, as in the JAX package: the threshold back-off
loop re-ran blob_log on the raw RGB image instead of the padded gray
(od_coords.py:157), and the fewer-than-2-blobs fallback discarded its
np.concatenate result (od_coords.py:163), so callers could still receive
fewer than 2 rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage


def peak_local_max(
    image: np.ndarray,
    min_distance: int = 1,
    num_peaks: Optional[int] = None,
    exclude_border: bool = True,
) -> np.ndarray:
    """Coordinates of local maxima, intensity-sorted (skimage semantics).

    A pixel is a peak when it equals the maximum of its
    (2*min_distance+1)-box neighbourhood and exceeds the image minimum;
    peaks within `min_distance` of the border are excluded
    (skimage's default `exclude_border=True` maps to min_distance);
    peaks closer than min_distance (Chebyshev — skimage's default
    p_norm=np.inf) to a stronger accepted peak are suppressed; at most
    num_peaks (strongest first) are returned as (N, ndim) int indices.
    """
    image = np.asarray(image, dtype=np.float64)
    size = 2 * int(min_distance) + 1
    maxed = ndimage.maximum_filter(image, size=size, mode="constant")
    candidates = np.argwhere((image == maxed) & (image > image.min()))
    if candidates.size == 0:
        return candidates.reshape(0, image.ndim)
    if exclude_border and min_distance > 0:
        lo = np.asarray(candidates) >= min_distance
        hi = candidates < np.asarray(image.shape) - min_distance
        candidates = candidates[(lo & hi).all(axis=1)]
        if candidates.size == 0:
            return candidates.reshape(0, image.ndim)
    order = np.argsort(image[tuple(candidates.T)])[::-1]
    candidates = candidates[order]
    accepted = []
    for c in candidates:
        if all(np.max(np.abs(c - a)) >= min_distance for a in accepted):
            accepted.append(c)
            if num_peaks is not None and len(accepted) >= num_peaks:
                break
    return np.asarray(accepted, dtype=np.intp)


def find_od_f(pred: np.ndarray) -> np.ndarray:
    """Two strongest well-separated peaks of a heatmap (od_coords.py:15-20)."""
    return peak_local_max(pred, min_distance=50, num_peaks=2)


def plot_coords(img: np.ndarray, coords: np.ndarray) -> None:
    """Overlay peak coordinates on the image (od_coords.py:22-25)."""
    import matplotlib.pyplot as plt

    plt.imshow(img)
    plt.plot(coords[:, 1], coords[:, 0], "r.")


def get_new_peaks(coords, shp) -> Tuple[float, float]:
    """Rescale 512-space peak coords to the original shape (od_coords.py:28-37)."""
    xo, yo = shp
    xp, yp = coords
    return (xp * xo) / 512, (yp * yo) / 512


def distance_metric(pred_coords, orig_coords) -> float:
    """Euclidean localization distance (od_coords.py:40-47)."""
    xp, yp = pred_coords
    xo, yo = orig_coords
    return float(np.sqrt((xo - xp) ** 2 + (yo - yp) ** 2))


def distance_error(pred_coords, orig_coords, od_radius: float = 88.0, r: float = 1):
    """Distance plus the OD-radius-normalized error (od_coords.py:50-58)."""
    dist = distance_metric(pred_coords, orig_coords)
    return dist, dist / (od_radius * r)


def determine_od(image: np.ndarray, coords: np.ndarray, neigh: int = 3):
    """Split two peaks into (od, fovea) by green-channel intensity
    (od_coords.py:61-96): the OD is the brighter neighbourhood; peaks are
    clamped `neigh` pixels inside the 512-space border first."""
    coords = np.array(coords)
    coords[coords < neigh] = neigh
    coords[coords > (511 - neigh)] = 511 - neigh
    c1, c2 = coords[0], coords[1]
    g = image[:, :, 1]
    i1 = np.mean(g[c1[0] - neigh : c1[0] + neigh, c1[1] - neigh : c1[1] + neigh])
    i2 = np.mean(g[c2[0] - neigh : c2[0] + neigh, c2[1] - neigh : c2[1] + neigh])
    if i1 >= i2:
        return c1, c2
    return c2, c1


def get_diameters(od_mask: np.ndarray) -> Tuple[int, int]:
    """Column/row extents of an OD mask (od_coords.py:98-119)."""
    collapsed = np.sum(od_mask, axis=0)
    indices = np.where(collapsed > 0)[0]
    dc = indices[-1] - indices[0]
    collapsedr = np.sum(od_mask, axis=1)
    indices = np.where(collapsedr > 0)[0]
    dr = indices[-1] - indices[0]
    return dc, dr


def get_centroid(mask: np.ndarray, fill: bool = True) -> Tuple[int, int]:
    """Mid-point of the widest column/row bands (od_coords.py:121-136)."""
    if fill:
        mask = ndimage.binary_fill_holes(mask)
    collapsedc = np.sum(mask, axis=0)
    indices = np.where(collapsedc == collapsedc.max())[0]
    c = indices[int(round((len(indices) - 1) / 2))]
    collapsedr = np.sum(mask, axis=1)
    indices = np.where(collapsedr == collapsedr.max())[0]
    r = indices[int(round((len(indices) - 1) / 2))]
    return int(c), int(r)


def _disk_overlap(r1: float, r2: float, d: float) -> float:
    """Fraction of the smaller disk's area covered by the larger
    (skimage.feature.blob._blob_overlap, 2D case): 0 when disjoint, 1 when
    nested, else the lens area over the smaller disk's area."""
    if d > r1 + r2:
        return 0.0
    if d <= abs(r1 - r2):
        return 1.0
    ratio1 = np.clip((d * d + r1 * r1 - r2 * r2) / (2.0 * d * r1), -1.0, 1.0)
    ratio2 = np.clip((d * d + r2 * r2 - r1 * r1) / (2.0 * d * r2), -1.0, 1.0)
    a, b = -d + r2 + r1, d - r2 + r1
    c, dd = d + r2 - r1, d + r2 + r1
    area = (
        r1 * r1 * np.arccos(ratio1)
        + r2 * r2 * np.arccos(ratio2)
        - 0.5 * np.sqrt(abs(a * b * c * dd))
    )
    return float(area / (np.pi * min(r1, r2) ** 2))


def _prune_blobs(blobs: np.ndarray, overlap: float) -> np.ndarray:
    """skimage _prune_blobs: for every overlapping pair (disk radius =
    sigma * sqrt(2) in 2D) with overlap fraction > `overlap`, zero out the
    smaller-sigma blob; keep the survivors."""
    blobs = np.array(blobs, dtype=np.float64)
    root2 = np.sqrt(2.0)
    for i in range(len(blobs)):
        for j in range(i + 1, len(blobs)):
            b1, b2 = blobs[i], blobs[j]
            r1, r2 = b1[2] * root2, b2[2] * root2
            if r1 <= 0 or r2 <= 0:
                continue
            d = float(np.hypot(b1[0] - b2[0], b1[1] - b2[1]))
            if _disk_overlap(r1, r2, d) > overlap:
                if b1[2] > b2[2]:
                    b2[2] = 0.0
                else:
                    b1[2] = 0.0
    return blobs[blobs[:, 2] > 0]


def blob_log(
    image: np.ndarray,
    min_sigma: float = 1.0,
    max_sigma: float = 50.0,
    num_sigma: int = 10,
    threshold: float = 0.2,
    overlap: float = 0.5,
) -> np.ndarray:
    """Laplacian-of-Gaussian blob detection (skimage.feature.blob_log
    semantics for the parameters od_coords.py uses): returns (N, 3) rows
    of (row, col, sigma) for scale-space maxima of sigma^2 * -LoG above
    `threshold`, with blobs overlapping a larger blob by more than
    `overlap` pruned (skimage default 0.5)."""
    image = np.asarray(image, dtype=np.float64)
    sigmas = np.linspace(min_sigma, max_sigma, num_sigma)
    cube = np.stack(
        [-(s**2) * ndimage.gaussian_laplace(image, s) for s in sigmas], axis=-1
    )
    maxed = ndimage.maximum_filter(cube, size=(3, 3, 3), mode="constant")
    peaks = np.argwhere((cube == maxed) & (cube > threshold))
    if peaks.size == 0:
        return np.empty((0, 3))
    order = np.argsort(cube[tuple(peaks.T)])[::-1]
    peaks = peaks[order]
    out = np.empty((len(peaks), 3))
    out[:, :2] = peaks[:, :2]
    out[:, 2] = sigmas[peaks[:, 2]]
    return _prune_blobs(out, overlap)


def _rgb2gray(image: np.ndarray) -> np.ndarray:
    """skimage.color.rgb2gray weights (ITU-R 601-2 luma)."""
    if image.ndim == 2:
        return np.asarray(image, dtype=np.float64)
    return np.asarray(image, dtype=np.float64) @ np.array([0.2125, 0.7154, 0.0721])


def get_peak_coordinates(image: np.ndarray, threshold: float = 0.2) -> np.ndarray:
    """Blob-based peak candidates with the reference's threshold back-off
    (od_coords.py:139-178): pad 15, LoG blobs in sigma [10, 50]; when fewer
    than 2 blobs are found the threshold decays by 0.8x until 0.001."""
    image_gray = _rgb2gray(image)
    image_gray = np.pad(image_gray, (15, 15), "constant")

    blobs = blob_log(image_gray, min_sigma=10, max_sigma=50, threshold=threshold)
    if blobs.shape[0] < 2:
        new_blobs = np.copy(blobs)
        while new_blobs.shape[0] < 2:
            threshold = 0.8 * threshold
            if threshold < 0.001:
                break
            new_blobs = blob_log(
                image_gray, min_sigma=10, max_sigma=50, threshold=threshold
            )
        blobs = new_blobs

    blobs = blobs - 15  # undo the padding offset
    blobs[blobs > 512] = 0
    blobs[blobs < 0] = 0
    if blobs.shape[0] < 2:
        # image-center fallback, appended after the unpad shift so it lands
        # at (256, 256) (the reference discarded this concatenate entirely)
        blobs = np.concatenate((blobs, [[256, 256, 0]]), axis=0)
    return blobs[:, :2].astype("int")
