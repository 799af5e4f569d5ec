"""Host post-processing of predictions (port of
`ramdsir_tpu/ops/postprocess.py`).

  get_largest_fillhole          largest 8-connected component, holes filled
  connectivity_region_analysis  largest connectivity-1 component of a volume
  postprocessing                the reference's dataset branches

Each runs in the host library (`ramdsir_tpu_torch.native`).  The `*_plain`
functions are the same with scipy: the plain versions that the tests and the
smoke run hold the library to.

Deliberate divergence kept from the JAX package (PARITY.md): for an all-zero
mask the reference's `_connectivity_region_analysis` returns all ones; this
returns all zeros.
"""
from __future__ import annotations

import numpy as np

from ramdsir_tpu_torch import native


def get_largest_fillhole(binary: np.ndarray) -> np.ndarray:
    """Largest 8-connected component of a 2-D mask, holes filled (int64 0/1)."""
    return native.largest_cc_fillhole(np.asarray(binary).astype(bool))


def get_largest_fillhole_plain(binary: np.ndarray) -> np.ndarray:
    """`get_largest_fillhole` with scipy."""
    from scipy import ndimage

    binary = np.asarray(binary).astype(bool)
    if not binary.any():
        return np.zeros(binary.shape, np.int64)
    labels, n = ndimage.label(binary, structure=ndimage.generate_binary_structure(binary.ndim, binary.ndim))
    sizes = ndimage.sum(binary, labels, range(1, n + 1))
    kept = labels == int(np.argmax(sizes)) + 1
    return ndimage.binary_fill_holes(kept).astype(np.int64)


def _region_dtype(mask: np.ndarray):
    return np.int64 if mask.dtype.kind in "fiu" else mask.dtype


def connectivity_region_analysis(mask: np.ndarray) -> np.ndarray:
    """Largest connectivity-1 component of a volume; an empty mask gives
    all zeros (the deliberate divergence above)."""
    mask = np.asarray(mask)
    return native.largest_cc_nd(mask != 0).astype(_region_dtype(mask))


def connectivity_region_analysis_plain(mask: np.ndarray) -> np.ndarray:
    """`connectivity_region_analysis` with scipy."""
    from scipy import ndimage

    mask = np.asarray(mask)
    binary = mask != 0
    labels, n = ndimage.label(binary)
    sizes = ndimage.sum(binary, labels, range(n + 1))
    winner = int(np.argmax(sizes))
    out = (labels == winner) if winner else np.zeros(mask.shape, bool)
    return out.astype(_region_dtype(mask))


def postprocessing(
    prediction: np.ndarray, threshold: float = 0.5, dataset: str = "G", largest=get_largest_fillhole
) -> np.ndarray:
    """Dataset-dependent cleanup of one prediction.

    prediction: (2, H, W) cup/disc probabilities for the fundus branches, or
    an integer (H, W) mask for 'prostate'.  `largest` is
    `get_largest_fillhole` or its plain version.
    """
    prediction = np.asarray(prediction)
    if dataset == "prostate":
        return largest(np.copy(prediction).astype(np.uint8)).astype(np.uint8)
    if dataset and dataset[0] == "D":
        out = np.copy(prediction)
        disc = (prediction[1] > 0.5).astype(np.uint8)
        cup = (prediction[0] > 0.1).astype(np.uint8)
        out[0] = largest(cup).astype(np.uint8)
        out[1] = largest(disc).astype(np.uint8)
        return out
    out = (np.copy(prediction) > threshold).astype(np.uint8)
    out[0] = largest(out[0]).astype(np.uint8)
    out[1] = largest(out[1]).astype(np.uint8)
    return out
