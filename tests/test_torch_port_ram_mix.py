"""K1's layout dispatch, its write-skip invariant and its byte count, on the CPU.

The kernel (`ramdsir_tpu_torch/csrc/ram_mix.cu`) stores nothing in full mode
out of the band where 0 < amp_s < inf: there the mix is z*(amp/amp) = z.
These tests hold the plain version, and the JAX package's Pallas kernel
(interpret mode) and XLA twin, to that invariant, so the kernel's skipped
stores give the plain version's numbers.  They also check `_layout` and
`_path`, which pick the kernel's code path from the tensors' strides and
alignment, and `chip_smoke.k1_min_bytes`, the byte count behind K1's bound.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from ramdsir_tpu.ops import ram as jram
from ramdsir_tpu.ops.ram_pallas import mix_spectrum_pallas
from ramdsir_tpu_torch.ops import ram_mix

NORMAL, TINY, ZERO, SUBNORMAL_SQUARE = range(4)


def _corner_spectrum(seed, n, h, wh, c=3):
    """A (n, h, wh, c) complex64 spectrum whose elements fall in four kinds:
    components in [1e-18, 1e6] (normal squares), in [1e-30, 2^-76] (squares
    that underflow to 0), signed zeros, and in [2^-74, 2^-64] (subnormal
    squares).  Returns the spectrum and each element's kind."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 4, (n, h, wh, c))
    lo = np.choose(kind, [1e-18, 1e-30, 0.0, 2.0**-74])
    hi = np.choose(kind, [1e6, 2.0**-76, 0.0, 2.0**-64])

    def part():
        mag = np.exp(rng.uniform(np.log(np.maximum(lo, 1e-300)), np.log(np.maximum(hi, 1e-300))))
        mag = np.where(kind == ZERO, 0.0, mag)
        return (rng.choice([-1.0, 1.0], kind.shape) * mag).astype(np.float32)

    return (part() + 1j * part()).astype(np.complex64), kind


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _planes(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("seed,h,w", [(0, 32, 32), (1, 33, 31), (2, 48, 40)])
def test_full_mode_write_skip_invariant(seed, h, w):
    """Out of the band the mix maps z to itself bit for bit wherever
    0 < amp_s < inf, and to (+0, +0) where amp_s == 0 (zeros, and
    components below 2^-75 whose squares underflow): the plain version (in
    place on the complex spectrum, as `ram_mixup` calls it) and the Pallas
    kernel agree bit for bit.  The XLA twin `_mix_spectrum` takes |z| as a
    hypot, which does not underflow, and keeps the tiny values: the port
    follows the TPU kernel there, within 2^-75 of the twin."""
    wh = w // 2 + 1
    z, kind = _corner_spectrum(seed, 2, h, wh)
    rng = np.random.default_rng(seed + 100)
    amp_t = rng.uniform(0, 1e4, z.shape).astype(np.float32)
    ratio = np.array([0.3, 0.8], np.float32)
    b = jram.band_halfwidth(h, w)
    out_band = ~jram.low_freq_band_mask(h, w, half=True)[None, :, :, None] & np.ones(z.shape, bool)

    zc = torch.from_numpy(z).permute(0, 3, 1, 2).contiguous()
    zv = torch.view_as_real(zc)
    ram_mix.mix_spectrum(zv[..., 0], zv[..., 1], _planes(amp_t), torch.from_numpy(ratio), b, full=True)
    got = zc.permute(0, 2, 3, 1).numpy()

    re, im = z.real, z.imag
    ss = re * re + im * im  # numpy float32, no flush of subnormals, as the kernel
    identity = out_band & (ss > 0) & np.isfinite(ss)
    zero = out_band & (ss == 0)
    assert identity.any() and zero.any() and (zero & (kind == TINY)).any()
    np.testing.assert_array_equal(_bits(got.real)[identity], _bits(re)[identity])
    np.testing.assert_array_equal(_bits(got.imag)[identity], _bits(im)[identity])
    np.testing.assert_array_equal(_bits(got.real)[zero], 0)
    np.testing.assert_array_equal(_bits(got.imag)[zero], 0)
    # the subnormal squares are kept: 0 < amp_s
    assert (identity & (kind == SUBNORMAL_SQUARE)).sum() == (out_band & (kind == SUBNORMAL_SQUARE)).sum()

    mask = jnp.asarray(jram.low_freq_band_mask(h, w, half=True))
    pallas = np.asarray(mix_spectrum_pallas(jnp.asarray(z), jnp.asarray(amp_t), jnp.asarray(ratio), mask))
    # XLA on the CPU flushes subnormals, as the TPU does: leave those out
    same = out_band & (kind != SUBNORMAL_SQUARE)
    np.testing.assert_array_equal(_bits(pallas.real)[same], _bits(got.real)[same])
    np.testing.assert_array_equal(_bits(pallas.imag)[same], _bits(got.imag)[same])

    xla = np.asarray(jram._mix_spectrum(jnp.asarray(z), jnp.asarray(amp_t), jnp.asarray(ratio), mask[None, :, :, None]))
    normal = out_band & (kind == NORMAL)
    np.testing.assert_array_equal(_bits(xla.real)[normal], _bits(got.real)[normal])
    np.testing.assert_array_equal(_bits(xla.imag)[normal], _bits(got.imag)[normal])
    tiny = out_band & (kind == TINY)
    np.testing.assert_array_equal(xla[tiny], z[tiny])
    assert np.abs(xla[tiny] - got[tiny]).max() < 2.0**-75 * np.sqrt(2)


def _complex(shape, offset=0):
    """A contiguous complex64 tensor `offset` elements into its storage."""
    buf = torch.zeros(int(np.prod(shape)) + offset, dtype=torch.complex64)
    return buf[offset:].view(shape)


def _floats(shape, offset=0):
    buf = torch.zeros(int(np.prod(shape)) + offset)
    return buf[offset:].view(shape)


def _split(z):
    zv = torch.view_as_real(z)
    return zv[..., 0], zv[..., 1]


LAYOUTS = {
    "view_as_real": (lambda: _split(_complex((2, 3, 16, 9))), "interleaved"),
    "view_as_real_single_plane": (lambda: _split(_complex((1, 1, 16, 9))), "interleaved"),
    "view_as_real_one_off": (lambda: _split(_complex((2, 3, 16, 9), offset=1)), "strided"),
    "view_as_real_two_off": (lambda: _split(_complex((2, 3, 16, 9), offset=2)), "interleaved"),
    "view_as_real_nhwc": (lambda: _split(_complex((2, 16, 9, 3)).permute(0, 3, 1, 2)), "strided"),
    "view_as_real_band_rows": (lambda: _split(_complex((2, 3, 16, 9))[:, :, :5, :4]), "strided"),
    "separate_blocks": (lambda: (_floats((2, 3, 11, 6)), _floats((2, 3, 11, 6))), "planar"),
    "separate_blocks_one_off": (lambda: (_floats((2, 3, 11, 6), 1), _floats((2, 3, 11, 6))), "planar"),
    "separate_blocks_sliced": (lambda: (_floats((2, 3, 11, 8))[..., :6], _floats((2, 3, 11, 8))[..., :6]), "strided"),
    "real_imag_views": (lambda: (lambda z: (z.real, z.imag))(_complex((2, 3, 11, 6))), "interleaved"),
    "real_imag_of_two": (lambda: (_complex((2, 3, 11, 6)).real, _complex((2, 3, 11, 6)).imag), "strided"),
    "transposed_blocks": (lambda: (_floats((2, 3, 6, 11)).transpose(2, 3), _floats((2, 3, 6, 11)).transpose(2, 3)), "strided"),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout(name):
    make, want = LAYOUTS[name]
    re, im = make()
    assert ram_mix._layout(re, im) == want


@pytest.mark.parametrize(
    "layout,full,delta,compact,want",
    [
        ("interleaved", True, False, True, "full_vec"),
        ("planar", True, False, True, "strided"),
        ("strided", True, False, True, "strided"),
        ("interleaved", False, False, False, "strided"),
        ("planar", False, False, False, "strided"),
        ("planar", False, True, True, "delta_flat"),
        ("planar", False, True, False, "strided"),
        ("interleaved", False, True, True, "strided"),
        ("strided", False, True, True, "strided"),
    ],
)
def test_path(layout, full, delta, compact, want):
    assert ram_mix._path(layout, full, delta, compact) == want
    assert want in ram_mix.PATHS


@pytest.mark.parametrize(
    "shape,band,mode,want",
    [
        # 8 B x 1,585,152 read + 12 B x 63,648 in the band + 4 B x 16 ratios
        ((16, 3, 256, 129), 25, "full", 13_445_056),
        ((16, 3, 256, 129), 25, "band", 1_273_024),
        ((16, 3, 256, 129), 25, "delta", 1_273_024),
        # 8 x 40 + 12 x (3 x 2) + 4
        ((1, 1, 8, 5), 1, "full", 396),
        ((1, 1, 8, 5), 1, "delta", 124),
    ],
)
def test_k1_min_bytes(shape, band, mode, want):
    assert chip_smoke.k1_min_bytes(*shape, band, mode) == want
