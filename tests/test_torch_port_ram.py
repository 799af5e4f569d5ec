"""The port's RAM and K1's plain version against the JAX package on the CPU.

K1's plain version (`ramdsir_tpu_torch.ops.ram_mix.mix_spectrum` on CPU
tensors) is held against the Pallas kernel run as the JAX tests run it
(`mix_spectrum_pallas`, interpret mode off the TPU) and against the XLA
twins `_mix_spectrum` / `_mix_block` / the delta form of
`ram_mixup_banded_dft`; the port's RAM functions against their JAX
counterparts given the same ratios, and against the float64 oracle of
tests/test_ram.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ramdsir_tpu.ops import ram as jram
from ramdsir_tpu.ops.ram_pallas import mix_spectrum_pallas
from ramdsir_tpu_torch.ops import ram as tram
from ramdsir_tpu_torch.ops import ram_mix
from tests.test_ram import oracle_ram
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

SHAPES = [(64, 64), (65, 63), (32, 48)]
TINY = float(np.finfo(np.float32).tiny)


def _images(seed, n, h, w, lo=0.0, hi=255.0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(lo, hi, (n, h, w, 3)).astype(np.float32)
    donor = rng.uniform(lo, hi, (n, h, w, 3)).astype(np.float32)
    ratio = (rng.integers(1, 11, n) / 10.0).astype(np.float32)
    return src, donor, ratio


def _spectrum(src):
    """rfft2 of NHWC images as complex64 NHWC, and the port's (re, im) planes."""
    z = np.fft.rfft2(src, axes=(1, 2)).astype(np.complex64)
    planes = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    return z, planes(z.real), planes(z.imag)


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def _spectral_tol(z):
    """Two float32 evaluations of the mix differ by a rounding or two of the
    largest spectral values (|z| up to ~255*H*W): the XLA twins take |z| as a
    hypot and may contract r*a + (1-r)*b into an FMA, the kernel does not."""
    return dict(rtol=1e-5, atol=1e-6 * float(np.abs(z).max()))


@pytest.mark.parametrize("h,w", SHAPES)
def test_full_mode_matches_pallas_and_xla(h, w):
    src, donor, ratio = _images(0, 2, h, w)
    z, re, im = _spectrum(src)
    amp_t = np.abs(np.fft.rfft2(donor, axes=(1, 2))).astype(np.float32)
    band = jram.band_halfwidth(h, w)
    ram_mix.mix_spectrum(
        re, im, torch.from_numpy(amp_t.transpose(0, 3, 1, 2)), torch.from_numpy(ratio), band, full=True
    )
    got = _nhwc(re) + 1j * _nhwc(im)

    mask = jnp.asarray(jram.low_freq_band_mask(h, w, half=True))
    pallas = np.asarray(mix_spectrum_pallas(jnp.asarray(z), jnp.asarray(amp_t), jnp.asarray(ratio), mask))
    xla = np.asarray(jram._mix_spectrum(jnp.asarray(z), jnp.asarray(amp_t), jnp.asarray(ratio), mask[None, :, :, None]))
    np.testing.assert_allclose(got, pallas, **_spectral_tol(z))
    np.testing.assert_allclose(got, xla, **_spectral_tol(z))


@pytest.mark.parametrize("h,w", SHAPES)
def test_band_mode_matches_mix_block(h, w):
    src, donor, ratio = _images(1, 3, h, w)
    z, re, im = _spectrum(src)
    damp = np.array(jram.banded_amplitude_spectrum(jnp.asarray(donor)))
    b = jram.band_halfwidth(h, w)
    ram_mix.mix_spectrum(
        re, im, torch.from_numpy(damp.transpose(0, 3, 1, 2)), torch.from_numpy(ratio), b, full=False
    )
    got = _nhwc(re) + 1j * _nhwc(im)

    r = jnp.asarray(ratio).reshape(-1, 1, 1, 1)
    fz = jnp.asarray(z)
    top = jram._mix_block(fz[:, : b + 1, : b + 1], jnp.asarray(damp[:, : b + 1]), r)
    bot = jram._mix_block(fz[:, h - b :, : b + 1], jnp.asarray(damp[:, b + 1 :]), r)
    want = np.asarray(fz.at[:, : b + 1, : b + 1].set(top).at[:, h - b :, : b + 1].set(bot))
    np.testing.assert_allclose(got, want, **_spectral_tol(z))
    # out of the band the spectrum is untouched, bit for bit
    out_rows = np.r_[b + 1 : h - b]
    np.testing.assert_array_equal(got[:, out_rows], z[:, out_rows])
    np.testing.assert_array_equal(got[:, :, b + 1 :], z[:, :, b + 1 :])


@pytest.mark.parametrize("h,w", SHAPES)
def test_delta_output_matches_dft_formula(h, w):
    """Delta mode on a compact band block against the formula of the JAX
    package's ram.py:241-248, transcribed in jnp."""
    src, donor, ratio = _images(2, 3, h, w)
    b = jram.band_halfwidth(h, w)
    z = np.fft.rfft2(src, axes=(1, 2)).astype(np.complex64)
    blk = np.concatenate([z[:, : b + 1, : b + 1], z[:, h - b :, : b + 1]], axis=1)  # (N, 2b+1, b+1, C)
    damp = np.array(jram.banded_amplitude_spectrum(jnp.asarray(donor)))
    planes = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    zr, zi = planes(blk.real), planes(blk.imag)
    dr, di = ram_mix.mix_spectrum(zr, zi, planes(damp), torch.from_numpy(ratio), b, full=False, delta=True)

    jzr, jzi = jnp.asarray(blk.real), jnp.asarray(blk.imag)
    r = jnp.asarray(ratio).reshape(-1, 1, 1, 1)
    amp = jnp.sqrt(jzr * jzr + jzi * jzi)
    new_amp = r * amp + (1.0 - r) * jnp.asarray(damp)
    scale = new_amp / jnp.maximum(amp, TINY) - 1.0
    zero = amp == 0.0
    want_r = np.asarray(jnp.where(zero, new_amp, jzr * scale))
    want_i = np.asarray(jnp.where(zero, 0.0, jzi * scale))
    tol = _spectral_tol(blk)
    np.testing.assert_allclose(_nhwc(dr), want_r, **tol)
    np.testing.assert_allclose(_nhwc(di), want_i, **tol)
    # the inputs are left alone
    np.testing.assert_array_equal(_nhwc(zr), blk.real)


@pytest.mark.parametrize("full", [True, False])
def test_zero_amplitude_takes_new_amplitude(full):
    """Where |z| == 0 the mixed value is (new_amp, 0), as numpy's
    angle(0) == 0 gives the reference; Pallas and XLA agree."""
    h = w = 32
    src, donor, ratio = _images(3, 2, h, w)
    z = np.fft.rfft2(src, axes=(1, 2)).astype(np.complex64)
    z[:, 0, 0, :] = 0.0  # DC, in the band
    z[:, 1, 2, 1] = 0.0  # in the band
    z[:, 10, 5, 2] = 0.0  # out of the band: stays (0, 0)
    amp_t = np.abs(np.fft.rfft2(donor, axes=(1, 2))).astype(np.float32)
    b = jram.band_halfwidth(h, w)
    planes = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    re, im = planes(z.real), planes(z.imag)
    if full:
        ram_mix.mix_spectrum(re, im, planes(amp_t), torch.from_numpy(ratio), b, full=True)
    else:
        band = np.concatenate([amp_t[:, : b + 1, : b + 1], amp_t[:, h - b :, : b + 1]], axis=1)
        ram_mix.mix_spectrum(re, im, planes(band), torch.from_numpy(ratio), b, full=False)
    got = _nhwc(re) + 1j * _nhwc(im)
    r = ratio[:, None]
    np.testing.assert_array_equal(got[:, 0, 0, :].imag, 0.0)
    np.testing.assert_allclose(got[:, 0, 0, :].real, (1.0 - r) * amp_t[:, 0, 0, :], rtol=1e-6)
    np.testing.assert_allclose(got[:, 1, 2, 1].real, (1.0 - ratio) * amp_t[:, 1, 2, 1], rtol=1e-6)
    np.testing.assert_array_equal(got[:, 10, 5, 2], 0.0)
    mask = jnp.asarray(jram.low_freq_band_mask(h, w, half=True))
    pallas = np.asarray(mix_spectrum_pallas(jnp.asarray(z), jnp.asarray(amp_t), jnp.asarray(ratio), mask))
    np.testing.assert_allclose(got, pallas, **_spectral_tol(z))


@pytest.mark.parametrize("full", [True, False])
def test_ratio_one_is_identity(full):
    """At ratio 1 the new amplitude is |z| exactly, so z*(|z|/|z|) == z bit
    for bit, and the delta is exactly 0."""
    h, w = 65, 63
    src, donor, _ = _images(4, 2, h, w)
    ratio = torch.ones(2)
    z, re, im = _spectrum(src)
    b = jram.band_halfwidth(h, w)
    amp_t = np.abs(np.fft.rfft2(donor, axes=(1, 2))).astype(np.float32)
    planes = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    if full:
        ram_mix.mix_spectrum(re, im, planes(amp_t), ratio, b, full=True)
    else:
        band = np.concatenate([amp_t[:, : b + 1, : b + 1], amp_t[:, h - b :, : b + 1]], axis=1)
        dr, di = ram_mix.mix_spectrum(re, im, planes(band), ratio, b, full=False, delta=True)
        assert not dr.any() and not di.any()
        ram_mix.mix_spectrum(re, im, planes(band), ratio, b, full=False)
    np.testing.assert_array_equal(_nhwc(re), z.real)
    np.testing.assert_array_equal(_nhwc(im), z.imag)


def test_in_place_on_complex_view():
    """The NHWC complex spectrum's view_as_real planes (stride 2, im at
    offset 1) take the mix in place, as the FFT paths use it."""
    h = w = 32
    src, donor, ratio = _images(5, 2, h, w)
    zc = torch.fft.rfft2(torch.from_numpy(src).permute(0, 3, 1, 2))
    before = zc.clone()
    zv = torch.view_as_real(zc)
    amp_t = torch.from_numpy(np.abs(np.fft.rfft2(donor, axes=(1, 2))).astype(np.float32)).permute(0, 3, 1, 2)
    b = jram.band_halfwidth(h, w)
    ram_mix.mix_spectrum(zv[..., 0], zv[..., 1], amp_t, torch.from_numpy(ratio), b, full=True)
    re, im = before.real.contiguous(), before.imag.contiguous()
    ram_mix.mix_spectrum_plain(re, im, amp_t.contiguous(), torch.from_numpy(ratio), b, full=True)
    np.testing.assert_array_equal(zc.real.numpy(), re.numpy())
    np.testing.assert_array_equal(zc.imag.numpy(), im.numpy())


def test_mix_rejects_other_devices_and_modes():
    x = torch.zeros(1, 3, 8, 5)
    with pytest.raises(ValueError):
        ram_mix.mix_spectrum(x, x, x, torch.ones(1), 0, full=True, delta=True)
    meta = torch.zeros(1, 3, 8, 5, device="meta")
    with pytest.raises(ValueError):
        ram_mix.mix_spectrum(meta, meta, meta, torch.ones(1, device="meta"), 0, full=True)


# --- the RAM functions -----------------------------------------------------

# O(255) images through two different float32 FFTs (torch.fft, jnp.fft) or
# matrix products: measured up to 2e-4 apart at 256^2
IMG_TOL = dict(atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("h,w", SHAPES)
def test_ram_mixup_matches_jax_and_oracle(h, w):
    src, donor, ratio = _images(6, 2, h, w)
    got = tram.ram_mixup(
        torch.from_numpy(src), tram.amplitude_spectrum(torch.from_numpy(donor)), torch.from_numpy(ratio)
    ).numpy()
    want = np.asarray(
        jram.ram_mixup(jnp.asarray(src), jram.amplitude_spectrum(jnp.asarray(donor)), jnp.asarray(ratio))
    )
    np.testing.assert_allclose(got, want, **IMG_TOL)
    for i in range(2):
        # same bound as tests/test_ram.py: float32 rfft against a float64 fft
        np.testing.assert_allclose(got[i], oracle_ram(src[i], donor[i], ratio[i]), atol=2e-2, rtol=1e-5)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("dft", [False, True])
def test_banded_mixups_match_jax_and_oracle(h, w, dft):
    src, donor, ratio = _images(7, 3, h, w)
    damp = tram.banded_amplitude_spectrum(torch.from_numpy(donor))
    fn_t = tram.ram_mixup_banded_dft if dft else tram.ram_mixup_banded
    fn_j = jram.ram_mixup_banded_dft if dft else jram.ram_mixup_banded
    got = fn_t(torch.from_numpy(src), damp, torch.from_numpy(ratio)).numpy()
    want = np.asarray(fn_j(jnp.asarray(src), jnp.asarray(damp.numpy()), jnp.asarray(ratio)))
    np.testing.assert_allclose(got, want, **IMG_TOL)
    for i in range(3):
        np.testing.assert_allclose(got[i], oracle_ram(src[i], donor[i], ratio[i]), atol=2e-2, rtol=1e-5)
    if dft:
        # out-of-band content passes through: ratio 1 returns src exactly
        one = fn_t(torch.from_numpy(src), damp, torch.ones(3)).numpy()
        np.testing.assert_array_equal(one, src)


def test_spectra_and_mask_match_jax():
    rng = np.random.default_rng(8)
    pool = rng.uniform(0, 255, (7, 32, 48, 3)).astype(np.float32)
    got = tram.banded_amplitude_spectrum(torch.from_numpy(pool), chunk=3).numpy()
    want = np.asarray(jram.banded_amplitude_spectrum(jnp.asarray(pool), chunk=3))
    assert got.shape == want.shape == (7, 2 * jram.band_halfwidth(32, 48) + 1, jram.band_halfwidth(32, 48) + 1, 3)
    # |FFT| values up to ~255*H*W: float32 FFT rounding
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * float(np.abs(want).max()))
    amp = tram.amplitude_spectrum(torch.from_numpy(pool)).numpy()
    np.testing.assert_allclose(
        amp, np.asarray(jram.amplitude_spectrum(jnp.asarray(pool))), rtol=1e-5, atol=1e-6 * float(amp.max())
    )
    for h, w in [(64, 64), (65, 63), (10, 20)]:
        for half in (False, True):
            np.testing.assert_array_equal(tram.low_freq_band_mask(h, w, half=half), jram.low_freq_band_mask(h, w, half=half))
        for i, op in enumerate(tram._band_dft_operators(h, w)):
            np.testing.assert_array_equal(op[0], jram._band_dft_operators(h, w)[i][0])
            np.testing.assert_array_equal(op[1], jram._band_dft_operators(h, w)[i][1])


def test_ratio_draws():
    g = torch.Generator().manual_seed(0)
    r = tram.sample_ram_ratios(g, 10000).numpy()
    assert set(np.round(np.unique(r) * 10).astype(int)) <= set(range(1, 11))
    assert abs(r.mean() - 0.55) < 0.02  # E[randint(1,10)/10] = 0.55


@pytest.mark.parametrize("dft", [False, True])
def test_wrappers_match_jax_given_the_same_ratios(dft):
    import jax

    key = jax.random.PRNGKey(6)
    rng = np.random.default_rng(13)
    src = rng.uniform(0, 255, (4, 48, 48, 3)).astype(np.float32)
    donor = rng.uniform(0, 255, (4, 48, 48, 3)).astype(np.float32)
    ratio = torch.from_numpy(np.asarray(jram.sample_ram_ratios(key, 4)))
    damp = jram.banded_amplitude_spectrum(jnp.asarray(donor))
    pairs = [
        (
            tram.ram_augment_fundus_banded(torch.from_numpy(src), torch.from_numpy(np.asarray(damp)), ratio, use_dft=dft),
            jram.ram_augment_fundus_banded(jnp.asarray(src), damp, key, use_dft=dft),
        ),
        (
            tram.ram_augment_fundus(torch.from_numpy(src), torch.from_numpy(donor), ratio),
            jram.ram_augment_fundus(jnp.asarray(src), jnp.asarray(donor), key),
        ),
    ]
    srcp, donorp = src / 127.5 - 1.0, donor / 127.5 - 1.0
    dampp = jram.banded_amplitude_spectrum(jnp.asarray(donorp))
    pairs += [
        (
            tram.ram_augment_prostate_banded(torch.from_numpy(srcp), torch.from_numpy(np.asarray(dampp)), ratio, use_dft=dft),
            jram.ram_augment_prostate_banded(jnp.asarray(srcp), dampp, key, use_dft=dft),
        ),
        (
            tram.ram_augment_prostate(torch.from_numpy(srcp), torch.from_numpy(donorp), ratio),
            jram.ram_augment_prostate(jnp.asarray(srcp), jnp.asarray(donorp), key),
        ),
    ]
    for (img_t, freq_t), (img_j, freq_j) in pairs:
        np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))
        # outputs in [-1, 1]: the IMG_TOL bound scaled by 1/127.5
        np.testing.assert_allclose(freq_t.numpy(), np.asarray(freq_j), atol=1e-5, rtol=1e-5)
