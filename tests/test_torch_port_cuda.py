"""K1 on the card against its plain version (marker `cuda`; skipped without
a card).

These tests import neither JAX nor the JAX package, so they also run where
JAX is not installed; the root conftest.py imports JAX, so run them there
with `python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py`.
"""
import pytest
import torch

from ramdsir_tpu_torch.ops import ram as tram
from ramdsir_tpu_torch.ops import ram_mix

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is a CUDA kernel with no CPU build")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, n, h, w):
    x = torch.rand((n, 3, h, w), generator=gen, device="cuda") * 255.0
    donor = torch.rand((n, h, w, 3), generator=gen, device="cuda") * 255.0
    ratio = torch.randint(1, 11, (n,), generator=gen, device="cuda").float() / 10.0
    return torch.fft.rfft2(x), donor, ratio


def _mix(fn, z, amp, ratio, band, full, delta):
    z = z.clone()
    if delta:
        re, im = z.real.contiguous(), z.imag.contiguous()
    else:
        zv = torch.view_as_real(z)
        re, im = zv[..., 0], zv[..., 1]
    out = fn(re, im, amp, ratio, band, full=full, delta=delta)
    return torch.stack(out)


@pytest.mark.parametrize("h,w", [(64, 64), (65, 63), (256, 256)])
@pytest.mark.parametrize("mode", ["full", "band", "delta"])
def test_kernel_matches_plain(gen, h, w, mode):
    z, donor, ratio = _inputs(gen, 4, h, w)
    b = tram.band_halfwidth(h, w)
    if mode == "full":
        amp = tram.amplitude_spectrum(donor).permute(0, 3, 1, 2)
    else:
        amp = tram.banded_amplitude_spectrum(donor).permute(0, 3, 1, 2)
    if mode == "delta":
        rows = torch.cat([torch.arange(b + 1), torch.arange(h - b, h)]).cuda()
        z = z[:, :, rows, : b + 1]
    args = (z, amp, ratio, b, mode == "full", mode == "delta")
    before = ram_mix.launches
    got = _mix(ram_mix.mix_spectrum, *args)
    want = _mix(ram_mix.mix_spectrum_plain, *args)
    torch.cuda.synchronize()
    assert ram_mix.launches == before + 1
    # the same IEEE operations in the same order: equal to a rounding of the largest value
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_ram_functions_run_through_the_kernel(gen):
    z, donor, ratio = _inputs(gen, 2, 64, 64)
    src = torch.fft.irfft2(z, s=(64, 64)).permute(0, 2, 3, 1)
    before = ram_mix.launches
    outs = [
        tram.ram_mixup(src, tram.amplitude_spectrum(donor), ratio),
        tram.ram_mixup_banded(src, tram.banded_amplitude_spectrum(donor), ratio),
        tram.ram_mixup_banded_dft(src, tram.banded_amplitude_spectrum(donor), ratio),
    ]
    torch.cuda.synchronize()
    assert ram_mix.launches == before + 3
    for out in outs[1:]:
        assert float((out - outs[0]).abs().max()) < 1e-2  # O(255) images, float32 FFT vs DFT rounding


def test_wrapper_refuses_what_the_kernel_cannot_take(gen):
    z, donor, ratio = _inputs(gen, 2, 32, 32)
    zv = torch.view_as_real(z)
    amp = tram.amplitude_spectrum(donor).permute(0, 3, 1, 2)
    with pytest.raises(ValueError):
        ram_mix.mix_spectrum(zv[..., 0], zv[..., 1], amp.cpu(), ratio, 3, full=True)
    with pytest.raises(TypeError):
        ram_mix.mix_spectrum(zv[..., 0], zv[..., 1], amp.double(), ratio, 3, full=True)
    with pytest.raises(ValueError):
        ram_mix.mix_spectrum(zv[..., 0], zv[..., 1], amp[:, :, :5], ratio, 3, full=True)
