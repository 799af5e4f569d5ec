"""RAM — Random Amplitude Mixup — as batched tensor ops (PyTorch port of
`ramdsir_tpu/ops/ram.py`).

Per sample and channel: take the image's 2-D spectrum, blend its amplitude
inside the centred low-frequency square of half-width b = floor(min(H, W) * L)
with a donor's amplitude at ratio r ~ U{0.1, ..., 1.0}, keep the phase, and
transform back.  The rfft2 half-spectrum carries the whole mix exactly (the
band is point-symmetric, both amplitudes are even), and the band needs no
fftshift: in unshifted coordinates it is rows [0..b] u [h-b..h-1] x cols
[0..b].

Every amplitude mix goes through K1 (`ops.ram_mix.mix_spectrum`): the
hand-written CUDA kernel on the card, its plain version on the CPU.

Layout: images and amplitudes are NHWC at every public function, as in the
JAX package; spectra are computed over NCHW planes inside.  Results are
NHWC views of NCHW memory, so `x.permute(0, 3, 1, 2)` gives the planes back
without a copy.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ramdsir_tpu_torch.ops import ram_mix


@functools.lru_cache(maxsize=32)
def low_freq_band_mask(h: int, w: int, L: float = 0.1, half: bool = False) -> np.ndarray:
    """Boolean (h, w) mask of the mixed band in unshifted fft coordinates
    (the centred square of half-width b, ifftshifted); half=True keeps the
    rfft2 columns (h, w//2+1)."""
    b = band_halfwidth(h, w, L)
    c_h, c_w = h // 2, w // 2
    m = np.zeros((h, w), dtype=bool)
    m[c_h - b : c_h + b + 1, c_w - b : c_w + b + 1] = True
    m = np.fft.ifftshift(m)
    if half:
        m = m[:, : w // 2 + 1]
    return m


def band_halfwidth(h: int, w: int, L: float = 0.1) -> int:
    """b = floor(min(h, w) * L)."""
    return int(np.floor(min(h, w) * L))


def _planes(x: torch.Tensor) -> torch.Tensor:
    """NHWC images -> float32 NCHW planes."""
    return x.permute(0, 3, 1, 2).float()


def amplitude_spectrum(img: torch.Tensor) -> torch.Tensor:
    """|rfft2| of an NHWC batch over the spatial axes: (B, H, W//2+1, C)."""
    return torch.fft.rfft2(_planes(img)).abs().permute(0, 2, 3, 1)


def banded_amplitude_spectrum(pool: torch.Tensor, L: float = 0.1, chunk: int = 64) -> torch.Tensor:
    """Donor amplitudes restricted to the band, computed once per run:
    (N, 2b+1, b+1, C) float32, rows [0..b] then rows [h-b..h-1].  Chunked so
    the transient spectrum stays about chunk*H*W*C*8 bytes."""
    n, h, w, _ = pool.shape
    b = band_halfwidth(h, w, L)
    outs = []
    for i in range(0, n, chunk):
        amp = torch.fft.rfft2(_planes(pool[i : i + chunk])).abs()
        outs.append(torch.cat([amp[:, :, : b + 1, : b + 1], amp[:, :, h - b :, : b + 1]], dim=2))
    return torch.cat(outs).permute(0, 2, 3, 1).contiguous()


def sample_ram_ratios(generator: torch.Generator, batch: int) -> torch.Tensor:
    """Per-sample mix ratio randint(1, 10)/10, drawn from `generator` on its
    device."""
    return torch.randint(1, 11, (batch,), generator=generator, device=generator.device).float() / 10.0


def ram_mixup(
    src: torch.Tensor, donor_amp: torch.Tensor, ratio: torch.Tensor, L: float = 0.1
) -> torch.Tensor:
    """Mix `src`'s low-frequency amplitude with `donor_amp` over the whole
    half-spectrum (K1 full mode).

    src (B, H, W, C) real images; donor_amp (B, H, W//2+1, C) from
    `amplitude_spectrum`; ratio (B,).  Returns (B, H, W, C) float32,
    unclipped.
    """
    _, h, w, _ = src.shape
    z = torch.fft.rfft2(_planes(src))
    zv = torch.view_as_real(z)
    ram_mix.mix_spectrum(
        zv[..., 0], zv[..., 1], donor_amp.permute(0, 3, 1, 2), ratio.float(),
        band_halfwidth(h, w, L), full=True,
    )
    return torch.fft.irfft2(z, s=(h, w)).permute(0, 2, 3, 1)


def ram_mixup_banded(
    src: torch.Tensor, donor_amp_band: torch.Tensor, ratio: torch.Tensor, L: float = 0.1
) -> torch.Tensor:
    """`ram_mixup` with precomputed banded donor amplitudes
    (`banded_amplitude_spectrum`): K1 in band mode touches only the band's
    two rectangles.  Out of the band the full mode computes z*(amp/amp) = z,
    so both give the same numbers."""
    _, h, w, _ = src.shape
    z = torch.fft.rfft2(_planes(src))
    zv = torch.view_as_real(z)
    ram_mix.mix_spectrum(
        zv[..., 0], zv[..., 1], donor_amp_band.permute(0, 3, 1, 2), ratio.float(),
        band_halfwidth(h, w, L), full=False,
    )
    return torch.fft.irfft2(z, s=(h, w)).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=16)
def _band_dft_operators(h: int, w: int, L: float = 0.1):
    """Restricted-DFT operators for the banded path as (re, im) float32
    numpy pairs, built in float64 and truncated once.

    Row order matches `banded_amplitude_spectrum`: [0..b] then [h-b..h-1];
    cols [0..b].  Analysis maps an (h, w) real image to its (2b+1, b+1)
    in-band rfft2 coefficients; synthesis is the inverse FFT restricted to
    the band, with the conjugate-symmetry column weights (2 for 0 < c <= b,
    1 for c == 0).
    """
    b = band_halfwidth(h, w, L)
    rows = np.concatenate([np.arange(b + 1), np.arange(h - b, h)])
    cols = np.arange(b + 1)
    ar = np.exp(-2j * np.pi * np.outer(rows, np.arange(h)) / h)  # (R, h)
    ac = np.exp(-2j * np.pi * np.outer(np.arange(w), cols) / w)  # (w, K)
    sr = np.exp(2j * np.pi * np.outer(np.arange(h), rows) / h)  # (h, R)
    wk = np.where(cols == 0, 1.0, 2.0) / (h * w)
    sc = wk[:, None] * np.exp(2j * np.pi * np.outer(cols, np.arange(w)) / w)  # (K, w)
    f32 = lambda z: (z.real.astype(np.float32), z.imag.astype(np.float32))
    return f32(ar), f32(ac), f32(sr), f32(sc)


@functools.lru_cache(maxsize=16)
def _band_dft_tensors(h: int, w: int, L: float, device: torch.device):
    return tuple(
        tuple(torch.from_numpy(m).to(device) for m in pair) for pair in _band_dft_operators(h, w, L)
    )


def ram_mixup_banded_dft(
    src: torch.Tensor, donor_amp_band: torch.Tensor, ratio: torch.Tensor, L: float = 0.1
) -> torch.Tensor:
    """`ram_mixup_banded` with the rfft2/irfft2 pair replaced by restricted
    DFT matrix products over the (2b+1) x (b+1) band:
    out = src + Re(S_r @ (Z' - Z) @ S_c), where Z is the band of rfft2(src)
    and Z' - Z comes from K1's delta output.  Out-of-band content passes
    through exactly; at ratio 1 the delta is exactly 0.  The products run in
    float32 through torch.matmul (TF32 off for matmuls, PyTorch's default).
    """
    _, h, w, _ = src.shape
    b = band_halfwidth(h, w, L)
    (arr, ari), (acr, aci), (srr, sri), (scr, sci) = _band_dft_tensors(h, w, L, src.device)
    x = _planes(src)
    # analysis: Z = A_r @ x @ A_c  (x real: the row pass is two real products)
    yr, yi = arr @ x, ari @ x  # (B, C, R, W)
    zr = yr @ acr - yi @ aci  # (B, C, R, K)
    zi = yr @ aci + yi @ acr
    dr, di = ram_mix.mix_spectrum(
        zr, zi, donor_amp_band.permute(0, 3, 1, 2), ratio.float(), b, full=False, delta=True
    )
    # synthesis: out = src + Re(S_r @ Delta @ S_c)
    tr = srr @ dr - sri @ di  # (B, C, H, K)
    ti = srr @ di + sri @ dr
    return (x + (tr @ scr - ti @ sci)).permute(0, 2, 3, 1)


def ram_augment_fundus_banded(
    img255: torch.Tensor,
    donor_amp_band: torch.Tensor,
    ratio: torch.Tensor,
    L: float = 0.1,
    use_dft: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fundus RAM with the donor FFT hoisted out of the step: [0,255] NHWC
    images in, (img, img_freq) normalised to [-1, 1] out."""
    mix = ram_mixup_banded_dft if use_dft else ram_mixup_banded
    freq = mix(img255, donor_amp_band, ratio, L).clamp(0.0, 255.0)
    return img255 / 127.5 - 1.0, freq / 127.5 - 1.0


def ram_augment_prostate_banded(
    img: torch.Tensor,
    donor_amp_band: torch.Tensor,
    ratio: torch.Tensor,
    L: float = 0.1,
    use_dft: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prostate RAM with banded donor amplitudes: inputs in [-1, 1], the
    mixed image clipped back to [-1, 1]."""
    mix = ram_mixup_banded_dft if use_dft else ram_mixup_banded
    freq = mix(img, donor_amp_band, ratio, L)
    return img.float(), freq.clamp(-1.0, 1.0)


def ram_augment_fundus(
    img255: torch.Tensor, donor255: torch.Tensor, ratio: torch.Tensor, L: float = 0.1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fundus RAM from same-size [0,255] donor images (their spectra taken
    here): (img, img_freq) normalised to [-1, 1]."""
    freq = ram_mixup(img255, amplitude_spectrum(donor255), ratio, L).clamp(0.0, 255.0)
    return img255 / 127.5 - 1.0, freq / 127.5 - 1.0


def ram_augment_prostate(
    img: torch.Tensor, donor: torch.Tensor, ratio: torch.Tensor, L: float = 0.1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prostate RAM from donor images: inputs in [-1, 1], no
    renormalisation, the mixed image clipped to [-1, 1]."""
    freq = ram_mixup(img, amplitude_spectrum(donor), ratio, L)
    return img.float(), freq.clamp(-1.0, 1.0)
