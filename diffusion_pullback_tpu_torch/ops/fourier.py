"""Fourier noise shaping (counterpart of diffusion_pullback_tpu/ops/fourier.py):
reshape a perturbation's spectrum toward the source image's envelope,
|F(shaped)| = |F(perturbed)|^p · |F(src)|^q with the source's phase,
optionally variance-matching the magnitude field. Arrays are (H, W, C),
channel-last as the JAX package takes them; the FFT runs over the two
leading axes for every channel at once."""

from __future__ import annotations

import torch


def _fft2(x):
    """Orthonormal, center-shifted 2-D FFT over the leading two axes."""
    return torch.fft.ifftshift(
        torch.fft.fft2(torch.fft.fftshift(x, dim=(0, 1)), dim=(0, 1), norm="ortho"),
        dim=(0, 1))


def _ifft2(x):
    return torch.fft.ifftshift(
        torch.fft.ifft2(torch.fft.fftshift(x, dim=(0, 1)), dim=(0, 1), norm="ortho"),
        dim=(0, 1))


def fourier_regularization(src: torch.Tensor, perturbed_src: torch.Tensor,
                           noise_p: float, noise_q: float,
                           fft_smoothing: bool = False, eps: float = 1e-12
                           ) -> torch.Tensor:
    """Shape ``perturbed_src``'s spectrum with ``src``'s envelope and
    phase; ``fft_smoothing`` rescales the shaped magnitudes' deviation from
    their mean to the source's spread (population std)."""
    src_fft = _fft2(src)
    src_dist = src_fft.abs()
    src_phase = src_fft / torch.clamp(src_dist, min=eps)

    shaped_dist = _fft2(perturbed_src).abs() ** noise_p * src_dist ** noise_q
    if fft_smoothing:
        var_src = src_dist - src_dist.mean()
        var_shaped = shaped_dist - shaped_dist.mean()
        shaped_dist = shaped_dist.mean() + var_shaped * (
            var_src.std(correction=0)
            / torch.clamp(var_shaped.std(correction=0), min=eps))
    return _ifft2(shaped_dist * src_phase).real


def match_histograms(shaped, src):
    """Histogram matching of ``shaped`` (rescaled to [0, 1]) to ``src`` on
    the host; needs scikit-image."""
    import numpy as np

    try:
        import skimage.exposure as exposure
    except ImportError as e:
        raise RuntimeError("histogram matching requires scikit-image") from e

    s = np.asarray(torch.as_tensor(shaped).cpu(), np.float64)
    s -= s.min()
    s /= max(s.max(), 1e-12)
    return exposure.match_histograms(s, np.asarray(torch.as_tensor(src).cpu(), np.float64),
                                     channel_axis=-1)
