"""Analysis artifacts: eigenvalue spectra, the RGB map of x-space
directions and the radially averaged power spectra of a trajectory.

Counterpart of diffusion_pullback_tpu/experiments/vis.py, on numpy arrays
(NHWC, as the drivers' bases and images are at their boundary).
matplotlib is imported inside the two plotting functions, so the rest
works without it; a driver that cannot plot logs ``vis_failed`` and goes
on.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..parallel.mesh import is_writer
from ..utils.images import save_image_grid


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_eigenvalue_spectrum(s: np.ndarray, path: str) -> None:
    """Scatter of the singular values by index."""
    plt = _pyplot()
    s = np.asarray(s)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig, ax = plt.subplots(figsize=(4, 3))
    ax.scatter(range(len(s)), s, s=4)
    ax.set_xlabel("index")
    ax.set_ylabel("singular value")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def visualize_vT_rgb(vT: np.ndarray, spatial_shape: Sequence[int], path: str
                     ) -> np.ndarray:
    """Project each direction's channel axis onto the top-3 principal
    components of the channels over all directions and pixels, scale to
    [0, 1] and save the maps side by side. ``vT``: (k, H·W·C) rows
    flattened NHWC; ``spatial_shape``: (H, W, C). Returns the (k, H, W, 3)
    maps."""
    h, w, c = spatial_shape
    k = vT.shape[0]
    maps = np.asarray(vT, np.float32).reshape(k, h, w, c)
    flat = maps.reshape(-1, c)
    flat = flat - flat.mean(axis=0, keepdims=True)
    _, evecs = np.linalg.eigh(flat.T @ flat)           # c×c covariance
    rgb = maps @ evecs[:, ::-1][:, :min(3, c)]         # (k, h, w, ≤3)
    if rgb.shape[-1] < 3:
        rgb = np.concatenate([rgb] + [rgb[..., :1]] * (3 - rgb.shape[-1]), axis=-1)
    rgb = rgb - rgb.min()
    rgb = rgb / max(rgb.max(), 1e-12)
    save_image_grid(rgb * 2 - 1, path)
    return rgb


def radial_psd(img: np.ndarray, num_bins: int = 64) -> np.ndarray:
    """Radially averaged power spectral density of one (H, W, C) image: the
    channel mean of |FFT2|², averaged over integer-radius annuli around the
    DC component (bin i = the frequencies at distance ≈ i, capped at
    ``num_bins`` − 1)."""
    x = np.asarray(img, np.float32)
    if x.ndim == 2:
        x = x[..., None]
    h, w, _ = x.shape
    spec = np.fft.fftshift(np.fft.fft2(x, axes=(0, 1)), axes=(0, 1))
    power = (np.abs(spec) ** 2).mean(axis=-1)
    r = np.hypot((np.arange(h) - h // 2)[:, None], (np.arange(w) - w // 2)[None, :])
    bins = np.minimum(np.round(r).astype(np.int64), num_bins - 1)
    n = min(num_bins, int(np.round(r.max())) + 1)
    sums = np.bincount(bins.ravel(), weights=power.ravel(), minlength=n)[:n]
    counts = np.maximum(np.bincount(bins.ravel(), minlength=n)[:n], 1)
    return sums / counts


def psd_curves(traj, num_bins: int = 64) -> np.ndarray:
    """(T, bins) radial PSD of each frame of a trajectory (x_t or ε_t over
    the grid; of a frame's first image where it holds a batch)."""
    frames = [np.asarray(f, np.float32) for f in traj]
    return np.stack([radial_psd(f[0] if f.ndim == 4 else f, num_bins) for f in frames])


def vis_power_spectral_density(traj, path: str, num_bins: int = 64, labels=None
                               ) -> np.ndarray:
    """One PSD curve per trajectory frame, log scale, coloured from early to
    late, the DC bin dropped. Returns the (T, bins) PSD matrix."""
    curves = psd_curves(traj, num_bins)
    if not is_writer():  # rank 0 of a torch.distributed run plots
        return curves
    plt = _pyplot()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig, ax = plt.subplots(figsize=(5, 4))
    cmap = plt.get_cmap("viridis")
    bins = curves.shape[1]
    for i, c in enumerate(curves):
        ax.plot(np.arange(1, bins), c[1:], color=cmap(i / max(len(curves) - 1, 1)),
                label=labels[i] if labels else None, linewidth=1.0)
    ax.set_yscale("log")
    ax.set_xlabel("radial frequency bin")
    ax.set_ylabel("power")
    if labels:
        ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return curves
