"""Post-edit regularizers of the edited latents (counterpart of
diffusion_pullback_tpu/samplers/regularizers.py).

The drivers apply them to the strided walk frames right before the finish
sampling, in the reference's order (thresholding, then contrast, then
norm), and ``sega_sparsify`` to the mean-basis directions. Every
per-sample statistic reduces over the flattened sample, so it does not
depend on NHWC or NCHW. Standard deviations are the population ones
(``correction=0``), as ``jnp.std``.
"""

from __future__ import annotations

import torch


def _per_sample(fn, x):
    flat = x.reshape(x.shape[0], -1)
    return fn(flat).reshape(x.shape)


def _ref_stat(stat: torch.Tensor, n_edit: int) -> torch.Tensor:
    """A per-reference-sample statistic (B_ref,) aligned with the edit
    batch: as it is when the batches match, broadcast from a single
    reference latent; any other mismatch is a caller's error."""
    if stat.shape[0] == n_edit:
        return stat
    if stat.shape[0] == 1:
        return stat.expand(n_edit)
    raise ValueError(
        f"reference batch {stat.shape[0]} incompatible with edit batch {n_edit}")


def preserve_norm(x_edit: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
    """Rescale each edited sample to its reference latent's L2 norm (a
    batch-1 reference broadcasts over the edit batch)."""
    ref = torch.linalg.norm(x_ref.reshape(x_ref.shape[0], -1), dim=1)
    ref = _ref_stat(ref, x_edit.shape[0])

    def f(flat):
        n = torch.linalg.norm(flat, dim=1, keepdim=True)
        return flat * (ref[:, None] / torch.clamp(n, min=1e-12))

    return _per_sample(f, x_edit)


def preserve_contrast(x_edit: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
    """Match each edited sample's (mean, std) to its reference latent's (a
    batch-1 reference broadcasts)."""
    rflat = x_ref.reshape(x_ref.shape[0], -1)
    r_mu = _ref_stat(rflat.mean(dim=1), x_edit.shape[0])
    r_sd = _ref_stat(rflat.std(dim=1, correction=0), x_edit.shape[0])

    def f(flat):
        mu = flat.mean(dim=1, keepdim=True)
        sd = flat.std(dim=1, keepdim=True, correction=0)
        return (flat - mu) * (r_sd[:, None] / torch.clamp(sd, min=1e-12)) + r_mu[:, None]

    return _per_sample(f, x_edit)


def dynamic_thresholding(x: torch.Tensor, q: float = 0.8) -> torch.Tensor:
    """Imagen-style dynamic thresholding: clamp each sample at the
    q-quantile s of its |x| (linear interpolation, as jnp.quantile).
    torch.quantile takes at most 2²⁴ elements per call; one sample here
    is at most 128·128·4 SDXL latents or 256·256·3 pixels, far below."""

    def f(flat):
        s = torch.quantile(flat.abs(), q, dim=1, keepdim=True)
        s = torch.clamp(s, min=1e-12)
        return torch.clamp(flat, -s, s)

    return _per_sample(f, x)


def sega_sparsify(v: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """SEGA-style sparsification: zero every component of the direction
    whose magnitude is below σ·std(v)."""
    std = v.std(correction=0)
    return torch.where(v.abs() < sigma * std, torch.zeros_like(v), v)
