"""Mean bases across samples (counterpart of
diffusion_pullback_tpu/geometry/mean.py):

  - Fréchet: the extrinsic Grassmannian mean of the spans of U_i, the
    top-r eigenvectors of the mean projector (1/n)Σ U_i U_iᵀ, taken as the
    top left singular vectors of the stacked (dim, n·r) matrix, so the
    dim × dim projector never exists;
  - Hungarian: each basis' columns matched to a pivot basis by maximal
    |cosine| (scipy's linear_sum_assignment), sign-aligned, averaged and
    re-orthonormalised by QR; it keeps each direction's identity where the
    Fréchet mean keeps only the subspace.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .pullback import _short_fat_svd


def frechet_mean_basis(bases: Sequence[torch.Tensor], rank: int) -> torch.Tensor:
    """(dim, r) column-orthonormal matrices → (dim, rank)."""
    stack = torch.cat([torch.as_tensor(u).float() for u in bases], dim=1)  # (d, n·r)
    _, vT = _short_fat_svd(stack.T)   # vT rows: the left singular vectors of stack
    return vT[:rank].T


def hungarian_mean_basis(bases: Sequence[torch.Tensor], rank: int) -> torch.Tensor:
    """Column-matched mean basis → (dim, rank), column-orthonormal, on the
    first basis' device."""
    from scipy.optimize import linear_sum_assignment

    host = [torch.as_tensor(u).float().cpu().numpy() for u in bases]
    pivot = host[0][:, :rank]
    acc = pivot.copy()
    for u in host[1:]:
        _, col = linear_sum_assignment(-np.abs(pivot.T @ u))
        matched = u[:, col]
        signs = np.sign(np.sum(pivot * matched, axis=0))
        signs[signs == 0] = 1.0
        acc = acc + matched * signs[None, :]
    q, _ = np.linalg.qr(acc)
    return torch.as_tensor(q[:, :rank], dtype=torch.float32,
                           device=torch.as_tensor(bases[0]).device)
