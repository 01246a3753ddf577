"""Parallel transport of editing directions between samples.

Counterpart of diffusion_pullback_tpu/geometry/transport.py: a direction
found at sample 0 moves to sample 1 through h-space,
v_k^(1) = v₁ᵀᵀ (u₁ᵀ u₀[:, k]) — u₀'s k-th column expressed in sample 1's
h-basis, then mapped to sample 1's x-basis.
"""

from __future__ import annotations

import torch


def transport_direction(u0: torch.Tensor, u1: torch.Tensor, vT1: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Direction k of basis 0 in the x-space of sample 1. u0, u1: (dim_h, r)
    column bases; vT1: (r, dim_x) row basis of sample 1. Returns a unit
    (dim_x,) direction."""
    coeffs = u1.T @ u0[:, k]            # (r,): u0_k in sample 1's h-basis
    v = vT1.T @ coeffs                  # (dim_x,)
    return v / torch.linalg.norm(v)


def transport_all(u0: torch.Tensor, u1: torch.Tensor, vT1: torch.Tensor
                  ) -> torch.Tensor:
    """All directions at once → (r, dim_x) unit rows."""
    coeffs = u1.T @ u0                  # (r, r)
    v = coeffs.T @ vT1                  # (r, dim_x)
    return v / torch.linalg.norm(v, dim=1, keepdim=True)
