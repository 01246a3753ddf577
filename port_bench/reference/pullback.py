"""Plain reference of the pullback: the top-r singular triplets of J = ∂f/∂z
of a map f at z by the subspace power iteration the paper describes.

    v₀ = Qᵀ of the QR of a (dim_z, r) Gaussian block (the probes)
    each iteration:  u = J vᵀ (r forward-mode passes),  w = Jᵀ u
                     (r reverse-mode passes), then the SVD of the short-fat
                     w by the QR of wᵀ and the SVD of the r×r factor;
                     rows sign-aligned to the previous iterate
    it runs at least min_iter + 2 and at most max_iter iterations, stopping
    early once the largest change of v is under atol; then one more forward
    pass gives u for the final v.

The passes are vmapped over chunks of probes so that float32 attention at
4096 tokens fits; the chunking changes no number.
"""

from __future__ import annotations

import math

import torch
from torch.func import jvp, vjp, vmap


def probes(seed: int, dim: int, rank: int) -> torch.Tensor:
    """(rank, dim) orthonormal rows from a CPU generator seeded with
    ``seed``: the QR of a (dim, rank) Gaussian block."""
    g = torch.randn(dim, rank, generator=torch.Generator().manual_seed(seed),
                    dtype=torch.float32)
    return torch.linalg.qr(g)[0].T


def _svd_short_fat(w: torch.Tensor):
    q, r = torch.linalg.qr(w.T)
    _, s, wt = torch.linalg.svd(r.T)
    return s, wt @ q.T


def power_iteration(f, z: torch.Tensor, v: torch.Tensor, min_iter: int,
                    max_iter: int, atol: float, chunk: int = 10):
    """(u (dim_h, r), s (r,), vT (r, dim_z), iterations) of f at z from the
    probes ``v`` (r, dim_z)."""
    z = z.float()
    shape = z.shape

    def chunked(fn, a):
        return torch.cat([vmap(fn)(c) for c in a.split(chunk)])

    tangent = lambda vi: jvp(f, (z,), (vi.reshape(shape),))[1].reshape(-1)
    h, pull = vjp(f, z)
    cotangent = lambda ui: pull(ui.reshape(h.shape))[0].reshape(-1)
    s, it, delta = None, 0, math.inf
    while it < max_iter and (it <= min_iter + 1 or delta > atol):
        u = chunked(tangent, v)
        s2, v_new = _svd_short_fat(chunked(cotangent, u))
        signs = torch.sign((v_new * v).sum(-1))
        v_new = v_new * torch.where(signs == 0, torch.ones_like(signs), signs)[:, None]
        delta = (v_new - v).abs().max().item()
        v, s, it = v_new, s2, it + 1
    u = chunked(tangent, v)
    return u.T, torch.sqrt(s), v, it
