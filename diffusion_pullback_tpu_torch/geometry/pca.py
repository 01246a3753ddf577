"""PCA over feature space (counterpart of
diffusion_pullback_tpu/geometry/pca.py):

  - ``local_pca``: PCA of h = f(x + σδ) over many Gaussian perturbations δ,
    as a two-pass streaming randomized sketch over chunks of samples, so
    the (num_samples, dim_h) matrix never exists;
  - ``global_pca``: PCA of h across a batch of different inputs;
  - ``pca_to_x_direction``: an h-space direction mapped to a unit x-space
    direction through one VJP, v = Jᵀu / ‖Jᵀu‖.

Features flatten in the caller's layout; the drivers hand NHWC features,
so components flatten as the JAX package's do.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from .pullback import _short_fat_svd, pullback_covector


class PCAResult(NamedTuple):
    components: torch.Tensor   # (rank, dim_h) unit rows
    variances: torch.Tensor    # (rank,) explained variance, descending
    mean: torch.Tensor         # (dim_h,)


def _chunk_generator(seed: int, i: int, stream: int) -> torch.Generator:
    """A CPU generator for chunk ``i`` of one draw stream (0: δ, 1: Ω),
    seeded from (seed, i, stream) alone, so a chunk's draws come out the
    same whenever they are made."""
    state = np.random.SeedSequence([seed, i, stream]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)


def local_pca(
    fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    seed: int = 0,
    rank: int = 50,
    num_samples: int = 4096,
    chunk: int = 64,
    sigma: float = 0.1,
    oversample: int = 8,
    unit_delta: bool = False,
    draw: Optional[Callable[[int], Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> PCAResult:
    """Streaming randomized PCA of {f(x + σδ_i)} for Gaussian δ_i.

    ``fn`` maps one sample (with its leading batch axis of 1) to a feature
    tensor; it is vmapped over each chunk of perturbations. Pass 1 sums the
    mean and the sketch Y = XᵀΩ for a Gaussian test matrix Ω of rank +
    oversample columns; the sketch is centred exactly with the mean,
    (X − 1μᵀ)ᵀΩ = XᵀΩ − μ(1ᵀΩ), and its QR gives the basis Q. Pass 2 sums the
    Gram matrix of the centred samples projected on Q, whose eigenpairs
    give the components. ``unit_delta`` scales each δ to unit L2 norm
    before σ.

    Both passes must see the same samples: chunk i's δ and Ω are drawn
    anew in each pass from generators seeded by (seed, i), never from one
    running generator. ``draw(i) -> (δ (chunk, *x.shape[1:]), Ω (chunk,
    rank + oversample))`` replaces those draws (δ before the unit scaling),
    so a test can hand both packages the same samples.
    """
    if num_samples % chunk:
        raise ValueError("num_samples must be divisible by chunk")
    q = rank + oversample
    n_chunks = num_samples // chunk
    x = x.float()
    dev = x.device

    def draws(i):
        if draw is not None:
            delta, omega = draw(i)
        else:
            delta = torch.randn((chunk, *x.shape[1:]), generator=_chunk_generator(seed, i, 0))
            omega = torch.randn((chunk, q), generator=_chunk_generator(seed, i, 1))
        delta = torch.as_tensor(delta, dtype=torch.float32).to(dev)
        omega = torch.as_tensor(omega, dtype=torch.float32).to(dev)
        if unit_delta:
            n = torch.linalg.norm(delta.reshape(chunk, -1), dim=1)
            delta = delta / n.clamp_min(1e-12).reshape(chunk, *(1,) * (delta.ndim - 1))
        return delta, omega

    def samples(delta):
        return vmap(lambda d: fn(x + sigma * d[None]).reshape(-1))(delta).float()

    with torch.no_grad():
        sum_h = sketch = col_sums = None
        for i in range(n_chunks):           # pass 1: mean and sketch
            delta, omega = draws(i)
            hs = samples(delta)                              # (chunk, dh)
            if sum_h is None:
                sum_h = torch.zeros(hs.shape[1], device=dev)
                sketch = torch.zeros(hs.shape[1], q, device=dev)
                col_sums = torch.zeros(q, device=dev)
            sum_h += hs.sum(dim=0)
            sketch += hs.T @ omega
            col_sums += omega.sum(dim=0)
        mean = sum_h / num_samples
        qbasis, _ = torch.linalg.qr(sketch - mean[:, None] * col_sums[None, :])

        gram = torch.zeros(q, q, device=dev)
        for i in range(n_chunks):           # pass 2: Gram of the projections
            proj = (samples(draws(i)[0]) - mean[None, :]) @ qbasis   # (chunk, q)
            gram += proj.T @ proj
        w, evecs = torch.linalg.eigh(gram)                  # ascending
        w, evecs = w.flip(0), evecs.flip(1)
        comps = (qbasis @ evecs[:, :rank]).T                # (rank, dh)
        comps = comps / torch.linalg.norm(comps, dim=1, keepdim=True)
    return PCAResult(components=comps,
                     variances=w[:rank].clamp_min(0.0) / num_samples, mean=mean)


def global_pca(hs: torch.Tensor, rank: int = 50) -> PCAResult:
    """PCA of a batch of feature maps (batch, ...): the top min(rank,
    batch) directions of the centred rows."""
    n = hs.shape[0]
    x = hs.reshape(n, -1).float()
    mean = x.mean(dim=0)
    s, vt = _short_fat_svd(x - mean)
    k = min(rank, n)
    return PCAResult(components=vt[:k], variances=(s[:k] ** 2) / n, mean=mean)


def pca_to_x_direction(fn: Callable[[torch.Tensor], torch.Tensor],
                       x: torch.Tensor, component: torch.Tensor) -> torch.Tensor:
    """An h-space direction (flattened as fn's output) → the unit x-space
    direction Jᵀu / ‖Jᵀu‖, in x's shape."""
    v = pullback_covector(fn, x, component)
    return v / torch.linalg.norm(v)
