"""x-space guidance: walk a latent along a pullback direction
(counterpart of diffusion_pullback_tpu/samplers/guidance.py).

Each micro-step evaluates ε on the pair [z, z + step·v_k] and moves z by
scale·(ε_edit − ε_null)."""

from __future__ import annotations

from typing import Callable

import torch

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def x_space_guidance_step(eps_fn: EpsFn, z, t, vk, edit_step: float,
                          scale: float, pair_impl: str = "batch"):
    """One micro-step. ``pair_impl``: 'batch' evaluates the pair as one
    2·B-row call, 'split' as two B-row calls; the per-sample math is the
    same (no cross-batch coupling), so it is a scheduling choice."""
    z_edit = z + edit_step * vk
    if pair_impl == "split":
        et_null, et_edit = eps_fn(z, t), eps_fn(z_edit, t)
    elif pair_impl == "batch":
        et_null, et_edit = eps_fn(torch.cat([z, z_edit]), t).chunk(2)
    else:
        raise ValueError(f"unknown pair_impl {pair_impl!r}")
    return z + scale * (et_edit - et_null)


def x_space_guidance_scan(eps_fn: EpsFn, z0, t, vk, num_steps: int,
                          edit_step: float, scale: float,
                          pair_impl: str = "batch") -> torch.Tensor:
    """``num_steps`` micro-steps; the trajectory INCLUDING the start:
    (num_steps + 1, B, ...), the reference's [original, step_1, ...]."""
    traj = [z0]
    for _ in range(num_steps):
        traj.append(x_space_guidance_step(eps_fn, traj[-1], t, vk, edit_step,
                                          scale, pair_impl))
    return torch.stack(traj)


def x_space_guidance_scan_deepcache(full_fn, reuse_fn, z0, t, vk,
                                    num_steps: int, edit_step: float,
                                    scale: float, interval: int
                                    ) -> torch.Tensor:
    """``x_space_guidance_scan`` (pair evaluated as one batch) with the deep
    U-Net path of the [z; z + step·v_k] pair cached and refreshed every
    ``interval`` micro-steps: every micro-step evaluates ε at the same t and
    z moves only by scale·Δε, so the deep features drift slowly. Interval 1
    runs the full pair every micro-step.

    ``full_fn(pair, t) -> (eps, h)`` runs the full model and returns the
    ('up', n-2) tap activation; ``reuse_fn(pair, t, h) -> eps`` resumes
    from a cached h. Returns the trajectory with its start,
    (num_steps + 1, B, ...)."""
    traj, h = [z0], None
    for i in range(num_steps):
        z = traj[-1]
        pair = torch.cat([z, z + edit_step * vk])
        if i % interval == 0:
            eps, h = full_fn(pair, t)
        else:
            eps = reuse_fn(pair, t, h)
        et_null, et_edit = eps.chunk(2)
        traj.append(z + scale * (et_edit - et_null))
    return torch.stack(traj)
