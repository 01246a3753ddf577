"""x-space guidance: walk a latent along a pullback direction
(counterpart of diffusion_pullback_tpu/samplers/guidance.py).

Each micro-step evaluates ε on the pair [z, z + step·v_k] and moves z by
scale·(ε_edit − ε_null).

Classifier guidance (the ADM family): a noisy-image classifier's
∇ₓ log p(y | x_t) folded into ε (condition_score) or into the DDPM
posterior mean (condition_mean); ``guided_eps_fn`` wraps an ε function so
every sampler loop runs guided."""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.schedule import alpha_bar

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


def classifier_grad_fn(logit_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                       y, scale: float = 1.0):
    """cond_fn(x, t) = scale · ∇ₓ log softmax(logit_fn(x, t))[y], ``y`` the
    (B,) labels (or one, broadcast over x's batch). torch.func.grad takes
    the gradient, so it flows under the samplers' ``torch.no_grad``."""

    def cond_fn(x, t):
        yb = torch.as_tensor(y, device=x.device).reshape(-1).expand(x.shape[0])

        def log_prob(xx):
            logp = torch.log_softmax(logit_fn(xx, t).float(), dim=-1)
            return logp.gather(-1, yb[:, None]).sum()

        return scale * torch.func.grad(log_prob)(x)

    return cond_fn


def condition_eps(eps, grad, abar_t):
    """condition_score in ε form: ε − √(1 − ᾱ_t) · ∇ₓ log p(y | x)."""
    return eps - torch.sqrt(1.0 - abar_t) * grad


def condition_mean(mean, variance, grad):
    """condition_mean: the DDPM posterior mean μ + Σ·∇ₓ log p(y | x)."""
    return mean + variance * grad


def guided_eps_fn(eps_fn: EpsFn, cond_fn, schedule) -> EpsFn:
    """``eps_fn`` with classifier guidance: each call evaluates ε(x, t) and
    the classifier gradient, and returns ``condition_eps`` of the two."""

    def fn(x, t):
        return condition_eps(eps_fn(x, t), cond_fn(x, t), alpha_bar(schedule, t))

    return fn
