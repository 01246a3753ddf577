"""DDIM sampling / inversion loops and the ancestral DDPM loop (counterpart
of diffusion_pullback_tpu/samplers/ddim_loop.py; JAX's lax.scan is a
Python loop here). Partial traversals slice the grid by index, the
t_start_idx / t_end_idx semantics of the reference's DDIMforwardsteps.

Performance boosting (η = 1 from a timestep on) is a per-step η array. The
η = 1 noise comes from an explicit ``torch.Generator`` (drawn on the CPU, so
a seed gives the same noise on any device) or from the caller's list of one
tensor per step: ``jax.random`` cannot be reproduced, so a test hands both
packages the same draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.ddim import ddim_step, predict_x0, split_learned_sigma
from ..ops.schedule import DiffusionSchedule, TimestepGrid, alpha_bar
from .guidance import condition_mean

# eps_fn(x, t) -> ε ; already closed over weights / prompt conditioning / CFG
EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def performance_boost_etas(num_steps: int, boost_start_idx: Optional[int]
                           ) -> np.ndarray:
    """η per forward step: 0 before ``boost_start_idx``, 1 from it on,
    the final step included. When the boost index is the last step, boosting
    is off entirely (the reference's gate checks the boost index, not the
    current step)."""
    etas = np.zeros((num_steps,), np.float32)
    if boost_start_idx is not None and boost_start_idx < num_steps - 1:
        etas[boost_start_idx:] = 1.0
    return etas


def make_ddim_step_fn(eps_fn: EpsFn, schedule: DiffusionSchedule):
    """One (ε-eval + deterministic DDIM update) step."""

    def step(x, t, t_next):
        et = eps_fn(x, t)
        return ddim_step(et, x, alpha_bar(schedule, t),
                         alpha_bar(schedule, t_next)).prev_sample

    return step


def ddim_scan(
    eps_fn: EpsFn,
    x: torch.Tensor,
    schedule: DiffusionSchedule,
    timesteps: torch.Tensor,
    timesteps_next: torch.Tensor,
    etas: Optional[Sequence[float]] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
    collect_trajectory: bool = False,
    collect_eps: bool = False,
):
    """Step x through the (t, t_next) pairs. Returns (x_final, trajectory).

    ``etas``: η per step (None: every step deterministic). A step with
    η > 0 takes its noise from ``noise[i]`` or, without a list, draws it
    from ``generator``; steps with η = 0 draw nothing. The trajectory is the
    stack of each step's output, with ``collect_eps`` the pair (x stack,
    ε stack), ε alone with ``collect_eps`` only, else None."""
    if etas is not None and noise is None and generator is None:
        raise ValueError("a stochastic ddim_scan needs a generator or noise")
    if noise is not None and len(noise) != len(timesteps):
        raise ValueError(f"{len(noise)} noise tensors for {len(timesteps)} steps")
    xs, es = [], []
    for i, (t, tn) in enumerate(zip(timesteps, timesteps_next)):
        et = eps_fn(x, t)
        eta = 0.0 if etas is None else float(etas[i])
        z = None
        if eta > 0:
            z = noise[i] if noise is not None else torch.randn(
                x.shape, generator=generator, dtype=torch.float32)
            z = z.to(device=x.device, dtype=x.dtype)
        x = ddim_step(et, x, alpha_bar(schedule, t), alpha_bar(schedule, tn),
                      eta=eta, noise=z).prev_sample
        if collect_trajectory:
            xs.append(x)
        if collect_eps:
            es.append(et)
    if collect_trajectory and collect_eps:
        return x, (torch.stack(xs), torch.stack(es))
    if collect_trajectory:
        return x, torch.stack(xs)
    return x, (torch.stack(es) if collect_eps else None)


def ddim_invert(eps_fn: EpsFn, x0: torch.Tensor, schedule: DiffusionSchedule,
                grid: TimestepGrid) -> torch.Tensor:
    """x0 → x_T over the inversion grid. Like the reference loop (which
    breaks before its final timestep entry), only the first n−2 of the n−1
    pairs run, so "x_T" sits at seq[n−2]."""
    return ddim_scan(eps_fn, x0, schedule, grid.timesteps[:-1],
                     grid.timesteps_next[:-1])[0]


def ddim_forward(eps_fn: EpsFn, xT: torch.Tensor, schedule: DiffusionSchedule,
                 grid: TimestepGrid, start_idx: int = 0,
                 end_idx: Optional[int] = None,
                 boost_start_idx: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Sequence[Optional[torch.Tensor]]] = None
                 ) -> torch.Tensor:
    """Denoise from grid index ``start_idx`` (inclusive) to ``end_idx``
    (exclusive; None = all the way to x0), with η = 1 from
    ``boost_start_idx`` on (``performance_boost_etas``); ``noise`` holds one
    tensor per step of the slice."""
    end = grid.num_steps if end_idx is None else end_idx
    etas = None
    if boost_start_idx is not None:
        etas = performance_boost_etas(grid.num_steps, boost_start_idx)[start_idx:end]
        etas = etas if (etas > 0).any() else None
    return ddim_scan(eps_fn, xT, schedule, grid.timesteps[start_idx:end],
                     grid.timesteps_next[start_idx:end], etas=etas,
                     generator=generator, noise=noise)[0]


def ddim_loop_host(step_fn, x: torch.Tensor, timesteps, timesteps_next
                   ) -> torch.Tensor:
    """Host-driven traversal: ``step_fn(x, t, t_next)`` once per pair."""
    for t, tn in zip(timesteps, timesteps_next):
        x = step_fn(x, t, tn)
    return x


def ddpm_forward(model_fn: EpsFn, x: torch.Tensor, schedule: DiffusionSchedule,
                 generator: Optional[torch.Generator] = None,
                 timesteps=None, learn_sigma: bool = False, cond_fn=None,
                 noises: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ancestral DDPM sampling (guided-diffusion's p_sample_loop) over
    ``timesteps`` (descending ints; default T−1 … 0, or the retained steps
    of a respacing, whose β is then the respaced 1 − ᾱ_t/ᾱ_prev).

    - Without ``learn_sigma`` the variance is the posterior β̃ (fixed
      small); with it ``model_fn`` returns [ε, v] on its trailing channel
      axis (an NHWC model output; a model run in NCHW must be wrapped) and
      the log-variance is the learned-range frac·log β_t + (1−frac)·log β̃_t,
      frac = (v + 1)/2.
    - ``cond_fn(x, t)`` = ∇ₓ log p(y | x) shifts the mean by Σ·∇
      (``condition_mean``).
    - The final transition (no earlier retained step) adds no noise.

    Noise comes from ``noises`` (steps, *x.shape), or is drawn on the CPU
    from ``generator``."""
    if timesteps is None:
        timesteps = torch.arange(schedule.num_train_timesteps - 1, -1, -1)
    timesteps = torch.as_tensor(timesteps, dtype=torch.float32)
    t_prev = torch.cat([timesteps[1:], torch.full((1,), -1.0)])
    if noises is None and generator is None:
        generator = torch.Generator().manual_seed(0)
    if noises is not None and len(noises) != len(timesteps):
        raise ValueError(f"{len(noises)} noise tensors for {len(timesteps)} steps")
    for i, (t, tp) in enumerate(zip(timesteps, t_prev)):
        ab_t = alpha_bar(schedule, t)
        ab_prev = torch.ones_like(ab_t) if tp < 0 else alpha_bar(schedule, tp)
        beta_t = 1.0 - ab_t / ab_prev
        out = model_fn(x, t).float()
        tilde = (1.0 - ab_prev) / (1.0 - ab_t) * beta_t
        # the 1e-20 floor stands in for posterior_log_variance_clipped; it
        # differs only at the final transition, which adds no noise
        min_log = torch.log(torch.clamp(tilde, min=1e-20))
        if learn_sigma:
            et, v = split_learned_sigma(out)
            frac = (v + 1.0) / 2.0
            logvar = frac * torch.log(beta_t) + (1.0 - frac) * min_log
            variance = torch.exp(logvar)
        else:
            et, logvar = out, min_log.expand(x.shape)
            variance = torch.exp(logvar)
        x0 = torch.clamp(predict_x0(et, x, ab_t), -1.0, 1.0)
        coef1 = beta_t * torch.sqrt(ab_prev) / (1.0 - ab_t)
        coef2 = (1.0 - ab_prev) * torch.sqrt(1.0 - beta_t) / (1.0 - ab_t)
        mean = coef1 * x0 + coef2 * x
        if cond_fn is not None:
            mean = condition_mean(mean, variance, cond_fn(x, t))
        if tp < 0:
            x = mean
            continue
        z = noises[i] if noises is not None else torch.randn(
            x.shape, generator=generator, dtype=torch.float32)
        x = mean + torch.exp(0.5 * logvar) * z.to(device=x.device, dtype=mean.dtype)
    return x
