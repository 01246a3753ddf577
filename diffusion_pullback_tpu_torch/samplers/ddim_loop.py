"""DDIM sampling / inversion loops (counterpart of
diffusion_pullback_tpu/samplers/ddim_loop.py; JAX's lax.scan is a Python
loop here). Partial traversals slice the grid by index, the
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

from ..ops.ddim import ddim_step
from ..ops.schedule import DiffusionSchedule, TimestepGrid, alpha_bar

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
