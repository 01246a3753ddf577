"""DDIM sampling / inversion loops (counterpart of
diffusion_pullback_tpu/samplers/ddim_loop.py; JAX's lax.scan is a Python
loop here). Partial traversals slice the grid by index, the
t_start_idx / t_end_idx semantics of the reference's DDIMforwardsteps."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.ddim import ddim_step
from ..ops.schedule import DiffusionSchedule, TimestepGrid, alpha_bar

# eps_fn(x, t) -> ε ; already closed over weights / prompt conditioning / CFG
EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_ddim_step_fn(eps_fn: EpsFn, schedule: DiffusionSchedule):
    """One (ε-eval + DDIM update) step."""

    def step(x, t, t_next):
        et = eps_fn(x, t)
        return ddim_step(et, x, alpha_bar(schedule, t),
                         alpha_bar(schedule, t_next)).prev_sample

    return step


def _traverse(eps_fn, x, schedule, timesteps, timesteps_next):
    step = make_ddim_step_fn(eps_fn, schedule)
    for t, tn in zip(timesteps, timesteps_next):
        x = step(x, t, tn)
    return x


def ddim_invert(eps_fn: EpsFn, x0: torch.Tensor, schedule: DiffusionSchedule,
                grid: TimestepGrid) -> torch.Tensor:
    """x0 → x_T over the inversion grid. Like the reference loop (which
    breaks before its final timestep entry), only the first n−2 of the n−1
    pairs run, so "x_T" sits at seq[n−2]."""
    return _traverse(eps_fn, x0, schedule, grid.timesteps[:-1],
                     grid.timesteps_next[:-1])


def ddim_forward(eps_fn: EpsFn, xT: torch.Tensor, schedule: DiffusionSchedule,
                 grid: TimestepGrid, start_idx: int = 0,
                 end_idx: Optional[int] = None) -> torch.Tensor:
    """Denoise from grid index ``start_idx`` (inclusive) to ``end_idx``
    (exclusive; None = all the way to x0)."""
    end = grid.num_steps if end_idx is None else end_idx
    return _traverse(eps_fn, xT, schedule, grid.timesteps[start_idx:end],
                     grid.timesteps_next[start_idx:end])
