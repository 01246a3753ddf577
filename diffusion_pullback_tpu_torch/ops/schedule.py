"""Diffusion noise schedules and DDIM timestep grids.

Counterpart of diffusion_pullback_tpu/ops/schedule.py: beta tables are built
in float64 on the host and only then cast to float32 tensors; the DDIM grid
pairs inversion and forward steps over the same (ᾱ_t, ᾱ_next) pairs; the ᾱ
lookup floors the float timestep to an integer index.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    """Beta table and its cumulative-alpha table, float32, length T."""

    betas: torch.Tensor           # (T,)
    alphas_cumprod: torch.Tensor  # (T,)

    @property
    def num_train_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(self.betas.to(device),
                                 self.alphas_cumprod.to(device))

    @staticmethod
    def from_betas(betas_f64: np.ndarray) -> "DiffusionSchedule":
        betas_f64 = np.asarray(betas_f64, dtype=np.float64)
        alphas_cumprod = np.cumprod(1.0 - betas_f64, axis=0)
        return DiffusionSchedule(
            betas=torch.tensor(betas_f64, dtype=torch.float32),
            alphas_cumprod=torch.tensor(alphas_cumprod, dtype=torch.float32),
        )

    @staticmethod
    def scaled_linear(
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        num_train_timesteps: int = 1000,
    ) -> "DiffusionSchedule":
        """Stable-Diffusion 'scaled_linear' schedule: linear in sqrt(beta)."""
        betas = np.linspace(math.sqrt(beta_start), math.sqrt(beta_end),
                            num_train_timesteps, dtype=np.float64) ** 2
        return DiffusionSchedule.from_betas(betas)

    @staticmethod
    def from_name(name: str, **kwargs) -> "DiffusionSchedule":
        if name != "scaled_linear":
            raise ValueError(f"noise schedule {name!r} is not ported; the SD "
                             f"path uses 'scaled_linear'")
        return DiffusionSchedule.scaled_linear(**kwargs)


class TimestepGrid(NamedTuple):
    """A DDIM traversal of (t, t_next) pairs, float32, length num_steps - 1."""

    timesteps: torch.Tensor
    timesteps_next: torch.Tensor

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def ddim_timestep_grid(num_steps: int, t_max: float = 999.0,
                       inversion: bool = False) -> TimestepGrid:
    """Forward:   t = [t_max, ..., seq[1]],  t_next = [seq[n-2], ..., 0]
    Inversion: t = [~0, ..., seq[n-2]],   t_next = [seq[1], ..., t_max]
    where seq = linspace(0, 1, num_steps) * t_max (+1e-6 for inversion)."""
    seq = np.linspace(0.0, 1.0, num_steps, dtype=np.float64) * t_max
    if inversion:
        seq = seq + 1e-6
        ts, ts_next = seq[:-1], seq[1:]
    else:
        ts, ts_next = seq[1:][::-1], seq[:-1][::-1]
    return TimestepGrid(
        timesteps=torch.tensor(ts.copy(), dtype=torch.float32),
        timesteps_next=torch.tensor(ts_next.copy(), dtype=torch.float32),
    )


def alpha_bar(schedule: DiffusionSchedule, t) -> torch.Tensor:
    """ᾱ_t lookup, flooring the float timestep to an index (clamped)."""
    t = torch.as_tensor(t, device=schedule.alphas_cumprod.device)
    idx = t.to(torch.int64).clamp(0, schedule.num_train_timesteps - 1)
    return schedule.alphas_cumprod[idx]
