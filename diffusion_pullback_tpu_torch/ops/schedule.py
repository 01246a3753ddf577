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
    def linear(
        beta_start: float = 1e-4,
        beta_end: float = 0.02,
        num_train_timesteps: int = 1000,
    ) -> "DiffusionSchedule":
        """DDPM linear schedule: linear in beta."""
        return DiffusionSchedule.from_betas(np.linspace(
            beta_start, beta_end, num_train_timesteps, dtype=np.float64))

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
    def cosine(num_train_timesteps: int = 1000, s: float = 0.008
               ) -> "DiffusionSchedule":
        """Improved-DDPM cosine schedule over a ``num_train_timesteps``-entry
        table, betas clipped to [0, 0.999]."""
        x = np.linspace(0, num_train_timesteps, num_train_timesteps + 1,
                        dtype=np.float64)
        ac = np.cos(((x / num_train_timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
        ac = ac / ac[0]
        return DiffusionSchedule.from_betas(
            np.clip(1 - (ac[1:] / ac[:-1]), 0.0, 0.999))

    @staticmethod
    def from_name(name: str, **kwargs) -> "DiffusionSchedule":
        try:
            return {
                "linear": DiffusionSchedule.linear,
                "cosine": DiffusionSchedule.cosine,
                "scaled_linear": DiffusionSchedule.scaled_linear,
            }[name](**kwargs)
        except KeyError:
            raise ValueError(f"unknown noise schedule: {name!r}") from None


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


def _lookup(table: torch.Tensor, t) -> torch.Tensor:
    """table[t], flooring the float timestep to an index (clamped)."""
    t = torch.as_tensor(t, device=table.device)
    return table[t.to(torch.int64).clamp(0, table.shape[0] - 1)]


def alpha_bar(schedule: DiffusionSchedule, t) -> torch.Tensor:
    """ᾱ_t lookup, flooring the float timestep to an index (clamped)."""
    return _lookup(schedule.alphas_cumprod, t)


def beta(schedule: DiffusionSchedule, t) -> torch.Tensor:
    """β_t lookup (floor-to-int, clamped), for the learned-σ DDPM step."""
    return _lookup(schedule.betas, t)
