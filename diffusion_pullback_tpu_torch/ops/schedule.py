"""Diffusion noise schedules and DDIM timestep grids.

Counterpart of diffusion_pullback_tpu/ops/schedule.py: beta tables are built
in float64 on the host and only then cast to float32 tensors; the DDIM grid
pairs inversion and forward steps over the same (ᾱ_t, ᾱ_next) pairs; the ᾱ
lookup floors the float timestep to an integer index. The OpenAI respacing
grids ('ddim25', '250', '25,25,25') of the published ADM checkpoints visit
other steps than the linspace grid: ``respaced_timestep_grid``.
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

    @property
    def t_max(self) -> int:
        """The last timestep, T − 1 (the reference fixes 999)."""
        return self.betas.shape[0] - 1

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


def space_timesteps(num_timesteps: int, section_counts) -> frozenset:
    """The retained steps of OpenAI's respacing: ``section_counts`` steps
    from equal sections of the process (a list, a comma-separated string),
    or ``"ddimN"``, the integer stride that gives exactly N steps."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return frozenset(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per, extra = divmod(num_timesteps, len(section_counts))
    start_idx, all_steps = 0, []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(
                f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return frozenset(all_steps)


def respaced_timestep_grid(section_counts, num_train_timesteps: int = 1000,
                           inversion: bool = False) -> TimestepGrid:
    """A grid over exactly the ``space_timesteps`` steps, paired as
    ``ddim_timestep_grid`` pairs its own (forward descending, inversion
    ascending with the +1e-6 tag). ᾱ lookups hit the retained steps, which
    is what the respaced process's β table preserves, so sampling needs no
    new table."""
    seq = np.asarray(sorted(space_timesteps(num_train_timesteps, section_counts)),
                     dtype=np.float64)
    if inversion:
        seq = seq + 1e-6
        ts, ts_next = seq[:-1], seq[1:]
    else:
        ts, ts_next = seq[1:][::-1], seq[:-1][::-1]
    return TimestepGrid(
        timesteps=torch.tensor(ts.copy(), dtype=torch.float32),
        timesteps_next=torch.tensor(ts_next.copy(), dtype=torch.float32),
    )


def respaced_betas(schedule: DiffusionSchedule, use_timesteps):
    """The respaced process's β table, β_i = 1 − ᾱ_i / ᾱ_prev over the
    retained steps (its cumulative ᾱ equals the original at each of them),
    and the map from new to original step. Returns (betas float64 array,
    timestep_map)."""
    ac = np.cumprod(1.0 - schedule.betas.double().cpu().numpy())
    keep = set(int(t) for t in use_timesteps)
    last, new_betas, tmap = 1.0, [], []
    for i, a in enumerate(ac):
        if i in keep:
            new_betas.append(1.0 - a / last)
            last = a
            tmap.append(i)
    return np.asarray(new_betas, dtype=np.float64), tmap


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
