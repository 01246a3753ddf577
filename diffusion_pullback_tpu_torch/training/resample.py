"""Timestep samplers: uniform and loss-second-moment importance sampling
(counterpart of diffusion_pullback_tpu/training/resample.py, after
guided-diffusion's UniformSampler and LossSecondMomentResampler).

Draws come from an explicit ``torch.Generator`` on the device the draws
land on. The loss-aware state is a pair of tensors carried beside the train
state, as the JAX package carries its pytree.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


def uniform_sample_t(generator: torch.Generator, batch: int, num_timesteps: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, weights): uniform int64 timesteps in [0, num_timesteps) and unit
    f32 weights, on the generator's device."""
    dev = generator.device
    t = torch.randint(0, num_timesteps, (batch,), generator=generator, device=dev)
    return t, torch.ones((batch,), dtype=torch.float32, device=dev)


class LossAwareState(NamedTuple):
    history: torch.Tensor  # (T, history_per_term) f32: the last losses per t
    counts: torch.Tensor   # (T,) int32: entries filled per t


def init_loss_aware(num_timesteps: int, history_per_term: int = 10,
                    device: Optional[torch.device | str] = None) -> LossAwareState:
    return LossAwareState(
        history=torch.zeros((num_timesteps, history_per_term), dtype=torch.float32,
                            device=device),
        counts=torch.zeros((num_timesteps,), dtype=torch.int32, device=device))


def loss_aware_weights(state: LossAwareState, uniform_prob: float = 0.001
                       ) -> torch.Tensor:
    """The sampling distribution over t ∝ sqrt(E[loss²]), mixed with
    ``uniform_prob`` of uniform; uniform until every t has a full history
    ('warmed up')."""
    T, per_term = state.history.shape
    warmed = (state.counts == per_term).all()
    w = torch.sqrt(torch.mean(state.history ** 2, dim=-1))
    w = w / torch.clamp(w.sum(), min=1e-20)
    w = w * (1 - uniform_prob) + uniform_prob / T
    return torch.where(warmed, w, torch.full_like(w, 1.0 / T))


def loss_aware_sample_t(state: LossAwareState, generator: torch.Generator,
                        batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, importance weights 1 / (T·p(t))): ``batch`` draws with
    replacement from loss_aware_weights."""
    p = loss_aware_weights(state)
    t = torch.multinomial(p, batch, replacement=True, generator=generator)
    return t, 1.0 / (p.shape[0] * p[t])


def update_loss_aware(state: LossAwareState, t: torch.Tensor, losses: torch.Tensor
                      ) -> LossAwareState:
    """Record per-sample losses into the per-t ring buffers, in batch order:
    a t that occurs k times in the batch shifts its buffer k times (as the
    JAX package's lax.scan over the batch does; a scatter would keep one of
    them). Returns a new state on the old one's device."""
    hist, cnt = state.history.cpu().clone(), state.counts.cpu().clone()
    per_term = hist.shape[1]
    for ti, li in zip(t.tolist(), losses.detach().float().cpu()):
        c = int(cnt[ti])
        if c == per_term:  # full: shift left, append at the end
            hist[ti] = torch.cat([hist[ti, 1:], li[None]])
        else:
            hist[ti, c] = li
        cnt[ti] = min(c + 1, per_term)
    dev = state.history.device
    return LossAwareState(hist.to(dev), cnt.to(dev))
