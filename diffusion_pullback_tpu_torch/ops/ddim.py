"""DDIM step math (counterpart of diffusion_pullback_tpu/ops/ddim.py).

    P_xt    = (x_t - sqrt(1-ᾱ_t) ε) / sqrt(ᾱ_t)
    σ_t     = sqrt((1 - ᾱ_t/ᾱ_next)(1 - ᾱ_next)/(1 - ᾱ_t))
    D_xt    = sqrt(1 - ᾱ_next - η σ_t²) ε        # η·σ², not (ησ)²
    x_next  = sqrt(ᾱ_next) P_xt + D_xt + η σ_t z

and the learned-σ ancestral DDPM step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DDIMStepOutput(NamedTuple):
    prev_sample: torch.Tensor    # x at t_next
    pred_original: torch.Tensor  # P_xt, the Tweedie x0 estimate


def predict_x0(et, xt, at):
    """Tweedie estimate P_xt = (x_t − sqrt(1−ᾱ_t)·ε) / sqrt(ᾱ_t)."""
    return (xt - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)


def ddim_step(et, xt, at, at_next, eta: float = 0.0,
              noise: Optional[torch.Tensor] = None) -> DDIMStepOutput:
    """One DDIM update x_t → x_{t_next} (inversion and forward alike).
    ``noise=None`` is the deterministic branch (η ignored)."""
    p_x0 = predict_x0(et, xt, at)
    if noise is None:
        d = torch.sqrt(1.0 - at_next) * et
        return DDIMStepOutput(torch.sqrt(at_next) * p_x0 + d, p_x0)
    sigma = torch.sqrt((1.0 - at / at_next) * (1.0 - at_next) / (1.0 - at))
    d = torch.sqrt(torch.clamp(1.0 - at_next - eta * sigma**2, min=0.0)) * et
    prev = torch.sqrt(at_next) * p_x0 + d + eta * sigma * noise
    return DDIMStepOutput(prev, p_x0)


def ddpm_step_learned_sigma(et, logvar, xt, at, bt, noise) -> DDIMStepOutput:
    """Ancestral DDPM step with the model's log-variance (ε and logvar
    already split): x_prev = (x_t − β_t/√(1−ᾱ_t)·ε)/√(1−β_t) +
    exp(logvar/2)·z."""
    mean = (xt - bt / torch.sqrt(1.0 - at) * et) / torch.sqrt(1.0 - bt)
    prev = mean + torch.exp(0.5 * logvar) * noise
    return DDIMStepOutput(prev, predict_x0(et, xt, at))


def split_learned_sigma(model_out: torch.Tensor, axis: int = -1):
    """(ε, logvar): the two halves of a learned-σ model output along
    ``axis`` (default the trailing channel axis of an NHWC tensor)."""
    return model_out.chunk(2, dim=axis)
