"""Variational-bound loss terms for learned-σ diffusion training
(counterpart of diffusion_pullback_tpu/training/losses.py, after
guided-diffusion's losses.py and gaussian_diffusion.py's _vb_terms_bpd,
_prior_bpd and calc_bpd_loop): the L_vb half of the improved-DDPM hybrid
objective, and the full-chain bound in bits per dimension.

Images are NCHW; per-sample terms average over every axis but the first.
The schedule's tables move to the images' device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..ops.ddim import predict_x0
from ..ops.schedule import DiffusionSchedule, alpha_bar, beta


def _per_sample(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=1)


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (ndim - 1))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, e^{logvar1}) ‖ N(mean2, e^{logvar2})), elementwise in nats."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """log p(x) for images discretised to 255 bins (x in [-1, 1])."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def q_posterior_mean_logvar(schedule: DiffusionSchedule, x0, xt, t):
    """Mean and log-variance of q(x_{t−1} | x_t, x_0), the DDPM posterior;
    at t < 1 (variance 0) the log-variance is the t = 1 value, as
    guided-diffusion's posterior_log_variance_clipped."""
    schedule = schedule.to(x0.device)
    at = alpha_bar(schedule, t)
    t_prev = torch.clamp(t - 1.0, min=0.0)
    at_prev = torch.where(t < 1.0, torch.ones_like(at), alpha_bar(schedule, t_prev))
    bt = 1.0 - at / at_prev
    at, at_prev, bt = (_bcast(v, x0.ndim) for v in (at, at_prev, bt))
    coef0 = torch.sqrt(at_prev) * bt / (1.0 - at)
    coeft = torch.sqrt(1.0 - bt) * (1.0 - at_prev) / (1.0 - at)
    mean = coef0 * x0 + coeft * xt
    var = bt * (1.0 - at_prev) / (1.0 - at)
    at1 = _bcast(alpha_bar(schedule, torch.ones_like(t)), x0.ndim)
    at0 = _bcast(alpha_bar(schedule, torch.zeros_like(t)), x0.ndim)
    bt1 = 1.0 - at1 / at0
    var1 = bt1 * (1.0 - at0) / (1.0 - at1)
    var = torch.where(_bcast(t, x0.ndim) < 1.0, var1, var)
    return mean, torch.log(torch.clamp(var, min=1e-20))


def vb_term(schedule: DiffusionSchedule, x0, xt, t, eps_pred, logvar_pred,
            clip_x0: bool = False):
    """Per-sample L_vb in bits/dim of a learned-σ output: ``logvar_pred`` is
    the raw channel half, range-interpolated between the posterior variance
    (−1) and β_t (+1) as improved DDPM does; the KL against the posterior,
    or at t < 1 the decoder's discretised NLL. ``clip_x0`` clamps x̂₀ to
    [−1, 1] first (guided-diffusion's clip_denoised)."""
    schedule = schedule.to(x0.device)
    at = _bcast(alpha_bar(schedule, t), x0.ndim)
    pred_x0 = predict_x0(eps_pred, xt, at)
    if clip_x0:
        pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
    true_mean, true_logvar = q_posterior_mean_logvar(schedule, x0, xt, t)
    model_mean, _ = q_posterior_mean_logvar(schedule, pred_x0, xt, t)
    max_log = torch.log(torch.clamp(_bcast(beta(schedule, t), x0.ndim), min=1e-20))
    frac = (logvar_pred + 1.0) / 2.0
    model_logvar = frac * max_log + (1.0 - frac) * true_logvar
    kl = _per_sample(normal_kl(true_mean, true_logvar, model_mean, model_logvar))
    decoder_nll = _per_sample(-discretized_gaussian_log_likelihood(
        x0, model_mean, 0.5 * model_logvar))
    return torch.where(t < 1.0, decoder_nll, kl) / math.log(2.0)


def prior_bpd(schedule: DiffusionSchedule, x0):
    """KL(q(x_T | x_0) ‖ N(0, I)) in bits/dim, the L_T prior term."""
    schedule = schedule.to(x0.device)
    t = torch.full((x0.shape[0],), float(schedule.num_train_timesteps - 1),
                   device=x0.device)
    at = _bcast(alpha_bar(schedule, t), x0.ndim)
    mean = torch.sqrt(at) * x0
    logvar = torch.log(torch.clamp(1.0 - at, min=1e-20)).expand_as(mean)
    kl = normal_kl(mean, logvar, torch.zeros_like(mean), torch.zeros_like(logvar))
    return _per_sample(kl) / math.log(2.0)


@torch.no_grad()
def calc_bpd_loop(schedule: DiffusionSchedule,
                  model_fn: Callable[[torch.Tensor, torch.Tensor], tuple],
                  x0: torch.Tensor, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None, clip_x0: bool = True):
    """The full-chain variational bound in bits/dim: for every t in
    [T−1 … 0] draw x_t ~ q(x_t | x_0), evaluate ``model_fn(x_t, t) →
    (ε, logvar_raw)`` (t of shape (B,)) and take the step's L_vb, then add
    the prior term. Pass exactly one of ``generator`` (fresh noise per
    step, on its device) and ``noise`` of shape (T, *x0.shape). Returns
    ``total_bpd`` and ``prior_bpd`` (B,), and per step ``vb``,
    ``xstart_mse`` and ``mse`` (T, B), ordered t = T−1 … 0. Runs with no
    gradient recorded."""
    if (generator is None) == (noise is None):
        raise ValueError("pass exactly one of generator= or noise=")
    schedule = schedule.to(x0.device)
    T = schedule.num_train_timesteps
    vb, xs_mse, mse = [], [], []
    for i, t in enumerate(range(T - 1, -1, -1)):
        n = (noise[i] if noise is not None else torch.randn(
            x0.shape, generator=generator, device=x0.device, dtype=x0.dtype))
        tb = torch.full((x0.shape[0],), float(t), device=x0.device)
        at = _bcast(alpha_bar(schedule, tb), x0.ndim)
        xt = torch.sqrt(at) * x0 + torch.sqrt(1.0 - at) * n
        eps, logvar = model_fn(xt, tb)
        vb.append(vb_term(schedule, x0, xt, tb, eps, logvar, clip_x0=clip_x0))
        px0 = predict_x0(eps, xt, at)
        if clip_x0:
            px0 = torch.clamp(px0, -1.0, 1.0)
        xs_mse.append(_per_sample((px0 - x0) ** 2))
        # ε re-derived from the (possibly clipped) x̂₀, as guided-diffusion's
        # _predict_eps_from_xstart
        eps_used = (xt - torch.sqrt(at) * px0) / torch.sqrt(1.0 - at)
        mse.append(_per_sample((eps_used - n) ** 2))
    vb, xs_mse, mse = (torch.stack(v) for v in (vb, xs_mse, mse))
    prior = prior_bpd(schedule, x0)
    return {"total_bpd": vb.sum(dim=0) + prior, "prior_bpd": prior, "vb": vb,
            "xstart_mse": xs_mse, "mse": mse}
