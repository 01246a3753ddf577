"""Diffusion training: the ε-prediction MSE (plus the learned-σ VB term),
gradient accumulation, one optimizer and EMA update per step
(counterpart of diffusion_pullback_tpu/training/train.py, after
guided-diffusion's TrainLoop).

f32 master parameters: the train state keeps params, EMA copies and the
optimizer's state in float32 whatever the model computes in. A bf16 module
runs through ``torch.func.functional_call`` on a bf16 cast of the master
params, whose backward hands f32 gradients to the masters; an f32 module
runs on the masters themselves. No second module is kept.

``torch.optim`` stands in for optax: ``optimizer`` is a factory from the
list of master params to a ``torch.optim.Optimizer`` (e.g.
``functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=0.0)``).
optax.adamw's update −lr·(m̂/(√v̂+ε) + wd·p) equals torch's decoupled
AdamW, p·(1 − lr·wd) − lr·m̂/(√v̂+ε), and optax.sgd torch's SGD without
momentum. The step updates the state's tensors in place and returns the
state with its counter advanced; afterwards each master's ``.grad`` holds
the gradient the step applied.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.schedule import DiffusionSchedule, alpha_bar
from .losses import vb_term
from .resample import loss_aware_sample_t, uniform_sample_t, update_loss_aware

Params = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    step: int
    params: Params        # f32 masters, name → leaf tensor (requires grad)
    ema_params: Any       # f32, one dict or a tuple of dicts (one per rate)
    opt_state: torch.optim.Optimizer  # holds its state beside the masters


def create_train_state(params: Mapping[str, torch.Tensor],
                       optimizer: Callable[[list], torch.optim.Optimizer],
                       n_ema: int = 1) -> TrainState:
    """A state on f32 copies of ``params`` (e.g. ``model.state_dict()``),
    with the optimizer ``optimizer`` builds on them. ``n_ema > 1`` keeps
    one EMA copy per rate (guided-diffusion's comma-separated ema_rate):
    ``ema_params`` is then a tuple, for a tuple ``ema_rate`` in
    make_train_step."""
    masters = {k: v.detach().to(torch.float32, copy=True).requires_grad_()
               for k, v in params.items()}
    copy = lambda: {k: v.detach().clone() for k, v in masters.items()}
    return TrainState(
        step=0, params=masters,
        ema_params=copy() if n_ema == 1 else tuple(copy() for _ in range(n_ema)),
        opt_state=optimizer(list(masters.values())))


def make_train_step(model: nn.Module, schedule: DiffusionSchedule,
                    optimizer: Callable[[list], torch.optim.Optimizer],
                    ema_rate=0.9999, learn_sigma_vb_weight: Optional[float] = None,
                    loss_aware: bool = False, accum_steps: int = 1):
    """Build the train step of ``model`` (ε-prediction, NCHW; a learned-σ
    head has twice the image's channels).

    Plain:      step(state, x0, generator) → (state, metrics)
    loss_aware: step(state, x0, generator, sampler_state) → (state,
                metrics, sampler_state): importance-sampled t and the
                history update (training/resample.py).

    metrics: ``loss`` (the weighted mean over the batch), ``grad_norm`` (the
    global L2 norm of the applied gradient) and ``step``. A learned-σ head
    trains its ε half with the MSE plus ``learn_sigma_vb_weight``·L_vb on
    the detached ε (the improved-DDPM hybrid objective). ``accum_steps > 1``
    splits the batch (which it must divide) into microbatches whose
    gradients are summed and divided by ``accum_steps``; the optimizer and
    each EMA copy update once per step. ``ema_rate`` is a float or a tuple
    with one rate per EMA copy of the state (a 1-tuple is the float).

    ``optimizer`` is the factory create_train_state built the state's
    optimizer with; the step updates through ``state.opt_state``.

    ``draw=`` (a keyword of the step, in place of the generator) replaces
    the random draws: ``draw(i) → (t, weights, noise)`` for microbatch i,
    as local_pca's ``draw`` does.
    """
    del optimizer  # the state holds the optimizer it built
    if isinstance(ema_rate, (tuple, list)) and len(ema_rate) == 1:
        ema_rate = ema_rate[0]

    def per_sample_losses(params, x0, t, noise, sched):
        tf = t.to(torch.float32)
        at = alpha_bar(sched, tf).reshape((-1,) + (1,) * (x0.ndim - 1))
        xt = torch.sqrt(at) * x0 + torch.sqrt(1.0 - at) * noise
        dtype = next(model.parameters()).dtype  # the cast is a no-op in f32
        pred = torch.func.functional_call(
            model, {k: v.to(dtype) for k, v in params.items()}, (xt, tf))
        channels = noise.shape[1]
        eps_pred, logvar = ((pred[:, :channels], pred[:, channels:])
                            if pred.shape[1] != channels else (pred, None))
        losses = torch.mean((eps_pred.float() - noise) ** 2,
                            dim=tuple(range(1, x0.ndim)))
        if learn_sigma_vb_weight and logvar is not None:
            losses = losses + learn_sigma_vb_weight * vb_term(
                sched, x0, xt, tf, eps_pred.detach().float(), logvar.float())
        return losses

    def sample(generator, x0_i, sampler_state):
        if loss_aware:
            t, weights = loss_aware_sample_t(sampler_state, generator, x0_i.shape[0])
        else:
            t, weights = uniform_sample_t(generator, x0_i.shape[0],
                                          schedule.num_train_timesteps)
        noise = torch.randn(x0_i.shape, generator=generator, device=x0_i.device,
                            dtype=x0_i.dtype)
        return t, weights, noise

    def ema_pairs(state):
        if not isinstance(ema_rate, (tuple, list)):
            return [(ema_rate, state.ema_params)]
        if not (isinstance(state.ema_params, tuple)
                and len(state.ema_params) == len(ema_rate)):
            raise ValueError(
                f"ema_rate has {len(ema_rate)} entries but the state does not "
                "hold a matching tuple of EMA copies — build it with "
                f"create_train_state(n_ema={len(ema_rate)})")
        return list(zip(ema_rate, state.ema_params))

    def train_step(state: TrainState, x0: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   sampler_state=None, *, draw=None):
        if (generator is None) == (draw is None):
            raise ValueError("pass exactly one of generator and draw=")
        if loss_aware and sampler_state is None:
            raise ValueError("a loss_aware step takes the sampler state")
        if x0.shape[0] % accum_steps:
            raise ValueError(f"batch {x0.shape[0]} not divisible by accum_steps "
                             f"{accum_steps}")
        emas = ema_pairs(state)
        sched = schedule.to(x0.device)
        masters = list(state.params.values())
        for p in masters:
            p.grad = None
        loss, ts, all_losses = 0.0, [], []
        for i, x0_i in enumerate(x0.chunk(accum_steps)):
            t, weights, noise = (draw(i) if draw is not None
                                 else sample(generator, x0_i, sampler_state))
            losses = per_sample_losses(state.params, x0_i, t, noise, sched)
            loss_i = torch.mean(losses * weights)
            loss_i.backward()
            loss = loss + loss_i.detach()
            ts.append(t)
            all_losses.append(losses.detach())
        for p in masters:
            if p.grad is None:  # a parameter the output does not reach
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in masters]
        if accum_steps > 1:
            torch._foreach_div_(grads, accum_steps)
            loss = loss / accum_steps
        grad_norm = torch.nn.utils.get_total_norm(grads)
        state.opt_state.step()
        with torch.no_grad():
            for rate, ema in emas:  # e·rate + p·(1 − rate)
                ema_t = list(ema.values())
                torch._foreach_mul_(ema_t, rate)
                torch._foreach_add_(ema_t, masters, alpha=1.0 - rate)
        new_state = state._replace(step=state.step + 1)
        metrics = {"loss": loss, "grad_norm": grad_norm, "step": new_state.step}
        if loss_aware:
            sampler_state = update_loss_aware(sampler_state, torch.cat(ts),
                                              torch.cat(all_losses))
            return new_state, metrics, sampler_state
        return new_state, metrics

    return train_step


def draws_of(t: torch.Tensor, weights: torch.Tensor, noise: torch.Tensor,
             accum_steps: int = 1) -> Callable[[int], Tuple[torch.Tensor, ...]]:
    """A ``draw`` hook that hands microbatch i its slice of given draws for
    the whole batch (t and weights (B,), noise shaped as x0)."""
    parts = [x.chunk(accum_steps) for x in (t, weights, noise)]
    return lambda i: tuple(p[i] for p in parts)
