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

Under a dp×fsdp mesh (the first leg of the JAX package's multi-device dry
run, __graft_entry__._dryrun_impl, where GSPMD shards the batch over 'dp'
and the state over 'fsdp') the same step runs with ``mesh=``: an explicit
ZeRO-style shard. Each master is flattened, padded to a multiple of the
fsdp size and cut into one flat f32 chunk per fsdp rank; the optimizer
and the EMA run on the chunks (AdamW and SGD are elementwise, so a
chunk's update is the whole tensor's on its elements). The step gathers
the masters over 'fsdp', runs the loss of the rank's 'dp' share of each
microbatch on them, averages the gradients over 'dp' and hands each chunk
its slice. The draws are the whole batch's on every rank, so the sharded
step computes the single-device step's function.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
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


def _fsdp(mesh):
    """(the 'fsdp' group or None, its size, this rank's place in it)."""
    from ..parallel.mesh import axis_group, axis_names, axis_size

    if "fsdp" not in axis_names(mesh):
        return None, 1, 0
    group = axis_group(mesh, "fsdp")
    return group, axis_size(mesh, "fsdp"), dist.get_rank(group)


def _chunk(t: torch.Tensor, n: int, me: int) -> torch.Tensor:
    """Flat chunk ``me`` of ``n`` of t, zero-padded to a multiple of n."""
    flat = t.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % n)])
    return flat.chunk(n)[me]


def gather_params(shards: Mapping[str, torch.Tensor], shapes, mesh) -> Params:
    """The whole tensors of a sharded state's flat chunks (name → chunk:
    its masters, an EMA copy) over the mesh's 'fsdp' axis, each reshaped
    to ``shapes[name]``."""
    from ..parallel.collectives import gather_rows

    group, _, _ = _fsdp(mesh)
    return {k: (v.detach() if group is None else gather_rows(v.detach(), group))
            [:math.prod(shapes[k])].reshape(shapes[k]) for k, v in shards.items()}


def create_train_state(params: Mapping[str, torch.Tensor],
                       optimizer: Callable[[list], torch.optim.Optimizer],
                       n_ema: int = 1, mesh=None) -> TrainState:
    """A state on f32 copies of ``params`` (e.g. ``model.state_dict()``),
    with the optimizer ``optimizer`` builds on them. ``n_ema > 1`` keeps
    one EMA copy per rate (guided-diffusion's comma-separated ema_rate):
    ``ema_params`` is then a tuple, for a tuple ``ema_rate`` in
    make_train_step. With a ``mesh``, rank 0's ``params`` on every rank,
    and each master and EMA copy is this rank's flat chunk over the mesh's
    'fsdp' axis (gather_params gives them back whole)."""
    masters = {k: v.detach().to(torch.float32, copy=True) for k, v in params.items()}
    if mesh is not None:
        _, n, me = _fsdp(mesh)
        for v in masters.values():
            dist.broadcast(v, src=0)
        masters = {k: _chunk(v, n, me).clone() for k, v in masters.items()}
    masters = {k: v.requires_grad_() for k, v in masters.items()}
    copy = lambda: {k: v.detach().clone() for k, v in masters.items()}
    return TrainState(
        step=0, params=masters,
        ema_params=copy() if n_ema == 1 else tuple(copy() for _ in range(n_ema)),
        opt_state=optimizer(list(masters.values())))


def sample_losses(model: nn.Module, params: Params, x0, t, noise, sched,
                  learn_sigma_vb_weight: Optional[float] = None) -> torch.Tensor:
    """The per-sample losses of ``model`` run on ``params`` (f32 masters,
    cast to the module's dtype) at x_t = √ᾱ·x0 + √(1−ᾱ)·noise: the ε MSE,
    plus ``learn_sigma_vb_weight``·L_vb on the detached ε for a learned-σ
    head."""
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


def make_train_step(model: nn.Module, schedule: DiffusionSchedule,
                    optimizer: Callable[[list], torch.optim.Optimizer],
                    ema_rate=0.9999, learn_sigma_vb_weight: Optional[float] = None,
                    loss_aware: bool = False, accum_steps: int = 1, mesh=None):
    """Build the train step of ``model`` (ε-prediction, NCHW; a learned-σ
    head has twice the image's channels). With ``mesh``, the step of a
    state create_train_state sharded over the mesh's 'fsdp' axis, each
    microbatch split over its 'dp' axis (the module docstring); ``x0`` is
    the whole batch on every rank and the metrics are the whole batch's.

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
    from ..parallel.collectives import gather_rows
    from ..parallel.mesh import axis_group, axis_size

    del optimizer  # the state holds the optimizer it built
    if isinstance(ema_rate, (tuple, list)) and len(ema_rate) == 1:
        ema_rate = ema_rate[0]
    dp = axis_size(mesh, "dp")
    dp_group = axis_group(mesh, "dp") if dp > 1 else None
    if mesh is not None:
        _, n_fsdp, me_fsdp = _fsdp(mesh)
        shapes = {k: v.shape for k, v in model.state_dict().items()}

    def leaves(state):
        """The params the loss runs on, whose .grad the backward fills: the
        masters, or under a mesh their whole copies gathered over 'fsdp'."""
        if mesh is None:
            return state.params
        return {k: v.requires_grad_()
                for k, v in gather_params(state.params, shapes, mesh).items()}

    def share(rows: int) -> slice:
        """This rank's dp share of a microbatch of ``rows``."""
        if dp_group is None:
            return slice(None)
        me, n = dist.get_rank(dp_group), rows // dp
        return slice(me * n, (me + 1) * n)

    def per_sample_losses(params, x0, t, noise, sched):
        return sample_losses(model, params, x0, t, noise, sched, learn_sigma_vb_weight)

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
        if (x0.shape[0] // accum_steps) % dp:
            raise ValueError(f"microbatch {x0.shape[0] // accum_steps} does not "
                             f"split over dp={dp}")
        emas = ema_pairs(state)
        sched = schedule.to(x0.device)
        masters = list(state.params.values())
        params = leaves(state)
        for p in masters:
            p.grad = None
        loss, ts, all_losses = 0.0, [], []
        for i, x0_i in enumerate(x0.chunk(accum_steps)):
            t, weights, noise = (draw(i) if draw is not None
                                 else sample(generator, x0_i, sampler_state))
            rows = share(x0_i.shape[0])
            losses = per_sample_losses(params, x0_i[rows], t[rows], noise[rows], sched)
            loss_i = torch.mean(losses * weights[rows])
            loss_i.backward()
            loss = loss + loss_i.detach()
            ts.append(t)
            all_losses.append(losses.detach())
        # a parameter the output does not reach has no gradient: zero
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params.values()]
        if dp_group is not None:  # the mean over dp of the shares' means
            for g in grads + [loss]:
                dist.all_reduce(g, group=dp_group)
            torch._foreach_div_(grads, dp)
            loss = loss / dp
            all_losses = [gather_rows(x, dp_group) for x in all_losses]
        if accum_steps > 1:
            torch._foreach_div_(grads, accum_steps)
            loss = loss / accum_steps
        grad_norm = torch.nn.utils.get_total_norm(grads)
        for p, g in zip(masters, grads):
            p.grad = g if mesh is None else _chunk(g, n_fsdp, me_fsdp).clone()
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
