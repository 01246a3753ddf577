"""Encoder-reuse (DeepCache-style) DDIM sampling on the DDPM U-Net
(``ddim_forward_deepcache``) and the SD U-Net (``ddim_forward_deepcache_cond``);
counterparts of diffusion_pullback_tpu/samplers/deepcache.py, whose
lax.scan and lax.cond are a Python loop and an ``if`` here.

Deep U-Net features change slowly across adjacent timesteps, so the deep
path (down blocks 1…, mid, up blocks …n-2) runs only every ``interval``
steps and its ('up', n-2) activation is cached; the steps in between run
the shallow slice (``shallow_encode``: conv_in and the first down block)
and the last up block and head (``decode_with_state`` from the cached h).
Interval 1 runs the full model every step.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.unet2d import TapPoint
from ..ops.ddim import ddim_step
from ..ops.schedule import DiffusionSchedule, TimestepGrid, alpha_bar


def ddim_forward_deepcache(
    model,
    x: torch.Tensor,
    schedule: DiffusionSchedule,
    grid: TimestepGrid,
    interval: int = 3,
    start_idx: int = 0,
    end_idx: Optional[int] = None,
) -> torch.Tensor:
    """Denoise x (NCHW, the model's layout) with a UNet2D from grid index
    ``start_idx`` to ``end_idx`` (None: to x0), refreshing the deep path
    every ``interval`` steps; interval 1 is the full model every step."""
    n_up = len(model.up_blocks)
    if n_up < 2:
        raise ValueError("deepcache needs at least 2 up blocks")
    tap = TapPoint("up", n_up - 2)
    end = grid.num_steps if end_idx is None else end_idx
    h = None
    for i, (t, tn) in enumerate(zip(grid.timesteps[start_idx:end],
                                    grid.timesteps_next[start_idx:end])):
        if i % interval == 0:
            h, state = model.encode_with_state(x, t, tap)
        else:
            state = model.shallow_encode(x, t)
        eps = model.decode_with_state(h, state, tap)
        x = ddim_step(eps, x, alpha_bar(schedule, t),
                      alpha_bar(schedule, tn)).prev_sample
    return x


def ddim_forward_deepcache_cond(
    model,
    x: torch.Tensor,
    context: torch.Tensor,
    schedule: DiffusionSchedule,
    grid: TimestepGrid,
    interval: int = 3,
    start_idx: int = 0,
    end_idx: Optional[int] = None,
    added_cond=None,
    neg_context: Optional[torch.Tensor] = None,
    neg_added_cond=None,
    guidance_scale: float = 0.0,
) -> torch.Tensor:
    """Denoise x (NCHW, the model's layout) from grid index ``start_idx``
    to ``end_idx`` (None: to x0), refreshing the deep path every
    ``interval`` steps. With ``neg_context`` and ``guidance_scale`` > 1
    every ε is classifier-free guidance on one fused 2·B batch ([neg; cond]
    rows), and the cache covers both rows. ``added_cond`` (SDXL's
    (text_embeds, time_ids)) stacks its [neg; cond] rows the same way, the
    negative rows from ``neg_added_cond`` (default: ``added_cond``)."""
    n_up = len(model.up_blocks)
    if n_up < 2:
        raise ValueError("deepcache needs at least 2 up blocks")
    tap = TapPoint("up", n_up - 2)
    end = grid.num_steps if end_idx is None else end_idx

    b = x.shape[0]
    rows = lambda a: a.expand(b, *a.shape[1:])
    if neg_context is not None and guidance_scale > 1.0:
        ctx = torch.cat([rows(neg_context), rows(context)])
        if added_cond is not None:
            neg_added = added_cond if neg_added_cond is None else neg_added_cond
            added_cond = tuple(torch.cat([rows(n), rows(c)])
                               for n, c in zip(neg_added, added_cond))
        model_in = lambda z: torch.cat([z, z])

        def combine(eps):
            e_un, e_c = eps.chunk(2)
            return e_un + guidance_scale * (e_c - e_un)
    else:
        ctx = context
        model_in = combine = lambda a: a

    h = None
    for i, (t, tn) in enumerate(zip(grid.timesteps[start_idx:end],
                                    grid.timesteps_next[start_idx:end])):
        if i % interval == 0:
            h, state = model.encode_with_state(model_in(x), t, ctx, tap,
                                               added_cond)
        else:
            state = model.shallow_encode(model_in(x), t, ctx, added_cond)
        eps = combine(model.decode_with_state(h, state, tap))
        x = ddim_step(eps, x, alpha_bar(schedule, t),
                      alpha_bar(schedule, tn)).prev_sample
    return x
