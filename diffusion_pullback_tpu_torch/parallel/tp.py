"""Tensor parallelism in the Megatron layout for the U-Net and transformer
families.

Counterpart of diffusion_pullback_tpu/parallel/tp.py. The JAX package
annotates the parameter layout and lets GSPMD propagate it through the
unchanged forward; here each rank holds explicit local slices and the
layers call the collectives (collectives.py): a column-parallel layer
(output features sharded: to_q, to_k, to_v, GEGLU's proj, proj_in) enters
its region through ``copy_to_region``, a row-parallel layer (input features
sharded: to_out.0, ff.net.2, proj_out) sums its partial products with
``all_reduce`` and adds its bias once, after the sum. Between the two, an
attention block runs heads/tp local heads and a feed-forward block the
local slice of its inner width.

Where GSPMD is right by construction and explicit slices are not:

* GEGLU's fused ``proj`` holds the value half and the gate half; a
  contiguous split would put them on different ranks, so each half is
  split apart and a rank holds its slice of both.
* An attention block whose heads do not divide by tp (SD 2.1-base has 5
  at level 1, a VAE or DDPM block one head over all channels) stays
  replicated: a local slice must hold whole heads. GSPMD shards its
  projections and reshards around the heads' reshape; this is the port's
  departure, and ``tp_param_specs`` marks such blocks' leaves unsharded.
* ``project_qkv`` fuses q, k and v into one product; a sharded attention
  block gets ``fuse_qkv`` False (as the JAX package turns it off under
  TP), so each projection runs on its own, each entering the region.

proj_in (column-parallel) is gathered after it and proj_out (row-parallel)
takes its rank's slice of a replicated input, since the transformer's
residual stream between them is replicated.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .collectives import all_reduce, copy_to_region, gather, shard
from .mesh import axis_group, axis_size

# module names whose output features shard over 'tp' (column-parallel) and
# whose input features do (row-parallel), in diffusers' names: the JAX
# layout's; _plan picks among them by the owning block's structure
COLUMN_PARALLEL = frozenset({"to_q", "to_k", "to_v", "proj", "proj_in"})
ROW_PARALLEL = frozenset({"to_out.0", "net.2", "proj_out"})


def _features(layer: nn.Module, dim: int) -> int:
    return layer.weight.shape[dim]


def _plan(model: nn.Module, tp: int) -> Dict[str, tuple]:
    """Module name → (kind, options) of every layer that shards: kind
    'column' or 'row'; options: 'halves' (GEGLU's proj), 'gather' (output
    gathered), 'shard_in' (a replicated input sliced)."""
    from ..models.layers import SelfAttention2D
    from ..models.transformer2d import GEGLU, CrossAttention, FeedForward

    plan = {}
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, (CrossAttention, SelfAttention2D)):
            if m.heads % tp == 0 and _features(m.to_q, 0) % tp == 0:
                for p in ("to_q", "to_k", "to_v"):
                    plan[pre + p] = ("column", ())
                plan[pre + "to_out.0"] = ("row", ())
        elif isinstance(m, FeedForward):
            geglu = m.net[0]
            if isinstance(geglu, GEGLU) and _features(geglu.proj, 0) % (2 * tp) == 0:
                plan[pre + "net.0.proj"] = ("column", ("halves",))
                plan[pre + "net.2"] = ("row", ())
        elif name.rsplit(".", 1)[-1] == "proj_in" and _features(m, 0) % tp == 0:
            plan[name] = ("column", ("gather",))
        elif name.rsplit(".", 1)[-1] == "proj_out" and _features(m, 1) % tp == 0:
            plan[name] = ("row", ("shard_in",))
    return plan


def tp_param_specs(model: nn.Module, mesh, axis: str = "tp") -> Dict[str, Optional[int]]:
    """Parameter name → the dim its local slice is taken along (None:
    replicated): the Megatron layout of every attention / feed-forward /
    projection layer whose features divide by mesh's ``axis`` (and, for an
    attention block, whose heads do). The names and shapes are those of
    the unsharded ``model``."""
    plan = _plan(model, axis_size(mesh, axis))
    specs = {}
    for name, _ in model.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        kind = plan.get(owner, (None,))[0]
        if kind == "column":
            specs[name] = 0
        elif kind == "row" and leaf == "weight":
            specs[name] = 1
        else:
            specs[name] = None
    return specs


def tp_sharded_leaf_count(specs: Dict[str, Optional[int]]) -> int:
    """How many parameters shard (diagnostics and tests)."""
    return sum(1 for d in specs.values() if d is not None)


class TPLayer(nn.Module):
    """A Linear or 1×1 conv of a tensor-parallel region holding this rank's
    slice of its weights (under the layer's own parameter names).
    'column': its output features, entered through copy_to_region and, with
    'gather', gathered after; 'halves': each half of the output features
    sliced apart (GEGLU). 'row': its input features, from a sharded input
    (or, with 'shard_in', this rank's slice of a replicated one), the
    partial products all-reduced and the bias added after."""

    def __init__(self, layer: nn.Module, group, kind: str, options=()):
        super().__init__()
        n, me = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
        self.group, self.kind, self.options = group, kind, tuple(options)
        self.conv = layer.weight.ndim > 2
        own = lambda t, dim: t.chunk(n, dim=dim)[me]
        w, b = layer.weight.detach(), layer.bias
        b = None if b is None else b.detach()
        if kind == "column":
            if "halves" in options:
                halves = lambda t: torch.cat([own(h, 0) for h in t.chunk(2, dim=0)])
                w, b = halves(w), None if b is None else halves(b)
            else:
                w, b = own(w, 0), None if b is None else own(b, 0)
        else:
            w = own(w, 1)
        grad = layer.weight.requires_grad
        self.weight = nn.Parameter(w.clone(), requires_grad=grad)
        self.bias = None if b is None else nn.Parameter(b.clone(), requires_grad=grad)

    def _apply_weight(self, x, bias):
        if self.conv:
            return F.conv2d(x, self.weight, bias)
        return F.linear(x, self.weight, bias)

    def forward(self, x):
        fdim = 1 if self.conv else -1
        if self.kind == "column":
            y = self._apply_weight(copy_to_region(x, self.group), self.bias)
            return gather(y, fdim, self.group) if "gather" in self.options else y
        if "shard_in" in self.options:
            x = shard(x, fdim, self.group)
        y = all_reduce(self._apply_weight(x, None), self.group)
        if self.bias is None:
            return y
        return y + (self.bias[:, None, None] if self.conv else self.bias)


def tp_shard_params(model: nn.Module, mesh, axis: str = "tp") -> nn.Module:
    """Put ``model`` onto its tensor-parallel layout in place: every layer
    of ``tp_param_specs`` becomes a TPLayer holding this rank's slice, and
    the sharded attention blocks run heads/tp heads, their projections
    unfused. Returns the model."""
    tp = axis_size(mesh, axis)
    if tp == 1:
        return model
    group = axis_group(mesh, axis)
    plan = _plan(model, tp)
    for name, (kind, options) in plan.items():
        parent_name, _, leaf = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        layer = parent.get_submodule(leaf) if not leaf.isdigit() else parent[int(leaf)]
        tp_layer = TPLayer(layer, group, kind, options)
        if leaf.isdigit():
            parent[int(leaf)] = tp_layer
        else:
            setattr(parent, leaf, tp_layer)
        if leaf == "to_q":
            parent.heads //= tp
            parent.fuse_qkv = False
    return model
