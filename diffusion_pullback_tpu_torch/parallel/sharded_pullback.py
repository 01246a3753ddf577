"""The probe-sharded pullback and the dp sweep.

Counterpart of diffusion_pullback_tpu/parallel/sharded_pullback.py. The
probes of the subspace iteration are its parallel axis: each probe's
tangent and cotangent passes are independent, and only the r×r SVD step
couples them. Over a mesh's 'probe' axis each rank runs r/n of them and
the (r, dim_x) iterate is gathered once per iteration
(``local_pullback(probe_group=…)``, where the JAX package constrains the
iterate's sharding and lets GSPMD split the vmapped passes).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..geometry.pullback import PullbackResult, local_pullback
from .collectives import gather_rows
from .mesh import axis_group, axis_size
from .ring_attention import dp_split


def make_sharded_pullback(fn: Callable, mesh, probe_axis: str = "probe",
                          pca_rank: int = 50, fn_vjp: Callable = None,
                          **kwargs) -> Callable:
    """A reusable probe-sharded pullback runner.

    ``fn(z, *fn_args)`` maps a sample to the tapped feature tensor;
    ``fn_args`` (weights, prompt embeddings, timestep, …) are passed
    through. Returns ``runner(x, generator, *fn_args) -> PullbackResult``,
    the torch generator in place of the JAX key. ``pca_rank`` must divide
    by the probe axis's size. The sample and the result are whole on every
    rank, vT included (the JAX runner returns vT probe-sharded).
    """
    n = axis_size(mesh, probe_axis)
    if pca_rank % n != 0:
        raise ValueError(f"pca_rank {pca_rank} not divisible by probe axis size {n}")
    group = axis_group(mesh, probe_axis)

    def runner(x, generator, *fn_args):
        return local_pullback(
            lambda v: fn(v, *fn_args), x, generator, pca_rank=pca_rank,
            probe_group=group,
            fn_vjp=(lambda v: fn_vjp(v, *fn_args)) if fn_vjp is not None else None,
            **kwargs)

    return runner


def sharded_local_pullback(fn: Callable[[torch.Tensor], torch.Tensor],
                           x: torch.Tensor, generator, mesh, probe_axis: str = "probe",
                           pca_rank: int = 50, **kwargs) -> PullbackResult:
    """One-shot ``make_sharded_pullback`` for an ``fn`` already closed over
    its weights."""
    return make_sharded_pullback(fn, mesh, probe_axis=probe_axis, pca_rank=pca_rank,
                                 **kwargs)(x, generator)


def _stack(outs):
    """Per-item results (tensors, numbers, NamedTuples of them) stacked
    along a new leading axis."""
    first = outs[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack([o[i] for o in outs]) for i in range(len(first))))
    return torch.stack([torch.as_tensor(o) for o in outs])


def _gather_tree(tree, group, device):
    if isinstance(tree, tuple):
        return type(tree)(*(_gather_tree(t, group, device) for t in tree))
    return gather_rows(tree.to(device), group)


def dp_vmap(fn: Callable, mesh, axis_name: str = "dp") -> Callable:
    """Data-parallel map: ``run(*args)`` applies ``fn`` to each index of the
    arguments' leading axis, each rank of the mesh's ``axis_name`` taking a
    contiguous share of it in turn, and returns the per-item results
    stacked (tensors, numbers and NamedTuples of them, e.g. a
    PullbackResult) and gathered, whole on every rank. The leading axis
    must divide by the axis size. The items run one after another on a
    rank (``fn`` may loop on data, as the pullback does), where the JAX
    package vmaps them."""
    n = axis_size(mesh, axis_name)
    group = axis_group(mesh, axis_name)

    def run(*args):
        total = args[0].shape[0]
        if total % n:
            raise ValueError(f"{total} items do not split over {axis_name}={n}")
        per, me = total // n, torch.distributed.get_rank(group)
        with dp_split():
            outs = [fn(*(a[i] for a in args)) for i in range(me * per, (me + 1) * per)]
        return _gather_tree(_stack(outs), group, args[0].device)

    return run
