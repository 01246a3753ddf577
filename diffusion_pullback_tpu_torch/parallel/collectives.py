"""The collectives of the port's mesh paths as differentiable ops.

The JAX package writes no collective: GSPMD inserts them where a sharded
layout meets an op that needs the whole tensor. A torch run is one process
per rank, every rank running the same program on replicated values, so the
port calls them itself. Each is a `torch.autograd.Function` with a
``setup_context``, a forward-mode rule (``jvp``), a reverse-mode rule
(``backward``) and a ``vmap`` rule that moves the vmapped axis into the
tensor and communicates once: the pullback runs ``vmap(jvp)`` and
``vmap(vjp)`` through them (its probes), and DTensor's parallel layers do
not compose with those transforms.

Values are replicated unless an op says otherwise, and so are their
tangents and cotangents: every rank of the group holds the same value and
runs the same program after it. The ops come in dual pairs:

    shard           own chunk along dim        backward: gather
    gather          all chunks, concatenated   backward: own chunk
    copy_to_region  identity (Megatron's f)    backward: all-reduce
    all_reduce      sum of the ranks' partials backward: identity (Megatron's g)
    ring_shift      rank i's value to i+step   backward: shift by −step

A collective that fails raises; nothing falls back to a local result.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _info(group):
    return dist.get_world_size(group), dist.get_rank(group)


def _all_gather(x, dim, group):
    n, _ = _info(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _own_chunk(x, dim, group):
    n, me = _info(group)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split over {n} ranks")
    return x.narrow(dim, me * (size // n), size // n).contiguous()


def _all_reduce(x, group):
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _shift(x, group, step):
    n, me = _info(group)
    if n == 1:
        return x
    ranks = dist.get_process_group_ranks(group)
    x = x.contiguous()
    recv = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(me + step) % n], group),
           dist.P2POp(dist.irecv, recv, ranks[(me - step) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _front(x, bdim):
    return x if bdim is None else x.movedim(bdim, 0)


def _shift_dim(dim, bdim):
    """``dim`` of an unbatched tensor in the tensor with a leading batch."""
    return dim if bdim is None or dim < 0 else dim + 1


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(x, dim, group):
        return _own_chunk(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.dim, ctx.group), None, None

    @staticmethod
    def jvp(ctx, t, _d, _g):
        return None if t is None else _Shard.apply(t, ctx.dim, ctx.group)

    @staticmethod
    def vmap(info, in_dims, x, dim, group):
        b = in_dims[0]
        return _Shard.apply(_front(x, b), _shift_dim(dim, b), group), (
            None if b is None else 0)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(x, dim, group):
        return _all_gather(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Shard.apply(g, ctx.dim, ctx.group), None, None

    @staticmethod
    def jvp(ctx, t, _d, _g):
        return None if t is None else _Gather.apply(t, ctx.dim, ctx.group)

    @staticmethod
    def vmap(info, in_dims, x, dim, group):
        b = in_dims[0]
        return _Gather.apply(_front(x, b), _shift_dim(dim, b), group), (
            None if b is None else 0)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None

    @staticmethod
    def jvp(ctx, t, _g):
        return t

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _CopyToRegion.apply(x, group), in_dims[0]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, t, _g):
        return None if t is None else _AllReduce.apply(t, ctx.group)

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _AllReduce.apply(x, group), in_dims[0]


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(x, group, step):
        return _shift(x, group, step)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.step = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _RingShift.apply(g, ctx.group, -ctx.step), None, None

    @staticmethod
    def jvp(ctx, t, _g, _s):
        return None if t is None else _RingShift.apply(t, ctx.group, ctx.step)

    @staticmethod
    def vmap(info, in_dims, x, group, step):
        return _RingShift.apply(x, group, step), in_dims[0]


def shard(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of the replicated ``x`` along ``dim``."""
    return _Shard.apply(x, dim, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's chunks of ``x``, concatenated along ``dim`` in rank
    order (replicated)."""
    return _Gather.apply(x, dim, group)


def copy_to_region(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering a tensor-parallel region: the identity, whose
    backward sums the ranks' partial gradients."""
    return _CopyToRegion.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of the ranks' partial ``x`` (replicated)."""
    return _AllReduce.apply(x, group)


def ring_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """Rank i's ``x`` on rank i + step of the group (modulo its size)."""
    return _RingShift.apply(x, group, step)


# ---- plain (undifferentiated) collectives of the drivers ---------------------

def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` stacked along dim 0 in rank order; no autograd."""
    return _all_gather(x, 0, group)


def from_first(x: torch.Tensor, group) -> torch.Tensor:
    """The group's first rank's ``x`` on every rank of the group."""
    x = x.contiguous()
    dist.broadcast(x, src=dist.get_process_group_ranks(group)[0], group=group)
    return x
