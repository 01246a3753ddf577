"""Ring attention: exact attention with the sequence axis sharded over a
mesh axis ('sp').

Counterpart of diffusion_pullback_tpu/parallel/ring_attention.py. Every
rank of the 'sp' group takes its shard of the queries and of the keys and
values, computes the partial attention of its query shard against the K/V
shard it holds, passes K and V on around the ring (one ``ring_shift`` per
step, `batch_isend_irecv` over the group) and merges the partial outputs by
their row log-sum-exps, the online-softmax algebra of the flash kernel
applied across ranks. The merged shards are gathered, so the output is
replicated, as the JAX shard_map's is a whole array.

The 'xla' inner is the math path, differentiable in both modes through the
collectives' own rules (collectives.py), so the pullback's encoder can run
it ('ring_xla'). The 'flash' inner runs K2 (``flash_forward_lse``) per ring
step, primal only: the ported call site of the Pallas `_flash_forward_lse`
in the JAX ring. On a CUDA tensor K2 launches or raises.

The per-rank loop, ``ring_merge``, takes its query shard, the K/V shards in
ring order and the partial function, so the distributed call and a
one-process run over virtual shards (chip_smoke.py) run the same loop.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Optional, Tuple

import torch

from .collectives import gather, ring_shift, shard
from .mesh import axis_group, axis_names, axis_size

# The ambient mesh published by the drivers (experiments/_common.py), so
# model code, which knows only its attn_impl string, reaches the ring
_RING_MESH = None
_RING_AXIS: str = "sp"

# Engage the ring only when every shard keeps at least this many rows:
# below that the work is too small for the ring's round trips to pay, and
# short cross-attention contexts (77-token CLIP) stay dense
MIN_SHARD_TOKENS = 128

# True inside a sweep whose dp ranks hold different samples (dp_vmap, the
# drivers' dp harvests): the batch then must not co-shard over 'dp'
_DP_SPLIT = False


@contextlib.contextmanager
def dp_split():
    """The block's dp ranks hold different data: the ring keeps the batch
    whole on each of them."""
    global _DP_SPLIT
    old, _DP_SPLIT = _DP_SPLIT, True
    try:
        yield
    finally:
        _DP_SPLIT = old


def set_ring_mesh(mesh, axis: str = "sp") -> None:
    """Publish (or clear, with None) the mesh of ``attention(impl='ring')``."""
    global _RING_MESH, _RING_AXIS
    _RING_MESH = mesh
    _RING_AXIS = axis


def get_ring_mesh() -> Tuple[Optional[object], str]:
    return _RING_MESH, _RING_AXIS


def _partial_xla(q, k, v, scale):
    """Block-normalised partial attention and its row LSE, the math path
    (both modes differentiable). q: (B,Sq,H,D), k/v: (B,Sk,H,D) → o f32
    (B,Sq,H,D), lse f32 (B,Sq,H)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", (p / l).to(q.dtype).float(), v.float())
    return o, (m + torch.log(l))[..., 0].transpose(1, 2)


def _partial_flash(q, k, v, scale, forward_lse=None):
    """The same contract through K2 (``flash_forward_lse``, or
    ``forward_lse`` with its signature, e.g. K2's plain version), primal
    only."""
    if forward_lse is None:
        from ..ops.flash_attention import flash_forward_lse as forward_lse

    b, sq, h, d = q.shape
    sk = k.shape[1]
    fold = lambda x, s: x.transpose(1, 2).reshape(b * h, s, x.shape[-1])
    o, lse = forward_lse(fold(q, sq), fold(k, sk), fold(v, sk), scale)
    o = o.reshape(b, h, sq, d).transpose(1, 2).float()
    return o, lse.reshape(b, h, sq).transpose(1, 2)


def _block_divisor(s: int, cap: int = 512) -> int:
    b = min(cap, s)
    while s % b:
        b -= 1
    return b


def choose_inner(inner: str, q, sq_shard: int, sk_shard: int) -> str:
    """'auto' is the math path on the CPU and K2 on the card. On the CPU a
    flash inner whose shard's largest ≤ 512 block divisor is under 128 rows
    drops to the math path, as the JAX ring's Pallas K2 does; the card's K2
    masks its tail blocks and takes any shard."""
    if inner == "auto":
        inner = "xla" if q.device.type == "cpu" else "flash"
    if (inner == "flash" and q.device.type == "cpu"
            and min(_block_divisor(sq_shard), _block_divisor(sk_shard)) < 128):
        inner = "xla"
    if inner not in ("xla", "flash"):
        raise ValueError(f"unknown ring inner {inner!r}")
    return inner


def partial_fn(inner: str, scale: float) -> Callable:
    if inner == "flash":
        return lambda q, k, v: _partial_flash(q, k, v, scale)
    return lambda q, k, v: _partial_xla(q, k, v, scale)


def ring_merge(qs: torch.Tensor, kvs: Iterable, partial: Callable) -> torch.Tensor:
    """One rank's ring: the partial attention of the query shard ``qs``
    against each (k, v) shard of ``kvs`` in ring order, merged by L in f32
    (log-add-exp), cast back to q's dtype."""
    it = iter(kvs)
    o, lse = partial(qs, *next(it))
    for kr, vr in it:
        ob, lb = partial(qs, kr, vr)
        m = torch.logaddexp(lse, lb)
        o = o * torch.exp(lse - m)[..., None] + ob * torch.exp(lb - m)[..., None]
        lse = m
    return o.to(qs.dtype)


def _ring_stream(ks, vs, group, n):
    """The K/V shards this rank holds in ring order: its own, then each
    one received from the previous rank."""
    yield ks, vs
    for _ in range(n - 1):
        ks, vs = ring_shift(ks, group), ring_shift(vs, group)
        yield ks, vs


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None, *, mesh=None, axis: str = "sp",
                   inner: str = "auto") -> torch.Tensor:
    """Exact softmax(q kᵀ·scale) v with S sharded over the mesh's ``axis``.

    q: (B, Sq, H, D), k/v: (B, Sk, H, D), replicated → (B, Sq, H, D),
    replicated. Sq and Sk must divide by the axis size (the `ops.attention`
    dispatcher checks it and falls back to the dense path). When the mesh
    also has a 'dp' axis that divides B, the batch co-shards over it
    (outside ``dp_split``, where dp ranks hold different samples).

    inner: 'xla' (differentiable both modes) | 'flash' (K2 per ring step,
    primal only) | 'auto' (flash on the card).
    """
    if mesh is None:
        mesh, axis = get_ring_mesh()
    if mesh is None:
        raise ValueError("ring_attention needs a mesh (arg or set_ring_mesh)")
    n = axis_size(mesh, axis)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if sq % n or sk % n:
        raise ValueError(f"sequence ({sq},{sk}) not divisible by {axis}={n}")
    if scale is None:
        scale = d ** -0.5
    partial = partial_fn(choose_inner(inner, q, sq // n, sk // n), scale)

    dp = axis_size(mesh, "dp")
    dp_group = (axis_group(mesh, "dp") if "dp" in axis_names(mesh) and axis != "dp"
                and dp > 1 and b % dp == 0 and not _DP_SPLIT else None)
    if dp_group is not None:
        q, k, v = (shard(t, 0, dp_group) for t in (q, k, v))
    group = axis_group(mesh, axis)
    qs, ks, vs = (shard(t, 1, group) for t in (q, k, v))
    out = gather(ring_merge(qs, _ring_stream(ks, vs, group, n), partial), 1, group)
    return out if dp_group is None else gather(out, 0, dp_group)


def ring_attention_virtual(q, k, v, n: int, scale: Optional[float] = None,
                           inner: str = "auto", partial: Optional[Callable] = None
                           ) -> torch.Tensor:
    """``ring_attention`` over ``n`` virtual ranks in one process: each
    query shard runs ``ring_merge`` over the K/V shards in the order its
    rank would receive them (its own, then i − 1, i − 2, …). ``partial``
    replaces the inner's partial function (q, k, v) → (o, lse)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if sq % n or sk % n:
        raise ValueError(f"sequence ({sq},{sk}) not divisible by {n}")
    if partial is None:
        partial = partial_fn(choose_inner(inner, q, sq // n, sk // n),
                             d ** -0.5 if scale is None else scale)
    qs, ks, vs = (t.chunk(n, dim=1) for t in (q, k, v))
    return torch.cat([ring_merge(qs[i], [(ks[(i - j) % n], vs[(i - j) % n])
                                         for j in range(n)], partial)
                      for i in range(n)], dim=1)
