"""Attention with switchable implementations (layout (B, S, H, D)).

Counterpart of diffusion_pullback_tpu/ops/attention.py. 'xla' is the math
path: explicit matmuls with the softmax in float32, which torch.func.jvp /
vjp / vmap differentiate (it never calls F.scaled_dot_product_attention).
'blockwise' is the math path as an online softmax over key blocks, whose
logits never exceed (Sq, block_k); 'auto' takes it from 1024 tokens on and
the math path below. 'flash' and 'flash_jvp' route long self-attention to
the fused kernels and everything else to the math path: 'flash' is the
reverse-mode entry (K1, or K2 with K4/K5 as its backward), 'flash_jvp' the
forward-mode one (K2 with K3 as its tangent rule). 'ring' is sequence
parallel over the mesh published by parallel.ring_attention.set_ring_mesh
(an 'sp' axis): K2 per ring step on the card, the math path on the CPU;
'ring_xla' keeps the math inner everywhere, for the differentiated encoder.
Where the ring does not engage, 'ring' on the card falls back to 'flash'.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention import flash_attention, flash_attention_jvp


def xla_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v with f32 logits and softmax.
    q: (B, Sq, H, D), k/v: (B, Sk, H, D) → (B, Sq, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dtype = q.dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(), v.float())
    return out.to(dtype)


def blockwise_attention(q, k, v, scale: Optional[float] = None,
                        block_k: int = 1024) -> torch.Tensor:
    """softmax(q kᵀ · scale) v by an online softmax over key blocks of
    ``block_k`` (running max, normaliser and f32 accumulator), built from
    ordinary ops so torch.func differentiates it in both modes. A key length
    that ``block_k`` does not divide takes its largest divisor below it;
    when that falls under max(64, block_k // 8), and at sk ≤ block_k, the
    dense math path runs instead."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if sk <= block_k:
        return xla_attention(q, k, v, scale)
    if sk % block_k:
        bk = block_k
        while sk % bk:
            bk -= 1
        if bk < max(64, block_k // 8):
            return xla_attention(q, k, v, scale)
        block_k = bk
    dtype, qf = q.dtype, q.float()
    m = torch.full((b, h, sq, 1), -math.inf, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, sq, h, d), device=q.device)
    for kb, vb in zip(k.split(block_k, dim=1), v.split(block_k, dim=1)):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(dtype).float(), vb.float())
        acc = acc * corr.transpose(1, 2) + pv
        m = m_new
    return (acc / l.transpose(1, 2)).to(dtype)


def attention(q, k, v, scale: Optional[float] = None,
              impl: str = "xla") -> torch.Tensor:
    """'xla': the math path. 'blockwise': ``blockwise_attention``. 'auto':
    blockwise when sq and sk are both ≥ 1024, else the math path. 'flash' /
    'flash_jvp': the fused kernels when sq ≥ 1024, sk ≥ 128 and both divide
    by min(512, s); the math path otherwise (e.g. the 77-token
    cross-attention). 'ring' / 'ring_xla': ``ring_attention`` (K2 or the
    math path per step; the math path for 'ring_xla') when the published
    mesh's 'sp' axis is > 1, divides sq and sk and leaves shards of at least
    MIN_SHARD_TOKENS rows. Otherwise 'ring' on a CUDA tensor takes the
    'flash' dispatch (K1 where its rule allows), and on the CPU, as
    'ring_xla' everywhere, the 'auto' rule (blockwise from 1024 tokens, the
    math path below), the JAX dispatcher's fallback."""
    if impl == "xla":
        return xla_attention(q, k, v, scale)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, scale)
    if impl == "auto":
        if q.shape[1] >= 1024 and k.shape[1] >= 1024:
            return blockwise_attention(q, k, v, scale)
        return xla_attention(q, k, v, scale)
    if impl in ("flash", "flash_jvp"):
        sq, sk = q.shape[1], k.shape[1]
        bq, bk = min(512, sq), min(512, sk)
        if sq < 1024 or sk < 128 or sq % bq or sk % bk:
            return xla_attention(q, k, v, scale)
        if impl == "flash":
            return flash_attention(q, k, v, scale)
        return flash_attention_jvp(q, k, v, scale)
    if impl in ("ring", "ring_xla"):
        # the ring when a mesh with an 'sp' axis is published and the
        # sequence splits into shards of MIN_SHARD_TOKENS rows or more
        from ..parallel.mesh import axis_size
        from ..parallel.ring_attention import (MIN_SHARD_TOKENS, get_ring_mesh,
                                               ring_attention)

        mesh, axis = get_ring_mesh()
        n = axis_size(mesh, axis)
        sq, sk = q.shape[1], k.shape[1]
        if n > 1 and sq % n == 0 and sk % n == 0 and min(sq, sk) // n >= MIN_SHARD_TOKENS:
            return ring_attention(q, k, v, scale, mesh=mesh, axis=axis,
                                  inner="xla" if impl == "ring_xla" else "auto")
        if impl == "ring" and q.device.type == "cuda":
            # on the card the primal falls back to the kernels' dispatch
            return attention(q, k, v, scale, impl="flash")
        # the JAX dispatcher's fallback; 'ring_xla' is differentiated in
        # both modes, which neither fused entry carries alone
        return attention(q, k, v, scale, impl="auto")
    raise ValueError(f"unknown attention impl: {impl!r} (the port has 'xla', "
                     f"'blockwise', 'auto', 'flash', 'flash_jvp', 'ring' and "
                     f"'ring_xla')")
