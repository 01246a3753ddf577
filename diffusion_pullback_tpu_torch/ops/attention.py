"""Attention with switchable implementations (layout (B, S, H, D)).

Counterpart of diffusion_pullback_tpu/ops/attention.py for 'xla', 'flash'
and 'flash_jvp'. 'xla' is the math path: explicit matmuls with the softmax
in float32, which torch.func.jvp / vjp / vmap differentiate (it never calls
F.scaled_dot_product_attention). 'flash' and 'flash_jvp' route long
self-attention to the fused kernels and everything else to the math path:
'flash' is the reverse-mode entry (K1, or K2 with K4/K5 as its backward),
'flash_jvp' the forward-mode one (K2 with K3 as its tangent rule).
"""

from __future__ import annotations

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


def attention(q, k, v, scale: Optional[float] = None,
              impl: str = "xla") -> torch.Tensor:
    """'xla': the math path. 'flash' / 'flash_jvp': the fused kernels when
    sq ≥ 1024, sk ≥ 128 and both divide by min(512, s); the math path
    otherwise (e.g. the 77-token cross-attention)."""
    if impl == "xla":
        return xla_attention(q, k, v, scale)
    if impl in ("flash", "flash_jvp"):
        sq, sk = q.shape[1], k.shape[1]
        bq, bk = min(512, sq), min(512, sk)
        if sq < 1024 or sk < 128 or sq % bq or sk % bk:
            return xla_attention(q, k, v, scale)
        if impl == "flash":
            return flash_attention(q, k, v, scale)
        return flash_attention_jvp(q, k, v, scale)
    raise ValueError(f"attention impl {impl!r} is not ported "
                     f"(the port has 'xla', 'flash' and 'flash_jvp')")
