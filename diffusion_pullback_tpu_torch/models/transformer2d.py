"""Spatial transformer blocks of the SD U-Net (NCHW in, tokens inside).

Counterpart of diffusion_pullback_tpu/models/transformer2d.py, with
diffusers' Transformer2DModel / BasicTransformerBlock parameter names
(attn1/attn2, to_q/to_k/to_v/to_out.0, ff.net.0.proj, ff.net.2,
proj_in/proj_out, norm1-3).
"""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .layers import GroupNorm, LayerNorm, project_qkv


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, attn_impl: str = "xla"):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.attn_impl = heads, head_dim, attn_impl
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None):
        b, sq, _ = x.shape
        sk = sq if context is None else context.shape[1]
        q, k, v = project_qkv(x, context, self.to_q, self.to_k, self.to_v)
        out = attention(
            q.reshape(b, sq, self.heads, self.head_dim),
            k.reshape(b, sk, self.heads, self.head_dim),
            v.reshape(b, sk, self.heads, self.head_dim),
            impl=self.attn_impl,
        )
        return self.to_out[0](out.reshape(b, sq, self.heads * self.head_dim))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner_dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner_dim * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) GELU, as diffusers' GEGLU


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # diffusers layout: net.0 GEGLU, net.1 dropout (no parameters), net.2
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int,
                 attn_impl: str = "xla"):
        super().__init__()
        # Flax LayerNorm's epsilon (1e-6), as the JAX package
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(dim, heads, head_dim, attn_impl=attn_impl)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim,
                                    attn_impl=attn_impl)
        self.norm3 = LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GN → proj_in → transformer blocks → proj_out, residual around it all.
    ``use_linear_projection`` projects tokens with Linear (SD2.x), else
    1×1 convs (SD1.x)."""

    def __init__(self, in_channels: int, heads: int, head_dim: int,
                 context_dim: int, depth: int = 1,
                 use_linear_projection: bool = True,
                 norm_num_groups: int = 32, attn_impl: str = "xla"):
        super().__init__()
        inner = heads * head_dim
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        proj = ((lambda i, o: nn.Linear(i, o)) if use_linear_projection
                else (lambda i, o: nn.Conv2d(i, o, 1)))
        self.proj_in = proj(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, head_dim, context_dim,
                                  attn_impl=attn_impl)
            for _ in range(depth)
        ])
        self.proj_out = proj(inner, in_channels)

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if self.use_linear_projection:
            x = self.proj_in(x.flatten(2).transpose(1, 2))
        else:
            x = self.proj_in(x)
            x = x.flatten(2).transpose(1, 2)
        for block in self.transformer_blocks:
            x = block(x, context)
        if self.use_linear_projection:
            x = self.proj_out(x).transpose(1, 2).reshape(b, c, h, w)
        else:
            x = self.proj_out(x.transpose(1, 2).reshape(b, -1, h, w))
        return x + residual
