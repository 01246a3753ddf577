"""Spatial transformer blocks of the SD U-Net (NCHW in, tokens inside).

Counterpart of diffusion_pullback_tpu/models/transformer2d.py, with
diffusers' Transformer2DModel / BasicTransformerBlock parameter names
(attn1/attn2, to_q/to_k/to_v/to_out.0, ff.net.0.proj, ff.net.2,
proj_in/proj_out, norm1-3).

``remat`` (SDXL's ``remat_transformer``) recomputes each transformer block
in its backward, where JAX's nn.remat checkpoints it: ``_RematBlock``, an
autograd Function that saves only the block's inputs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .layers import GroupNorm, LayerNorm, attn_impl_as, project_qkv


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None."""

    fuse_qkv = True  # project_qkv's fuse

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
        q, k, v = project_qkv(x, context, self.to_q, self.to_k, self.to_v,
                              self.fuse_qkv)
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


class _RematBlock(torch.autograd.Function):
    """A BasicTransformerBlock call that saves only its inputs (x, context):
    forward runs the block under no_grad, backward recomputes it through
    torch.func.vjp, the forward-mode rule through torch.func.jvp, each with
    the attention impl the layers had at the call (the pullback switches it
    per call). Its vmap rule is generated, so probe-vmapped cotangents pass
    through the backward, where the fused pair's own vmap rules fold them
    into B·H. The block's weights are constants of the differentiation.
    (torch.utils.checkpoint is not the route: torch.func.vjp refuses its
    saved-tensor hooks.)"""

    generate_vmap_rule = True

    @staticmethod
    def forward(block, impl, x, context):
        with torch.no_grad(), attn_impl_as(block, impl):
            return block(x, context)

    @staticmethod
    def setup_context(ctx, inputs, output):
        block, impl, x, context = inputs
        ctx.block, ctx.impl = block, impl
        ctx.save_for_backward(x, context)
        ctx.save_for_forward(x, context)

    @staticmethod
    def backward(ctx, grad):
        x, context = ctx.saved_tensors
        with attn_impl_as(ctx.block, ctx.impl):
            _, vjp_fn = torch.func.vjp(ctx.block, x, context)
            dx, dcontext = vjp_fn(grad)
        return None, None, dx, dcontext

    @staticmethod
    def jvp(ctx, _dblock, _dimpl, dx, dcontext):
        x, context = ctx.saved_tensors
        zero = lambda t, p: torch.zeros_like(p) if t is None else t
        with attn_impl_as(ctx.block, ctx.impl):
            return torch.func.jvp(ctx.block, (x, context),
                                  (zero(dx, x), zero(dcontext, context)))[1]


def remat_block(block: BasicTransformerBlock, x, context):
    """``block(x, context)`` through ``_RematBlock`` where a reverse-mode
    graph is recorded (grad enabled, an input that requires grad). Calls
    that record none (sampling under no_grad, the pullback's forward-mode
    tangent passes) save no activations anyway and call the block
    directly: through the Function a jvp would run the block twice."""
    if torch.is_grad_enabled() and (x.requires_grad or context.requires_grad):
        return _RematBlock.apply(block, block.attn1.attn_impl, x, context)
    return block(x, context)


class Transformer2D(nn.Module):
    """GN → proj_in → transformer blocks → proj_out, residual around it all.
    ``use_linear_projection`` projects tokens with Linear (SD2.x), else
    1×1 convs (SD1.x). ``remat`` runs each block through ``remat_block``."""

    def __init__(self, in_channels: int, heads: int, head_dim: int,
                 context_dim: int, depth: int = 1,
                 use_linear_projection: bool = True,
                 norm_num_groups: int = 32, attn_impl: str = "xla",
                 remat: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.use_linear_projection, self.remat = use_linear_projection, remat
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
            x = remat_block(block, x, context) if self.remat else block(x, context)
        if self.use_linear_projection:
            x = self.proj_out(x).transpose(1, 2).reshape(b, c, h, w)
        else:
            x = self.proj_out(x.transpose(1, 2).reshape(b, -1, h, w))
        return x + residual
