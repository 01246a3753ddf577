"""Building blocks of the SD U-Net and VAE (NCHW).

Counterpart of diffusion_pullback_tpu/models/layers.py. Parameters carry
diffusers names (norm1, conv1, time_emb_proj, to_q, to_out.0, ...), so a
diffusers state dict loads with no renaming. Norm epsilons follow the JAX
package, which is the reference of this port.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention


class GroupNorm(nn.GroupNorm):
    """GroupNorm computed in float32 and returned in the input's dtype, as
    Flax's norms compute their statistics in float32. It also keeps a bf16
    model's forward-mode tangents in bf16: on CUDA the bf16 norm kernels
    keep float32 statistics, and their JVP would return float32 tangents
    that the next bf16 matmul refuses. The input is made contiguous:
    torch.func's batched group_norm views it, which a channels-last
    activation (a transformer's output) with more than one sample
    refuses."""

    def forward(self, x):
        xf = x.to(torch.float32, memory_format=torch.contiguous_format)
        return F.group_norm(xf, self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in float32, returned in the input's dtype (see
    GroupNorm)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def project_qkv(x: torch.Tensor, context: Optional[torch.Tensor],
                to_q: nn.Linear, to_k: nn.Linear, to_v: nn.Linear, fuse: bool = True):
    """q/k/v projections with same-operand matmuls fused into one: one
    (…, C)×(C, 3·inner) product for self-attention, one k/v product over
    the context for cross-attention. Each output column sees exactly the
    weights it would unfused. ``fuse`` False runs them one by one (the
    attention modules' ``fuse_qkv``, which tensor parallelism turns off as
    the JAX package does)."""
    if not fuse:
        src = x if context is None else context
        return to_q(x), to_k(src), to_v(src)
    cat = lambda *ts: None if ts[0] is None else torch.cat(ts)
    if context is None:
        qkv = F.linear(x, cat(to_q.weight, to_k.weight, to_v.weight),
                       cat(to_q.bias, to_k.bias, to_v.bias))
        return qkv.chunk(3, dim=-1)
    kv = F.linear(context, cat(to_k.weight, to_v.weight),
                  cat(to_k.bias, to_v.bias))
    k, v = kv.chunk(2, dim=-1)
    return to_q(x), k, v


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = False,
                       downscale_freq_shift: float = 1.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features (diffusers' get_timestep_embedding).
    timesteps: (B,) → (B, dim) float32."""
    half_dim = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    if flip_sin_to_cos:
        emb = torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    else:
        emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedMLP(nn.Module):
    """Two-layer MLP lifting sinusoidal features to the conditioning vector."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, t_feat):
        return self.linear_2(F.silu(self.linear_1(t_feat)))


class ResnetBlock(nn.Module):
    """GN → silu → conv → (+temb) → GN → silu → dropout → conv, with skip."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int], norm_num_groups: int = 32,
                 eps: float = 1e-6, dropout: float = 0.0):
        super().__init__()
        self.norm1 = GroupNorm(norm_num_groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels else None)
        self.norm2 = GroupNorm(norm_num_groups, out_channels, eps=eps)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.dropout(F.silu(self.norm2(h))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class SelfAttention2D(nn.Module):
    """Spatial self-attention with a residual add; one head over all
    channels when ``num_head_channels`` is None (the VAE mid-block)."""

    fuse_qkv = True  # project_qkv's fuse

    def __init__(self, channels: int, num_head_channels: Optional[int] = None,
                 norm_num_groups: int = 32, eps: float = 1e-6,
                 attn_impl: str = "xla"):
        super().__init__()
        self.heads = 1 if num_head_channels is None else channels // num_head_channels
        self.attn_impl = attn_impl
        self.group_norm = GroupNorm(norm_num_groups, channels, eps=eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, hgt, wid = x.shape
        h = self.group_norm(x).flatten(2).transpose(1, 2)  # (B, HW, C)
        q, k, v = project_qkv(h, None, self.to_q, self.to_k, self.to_v, self.fuse_qkv)
        # q's width: c, or c/tp with heads/tp heads under tensor parallelism
        shape4 = (b, hgt * wid, self.heads, q.shape[-1] // self.heads)
        out = attention(q.reshape(shape4), k.reshape(shape4),
                        v.reshape(shape4), impl=self.attn_impl)
        out = self.to_out[0](out.reshape(b, hgt * wid, q.shape[-1]))
        return x + out.transpose(1, 2).reshape(b, c, hgt, wid)


class Downsample2D(nn.Module):
    """Stride-2 3×3 conv, padding 1; with ``asymmetric`` (the original DDPM
    nets) the input is padded by one row and column at the bottom and right
    and the conv pads nothing."""

    def __init__(self, channels: int, asymmetric: bool = False):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = nn.Conv2d(channels, channels, 3, stride=2,
                              padding=0 if asymmetric else 1)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.asymmetric else x)


class Upsample2D(nn.Module):
    """Nearest-neighbour 2× upsample followed by a 3×3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


@contextlib.contextmanager
def attn_impl_as(module: nn.Module, impl: str):
    """Run ``module`` with every attention layer set to ``impl`` (the same
    weights under another kernel), restoring the old setting on exit."""
    layers = [m for m in module.modules() if hasattr(m, "attn_impl")]
    old = [m.attn_impl for m in layers]
    for m in layers:
        m.attn_impl = impl
    try:
        yield module
    finally:
        for m, o in zip(layers, old):
            m.attn_impl = o
