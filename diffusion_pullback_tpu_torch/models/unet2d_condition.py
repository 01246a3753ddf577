"""Text-conditioned 2-D U-Net (Stable Diffusion family) with feature taps.

Counterpart of diffusion_pullback_tpu/models/unet2d_condition.py: the same
blocks, ``forward`` (ε) and ``encode`` (the activation at a `TapPoint`),
NCHW inside, diffusers parameter names (down_blocks.i.resnets.j,
.attentions.j, .downsamplers.0.conv, mid_block, up_blocks, time_embedding,
conv_in/conv_norm_out/conv_out).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .configs import UNet2DConditionConfig
from .layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock,
    TimestepEmbedMLP,
    Upsample2D,
    timestep_embedding,
)
from .transformer2d import Transformer2D
from .unet2d import TapPoint


class DownBlock(nn.Module):
    """Resnets (each followed by a transformer when ``transformer`` builds
    one), then an optional stride-2 downsampler. Returns (h, skips)."""

    def __init__(self, in_ch, out_ch, num_layers, temb_ch, add_downsample,
                 groups, eps, dropout, transformer=None):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_ch if i == 0 else out_ch, out_ch, temb_ch, groups,
                        eps, dropout)
            for i in range(num_layers)
        ])
        if transformer is not None:
            self.attentions = nn.ModuleList(
                [transformer(out_ch) for _ in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_ch)])
                             if add_downsample else None)

    def forward(self, x, temb, context):
        res = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res.append(x)
        return x, res


class UpBlock(nn.Module):
    """Resnets over [h; skip] (each followed by a transformer when
    ``transformer`` builds one), then an optional 2× upsampler."""

    def __init__(self, in_ch, prev_out_ch, out_ch, num_layers, temb_ch,
                 add_upsample, groups, eps, dropout, transformer=None):
        super().__init__()
        # diffusers' channel bookkeeping of the skip connections
        self.resnets = nn.ModuleList([
            ResnetBlock((prev_out_ch if i == 0 else out_ch)
                        + (in_ch if i == num_layers - 1 else out_ch),
                        out_ch, temb_ch, groups, eps, dropout)
            for i in range(num_layers)
        ])
        if transformer is not None:
            self.attentions = nn.ModuleList(
                [transformer(out_ch) for _ in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_ch)])
                           if add_upsample else None)

    def forward(self, x, res_samples, temb, context):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, res_samples[-1 - i]], dim=1), temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class CrossAttnMidBlock(nn.Module):
    def __init__(self, channels, temb_ch, groups, eps, dropout, transformer):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, temb_ch, groups, eps, dropout)
            for _ in range(2)
        ])
        self.attentions = nn.ModuleList([transformer(channels)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNet2DConditionConfig):
        super().__init__()
        cfg = self.config = config
        ch = cfg.block_out_channels
        n = len(ch)
        temb_ch = 4 * ch[0]
        head_dims = (tuple(cfg.attention_head_dim)
                     if isinstance(cfg.attention_head_dim, (tuple, list))
                     else (cfg.attention_head_dim,) * n)
        norm = dict(groups=cfg.norm_num_groups, eps=cfg.norm_eps,
                    dropout=cfg.dropout)

        def transformer(i):
            return lambda c: Transformer2D(
                c, cfg.attention_heads[i], head_dims[i],
                cfg.cross_attention_dim, depth=cfg.transformer_depth[i],
                use_linear_projection=cfg.use_linear_projection,
                norm_num_groups=cfg.norm_num_groups, attn_impl=cfg.attn_impl)

        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedMLP(ch[0], temb_ch)
        self.down_blocks = nn.ModuleList([
            DownBlock(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block, temb_ch,
                      i < n - 1, **norm,
                      transformer=transformer(i) if bt == "cross" else None)
            for i, bt in enumerate(cfg.down_block_types)
        ])
        self.mid_block = CrossAttnMidBlock(ch[-1], temb_ch, **norm,
                                           transformer=transformer(n - 1))
        rev = tuple(reversed(ch))
        self.up_blocks = nn.ModuleList([
            UpBlock(rev[min(i + 1, n - 1)], rev[max(i - 1, 0)], rev[i],
                    cfg.layers_per_block + 1, temb_ch, i < n - 1, **norm,
                    transformer=(transformer(n - 1 - i) if bt == "cross"
                                 else None))
            for i, bt in enumerate(cfg.up_block_types)
        ])
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0],
                                          eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)
        self.to(getattr(torch, cfg.dtype))

    # ---- internals --------------------------------------------------------

    def _prologue(self, x, t, context):
        """(h after conv_in, time embedding, context at x's batch)."""
        dtype = self.conv_in.weight.dtype
        # contiguous: torch.func's batched group_norm views its input
        x = x.to(dtype).contiguous()
        context = context.to(dtype)
        if context.shape[0] == 1 and x.shape[0] > 1:
            context = context.expand(x.shape[0], *context.shape[1:])
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        if t.ndim == 0:
            t = t.expand(x.shape[0])
        feat = timestep_embedding(t, self.config.block_out_channels[0],
                                  self.config.flip_sin_to_cos,
                                  self.config.freq_shift)
        return self.conv_in(x), self.time_embedding(feat.to(dtype)), context

    def _up(self, h, skips, emb, context, stop_at=None):
        n_res = self.config.layers_per_block + 1
        for i, block in enumerate(self.up_blocks):
            res, skips = skips[-n_res:], skips[:-n_res]
            h = block(h, res, emb, context)
            if i == stop_at:
                break
        return h

    # ---- public -----------------------------------------------------------

    def forward(self, x, t, encoder_hidden_states):
        """ε(x, t | context). x: (B, C, H, W); t: scalar or (B,)."""
        h, emb, ctx = self._prologue(x, t, encoder_hidden_states)
        skips = [h]
        for block in self.down_blocks:
            h, res = block(h, emb, ctx)
            skips += res
        h = self.mid_block(h, emb, ctx)
        h = self._up(h, skips, emb, ctx)
        return self.conv_out(F.silu(self.conv_norm_out(h)))

    def encode(self, x, t, encoder_hidden_states, tap: TapPoint):
        """The activation at ``tap`` (only the sub-graph up to it runs)."""
        tap = TapPoint(*tap).validate(len(self.down_blocks), len(self.up_blocks))
        h, emb, ctx = self._prologue(x, t, encoder_hidden_states)
        skips = [h]
        for i, block in enumerate(self.down_blocks):
            h, res = block(h, emb, ctx)
            if tap.op == "down" and tap.block_idx == i:
                return h
            skips += res
        h = self.mid_block(h, emb, ctx)
        if tap.op == "mid":
            return h
        return self._up(h, skips, emb, ctx, stop_at=tap.block_idx)
