"""AutoencoderKL — the SD latent VAE (NCHW).

Counterpart of diffusion_pullback_tpu/models/vae.py, with diffusers
parameter names (encoder.down_blocks.i.resnets.j, .downsamplers.0.conv,
mid_block.attentions.0, quant_conv, post_quant_conv, ...).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .configs import VAEConfig
from .layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock,
    SelfAttention2D,
    Upsample2D,
)


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, groups: int, attn_impl: str):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(channels, channels, None, groups) for _ in range(2)])
        self.attentions = nn.ModuleList(
            [SelfAttention2D(channels, None, groups, attn_impl=attn_impl)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _Stage(nn.Module):
    """One resolution of the encoder or decoder: resnets, then an optional
    down- or upsampler (diffusers' DownEncoderBlock2D / UpDecoderBlock2D)."""

    def __init__(self, in_ch, out_ch, num_layers, groups, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_ch if i == 0 else out_ch, out_ch, None, groups)
            for i in range(num_layers)
        ])
        if sampler == "down":
            self.downsamplers = nn.ModuleList([Downsample2D(out_ch)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        for sampler in getattr(self, "downsamplers", getattr(self, "upsamplers", ())):
            x = sampler(x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _Stage(ch[max(i - 1, 0)], c, cfg.layers_per_block, g,
                   "down" if i < len(ch) - 1 else None)
            for i, c in enumerate(ch)
        ])
        self.mid_block = VAEMidBlock(ch[-1], g, cfg.attn_impl)
        self.conv_norm_out = GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0], g, cfg.attn_impl)
        self.up_blocks = nn.ModuleList([
            _Stage(rev[max(i - 1, 0)], c, cfg.layers_per_block + 1, g,
                   "up" if i < len(rev) - 1 else None)
            for i, c in enumerate(rev)
        ])
        self.conv_norm_out = GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                    2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)
        self.to(getattr(torch, config.dtype))

    def encode_moments(self, x):
        """(mean, logvar) of the latent posterior."""
        x = x.to(self.quant_conv.weight.dtype)
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x, generator: Optional[torch.Generator] = None):
        """Latent sampled with ``generator`` (the mean when None), scaled by
        scaling_factor. x: (B, 3, H, W) in [-1, 1]."""
        mean, logvar = self.encode_moments(x)
        if generator is not None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=generator.device).to(mean)
            mean = mean + torch.exp(0.5 * logvar) * noise
        return mean * self.config.scaling_factor

    def decode(self, z):
        """Scaled latent → image (undoes scaling_factor)."""
        z = z.to(self.post_quant_conv.weight.dtype) / self.config.scaling_factor
        return self.decoder(self.post_quant_conv(z))
