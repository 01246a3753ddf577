"""Models of the SD 2.1-base path: U-Net, VAE, CLIP text tower."""

from __future__ import annotations

import torch
from torch import nn

from .clip_text import CLIPTextModel, HashTokenizer, load_tokenizer
from .configs import (
    CLIPTextConfig,
    UNet2DConditionConfig,
    VAEConfig,
    clip_text_tiny,
    sd21_base_unet,
    sd21_text_encoder,
    sd_tiny_unet,
    sd_vae,
    vae_tiny,
)
from .convert import load_flax_params
from .unet2d import TapPoint
from .unet2d_condition import UNet2DCondition
from .vae import AutoencoderKL


@torch.no_grad()
def random_init_(module: nn.Module, seed: int) -> nn.Module:
    """Deterministic random weights from ``seed`` (the offline stand-in for a
    checkpoint, like the JAX package's seeded init): LeCun-normal matrices
    and conv kernels, unit-variance-per-row embeddings, unit norm scales,
    zero biases. Drawn on the CPU, so a seed gives the same weights on any
    device."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            w = torch.zeros(p.shape)
        elif p.ndim == 1:
            w = torch.ones(p.shape)
        elif "embedding" in name:
            w = torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5
        else:
            w = torch.randn(p.shape, generator=gen) * (p[0].numel() ** -0.5)
        p.copy_(w)
    return module


__all__ = [
    "AutoencoderKL", "CLIPTextConfig", "CLIPTextModel", "HashTokenizer",
    "TapPoint", "UNet2DCondition", "UNet2DConditionConfig", "VAEConfig",
    "clip_text_tiny", "load_flax_params", "load_tokenizer", "random_init_",
    "sd21_base_unet", "sd21_text_encoder", "sd_tiny_unet", "sd_vae",
    "vae_tiny",
]
