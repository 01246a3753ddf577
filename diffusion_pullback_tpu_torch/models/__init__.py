"""Models of the ported paths: the SD 2.1-base U-Net, VAE and CLIP text
tower, and the DDPM-family UNet2D."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .clip_text import CLIPTextModel, HashTokenizer, load_tokenizer
from .configs import (
    CLIPTextConfig,
    UNet2DConditionConfig,
    UNet2DConfig,
    VAEConfig,
    clip_text_tiny,
    ddpm_celebahq_256,
    ddpm_ema_bedroom_256,
    ddpm_ema_church_256,
    ddpm_ema_ffhq_256,
    ddpm_tiny,
    sd21_base_unet,
    sd21_text_encoder,
    sd_tiny_unet,
    sd_vae,
    sdedit_celeba_256,
    vae_tiny,
)
from .convert import load_flax_params
from .unet2d import TapPoint, TapState, UNet2D
from .unet2d_condition import CondTapState, UNet2DCondition
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


# the HF '*_HF' names share the google/ddpm 256 px architecture (UNet2D)
_HF_MODELS = {
    "CelebA_HQ_HF": ddpm_celebahq_256,
    "LSUN_church_HF": ddpm_ema_church_256,
    "LSUN_bedroom_HF": ddpm_ema_bedroom_256,
    "FFHQ_HF": ddpm_ema_ffhq_256,
}
# the checkpoint-era ADM / P2 names, which build UNetADM in the JAX package
_ADM_MODELS = {
    "LSUN_bedroom", "LSUN_cat", "LSUN_horse", "FFHQ_P2", "AFHQ_P2",
    "Flower_P2", "CIFAR10", "CIFAR10Uncond", "ImageNet64Uncond",
    "ImageNet256Uncond", "ImageNet256Cond", "ImageNet128Cond",
    "ImageNet64Cond",
}


def model_for_name(model_name: str, dtype: str = "float32") -> UNet2D:
    """model_name → the uncond diffusion module (uninitialised weights)."""
    if model_name in _HF_MODELS:
        return UNet2D(dataclasses.replace(_HF_MODELS[model_name](), dtype=dtype))
    if model_name in _ADM_MODELS:
        raise NotImplementedError(
            f"{model_name!r} builds the ADM U-Net, which the port does not "
            f"have yet (ROADMAP queue 1, item 13)")
    raise ValueError(f"model_name choice: {sorted(_HF_MODELS) + sorted(_ADM_MODELS)} "
                     f"(got {model_name!r})")


__all__ = [
    "AutoencoderKL", "CLIPTextConfig", "CLIPTextModel", "CondTapState",
    "HashTokenizer", "TapPoint", "TapState", "UNet2D", "UNet2DCondition",
    "UNet2DConditionConfig", "UNet2DConfig", "VAEConfig", "clip_text_tiny",
    "ddpm_celebahq_256", "ddpm_tiny", "load_flax_params", "load_tokenizer",
    "model_for_name", "random_init_", "sd21_base_unet", "sd21_text_encoder",
    "sd_tiny_unet", "sd_vae", "sdedit_celeba_256", "vae_tiny",
]
