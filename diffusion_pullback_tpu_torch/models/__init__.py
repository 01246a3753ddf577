"""Models of the ported paths: the SD 1.5, SD 2.1-base and SDXL U-Nets, the VAE,
the CLIP text towers, the DDPM-family UNet2D and the ADM family (UNetADM,
its classifier EncoderUNetADM, SuperResUNetADM)."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .adm import (
    ADMTapState,
    AttentionPool2d,
    EncoderUNetADM,
    SuperResUNetADM,
    UNetADM,
)
from .clip_text import CLIPTextModel, HashTokenizer, load_tokenizer
from .configs import (
    ADMConfig,
    ADMEncoderConfig,
    CLIPTextConfig,
    UNet2DConditionConfig,
    UNet2DConfig,
    VAEConfig,
    adm_cifar10,
    adm_classifier,
    adm_classifier_imagenet256,
    adm_encoder_tiny,
    adm_ffhq_p2,
    adm_imagenet64_cond,
    adm_imagenet64_uncond,
    adm_imagenet128_cond,
    adm_imagenet256_cond,
    adm_imagenet256_uncond,
    adm_lsun_256,
    adm_tiny,
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
    sd15_text_encoder,
    sd15_unet,
    sdedit_celeba_256,
    sdxl_base_unet,
    sdxl_text_encoder_1,
    sdxl_text_encoder_2,
    sdxl_tiny_unet,
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
    zero biases. Drawn in f32 from a generator on the device the module's
    parameters are on: a module built on the CPU gets the same weights for
    a seed whatever device it later moves to (the SD 2.1 and DDPM
    builders); one built on the card draws there, with CUDA's generator,
    which keeps the 3.5 B parameters of the SDXL models off the host (its
    f32 draw on the CPU takes tens of seconds). Every weight is drawn, the
    ones the JAX init of an ADM net zeroes too (its output convs and
    attention proj_out): with those at 0 the attention would drop out of ε
    and of the Jacobian."""
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda shape: torch.randn(shape, generator=gen, device=dev)
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        elif "embedding" in name:
            p.copy_(randn(p.shape) * p.shape[1] ** -0.5)
        else:
            p.copy_(randn(p.shape) * (p[0].numel() ** -0.5))
    return module


# the HF '*_HF' names share the google/ddpm 256 px architecture (UNet2D)
_HF_MODELS = {
    "CelebA_HQ_HF": ddpm_celebahq_256,
    "LSUN_church_HF": ddpm_ema_church_256,
    "LSUN_bedroom_HF": ddpm_ema_bedroom_256,
    "FFHQ_HF": ddpm_ema_ffhq_256,
}
# the checkpoint-era ADM / P2 names (learned-σ heads)
_ADM_MODELS = {
    "LSUN_bedroom": adm_lsun_256,
    "LSUN_cat": adm_lsun_256,
    "LSUN_horse": adm_lsun_256,
    "FFHQ_P2": adm_ffhq_p2,
    "AFHQ_P2": adm_ffhq_p2,
    "Flower_P2": adm_ffhq_p2,
    "CIFAR10": adm_cifar10,
    "CIFAR10Uncond": adm_cifar10,
    "ImageNet64Uncond": adm_imagenet64_uncond,
    "ImageNet256Uncond": adm_imagenet256_uncond,
    "ImageNet256Cond": adm_imagenet256_cond,
    "ImageNet128Cond": adm_imagenet128_cond,
    "ImageNet64Cond": adm_imagenet64_cond,
}


def model_for_name(model_name: str, dtype: str = "float32", attn_impl: str = ""):
    """model_name → the uncond diffusion module (uninitialised weights): the
    '*_HF' names build UNet2D (no attention switch: its ≤256-token attention
    is the math path), the ADM names UNetADM with ``attn_impl`` ('' keeps
    the config's 'xla')."""
    if model_name in _HF_MODELS:
        return UNet2D(dataclasses.replace(_HF_MODELS[model_name](), dtype=dtype))
    if model_name in _ADM_MODELS:
        cfg = dataclasses.replace(_ADM_MODELS[model_name](), dtype=dtype)
        if attn_impl:
            cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
        return UNetADM(cfg)
    raise ValueError(f"model_name choice: {sorted(_HF_MODELS) + sorted(_ADM_MODELS)} "
                     f"(got {model_name!r})")


__all__ = [
    "ADMConfig", "ADMEncoderConfig", "ADMTapState", "AttentionPool2d",
    "EncoderUNetADM", "SuperResUNetADM", "UNetADM", "adm_cifar10",
    "adm_classifier", "adm_classifier_imagenet256", "adm_encoder_tiny",
    "adm_ffhq_p2", "adm_imagenet64_cond", "adm_imagenet64_uncond",
    "adm_imagenet128_cond", "adm_imagenet256_cond", "adm_imagenet256_uncond",
    "adm_lsun_256", "adm_tiny",
    "AutoencoderKL", "CLIPTextConfig", "CLIPTextModel", "CondTapState",
    "HashTokenizer", "TapPoint", "TapState", "UNet2D", "UNet2DCondition",
    "UNet2DConditionConfig", "UNet2DConfig", "VAEConfig", "clip_text_tiny",
    "ddpm_celebahq_256", "ddpm_tiny", "load_flax_params", "load_tokenizer",
    "model_for_name", "random_init_", "sd15_text_encoder", "sd15_unet",
    "sd21_base_unet", "sd21_text_encoder",
    "sd_tiny_unet", "sd_vae", "sdedit_celeba_256", "sdxl_base_unet",
    "sdxl_text_encoder_1", "sdxl_text_encoder_2", "sdxl_tiny_unet", "vae_tiny",
]
