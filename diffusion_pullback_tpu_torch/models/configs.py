"""Model architecture configs and presets of the ported paths.

The SD 1.5, SD 2.1, SDXL, DDPM (UNet2D) and ADM subsets of the dataclasses and fields of
diffusion_pullback_tpu/models/configs.py, under the same names, so one set of
kwargs builds both packages. ``dtype`` is the parameter and compute dtype of
the module ('float32' | 'bfloat16'). The JAX ``precision`` field is not
carried: the port's float32 is full float32 on the card (strict_f32).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    """Unconditional 2-D U-Net (DDPM family).

    ``down_block_types`` entries: 'down' | 'attn_down'; up: 'up' | 'attn_up'.
    ``attention_head_dim=None`` → single attention head over all channels.
    """

    sample_size: int = 256
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 128, 256, 256, 512, 512)
    down_block_types: Tuple[str, ...] = (
        "down", "down", "down", "down", "attn_down", "down",
    )
    up_block_types: Tuple[str, ...] = (
        "up", "attn_up", "up", "up", "up", "up",
    )
    layers_per_block: int = 2
    attention_head_dim: Optional[int] = None
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    dropout: float = 0.0
    time_embed_dim: Optional[int] = None  # default: 4 * block_out_channels[0]
    flip_sin_to_cos: bool = False
    freq_shift: float = 1.0
    add_mid_attention: bool = True
    asymmetric_downsample: bool = False
    learn_sigma: bool = False  # doubles out_channels at the head
    dtype: str = "float32"

    @property
    def effective_out_channels(self) -> int:
        return self.out_channels * (2 if self.learn_sigma else 1)


def ddpm_celebahq_256() -> UNet2DConfig:
    """Architecture of google/ddpm-ema-celebahq-256 (and the other google/ddpm
    256 px checkpoints: CelebA_HQ_HF, LSUN_*_HF, FFHQ_HF)."""
    return UNet2DConfig()


def ddpm_ema_church_256() -> UNet2DConfig:
    return UNet2DConfig()


def ddpm_ema_bedroom_256() -> UNet2DConfig:
    """google/ddpm-ema-bedroom-256: the same architecture as celebahq."""
    return UNet2DConfig()


def ddpm_ema_ffhq_256() -> UNet2DConfig:
    """FFHQ 256 px HF checkpoint."""
    return UNet2DConfig()


def sdedit_celeba_256() -> UNet2DConfig:
    """The SDEdit CelebA-HQ custom DDPM (ch=128, ch_mult=(1,1,2,2,4,4),
    attention at 16×16, two res blocks, asymmetric downsampling)."""
    return UNet2DConfig(asymmetric_downsample=True)


def ddpm_tiny(sample_size: int = 32) -> UNet2DConfig:
    """Tiny config for tests: 2 blocks, 8/16 channels, attention in block 1."""
    return UNet2DConfig(
        sample_size=sample_size,
        block_out_channels=(8, 16),
        down_block_types=("down", "attn_down"),
        up_block_types=("attn_up", "up"),
        layers_per_block=1,
        norm_num_groups=4,
    )


@dataclasses.dataclass(frozen=True)
class UNet2DConditionConfig:
    """Text-conditioned U-Net (Stable Diffusion family).

    ``down_block_types`` entries: 'cross' | 'down'; up: 'cross' | 'up'.
    ``attention_heads`` is per-block (SD2.1: ch/64 heads of dim 64);
    ``transformer_depth`` per-block.
    """

    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = ("cross", "cross", "cross", "down")
    up_block_types: Tuple[str, ...] = ("up", "cross", "cross", "cross")
    layers_per_block: int = 2
    attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    # per-block head dim; an int applies to every block (SD 2.x / SDXL: 64;
    # SD 1.5 fixes 8 heads, so its head dim grows with the block channels)
    attention_head_dim: Any = 64
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 1)
    cross_attention_dim: int = 1024
    use_linear_projection: bool = True
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    dropout: float = 0.0
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    # SDXL addition embeddings: the pooled text embedding (text_embeds) and
    # the micro-conditioning time_ids, folded into the time embedding
    addition_embed_dim: Optional[int] = None       # pooled-text dim (1280)
    addition_time_embed_dim: Optional[int] = None  # Fourier dim per time_id (256)
    num_time_ids: int = 6
    dtype: str = "float32"
    attn_impl: str = "xla"
    # recompute each transformer block in its backward instead of saving
    # its activations (SDXL's deep stacks under the pullback's vjp)
    remat_transformer: bool = False


def sd21_base_unet(**over) -> UNet2DConditionConfig:
    """stabilityai/stable-diffusion-2-1-base U-Net."""
    return UNet2DConditionConfig(**over)


def sd15_unet(**over) -> UNet2DConditionConfig:
    """runwayml/stable-diffusion-v1-5 U-Net: 8 heads per block (head dims
    40 / 80 / 160 / 160), 1×1-conv projections, CLIP-L's 768-d context."""
    return UNet2DConditionConfig(
        attention_heads=(8, 8, 8, 8),
        attention_head_dim=(40, 80, 160, 160),
        cross_attention_dim=768,
        use_linear_projection=False,
        **over,
    )


def sdxl_base_unet(**over) -> UNet2DConditionConfig:
    """stabilityai/stable-diffusion-xl-base-1.0 U-Net: 3 levels, transformer
    depths (1, 2, 10), 2048-d context, pooled-text + time_ids addition
    embeddings."""
    return UNet2DConditionConfig(
        sample_size=128,
        block_out_channels=(320, 640, 1280),
        down_block_types=("down", "cross", "cross"),
        up_block_types=("cross", "cross", "up"),
        attention_heads=(5, 10, 20),
        transformer_depth=(1, 2, 10),
        cross_attention_dim=2048,
        addition_embed_dim=1280,
        addition_time_embed_dim=256,
        **over,
    )


def sdxl_tiny_unet(sample_size: int = 8) -> UNet2DConditionConfig:
    """Tiny SDXL-style config (addition embeddings, a 2-deep transformer)
    for tests."""
    return UNet2DConditionConfig(
        sample_size=sample_size,
        block_out_channels=(8, 16),
        down_block_types=("down", "cross"),
        up_block_types=("cross", "up"),
        layers_per_block=1,
        attention_heads=(2, 2),
        attention_head_dim=4,
        transformer_depth=(1, 2),
        cross_attention_dim=16,
        addition_embed_dim=8,
        addition_time_embed_dim=4,
        norm_num_groups=4,
    )


def sd_tiny_unet(sample_size: int = 8) -> UNet2DConditionConfig:
    """Tiny SD-style config for tests."""
    return UNet2DConditionConfig(
        sample_size=sample_size,
        block_out_channels=(8, 16),
        down_block_types=("cross", "down"),
        up_block_types=("up", "cross"),
        layers_per_block=1,
        attention_heads=(2, 2),
        attention_head_dim=4,
        transformer_depth=(1, 1),
        cross_attention_dim=16,
        norm_num_groups=4,
    )


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL (SD latent VAE)."""

    sample_size: int = 512
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    attn_impl: str = "xla"  # 'flash' at 512px: the mid attention is 4096 tokens
    dtype: str = "float32"


def sd_vae(**over) -> VAEConfig:
    return VAEConfig(**over)


def vae_tiny(sample_size: int = 32) -> VAEConfig:
    return VAEConfig(
        sample_size=sample_size,
        block_out_channels=(8, 16),
        layers_per_block=1,
        norm_num_groups=4,
        latent_channels=4,
    )


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP/OpenCLIP text encoder (SD prompt embedder)."""

    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 23
    num_heads: int = 16
    max_length: int = 77
    hidden_act: str = "gelu"
    eos_token_id: int = 49407
    dtype: str = "float32"


def sd21_text_encoder() -> CLIPTextConfig:
    """OpenCLIP ViT-H/14 text tower as shipped with SD2.1 (23 layers)."""
    return CLIPTextConfig()


def sd15_text_encoder() -> CLIPTextConfig:
    """SD 1.5's tower: CLIP ViT-L/14, read at its final LayerNorm."""
    return CLIPTextConfig(
        hidden_size=768, intermediate_size=3072, num_layers=12, num_heads=12,
        hidden_act="quick_gelu",
    )


def sdxl_text_encoder_1() -> CLIPTextConfig:
    """SDXL's first tower: CLIP ViT-L/14, read at its penultimate layer."""
    return CLIPTextConfig(
        hidden_size=768, intermediate_size=3072, num_layers=12, num_heads=12,
        hidden_act="quick_gelu",
    )


def sdxl_text_encoder_2() -> CLIPTextConfig:
    """SDXL's second tower: OpenCLIP ViT-bigG/14 (penultimate hidden states
    and the pooled, projected text embedding)."""
    return CLIPTextConfig(
        hidden_size=1280, intermediate_size=5120, num_layers=32, num_heads=20,
        hidden_act="gelu",
    )


def clip_text_tiny() -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=128, hidden_size=16, intermediate_size=32,
        num_layers=2, num_heads=2, max_length=8, eos_token_id=1,
    )


@dataclasses.dataclass(frozen=True)
class ADMConfig:
    """ADM / guided-diffusion U-Net (UNetADM). ``attention_resolutions``
    holds downsample factors (1, 2, 4, …), the argument of the torch
    ``UNetModel`` itself, not the "32,16,8" resolution strings of the
    published script dicts (which map through image_size // res; at 256 px
    the two coincide). ``num_head_channels`` > 0 sets the heads per layer
    as channels // num_head_channels, else ``num_heads``.
    ``time_embed_style``: 'adm' = [cos, sin] features with frequencies over
    half; 'ddpm' = [sin, cos] over half − 1 (the improved_ddpm_old nets).
    ``use_new_attention_order``: qkv laid out [Q; K; V] over all heads
    instead of the legacy per-head [q, k, v] interleave. ``zero_init`` is
    the JAX init's zero output layers; the port's weights come from
    ``random_init_`` or a checkpoint, so it changes nothing here."""

    image_size: int = 256
    in_channels: int = 3
    out_channels: int = 3
    model_channels: int = 256
    num_res_blocks: int = 2
    channel_mult: Tuple[float, ...] = (1, 1, 2, 2, 4, 4)
    attention_resolutions: Tuple[int, ...] = (32, 16, 8)
    num_heads: int = 4
    num_head_channels: int = 64
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    learn_sigma: bool = True
    num_classes: Optional[int] = None
    dropout: float = 0.0
    norm_num_groups: int = 32
    zero_init: bool = True
    dtype: str = "float32"
    attn_impl: str = "xla"
    time_embed_style: str = "adm"
    use_new_attention_order: bool = False


@dataclasses.dataclass(frozen=True)
class ADMEncoderConfig:
    """Half-U-Net noisy-image classifier (EncoderUNetADM): the ADM down path
    and middle with a pooled head. ``pool``: 'adaptive' | 'attention' |
    'spatial' | 'spatial_v2'. The defaults are the published 256 px
    ImageNet classifier."""

    image_size: int = 256
    in_channels: int = 3
    out_channels: int = 1000
    model_channels: int = 128
    num_res_blocks: int = 2
    channel_mult: Tuple[float, ...] = (1, 1, 2, 2, 4, 4)
    attention_resolutions: Tuple[int, ...] = (32, 16, 8)
    num_heads: int = 4
    num_head_channels: int = 64
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    pool: str = "attention"
    dropout: float = 0.0
    norm_num_groups: int = 32
    zero_init: bool = True
    dtype: str = "float32"
    attn_impl: str = "xla"


def adm_classifier_imagenet256() -> ADMEncoderConfig:
    return ADMEncoderConfig()


def adm_classifier(image_size: int = 256, *, width: int = 128, depth: int = 2,
                   attn_res: Tuple[int, ...] = (32, 16, 8),
                   pool: str = "attention") -> ADMEncoderConfig:
    """The published guidance classifier at ``image_size``: channel_mult
    and the attention's downsample factors (image_size // res) both change
    with the size."""
    mults = {
        512: (0.5, 1, 1, 2, 2, 4, 4),
        256: (1, 1, 2, 2, 4, 4),
        128: (1, 1, 2, 3, 4),
        64: (1, 2, 3, 4),
    }
    if image_size not in mults:
        raise ValueError(f"unsupported classifier image size: {image_size}")
    return ADMEncoderConfig(
        image_size=image_size, model_channels=width, num_res_blocks=depth,
        channel_mult=mults[image_size],
        attention_resolutions=tuple(image_size // r for r in attn_res),
        pool=pool,
    )


def adm_encoder_tiny(image_size: int = 16, pool: str = "attention"
                     ) -> ADMEncoderConfig:
    return ADMEncoderConfig(
        image_size=image_size, out_channels=10, model_channels=8,
        num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(2,),
        num_heads=2, num_head_channels=4, norm_num_groups=4, pool=pool,
    )


def adm_imagenet256_uncond() -> ADMConfig:
    """ImageNet256Uncond: 256 px, 256 channels, attention at 32², 16², 8²
    with heads of 64 (8 heads at 32² = 1024 tokens)."""
    return ADMConfig()


def adm_imagenet256_cond() -> ADMConfig:
    return ADMConfig(num_classes=1000)


def adm_imagenet128_cond() -> ADMConfig:
    """ImageNet128Cond: 128 px, 4 heads per layer (no head_channels), so
    heads of 128 at 32² = 1024 tokens."""
    return ADMConfig(image_size=128, channel_mult=(1, 1, 2, 3, 4),
                     attention_resolutions=(4, 8, 16), num_heads=4,
                     num_head_channels=-1, num_classes=1000)


def adm_imagenet64_cond() -> ADMConfig:
    """ImageNet64Cond: 64 px, 192 channels, 3 res blocks, the new qkv
    order."""
    return ADMConfig(image_size=64, model_channels=192, num_res_blocks=3,
                     channel_mult=(1, 2, 3, 4), attention_resolutions=(2, 4, 8),
                     num_classes=1000, use_new_attention_order=True)


def adm_lsun_256() -> ADMConfig:
    """LSUN bedroom / cat / horse 256 px: the ImageNet256Uncond
    architecture (attention at downsample factors 8, 16, 32)."""
    return ADMConfig(attention_resolutions=(8, 16, 32))


def adm_ffhq_p2() -> ADMConfig:
    """The P2-weighting FFHQ / AFHQ / Flower 256 px nets: 128 channels, 1
    res block, attention only at 16² (256 tokens)."""
    return ADMConfig(model_channels=128, num_res_blocks=1,
                     channel_mult=(1, 1, 2, 2, 4, 4),
                     attention_resolutions=(16,), num_head_channels=64,
                     resblock_updown=True, use_scale_shift_norm=True)


def adm_cifar10() -> ADMConfig:
    """CIFAR10Uncond: 32 px, 128 channels, 3 res blocks, 4 heads, plain
    conv down / up sampling."""
    return ADMConfig(image_size=32, model_channels=128, num_res_blocks=3,
                     channel_mult=(1, 2, 2, 2), attention_resolutions=(2, 4),
                     num_heads=4, num_head_channels=-1,
                     resblock_updown=False)


def adm_imagenet64_uncond() -> ADMConfig:
    """ImageNet64Uncond: 64 px, 128 channels, 3 res blocks, 4 heads, plain
    conv down / up sampling."""
    return ADMConfig(image_size=64, model_channels=128, num_res_blocks=3,
                     channel_mult=(1, 2, 3, 4), attention_resolutions=(4, 8),
                     num_heads=4, num_head_channels=-1,
                     resblock_updown=False)


def adm_tiny(image_size: int = 16) -> ADMConfig:
    return ADMConfig(
        image_size=image_size, model_channels=8, num_res_blocks=1,
        channel_mult=(1, 2), attention_resolutions=(2,), num_heads=2,
        num_head_channels=-1, norm_num_groups=4, learn_sigma=True,
    )
