"""ADM U-Net (guided-diffusion / improved-diffusion family) with taps, its
noisy-image classifier and its super-resolution variant.

Counterpart of diffusion_pullback_tpu/models/adm.py, NCHW inside, with
guided-diffusion's parameter names (input_blocks.N.M.in_layers.0,
emb_layers.1, out_layers.3, skip_connection, qkv, proj_out, op / conv of the
plain samplers, middle_block, output_blocks, out.0 / out.2, time_embed.0 /
.2, label_emb, positional_embedding as (C, S+1)), so the JAX package's
``flax_params_to_torch_state_dict`` output and ``load_flax_params`` fill
them with no renaming. qkv, proj_out and the pool's projections are
Linear layers (the checkpoints' 1-D convolutions with their last axis
squeezed).

    eps_sigma = unet(x, t[, y])                  # learned σ: 2·C channels
    h         = unet.encode(x, t, tap[, y])
    h, state  = unet.encode_with_state(x, t, tap[, y])
    eps_sigma = unet.decode_with_state(h, state, tap)

Taps are level-granular: ('down', level) → after that level's last input
block (its downsampler included); ('mid', 0); ('up', level). Attention goes
through ``ops.attention.attention`` with the config's ``attn_impl``; the
ADM-256 nets attend over 1024 tokens at 32², where 'flash' reaches K1 and
the pullback's pair K2–K5.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .configs import ADMConfig, ADMEncoderConfig
from .layers import GroupNorm, timestep_embedding
from .unet2d import TapPoint, TapState, _broadcast_state

GN_EPS = 1e-5  # guided-diffusion's GroupNorm32, as the JAX package


def _resample(v, updown: Optional[str]):
    if updown == "up":
        return F.interpolate(v, scale_factor=2.0, mode="nearest")
    if updown == "down":
        return F.avg_pool2d(v, 2)
    return v


class ADMResBlock(nn.Module):
    """GN → SiLU → [resample h and x] → conv, the embedding as FiLM
    scale-shift around the second GN (or added before it), SiLU → dropout →
    conv, plus the (1×1-projected when the channels change) skip."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int,
                 use_scale_shift_norm: bool, dropout: float = 0.0,
                 updown: Optional[str] = None, groups: int = 32):
        super().__init__()
        self.updown, self.use_scale_shift_norm = updown, use_scale_shift_norm
        self.in_layers = nn.Sequential(GroupNorm(groups, in_ch, eps=GN_EPS), nn.SiLU(),
                                       nn.Conv2d(in_ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(
            emb_ch, 2 * out_ch if use_scale_shift_norm else out_ch))
        self.out_layers = nn.Sequential(GroupNorm(groups, out_ch, eps=GN_EPS), nn.SiLU(),
                                        nn.Dropout(dropout),
                                        nn.Conv2d(out_ch, out_ch, 3, padding=1))
        self.skip_connection = (nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch
                                else nn.Identity())

    def forward(self, x, emb):
        h = self.in_layers[1](self.in_layers[0](x))
        if self.updown:
            h, x = _resample(h, self.updown), _resample(x, self.updown)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers(emb)[:, :, None, None]
        norm, rest = self.out_layers[0], self.out_layers[1:]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = norm(h) * (1 + scale) + shift
        else:
            h = norm(h + emb_out)
        return self.skip_connection(x) + rest(h)


class ADMAttentionBlock(nn.Module):
    """Multi-head self-attention over the H·W tokens with a residual add.
    ``new_order`` False: the legacy heads-major qkv channels [h0: q k v, h1:
    …]; True: qkv-major [Q (all heads); K; V]."""

    def __init__(self, channels: int, num_heads: int, groups: int = 32,
                 attn_impl: str = "xla", new_order: bool = False):
        super().__init__()
        self.num_heads, self.attn_impl, self.new_order = num_heads, attn_impl, new_order
        self.norm = GroupNorm(groups, channels, eps=GN_EPS)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, hgt, wid = x.shape
        heads, hd = self.num_heads, c // self.num_heads
        qkv = self.qkv(self.norm(x).flatten(2).transpose(1, 2))   # (B, S, 3C)
        if self.new_order:
            q, k, v = (p.reshape(b, -1, heads, hd) for p in qkv.chunk(3, dim=-1))
        else:
            q, k, v = qkv.reshape(b, -1, heads, 3 * hd).chunk(3, dim=-1)
        out = attention(q, k, v, impl=self.attn_impl)
        out = self.proj_out(out.reshape(b, hgt * wid, c))
        return x + out.transpose(1, 2).reshape(b, c, hgt, wid)


class Downsample(nn.Module):
    """Plain stride-2 3×3 conv (resblock_updown=False), as ``op``."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2× then a 3×3 conv (resblock_updown=False), as ``conv``."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class TimestepEmbedSequential(nn.ModuleList):
    """guided-diffusion's container: res blocks take the embedding, the
    other layers only h."""

    def forward(self, h, emb):
        for layer in self:
            h = layer(h, emb) if isinstance(layer, ADMResBlock) else layer(h)
        return h


class ADMTapState(NamedTuple):
    emb: torch.Tensor
    skips: Tuple[torch.Tensor, ...]


def _heads(cfg, ch: int) -> int:
    return max(1, ch // cfg.num_head_channels) if cfg.num_head_channels > 0 else cfg.num_heads


def _down_path(cfg, emb_ch: int, attn_impl: str):
    """(input_blocks, their output channels, the index range of each
    level's blocks, the middle block, the downsample factor at the middle)
    of an ADM down path; shared by UNetADM and EncoderUNetADM."""
    attn_at, groups = set(cfg.attention_resolutions), cfg.norm_num_groups
    res = lambda i, o, updown=None: ADMResBlock(i, o, emb_ch, cfg.use_scale_shift_norm,
                                                cfg.dropout, updown, groups)
    new_order = getattr(cfg, "use_new_attention_order", False)
    ch = cfg.model_channels
    blocks = [TimestepEmbedSequential([nn.Conv2d(cfg.in_channels, ch, 3, padding=1)])]
    chans, levels, ds = [ch], [], 1
    for level, mult in enumerate(cfg.channel_mult):
        start, out = len(blocks), int(cfg.model_channels * mult)
        for _ in range(cfg.num_res_blocks):
            layers = [res(ch, out)]
            ch = out
            if ds in attn_at:
                layers.append(ADMAttentionBlock(ch, _heads(cfg, ch), groups, attn_impl,
                                                new_order))
            blocks.append(TimestepEmbedSequential(layers))
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            blocks.append(TimestepEmbedSequential(
                [res(ch, ch, "down") if cfg.resblock_updown else Downsample(ch)]))
            chans.append(ch)
            ds *= 2
        levels.append(range(start, len(blocks)))
    middle = TimestepEmbedSequential([
        res(ch, ch), ADMAttentionBlock(ch, _heads(cfg, ch), groups, attn_impl, new_order),
        res(ch, ch)])
    return nn.ModuleList(blocks), chans, levels, middle, ds


def _time_features(t, x, dim: int, style: str = "adm"):
    """Sinusoidal features of t (scalar or (B,)) at x's batch: 'adm' is
    [cos, sin] with shift 0, 'ddpm' [sin, cos] with shift 1."""
    t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
    if t.ndim == 0:
        t = t.expand(x.shape[0])
    ddpm = style == "ddpm"
    return timestep_embedding(t, dim, flip_sin_to_cos=not ddpm,
                              downscale_freq_shift=1.0 if ddpm else 0.0)


class UNetADM(nn.Module):
    def __init__(self, config: ADMConfig):
        super().__init__()
        cfg = self.config = config
        mc, emb_ch = cfg.model_channels, 4 * cfg.model_channels
        self.time_embed = nn.Sequential(nn.Linear(mc, emb_ch), nn.SiLU(),
                                        nn.Linear(emb_ch, emb_ch))
        self.label_emb = nn.Embedding(cfg.num_classes, emb_ch) if cfg.num_classes else None
        (self.input_blocks, chans, self._down_levels, self.middle_block,
         ds) = _down_path(cfg, emb_ch, cfg.attn_impl)
        attn_at, groups = set(cfg.attention_resolutions), cfg.norm_num_groups
        ch, out_blocks, self._up_levels = chans[-1], [], []
        n = len(cfg.channel_mult)
        for level, mult in enumerate(reversed(cfg.channel_mult)):
            start, out = len(out_blocks), int(mc * mult)
            for i in range(cfg.num_res_blocks + 1):
                layers = [ADMResBlock(ch + chans.pop(), out, emb_ch,
                                      cfg.use_scale_shift_norm, cfg.dropout, None, groups)]
                ch = out
                if ds in attn_at:
                    layers.append(ADMAttentionBlock(ch, _heads(cfg, ch), groups,
                                                    cfg.attn_impl,
                                                    cfg.use_new_attention_order))
                if level != n - 1 and i == cfg.num_res_blocks:
                    layers.append(ADMResBlock(ch, ch, emb_ch, cfg.use_scale_shift_norm,
                                              cfg.dropout, "up", groups)
                                  if cfg.resblock_updown else Upsample(ch))
                out_blocks.append(TimestepEmbedSequential(layers))
            if level != n - 1:
                ds //= 2
            self._up_levels.append(range(start, len(out_blocks)))
        self.output_blocks = nn.ModuleList(out_blocks)
        out_ch = cfg.out_channels * (2 if cfg.learn_sigma else 1)
        self.out = nn.Sequential(GroupNorm(groups, ch, eps=GN_EPS), nn.SiLU(),
                                 nn.Conv2d(ch, out_ch, 3, padding=1))
        self.to(getattr(torch, cfg.dtype))

    # ---- internals --------------------------------------------------------

    def _prologue(self, x, t, y):
        """(the stem conv's output, the embedding of t and the labels y)."""
        dtype = self.out[2].weight.dtype
        feat = _time_features(t, x, self.config.model_channels,
                              self.config.time_embed_style)
        emb = self.time_embed(feat.to(dtype))
        if self.label_emb is not None:
            if y is None:
                raise ValueError("class-conditional model requires labels y")
            emb = emb + self.label_emb(torch.as_tensor(y, device=x.device))
        # contiguous: torch.func's batched group_norm views its input
        return self.input_blocks[0](x.to(dtype).contiguous(), emb), emb

    def _run_down(self, h, emb, levels, skips=()):
        """The input blocks of ``levels``; returns (h, the skips with each
        block's output appended)."""
        for level in levels:
            for i in self._down_levels[level]:
                h = self.input_blocks[i](h, emb)
                skips = skips + (h,)
        return h, skips

    def _run_up(self, h, skips, emb, levels):
        for level in levels:
            for i in self._up_levels[level]:
                h = self.output_blocks[i](torch.cat([h, skips[-1]], dim=1), emb)
                skips = skips[:-1]
        return h, skips

    def _tap(self, tap) -> TapPoint:
        tap = TapPoint(*tap)
        if tap.inner is not None:
            raise ValueError(
                "UNetADM does not support intra-block taps (after_res / "
                "after_sa exist only on the SD diffusers blocks)")
        n = len(self.config.channel_mult)
        return tap.validate(n, n)

    # ---- public -----------------------------------------------------------

    def forward(self, x, t, y=None):
        """[ε, σ] (learn_sigma) or ε. x: (B, C, H, W); t: scalar or (B,);
        y: (B,) labels of a class-conditional net."""
        stem, emb = self._prologue(x, t, y)
        n = len(self.config.channel_mult)
        h, skips = self._run_down(stem, emb, range(n), (stem,))
        h = self.middle_block(h, emb)
        return self.out(self._run_up(h, skips, emb, range(n))[0])

    def encode(self, x, t, tap: TapPoint, y=None):
        return self.encode_with_state(x, t, tap, y)[0]

    def encode_with_state(self, x, t, tap: TapPoint, y=None):
        """(h at ``tap``, the state that resumes the pass); only the
        sub-graph up to the tap runs. For a 'down' tap the tapped h is not
        among the skips (decode re-inserts it)."""
        tap = self._tap(tap)
        stem, emb = self._prologue(x, t, y)
        n = len(self.config.channel_mult)
        if tap.op == "down":
            h, skips = self._run_down(stem, emb, range(tap.block_idx + 1), (stem,))
            return h, ADMTapState(emb, skips[:-1])
        h, skips = self._run_down(stem, emb, range(n), (stem,))
        h = self.middle_block(h, emb)
        if tap.op == "up":
            h, skips = self._run_up(h, skips, emb, range(tap.block_idx + 1))
        return h, ADMTapState(emb, skips)

    def decode_with_state(self, h, state, tap: TapPoint):
        """Resume h(tap) → [ε, σ], the cached state broadcast over h's
        batch."""
        tap = self._tap(tap)
        emb, skips = _broadcast_state(TapState(*state), h.shape[0])
        h = h.to(emb.dtype)
        n = len(self.config.channel_mult)
        start = 0
        if tap.op == "down":
            h, skips = self._run_down(h, emb, range(tap.block_idx + 1, n), skips + (h,))
            h = self.middle_block(h, emb)
        elif tap.op == "up":
            start = tap.block_idx + 1
        return self.out(self._run_up(h, skips, emb, range(start, n))[0])


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling: the mean token prepended, a learned
    positional embedding (C, S+1) added, one multi-head self-attention pass
    with qkv-major channels, token 0 read out."""

    def __init__(self, tokens: int, channels: int, num_head_channels: int,
                 output_dim: int, attn_impl: str = "xla"):
        super().__init__()
        self.heads, self.attn_impl = channels // num_head_channels, attn_impl
        self.positional_embedding = nn.Parameter(torch.empty(channels, tokens + 1))
        self.qkv_proj = nn.Linear(channels, 3 * channels)
        self.c_proj = nn.Linear(channels, output_dim)

    def forward(self, x):
        b, c = x.shape[:2]
        tokens = x.flatten(2)                                       # (B, C, S)
        tokens = torch.cat([tokens.mean(dim=-1, keepdim=True), tokens], dim=-1)
        tokens = (tokens + self.positional_embedding[None].to(tokens.dtype)).transpose(1, 2)
        q, k, v = (p.reshape(b, -1, self.heads, c // self.heads)
                   for p in self.qkv_proj(tokens).chunk(3, dim=-1))
        out = attention(q, k, v, impl=self.attn_impl)
        return self.c_proj(out.reshape(b, -1, c))[:, 0]


class EncoderUNetADM(nn.Module):
    """Half-U-Net classifier: the ADM down path and middle with a pooled
    head, 'adaptive' (global mean → 1×1 conv), 'attention' (attention pool)
    or 'spatial' / 'spatial_v2' (each block's spatial mean → MLP)."""

    def __init__(self, config: ADMEncoderConfig):
        super().__init__()
        cfg = self.config = config
        mc, emb_ch, groups = cfg.model_channels, 4 * cfg.model_channels, cfg.norm_num_groups
        self.time_embed = nn.Sequential(nn.Linear(mc, emb_ch), nn.SiLU(),
                                        nn.Linear(emb_ch, emb_ch))
        (self.input_blocks, chans, _, self.middle_block,
         _) = _down_path(cfg, emb_ch, cfg.attn_impl)
        ch, k = chans[-1], cfg.out_channels
        if cfg.pool == "spatial":
            self.out = nn.Sequential(nn.Linear(sum(chans) + ch, 2048), nn.ReLU(),
                                     nn.Linear(2048, k))
        elif cfg.pool == "spatial_v2":
            self.out = nn.Sequential(nn.Linear(sum(chans) + ch, 2048),
                                     GroupNorm(groups, 2048, eps=GN_EPS), nn.SiLU(),
                                     nn.Linear(2048, k))
        elif cfg.pool == "adaptive":
            self.out = nn.Sequential(GroupNorm(groups, ch, eps=GN_EPS), nn.SiLU(),
                                     nn.AdaptiveAvgPool2d(1), nn.Conv2d(ch, k, 1))
        elif cfg.pool == "attention":
            side = cfg.image_size // 2 ** (len(cfg.channel_mult) - 1)
            self.out = nn.Sequential(GroupNorm(groups, ch, eps=GN_EPS), nn.SiLU(),
                                     AttentionPool2d(side * side, ch, cfg.num_head_channels,
                                                     k, cfg.attn_impl))
        else:
            raise ValueError(f"unknown pool {cfg.pool!r}")
        self.to(getattr(torch, cfg.dtype))

    def forward(self, x, t):
        """Logits (B, out_channels) of NCHW images x at timestep t."""
        dtype = self.time_embed[0].weight.dtype
        emb = self.time_embed(_time_features(t, x, self.config.model_channels).to(dtype))
        h = x.to(dtype).contiguous()
        spatial, pooled = self.config.pool.startswith("spatial"), []
        for block in self.input_blocks:
            h = block(h, emb)
            if spatial:
                pooled.append(h.float().mean(dim=(2, 3)))
        h = self.middle_block(h, emb)
        if spatial:
            pooled.append(h.float().mean(dim=(2, 3)))
            return self.out(torch.cat(pooled, dim=-1).to(dtype))
        return self.out(h).flatten(1)


class SuperResUNetADM(nn.Module):
    """The ADM U-Net conditioned on a low-resolution image, bilinearly
    upsampled to x's size and concatenated along the channels (the inner
    ``unet`` takes 2× in_channels and holds the parameters)."""

    def __init__(self, config: ADMConfig):
        super().__init__()
        self.config = config
        self.unet = UNetADM(dataclasses.replace(config, in_channels=2 * config.in_channels))

    def forward(self, x, t, low_res=None, y=None):
        if low_res is None:
            raise ValueError("SuperResUNetADM requires low_res conditioning")
        up = F.interpolate(low_res.to(x.dtype), size=x.shape[-2:], mode="bilinear",
                           align_corners=False)
        up = up.expand(x.shape[0], *up.shape[1:])
        return self.unet(torch.cat([x, up], dim=1), t, y=y)
