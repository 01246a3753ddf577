"""Unconditional 2-D diffusion U-Net (DDPM family) with feature taps.

Counterpart of diffusion_pullback_tpu/models/unet2d.py, NCHW inside, with
the parameter names that ``load_flax_params`` gives the Flax tree
(conv_in, time_embedding.linear_{1,2}, down_blocks.i.{resnets,attentions,
downsamplers}.j, mid_block, up_blocks, conv_norm_out, conv_out):

    eps       = unet(x, t)
    h         = unet.encode(x, t, tap)
    h, state  = unet.encode_with_state(x, t, tap)
    eps       = unet.decode_with_state(h, state, tap)

``encode`` runs only the sub-graph up to the tap; ``decode_with_state``
resumes from a (possibly probe-batched) h, broadcasting the cached skips
over its batch. The attention is the math path: its 256- and 64-token
single-head layers are below where the JAX dispatch would take a fused
kernel, so no flash kernel runs in this model.

Tap semantics:
    ('down', i) → output of down block i (after its downsampler)
    ('mid', 0)  → mid block output
    ('up', i)   → output of up block i
    inner ('res', j) / ('attn', j) on a down tap → after resnet j /
    self-attention j of that block (encode only)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .configs import UNet2DConfig
from .layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock,
    SelfAttention2D,
    TimestepEmbedMLP,
    Upsample2D,
    timestep_embedding,
)


class TapPoint(NamedTuple):
    op: str            # 'down' | 'mid' | 'up'
    block_idx: int = 0
    # intra-block tap on a down block (encode only): ('res', j) → after
    # resnet j; ('attn', j) → after self-attention j. None = block output.
    inner: Optional[Tuple[str, int]] = None

    def validate(self, num_down: int, num_up: int) -> "TapPoint":
        if self.op == "mid":
            if self.block_idx != 0:
                raise ValueError("mid tap requires block_idx == 0")
        elif self.op == "down":
            if not 0 <= self.block_idx < num_down:
                raise ValueError(f"down tap block_idx out of range: {self.block_idx}")
        elif self.op == "up":
            if not 0 <= self.block_idx < num_up:
                raise ValueError(f"up tap block_idx out of range: {self.block_idx}")
        else:
            raise ValueError(f"invalid tap op: {self.op!r}")
        if self.inner is not None:
            if self.op != "down":
                raise ValueError("inner taps are only supported on down blocks")
            kind, _ = self.inner
            if kind not in ("res", "attn"):
                raise ValueError(f"invalid inner tap kind: {kind!r}")
        return self


class TapState(NamedTuple):
    """What resuming the pass from a tap needs. ``skips`` excludes the
    tapped activation itself for 'down' taps: decode re-inserts h."""

    emb: torch.Tensor
    skips: Tuple[torch.Tensor, ...]


def _broadcast_state(state: TapState, batch: int) -> TapState:
    """Expand a batch-1 state to h's batch (views, no copy)."""
    b0 = state.emb.shape[0]
    if b0 == batch:
        return state
    if b0 != 1:
        raise ValueError(f"state batch {b0} incompatible with h batch {batch}")
    bc = lambda a: a.expand(batch, *a.shape[1:])
    return TapState(bc(state.emb), tuple(bc(s) for s in state.skips))


class DownBlock(nn.Module):
    """Resnets (each followed by a self-attention in 'attn_down' blocks),
    then an optional stride-2 downsampler. Returns (h, skips); ``stop_at``
    ('res' | 'attn', j) returns early with the skips so far."""

    def __init__(self, in_ch, out_ch, num_layers, temb_ch, add_attention,
                 add_downsample, head_dim, groups, eps, dropout, asymmetric):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_ch if i == 0 else out_ch, out_ch, temb_ch, groups,
                        eps, dropout)
            for i in range(num_layers)
        ])
        self.attentions = nn.ModuleList([
            SelfAttention2D(out_ch, head_dim, groups, eps)
            for _ in range(num_layers)
        ]) if add_attention else None
        self.downsamplers = nn.ModuleList([
            Downsample2D(out_ch, asymmetric)]) if add_downsample else None

    def forward(self, x, temb, stop_at=None):
        res = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if stop_at == ("res", i):
                return x, tuple(res)
            if self.attentions is not None:
                x = self.attentions[i](x)
                if stop_at == ("attn", i):
                    return x, tuple(res)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res.append(x)
        return x, tuple(res)


class UpBlock(nn.Module):
    """Resnets over [h; skip] (each followed by a self-attention in
    'attn_up' blocks), then an optional 2× upsampler."""

    def __init__(self, in_chs, out_ch, temb_ch, add_attention, add_upsample,
                 head_dim, groups, eps, dropout):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(c, out_ch, temb_ch, groups, eps, dropout) for c in in_chs])
        self.attentions = nn.ModuleList([
            SelfAttention2D(out_ch, head_dim, groups, eps) for _ in in_chs
        ]) if add_attention else None
        self.upsamplers = nn.ModuleList([
            Upsample2D(out_ch)]) if add_upsample else None

    def forward(self, x, res_samples, temb):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, res_samples[-1 - i]], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, channels, temb_ch, add_attention, head_dim, groups, eps,
                 dropout):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, temb_ch, groups, eps, dropout)
            for _ in range(2)
        ])
        self.attentions = nn.ModuleList([
            SelfAttention2D(channels, head_dim, groups, eps)
        ]) if add_attention else None

    def forward(self, x, temb):
        x = self.resnets[0](x, temb)
        if self.attentions is not None:
            x = self.attentions[0](x)
        return self.resnets[1](x, temb)


class UNet2D(nn.Module):
    def __init__(self, config: UNet2DConfig):
        super().__init__()
        cfg = self.config = config
        ch = cfg.block_out_channels
        n = len(ch)
        temb_ch = cfg.time_embed_dim or 4 * ch[0]
        common = dict(head_dim=cfg.attention_head_dim, groups=cfg.norm_num_groups,
                      eps=cfg.norm_eps, dropout=cfg.dropout)

        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedMLP(ch[0], temb_ch)
        skip_chs, cur = [ch[0]], ch[0]   # channels of the skips, in order
        down = []
        for i, bt in enumerate(cfg.down_block_types):
            down.append(DownBlock(
                cur, ch[i], cfg.layers_per_block, temb_ch, bt == "attn_down",
                i < n - 1, asymmetric=cfg.asymmetric_downsample, **common))
            skip_chs += [ch[i]] * (cfg.layers_per_block + (i < n - 1))
            cur = ch[i]
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = MidBlock(ch[-1], temb_ch, cfg.add_mid_attention, **common)
        up = []
        for i, bt in enumerate(cfg.up_block_types):
            out = ch[n - 1 - i]
            in_chs = []
            for _ in range(cfg.layers_per_block + 1):
                in_chs.append(cur + skip_chs.pop())
                cur = out
            up.append(UpBlock(in_chs, out, temb_ch, bt == "attn_up", i < n - 1,
                              **common))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0], eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch[0], cfg.effective_out_channels, 3, padding=1)
        self.to(getattr(torch, cfg.dtype))

    # ---- internals --------------------------------------------------------

    def _prologue(self, x, t):
        """(h after conv_in, time embedding) at x's batch."""
        dtype = self.conv_in.weight.dtype
        # contiguous: torch.func's batched group_norm views its input
        x = x.to(dtype).contiguous()
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        if t.ndim == 0:
            t = t.expand(x.shape[0])
        feat = timestep_embedding(t, self.config.block_out_channels[0],
                                  self.config.flip_sin_to_cos,
                                  self.config.freq_shift)
        return self.conv_in(x), self.time_embedding(feat.to(dtype))

    def _run_down(self, h, emb, stop_at: Optional[int] = None):
        """Down blocks; with ``stop_at`` stop after that block and leave its
        own output out of the skips (decode re-adds the tapped h)."""
        skips = (h,)
        for i, block in enumerate(self.down_blocks):
            h, res = block(h, emb)
            if stop_at == i:
                return h, skips + res[:-1]
            skips = skips + res
        return h, skips

    def _run_up(self, h, skips, emb, start: int = 0, stop_at: Optional[int] = None):
        """Up blocks ``start`` … (``stop_at`` inclusive); returns (h, the
        skips left)."""
        n_res = self.config.layers_per_block + 1
        for i in range(start, len(self.up_blocks)):
            res, skips = skips[-n_res:], skips[:-n_res]
            h = self.up_blocks[i](h, res, emb)
            if i == stop_at:
                break
        return h, skips

    def _head(self, h):
        return self.conv_out(F.silu(self.conv_norm_out(h)))

    def _tap(self, tap) -> TapPoint:
        return TapPoint(*tap).validate(len(self.down_blocks), len(self.up_blocks))

    # ---- public -----------------------------------------------------------

    def forward(self, x, t):
        """ε (or [ε, logvar] with learn_sigma). x: (B, C, H, W); t: scalar
        or (B,)."""
        h, emb = self._prologue(x, t)
        h, skips = self._run_down(h, emb)
        h = self.mid_block(h, emb)
        return self._head(self._run_up(h, skips, emb)[0])

    def encode(self, x, t, tap: TapPoint):
        """The activation at ``tap`` (only the sub-graph up to it runs)."""
        return self.encode_with_state(x, t, tap)[0]

    def encode_with_state(self, x, t, tap: TapPoint):
        tap = self._tap(tap)
        h, emb = self._prologue(x, t)
        if tap.inner is not None:
            for i in range(tap.block_idx):
                h, _ = self.down_blocks[i](h, emb)
            h, _ = self.down_blocks[tap.block_idx](h, emb, stop_at=tap.inner)
            return h, TapState(emb, ())
        if tap.op == "down":
            h, skips = self._run_down(h, emb, tap.block_idx)
            return h, TapState(emb, skips)
        h, skips = self._run_down(h, emb)
        h = self.mid_block(h, emb)
        if tap.op == "up":
            h, skips = self._run_up(h, skips, emb, stop_at=tap.block_idx)
        return h, TapState(emb, skips)

    def decode_with_state(self, h, state: TapState, tap: TapPoint):
        """Resume h(tap) → ε, the cached skips broadcast over h's batch."""
        tap = self._tap(tap)
        if tap.inner is not None:
            raise NotImplementedError(
                "decode from intra-block taps is not supported")
        emb, skips = _broadcast_state(TapState(*state), h.shape[0])
        h = h.to(emb.dtype)
        if tap.op == "down":
            skips = skips + (h,)
            for i in range(tap.block_idx + 1, len(self.down_blocks)):
                h, res = self.down_blocks[i](h, emb)
                skips = skips + res
            h = self.mid_block(h, emb)
        start = tap.block_idx + 1 if tap.op == "up" else 0
        return self._head(self._run_up(h, skips, emb, start=start)[0])

    def shallow_encode(self, x, t) -> TapState:
        """Time embedding, conv_in and the first down block's resnet /
        attention outputs: exactly the skips the last up block consumes."""
        h, emb = self._prologue(x, t)
        block = self.down_blocks[0]
        kind = "attn" if block.attentions is not None else "res"
        out, res = block(h, emb, stop_at=(kind, self.config.layers_per_block - 1))
        return TapState(emb, (h,) + res + (out,))

    def forward_dh(self, x, t, dh, tap: TapPoint):
        """ε with h(tap) replaced by h(tap) + dh."""
        h, state = self.encode_with_state(x, t, tap)
        return self.decode_with_state(h + dh, state, tap)
