"""Text-conditioned 2-D U-Net (Stable Diffusion family) with feature taps.

Counterpart of diffusion_pullback_tpu/models/unet2d_condition.py: the same
blocks and the same tap surface as models.unet2d.UNet2D, with the prompt
embeddings threaded through, NCHW inside, diffusers parameter names
(down_blocks.i.resnets.j, .attentions.j, .downsamplers.0.conv, mid_block,
up_blocks, time_embedding, conv_in/conv_norm_out/conv_out):

    eps       = unet(x, t, context)
    h         = unet.encode(x, t, context, tap)
    h, state  = unet.encode_with_state(x, t, context, tap)
    eps       = unet.decode_with_state(h, state, tap)
    state     = unet.shallow_encode(x, t, context)

The state (``CondTapState``) carries the context too, so a batch-1 state
fans out over a probe batch of h. A config with SDXL addition embeddings
(``addition_embed_dim``) also takes ``added_cond=(text_embeds, time_ids)``
in every call that starts from x; the embedding it adds to the time
embedding travels in the state.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

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
from .unet2d import TapPoint, TapState, _broadcast_state


class CondTapState(NamedTuple):
    """What resuming the pass from a tap needs: the time embedding, the
    skips (for 'down' taps without the tapped activation itself) and the
    context."""

    emb: torch.Tensor
    skips: Tuple[torch.Tensor, ...]
    context: torch.Tensor


def _broadcast_cond_state(state: CondTapState, batch: int) -> CondTapState:
    """Expand a batch-1 state, context included, to h's batch (views)."""
    base = _broadcast_state(TapState(state.emb, state.skips), batch)
    ctx = state.context
    if ctx.shape[0] != batch:
        if ctx.shape[0] != 1:
            raise ValueError(f"context batch {ctx.shape[0]} vs h batch {batch}")
        ctx = ctx.expand(batch, *ctx.shape[1:])
    return CondTapState(base.emb, base.skips, ctx)


class DownBlock(nn.Module):
    """Resnets (each followed by a transformer when ``transformer`` builds
    one), then an optional stride-2 downsampler. Returns (h, skips);
    ``stop_at`` ('res' | 'attn', j) returns early with the skips so far."""

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

    def forward(self, x, temb, context, stop_at=None):
        res = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if stop_at == ("res", i):
                return x, tuple(res)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context)
                if stop_at == ("attn", i):
                    return x, tuple(res)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res.append(x)
        return x, tuple(res)


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
                norm_num_groups=cfg.norm_num_groups, attn_impl=cfg.attn_impl,
                remat=cfg.remat_transformer)

        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedMLP(ch[0], temb_ch)
        if cfg.addition_embed_dim:
            # diffusers' add_embedding: [text_embeds; Fourier(time_ids)]
            # (1280 + 6·256 = 2816 wide on SDXL) → the time embedding's width
            self.add_embedding = TimestepEmbedMLP(
                cfg.addition_embed_dim
                + cfg.num_time_ids * cfg.addition_time_embed_dim, temb_ch)
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

    def _prologue(self, x, t, context, added_cond=None):
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
        cfg = self.config
        feat = timestep_embedding(t, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        emb = self.time_embedding(feat.to(dtype))
        if cfg.addition_embed_dim:
            emb = emb + self._added_embedding(added_cond, x.shape[0], dtype)
        return self.conv_in(x), emb, context

    def _added_embedding(self, added_cond, batch, dtype):
        """add_embedding([text_embeds; Fourier features of each time_id]),
        the features in f32 and cast to the module's dtype at the MLP, as
        the JAX package does; a batch-1 pair broadcasts over ``batch``."""
        if added_cond is None:
            raise ValueError("this config uses SDXL addition embeddings: pass "
                             "added_cond=(text_embeds, time_ids)")
        cfg = self.config
        text_embeds, time_ids = added_cond
        tf = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                cfg.flip_sin_to_cos, cfg.freq_shift)
        add = torch.cat([text_embeds.float(), tf.reshape(time_ids.shape[0], -1)],
                        dim=-1)
        if add.shape[0] == 1 and batch > 1:
            add = add.expand(batch, -1)
        return self.add_embedding(add.to(dtype))

    def _run_up(self, h, skips, emb, context, start: int = 0, stop_at=None):
        """Up blocks ``start`` … (``stop_at`` inclusive); returns (h, the
        skips left)."""
        n_res = self.config.layers_per_block + 1
        for i in range(start, len(self.up_blocks)):
            res, skips = skips[-n_res:], skips[:-n_res]
            h = self.up_blocks[i](h, res, emb, context)
            if i == stop_at:
                break
        return h, skips

    def _head(self, h):
        return self.conv_out(F.silu(self.conv_norm_out(h)))

    def _tap(self, tap) -> TapPoint:
        return TapPoint(*tap).validate(len(self.down_blocks), len(self.up_blocks))

    # ---- public -----------------------------------------------------------

    def forward(self, x, t, encoder_hidden_states, added_cond=None):
        """ε(x, t | context). x: (B, C, H, W); t: scalar or (B,)."""
        h, emb, ctx = self._prologue(x, t, encoder_hidden_states, added_cond)
        skips = (h,)
        for block in self.down_blocks:
            h, res = block(h, emb, ctx)
            skips += res
        h = self.mid_block(h, emb, ctx)
        return self._head(self._run_up(h, skips, emb, ctx)[0])

    def encode(self, x, t, encoder_hidden_states, tap: TapPoint, added_cond=None):
        """The activation at ``tap`` (only the sub-graph up to it runs)."""
        return self.encode_with_state(x, t, encoder_hidden_states, tap,
                                      added_cond)[0]

    def encode_with_state(self, x, t, encoder_hidden_states, tap: TapPoint,
                          added_cond=None):
        """(h at ``tap``, the CondTapState that resumes the pass from it).
        An inner tap stops inside a cross-attention down block and carries
        no skips (decode from it is not supported)."""
        tap = self._tap(tap)
        h, emb, ctx = self._prologue(x, t, encoder_hidden_states, added_cond)
        if tap.inner is not None:
            for i in range(tap.block_idx):
                h, _ = self.down_blocks[i](h, emb, ctx)
            block = self.down_blocks[tap.block_idx]
            if not hasattr(block, "attentions"):
                raise ValueError("inner taps need a cross-attention block")
            h, _ = block(h, emb, ctx, stop_at=tap.inner)
            return h, CondTapState(emb, (), ctx)
        skips = (h,)
        for i, block in enumerate(self.down_blocks):
            h, res = block(h, emb, ctx)
            if tap.op == "down" and tap.block_idx == i:
                return h, CondTapState(emb, skips + res[:-1], ctx)
            skips += res
        h = self.mid_block(h, emb, ctx)
        if tap.op == "up":
            h, skips = self._run_up(h, skips, emb, ctx, stop_at=tap.block_idx)
        return h, CondTapState(emb, skips, ctx)

    def decode_with_state(self, h, state: CondTapState, tap: TapPoint):
        """Resume h(tap) → ε, the state broadcast over h's batch."""
        tap = self._tap(tap)
        if tap.inner is not None:
            raise NotImplementedError(
                "decode from intra-block taps is not supported")
        emb, skips, ctx = _broadcast_cond_state(CondTapState(*state), h.shape[0])
        h = h.to(emb.dtype)
        if tap.op == "down":
            skips = skips + (h,)
            for i in range(tap.block_idx + 1, len(self.down_blocks)):
                h, res = self.down_blocks[i](h, emb, ctx)
                skips = skips + res
            h = self.mid_block(h, emb, ctx)
        start = tap.block_idx + 1 if tap.op == "up" else 0
        return self._head(self._run_up(h, skips, emb, ctx, start=start)[0])

    def forward_dh(self, x, t, encoder_hidden_states, dh, tap: TapPoint):
        """ε with h(tap) replaced by h(tap) + dh."""
        h, state = self.encode_with_state(x, t, encoder_hidden_states, tap)
        return self.decode_with_state(h + dh, state, tap)

    def shallow_encode(self, x, t, encoder_hidden_states,
                       added_cond=None) -> CondTapState:
        """Time embedding, conv_in and the first down block's per-layer
        outputs: exactly the skips the last up block consumes (the
        per-step slice of DeepCache sampling, samplers/deepcache.py)."""
        h, emb, ctx = self._prologue(x, t, encoder_hidden_states, added_cond)
        block = self.down_blocks[0]
        kind = "attn" if hasattr(block, "attentions") else "res"
        out, res = block(h, emb, ctx,
                         stop_at=(kind, self.config.layers_per_block - 1))
        return CondTapState(emb, (h,) + res + (out,), ctx)
