"""Plain PyTorch reference of the Stable Diffusion U-Net (diffusers'
UNet2DConditionModel, as its unet/config.json describes it), NCHW, on a
dict of float32 tensors under the diffusers state-dict names.

It runs the encoder half to the mid block, the map whose Jacobian the
pullback takes: conv_in and the time embedding, the down blocks (resnets,
each followed by a spatial transformer in a CrossAttnDownBlock2D, then a
stride-2 conv), and the mid block (resnet, transformer, resnet). The
layout covers every weight of the whole U-Net, so one state dict loads into
the program's module as it is.

Norms, softmax and the residual adds are in float32; every product goes
through the arithmetic object ``A`` (arith.py). Epsilons are diffusers':
norm_eps for the resnets, 1e-6 for a transformer's GroupNorm, 1e-5 for its
LayerNorms.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LAYER_NORM_EPS = 1e-5
TRANSFORMER_GN_EPS = 1e-6


def heads_and_dims(cfg: dict):
    """Per-block (heads, head dim). diffusers' 'attention_head_dim' of the
    SD 1.x / 2.x configs holds the number of heads per block (an int for
    all blocks or a list); the head dim is the block's channels over it."""
    ch = cfg["block_out_channels"]
    heads = cfg["attention_head_dim"]
    heads = list(heads) if isinstance(heads, (list, tuple)) else [heads] * len(ch)
    return [(h, c // h) for h, c in zip(heads, ch)]


def _cross(block_type: str) -> bool:
    return block_type.startswith("CrossAttn")


def layout(cfg: dict) -> dict:
    """{name: shape} of every weight of the whole U-Net."""
    ch = cfg["block_out_channels"]
    n, lpb = len(ch), cfg["layers_per_block"]
    temb = 4 * ch[0]
    ctx = cfg["cross_attention_dim"]
    hd = heads_and_dims(cfg)
    out = {}

    def conv(name, cin, cout, k=3):
        out[name + ".weight"] = (cout, cin, k, k)
        out[name + ".bias"] = (cout,)

    def lin(name, cin, cout, bias=True):
        out[name + ".weight"] = (cout, cin)
        if bias:
            out[name + ".bias"] = (cout,)

    def norm(name, c):
        out[name + ".weight"] = (c,)
        out[name + ".bias"] = (c,)

    def resnet(name, cin, cout):
        norm(name + ".norm1", cin)
        conv(name + ".conv1", cin, cout)
        lin(name + ".time_emb_proj", temb, cout)
        norm(name + ".norm2", cout)
        conv(name + ".conv2", cout, cout)
        if cin != cout:
            conv(name + ".conv_shortcut", cin, cout, 1)

    def transformer(name, c, level):
        heads, dim = hd[level]
        inner = heads * dim
        norm(name + ".norm", c)
        proj = (lambda nm, i, o: lin(nm, i, o)) if cfg.get("use_linear_projection") \
            else (lambda nm, i, o: conv(nm, i, o, 1))
        proj(name + ".proj_in", c, inner)
        b = name + ".transformer_blocks.0"
        for a, src in (("attn1", inner), ("attn2", ctx)):
            lin(f"{b}.{a}.to_q", inner, inner, bias=False)
            lin(f"{b}.{a}.to_k", src, inner, bias=False)
            lin(f"{b}.{a}.to_v", src, inner, bias=False)
            lin(f"{b}.{a}.to_out.0", inner, inner)
        for i in (1, 2, 3):
            norm(f"{b}.norm{i}", inner)
        lin(f"{b}.ff.net.0.proj", inner, 8 * inner)
        lin(f"{b}.ff.net.2", 4 * inner, inner)
        proj(name + ".proj_out", inner, c)

    conv("conv_in", cfg["in_channels"], ch[0])
    lin("time_embedding.linear_1", ch[0], temb)
    lin("time_embedding.linear_2", temb, temb)
    for i, bt in enumerate(cfg["down_block_types"]):
        for j in range(lpb):
            resnet(f"down_blocks.{i}.resnets.{j}", ch[i - 1] if i and not j else ch[i], ch[i])
            if _cross(bt):
                transformer(f"down_blocks.{i}.attentions.{j}", ch[i], i)
        if i < n - 1:
            conv(f"down_blocks.{i}.downsamplers.0.conv", ch[i], ch[i])
    resnet("mid_block.resnets.0", ch[-1], ch[-1])
    transformer("mid_block.attentions.0", ch[-1], n - 1)
    resnet("mid_block.resnets.1", ch[-1], ch[-1])
    rev = list(reversed(ch))
    for i, bt in enumerate(cfg["up_block_types"]):
        prev, cout, skip_in = rev[max(i - 1, 0)], rev[i], rev[min(i + 1, n - 1)]
        for j in range(lpb + 1):
            cin = (prev if j == 0 else cout) + (skip_in if j == lpb else cout)
            resnet(f"up_blocks.{i}.resnets.{j}", cin, cout)
            if _cross(bt):
                transformer(f"up_blocks.{i}.attentions.{j}", cout, n - 1 - i)
        if i < n - 1:
            conv(f"up_blocks.{i}.upsamplers.0.conv", cout, cout)
    norm("conv_norm_out", ch[0])
    conv("conv_out", ch[0], cfg["out_channels"])
    return out


def timestep_features(t: torch.Tensor, dim: int, flip_sin_to_cos: bool,
                      shift: float) -> torch.Tensor:
    """diffusers' get_timestep_embedding: (B,) → (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / (half - shift))
    arg = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(arg), torch.cos(arg)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class UNetEncoder:
    """x (B, C, H, W) → the mid block's output, on weights ``P``."""

    def __init__(self, P: dict, cfg: dict, A):
        self.P, self.cfg, self.A = P, cfg, A
        self.hd = heads_and_dims(cfg)

    def _gn(self, name, x, eps):
        # contiguous: torch.func's batched group_norm views its input
        return F.group_norm(x.contiguous(), self.cfg["norm_num_groups"], self.P[name + ".weight"],
                            self.P[name + ".bias"], eps)

    def _conv(self, name, x, stride=1, padding=1):
        return self.A.conv2d(x, self.P[name + ".weight"], self.P[name + ".bias"],
                             stride, padding)

    def _lin(self, name, x):
        return self.A.linear(x, self.P[name + ".weight"], self.P.get(name + ".bias"))

    def resnet(self, name, x, temb):
        eps = self.cfg["norm_eps"]
        h = self._conv(name + ".conv1", F.silu(self._gn(name + ".norm1", x, eps)))
        h = h + self._lin(name + ".time_emb_proj", F.silu(temb))[:, :, None, None]
        h = self._conv(name + ".conv2", F.silu(self._gn(name + ".norm2", h, eps)))
        if name + ".conv_shortcut.weight" in self.P:
            x = self._conv(name + ".conv_shortcut", x, padding=0)
        return x + h

    def attention(self, name, x, ctx, heads, dim):
        A = self.A
        b, s, _ = x.shape
        src = x if ctx is None else ctx
        split = lambda a: a.reshape(b, a.shape[1], heads, dim).transpose(1, 2)
        q = split(self._lin(name + ".to_q", x))
        k = split(self._lin(name + ".to_k", src))
        v = split(self._lin(name + ".to_v", src))
        p = torch.softmax(A.matmul(q, k.transpose(-1, -2)) * dim ** -0.5, dim=-1)
        o = A.matmul(p, v).transpose(1, 2).reshape(b, s, heads * dim)
        return self._lin(name + ".to_out.0", o)

    def _ln(self, name, x):
        return F.layer_norm(x, x.shape[-1:], self.P[name + ".weight"],
                            self.P[name + ".bias"], LAYER_NORM_EPS)

    def transformer(self, name, x, ctx, level):
        heads, dim = self.hd[level]
        b, c, hh, ww = x.shape
        linear = self.cfg.get("use_linear_projection", False)
        h = self._gn(name + ".norm", x, TRANSFORMER_GN_EPS)
        if linear:
            h = self._lin(name + ".proj_in", h.flatten(2).transpose(1, 2))
        else:
            h = self._conv(name + ".proj_in", h, padding=0).flatten(2).transpose(1, 2)
        blk = name + ".transformer_blocks.0"
        h = h + self.attention(blk + ".attn1", self._ln(blk + ".norm1", h), None, heads, dim)
        h = h + self.attention(blk + ".attn2", self._ln(blk + ".norm2", h), ctx, heads, dim)
        a, gate = self._lin(blk + ".ff.net.0.proj", self._ln(blk + ".norm3", h)).chunk(2, -1)
        h = h + self._lin(blk + ".ff.net.2", a * F.gelu(gate))
        if linear:
            h = self._lin(name + ".proj_out", h).transpose(1, 2).reshape(b, c, hh, ww)
        else:
            h = self._conv(name + ".proj_out", h.transpose(1, 2).reshape(b, -1, hh, ww),
                           padding=0)
        return x + h

    def __call__(self, x, t, ctx):
        cfg = self.cfg
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1)
        t = t.expand(x.shape[0])
        feat = timestep_features(t, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"],
                                 cfg["freq_shift"])
        temb = self._lin("time_embedding.linear_2",
                         F.silu(self._lin("time_embedding.linear_1", feat)))
        ctx = ctx.expand(x.shape[0], *ctx.shape[1:])
        h = self._conv("conv_in", x)
        n = len(cfg["block_out_channels"])
        for i, bt in enumerate(cfg["down_block_types"]):
            for j in range(cfg["layers_per_block"]):
                h = self.resnet(f"down_blocks.{i}.resnets.{j}", h, temb)
                if _cross(bt):
                    h = self.transformer(f"down_blocks.{i}.attentions.{j}", h, ctx, i)
            if i < n - 1:
                h = self._conv(f"down_blocks.{i}.downsamplers.0.conv", h, stride=2)
        h = self.resnet("mid_block.resnets.0", h, temb)
        h = self.transformer("mid_block.attentions.0", h, ctx, n - 1)
        return self.resnet("mid_block.resnets.1", h, temb)


def mid_tap_map(P: dict, cfg: dict, A, t, ctx):
    """z (1, H, W, C) NHWC → h at the mid tap (1, h, w, c) NHWC: the map
    the harvest's pullback differentiates, flattened in NHWC order as the
    basis is."""
    enc = UNetEncoder(P, cfg, A)
    return lambda z: enc(z.permute(0, 3, 1, 2), t, ctx).permute(0, 2, 3, 1)
