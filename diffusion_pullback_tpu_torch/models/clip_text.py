"""CLIP / OpenCLIP text encoder — the SD prompt embedder.

Counterpart of diffusion_pullback_tpu/models/clip_text.py: token +
position embeddings, pre-LN transformer with a causal mask, final LN.
Parameter names are those of transformers' CLIPTextModel
(text_model.embeddings.token_embedding, text_model.encoder.layers.i.
self_attn.q_proj, .mlp.fc1, text_model.final_layer_norm, ...); a tower
built with ``projection=True`` (SDXL's bigG) also has the top-level
``text_projection`` of CLIPTextModelWithProjection, so the text_encoder_2
state dict of a diffusers SDXL directory names the same parameters.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .configs import CLIPTextConfig
from .layers import LayerNorm


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return F.gelu  # HF 'gelu' is the exact erf form


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, mask):
        b, s, c = x.shape
        hd = c // self.num_heads
        split = lambda t: t.reshape(b, s, self.num_heads, hd)
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
        logits = torch.where(mask, logits, torch.tensor(-1e9, device=x.device))
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(x.dtype).float(), v.float())
        return self.out_proj(out.to(x.dtype).reshape(b, s, c))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, intermediate: int, act: str):
        super().__init__()
        self.fc1 = nn.Linear(dim, intermediate)
        self.fc2 = nn.Linear(intermediate, dim)
        self.act = _act(act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        # Flax LayerNorm's epsilon (1e-6), as the JAX package
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=1e-6)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=1e-6)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size,
                           cfg.hidden_act)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(pos)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-6)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig, projection: bool = False):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)
        if projection:
            self.text_projection = nn.Linear(config.hidden_size,
                                             config.hidden_size, bias=False)
        self.to(getattr(torch, config.dtype))

    def forward(self, input_ids: torch.Tensor, return_pooled: bool = False,
                penultimate: bool = False):
        """(B, L) token ids → (B, L, hidden) final hidden states.

        ``penultimate`` returns the input of the last layer instead, without
        the final LayerNorm (HF hidden_states[-2]): the context SDXL's two
        towers give the U-Net. ``return_pooled`` also returns the pooled
        embedding, (hidden, pooled): the row of the first EOS token of the
        normalised output, through ``text_projection`` (needs
        ``projection=True``)."""
        tm = self.text_model
        x = tm.embeddings(input_ids)
        s = input_ids.shape[1]
        causal = torch.tril(torch.ones(s, s, dtype=torch.bool,
                                       device=input_ids.device))[None, None]
        x_penult = x
        for i, layer in enumerate(tm.encoder.layers):
            if i == len(tm.encoder.layers) - 1:
                x_penult = x
            x = layer(x, causal)
        if penultimate and not return_pooled:
            return x_penult
        hidden = tm.final_layer_norm(x)
        if not return_pooled:
            return hidden
        eos = (input_ids == self.config.eos_token_id).int().argmax(dim=1)
        pooled = self.text_projection(
            hidden[torch.arange(hidden.shape[0], device=hidden.device), eos])
        return (x_penult if penultimate else hidden), pooled


# ---- tokenization ---------------------------------------------------------

class HashTokenizer:
    """Deterministic offline stand-in for the CLIP BPE tokenizer: each
    whitespace word maps to a stable id in [3, vocab); the same ids as the
    JAX package's HashTokenizer."""

    def __init__(self, vocab_size: int, max_length: int):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos, self.eos, self.pad = 0, 1, 2

    def __call__(self, prompts: List[str]) -> np.ndarray:
        out = np.full((len(prompts), self.max_length), self.pad, np.int32)
        for i, p in enumerate(prompts):
            ids = [self.bos]
            for w in p.lower().split()[: self.max_length - 2]:
                hid = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4],
                                     "little")
                ids.append(3 + hid % (self.vocab_size - 3))
            ids.append(self.eos)
            out[i, : len(ids)] = ids
        return out


def load_tokenizer(config: CLIPTextConfig, local_path: Optional[str] = None):
    """The real CLIPTokenizer from a local directory when one is given (needs
    transformers), else the deterministic hash tokenizer."""
    if local_path:
        from transformers import CLIPTokenizer

        tok = CLIPTokenizer.from_pretrained(local_path)
        return lambda prompts: np.asarray(
            tok(prompts, padding="max_length", truncation=True,
                max_length=config.max_length, return_tensors="np").input_ids,
            np.int32,
        )
    return HashTokenizer(config.vocab_size, config.max_length)
