"""Carry a Flax param tree of the JAX package into a port module.

``load_flax_params(module, params)`` renames the Flax tree to the port's
diffusers / transformers parameter names, transposes each leaf to torch's
layout and loads it with ``load_state_dict(strict=True)``, so a missing,
extra or misshapen parameter raises. The renaming is this package's own
copy of the inverse mapping of the JAX package's models/convert.py
(``flax_params_to_torch_state_dict``), plus the three places where the
diffusers / transformers names differ from it (samplers keep their inner
``conv``, attention outputs are ``to_out.0``, CLIP is scoped under
``text_model`` except for the projection of the pooled embedding,
``text_projection``, which transformers keeps at the top level). ADM trees
take guided-diffusion's names: the Sequential stems (input_blocks_4_1,
in_layers_0, time_embed_2, out_0, …) expand to '.N.', and a plain sampler
conv gains ``op`` (input blocks, not the stem input_blocks_0_0) or ``conv``
(output blocks).

Conventions: conv kernel HWIO → OIHW, dense kernel (in, out) → (out, in),
norm scale → weight, embedding table → weight, the attention pool's
positional_embedding (S+1, C) → (C, S+1).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .clip_text import CLIPTextModel

# module-list stems whose Flax auto-name digit suffixes expand back to the
# torch '.N.' form (down_blocks_0 → down_blocks.0)
_EXPAND_STEMS = {
    "down_blocks", "up_blocks", "resnets", "attentions", "downsamplers",
    "upsamplers", "transformer_blocks", "net", "layers", "input_blocks",
    "output_blocks", "middle_block", "time_embed", "in_layers", "out_layers",
    "emb_layers", "out",
}


def _expand_list_indices(comp: str):
    """'resnets_1' → ['resnets', '1']; 'input_blocks_4_1' → ['input_blocks',
    '4', '1'] (a Sequential inside a ModuleList)."""
    suffix = []
    while True:
        m = re.match(r"(.+)_(\d+)$", comp)
        if not m or not (m.group(1) in _EXPAND_STEMS or re.fullmatch(
                r"(?:input|output)_blocks_\d+", m.group(1))):
            break
        suffix.insert(0, m.group(2))
        comp = m.group(1)
    return [comp] + suffix


def _torch_name(mods, leaf: str, clip: bool) -> str:
    mods = list(mods)
    # the VAE's flat stage names: down_blocks_0_resnets_1 → two levels
    if mods and mods[0] in ("encoder", "decoder"):
        expanded = [mods[0]]
        for comp in mods[1:]:
            m = re.fullmatch(r"(down_blocks|up_blocks)_(\d+)_"
                             r"(resnets|downsamplers|upsamplers)_(\d+)", comp)
            expanded += ([f"{m.group(1)}_{m.group(2)}",
                          f"{m.group(3)}_{m.group(4)}"] if m else [comp])
        mods = expanded
    # ADM's plain Downsample / Upsample: the Flax conv sits at the block,
    # torch nests it as '.op' / '.conv' (the stem input_blocks_0_0 does not)
    if mods and leaf in ("kernel", "bias"):
        if re.fullmatch(r"input_blocks_\d+_\d+", mods[-1]) and mods[-1] != "input_blocks_0_0":
            mods.append("op")
        elif re.fullmatch(r"output_blocks_\d+_\d+", mods[-1]):
            mods.append("conv")
    parts = []
    for p in mods:
        parts += _expand_list_indices(p)
    parts = ["time_embedding" if p == "time_mlp" else p for p in parts]
    if parts and parts[-1] == "to_out":
        parts.append("0")
    if clip and parts[0] != "text_projection":
        if parts[-1] in ("fc1", "fc2"):
            parts.insert(-1, "mlp")
        if parts[0] in ("token_embedding", "position_embedding"):
            parts.insert(0, "embeddings")
        elif parts[0] == "layers":
            parts.insert(0, "encoder")
        parts.insert(0, "text_model")
    suffix = "weight" if leaf in ("scale", "kernel", "embedding") else leaf
    return ".".join(parts + [suffix])


def flax_to_state_dict(params: Dict[str, Any], clip: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """The Flax tree as a state dict of torch-layout tensors."""
    inner = params["params"] if "params" in params else params
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        arr = np.asarray(node, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf == "positional_embedding":
            arr = arr.T
        out[_torch_name(path[:-1], leaf, clip)] = torch.tensor(arr)

    walk(inner, ())
    return out


def load_flax_params(module: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Fill ``module`` (a port U-Net, VAE or CLIP text tower) with the Flax
    params of the same config. Raises on any name or shape mismatch."""
    sd = flax_to_state_dict(params, clip=isinstance(module, CLIPTextModel))
    mine = module.state_dict()
    for name, t in sd.items():
        if name in mine and tuple(mine[name].shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch at {name}: flax {tuple(t.shape)}"
                             f" vs port {tuple(mine[name].shape)}")
    module.load_state_dict(sd, strict=True)
    return module
