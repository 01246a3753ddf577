"""Load weights into a port module: torch checkpoints from local files,
and the Flax param trees of the JAX package.

``convert_torch_state_dict(state_dict, module)`` pours a diffusers,
transformers or guided-diffusion state dict into a port module, whose
parameters carry those names: it strips ``module.`` wrappers, maps the old
diffusers attention names (query / key / value / proj_attn), squeezes
guided-diffusion's 1-D conv weights (out, in, 1) onto the port's linears,
skips the buffers and EMA stems a module does not have, casts each tensor
to the module's dtype and loads with ``strict=True``, so a missing, extra
or misshapen tensor raises. ``load_torch_checkpoint_file`` reads the file
(torch.load with weights_only=True, or safetensors).

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


# ---- torch checkpoints ------------------------------------------------------

# the scope torch.nn.DataParallel / DistributedDataParallel wrap names in
_WRAPPER = "module."
# the attention names of diffusers before 0.12 (AttentionBlock) → today's
_OLD_ATTENTION_NAMES = {"query": "to_q", "key": "to_k", "value": "to_v",
                        "proj_attn": "to_out.0"}


def load_torch_checkpoint_file(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from a local file: .bin / .pt / .ckpt through
    torch.load(weights_only=True), unwrapping a ``state_dict`` entry, or
    .safetensors through the safetensors package."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(f"reading {path} needs the safetensors package, which "
                               "is not installed; save the weights with torch.save "
                               "(.bin / .pt) instead") from e
        return load_file(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def _port_name(name: str, mine) -> str:
    """The port's name of a checkpoint tensor: an old diffusers attention
    projection renamed, where the name as it is does not exist."""
    if name in mine:
        return name
    mod, _, leaf = name.rpartition(".")
    stem, _, last = mod.rpartition(".")
    if last in _OLD_ATTENTION_NAMES:
        return f"{stem}.{_OLD_ATTENTION_NAMES[last]}.{leaf}"
    return name


def _ignorable(name: str) -> bool:
    """Tensors a checkpoint may carry that no port module has: BatchNorm
    step counters, position-id buffers, EMA shadows."""
    return (name.rpartition(".")[2] in ("num_batches_tracked", "position_ids")
            or "ema" in name.split(".")[0].lower())


def convert_torch_state_dict(state_dict: Dict[str, Any], module: nn.Module) -> nn.Module:
    """Load a torch state dict (tensors or arrays) into ``module`` and return
    it. Raises KeyError on a missing or an unconsumed tensor and ValueError
    on a shape mismatch, so a partial load cannot pass silently."""
    mine = module.state_dict()
    out = {}
    for name, value in state_dict.items():
        while name.startswith(_WRAPPER):
            name = name[len(_WRAPPER):]
        name = _port_name(name, mine)
        if name not in mine and _ignorable(name):
            continue
        t = torch.as_tensor(value)
        target = mine.get(name)
        if target is not None:
            if t.ndim == 3 and t.shape[-1] == 1 and target.ndim == 2:
                t = t[..., 0]       # guided-diffusion's conv_nd(1, …) weights
            if tuple(t.shape) != tuple(target.shape):
                raise ValueError(f"shape mismatch at {name}: checkpoint "
                                 f"{tuple(t.shape)} vs model {tuple(target.shape)}")
            t = t.to(target.dtype)
        out[name] = t
    missing = [n for n in mine if n not in out]
    if missing:
        raise KeyError(f"checkpoint missing parameter {missing[0]} "
                       f"({len(missing)} missing)")
    extra = [n for n in out if n not in mine]
    if extra:
        raise KeyError(f"checkpoint has {len(extra)} unconsumed tensors, e.g. {extra[0]}")
    module.load_state_dict(out, strict=True)
    return module


def load_torch_checkpoint(path: str, module: nn.Module) -> nn.Module:
    """``module`` (any port model: a U-Net, the classifier, the VAE or a
    text tower) with the checkpoint file at ``path`` loaded."""
    return convert_torch_state_dict(load_torch_checkpoint_file(path), module)
