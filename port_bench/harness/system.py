"""The system under test: the port's Stable Diffusion driver
(``EditStableDiffusion``) built from a configuration file, with the
benchmark's seeded weights, and the units of work its traffic drives.

A configuration file holds diffusers' unet/, vae/ and text_encoder/
config.json as published, and the dtypes and attention the program runs
them in; the modules are the port's, built as ``main.build_sd`` builds
them (U-Net in its dtype with the fused attention, VAE and text tower in
float32).

A traffic file's ``entry`` names the unit its cells run; ``local_basis``
is the only one so far, and any other name is refused. A ``local_basis``
unit is the t-grid harvest's per-point body: the
encoder pullback at the mid tap of a seeded z_t at one grid t
(``compute_local_basis``), then ``_save_basis`` into the run's basis
folder. Every unit has its own z_t, probe seed and basis name, so no cache
serves it. The conditioning is the embedding the benchmark draws for the
empty prompt, handed to the driver and to the reference alike.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from . import weights

# what a traffic file's "entry" may name: the unit that System.unit runs
ENTRIES = ("local_basis",)

UNET_BLOCKS = {"CrossAttnDownBlock2D": "cross", "DownBlock2D": "down",
               "CrossAttnUpBlock2D": "cross", "UpBlock2D": "up"}


def unet_config(cfg: dict):
    """The port's UNet2DConditionConfig of a configuration file."""
    from diffusion_pullback_tpu_torch.models.configs import UNet2DConditionConfig

    from ..reference.unet import heads_and_dims

    u = cfg["unet"]
    hd = heads_and_dims(u)
    dims = tuple(d for _, d in hd)
    return UNet2DConditionConfig(
        sample_size=u["sample_size"], in_channels=u["in_channels"],
        out_channels=u["out_channels"], block_out_channels=tuple(u["block_out_channels"]),
        down_block_types=tuple(UNET_BLOCKS[b] for b in u["down_block_types"]),
        up_block_types=tuple(UNET_BLOCKS[b] for b in u["up_block_types"]),
        layers_per_block=u["layers_per_block"], attention_heads=tuple(h for h, _ in hd),
        attention_head_dim=dims[0] if len(set(dims)) == 1 else dims,
        cross_attention_dim=u["cross_attention_dim"],
        use_linear_projection=u.get("use_linear_projection", False),
        norm_num_groups=u["norm_num_groups"], norm_eps=u["norm_eps"],
        flip_sin_to_cos=u["flip_sin_to_cos"], freq_shift=u["freq_shift"],
        dtype=cfg["unet_dtype"], attn_impl=cfg["attn_impl"])


def vae_config(cfg: dict):
    from diffusion_pullback_tpu_torch.models.configs import VAEConfig

    v = cfg["vae"]
    return VAEConfig(
        sample_size=v["sample_size"], in_channels=v["in_channels"],
        out_channels=v["out_channels"], latent_channels=v["latent_channels"],
        block_out_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"], norm_num_groups=v["norm_num_groups"],
        scaling_factor=v["scaling_factor"], attn_impl=cfg["attn_impl"],
        dtype=cfg["vae_dtype"])


def text_config(cfg: dict):
    from diffusion_pullback_tpu_torch.models.configs import CLIPTextConfig

    t = cfg["text_encoder"]
    return CLIPTextConfig(
        vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
        intermediate_size=t["intermediate_size"], num_layers=t["num_hidden_layers"],
        num_heads=t["num_attention_heads"], max_length=t["max_position_embeddings"],
        hidden_act=t["hidden_act"], dtype=cfg["text_dtype"])


# weight streams of one run: one draw per module
STREAM_UNET, STREAM_VAE, STREAM_TEXT, STREAM_EMB = range(4)


def context_shape(cfg: dict):
    return (1, cfg["text_encoder"]["max_position_embeddings"],
            cfg["unet"]["cross_attention_dim"])


def draw_context(cfg: dict, seed: int, device) -> torch.Tensor:
    """The empty prompt's conditioning (1, 77, C): unit-variance tokens,
    as a final LayerNorm with unit scale gives them."""
    gen = torch.Generator(device=device).manual_seed(weights.stream_seed(seed, STREAM_EMB))
    return torch.randn(context_shape(cfg), generator=gen, device=device)


def latent_shape(cfg: dict):
    u = cfg["unet"]
    return (1, u["sample_size"], u["sample_size"], u["in_channels"])


def draw_latent(cfg: dict, seed: int, unit: int, device) -> torch.Tensor:
    """Unit ``unit``'s z_t (1, H, W, C), NHWC."""
    gen = torch.Generator(device=device).manual_seed(
        weights.stream_seed(seed, 1000 + unit))
    return torch.randn(latent_shape(cfg), generator=gen, device=device)


def unit_seed(seed: int, unit: int) -> int:
    """The probe seed of unit ``unit`` (the driver's cfg.seed)."""
    return weights.stream_seed(seed, 100_000 + unit)


def grid_timesteps(for_steps: int) -> np.ndarray:
    """The forward DDIM grid's t of each step: linspace(0, 1, n)·999 from
    the top, its last entry 0 left out (the paper's sampler)."""
    seq = np.linspace(0.0, 1.0, for_steps) * 999.0
    return seq[1:][::-1].astype(np.float32)


def unit_t(traffic: dict, seed: int, unit: int) -> float:
    """The grid t of unit ``unit``: the traffic's t grid cycled from an
    offset drawn from the seed, snapped to the forward grid as the
    harvest snaps it (the nearest of t·1000)."""
    grid = traffic["t_grid"]
    offset = np.random.default_rng(seed).integers(len(grid))
    t = grid[(offset + unit) % len(grid)]
    ts = grid_timesteps(traffic["for_steps"])
    return float(ts[int(np.argmin(np.abs(ts - t * 1000.0)))])


class System:
    """The port's driver for one run (configuration, traffic, seed)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, workdir: str,
                 parts: Optional[dict] = None):
        if traffic.get("entry") not in ENTRIES:
            raise ValueError(f"traffic entry {traffic.get('entry')!r}: the benchmark "
                             f"drives {ENTRIES}")
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.spans = []   # (name, unit, start, seconds) of the benchmark's own spans
        parts = {} if parts is None else parts
        with self.phase("import_program", parts):
            from diffusion_pullback_tpu_torch.experiments import (EditStableDiffusion,
                                                                   SDExperimentConfig)
            from diffusion_pullback_tpu_torch.models import (AutoencoderKL, CLIPTextModel,
                                                             UNet2DCondition)
            from diffusion_pullback_tpu_torch.ops import flash_attention
            from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
            from diffusion_pullback_tpu_torch.utils.logging import JSONLLogger

            from ..reference.unet import layout
        with self.phase("device_init", parts):
            torch.zeros(1, device=self.device)
        if self.device.type == "cuda":
            with self.phase("kernel_library", parts):   # built on a checkout's first run
                flash_attention.design("K1", 64, torch.bfloat16)
        with self.phase("modules", parts):
            with self.device:
                unet = UNet2DCondition(unet_config(cfg))
                vae = AutoencoderKL(vae_config(cfg))
                text = CLIPTextModel(text_config(cfg))
        want = {n: tuple(s) for n, s in layout(cfg["unet"]).items()}
        have = {n: tuple(t.shape) for n, t in unet.state_dict().items()}
        if want != have:
            raise RuntimeError("the port's U-Net does not have the diffusers layout: "
                               f"{sorted(set(want.items()) ^ set(have.items()))[:6]}")
        with self.phase("weights", parts):
            for stream, module in ((STREAM_UNET, unet), (STREAM_VAE, vae),
                                   (STREAM_TEXT, text)):
                weights.fill_(module.state_dict(), seed, stream)
        with self.phase("driver", parts):
            self.log_path = os.path.join(workdir, "log.jsonl")
            ex = SDExperimentConfig(
                dataset_name="noise", for_steps=traffic["for_steps"],
                inv_steps=traffic["for_steps"], seed=0, pca_rank=traffic["pca_rank"],
                pullback_min_iter=traffic["pullback_min_iter"],
                pullback_max_iter=traffic["pullback_max_iter"],
                pullback_atol=traffic["pullback_atol"],
                pullback_attn_impl=cfg["attn_impl"],
                result_folder=os.path.join(workdir, "results"),
                obs_folder=os.path.join(workdir, "obs"),
                basis_folder=os.path.join(workdir, "bases"))
            self.edit = EditStableDiffusion(
                unet, vae, text, DiffusionSchedule.from_name("scaled_linear"), None, ex,
                logger=JSONLLogger(self.log_path, echo=False), device=self.device)
            ctx = draw_context(cfg, seed, self.device)
            for attr in ("for_prompt_emb", "neg_prompt_emb", "null_prompt_emb",
                         "inv_prompt_emb", "edit_prompt_emb"):
                setattr(self.edit, attr, ctx)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str, parts: dict):
        """Time a step of set-up into ``parts`` (host clock, synchronised)."""
        t0 = time.perf_counter()
        yield
        self._sync()
        parts[name] = time.perf_counter() - t0

    def tap(self):
        from diffusion_pullback_tpu_torch.models import TapPoint

        op, block = self.traffic["tap"]
        return TapPoint(op, block)

    @contextlib.contextmanager
    def span(self, name: str, unit: int):
        t0 = time.perf_counter()
        yield
        self._sync()
        self.spans.append((name, unit, t0, time.perf_counter() - t0))

    def unit(self, k: int, warm: bool = False) -> str:
        """Run unit ``k``; returns its basis file. ``warm``: the same calls
        with one power iteration (set-up's warm-up of every shape)."""
        edit, tr = self.edit, self.traffic
        if warm:
            edit.cfg.pullback_min_iter, edit.cfg.pullback_max_iter = 0, 1
        try:
            edit.cfg.seed = unit_seed(self.seed, k)
            z = draw_latent(self.cfg, self.seed, k, self.device)
            t = torch.tensor(unit_t(tr, self.seed, k), dtype=torch.float32)
            with self.span("pullback", k):
                res = edit.compute_local_basis(z, t, self.tap(), tr["pca_rank"])
            with self.span("save", k):
                path = edit._save_basis(f"unit-{k:05d}" + ("-warm" if warm else ""), res)
        finally:
            edit.cfg.pullback_min_iter = tr["pullback_min_iter"]
            edit.cfg.pullback_max_iter = tr["pullback_max_iter"]
        return path

    def stage_events(self) -> list:
        """The driver's synchronised stage events, in order."""
        with open(self.log_path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def close(self) -> None:
        """Free the program's state (its modules and cached blocks)."""
        self.edit.log.close()
        del self.edit
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


DPB_MAGIC = 0x53425044  # 'DPBS' little-endian


def read_basis(path: str):
    """(u, s, vT) of a basis file as the program writes it: .dpb (a
    32-byte header of eight little-endian u32 — magic, version, u rows, u
    cols, k, vT rows, vT cols, 0 — then u, s, vT as float32) or .npz."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z["u"], z["s"], z["vT"]
    head = np.fromfile(path, dtype="<u4", count=8)
    if len(head) != 8 or head[0] != DPB_MAGIC or head[1] != 1:
        raise ValueError(f"not a basis file: {path}")
    u0, u1, k, v0, v1 = (int(x) for x in head[2:7])
    data = np.fromfile(path, dtype="<f4", offset=32)
    if data.size != u0 * u1 + k + v0 * v1:
        raise ValueError(f"truncated basis file {path}")
    return (data[:u0 * u1].reshape(u0, u1), data[u0 * u1:u0 * u1 + k],
            data[u0 * u1 + k:].reshape(v0, v1))
