"""Stable-Diffusion-XL editing along pullback directions.

Counterpart of EditStableDiffusionXL in
diffusion_pullback_tpu/experiments/edit_sdxl.py. Only the conditioning
differs from the SD driver:

  - two text towers, CLIP ViT-L (768) and OpenCLIP bigG (1280), each read
    at its penultimate layer; their concatenation (2048) is the U-Net's
    cross-attention context;
  - the bigG tower's pooled, projected embedding and the micro-conditioning
    time_ids (original size, crop, target size) feed the U-Net's addition
    embeddings;
  - the VAE's scaling factor 0.13025, carried by its config.

A prompt embedding is the pair (context, pooled). It goes through the SD
driver's conditioning hooks, so every pipeline of that driver (inversion,
forward, the encoder pullback with CFG inside the JVP, the decoder and x̂₀
pullbacks, the text-driven edit, DeepCache, run_DDIMforward) runs on SDXL
unchanged: this class overrides ``_get_emb`` and ``_unet_cond`` only.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import AutoencoderKL, CLIPTextModel, UNet2DCondition
from ..models.clip_text import load_tokenizer
from ..ops.schedule import DiffusionSchedule
from ..utils.device import resolve_device
from ..utils.logging import JSONLLogger
from .edit_sd import EditStableDiffusion, SDExperimentConfig


class EditStableDiffusionXL(EditStableDiffusion):
    def __init__(
        self,
        unet: UNet2DCondition,
        vae: AutoencoderKL,
        text_model_1: CLIPTextModel,
        text_model_2: CLIPTextModel,
        schedule: DiffusionSchedule,
        dataset,
        config: SDExperimentConfig,
        tokenizer_1=None,
        tokenizer_2=None,
        logger: Optional[JSONLLogger] = None,
        device=None,
    ):
        # the second tower and the time_ids first: the SD driver embeds the
        # prompts in its __init__, through _get_emb
        device = resolve_device(device)
        self.text_model_2 = text_model_2.to(device).eval().requires_grad_(False)
        self.tokenizer_2 = tokenizer_2 or load_tokenizer(text_model_2.config)
        # micro-conditioning: original size = target size, no crop (the
        # time_ids SDXL pipelines use by default)
        side = float(unet.config.sample_size * 8)
        self._time_ids = torch.tensor([[side, side, 0.0, 0.0, side, side]],
                                      device=device)
        super().__init__(unet, vae, text_model_1, schedule, dataset, config,
                         tokenizer=tokenizer_1, logger=logger, device=device)

    def _replicated_modules(self):
        return super()._replicated_modules() + [self.text_model_2]

    @torch.no_grad()
    def _get_emb(self, prompt: str):
        """Prompt → ((1, 77, 2048) context, (1, 1280) pooled)."""
        h1 = self.text_model(self._ids(self.tokenizer, prompt), penultimate=True)
        h2, pooled = self.text_model_2(self._ids(self.tokenizer_2, prompt),
                                       return_pooled=True, penultimate=True)
        return torch.cat([h1, h2], dim=-1), pooled

    def _unet_cond(self, emb, batch: int):
        """(context, (pooled, time_ids) at ``batch`` rows)."""
        ctx, pooled = emb
        return ctx, (pooled.expand(batch, *pooled.shape[1:]),
                     self._time_ids.expand(batch, -1))
