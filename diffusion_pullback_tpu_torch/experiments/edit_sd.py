"""Stable-Diffusion editing along the encoder pullback basis.

Counterpart of the main-path subset of EditStableDiffusion in
diffusion_pullback_tpu/experiments/edit_sd.py:

    VAE encode → DDIM inversion → DDIM forward to the edit t → encoder
    pullback at a U-Net tap (edit-prompt conditioned) → x-space-guidance
    walk along ±v_k → DDIM finish → VAE decode → PNG grids.

Latents, ``vT`` and the basis cache are NHWC at this boundary, as in the JAX
package, so ``vT`` rows flatten in the same order and a basis from either
package loads in the other; the models run NCHW inside. The JAX driver's
vmap over edit directions is a batch dimension here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..geometry import PullbackResult, local_pullback
from ..models import AutoencoderKL, CLIPTextModel, TapPoint, UNet2DCondition
from ..models.clip_text import load_tokenizer
from ..models.layers import attn_impl_as
from ..ops.schedule import DiffusionSchedule, ddim_timestep_grid
from ..samplers.ddim_loop import ddim_forward, ddim_invert
from ..samplers.guidance import x_space_guidance_scan
from ..utils.device import resolve_device, strict_f32
from ..utils.images import save_image_grid
from ..utils.logging import JSONLLogger
from ._common import DriverCommonMixin, to_nchw, to_nhwc
from .cache import BasisCache, basis_name


@dataclasses.dataclass
class SDExperimentConfig:
    dataset_name: str = "Examples"
    for_steps: int = 100
    inv_steps: int = 100
    edit_t: float = 0.7
    seed: int = 0
    guidance_scale: float = 0.0
    for_prompt: str = ""
    neg_prompt: str = ""
    inv_prompt: str = ""
    edit_prompt: str = ""
    x_space_guidance_edit_step: float = 1.0
    x_space_guidance_scale: float = 1.0
    x_space_guidance_num_step: int = 16
    # (ε_null, ε_edit) evaluation of the walk: 'batch' | 'split'
    xsg_pair_impl: str = "batch"
    pca_rank: int = 2
    pullback_min_iter: int = 10
    pullback_max_iter: int = 50
    pullback_atol: float = 1e-4
    pullback_chunk_size: Optional[int] = None
    # attention inside the differentiated encoder ('' = the model's own;
    # 'flash' = the fused JVP/VJP kernel pair)
    pullback_attn_impl: str = ""
    result_folder: str = "./runs/sd"
    basis_folder: str = "./inputs/local_encoder_pullback_stable_diffusion"
    vis_num: int = 4
    vis_num_pc: int = 2


class EditStableDiffusion(DriverCommonMixin):
    def __init__(
        self,
        unet: UNet2DCondition,
        vae: AutoencoderKL,
        text_model: CLIPTextModel,
        schedule: DiffusionSchedule,
        dataset,
        config: SDExperimentConfig,
        tokenizer=None,
        logger: Optional[JSONLLogger] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        strict_f32()
        prep = lambda m: m.to(self.device).eval().requires_grad_(False)
        self.unet, self.vae, self.text_model = prep(unet), prep(vae), prep(text_model)
        self.schedule = schedule.to(self.device)
        self.dataset = dataset
        self.cfg = config
        self.tokenizer = tokenizer or load_tokenizer(text_model.config)
        self.log = logger or JSONLLogger(
            os.path.join(config.result_folder, "log.jsonl"))
        self.cache = BasisCache(config.basis_folder)

        self.fwd_grid = ddim_timestep_grid(config.for_steps)
        self.inv_grid = ddim_timestep_grid(config.inv_steps, inversion=True)
        self.edit_t_idx = int(torch.argmin(
            torch.abs(self.fwd_grid.timesteps - config.edit_t * 1000.0)))

        with self._stage("sd_prompts_embedded"):
            self.for_prompt_emb = self._get_emb(config.for_prompt)
            self.neg_prompt_emb = self._get_emb(config.neg_prompt)
            self.inv_prompt_emb = self._get_emb(config.inv_prompt)
            self.edit_prompt_emb = self._get_emb(config.edit_prompt)

    # ---- prompt / ε ---------------------------------------------------------

    @torch.no_grad()
    def _get_emb(self, prompt: str) -> torch.Tensor:
        ids = torch.as_tensor(self.tokenizer([prompt]), dtype=torch.long,
                              device=self.device)
        return self.text_model(ids)

    def eps_with(self, prompt_emb, cfg_neg_emb=None):
        """ε(z, t) on NHWC latents; with ``cfg_neg_emb`` and guidance_scale
        > 1, classifier-free guidance as one fused 2·B batch."""
        scale = self.cfg.guidance_scale

        def unet(z, t, ctx):
            return to_nhwc(self.unet(to_nchw(z), t, ctx))

        if cfg_neg_emb is None or scale <= 1.0:
            return lambda z, t: unet(z, t, prompt_emb)

        def fn(z, t):
            b = z.shape[0]
            ctx = torch.cat([cfg_neg_emb.expand(b, -1, -1),
                             prompt_emb.expand(b, -1, -1)])
            e_un, e_c = unet(torch.cat([z, z]), t, ctx).chunk(2)
            return e_un + scale * (e_c - e_un)

        return fn

    # ---- pipelines --------------------------------------------------------

    @torch.no_grad()
    def encode_image(self, idx: int) -> torch.Tensor:
        x0 = torch.as_tensor(self.dataset[idx], device=self.device)
        return to_nhwc(self.vae.encode(to_nchw(x0))).float()

    @torch.no_grad()
    def run_DDIMinversion(self, idx: int) -> torch.Tensor:
        """image → z0 (VAE, ×scaling) → zT, NHWC."""
        with self._stage("sd_vae_encoded", idx=idx):
            z0 = self.encode_image(idx)
        with self._stage("sd_ddim_inversion", idx=idx):
            zT = ddim_invert(self.eps_with(self.inv_prompt_emb), z0,
                             self.schedule, self.inv_grid)
        return zT

    @torch.no_grad()
    def DDIMforwardsteps(self, zt, t_start_idx, t_end_idx=None):
        return ddim_forward(
            self.eps_with(self.for_prompt_emb, self.neg_prompt_emb), zt,
            self.schedule, self.fwd_grid, start_idx=t_start_idx,
            end_idx=t_end_idx)

    @torch.no_grad()
    def decode_latents(self, z) -> np.ndarray:
        """NHWC latents → NHWC images in [-1, 1] on the host."""
        return to_nhwc(self.vae.decode(to_nchw(z))).float().cpu().numpy()

    def _pullback_tap_encoders(self, t, tap: TapPoint):
        """(encode, encode_vjp or None, impl tag) of the edit-prompt encoder
        z → h at ``tap`` (NHWC on both sides, so u and vT flatten as in the
        JAX package).

        'flash' (or '' with a U-Net that runs 'flash') maps to the fused
        kernel pair: the tangent half runs the forward-mode kernels
        ('flash_jvp'), the cotangent half the reverse-mode ones ('flash').
        Both run the same weights; each call sets its own impl, because the
        vjp's backward runs inside the loop between the tangent passes."""
        impl = self.cfg.pullback_attn_impl or self.unet.config.attn_impl
        emb = self.edit_prompt_emb

        def encoder(attn_impl):
            def enc(z):
                with attn_impl_as(self.unet, attn_impl):
                    return to_nhwc(self.unet.encode(to_nchw(z), t, emb, tap))
            return enc

        if impl in ("flash", "flash_jvp"):
            return encoder("flash_jvp"), encoder("flash"), "flashpair"
        return encoder(impl), None, impl

    def compute_local_basis(self, zt, t, tap: TapPoint, pca_rank: int
                            ) -> PullbackResult:
        """Pullback of the edit-prompt encoder z → h at ``tap``."""
        enc, enc_vjp, tag = self._pullback_tap_encoders(t, tap)
        with self._stage("sd_local_pullback", encoder=tag) as log:
            res = local_pullback(
                enc, zt, torch.Generator().manual_seed(self.cfg.seed),
                pca_rank=pca_rank, min_iter=self.cfg.pullback_min_iter,
                max_iter=self.cfg.pullback_max_iter,
                atol=self.cfg.pullback_atol, fn_vjp=enc_vjp,
                chunk_size=self.cfg.pullback_chunk_size)
            log.update(iterations=res.iterations,
                       top_s=res.s[:3].float().cpu().numpy().round(4))
        return res

    def run_edit_local_encoder_pullback_zt(
        self,
        idx: int,
        op: str = "mid",
        block_idx: int = 0,
        pca_rank: Optional[int] = None,
        vis_num: Optional[int] = None,
        vis_num_pc: Optional[int] = None,
        edit_prompt: Optional[str] = None,
    ):
        """The headline SD experiment; returns the names of the PNGs."""
        cfg = self.cfg
        if edit_prompt is not None:
            cfg.edit_prompt = edit_prompt
            self.edit_prompt_emb = self._get_emb(edit_prompt)
        pca_rank = pca_rank or cfg.pca_rank
        vis_num = vis_num or cfg.vis_num
        vis_num_pc = vis_num_pc or cfg.vis_num_pc
        tap = TapPoint(op, block_idx)

        zT = self.run_DDIMinversion(idx)
        with self._stage("sd_ddim_forward_to_edit", steps=self.edit_t_idx):
            zt = self.DDIMforwardsteps(zT, 0, self.edit_t_idx)
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        u, s, vT = self._cached_local_basis(zt, t_edit, tap, pca_rank, idx)

        shape = zt.shape[1:]
        vks, names = [], []
        for pc in range(vis_num_pc):
            for sign, tag in ((1.0, "pos"), (-1.0, "neg")):
                vks.append(sign * vT[pc].reshape(shape))
                names.append(
                    f"Edit_zt-{cfg.dataset_name}_{idx}-edit_{cfg.edit_t}T-{op}"
                    f"-block_{block_idx}-pc_{pc:03d}_{tag}"
                    f"-edit_prompt_{cfg.edit_prompt}")
        return self._edit_along_directions(zt, vks, names, vis_num)

    def _cached_local_basis(self, zt, t_edit, tap, pca_rank, idx):
        """Load-or-compute (u, s, vT); factors come back column/row
        normalised."""
        cfg = self.cfg
        name = basis_name(cfg.dataset_name, idx, cfg.edit_t, tap.op,
                          tap.block_idx, cfg.seed, edit_prompt=cfg.edit_prompt,
                          pca_rank=pca_rank)
        cached = self.cache.load(name)
        if cached is not None:
            u, s, vT = (torch.as_tensor(np.asarray(a), device=self.device)
                        for a in cached)
            self.log.log("basis_cache_hit", name=name)
        else:
            res = self.compute_local_basis(zt, t_edit, tap, pca_rank)
            u, s, vT = res.u.float(), res.s, res.vT
            self.cache.save(name, u.cpu().numpy(), s.cpu().numpy(),
                            vT.cpu().numpy())
        u = u / torch.linalg.norm(u, dim=0, keepdim=True)
        vT = vT / torch.linalg.norm(vT, dim=1, keepdim=True)
        return u, s, vT

    @torch.no_grad()
    def _guidance_walk(self, z_start, vks, t_edit):
        """The x-space-guidance micro-walk, edit-prompt conditioned, for a
        batch of directions at once: (num_step + 1, D, H, W, C)."""
        cfg = self.cfg
        z = z_start.expand(vks.shape[0], *z_start.shape[1:])
        return x_space_guidance_scan(
            self.eps_with(self.edit_prompt_emb), z, t_edit, vks,
            num_steps=cfg.x_space_guidance_num_step,
            edit_step=cfg.x_space_guidance_edit_step,
            scale=cfg.x_space_guidance_scale, pair_impl=cfg.xsg_pair_impl)

    def _edit_along_directions(self, zt, vks, names, vis_num):
        """Walks for every direction whose PNG is missing, the finish
        sampling of the selected frames, VAE decode, one PNG grid each."""
        cfg = self.cfg
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        todo = [i for i, n in enumerate(names) if not os.path.exists(
            os.path.join(cfg.result_folder, n + ".png"))]
        if not todo:
            self.log.log("all_edits_cached")
            return names
        stride = max(1, (cfg.x_space_guidance_num_step + 1) // vis_num)

        with self._stage("sd_x_space_guidance_walk", directions=len(todo)):
            traj = self._guidance_walk(
                zt, torch.stack([vks[i] for i in todo]), t_edit)
        sel = traj[::stride].transpose(0, 1)       # (D, frames, H, W, C)
        d, f = sel.shape[:2]
        with self._stage("sd_finish_forward", batch=d * f):  # edit_t → 0
            z0s = self.DDIMforwardsteps(sel.reshape(d * f, *sel.shape[2:]),
                                        self.edit_t_idx)
            z0s = z0s.reshape(d, f, *z0s.shape[1:])
        with self._stage("sd_decode_and_save", directions=d) as log:
            finite = bool(torch.isfinite(z0s).all())
            for j, i in enumerate(todo):
                imgs = self.decode_latents(z0s[j])
                finite &= bool(np.isfinite(imgs).all())
                save_image_grid(imgs, os.path.join(cfg.result_folder,
                                                   names[i] + ".png"))
            log.update(finite=finite)
        return names
