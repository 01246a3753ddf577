"""Stable-Diffusion editing along pullback directions.

Counterpart of EditStableDiffusion in
diffusion_pullback_tpu/experiments/edit_sd.py (the harvests are in
sd_harvest.py, the PCA runs in sd_pca.py):

    VAE encode → DDIM inversion → DDIM forward to the edit t → a direction
    (the encoder pullback at a U-Net tap, edit-prompt conditioned, with CFG
    inside the JVP when pullback_guidance_scale > 0; the decoder or x̂₀
    pullback pulled back through the encoder's Jᵀ; or the text-driven
    JᵀΔh) → x-space-guidance walk along ±v_k → the post-edit regularizers
    the config turns on → DDIM finish (walk and finish with optional
    DeepCache reuse) → VAE decode → PNG grids.

Latents, ``vT`` and the basis cache are NHWC at this boundary, as in the JAX
package, so ``vT`` rows flatten in the same order and a basis from either
package loads in the other; the models run NCHW inside. The JAX driver's
vmap over edit directions is a batch dimension here.

A prompt embedding is an opaque conditioning that only three hooks look
inside: ``_get_emb`` makes it, ``_unet_cond`` turns it into the U-Net's
(context, added_cond) at a batch, and ``_stack_cond`` stacks two of them
into the rows of one fused 2·B batch. Here it is the (1, 77, C) context;
the SDXL driver (edit_sdxl.py) overrides the first two for its
(context, pooled) pair.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..geometry import (
    PullbackResult,
    local_decoder_pullback,
    local_encoder_pullback,
    pullback_covector,
)
from ..models import AutoencoderKL, CLIPTextModel, TapPoint, UNet2DCondition
from ..models.clip_text import load_tokenizer
from ..models.layers import attn_impl_as
from ..ops.ddim import predict_x0
from ..ops.schedule import DiffusionSchedule, alpha_bar, ddim_timestep_grid
from ..samplers.ddim_loop import ddim_forward, ddim_invert
from ..samplers.deepcache import ddim_forward_deepcache_cond
from ..samplers.guidance import (
    x_space_guidance_scan,
    x_space_guidance_scan_deepcache,
)
from ..utils.device import resolve_device, strict_f32
from ..utils.images import save_image_grid
from ..utils.logging import JSONLLogger
from ._common import DriverCommonMixin, to_nchw, to_nhwc
from .cache import BasisCache, basis_name
from .sd_harvest import SDHarvestMixin
from .sd_pca import SDPCAMixin


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
    # each cotangent pass of the pullback runs its own vjp, so the map's
    # activations live only during the pass (SDXL)
    pullback_remat: bool = False
    # attention inside the differentiated encoder ('' = the model's own;
    # 'flash' = the fused JVP/VJP kernel pair)
    pullback_attn_impl: str = ""
    # CFG inside the JVP'd encoder (BASELINE config 4): > 0 differentiates
    # h_edit + s·(h_edit − h_neg) as one fused 2·B batch; 0 the edit-prompt
    # encoder alone
    pullback_guidance_scale: float = 0.0
    # DeepCache on the finish (edit_t → 0) and on the guidance walk: refresh
    # the deep U-Net path every N steps / micro-steps; 0 or 1 = the full
    # model every step
    edit_deepcache_interval: int = 0
    guidance_deepcache_interval: int = 0
    # run_edit_text_driven_direction: 0 = one JᵀΔh direction; k > 0 = Δh
    # decomposed in the top-k pullback basis, each PC walked separately
    text_driven_num_pc: int = 0
    # post-edit regularizers of the walk frames before the finish
    # (samplers/regularizers.py), in this order
    use_dynamic_thresholding: bool = False
    dynamic_thresholding_q: float = 0.8
    use_preserve_contrast: bool = False
    use_preserve_norm: bool = False
    # decode at most this many latents per VAE call (None = all at once):
    # bounds the VAE's activations at 1024 px
    decode_chunk: Optional[int] = None
    # a device mesh (parallel.make_mesh): 'probe' shards the pullback's
    # probes, 'dp' the harvests' sweeps, 'tp' the U-Net's weights, 'sp' the
    # sequence of ring attention
    mesh: Optional[object] = None
    # 'on': the per-step ε and the VAE encode / decode through the export
    # cache (utils/aot.py); 'auto' and 'off' run them eagerly
    aot_export: str = "off"
    result_folder: str = "./runs/sd"
    # the analysis artifacts of freshly computed bases
    obs_folder: str = "./runs/sd/obs"
    basis_folder: str = "./inputs/local_encoder_pullback_stable_diffusion"
    vis_num: int = 4
    vis_num_pc: int = 2


class EditStableDiffusion(DriverCommonMixin, SDPCAMixin, SDHarvestMixin):
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
        # on a mesh the U-Net takes the tensor-parallel layout when it has a
        # 'tp' axis; the VAE and the text towers are replicated
        self.unet = self._place_weights(self.unet)
        if config.mesh is not None:
            for m in self._replicated_modules():
                self._replicate(m)
        self.tokenizer = tokenizer or load_tokenizer(text_model.config)
        self.log = logger or JSONLLogger(
            os.path.join(config.result_folder, "log.jsonl"))
        self.cache = BasisCache(config.basis_folder)

        self.fwd_grid = ddim_timestep_grid(config.for_steps)
        self.inv_grid = ddim_timestep_grid(config.inv_steps, inversion=True)
        self.edit_t_idx = self._t_index(config.edit_t)

        with self._stage("sd_prompts_embedded"):
            self.for_prompt_emb = self._get_emb(config.for_prompt)
            self.neg_prompt_emb = self._get_emb(config.neg_prompt)
            self.null_prompt_emb = self._get_emb("")
            self.inv_prompt_emb = self._get_emb(config.inv_prompt)
            self.edit_prompt_emb = self._get_emb(config.edit_prompt)

    @property
    def _arch_config(self):
        return self.unet.config

    def _replicated_modules(self):
        """The modules a mesh replicates (the SDXL driver adds its second
        text tower)."""
        return [self.vae, self.text_model]

    # ---- prompt / ε ---------------------------------------------------------

    def _ids(self, tokenizer, prompt: str) -> torch.Tensor:
        return torch.as_tensor(tokenizer([prompt]), dtype=torch.long,
                               device=self.device)

    @torch.no_grad()
    def _get_emb(self, prompt: str):
        """Prompt → its conditioning: the tower's (1, 77, C) hidden states."""
        return self.text_model(self._ids(self.tokenizer, prompt))

    def _unet_cond(self, emb, batch: int):
        """A conditioning → the U-Net's (context, added_cond) for ``batch``
        rows; a batch-1 context broadcasts inside the U-Net."""
        return emb, None

    @staticmethod
    def _stack_cond(first, second, batch: int):
        """Two conditionings (batch 1 or ``batch``) stacked into the
        2·``batch`` rows [first; second] of a fused pair, leaf by leaf."""
        if isinstance(first, tuple):
            return tuple(EditStableDiffusion._stack_cond(a, b, batch)
                         for a, b in zip(first, second))
        return torch.cat([first.expand(batch, *first.shape[1:]),
                          second.expand(batch, *second.shape[1:])])

    def eps_with(self, prompt_emb, cfg_neg_emb=None):
        """ε(z, t) on NHWC latents; with ``cfg_neg_emb`` and guidance_scale
        > 1, classifier-free guidance as one fused 2·B batch."""
        scale = self.cfg.guidance_scale

        def unet(z, t, emb):
            ctx, added = self._unet_cond(emb, z.shape[0])
            return to_nhwc(self.unet(to_nchw(z), t, ctx, added))

        if cfg_neg_emb is None or scale <= 1.0:
            return lambda z, t: unet(z, t, prompt_emb)

        def fn(z, t):
            b = z.shape[0]
            emb2 = self._stack_cond(cfg_neg_emb, prompt_emb, b)
            e_un, e_c = unet(torch.cat([z, z]), t, emb2).chunk(2)
            return e_un + scale * (e_c - e_un)

        return fn

    def _eps_program(self, prompt_emb, cfg_neg_emb=None):
        """``eps_with(prompt_emb, cfg_neg_emb)`` as the program 'eps' (or
        'eps_cfg' with classifier-free guidance) of the U-Net's weights,
        with the embeddings as arguments: the per-step ε of the DDIM
        loops."""
        cfg_on = cfg_neg_emb is not None and self.cfg.guidance_scale > 1.0
        embs = (prompt_emb, cfg_neg_emb) if cfg_on else (prompt_emb,)
        prog = self._program("eps_cfg" if cfg_on else "eps",
                             lambda z, t, e: self.eps_with(*e)(z, t), self.unet)
        return lambda z, t: prog(z, t, embs)

    # ---- pipelines --------------------------------------------------------

    @torch.no_grad()
    def encode_image(self, idx: int) -> torch.Tensor:
        x0 = torch.as_tensor(self.dataset[idx], device=self.device)
        enc = self._program("vae_encode", self.vae.encode, self.vae)
        return to_nhwc(enc(to_nchw(x0))).float()

    @torch.no_grad()
    def run_DDIMinversion(self, idx: int) -> torch.Tensor:
        """image → z0 (VAE, ×scaling) → zT, NHWC."""
        with self._stage("sd_vae_encoded", idx=idx):
            z0 = self.encode_image(idx)
        with self._stage("sd_ddim_inversion", idx=idx):
            zT = ddim_invert(self._eps_program(self.inv_prompt_emb), z0,
                             self.schedule, self.inv_grid)
        return zT

    @torch.no_grad()
    def DDIMforwardsteps(self, zt, t_start_idx, t_end_idx=None):
        return ddim_forward(
            self._eps_program(self.for_prompt_emb, self.neg_prompt_emb), zt,
            self.schedule, self.fwd_grid, start_idx=t_start_idx,
            end_idx=t_end_idx)

    @torch.no_grad()
    def decode_latents(self, z) -> np.ndarray:
        """NHWC latents → NHWC images in [-1, 1] on the host, at most
        ``decode_chunk`` latents per VAE call."""
        chunk = self.cfg.decode_chunk or z.shape[0]
        dec = self._program("vae_decode", self.vae.decode, self.vae)
        return np.concatenate([
            to_nhwc(dec(to_nchw(z[i:i + chunk]))).float().cpu().numpy()
            for i in range(0, z.shape[0], chunk)])

    @torch.no_grad()
    def run_DDIMforward(self, num_samples: int = 5, save_as: Optional[str] = None,
                        generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Sample from seeded noise (zT drawn on the CPU from ``generator``,
        by default one seeded with cfg.seed) through the full forward grid
        and decode; NHWC images in [-1, 1] on the host."""
        zT = self._draw_latents(num_samples, generator)
        with self._stage("sd_ddim_forward", num_samples=num_samples):
            z0 = self.DDIMforwardsteps(zT, 0)
        with self._stage("sd_decode_and_save", directions=1) as log:
            x0 = self.decode_latents(z0)
            log.update(finite=bool(np.isfinite(x0).all()))
            if save_as:
                save_image_grid(x0, save_as)
        return x0

    @property
    def _sample_shape(self):
        """(H, W, C) of one NHWC latent at the U-Net's size."""
        s, c = self.unet.config.sample_size, self.unet.config.in_channels
        return s, s, c

    # ---- tap encoders -------------------------------------------------------

    def _encoder(self, t, tap: TapPoint, attn_impl: str):
        """enc(z, emb): the tapped h of NHWC latents z, NHWC, with every
        attention layer set to ``attn_impl`` for the call (so u and vT
        flatten as in the JAX package)."""
        def enc(z, emb):
            ctx, added = self._unet_cond(emb, z.shape[0])
            with attn_impl_as(self.unet, attn_impl):
                return to_nhwc(self.unet.encode(to_nchw(z), t, ctx, tap, added))
        return enc

    def _pair_impls(self):
        """(tangent impl, cotangent impl or None) of a differentiated U-Net:
        'flash' (or '' with a U-Net that runs 'flash') maps to the fused
        kernel pair, 'flash_jvp' (K2/K3) for the tangent half and 'flash'
        (K2/K4/K5) for the cotangent half. Both run the same weights; each
        call sets its own impl, because the vjp's backward runs inside the
        loop between the tangent passes."""
        impl = self.cfg.pullback_attn_impl or self.unet.config.attn_impl
        if impl in ("flash", "flash_jvp"):
            return "flash_jvp", "flash"
        if impl == "ring":
            # the ring's flash inner (K2) is primal only; the differentiated
            # encoder rings over the math path, as the JAX driver does
            return "ring_xla", None
        return impl, None

    def _tap_encode_with_state(self, z, t, emb, tap: TapPoint):
        """(h at ``tap``, the state that resumes the pass) of NHWC latents;
        h and the state in the U-Net's NCHW layout."""
        ctx, added = self._unet_cond(emb, z.shape[0])
        return self.unet.encode_with_state(to_nchw(z), t, ctx, tap, added)

    def _tap_decode_with_state(self, h, state, tap: TapPoint):
        """ε (NHWC) resumed from a (possibly perturbed) h at ``tap``."""
        return to_nhwc(self.unet.decode_with_state(h, state, tap))

    def _vjp_encoder(self, t, tap: TapPoint, emb):
        """z → h at ``tap`` for a reverse-mode pass (Jᵀu)."""
        impl, impl_vjp = self._pair_impls()
        enc = self._encoder(t, tap, impl_vjp or impl)
        return lambda z: enc(z, emb)

    def _cfg_encoder(self, enc):
        """The CFG extrapolation h_edit + s·(h_edit − h_neg) of a tap encoder
        enc(z, emb), as one fused 2·B batch with the edit rows first; the
        wrapped encoder takes embs = (edit_emb, neg_emb). The probe axis of
        a vmapped pass stays outside the 2·B rows."""
        s = self.cfg.pullback_guidance_scale

        def f(z, embs):
            b = z.shape[0]
            h2 = enc(torch.cat([z, z]), self._stack_cond(*embs, b))
            return (1.0 + s) * h2[:b] - s * h2[b:]

        return f

    def _pullback_tap_encoders(self, t, tap: TapPoint, edit_emb=None):
        """(encode, encode_vjp or None, impl tag) of the encoder z → h at
        ``tap`` that the pullback differentiates: conditioned on
        ``edit_emb`` (default the edit prompt's), or with
        pullback_guidance_scale s > 0 the CFG extrapolation against the
        negative prompt (tag suffix '_cfg{s}'). The pair's tag is
        'flashpair'."""
        impl, impl_vjp = self._pair_impls()
        encs = [self._encoder(t, tap, impl),
                impl_vjp and self._encoder(t, tap, impl_vjp)]
        tag = "flashpair" if impl_vjp else impl
        s = self.cfg.pullback_guidance_scale
        emb = self.edit_prompt_emb if edit_emb is None else edit_emb
        if s > 0:
            encs = [e and self._cfg_encoder(e) for e in encs]
            emb = (emb, self.neg_prompt_emb)
            tag = f"{tag}_cfg{s}"
        bind = lambda e: e and (lambda z: e(z, emb))
        return bind(encs[0]), bind(encs[1]), tag

    def compute_local_basis(self, zt, t, tap: TapPoint, pca_rank: int,
                            edit_emb=None) -> PullbackResult:
        """Pullback of the encoder z → h at ``tap``, conditioned on
        ``edit_emb`` (default the edit prompt's); its probes sharded over
        the mesh's 'probe' axis where ``_mesh_probe_size`` allows."""
        enc, enc_vjp, tag = self._pullback_tap_encoders(t, tap, edit_emb)
        n_probe = self._mesh_probe_size(pca_rank)
        with self._stage("sd_local_pullback", encoder=tag,
                         probe_shards=n_probe or 1) as log:
            res = local_encoder_pullback(
                enc, zt, torch.Generator().manual_seed(self.cfg.seed),
                pca_rank=pca_rank, min_iter=self.cfg.pullback_min_iter,
                max_iter=self.cfg.pullback_max_iter,
                atol=self.cfg.pullback_atol, fn_vjp=enc_vjp,
                chunk_size=self.cfg.pullback_chunk_size, remat=self.cfg.pullback_remat,
                probe_group=self._probe_group(pca_rank))
            log.update(iterations=res.iterations,
                       top_s=res.s[:3].float().cpu().numpy().round(4))
        return res

    def _basis_name_extras(self, tap: TapPoint) -> str:
        """Cache-key qualifiers beyond basis_name: the intra-block tap and
        the CFG-inside-JVP scale change the differentiated map, so their
        bases must not shadow plain ones."""
        s = f"-after_{tap.inner[0]}{tap.inner[1]}" if tap.inner else ""
        if self.cfg.pullback_guidance_scale > 0:
            s += f"-cfg{self.cfg.pullback_guidance_scale}"
        return s

    def _set_edit_prompt(self, edit_prompt: Optional[str]):
        if edit_prompt is not None:
            self.cfg.edit_prompt = edit_prompt
            self.edit_prompt_emb = self._get_emb(edit_prompt)

    def _zt(self, idx: int) -> torch.Tensor:
        """The inverted latent of sample ``idx`` at the edit t."""
        zT = self.run_DDIMinversion(idx)
        with self._stage("sd_ddim_forward_to_edit", steps=self.edit_t_idx):
            return self.DDIMforwardsteps(zT, 0, self.edit_t_idx)

    # ---- experiments ------------------------------------------------------

    def run_edit_local_encoder_pullback_zt(
        self,
        idx: int,
        op: str = "mid",
        block_idx: int = 0,
        pca_rank: Optional[int] = None,
        vis_num: Optional[int] = None,
        vis_num_pc: Optional[int] = None,
        edit_prompt: Optional[str] = None,
        after_res: bool = False,
        after_sa: bool = False,
    ):
        """The headline SD experiment; returns the names of the PNGs.
        ``after_res`` / ``after_sa`` move a down tap after the block's last
        resnet / self-attention."""
        cfg = self.cfg
        self._set_edit_prompt(edit_prompt)
        pca_rank = pca_rank or cfg.pca_rank
        vis_num = vis_num or cfg.vis_num
        vis_num_pc = vis_num_pc or cfg.vis_num_pc
        tap = self._make_tap(op, block_idx, after_res, after_sa)

        zt = self._zt(idx)
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
        """Load-or-compute (u, s, vT), with the analysis artifacts of a
        computed one; factors come back column/row normalised."""
        cfg = self.cfg
        name = basis_name(cfg.dataset_name, idx, cfg.edit_t, tap.op,
                          tap.block_idx, cfg.seed, edit_prompt=cfg.edit_prompt,
                          pca_rank=pca_rank) + self._basis_name_extras(tap)
        cached = self.cache.load(name)
        if cached is not None:
            u, s, vT = (torch.as_tensor(np.asarray(a), device=self.device)
                        for a in cached)
            self.log.log("basis_cache_hit", name=name)
        else:
            res = self.compute_local_basis(zt, t_edit, tap, pca_rank)
            u, s, vT = res.u.float(), res.s, res.vT
            self._save_basis(name, res)
            self._vis_basis(name, s, vT, tuple(zt.shape[1:]))
        u = u / torch.linalg.norm(u, dim=0, keepdim=True)
        vT = vT / torch.linalg.norm(vT, dim=1, keepdim=True)
        return u, s, vT

    def run_edit_text_driven_direction(
        self,
        idx: int,
        op: str = "mid",
        block_idx: int = 0,
        vis_num: Optional[int] = None,
        num_pc: Optional[int] = None,
    ):
        """Edit along the direction the edit prompt moves the tapped feature:
        Δh = h(z_t | edit prompt) − h(z_t | null prompt) and v = JᵀΔh/‖JᵀΔh‖
        (one VJP), walked ±. With ``num_pc`` = k > 0 (default
        cfg.text_driven_num_pc) Δh is decomposed in the top-k pullback basis
        instead, c_k = ⟨u_k, Δh⟩, and each PC is walked along sign(c_k)·v_k,
        the largest |c_k| first; the share of ‖Δh‖² the basis captures is
        logged."""
        cfg = self.cfg
        vis_num = vis_num or cfg.vis_num
        num_pc = cfg.text_driven_num_pc if num_pc is None else num_pc
        tap = TapPoint(op, block_idx)

        zt = self._zt(idx)
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        ptag = (cfg.edit_prompt or "none").replace(" ", "_")[:40]
        shape = zt.shape[1:]
        enc = self._encoder(t_edit, tap, self.unet.config.attn_impl)
        with torch.no_grad():
            dh = (enc(zt, self.edit_prompt_emb).float()
                  - enc(zt, self.null_prompt_emb).float()).reshape(-1)

        vks, names = [], []
        if num_pc > 0:
            u, s, vT = self._cached_local_basis(zt, t_edit, tap, num_pc, idx)
            c = (u.T @ dh).cpu().numpy()
            captured = float((c ** 2).sum() / max(float(dh @ dh), 1e-12))
            self.log.log("text_driven_pc_decomposition", coefficients=c.round(5),
                         singular_values=s[:num_pc].float().cpu().numpy().round(4),
                         subspace_energy_fraction=round(captured, 5))
            for pc in np.argsort(-np.abs(c)):
                sign = 1.0 if c[pc] >= 0 else -1.0
                vks.append(sign * vT[pc].reshape(shape))
                names.append(
                    f"Edit_text_driven-{cfg.dataset_name}_{idx}"
                    f"-edit_{cfg.edit_t}T-{op}-block_{block_idx}"
                    f"-prompt_{ptag}-pc_{int(pc):03d}_c{c[pc]:+.3f}")
            return self._edit_along_directions(zt, vks, names, vis_num)

        with self._stage("text_driven_direction"):
            v = pullback_covector(
                self._vjp_encoder(t_edit, tap, self.edit_prompt_emb), zt, dh)
            v = v / torch.linalg.norm(v)
        for sign, stag in ((1.0, "pos"), (-1.0, "neg")):
            vks.append(sign * v.reshape(shape))
            names.append(
                f"Edit_text_driven-{cfg.dataset_name}_{idx}"
                f"-edit_{cfg.edit_t}T-{op}-block_{block_idx}"
                f"-prompt_{ptag}_{stag}")
        return self._edit_along_directions(zt, vks, names, vis_num)

    # ---- decoder pullback ---------------------------------------------------

    def compute_local_decoder_basis(self, zt, t, tap: TapPoint, pca_rank: int,
                                    x0_pullback: bool = False) -> PullbackResult:
        """Top-k triplets of ∂ε/∂h (or, with ``x0_pullback``, of the Tweedie
        map ∂ẑ₀/∂h) at the tapped feature of the edit-prompt U-Net. The
        state (skips, time embedding, context) comes from one forward
        outside the differentiated map; h and the basis flatten NHWC."""
        cfg = self.cfg
        impl, impl_vjp = self._pair_impls()
        with torch.no_grad():
            h, state = self._tap_encode_with_state(zt, t, self.edit_prompt_emb, tap)
        at = alpha_bar(self.schedule, t)

        def decode_with(attn_impl):
            def decode(hh):
                with attn_impl_as(self.unet, attn_impl):
                    eps = self._tap_decode_with_state(to_nchw(hh), state, tap)
                return predict_x0(eps.float(), zt, at) if x0_pullback else eps
            return decode

        with self._stage("sd_decoder_pullback", x0_pullback=x0_pullback) as log:
            res = local_decoder_pullback(
                decode_with(impl), to_nhwc(h),
                torch.Generator().manual_seed(cfg.seed), pca_rank=pca_rank,
                min_iter=cfg.pullback_min_iter, max_iter=cfg.pullback_max_iter,
                atol=cfg.pullback_atol,
                fn_vjp=decode_with(impl_vjp) if impl_vjp else None,
                chunk_size=cfg.pullback_chunk_size, remat=cfg.pullback_remat)
            log.update(iterations=res.iterations,
                       top_s=res.s[:3].float().cpu().numpy().round(4))
        return res

    def run_edit_local_decoder_pullback_zt(
        self,
        idx: int,
        op: str = "mid",
        block_idx: int = 0,
        pca_rank: int = 2,
        vis_num: Optional[int] = None,
        vis_num_pc: Optional[int] = None,
        x0_pullback: bool = False,
        edit_prompt: Optional[str] = None,
    ):
        """Decoder-pullback edit: the top h-directions by decoder
        sensitivity (∂ε/∂h, or ∂ẑ₀/∂h with ``x0_pullback``), pulled back to
        the latent through the encoder's Jᵀ, then the guidance edit."""
        cfg = self.cfg
        self._set_edit_prompt(edit_prompt)
        vis_num = vis_num or cfg.vis_num
        vis_num_pc = vis_num_pc or cfg.vis_num_pc
        tap = TapPoint(op, block_idx)
        zt = self._zt(idx)
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        res = self.compute_local_decoder_basis(zt, t_edit, tap, pca_rank,
                                               x0_pullback)
        # the decoder's right-singular vectors live in h-space: (dim_h, k)
        tag = "local_dec_x0" if x0_pullback else "local_dec"
        return self._edit_with_global_h_basis(
            idx, res.vT.T, op, block_idx, vis_num, vis_num_pc, tag, zt=zt)

    # ---- the edit tail ------------------------------------------------------

    @torch.no_grad()
    def _guidance_walk(self, z_start, vks, t_edit):
        """The x-space-guidance micro-walk, edit-prompt conditioned, for a
        batch of directions at once: (num_step + 1, D, H, W, C). With
        guidance_deepcache_interval > 1 the deep path of the
        [z; z + δv] pair (every direction's rows) is cached and refreshed
        every that many micro-steps."""
        cfg = self.cfg
        z = z_start.expand(vks.shape[0], *z_start.shape[1:])
        itv = cfg.guidance_deepcache_interval
        walk = dict(num_steps=cfg.x_space_guidance_num_step,
                    edit_step=cfg.x_space_guidance_edit_step,
                    scale=cfg.x_space_guidance_scale)
        if itv <= 1:
            return x_space_guidance_scan(
                self.eps_with(self.edit_prompt_emb), z, t_edit, vks,
                pair_impl=cfg.xsg_pair_impl, **walk)
        return x_space_guidance_scan_deepcache(*self._deepcache_walk_fns(), z,
                                               t_edit, vks, interval=itv, **walk)

    def _deepcache_walk_fns(self):
        """(full_fn, reuse_fn) of x_space_guidance_scan_deepcache for the
        edit-prompt U-Net on NHWC pairs, cached at the ('up', n-2) tap."""
        tap = TapPoint("up", len(self.unet.up_blocks) - 2)
        emb = self.edit_prompt_emb

        def full_fn(pair, t):
            h, state = self._tap_encode_with_state(pair, t, emb, tap)
            return self._tap_decode_with_state(h, state, tap), h

        def reuse_fn(pair, t, h):
            ctx, added = self._unet_cond(emb, pair.shape[0])
            state = self.unet.shallow_encode(to_nchw(pair), t, ctx, added)
            return self._tap_decode_with_state(h, state, tap)

        return full_fn, reuse_fn

    @torch.no_grad()
    def _finish_forward(self, sel):
        """The finish sampling of the edit tail (edit t → 0). With
        edit_deepcache_interval > 1 the deep path is refreshed every that
        many steps, the classifier-free guidance rows (guidance_scale > 1)
        inside the cache."""
        cfg = self.cfg
        itv = cfg.edit_deepcache_interval
        if itv <= 1:
            return self.DDIMforwardsteps(sel, self.edit_t_idx)
        cfg_on = cfg.guidance_scale > 1.0
        b = sel.shape[0]
        ctx, added = self._unet_cond(self.for_prompt_emb, b)
        neg_ctx, neg_added = (self._unet_cond(self.neg_prompt_emb, b) if cfg_on
                              else (None, None))
        return to_nhwc(ddim_forward_deepcache_cond(
            self.unet, to_nchw(sel), ctx, self.schedule, self.fwd_grid,
            interval=itv, start_idx=self.edit_t_idx, added_cond=added,
            neg_context=neg_ctx, neg_added_cond=neg_added,
            guidance_scale=cfg.guidance_scale if cfg_on else 0.0))

    def _edit_along_directions(self, zt, vks, names, vis_num):
        """Walks for every direction whose PNG is missing, the regularizers
        and the finish sampling of the selected frames, VAE decode, one PNG
        grid each."""
        cfg = self.cfg
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        todo = [i for i, n in enumerate(names)
                if self._missing(os.path.join(cfg.result_folder, n + ".png"))]
        if not todo:
            self.log.log("all_edits_cached")
            return names
        stride = max(1, (cfg.x_space_guidance_num_step + 1) // vis_num)

        with self._stage("sd_x_space_guidance_walk", directions=len(todo),
                         deepcache=cfg.guidance_deepcache_interval):
            traj = self._guidance_walk(
                zt, torch.stack([vks[i] for i in todo]), t_edit)
        sel = traj[::stride].transpose(0, 1)       # (D, frames, H, W, C)
        d, f = sel.shape[:2]
        with self._stage("sd_finish_forward", batch=d * f,  # edit_t → 0
                         deepcache=cfg.edit_deepcache_interval):
            z0s = self._finish_forward(
                self._regularize(sel.reshape(d * f, *sel.shape[2:]), zt))
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
