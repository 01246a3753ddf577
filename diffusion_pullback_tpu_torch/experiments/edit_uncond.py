"""Unconditional (pixel-space DDPM) editing along the encoder pullback basis.

Counterpart of EditUncondDiffusion in
diffusion_pullback_tpu/experiments/edit_uncond.py. The main path:

    image → DDIM inversion → DDIM forward to the edit t → encoder pullback
    at a U-Net tap → x-space-guidance walk along ±v_k → the post-edit
    regularizers the config turns on → DDIM finish with performance
    boosting (η = 1 below performance_boosting_t·T) → PNG grids.

A freshly computed basis also leaves its eigenvalue spectrum and the RGB
map of its directions in ``obs_folder`` (experiments/vis.py).

The other edits: h-space guidance (the walk perturbs the tapped feature
along ±u_k and resumes the pass), parallel transport of a direction from
one sample to another, and the decoder (or x̂₀) pullback, whose h-space
directions map to x through the encoder's Jᵀ. The analysis runs: local
and global PCA of the tapped h, Fréchet and Hungarian mean bases over
samples (each edit maps its h-space directions to x through Jᵀ), the
tangent-space harvests over a timestep grid, and the power spectra of a
sampling trajectory.

Images, ``vT`` and the basis cache are NHWC at this boundary, as in the JAX
package, so ``vT`` rows flatten in the same order and a basis from either
package loads in the other; the model runs NCHW inside. The JAX driver's
vmap over edit directions is a batch dimension here, and the walk evaluates
its (null, edit) pair as one batch.

The model is the DDPM-family UNet2D or the ADM family's UNetADM (learned σ:
the samplers take the ε half). On an ADM net the pullback differentiates
the encoder through the fused kernel pair when the net samples with
'flash' (or ``pullback_attn_impl`` asks for it), as the SD driver does;
with ``cond_fn`` set (classifier guidance) every sampler loop runs guided,
and ``sampling_timesteps`` puts them on an OpenAI respacing grid.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..geometry import (
    PullbackResult,
    frechet_mean_basis,
    global_pca,
    hungarian_mean_basis,
    local_pca,
    local_pullback,
    pca_to_x_direction,
    pullback_covector,
    transport_all,
)
from ..models.layers import attn_impl_as
from ..models.unet2d import TapPoint, UNet2D
from ..ops.ddim import predict_x0, split_learned_sigma
from ..ops.schedule import (DiffusionSchedule, alpha_bar, ddim_timestep_grid,
                            respaced_timestep_grid)
from ..parallel.mesh import axis_size
from ..samplers.ddim_loop import ddim_forward, ddim_invert, ddim_scan
from ..samplers.guidance import guided_eps_fn, x_space_guidance_scan
from ..samplers.regularizers import sega_sparsify
from ..utils.device import resolve_device, strict_f32
from ..utils.images import save_image_grid
from ..utils.logging import JSONLLogger
from ._common import DriverCommonMixin, to_nchw, to_nhwc
from .cache import BasisCache, basis_name


@dataclasses.dataclass
class UncondExperimentConfig:
    dataset_name: str = "noise"
    for_steps: int = 100
    inv_steps: int = 100
    edit_t: float = 0.7
    seed: int = 0
    x_space_guidance_edit_step: float = 1.0
    x_space_guidance_scale: float = 0.1
    x_space_guidance_num_step: int = 16
    # h-space guidance's scale (0 = x_space_guidance_scale)
    h_space_guidance_scale: float = 0.0
    # (ε_null, ε_edit) evaluation of the walk: 'batch' | 'split' (the same
    # numbers; the JAX driver always batches)
    xsg_pair_impl: str = "batch"
    # post-edit regularizers of the walk frames before the finish
    # (samplers/regularizers.py), in this order; SEGA sparsifies the
    # directions that h-space bases map to x (PCA, mean-basis and
    # decoder-pullback edits)
    use_dynamic_thresholding: bool = False
    dynamic_thresholding_q: float = 0.8
    use_preserve_contrast: bool = False
    use_preserve_norm: bool = False
    use_sega_reg: bool = False
    sega_reg_sigma: float = 1.0
    # a device mesh (parallel.make_mesh): 'probe' shards the pullback's
    # probes, 'dp' the harvests' sweeps, 'tp' the model's weights, 'sp' the
    # sequence of ring attention
    mesh: Optional[object] = None
    # 'on': the unguided per-step ε of the DDIM loops through the export
    # cache (utils/aot.py); 'auto' and 'off' run it eagerly
    aot_export: str = "off"
    # OpenAI respacing grid ('ddim25', '250', '25,25,25'; '' = the linspace
    # grid of for_steps / inv_steps)
    sampling_timesteps: str = ""
    # classifier guidance: recorded for the basis cache's key; the driver's
    # cond_fn does the guiding
    classifier_scale: float = 0.0
    classifier_label: int = 0
    # attention of the differentiated encoder ('' = the model's own; 'flash'
    # = the fused pair, which a model sampling with 'flash' needs)
    pullback_attn_impl: str = ""
    # performance boosting: η = 1 below this fraction of T
    performance_boosting_t: float = 0.2
    use_performance_boosting: bool = True
    # pullback
    pca_rank: int = 2
    pullback_min_iter: int = 10
    pullback_max_iter: int = 50
    pullback_atol: float = 1e-4
    pullback_chunk_size: Optional[int] = None
    # io
    result_folder: str = "./runs/uncond"
    # the analysis artifacts (spectra, direction maps, power spectra)
    obs_folder: str = "./runs/uncond/obs"
    basis_folder: str = "./inputs/local_encoder_pullback_uncond"
    vis_num: int = 4
    vis_num_pc: int = 2


class EditUncondDiffusion(DriverCommonMixin):
    """Experiment driver bound to one (model, schedule) pair. ``cond_fn``
    (x, t) → ∇ₓ log p(y | x), set after construction
    (samplers.guidance.classifier_grad_fn), guides every sampler loop."""

    def __init__(
        self,
        model: UNet2D,
        schedule: DiffusionSchedule,
        dataset,
        config: UncondExperimentConfig,
        logger: Optional[JSONLLogger] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        strict_f32()
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.schedule = schedule.to(self.device)
        self.dataset = dataset
        self.cfg = config
        self.model = self._place_weights(self.model)
        self.log = logger or JSONLLogger(
            os.path.join(config.result_folder, "log.jsonl"))
        self.cache = BasisCache(config.basis_folder)

        if config.sampling_timesteps:
            self.fwd_grid = respaced_timestep_grid(config.sampling_timesteps)
            self.inv_grid = respaced_timestep_grid(config.sampling_timesteps,
                                                   inversion=True)
        else:
            self.fwd_grid = ddim_timestep_grid(config.for_steps)
            self.inv_grid = ddim_timestep_grid(config.inv_steps, inversion=True)
        self.edit_t_idx = self._t_index(config.edit_t)
        # boost index: the first step below performance_boosting_t·T
        below = self.fwd_grid.timesteps.numpy() < config.performance_boosting_t * 1000.0
        self.boost_start_idx = int(below.argmax()) if below.any() else None
        self.cond_fn = None
        # UNet2DConfig calls it sample_size, ADMConfig image_size
        self._sample_size = getattr(model.config, "sample_size", None) or \
            model.config.image_size
        # (H, W, C) of one NHWC image
        self._sample_shape = (self._sample_size, self._sample_size,
                              model.config.in_channels)

    @property
    def _arch_config(self):
        return self.model.config

    # ---- building blocks --------------------------------------------------

    def _eps_with(self):
        """ε(x, t) on NHWC images; a learned-σ head's ε half; with a
        ``cond_fn`` the classifier-guided ε."""
        def eps(x, t):
            out = to_nhwc(self.model(to_nchw(x), t))
            return split_learned_sigma(out)[0] if self.model.config.learn_sigma else out
        if self.cond_fn is not None:
            return guided_eps_fn(eps, self.cond_fn, self.schedule)
        return eps

    def eps_fn(self, x, t):
        return self._eps_with()(x, t)

    def _eps_program(self):
        """``_eps_with()`` as the program 'eps' of the model's weights (the
        per-step ε of the DDIM loops); classifier-guided ε, which takes a
        gradient, runs eagerly."""
        if self.cond_fn is not None:
            return self._eps_with()
        return self._program("eps", self._eps_with(), self.model)

    def _basis_name_extras(self, tap: Optional[TapPoint] = None) -> str:
        """Cache-key qualifiers: an intra-block tap, and classifier guidance
        (guided runs invert and sample to other latents), so their bases do
        not shadow the plain ones."""
        s = ""
        if tap is not None and tap.inner:
            s += f"-after_{tap.inner[0]}{tap.inner[1]}"
        if self.cond_fn is not None:
            s += f"-clsg{self.cfg.classifier_scale}-y{self.cfg.classifier_label}"
        return s

    def _pair_impls(self):
        """(attention impl of the tangent passes, of the cotangent pass or
        None, tag) of a differentiated map. A model that samples with
        'flash' (or pullback_attn_impl 'flash') maps to the fused pair:
        'flash_jvp' (K2, K3) for the tangents, 'flash' (K2, K4, K5) for the
        cotangent, tag 'flashpair'. The UNet2D has no attention switch (its
        ≤256-token attention is the math path): impl None, tag 'xla'."""
        model_impl = getattr(self.model.config, "attn_impl", None)
        if model_impl is None:
            return None, None, "xla"
        impl = self.cfg.pullback_attn_impl or model_impl
        if impl in ("flash", "flash_jvp"):
            return "flash_jvp", "flash", "flashpair"
        if impl == "ring":
            # the ring's flash inner (K2) is primal only: the math inner
            return "ring_xla", None, "ring_xla"
        return impl, None, impl

    def _with_impl(self, fn, attn_impl: Optional[str]):
        """``fn`` run with every attention layer of the model set to
        ``attn_impl`` for the call (the same weights under other kernels);
        None leaves the model as it is."""
        if attn_impl is None:
            return fn

        def run(*args):
            with attn_impl_as(self.model, attn_impl):
                return fn(*args)
        return run

    def _pullback_models(self):
        """(encode of the tangent passes, encode of the cotangent pass or
        None, impl tag) of the differentiated encoder (``_pair_impls``)."""
        impl, impl_vjp, tag = self._pair_impls()
        encode = lambda i: self._with_impl(self.model.encode, i)
        return encode(impl), impl_vjp and encode(impl_vjp), tag

    @torch.no_grad()
    def run_ddim_inversion(self, idx: int) -> torch.Tensor:
        """x0 → xT, NHWC."""
        x0 = torch.as_tensor(self.dataset[idx], device=self.device)
        with self._stage("ddim_inversion", idx=idx):
            return ddim_invert(self._eps_program(), x0, self.schedule, self.inv_grid)

    @torch.no_grad()
    def run_ddim_forward(self, num_samples: int = 4,
                         generator: Optional[torch.Generator] = None,
                         save_as: Optional[str] = None,
                         vis_psd: bool = False) -> torch.Tensor:
        """Sample from seeded noise (the smoke path of the reference's
        run_DDIMforward). ``vis_psd`` also collects the x_t and ε_t
        trajectories and plots the radial power spectrum of each step's
        first sample into obs_folder (xt_psd.png, et_psd.png)."""
        xT = self._draw_latents(num_samples, generator)
        grid = self.fwd_grid
        with self._stage("ddim_forward", num_samples=num_samples, vis_psd=vis_psd):
            x0, trajs = ddim_scan(self._eps_program(), xT, self.schedule, grid.timesteps,
                                  grid.timesteps_next, collect_trajectory=vis_psd,
                                  collect_eps=vis_psd)
        if vis_psd:
            from .vis import vis_power_spectral_density

            for traj, fname in zip(trajs, ("xt_psd.png", "et_psd.png")):
                vis_power_spectral_density(traj[:, :1].float().cpu().numpy(),
                                           os.path.join(self.cfg.obs_folder, fname))
        if save_as:
            save_image_grid(x0.float().cpu().numpy(), save_as)
        return x0

    @torch.no_grad()
    def forward_to_edit_t(self, xT: torch.Tensor) -> torch.Tensor:
        return self._forward_steps(xT, 0, self.edit_t_idx, "ddim_forward_to_edit")

    @torch.no_grad()
    def _forward_steps(self, x: torch.Tensor, start: int, end: int,
                       event: str = "ddim_forward_steps") -> torch.Tensor:
        """The forward grid's steps start … end − 1 from x (NHWC)."""
        with self._stage(event, steps=end - start):
            return ddim_forward(self._eps_program(), x, self.schedule, self.fwd_grid,
                                start_idx=start, end_idx=end)

    def _encode_nhwc(self, encode, t, tap: TapPoint):
        """x → h at ``tap``, NHWC on both sides, through ``encode`` (one of
        _pullback_models' encoders)."""
        return lambda x: to_nhwc(encode(to_nchw(x), t, tap))

    def compute_local_basis(self, xt, t, tap: TapPoint, pca_rank: int
                            ) -> PullbackResult:
        """Pullback of the encoder x → h at ``tap`` (NHWC on both sides),
        on the fused pair where ``_pullback_models`` gives it, its probes
        sharded over the mesh's 'probe' axis where ``_mesh_probe_size``
        allows."""
        cfg = self.cfg
        enc, enc_vjp, tag = self._pullback_models()
        n_probe = self._mesh_probe_size(pca_rank)
        with self._stage("local_pullback", encoder=tag, probe_shards=n_probe or 1) as log:
            res = local_pullback(
                self._encode_nhwc(enc, t, tap), xt,
                torch.Generator().manual_seed(cfg.seed),
                pca_rank=pca_rank, min_iter=cfg.pullback_min_iter,
                max_iter=cfg.pullback_max_iter, atol=cfg.pullback_atol,
                fn_vjp=enc_vjp and self._encode_nhwc(enc_vjp, t, tap),
                chunk_size=cfg.pullback_chunk_size,
                probe_group=self._probe_group(pca_rank))
            log.update(iterations=res.iterations, final_delta=res.final_delta,
                       top_s=res.s[:3].float().cpu().numpy().round(4))
        return res

    # ---- headline experiment ---------------------------------------------

    def run_edit_local_encoder_pullback_xt(
        self,
        idx: int,
        op: str = "mid",
        block_idx: int = 0,
        pca_rank: Optional[int] = None,
        vis_num: Optional[int] = None,
        vis_num_pc: Optional[int] = None,
        after_res: bool = False,
        after_sa: bool = False,
    ):
        """Invert → partial forward → pullback basis (cached) → ±pc
        x-space-guidance walks → boosted finish → PNGs; returns their
        names."""
        cfg = self.cfg
        pca_rank = pca_rank or cfg.pca_rank
        vis_num = vis_num or cfg.vis_num
        vis_num_pc = vis_num_pc or cfg.vis_num_pc
        tap = self._make_tap(op, block_idx, after_res, after_sa)

        xt = self.forward_to_edit_t(self.run_ddim_inversion(idx))
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        name = basis_name(cfg.dataset_name, idx, cfg.edit_t, op, block_idx,
                          cfg.seed, pca_rank=pca_rank) + self._basis_name_extras(tap)
        cached = self.cache.load(name)
        if cached is not None:
            u, s, vT = (torch.as_tensor(np.asarray(a), device=self.device)
                        for a in cached)
            self.log.log("basis_cache_hit", name=name)
        else:
            res = self.compute_local_basis(xt, t_edit, tap, pca_rank)
            u, s, vT = res.u.float(), res.s, res.vT
            self._save_basis(name, res)
            self._vis_basis(name, s, vT, tuple(xt.shape[1:]))
        vT = vT / torch.linalg.norm(vT, dim=1, keepdim=True)

        shape = xt.shape[1:]
        vks, names = [], []
        for pc in range(vis_num_pc):
            for sign, tag in ((1.0, "pos"), (-1.0, "neg")):
                vks.append(sign * vT[pc].reshape(shape))
                names.append(f"Edit_xt-{cfg.dataset_name}_{idx}-edit_{cfg.edit_t}T"
                             f"-{op}-block_{block_idx}-pc_{pc:03d}_{tag}")
        return self._edit_along_directions(xt, vks, names, vis_num)

    @torch.no_grad()
    def _edit_along_directions(self, xt, vks, names, vis_num):
        """The walks of every direction whose PNG is missing (one batch),
        the regularizers and the boosted finish of the selected frames, one
        PNG grid each."""
        cfg = self.cfg
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        todo = [i for i, n in enumerate(names) if self._missing(
            os.path.join(cfg.result_folder, n + ".png"))]
        if not todo:
            self.log.log("all_edits_cached")
            return names
        stride = max(1, (cfg.x_space_guidance_num_step + 1) // vis_num)
        boost = self.boost_start_idx if cfg.use_performance_boosting else None
        eps = self._eps_with()

        with self._stage("x_space_guidance_walk", directions=len(todo)):
            vk = torch.stack([vks[i] for i in todo])        # (D, H, W, C)
            traj = x_space_guidance_scan(
                eps, xt.expand(len(todo), *xt.shape[1:]), t_edit, vk,
                num_steps=cfg.x_space_guidance_num_step,
                edit_step=cfg.x_space_guidance_edit_step,
                scale=cfg.x_space_guidance_scale, pair_impl=cfg.xsg_pair_impl)
        sel = traj[::stride].transpose(0, 1)                # (D, frames, H, W, C)
        d, f = sel.shape[:2]
        with self._stage("finish_and_save", batch=d * f) as log:
            x0s = ddim_forward(
                self._eps_program(),
                self._regularize(sel.reshape(d * f, *sel.shape[2:]), xt),
                self.schedule, self.fwd_grid, start_idx=self.edit_t_idx,
                boost_start_idx=boost,
                generator=torch.Generator().manual_seed(cfg.seed + 1))
            imgs = x0s.reshape(d, f, *x0s.shape[1:]).float().cpu().numpy()
            log.update(finite=bool(np.isfinite(imgs).all()))
            for j, i in enumerate(todo):
                save_image_grid(imgs[j], os.path.join(cfg.result_folder,
                                                      names[i] + ".png"))
        return names

    def run_edit_local_encoder_pullback_zt(self, *a, **kw):
        """The reference's name, which its CLI dispatches for both families
        (an uncond model takes no prompt)."""
        kw.pop("edit_prompt", None)
        kw.pop("edit_t", None)
        return self.run_edit_local_encoder_pullback_xt(*a, **kw)

    def run_edit_local_pca_zt(self, *a, **kw):
        kw.pop("edit_prompt", None)
        return self.run_edit_local_pca_xt(*a, **kw)

    def run_edit_global_pca_zt(self, *a, **kw):
        kw.pop("edit_prompt", None)
        return self.run_edit_global_pca_xt(*a, **kw)

    def run_edit_local_decoder_pullback_zt(self, *a, **kw):
        kw.pop("edit_prompt", None)
        return self.run_edit_local_decoder_pullback_xt(*a, **kw)

    # ---- h-space guidance, parallel transport, the decoder pullback -------

    def _basis(self, idx, tap: TapPoint, pca_rank: int, xt=None):
        """(u, s, vT) of sample ``idx``'s encoder basis at the edit t, as f32
        on the device: from the cache, else computed at ``xt`` (by default
        the sample inverted and forwarded to the edit t) and saved."""
        cfg = self.cfg
        name = basis_name(cfg.dataset_name, idx, cfg.edit_t, tap.op, tap.block_idx,
                          cfg.seed, pca_rank=pca_rank) + self._basis_name_extras(tap)
        basis = self.cache.load(name)
        if basis is None:
            if xt is None:
                xt = self.forward_to_edit_t(self.run_ddim_inversion(idx))
            res = self.compute_local_basis(
                xt, self.fwd_grid.timesteps[self.edit_t_idx], tap, pca_rank)
            self._save_basis(name, res)
            basis = (res.u, res.s, res.vT)
        return tuple(torch.as_tensor(a).float().to(self.device) for a in basis)

    def run_edit_h_space_guidance(
        self,
        idx: int,
        op: str = "mid",
        block_idx: int = 0,
        pca_rank: Optional[int] = None,
        vis_num: Optional[int] = None,
        vis_num_pc: Optional[int] = None,
        scale: Optional[float] = None,
    ):
        """h-space editing along the basis' h-directions û_k: each
        micro-step runs ONE encoder pass to the tap and resumes the pass
        for the pair [h; h + δ·û_k] from its state, then moves x as the
        x-space walk does (the model's ε, without classifier guidance):

            h, state = encode_with_state(x_t)
            [ε_null; ε_edit] = decode_with_state([h; h + δ·û_k], state)
            x_t ← x_t + scale·(ε_edit − ε_null)

        δ = x_space_guidance_edit_step; ``scale`` defaults to
        h_space_guidance_scale, else x_space_guidance_scale. Every direction
        whose PNG is missing walks in one batch; the strided trajectory (its
        start included) finishes with performance boosting (noise seeded
        seed + 2). Returns the PNGs' names."""
        cfg = self.cfg
        pca_rank = pca_rank or max(cfg.pca_rank, 2)
        vis_num = vis_num or cfg.vis_num
        vis_num_pc = vis_num_pc or cfg.vis_num_pc
        scale = scale if scale is not None else (
            cfg.h_space_guidance_scale or cfg.x_space_guidance_scale)
        tap = TapPoint(op, block_idx)
        xt = self.forward_to_edit_t(self.run_ddim_inversion(idx))
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        u = self._basis(idx, tap, pca_rank, xt)[0]
        if vis_num_pc > u.shape[1]:
            self.log.log("vis_num_pc_clamped", requested=vis_num_pc,
                         available=int(u.shape[1]))
            vis_num_pc = int(u.shape[1])

        signs, names = [], []
        for pc in range(vis_num_pc):
            for sign, stag in ((1.0, "pos"), (-1.0, "neg")):
                signs.append((pc, sign))
                names.append(f"Edit_h_space-{cfg.dataset_name}_{idx}-edit_{cfg.edit_t}T"
                             f"-{op}-block_{block_idx}-scale_{scale}-pc_{pc:03d}_{stag}")
        todo = [i for i, n in enumerate(names) if self._missing(
            os.path.join(cfg.result_folder, n + ".png"))]
        if not todo:
            self.log.log("all_edits_cached")
            return names
        stride = max(1, (cfg.x_space_guidance_num_step + 1) // vis_num)
        boost = self.boost_start_idx if cfg.use_performance_boosting else None
        learn_sigma, c_out = self.model.config.learn_sigma, self.model.config.out_channels
        d = len(todo)

        with torch.no_grad(), self._stage("h_space_guidance_edit", directions=d) as log:
            z, dh = xt.expand(d, *xt.shape[1:]), None
            traj = [z]
            for _ in range(cfg.x_space_guidance_num_step):
                h, state = self.model.encode_with_state(to_nchw(z), t_edit, tap)
                if dh is None:
                    # û_k flattens NHWC: to the NHWC h shape, then to NCHW
                    hw = (1, h.shape[2], h.shape[3], h.shape[1])
                    dh = torch.cat([
                        to_nchw((sign * cfg.x_space_guidance_edit_step
                                 * u[:, pc] / torch.linalg.norm(u[:, pc])).reshape(hw))
                        for pc, sign in (signs[i] for i in todo)])
                pair = lambda a: torch.cat([a.expand(d, *a.shape[1:])] * 2)
                state = type(state)(pair(state.emb), tuple(pair(a) for a in state.skips))
                eps2 = self.model.decode_with_state(torch.cat([h, h + dh]), state, tap)
                if learn_sigma:
                    eps2 = eps2[:, :c_out]
                z = z + scale * to_nhwc(eps2[d:] - eps2[:d]).float()
                traj.append(z)
            sel = torch.stack(traj)[::stride].transpose(0, 1)   # (D, frames, H, W, C)
            f = sel.shape[1]
            x0s = ddim_forward(
                self._eps_program(), sel.reshape(d * f, *sel.shape[2:]), self.schedule,
                self.fwd_grid, start_idx=self.edit_t_idx, boost_start_idx=boost,
                generator=torch.Generator().manual_seed(cfg.seed + 2))
            imgs = x0s.reshape(d, f, *x0s.shape[1:]).float().cpu().numpy()
            log.update(finite=bool(np.isfinite(imgs).all()))
        for j, i in enumerate(todo):
            save_image_grid(imgs[j], os.path.join(cfg.result_folder, names[i] + ".png"))
        return names

    def run_edit_parallel_transport(self, sample_idx_0: int, sample_idx_1: int,
                                    op: str = "mid", block_idx: int = 0,
                                    pca_rank: int = 50, vis_num: int = 4,
                                    vis_num_pc: int = 2):
        """Transport the directions found at sample 0 to sample 1 and edit
        sample 1 along them: v_k^(1) = v₁ᵀᵀ(u₁ᵀu₀[:, k]), the two samples'
        bases (cached) with u₀, u₁ and v₁ᵀ normalised first."""
        cfg = self.cfg
        tap = TapPoint(op, block_idx)
        bases, xts = {}, {}
        for idx in (sample_idx_0, sample_idx_1):
            xts[idx] = self.forward_to_edit_t(self.run_ddim_inversion(idx))
            bases[idx] = self._basis(idx, tap, pca_rank, xts[idx])
        u0 = bases[sample_idx_0][0]
        u1, _, vT1 = bases[sample_idx_1]
        vt_trans = transport_all(                                          # (r, dim_x)
            u0 / torch.linalg.norm(u0, dim=0, keepdim=True),
            u1 / torch.linalg.norm(u1, dim=0, keepdim=True),
            vT1 / torch.linalg.norm(vT1, dim=1, keepdim=True))

        shape = xts[sample_idx_1].shape[1:]
        vks, names = [], []
        for pc in range(vis_num_pc):
            for sign, tag in ((1.0, "pos"), (-1.0, "neg")):
                vks.append(sign * vt_trans[pc].reshape(shape))
                names.append(f"Edit_transport-{cfg.dataset_name}_{sample_idx_0}to"
                             f"{sample_idx_1}-edit_{cfg.edit_t}T-{op}-block_{block_idx}"
                             f"-pc_{pc:03d}_{tag}")
        return self._edit_along_directions(xts[sample_idx_1], vks, names, vis_num)

    def compute_local_decoder_basis(self, xt, t, tap: TapPoint, pca_rank: int = 50,
                                    x0_pullback: bool = False) -> PullbackResult:
        """Top-k triplets of ∂ε/∂h (or, with ``x0_pullback``, of the Tweedie
        map ∂x̂₀/∂h) at the tapped feature: the state (skips, time
        embedding) from one encoder pass outside the differentiated map,
        then the pullback of h ↦ decode_with_state(h, state) on the pair
        where ``_pair_impls`` gives it. h and the basis flatten NHWC. A
        learned-σ head's output is not cut, as in the JAX package: ε there
        carries [ε, σ], twice x_t's channels, so its x̂₀ map is undefined
        and raises."""
        cfg = self.cfg
        if x0_pullback and self.model.config.learn_sigma:
            c = self.model.config.out_channels
            raise ValueError(
                f"x0_pullback on a learned-sigma net: its decoder emits [eps, sigma] "
                f"({2 * c} channels) and x_t has {c}, so x0 = (x_t - sqrt(1 - "
                "abar) eps) / sqrt(abar) cannot be formed (the JAX package fails "
                "on it too)")
        impl, impl_vjp, tag = self._pair_impls()
        with torch.no_grad():
            h, state = self.model.encode_with_state(to_nchw(xt), t, tap)
        at = alpha_bar(self.schedule, t)

        def decode_with(attn_impl):
            def decode(hh):
                eps = to_nhwc(self.model.decode_with_state(to_nchw(hh), state, tap))
                return predict_x0(eps.float(), xt, at) if x0_pullback else eps
            return self._with_impl(decode, attn_impl)

        with self._stage("local_decoder_pullback", decoder=tag,
                         x0_pullback=x0_pullback) as log:
            res = local_pullback(
                decode_with(impl), to_nhwc(h), torch.Generator().manual_seed(cfg.seed),
                pca_rank=pca_rank, min_iter=cfg.pullback_min_iter,
                max_iter=cfg.pullback_max_iter, atol=cfg.pullback_atol,
                fn_vjp=impl_vjp and decode_with(impl_vjp),
                chunk_size=cfg.pullback_chunk_size)
            log.update(iterations=res.iterations, final_delta=res.final_delta,
                       top_s=res.s[:3].float().cpu().numpy().round(4))
        return res

    def run_edit_local_decoder_pullback_xt(self, idx: int, op: str = "mid",
                                           block_idx: int = 0, pca_rank: int = 2,
                                           vis_num: Optional[int] = None,
                                           vis_num_pc: Optional[int] = None,
                                           x0_pullback: bool = False):
        """Decoder-pullback edit: the top h-directions by decoder
        sensitivity (∂ε/∂h, or ∂x̂₀/∂h with ``x0_pullback``), pulled back to
        x through the encoder's Jᵀ, then the guidance edit."""
        cfg = self.cfg
        vis_num = vis_num or cfg.vis_num
        vis_num_pc = vis_num_pc or cfg.vis_num_pc
        xt = self.forward_to_edit_t(self.run_ddim_inversion(idx))
        res = self.compute_local_decoder_basis(
            xt, self.fwd_grid.timesteps[self.edit_t_idx], TapPoint(op, block_idx),
            pca_rank, x0_pullback)
        # the decoder's right-singular vectors live in h-space: (dim_h, k)
        return self._edit_with_global_h_basis(
            idx, res.vT.T, op, block_idx, vis_num, vis_num_pc,
            "local_dec_x0" if x0_pullback else "local_dec", xt=xt)

    # ---- analysis runs ----------------------------------------------------

    def _vjp_encode(self, t, tap: TapPoint):
        """x → h at ``tap`` (NHWC) for a reverse-mode pass (Jᵀu)."""
        enc, enc_vjp, _ = self._pullback_models()
        return self._encode_nhwc(enc_vjp or enc, t, tap)

    def _edit_with_global_h_basis(self, idx, u_mean, op, block_idx, vis_num,
                                  vis_num_pc, tag, xt=None):
        """Map h-space directions (the columns of ``u_mean``, (dim_h, k),
        NHWC-flattened) to x at the sample through Jᵀ, v = Jᵀu/‖Jᵀu‖, and
        run the guidance edit. ``xt`` reuses a caller's inverted image."""
        cfg = self.cfg
        tap = TapPoint(op, block_idx)
        if xt is None:
            xt = self.forward_to_edit_t(self.run_ddim_inversion(idx))
        enc = self._vjp_encode(self.fwd_grid.timesteps[self.edit_t_idx], tap)
        shape = xt.shape[1:]
        vks, names = [], []
        with self._stage("inverse_jacobian", directions=vis_num_pc):
            for pc in range(vis_num_pc):
                v = pullback_covector(enc, xt, u_mean[:, pc])
                v = v / torch.linalg.norm(v)
                if cfg.use_sega_reg:
                    v = sega_sparsify(v, cfg.sega_reg_sigma)
                for sign, stag in ((1.0, "pos"), (-1.0, "neg")):
                    vks.append(sign * v.reshape(shape))
                    names.append(f"Edit_{tag}-{cfg.dataset_name}_{idx}-edit_{cfg.edit_t}T"
                                 f"-{op}-block_{block_idx}-pc_{pc:03d}_{stag}")
        return self._edit_along_directions(xt, vks, names, vis_num)

    def run_edit_local_pca_xt(self, idx: int, op: str = "mid", block_idx: int = 0,
                              pca_rank: int = 8, num_samples: int = 1024,
                              sigma: float = 0.1, vis_num: int = 4, vis_num_pc: int = 2):
        """Edit along local-PCA h-directions: the streaming PCA of the
        encoder's h over ``num_samples`` perturbations σδ of the image at
        the edit t (chunks of min(32, num_samples), seed cfg.seed), each
        component mapped to x through Jᵀ, then the guidance edit."""
        cfg = self.cfg
        tap = TapPoint(op, block_idx)
        xt = self.forward_to_edit_t(self.run_ddim_inversion(idx))
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        with self._stage("local_pca", num_samples=num_samples) as log:
            pca = local_pca(self._encode_nhwc(self.model.encode, t_edit, tap), xt,
                            cfg.seed, rank=pca_rank, num_samples=num_samples,
                            chunk=min(32, num_samples), sigma=sigma)
            log.update(top_var=pca.variances[:3].cpu().numpy().round(5))
        to_x = self._vjp_encode(t_edit, tap)
        shape = xt.shape[1:]
        vks, names = [], []
        for pc in range(vis_num_pc):
            v = pca_to_x_direction(to_x, xt, pca.components[pc])
            for sign, tag in ((1.0, "pos"), (-1.0, "neg")):
                vks.append(sign * v.reshape(shape))
                names.append(f"Edit_local_pca-{cfg.dataset_name}_{idx}-edit_{cfg.edit_t}T"
                             f"-{op}-block_{block_idx}-pc_{pc:03d}_{tag}")
        return self._edit_along_directions(xt, vks, names, vis_num)

    def run_edit_global_pca_xt(self, idx: int, num_samples: int = 16, op: str = "mid",
                               block_idx: int = 0, pca_rank: int = 2,
                               vis_num: Optional[int] = None,
                               vis_num_pc: Optional[int] = None,
                               generator: Optional[torch.Generator] = None):
        """Global-PCA edit: ``num_samples`` Gaussian images (from
        ``generator``, by default one seeded with cfg.seed) forwarded to the
        edit t as one batch, their tapped h PCA'd, and the top directions
        mapped to x at the sample through Jᵀ for the guidance edit."""
        cfg = self.cfg
        vis_num = vis_num or cfg.vis_num
        vis_num_pc = vis_num_pc or cfg.vis_num_pc
        tap = TapPoint(op, block_idx)
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        with self._stage("global_pca_harvest", num_samples=num_samples) as log:
            xt = self.forward_to_edit_t(self._draw_latents(num_samples, generator))
            with torch.no_grad():
                h = self._encode_nhwc(self.model.encode, t_edit, tap)(xt)
            res = global_pca(h, rank=pca_rank)
            log.update(top_var=res.variances[:3].cpu().numpy().round(4))
        # components are unit h-directions: (k, dim_h) → (dim_h, k)
        return self._edit_with_global_h_basis(
            idx, res.components.T, op, block_idx, vis_num, vis_num_pc, "global_pca")

    def _harvest_bases(self, sample_indices, op, block_idx, pca_rank):
        """{idx: (u, s, vT)} of each sample's pullback basis at the edit t,
        from the cache or computed and saved: one sample after another, or
        with a 'dp' mesh axis and more than one missing sample, the missing
        samples' inversions, forwards and pullbacks split over the axis
        (``_dp_sweep``), as the JAX driver shards its sweep."""
        cfg = self.cfg
        tap = TapPoint(op, block_idx)
        dp = axis_size(cfg.mesh, "dp")
        names = {idx: basis_name(cfg.dataset_name, idx, cfg.edit_t, op, block_idx,
                                 cfg.seed, pca_rank=pca_rank) + self._basis_name_extras(tap)
                 for idx in sample_indices}
        missing = [idx for idx in sample_indices
                   if dp > 1 and self.cache.load(names[idx]) is None]
        if len(missing) > 1:
            t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
            with self._stage("sample_harvest_dp", num_samples=len(missing), dp=dp):
                bases = self._dp_sweep(missing, lambda idx: self.compute_local_basis(
                    self.forward_to_edit_t(self.run_ddim_inversion(idx)), t_edit, tap,
                    pca_rank), dp)
            for idx, res in zip(missing, bases):
                self._save_basis(names[idx], res)
        return {idx: self._basis(idx, tap, pca_rank) for idx in sample_indices}

    def _edit_with_mean_basis(self, mean_basis, tag, idx, basis_indices, op,
                              block_idx, pca_rank, vis_num, vis_num_pc):
        """The guidance edit of ``idx`` along the top vis_num_pc directions of
        ``mean_basis`` over the samples' bases, columns normalised first."""
        bases = self._harvest_bases(basis_indices, op, block_idx, pca_rank)
        us = [u / torch.linalg.norm(u, dim=0, keepdim=True) for u, _, _ in bases.values()]
        return self._edit_with_global_h_basis(
            idx, mean_basis(us, rank=vis_num_pc), op, block_idx, vis_num, vis_num_pc, tag)

    def run_edit_global_frechet_mean_xt(self, idx, basis_indices, op="mid", block_idx=0,
                                        pca_rank=10, vis_num=4, vis_num_pc=2):
        """Edit ``idx`` along the Fréchet (Grassmannian) mean of the
        samples' h-space bases."""
        return self._edit_with_mean_basis(frechet_mean_basis, "global_frechet", idx,
                                          basis_indices, op, block_idx, pca_rank,
                                          vis_num, vis_num_pc)

    def run_edit_global_hungarian_mean_xt(self, idx, basis_indices, op="mid",
                                          block_idx=0, pca_rank=10, vis_num=4,
                                          vis_num_pc=2):
        """Edit ``idx`` along the Hungarian-matched mean of the samples'
        h-space bases (each direction keeps its identity)."""
        return self._edit_with_mean_basis(hungarian_mean_basis, "global_hungarian", idx,
                                          basis_indices, op, block_idx, pca_rank,
                                          vis_num, vis_num_pc)

    # ---- tangent-space harvests -------------------------------------------

    def run_sample_encoder_local_tangent_space_xt_batched(
        self,
        idx: int,
        op: str = "mid",
        block_idx: int = 0,
        pca_rank: int = 50,
        t_grid: Optional[Tuple[float, ...]] = None,
        sequential: Optional[bool] = None,
        fix_xt: bool = False,
        fix_t: bool = False,
        after_res: bool = False,
        after_sa: bool = False,
    ):
        """Harvest the bases of sample ``idx`` over a timestep grid (default
        0.1 … 1.0 in tenths): one inversion, one walk down the forward
        trajectory in t-index order (the image at grid index i is the input
        of forward step i), a pullback at each grid point. Ablations:
        ``fix_xt`` evaluates every basis at the first grid point's image
        while t varies, ``fix_t`` pins the network's timestep to the first
        grid point's while the image varies; each adds its name suffix.
        Returns {t: basis file}. ``sequential`` is the JAX signature's: on
        one device the JAX package too maps the per-t pullbacks in
        sequence, and here they always run so. With a 'dp' mesh axis that
        divides the grid the pullbacks split over the axis
        (``_dp_sweep``)."""
        cfg = self.cfg
        tap = self._make_tap(op, block_idx, after_res, after_sa)
        t_grid = tuple(t_grid or np.linspace(0.1, 1.0, 10).round(2))
        t_indices = [self._t_index(et) for et in t_grid]
        suffix = (("-fix_xt" if fix_xt else "") + ("-fix_t" if fix_t else "")
                  + self._basis_name_extras(tap))
        names = [basis_name(cfg.dataset_name, idx, et, op, block_idx, cfg.seed,
                            pca_rank=pca_rank) + suffix for et in t_grid]
        if all(self.cache.load(n) is not None for n in names):
            return {et: self.cache.path(n) for et, n in zip(t_grid, names)}

        dp = self._harvest_dp(len(t_grid), "harvest_dp_skip")
        x, cur, images = self.run_ddim_inversion(idx), 0, {}
        for ti in sorted(set(t_indices)):
            if ti > cur:
                x, cur = self._forward_steps(x, cur, ti), ti
            images[ti] = x
        out = {}
        with self._stage("tangent_harvest", num_t=len(t_grid), pca_rank=pca_rank,
                         dp=dp or 1):
            points = list(zip(t_grid, t_indices, names))
            bases = self._dp_sweep(points, lambda p: self.compute_local_basis(
                images[t_indices[0] if fix_xt else p[1]],
                self.fwd_grid.timesteps[t_indices[0] if fix_t else p[1]], tap,
                pca_rank), dp)
            for (et, _, name), res in zip(points, bases):
                out[et] = self._save_basis(name, res)
        return out

    def run_sample_encoder_local_tangent_space_xt(
        self, idx: int, op: str = "mid", block_idx: int = 0, pca_rank: int = 50,
        t_grid: Optional[Tuple[float, ...]] = None,
    ):
        """Harvest the bases of sample ``idx`` over a timestep grid point by
        point: one inversion, then for each t missing from the cache the
        forward from x_T to t and the pullback. Returns {t: basis file} of
        the bases computed."""
        cfg = self.cfg
        tap = TapPoint(op, block_idx)
        t_grid = tuple(t_grid or np.linspace(0.1, 1.0, 10).round(2))
        xT = self.run_ddim_inversion(idx)
        out = {}
        for et in t_grid:
            t_idx = self._t_index(et)
            name = basis_name(cfg.dataset_name, idx, et, op, block_idx, cfg.seed,
                              pca_rank=pca_rank) + self._basis_name_extras(tap)
            if self.cache.load(name) is not None:
                continue
            res = self.compute_local_basis(self._forward_steps(xT, 0, t_idx),
                                           self.fwd_grid.timesteps[t_idx], tap, pca_rank)
            out[et] = self._save_basis(name, res)
        return out
