"""PCA runs of the SD driver (counterpart of ``SDPCAMixin`` in
diffusion_pullback_tpu/experiments/sd_pca.py): local PCA of the tapped h
over latent perturbations, text-space PCA over prompt-embedding
perturbations, global PCA over a population of sampled latents, and the
h-basis edit that maps h-space directions to latent directions through Jᵀ.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..geometry import (global_pca, local_pca, pca_to_x_direction,
                        pullback_covector)
from ..models import TapPoint


class SDPCAMixin:
    """Mixed into EditStableDiffusion; uses its tap encoders and edit tail."""

    def _edit_with_global_h_basis(self, idx, u_mean, op, block_idx, vis_num,
                                  vis_num_pc, tag, zt=None):
        """Map h-space directions (the columns of ``u_mean``, (dim_h, k),
        NHWC-flattened) to latent directions at the sample through Jᵀ of
        the edit-prompt encoder, v = Jᵀu/‖Jᵀu‖, and run the guidance edit.
        ``zt`` reuses a caller's inverted latent."""
        cfg = self.cfg
        tap = TapPoint(op, block_idx)
        if zt is None:
            zt = self._zt(idx)
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        enc = self._vjp_encoder(t_edit, tap, self.edit_prompt_emb)
        shape = zt.shape[1:]
        vks, names = [], []
        with self._stage("sd_inverse_jacobian", directions=vis_num_pc):
            for pc in range(vis_num_pc):
                v = pullback_covector(enc, zt, u_mean[:, pc])
                v = v / torch.linalg.norm(v)
                for sign, stag in ((1.0, "pos"), (-1.0, "neg")):
                    vks.append(sign * v.reshape(shape))
                    names.append(
                        f"Edit_{tag}-{cfg.dataset_name}_{idx}-edit_{cfg.edit_t}T"
                        f"-{op}-block_{block_idx}-pc_{pc:03d}_{stag}"
                        f"-edit_prompt_{cfg.edit_prompt}")
        return self._edit_along_directions(zt, vks, names, vis_num)

    def run_edit_local_pca_zt(
        self,
        idx: int,
        op: str = "mid",
        block_idx: int = 0,
        pca_rank: int = 8,
        num_samples: int = 1024,
        sigma: float = 0.1,
        vis_num: Optional[int] = None,
        vis_num_pc: Optional[int] = None,
        edit_prompt: Optional[str] = None,
    ):
        """Edit along local-PCA h-directions: the streaming PCA of the
        edit-prompt encoder's h over ``num_samples`` perturbations σδ of
        the latent at the edit t (chunks of min(16, num_samples), seed
        cfg.seed), each component mapped to the latent through Jᵀ, then
        the guidance edit."""
        cfg = self.cfg
        self._set_edit_prompt(edit_prompt)
        vis_num = vis_num or cfg.vis_num
        vis_num_pc = vis_num_pc or cfg.vis_num_pc
        tap = TapPoint(op, block_idx)
        zt = self._zt(idx)
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        enc = self._encoder(t_edit, tap, self.unet.config.attn_impl)
        with self._stage("sd_local_pca", num_samples=num_samples) as log:
            pca = local_pca(lambda z: enc(z, self.edit_prompt_emb), zt, cfg.seed,
                            rank=pca_rank, num_samples=num_samples,
                            chunk=min(16, num_samples), sigma=sigma)
            log.update(top_var=pca.variances[:3].cpu().numpy().round(5))

        to_x = self._vjp_encoder(t_edit, tap, self.edit_prompt_emb)
        shape = zt.shape[1:]
        vks, names = [], []
        for pc in range(vis_num_pc):
            v = pca_to_x_direction(to_x, zt, pca.components[pc])
            for sign, tag in ((1.0, "pos"), (-1.0, "neg")):
                vks.append(sign * v.reshape(shape))
                names.append(
                    f"Edit_local_pca-{cfg.dataset_name}_{idx}"
                    f"-edit_{cfg.edit_t}T-{op}-block_{block_idx}"
                    f"-pc_{pc:03d}_{tag}-edit_prompt_{cfg.edit_prompt}")
        return self._edit_along_directions(zt, vks, names, vis_num)

    def run_local_pca_text(
        self,
        idx: int,
        op: str = "mid",
        block_idx: int = 0,
        pca_rank: int = 8,
        num_samples: int = 512,
        perturb_h: float = 1e-1,
        edit_prompt: Optional[str] = None,
    ):
        """Text-space PCA: the streaming PCA of the tapped h over unit-norm
        Gaussian perturbations of the prompt embedding (σ 1, the latent at
        the edit t held fixed), each principal h-direction pulled back into
        embedding space by one VJP and normalised. Saved in the basis cache
        as u = the h-space components as columns, s = √max(variance, 0),
        vT = the embedding-space rows; returns the file. ``perturb_h`` is
        the JAX signature's and changes nothing: the exact VJP needs no
        residual scale. A dual-tower (SDXL) embedding raises, as in the JAX
        driver."""
        cfg = self.cfg
        self._set_edit_prompt(edit_prompt)
        if not isinstance(self.edit_prompt_emb, torch.Tensor):
            raise NotImplementedError(
                "text-space PCA perturbs a single context embedding; it is "
                "defined only for the SD (single-tower) family")
        tap = TapPoint(op, block_idx)
        name = (f"local_pca_text-{cfg.dataset_name}_{idx}-edit_{cfg.edit_t}T"
                f"-{op}-block_{block_idx}-rank_{pca_rank}-seed_{cfg.seed}"
                f"-prompt_{(cfg.edit_prompt or 'none').replace(' ', '_')[:40]}")
        if self.cache.load(name) is not None:
            return self.cache.path(name)

        zt = self._zt(idx)
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        enc = self._encoder(t_edit, tap, self.unet.config.attn_impl)
        impl, impl_vjp = self._pair_impls()
        enc_vjp = self._encoder(t_edit, tap, impl_vjp or impl)
        emb = self.edit_prompt_emb
        with self._stage("sd_local_pca_text", num_samples=num_samples) as log:
            pca = local_pca(lambda e: enc(zt, e), emb, cfg.seed, rank=pca_rank,
                            num_samples=num_samples, chunk=min(16, num_samples),
                            sigma=1.0, unit_delta=True)
            vT_text = []
            for comp in pca.components:
                v = pullback_covector(lambda e: enc_vjp(zt, e), emb, comp)
                vT_text.append((v / torch.linalg.norm(v).clamp_min(1e-12)).reshape(-1))
            log.update(top_var=pca.variances[:3].cpu().numpy().round(6))
        var = pca.variances.cpu().numpy()
        return self.cache.save(name, pca.components.T.cpu().numpy(),
                               np.sqrt(np.maximum(var, 0)),
                               torch.stack(vT_text).float().cpu().numpy())

    def run_edit_global_pca_zt(
        self,
        idx: int,
        num_samples: int = 16,
        op: str = "mid",
        block_idx: int = 0,
        pca_rank: int = 2,
        vis_num: Optional[int] = None,
        vis_num_pc: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        edit_prompt: Optional[str] = None,
    ):
        """Global-PCA edit: ``num_samples`` Gaussian latents (from
        ``generator``, by default one seeded with cfg.seed) forwarded to the
        edit t as one batch, their tapped h under the edit prompt PCA'd,
        and the top directions mapped to the sample's latent through Jᵀ for
        the guidance edit."""
        cfg = self.cfg
        self._set_edit_prompt(edit_prompt)
        vis_num = vis_num or cfg.vis_num
        vis_num_pc = vis_num_pc or cfg.vis_num_pc
        tap = TapPoint(op, block_idx)
        t_edit = self.fwd_grid.timesteps[self.edit_t_idx]
        with self._stage("sd_global_pca_harvest", num_samples=num_samples) as log:
            zT = self._draw_latents(num_samples, generator)
            with torch.no_grad():
                zt = self.DDIMforwardsteps(zT, 0, self.edit_t_idx)
                h = self._encoder(t_edit, tap, self.unet.config.attn_impl)(
                    zt, self.edit_prompt_emb)
            res = global_pca(h, rank=pca_rank)
            log.update(top_var=res.variances[:3].cpu().numpy().round(4))
        # components are unit h-directions: (k, dim_h) → (dim_h, k)
        return self._edit_with_global_h_basis(
            idx, res.components.T, op, block_idx, vis_num, vis_num_pc, "global_pca")
