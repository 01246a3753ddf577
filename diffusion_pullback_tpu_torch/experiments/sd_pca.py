"""The h-basis edit of the SD driver (counterpart of
``SDPCAMixin._edit_with_global_h_basis`` in
diffusion_pullback_tpu/experiments/sd_pca.py; the PCA runs of that module
are not ported)."""

from __future__ import annotations

import torch

from ..geometry import pullback_covector
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
