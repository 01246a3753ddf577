"""What the experiment drivers share (counterpart of
diffusion_pullback_tpu/experiments/_common.py): the NHWC ↔ NCHW boundary,
the synchronised stage timer, the tap construction, the grid index of a
t, the seeded sample draw, the basis write and its analysis artifacts, and
the post-edit regularizers."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from ..models.unet2d import TapPoint
from ..samplers.regularizers import (dynamic_thresholding, preserve_contrast,
                                     preserve_norm)

to_nchw = lambda z: z.permute(0, 3, 1, 2)
to_nhwc = lambda z: z.permute(0, 2, 3, 1)


class DriverCommonMixin:
    """Requires ``self.device`` and ``self.log`` (a JSONLLogger);
    ``_make_tap`` also ``self._arch_config`` (the differentiated model's
    config), ``_draw_latents`` ``self.cfg`` and ``self._sample_shape``."""

    @contextlib.contextmanager
    def _stage(self, event: str, **fields):
        """Log ``event`` with the seconds of the block, the device's work
        included (synchronised on CUDA, where launches return early)."""
        sync = (lambda: torch.cuda.synchronize(self.device)
                if self.device.type == "cuda" else None)
        sync()
        t0 = time.perf_counter()
        yield fields
        sync()
        self.log.log(event, seconds=time.perf_counter() - t0, **fields)

    def _t_index(self, t: float) -> int:
        """The forward grid's index nearest t·1000 (needs ``self.fwd_grid``)."""
        return int(torch.argmin(torch.abs(self.fwd_grid.timesteps - t * 1000.0)))

    def _draw_latents(self, num_samples: int,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Gaussian NHWC samples of the driver's ``_sample_shape``, drawn on
        the CPU from ``generator`` (by default one seeded with cfg.seed)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        return torch.randn(num_samples, *self._sample_shape,
                           generator=generator).to(self.device)

    def _save_basis(self, name: str, res) -> str:
        """Write a PullbackResult's (u, s, vT) to the basis cache (needs
        ``self.cache``); returns the file."""
        f32 = lambda a: a.float().cpu().numpy()
        return self.cache.save(name, f32(res.u), f32(res.s), f32(res.vT))

    def _vis_basis(self, name: str, s, vT, shape) -> None:
        """The analysis artifacts of a freshly computed basis in
        cfg.obs_folder: its eigenvalue spectrum and the RGB map of its
        directions (``shape`` one sample's (H, W, C)). Visualisation never
        ends a run: a failure to plot (matplotlib absent, say) is logged as
        ``vis_failed``."""
        s, vT = s.float().cpu().numpy(), vT.float().cpu().numpy()
        try:
            from .vis import plot_eigenvalue_spectrum, visualize_vT_rgb

            obs = self.cfg.obs_folder
            plot_eigenvalue_spectrum(s, os.path.join(obs, f"eigenvalue_spectrum-{name}.png"))
            visualize_vT_rgb(vT, shape, os.path.join(obs, f"vT-{name}.png"))
        except Exception as e:
            self.log.log("vis_failed", error=str(e))

    def _regularize(self, sel: torch.Tensor, z_start: torch.Tensor) -> torch.Tensor:
        """The post-edit regularizers that cfg turns on, in the reference's
        order (thresholding, contrast, norm), on the walk frames ``sel``
        (one sample per row) against the walk's start ``z_start`` (batch
        1, broadcast)."""
        cfg = self.cfg
        if cfg.use_dynamic_thresholding:
            sel = dynamic_thresholding(sel, cfg.dynamic_thresholding_q)
        if cfg.use_preserve_contrast:
            sel = preserve_contrast(sel, z_start)
        if cfg.use_preserve_norm:
            sel = preserve_norm(sel, z_start)
        return sel

    def _make_tap(self, op, block_idx, after_res=False, after_sa=False) -> TapPoint:
        """``after_res`` / ``after_sa`` move the tap after the block's last
        resnet / self-attention instead of the block output; a family
        without such blocks (ADM) raises."""
        if after_res or after_sa:
            if not hasattr(self._arch_config, "layers_per_block"):
                raise ValueError("intra-block taps (after_res/after_sa) are not "
                                 "supported for this model family")
            layer = self._arch_config.layers_per_block - 1
            return TapPoint(op, block_idx, ("res", layer) if after_res else ("attn", layer))
        return TapPoint(op, block_idx)
