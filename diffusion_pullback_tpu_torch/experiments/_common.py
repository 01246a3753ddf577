"""What the experiment drivers share (counterpart of
diffusion_pullback_tpu/experiments/_common.py): the NHWC ↔ NCHW boundary,
the synchronised stage timer, the exported programs, the tap construction,
the grid index of a t, the seeded sample draw, the basis write and its
analysis artifacts, and the post-edit regularizers."""

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


class _Holder(torch.nn.Module):
    """``fn`` as the forward of a module that holds ``modules``, so
    functional_call can run it on other weights."""

    def __init__(self, fn, modules):
        super().__init__()
        self.held = torch.nn.ModuleList(modules)
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class DriverCommonMixin:
    """Requires ``self.device`` and ``self.log`` (a JSONLLogger);
    ``_make_tap`` also ``self._arch_config`` (the differentiated model's
    config), ``_draw_latents`` ``self.cfg`` and ``self._sample_shape``,
    ``_program`` ``self.cfg.aot_export``."""

    def _program(self, name: str, fn, *modules):
        """``fn`` (a function of tensors that runs ``modules``) as program
        ``name``: with cfg.aot_export 'on' through the export cache
        (utils/aot.py), the modules' parameters and buffers passed to it as
        an argument; else ``fn`` itself, run eagerly ('auto' and 'off': an
        eager process has no trace to save). Either way the outcome is
        logged once per program as an ``aot_program`` event."""
        mode = self.cfg.aot_export
        if mode != "on":
            logged = self.__dict__.setdefault("_eager_programs", set())
            if name not in logged:
                logged.add(name)
                self.log.log("aot_program", name=name, status="eager",
                             reason=f"aot_export {mode}")
            return fn
        from torch.func import functional_call

        from ..utils.aot import AOTProgramCache

        if "_aot_programs" not in self.__dict__:
            self._aot_programs = AOTProgramCache(logger=self.log)
        holder = _Holder(fn, modules)
        weights = {**dict(holder.named_parameters()), **dict(holder.named_buffers())}
        prog = self._aot_programs.wrap(
            name, lambda w, *args: functional_call(holder, w, args),
            self._cfg_fingerprint())
        return lambda *args: prog(weights, *args)

    def _cfg_fingerprint(self) -> str:
        """Digest of every primitive config field that a program can bake
        in as a constant (guidance scales, step counts, dtypes, chunk
        sizes); the folders and paths are left out, they reach no program.
        Recomputed per call: runs change cfg fields (edit_prompt)."""
        import dataclasses
        import hashlib

        parts = []
        for f in dataclasses.fields(self.cfg):
            if f.name == "mesh" or any(s in f.name for s in ("folder", "dir", "path")):
                continue
            v = getattr(self.cfg, f.name)
            if isinstance(v, (int, float, bool, str, type(None), tuple, list)):
                parts.append(f"{f.name}={v!r}")
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]

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
