"""Tangent-space basis harvests of the SD driver (counterpart of
``SDHarvestMixin`` in diffusion_pullback_tpu/experiments/sd_harvest.py):
per (t, prompt) point DDIM inversion → partial forward → encoder pullback →
the basis (u, s, vT) saved under the name the edit paths read.

  - ``run_sample_encoder_local_tangent_space_zt``: one (t, prompt) point;
  - ``run_sample_encoder_local_tangent_space_zt_batched``: a grid of t,
    one inversion and one walk down the trajectory;
  - ``run_sample_encoder_local_tangent_space_zt_various_prompt``: a list
    of prompts at one t, one inversion and one partial forward, each
    prompt's basis under the per-prompt edit path's cache name.

On one device every per-point pullback runs in sequence, as the JAX
package's auto dispatch runs them there. With a 'dp' mesh axis the points
missing from the cache split over its ranks (``_dp_sweep``: each rank its
contiguous share, the bases gathered, rank 0 writing them), where the JAX
package vmaps them with the sweep axis sharded.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models import TapPoint
from .cache import basis_name


class SDHarvestMixin:
    """Mixed into EditStableDiffusion; uses its inversion, forward steps,
    conditioning hooks, pullback encoders and basis cache."""

    def run_sample_encoder_local_tangent_space_zt_batched(
        self,
        idx: int,
        op: str = "mid",
        block_idx: int = 0,
        pca_rank: int = 50,
        t_grid=None,
        sequential: Optional[bool] = None,
        after_res: bool = False,
        after_sa: bool = False,
    ):
        """Harvest the bases of sample ``idx`` over a timestep grid (default
        0.1 … 1.0 in tenths): one inversion, then one walk down the forward
        trajectory in t-index order, and at each grid point the pullback
        of compute_local_basis (the kernel pair, CFG inside the JVP when
        pullback_guidance_scale > 0, the after_res / after_sa tap). The
        latent at grid index i is the input of forward step i. Returns
        {t: basis file}; points already in the cache are not recomputed.
        ``sequential`` is the JAX signature's: on one device the JAX
        package too maps the per-t pullbacks in sequence, and here they
        always run so. With a 'dp' mesh axis that divides the grid every
        rank walks the trajectory and the missing points' pullbacks split
        over the axis."""
        cfg = self.cfg
        tap = self._make_tap(op, block_idx, after_res, after_sa)
        t_grid = tuple(t_grid or np.linspace(0.1, 1.0, 10).round(2))
        suffix = self._basis_name_extras(tap)
        names = {et: basis_name(cfg.dataset_name, idx, et, op, block_idx, cfg.seed,
                                edit_prompt=cfg.edit_prompt, pca_rank=pca_rank) + suffix
                 for et in t_grid}
        if all(self.cache.load(n) is not None for n in names.values()):
            return {et: self.cache.path(n) for et, n in names.items()}

        dp = self._harvest_dp(len(t_grid), "sd_harvest_dp_skip")
        z, cur = self.run_DDIMinversion(idx), 0
        points = {}
        with self._stage("sd_tangent_harvest", num_t=len(t_grid), pca_rank=pca_rank,
                         dp=dp or 1):
            for et in sorted(t_grid, key=self._t_index):
                ti = self._t_index(et)
                if ti > cur:
                    z, cur = self.DDIMforwardsteps(z, cur, ti), ti
                if self.cache.load(names[et]) is not None:
                    continue
                if dp:
                    points[et] = (z, self.fwd_grid.timesteps[ti])
                else:
                    self._save_basis(names[et], self.compute_local_basis(
                        z, self.fwd_grid.timesteps[ti], tap, pca_rank))
            todo = list(points)
            for et, res in zip(todo, self._dp_sweep(
                    todo, lambda et: self.compute_local_basis(*points[et], tap, pca_rank),
                    dp)):
                self._save_basis(names[et], res)
        return {et: self.cache.path(names[et]) for et in t_grid}

    def run_sample_encoder_local_tangent_space_zt_various_prompt(
        self,
        prompts,
        idx: int,
        op: str = "mid",
        block_idx: int = 0,
        pca_rank: Optional[int] = None,
        h_t: Optional[float] = None,
        sequential: Optional[bool] = None,
    ):
        """Harvest one basis per prompt for sample ``idx`` at ``h_t``
        (default edit_t): the inversion and the partial forward once (they
        do not depend on the edit prompt), then each missing prompt's
        pullback with the same probe seed, as the per-prompt edit path
        draws them. The names are that path's, so
        run_edit_local_encoder_pullback_zt with each prompt afterwards
        reads the cache and runs no pullback. Returns {prompt: basis
        file}. ``sequential`` as in the t-grid harvest. With a 'dp' mesh
        axis the missing prompts (padded to a multiple of its size) split
        over it."""
        cfg = self.cfg
        tap = TapPoint(op, block_idx)
        pca_rank = pca_rank or cfg.pca_rank
        h_t = cfg.edit_t if h_t is None else h_t
        names = [basis_name(cfg.dataset_name, idx, h_t, op, block_idx, cfg.seed,
                            edit_prompt=pr, pca_rank=pca_rank)
                 + self._basis_name_extras(tap) for pr in prompts]
        todo = [i for i, n in enumerate(names) if self.cache.load(n) is None]
        if todo:
            from ..parallel.mesh import axis_size

            t_idx = self._t_index(h_t)
            zt = self.run_DDIMinversion(idx)
            if t_idx > 0:
                zt = self.DDIMforwardsteps(zt, 0, t_idx)
            dp = axis_size(cfg.mesh, "dp")
            dp = dp if dp > 1 else 0
            with self._stage("sd_prompt_sweep", num_prompts=len(todo), dp=dp or 1):
                bases = self._dp_sweep(todo, lambda i: self.compute_local_basis(
                    zt, self.fwd_grid.timesteps[t_idx], tap, pca_rank,
                    edit_emb=self._get_emb(prompts[i])), dp)
                for i, res in zip(todo, bases):
                    self._save_basis(names[i], res)
        return {p: self.cache.path(n) for p, n in zip(prompts, names)}

    def run_sample_encoder_local_tangent_space_zt(
        self, idx: int, op: str = "mid", block_idx: int = 0, pca_rank: int = 50,
        h_t: float = 1.0, edit_prompt: Optional[str] = None,
    ):
        """The basis at one (t, prompt) point; ``edit_prompt`` becomes the
        driver's edit prompt, as in the JAX driver. Returns its file."""
        cfg = self.cfg
        tap = TapPoint(op, block_idx)
        self._set_edit_prompt(edit_prompt)
        name = basis_name(cfg.dataset_name, idx, h_t, op, block_idx, cfg.seed,
                          edit_prompt=cfg.edit_prompt, pca_rank=pca_rank)
        if self.cache.load(name) is None:
            t_idx = self._t_index(h_t)
            zt = self.run_DDIMinversion(idx)
            if t_idx > 0:
                zt = self.DDIMforwardsteps(zt, 0, t_idx)
            self._save_basis(name, self.compute_local_basis(
                zt, self.fwd_grid.timesteps[t_idx], tap, pca_rank))
        return self.cache.path(name)
