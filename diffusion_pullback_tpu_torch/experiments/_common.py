"""What the experiment drivers share (counterpart of
diffusion_pullback_tpu/experiments/_common.py): the NHWC ↔ NCHW boundary,
the synchronised stage timer, the exported programs, the tap construction,
the grid index of a t, the seeded sample draw, the basis write and its
analysis artifacts, the post-edit regularizers, and the device mesh: the
weights' placement, the probe-sharded pullback's axis size and the dp
sweeps.

Under a mesh every rank runs the driver, and only rank 0 writes files
(PNGs, bases, the JSONL log); a decision that rests on a file (a cache hit,
an edit already on disk) is rank 0's on every rank (``_missing``,
BasisCache.load), so every rank takes the same branch and runs the same
collectives."""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Optional

import torch

from ..models.unet2d import TapPoint
from ..parallel.mesh import agreed, axis_group, axis_size, is_writer
from ..samplers.regularizers import (dynamic_thresholding, preserve_contrast,
                                     preserve_norm)
from ..utils.profiling import span

Basis = collections.namedtuple("Basis", "u s vT")

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
        if mode == "on" and getattr(self.cfg, "mesh", None) is not None:
            # a program of collectives is not exported (the JAX package's
            # mesh runs skip the export cache too)
            mode = "on, not under a mesh"
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
        included (synchronised on CUDA, where launches return early). Under
        a profiler the block is span ``event`` with ``fields`` as opened,
        its closing wait for the device a child span ``sync``."""
        sync = (lambda: torch.cuda.synchronize(self.device)
                if self.device.type == "cuda" else None)
        sync()
        t0 = time.perf_counter()
        with span(event, **fields):
            yield fields
            with span("sync"):
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
        ``self.cache``); returns the file. Spans ``basis_d2h`` (the copies
        to the host) and ``basis_write``."""
        with span("basis_d2h"):
            u, s, vT = (a.float().cpu().numpy() for a in (res.u, res.s, res.vT))
        with span("basis_write"):
            return self.cache.save(name, u, s, vT)

    def _vis_basis(self, name: str, s, vT, shape) -> None:
        """The analysis artifacts of a freshly computed basis in
        cfg.obs_folder: its eigenvalue spectrum and the RGB map of its
        directions (``shape`` one sample's (H, W, C)). Visualisation never
        ends a run: a failure to plot (matplotlib absent, say) is logged as
        ``vis_failed``. Rank 0 writes them."""
        if not is_writer():
            return
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

    # ---- the device mesh ------------------------------------------------------

    def _missing(self, path: str) -> bool:
        """Whether ``path`` is missing, as rank 0 sees it (every rank takes
        the branch rank 0 takes)."""
        return agreed(not os.path.exists(path))

    def _place_weights(self, module: torch.nn.Module) -> torch.nn.Module:
        """Place ``module``'s weights on cfg.mesh: rank 0's weights on every
        rank, then the Megatron layout when the mesh has a 'tp' axis
        (parallel/tp.py). An 'sp' axis publishes the mesh for ring
        attention (a mesh without one clears any earlier one). No mesh:
        unchanged."""
        mesh = self.cfg.mesh
        if mesh is None:
            return module
        from ..parallel import set_ring_mesh, tp_shard_params

        set_ring_mesh(mesh if axis_size(mesh, "sp") > 1 else None)
        self._replicate(module)
        if axis_size(mesh, "tp") > 1:
            tp_shard_params(module, mesh)
        return module

    @staticmethod
    def _replicate(module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank."""
        import torch.distributed as dist

        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)

    def _mesh_probe_size(self, pca_rank: int) -> int:
        """Probe-axis size when the configured mesh can shard this pullback
        (0 = run on one rank): a 'probe' axis > 1 dividing pca_rank, and no
        pullback_chunk_size (chunking and probe sharding exclude each
        other, as in the JAX package; SDXL's chunked pullback stays
        whole)."""
        mesh = self.cfg.mesh
        n = axis_size(mesh, "probe")
        if n <= 1 or pca_rank % n != 0 or self.cfg.pullback_chunk_size:
            return 0
        return n

    def _probe_group(self, pca_rank: int):
        """The probe group of a pullback at ``pca_rank`` (None: unsharded)."""
        return axis_group(self.cfg.mesh, "probe") if self._mesh_probe_size(pca_rank) else None

    def _harvest_dp(self, n_items: int, log_name: str) -> int:
        """dp-axis size when the configured mesh can shard an n-item sweep
        (0 = every item on every rank)."""
        dp = axis_size(self.cfg.mesh, "dp")
        if dp <= 1:
            return 0
        if n_items % dp != 0:
            self.log.log(log_name, num_t=n_items, dp=dp)
            return 0
        return dp

    def _dp_sweep(self, items, compute, dp: int):
        """The bases (u, s, vT) of ``compute(item)`` (a PullbackResult) for
        every item: with dp > 1 the items, padded with the last to a
        multiple of dp, split into contiguous shares, each rank computing
        its own and the bases gathered over the mesh's 'dp' axis, whole on
        every rank; else each item's PullbackResult, in turn on every
        rank."""
        if not dp:
            return [compute(it) for it in items]
        from ..parallel.collectives import gather_rows
        from ..parallel.ring_attention import dp_split

        group = axis_group(self.cfg.mesh, "dp")
        padded = list(items) + list(items[-1:]) * ((-len(items)) % dp)
        per = len(padded) // dp
        me = torch.distributed.get_rank(group)
        with dp_split():
            mine = [compute(it) for it in padded[me * per:(me + 1) * per]]
        u, s, vT = (gather_rows(torch.stack([getattr(r, f) for r in mine]), group)
                    for f in ("u", "s", "vT"))
        return [Basis(u[i], s[i], vT[i]) for i in range(len(items))]
