"""What the experiment drivers share (counterpart of
diffusion_pullback_tpu/experiments/_common.py): the NHWC ↔ NCHW boundary,
the synchronised stage timer and the tap construction."""

from __future__ import annotations

import contextlib
import time

import torch

from ..models.unet2d import TapPoint

to_nchw = lambda z: z.permute(0, 3, 1, 2)
to_nhwc = lambda z: z.permute(0, 2, 3, 1)


class DriverCommonMixin:
    """Requires ``self.device`` and ``self.log`` (a JSONLLogger);
    ``_make_tap`` also ``self._arch_config`` (the differentiated model's
    config)."""

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
