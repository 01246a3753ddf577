"""PNG grids of NHWC image batches in [-1, 1] (counterpart of
save_image_grid in diffusion_pullback_tpu/utils/images.py)."""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


def to_uint8(batch: np.ndarray) -> np.ndarray:
    """[-1, 1] NHWC floats → uint8 (x/2 + 0.5, clamped)."""
    batch = np.asarray(batch, dtype=np.float32)
    return (np.clip(batch / 2 + 0.5, 0, 1) * 255).round().astype(np.uint8)


def save_image_grid(batch: np.ndarray, path: str) -> None:
    """Save an NHWC batch as one PNG, the images side by side."""
    arr = to_uint8(batch)
    grid = np.concatenate(list(arr), axis=1)   # (H, N·W, C)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(grid.squeeze(-1) if grid.shape[-1] == 1 else grid).save(path)
