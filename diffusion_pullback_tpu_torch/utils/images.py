"""Image I/O of NHWC batches in [-1, 1] (counterpart of load_image and
save_image_grid in diffusion_pullback_tpu/utils/images.py)."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image


def load_image(path, image_size: int) -> np.ndarray:
    """An image file (or an open PIL image): center-crop to the largest
    square, resize bilinearly, scale to [-1, 1] → (1, S, S, 3) float32. The resize samples at pixel centres
    (align_corners=False) without antialiasing, the convention of the JAX
    package's native loader (native/imageproc.cpp); PIL's antialiased
    BILINEAR filter would differ from it by several uint8 levels at 2×."""
    img = (path if isinstance(path, Image.Image) else Image.open(path)).convert("RGB")
    w, h = img.size
    side = min(w, h)
    left, top = (w - side) // 2, (h - side) // 2
    arr = np.asarray(img.crop((left, top, left + side, top + side)), np.float32)
    x = torch.from_numpy(arr).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(image_size, image_size), mode="bilinear",
                      align_corners=False, antialias=False)
    return (x.permute(0, 2, 3, 1) * (2.0 / 255.0) - 1.0).numpy()


def to_uint8(batch: np.ndarray) -> np.ndarray:
    """[-1, 1] NHWC floats → uint8 (x/2 + 0.5, clamped)."""
    batch = np.asarray(batch, dtype=np.float32)
    return (np.clip(batch / 2 + 0.5, 0, 1) * 255).round().astype(np.uint8)


def save_image_grid(batch: np.ndarray, path: str) -> None:
    """Save an NHWC batch as one PNG, the images side by side (rank 0 of a
    torch.distributed run writes)."""
    from ..parallel.mesh import is_writer

    if not is_writer():
        return
    arr = to_uint8(batch)
    grid = np.concatenate(list(arr), axis=1)   # (H, N·W, C)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(grid.squeeze(-1) if grid.shape[-1] == 1 else grid).save(path)
