"""Offline data (counterpart of NoiseDataset in
diffusion_pullback_tpu/utils/datasets.py)."""

from __future__ import annotations

import numpy as np


class NoiseDataset:
    """Deterministic Gaussian 'images' (NHWC, in (-1, 1)) for offline runs;
    the same arrays as the JAX package's NoiseDataset."""

    def __init__(self, image_size: int, n: int = 8, scale: float = 0.7):
        self.image_size = image_size
        self.n = n
        self.scale = scale

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(idx)
        x = rng.normal(size=(1, self.image_size, self.image_size, 3))
        return np.tanh(x.astype(np.float32)) * self.scale
