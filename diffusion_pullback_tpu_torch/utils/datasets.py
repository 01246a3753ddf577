"""Datasets: numbered-image folders, seeded noise and prompt lists
(counterpart of ImgDataset, NoiseDataset, get_dataset and get_prompt_list in
diffusion_pullback_tpu/utils/datasets.py). Items are (1, S, S, 3) float32
NHWC arrays in [-1, 1]."""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from .images import load_image

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class ImgDataset:
    """Folder of images, ordered by the integer in each filename."""

    EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")

    def __init__(self, root: str, image_size: int):
        self.root = root
        self.image_size = image_size
        names = [f for f in os.listdir(root) if f.lower().endswith(self.EXTS)]

        def key(name: str):
            m = re.search(r"\d+", name)
            return (int(m.group()) if m else 1 << 30, name)

        self.files: List[str] = [os.path.join(root, f) for f in sorted(names, key=key)]
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        return load_image(self.files[idx], self.image_size)


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


def get_dataset(dataset_name: str, image_size: int,
                data_root: Optional[str] = None):
    """'noise' → NoiseDataset; any other name → the first image folder among
    ``data_root``, ``data_root/<name lower>`` and the repository's
    ``datasets/<name lower>`` and ``datasets/<name>``. Raises
    FileNotFoundError when none holds images."""
    if dataset_name == "noise":
        return NoiseDataset(image_size)
    candidates = []
    if data_root:
        candidates += [data_root, os.path.join(data_root, dataset_name.lower())]
    candidates += [os.path.join(_REPO, "datasets", dataset_name.lower()),
                   os.path.join(_REPO, "datasets", dataset_name)]
    for c in candidates:
        if os.path.isdir(c):
            try:
                return ImgDataset(c, image_size)
            except FileNotFoundError:
                continue
    raise FileNotFoundError(
        f"dataset {dataset_name!r} not found (searched {candidates}); "
        "use dataset_name='noise' for offline runs or pass data_root")


# the built-in caption bank (this package's copy of the JAX package's), the
# last fallback of get_prompt_list
_BUILTIN_CAPTIONS = [
    "a photo of a dog", "a photo of a cat", "a person smiling",
    "a red car on the street", "a mountain landscape at sunset",
    "a bowl of fruit on a table", "a city skyline at night",
    "a bird sitting on a branch", "a plate of pasta", "a child playing",
]
# the bundled 50 COCO-style captions, one per line
_SHIPPED_PROMPT_FILE = os.path.join(_REPO, "inputs", "prompts_coco50.txt")


def get_prompt_list(num_captions: int = 10, path: Optional[str] = None) -> List[str]:
    """``num_captions`` prompts from a local captions file (one per line, or
    a .json list), else the bundled inputs/prompts_coco50.txt, else the
    built-in 10-caption bank; the list repeats to reach ``num_captions``."""
    if not (path and os.path.exists(path)):
        path = _SHIPPED_PROMPT_FILE if os.path.exists(_SHIPPED_PROMPT_FILE) else None
    caps: List[str] = []
    if path:
        import json

        with open(path) as f:
            caps = json.load(f) if path.endswith(".json") else [
                line.strip() for line in f if line.strip()]
    caps = caps or _BUILTIN_CAPTIONS
    reps = (num_captions + len(caps) - 1) // len(caps)
    return (caps * reps)[:num_captions]
