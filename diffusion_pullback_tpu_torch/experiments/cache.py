"""Artifact cache for pullback bases (u, s, vT).

Counterpart of diffusion_pullback_tpu/experiments/cache.py with the same
basis names and the same .npz layout (u (dim_h, k), s (k,), vT (k, dim_x),
float32, h and x flattened in NHWC order), so each package reads the
other's bases. It also reads the JAX package's native .dpb files (32-byte
header of eight little-endian u32 — magic, version, u rows, u cols, k, vT
rows, vT cols, 0 — then u, s, vT as raw float32); it writes .npz.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np

_DPB_MAGIC, _DPB_VERSION = 0x53425044, 1


def basis_name(dataset_name: str, sample_idx: int, edit_t: float, op: str,
               block_idx: int, seed: int, edit_prompt: Optional[str] = None,
               pca_rank: Optional[int] = None) -> str:
    """local_basis-{dataset}_{idx}-{t}T-["{prompt}"-]{op}-block_{i}-seed_{s}[-pca_rank_{r}]"""
    prompt_part = f'-"{edit_prompt}"' if edit_prompt is not None else ""
    rank_part = f"-pca_rank_{pca_rank}" if pca_rank is not None else ""
    return (f"local_basis-{dataset_name}_{sample_idx}-{edit_t}T{prompt_part}"
            f"-{op}-block_{block_idx}-seed_{seed}{rank_part}")


def _read_dpb(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    raw = np.fromfile(path, dtype="<u4", count=8)
    if len(raw) != 8 or raw[0] != _DPB_MAGIC or raw[1] != _DPB_VERSION:
        raise ValueError(f"not a basis file: {path}")
    u0, u1, k, v0, v1 = (int(d) for d in raw[2:7])
    data = np.fromfile(path, dtype="<f4", offset=32)
    if data.size != u0 * u1 + k + v0 * v1:
        raise ValueError(f"truncated basis file: {path}")
    u = data[:u0 * u1].reshape(u0, u1)
    s = data[u0 * u1:u0 * u1 + k]
    return u, s, data[u0 * u1 + k:].reshape(v0, v1)


class BasisCache:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def load(self, name: str) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(u, s, vT) of a cached basis, from .dpb or .npz; None when absent."""
        dpb = os.path.join(self.root, name + ".dpb")
        if os.path.exists(dpb):
            return _read_dpb(dpb)
        npz = os.path.join(self.root, name + ".npz")
        if os.path.exists(npz):
            with np.load(npz) as z:
                return tuple(z[k] for k in ("u", "s", "vT"))
        return None

    def save(self, name: str, u, s, vT) -> str:
        """Write the basis as float32 .npz (atomically: temp file + rename)."""
        f32 = lambda a: np.asarray(a, dtype=np.float32)
        p = os.path.join(self.root, name + ".npz")
        dpb = os.path.join(self.root, name + ".dpb")
        if os.path.exists(dpb):  # it would shadow the new file in load()
            os.unlink(dpb)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, u=f32(u), s=f32(s), vT=f32(vT))
            os.replace(tmp, p)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return p
