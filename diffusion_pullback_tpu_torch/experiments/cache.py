"""Artifact cache for pullback bases (u, s, vT).

Counterpart of diffusion_pullback_tpu/experiments/cache.py with the same
basis names and the same .npz layout (u (dim_h, k), s (k,), vT (k, dim_x),
float32, h and x flattened in NHWC order). It reads what the JAX cache
reads: the native .dpb files (32-byte header of eight little-endian u32 —
magic, version, u rows, u cols, k, vT rows, vT cols, 0 — then u, s, vT as
raw float32), then the .npz, skipping a file it cannot read, and widens the
raw bfloat16 bytes of legacy .npz files to float32. So each package reads
the other's bases, under the folder names both CLIs build for the same
flags. It writes .dpb through the native library (utils/native.py) when
that loads, else .npz. Under a torch.distributed run rank 0 reads the
cache's state and writes it: ``load`` finds a file when rank 0 does, and
``save`` returns once rank 0's file is in place on every rank.
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


def load_basis(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(u, s, vT) of one basis file, .dpb or .npz by its extension."""
    if path.endswith(".dpb"):
        return _read_dpb(path)
    with np.load(path) as z:
        return tuple(_from_npz(z[k]) for k in ("u", "s", "vT"))


def _from_npz(a: np.ndarray) -> np.ndarray:
    """float32 of an .npz array; raw bfloat16 bytes (a 2-byte void dtype)
    widen exactly: bf16 is the upper half of an f32's bits."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return (a.view("<u2").astype(np.uint32) << 16).view(np.float32)
    return a


class BasisCache:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def load(self, name: str) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(u, s, vT) of a cached basis from the first readable of .dpb and
        .npz (as rank 0 finds them); None when neither is."""
        from ..parallel.mesh import agreed

        for ext in (".dpb", ".npz"):
            p = os.path.join(self.root, name + ext)
            if agreed(os.path.exists(p)):
                try:
                    return load_basis(p)
                except Exception:  # unreadable here: try the other format
                    continue
        return None

    def path(self, name: str) -> str:
        """The basis file for ``name``: the first of .dpb and .npz that
        exists (the one load() reads once it has read ``name``), else the
        one save() writes (.dpb with the native library, else .npz).
        Checks existence only, reads nothing."""
        from ..utils.native import get_lib

        for ext in (".dpb", ".npz"):
            p = os.path.join(self.root, name + ext)
            if os.path.exists(p):
                return p
        return os.path.join(self.root, name + (".dpb" if get_lib() else ".npz"))

    def save(self, name: str, u, s, vT) -> str:
        """Write the basis as float32: .dpb through the native library
        (temp file, fsync, rename), else .npz (temp file, rename). Under a
        torch.distributed run rank 0 writes, and every rank returns after
        it has."""
        from ..parallel.mesh import barrier, is_writer

        if not is_writer():
            barrier()
            return self.path(name)
        p = self._write(name, u, s, vT)
        barrier()
        return p

    def _write(self, name: str, u, s, vT) -> str:
        from ..utils.native import basis_write

        u, s, vT = (np.asarray(a, dtype=np.float32) for a in (u, s, vT))
        dpb = os.path.join(self.root, name + ".dpb")
        if basis_write(dpb, u, s, vT):
            return dpb
        p = os.path.join(self.root, name + ".npz")
        if os.path.exists(dpb):  # it would shadow the new file in load()
            os.unlink(dpb)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, u=u, s=s, vT=vT)
            os.replace(tmp, p)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return p
