"""Flash attention forward (K1): the CUDA kernel, its plain version, the binding.

Counterpart of the Pallas `_flash_forward` / `_flash_kernel` in
diffusion_pullback_tpu/ops/pallas/flash_attention.py. The kernel source is
csrc/flash_fwd.cu; it is compiled with nvcc for sm_90a at first use into
``.build/`` next to this module (keyed on the source's hash) and loaded
with ctypes.

``flash_forward`` takes (B·H, S, D) tensors. A CPU tensor goes to
``flash_forward_plain`` (a blockwise online softmax in torch, the
counterpart of the kernel's arithmetic); a CUDA tensor launches the kernel
or raises. The CUDA path is primal-only: asking it for a tangent or a
gradient raises, as the JAX package never puts its `flash` primal under
linearize (ops/attention.py there). The fused JVP/VJP kernels are ROADMAP
slice 2.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 512)  # head dims the kernel is built for

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "flash_fwd.cu")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), ".build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PRIMAL_ONLY = (
    "the CUDA flash forward kernel (K1) is primal-only; the fused JVP/VJP "
    "kernels that differentiate it are ROADMAP slice 2 — use attn_impl='xla' "
    "on a differentiated path")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # $CUDA_HOME, PATH, default

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the flash kernel builds from source "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return nvcc


def build() -> tuple[str, str]:
    """Compile csrc/flash_fwd.cu (if this source hash is not built yet).
    Returns (path of the shared library, nvcc's output of this build or '')."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"flash_fwd-{digest}.so")
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path, proc.stdout + proc.stderr


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.flash_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                      ctypes.c_float, vp]
            lib.flash_fwd.restype = ci
            _lib = lib
        return _lib


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, block_k: int = 512) -> torch.Tensor:
    """The kernel's arithmetic in torch: online softmax over K blocks, f32
    state, probabilities rounded to V's dtype before P·V, output in q's
    dtype. q (BH, Sq, D), k/v (BH, Sk, D) → (BH, Sq, D)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    qf = q.float()
    m = torch.full((bh, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    for start in range(0, sk, block_k):
        kb = k[:, start:start + block_k].float()
        vb = v[:, start:start + block_k]
        s = torch.bmm(qf, kb.transpose(1, 2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.bmm(p.to(vb.dtype).float(), vb.float())
        m = m_new
    return (acc / l).to(q.dtype)


def _launch(q, k, v, scale):
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {HEAD_DIMS}, got {d}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t, s in (("q", q, sq), ("k", k, sk), ("v", v, sk)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {t.device}/{t.dtype} vs q's "
                             f"{q.device}/{q.dtype}")
        if tuple(t.shape) != (bh, s, d) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({bh}, {s}, {d}) "
                             f"tensor, got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _load()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), bh, sq, sk, d,
                            int(q.dtype == torch.bfloat16), float(scale),
                            stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    flash_forward.launches += 1
    return out


class _FlashForwardCUDA(torch.autograd.Function):
    """The kernel as a primal-only autograd node: every derivative raises."""

    @staticmethod
    def forward(q, k, v, scale):
        return _launch(q, k, v, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(_PRIMAL_ONLY)

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(_PRIMAL_ONLY)

    @staticmethod
    def vmap(info, in_dims, *args):
        raise NotImplementedError(_PRIMAL_ONLY)


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """K1 on (B·H, S, D) tensors: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``flash_forward.launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on cuda or cpu, not {q.device}")
    return _FlashForwardCUDA.apply(q, k, v, scale)


flash_forward.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Public entry, layout (B, S, H, D) like ops.attention."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    sk = k.shape[1]
    to_bh = lambda x, s: x.transpose(1, 2).reshape(b * h, s, d).contiguous()
    out = flash_forward(to_bh(q, sq), to_bh(k, sk), to_bh(v, sk), float(scale))
    return out.reshape(b, h, sq, d).transpose(1, 2)
