"""Flash attention kernels K1–K5: the CUDA kernels, their plain versions, the
bindings and the autograd rules that compose with torch.func.

Counterparts of the Pallas kernels in
diffusion_pullback_tpu/ops/pallas/flash_attention.py:

    K1  flash_forward      `_flash_forward`      softmax(QKᵀ·scale)·V
    K2  flash_forward_lse  `_flash_forward_lse`  the same plus L = m + log l
    K3  flash_tangent      `_flash_tangent`      the forward-mode tangent Ȯ
    K4  flash_dq           `_flash_backward`     dQ   (its dq pallas_call)
    K5  flash_dkv          `_flash_backward`     dK, dV (its dkv pallas_call)

Three designs, all on the tensor cores, chosen by the C library's one rule
(``design`` says which served a call):

* 'wgmma': K1–K5 in bf16 at head dims 40, 64, 80, 128 and 160 (the SD
  2.1, SDXL and ADM-256 U-Nets' self-attentions and their pullbacks at 64,
  SD 1.5's 8 heads per block, ImageNet128Cond's 4 heads of 128; rows as
  64-column panels), TMA loads and wgmma products
  (csrc/flash_fwd_tc.cu, flash_jvp_tc.cu, flash_bwd_tc.cu);
* 'tf32x3': K1–K5 in f32, each f32 product as three TF32 mma.sync
  products: K1 and K2 at 512 (the VAE's single head; K2 where ring
  attention shards it) with warps that split D (csrc/flash_fwd_tf32.cu);
  at 40, 64, 80, 128 and 160 (the U-Nets run in f32, ``--dtype fp32``)
  K1 and K2 (csrc/flash_fwd_tf32_rows.cu), K3 (csrc/flash_jvp_tf32_rows.cu)
  and K4 and K5 (csrc/flash_bwd_tf32_rows.cu), with warps that own query
  rows (K5: key rows);
* 'mma_bf16': K1 and K2 in bf16 at 512 (a VAE built in bf16; K2 where
  ring attention shards its head), one bf16 mma.sync product per product,
  with warps that split D (csrc/flash_fwd_mma_bf16.cu).

The sources are csrc/*.cu; they are compiled with nvcc for sm_90a at first
use into one shared library under ``.build/`` next to this package (keyed on
the sources' hash) and loaded with ctypes. Each wrapper takes (B·H, S, D)
tensors, checks them and calls its kernel's custom op (dpx::flash_fwd,
dpx::flash_fwd_lse, dpx::flash_tangent, dpx::flash_dq, dpx::flash_dkv): on
a CPU tensor the op runs the kernel's plain version (the same arithmetic
and the same bf16 rounding in torch), on a CUDA tensor it launches the
kernel or raises. ``<wrapper>.launches`` counts kernel launches and
``<wrapper>.host_ns`` the host's nanoseconds in the wrapper (its checks,
the op's dispatch and the launch; on every device), and each recorded span
(utils/profiling.py) holds their growth summed over the five wrappers as
``flash_launches`` and ``flash_host_ns``. The ops'
fake implementations let torch.export (and make_fx) trace through them,
their flop formulas let torch.utils.flop_counter count them, and the
profiler records each call under the op's name.

Two autograd Functions carry the kernels through torch.func, as the JAX
package's custom_vjp / custom_jvp pair does:

* ``_Flash`` (custom_vjp ``_flash``): K1 when no gradient is recorded, K2
  when one is; backward is K4 + K5; jvp raises.
* ``_FlashFwdMode`` (custom_jvp ``_flash_fwdmode``): K2; jvp is K3;
  backward raises.

Under ``vmap`` the kernels are reached through Functions with vmap rules
that fold the vmapped axis into B·H (K3 through ``_Tangent``, K4 and K5
through ``_FlashBackward``). Over the pullback's probes only the
tangents (K3) or the cotangent (K4, K5) are batched: the kernels then read
primal slice ``b % B·H`` for batched slice ``b``, so the probes share one
copy of Q, K, V, O and L.

The port's tangent passes use ``jvp``: each pass runs the primal forward
(K2) again, where JAX linearises once.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import subprocess
import tempfile
import threading
import time

import torch

from ..utils import profiling

NEG_INF = -1e30
PAIR_HEAD_DIMS = (40, 64, 80, 128, 160)  # head dims K3–K5 are built for
# head dims K1 and K2 are built for (512: the VAE's single head, which K2
# meets as ring attention's shards)
HEAD_DIMS = PAIR_HEAD_DIMS + (512,)

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(sorted(glob.glob(os.path.join(_HERE, "csrc", "*.cu"))))
HEADERS = tuple(sorted(glob.glob(os.path.join(_HERE, "csrc", "*.cuh"))))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), ".build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # $CUDA_HOME, PATH, default

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the flash kernels build from source "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return nvcc


def build() -> tuple[str, str]:
    """Compile csrc/*.cu into one shared library (if these sources are not
    built yet): one nvcc per source, all started together, then one link.
    Returns (path of the library, nvcc's output of this build or '')."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in SOURCES + HEADERS:
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"flash-{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        log = ""
        try:
            for proc, src in zip(procs, SOURCES):
                out, _ = proc.communicate(timeout=600)
                log += out
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                       f"({proc.returncode}):\n{out}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        so = os.path.join(tmp, "flash.so")
        proc = subprocess.run([nvcc, "-shared", "-o", so, *objs],
                              capture_output=True, text=True, timeout=600)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(so, lib_path)
    return lib_path, log


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            sig = {  # pointers, then ints, then scale and stream
                "flash_fwd": (4, 5),
                "flash_fwd_lse": (5, 5),
                "flash_tangent": (9, 6),
                "flash_dq": (7, 6),
                "flash_dkv": (8, 6),
            }
            for name, (n_ptr, n_int) in sig.items():
                fn = getattr(lib, name)
                fn.argtypes = [vp] * n_ptr + [ci] * n_int + [cf, vp]
                fn.restype = ci
            lib.flash_design.argtypes = [ci, ci, ci]
            lib.flash_design.restype = ci
            lib.flash_served.argtypes = [ci, ci]
            lib.flash_served.restype = ctypes.c_longlong
            _lib = lib
        return _lib


# ---- plain versions (the kernels' arithmetic in torch) -----------------------

def _share(r: int, *primals: torch.Tensor):
    """The primal operands tiled r times along B·H: batched slice b reads
    primal slice b % B·H, as the kernels index them."""
    return tuple(t.repeat(r, *(1,) * (t.ndim - 1)) if r > 1 else t
                 for t in primals)


def _online_softmax(q, k, v, scale, block_k):
    """(acc / l in f32, m, l) by online softmax over K blocks, probabilities
    rounded to V's dtype before P·V."""
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
    return acc / l, m, l


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, block_k: int = 512) -> torch.Tensor:
    """K1's arithmetic in torch: online softmax over K blocks, f32 state,
    probabilities rounded to V's dtype before P·V, output in q's dtype.
    q (BH, Sq, D), k/v (BH, Sk, D) → (BH, Sq, D)."""
    return _online_softmax(q, k, v, scale, block_k)[0].to(q.dtype)


def flash_forward_lse_plain(q, k, v, scale: float, block_k: int = 512):
    """K2's arithmetic: K1's output and the row logsumexp L = m + log l,
    (BH, Sq) f32."""
    out, m, l = _online_softmax(q, k, v, scale, block_k)
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _key_blocks(q, k, lse, scale, block_k):
    """(key slice, K block in f32, P = exp(S − L)) per block of keys."""
    qf = q.float()
    for start in range(0, k.shape[1], block_k):
        blk = slice(start, start + block_k)
        kb = k[:, blk].float()
        s = torch.bmm(qf, kb.transpose(1, 2)) * scale
        yield blk, kb, torch.exp(s - lse[..., None])


def flash_tangent_plain(q, k, v, dq, dk, dv, o, lse, scale: float,
                        block_k: int = 512) -> torch.Tensor:
    """K3's arithmetic: Ṡ = (Q̇Kᵀ + QK̇ᵀ)·scale, P = exp(S − L),
    Ȯ = Σ(P∘Ṡ)V + P·V̇ − rowsum(P∘Ṡ)∘O, with P∘Ṡ and P rounded to the
    input dtype before their products and Ȯ in O's dtype. The tangents may
    have r times the primal's B·H (probes folded in)."""
    q, k, v, o, lse = _share(dq.shape[0] // q.shape[0], q, k, v, o, lse)
    dqf = dq.float()
    acc = torch.zeros(dq.shape, dtype=torch.float32, device=q.device)
    rsum = torch.zeros((*dq.shape[:2], 1), dtype=torch.float32, device=q.device)
    for blk, kb, p in _key_blocks(q, k, lse, scale, block_k):
        ds = (torch.bmm(dqf, kb.transpose(1, 2))
              + torch.bmm(q.float(), dk[:, blk].float().transpose(1, 2))) * scale
        pds = p * ds
        acc = acc + torch.bmm(pds.to(v.dtype).float(), v[:, blk].float()) \
            + torch.bmm(p.to(dv.dtype).float(), dv[:, blk].float())
        rsum = rsum + pds.sum(dim=-1, keepdim=True)
    return (acc - rsum * o.float()).to(o.dtype)


def _dscores(p, do, vb, delta):
    """dS = P ∘ (dO·Vᵀ − δ) in f32."""
    dp = torch.bmm(do.float(), vb.float().transpose(1, 2))
    return p * (dp - delta[..., None])


def flash_dq_plain(q, k, v, do, lse, delta, scale: float,
                   block_k: int = 512) -> torch.Tensor:
    """K4's arithmetic: dQ = scale·Σ_k [P∘(dO·Vᵀ − δ)]·K, dS rounded to K's
    dtype before the product; dQ in q's dtype. The cotangent (do, delta)
    may have r times the primal's B·H."""
    q, k, v, lse = _share(do.shape[0] // q.shape[0], q, k, v, lse)
    acc = torch.zeros(do.shape, dtype=torch.float32, device=q.device)
    for blk, kb, p in _key_blocks(q, k, lse, scale, block_k):
        ds = _dscores(p, do, v[:, blk], delta)
        acc = acc + torch.bmm(ds.to(k.dtype).float(), kb)
    return (acc * scale).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, scale: float, block_k: int = 512):
    """K5's arithmetic: dV = Σ_q Pᵀ·dO and dK = scale·Σ_q [P∘(dO·Vᵀ − δ)]ᵀ·Q,
    P rounded to dO's and dS to Q's dtype before the products; dK, dV in
    k's and v's dtype."""
    q, k, v, lse = _share(do.shape[0] // q.shape[0], q, k, v, lse)
    dk = torch.empty(do.shape[0], *k.shape[1:], dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk, dtype=v.dtype)
    for blk, _, p in _key_blocks(q, k, lse, scale, block_k):
        ds = _dscores(p, do, v[:, blk], delta)
        dv[:, blk] = torch.bmm(p.to(do.dtype).float().transpose(1, 2),
                               do.float()).to(v.dtype)
        dk[:, blk] = (torch.bmm(ds.to(q.dtype).float().transpose(1, 2),
                                q.float()) * scale).to(k.dtype)
    return dk, dv


# ---- wrappers: the kernel on CUDA, the plain version on the CPU --------------

def _check(name, t, shape, dtype, device):
    if torch._C._functorch.is_functorch_wrapped_tensor(t):
        raise TypeError(f"{name}: a functorch-wrapped tensor reached a flash "
                        f"kernel; call it through its autograd Function")
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: {t.device}/{t.dtype}, expected "
                         f"{device}/{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def _operands(q, head_dims, /, **named):
    """Check the operands of one call against their expected shapes and
    dtypes (``named``: name → (tensor, shape, dtype or None for q's)) and
    return them contiguous. On CUDA also the kernel's head dims and dtypes;
    the plain versions take any."""
    if _device(q):
        if q.shape[-1] not in head_dims:
            raise ValueError(f"flash kernel takes head dims {head_dims}, "
                             f"got {q.shape[-1]}")
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                            f"{q.dtype}")
    out = []
    for name, (t, shape, dtype) in named.items():
        _check(name, t, shape, dtype or q.dtype, q.device)
        out.append(t.contiguous())
    return out


def _device(q) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"the flash kernels run on cuda or cpu, not {q.device}")


def _launch(name, q, *args):
    """Call kernel ``name`` of the library on q's device and current stream;
    ``args`` are tensors (passed by pointer, 16-byte aligned) and ints/floats
    in the C function's order. Raises on a launch the runtime refused."""
    lib = _load()
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.data_ptr() % 16:
                raise ValueError(f"{name}: operands must be 16-byte aligned")
            cargs.append(a.data_ptr())
        else:
            cargs.append(a)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _is_bf16(q) -> int:
    return int(q.dtype == torch.bfloat16)


KERNELS = ("K1", "K2", "K3", "K4", "K5")
DESIGNS = ("mma_bf16", "wgmma", "tf32x3")  # by the C rule's number


def design(kernel: str, d: int, dtype: torch.dtype) -> str:
    """The design kernel ``kernel`` ('K1'…'K5') runs on the card at head
    dim d and dtype, as the C entries dispatch: 'wgmma', 'tf32x3' or
    'mma_bf16'. Raises where no kernel takes the call."""
    n = _load().flash_design(KERNELS.index(kernel) + 1, d, int(dtype == torch.bfloat16))
    if n < 0:
        raise ValueError(f"no kernel takes {kernel} at head dim {d} in {dtype}")
    return DESIGNS[n]


def served(kernel: str, design_: str) -> int:
    """Launches of kernel ``kernel`` ('K1'…'K5') on design ``design_`` since
    the library was loaded, as the C entries count them in the branch that
    launched the kernel."""
    return _load().flash_served(KERNELS.index(kernel) + 1, DESIGNS.index(design_))


# ---- the kernels as custom ops -----------------------------------------------
#
# Each kernel is the custom op dpx::<symbol>: its CUDA implementation
# launches the kernel (and counts the launch on its wrapper), its CPU one is
# the plain version, its fake one gives the output's shape for tracing
# (torch.export) and its flop formula the operations flash_ops counts. So the
# profiler names the op, FlopCounterMode counts the same work whichever
# device runs it, and an exported program calls the op. Any other device
# has no implementation and raises.

# operations per (B·H)·Sq·Sk·D of each kernel, B·H the tangents' or the
# cotangent's, with the primal's QKᵀ (2 of them) recomputed for every probe
PAIR_OPS = {"K1": 4, "K2": 4, "K3": 10, "K4": 6, "K5": 8}


def flash_ops(label: str, bhp: int, bh: int, sq: int, sk: int, d: int) -> float:
    """The operations kernel ``label`` must do with the primal at B·H =
    bhp and its tangents or cotangent at bh = r·bhp (r probes): PAIR_OPS
    less the primal's QKᵀ, which the probes share and which is counted once
    per primal head, (PAIR_OPS − 2)·bh·Sq·Sk·D + 2·bhp·Sq·Sk·D. K1 and K2
    (bh = bhp): the two products' 4·bhp·Sq·Sk·D."""
    return float((PAIR_OPS[label] - 2) * bh + 2 * bhp) * sq * sk * d


_LIB = torch.library.Library("dpx", "DEF")


def _op(symbol, label, schema, plain, fake, batched_arg=0):
    """Define the op dpx::<symbol> with ``schema`` and register its CUDA
    implementation (the decorated function), its CPU implementation
    ``plain``, its fake ``fake`` and the flop formula of kernel ``label``;
    argument ``batched_arg`` carries the tangents' or cotangent's B·H. The
    ops register directly with the dispatcher (torch.library.Library), not
    through torch.library.custom_op, whose Python layer (an autograd
    wrapper and argument checks on every call) adds to the host time that
    already sets the 1024-token kernels' time (PERF.md)."""
    from torch.utils.flop_counter import register_flop_formula

    def register(launch):
        _LIB.define(symbol + schema)
        _LIB.impl(symbol, launch, "CUDA")
        _LIB.impl(symbol, plain, "CPU")
        torch.library.register_fake(f"dpx::{symbol}", fake, lib=_LIB)

        @register_flop_formula(getattr(torch.ops.dpx, symbol))
        def _flops(q, k, *args, out_shape=None, **kwargs):
            bh = (q, k, *args)[batched_arg][0]
            return int(flash_ops(label, q[0], bh, q[1], k[1], q[2]))

        return launch
    return register


_QKV = "(Tensor q, Tensor k, Tensor v, float scale)"
_BWD = "(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, Tensor delta, float scale)"


@_op("flash_fwd", "K1", _QKV + " -> Tensor",
     lambda q, k, v, scale: flash_forward_plain(q, k, v, scale),
     lambda q, k, v, scale: torch.empty_like(q))
def _k1(q, k, v, scale):
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    _launch("flash_fwd", q, q, k, v, out, bh, sq, k.shape[1], d, _is_bf16(q), scale)
    flash_forward.launches += 1
    return out


def _k2_fake(q, k, v, scale):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


@_op("flash_fwd_lse", "K2", _QKV + " -> (Tensor, Tensor)",
     lambda q, k, v, scale: flash_forward_lse_plain(q, k, v, scale), _k2_fake)
def _k2(q, k, v, scale):
    out, lse = _k2_fake(q, k, v, scale)
    bh, sq, d = q.shape
    _launch("flash_fwd_lse", q, q, k, v, out, lse, bh, sq, k.shape[1], d,
            _is_bf16(q), scale)
    flash_forward_lse.launches += 1
    return out, lse


@_op("flash_tangent", "K3",
     "(Tensor q, Tensor k, Tensor v, Tensor dq, Tensor dk, Tensor dv, Tensor o, "
     "Tensor lse, float scale) -> Tensor",
     lambda q, k, v, dq, dk, dv, o, lse, scale: flash_tangent_plain(
         q, k, v, dq, dk, dv, o, lse, scale),
     lambda q, k, v, dq, dk, dv, o, lse, scale: torch.empty_like(dq),
     batched_arg=3)
def _k3(q, k, v, dq, dk, dv, o, lse, scale):
    out = torch.empty_like(dq)
    bhp, sq, d = q.shape
    _launch("flash_tangent", q, q, k, v, dq, dk, dv, o, lse, out, dq.shape[0], bhp,
            sq, k.shape[1], d, _is_bf16(q), scale)
    flash_tangent.launches += 1
    return out


def _bwd_dims(q, k, do):
    bhp, sq, d = q.shape
    return do.shape[0], bhp, sq, k.shape[1], d


@_op("flash_dq", "K4", _BWD + " -> Tensor",
     lambda q, k, v, do, lse, delta, scale: flash_dq_plain(
         q, k, v, do, lse, delta, scale),
     lambda q, k, v, do, lse, delta, scale: torch.empty_like(do),
     batched_arg=3)
def _k4(q, k, v, do, lse, delta, scale):
    dq = torch.empty_like(do)
    _launch("flash_dq", q, q, k, v, do, lse, delta, dq, *_bwd_dims(q, k, do),
            _is_bf16(q), scale)
    flash_dq.launches += 1
    return dq


def _k5_fake(q, k, v, do, lse, delta, scale):
    dk = k.new_empty((do.shape[0], *k.shape[1:]))
    return dk, torch.empty_like(dk, dtype=v.dtype)


@_op("flash_dkv", "K5", _BWD + " -> (Tensor, Tensor)",
     lambda q, k, v, do, lse, delta, scale: flash_dkv_plain(
         q, k, v, do, lse, delta, scale), _k5_fake, batched_arg=3)
def _k5(q, k, v, do, lse, delta, scale):
    dk, dv = _k5_fake(q, k, v, do, lse, delta, scale)
    _launch("flash_dkv", q, q, k, v, do, lse, delta, dk, dv, *_bwd_dims(q, k, do),
            _is_bf16(q), scale)
    flash_dkv.launches += 1
    return dk, dv


# ---- wrappers: the checks, then the op (the kernel on CUDA, the plain
# version on the CPU) ----------------------------------------------------------

def _counted(wrapper):
    """``wrapper`` with its counters ``launches`` (counted where its op
    launches the kernel) and ``host_ns`` (entry to return, on any device)."""
    @functools.wraps(wrapper)
    def counted(*args, **kwargs):
        t0 = time.perf_counter_ns()
        out = wrapper(*args, **kwargs)
        counted.host_ns += time.perf_counter_ns() - t0
        return out

    counted.launches = counted.host_ns = 0
    return counted


@_counted
def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """K1 on (B·H, S, D) tensors → (B·H, Sq, D) in q's dtype."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    q, k, v = _operands(q, HEAD_DIMS, q=(q, (bh, sq, d), None),
                        k=(k, (bh, sk, d), None), v=(v, (bh, sk, d), None))
    return torch.ops.dpx.flash_fwd(q, k, v, float(scale))


@_counted
def flash_forward_lse(q, k, v, scale: float):
    """K2 on (B·H, S, D) tensors → (o in q's dtype, L (B·H, Sq) f32)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    q, k, v = _operands(q, HEAD_DIMS, q=(q, (bh, sq, d), None),
                        k=(k, (bh, sk, d), None), v=(v, (bh, sk, d), None))
    return torch.ops.dpx.flash_fwd_lse(q, k, v, float(scale))


def _batched_bh(t, bh_primal, what):
    if t.shape[0] % bh_primal:
        raise ValueError(f"{what} B·H {t.shape[0]} is not a multiple of the "
                         f"primal's {bh_primal}")
    return t.shape[0]


@_counted
def flash_tangent(q, k, v, dq, dk, dv, o, lse, scale: float) -> torch.Tensor:
    """K3: the tangent Ȯ (in o's dtype) of attention at (q, k, v) with
    output o and logsumexp lse, along (dq, dk, dv). The tangents may carry
    r·B·H slices against the primal's B·H (probes folded in)."""
    bhp, sq, d = q.shape
    sk = k.shape[1]
    bh = _batched_bh(dq, bhp, "the tangents'")
    ops = _operands(
        q, PAIR_HEAD_DIMS, q=(q, (bhp, sq, d), None), k=(k, (bhp, sk, d), None),
        v=(v, (bhp, sk, d), None), dq=(dq, (bh, sq, d), None),
        dk=(dk, (bh, sk, d), None), dv=(dv, (bh, sk, d), None),
        o=(o, (bhp, sq, d), None), lse=(lse, (bhp, sq), torch.float32))
    return torch.ops.dpx.flash_tangent(*ops, float(scale))


def _bwd_operands(q, k, v, do, lse, delta):
    bhp, sq, d = q.shape
    sk = k.shape[1]
    bh = _batched_bh(do, bhp, "the cotangent's")
    return _operands(
        q, PAIR_HEAD_DIMS, q=(q, (bhp, sq, d), None), k=(k, (bhp, sk, d), None),
        v=(v, (bhp, sk, d), None), do=(do, (bh, sq, d), None),
        lse=(lse, (bhp, sq), torch.float32),
        delta=(delta, (bh, sq), torch.float32))


@_counted
def flash_dq(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """K4: dQ (in q's dtype) from the cotangent do and δ = rowsum(do∘o); do
    and delta may carry r·B·H slices against the primal's B·H."""
    return torch.ops.dpx.flash_dq(*_bwd_operands(q, k, v, do, lse, delta),
                                  float(scale))


@_counted
def flash_dkv(q, k, v, do, lse, delta, scale: float):
    """K5: (dK, dV) in k's and v's dtype; batching as flash_dq."""
    return torch.ops.dpx.flash_dkv(*_bwd_operands(q, k, v, do, lse, delta),
                                   float(scale))


_WRAPPERS = (flash_forward, flash_forward_lse, flash_tangent, flash_dq, flash_dkv)
profiling.counter("flash_launches", lambda: sum(w.launches for w in _WRAPPERS))
profiling.counter("flash_host_ns", lambda: sum(w.host_ns for w in _WRAPPERS))


# ---- autograd Functions and their vmap rules ---------------------------------

def _fold(t, dim, r, tile=1):
    """``t`` at one vmap level → (r·tile·B·H, …): the vmapped dim (None:
    unbatched, expanded) moved to the front, B·H tiled ``tile`` times, and
    both folded into B·H, vmapped index major."""
    t = t.expand(r, *t.shape) if dim is None else t.movedim(dim, 0)
    if tile > 1:
        t = t.repeat(1, tile, *(1,) * (t.ndim - 2))
    return t.reshape(-1, *t.shape[2:])


def _unfold(t, r):
    return t.reshape(r, -1, *t.shape[1:])


def _fold_shared(info, primals, primal_dims, batched, batched_dims):
    """Fold one vmap level of a kernel whose ``batched`` operands (tangents
    or cotangent) may hold more slices than its primals. Unbatched primals
    stay as they are (the kernel shares them); batched ones are tiled to the
    batched operands' B·H first, so slice b still pairs with slice b."""
    r = info.batch_size
    if all(d is None for d in primal_dims):
        folded_primals = primals
    else:
        per = lambda t, d: t.shape[0] if d is None else t.movedim(d, 0).shape[1]
        tile = per(batched[0], batched_dims[0]) // per(primals[0], primal_dims[0])
        folded_primals = tuple(_fold(t, d, r, tile)
                               for t, d in zip(primals, primal_dims))
    return folded_primals, tuple(_fold(t, d, r)
                                 for t, d in zip(batched, batched_dims))


class _Tangent(torch.autograd.Function):
    """K3 as a vmappable node (the tangent rule of _FlashFwdMode calls it
    with tangents batched over the probes)."""

    @staticmethod
    def forward(q, k, v, dq, dk, dv, o, lse, scale):
        return flash_tangent(q, k, v, dq, dk, dv, o, lse, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, q, k, v, dq, dk, dv, o, lse, scale):
        (q, k, v, o, lse), (dq, dk, dv) = _fold_shared(
            info, (q, k, v, o, lse), in_dims[:3] + in_dims[6:8], (dq, dk, dv),
            in_dims[3:6])
        out = _Tangent.apply(q, k, v, dq, dk, dv, o, lse, scale)
        return _unfold(out, info.batch_size), 0


class _FlashBackward(torch.autograd.Function):
    """K4 and K5 as one vmappable node (the backward of _Flash calls it with
    the cotangent batched over the probes). Returns (dq, dk, dv)."""

    @staticmethod
    def forward(q, k, v, do, lse, delta, scale):
        return (flash_dq(q, k, v, do, lse, delta, scale),
                *flash_dkv(q, k, v, do, lse, delta, scale))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, q, k, v, do, lse, delta, scale):
        (q, k, v, lse), (do, delta) = _fold_shared(
            info, (q, k, v, lse), in_dims[:3] + in_dims[4:5], (do, delta),
            (in_dims[3], in_dims[5]))
        grads = _FlashBackward.apply(q, k, v, do, lse, delta, scale)
        return tuple(_unfold(g, info.batch_size) for g in grads), (0, 0, 0)


def _fold_all(info, in_dims, *ts):
    return tuple(_fold(t, d, info.batch_size) for t, d in zip(ts, in_dims))


class _Flash(torch.autograd.Function):
    """The custom_vjp ``_flash``: forward K1 (``with_lse`` False: no
    gradient is recorded) or K2 (saving q, k, v, o, L); backward δ in
    torch, then K4 and K5; no forward-mode rule. Returns (o, L or None)."""

    @staticmethod
    def forward(q, k, v, scale, with_lse):
        if with_lse:
            return flash_forward_lse(q, k, v, scale)
        return flash_forward(q, k, v, scale), None

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale, with_lse = inputs
        o, lse = output
        ctx.scale = scale
        if with_lse:
            ctx.mark_non_differentiable(lse)
            ctx.save_for_backward(q, k, v, o, lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(dim=-1)
        return (*_FlashBackward.apply(q, k, v, do, lse, delta, ctx.scale),
                None, None)

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(
            "flash attention 'flash' (the custom_vjp kernel pair K2/K4/K5) has "
            "no forward-mode rule, as in the JAX package; use 'flash_jvp' "
            "(flash_attention_jvp) on a path that is jvp'd")

    @staticmethod
    def vmap(info, in_dims, q, k, v, scale, with_lse):
        o, lse = _Flash.apply(*_fold_all(info, in_dims, q, k, v), scale,
                              with_lse)
        r = info.batch_size
        if lse is None:
            return (_unfold(o, r), None), (0, None)
        return (_unfold(o, r), _unfold(lse, r)), (0, 0)


class _FlashFwdMode(torch.autograd.Function):
    """The custom_jvp ``_flash_fwdmode``: forward K2, keeping L for the
    tangent rule, which runs K3 (a ``None`` tangent counts as zeros, as
    JAX's SymbolicZero); no reverse-mode rule. Returns (o, L)."""

    @staticmethod
    def forward(q, k, v, scale):
        return flash_forward_lse(q, k, v, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale = inputs
        o, lse = output
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        ctx.save_for_forward(q, k, v, o, lse)

    @staticmethod
    def jvp(ctx, dq, dk, dv, _dscale):
        q, k, v, o, lse = ctx.saved_tensors
        inst = lambda t, p: torch.zeros_like(p) if t is None else t.to(p.dtype)
        do = _Tangent.apply(q, k, v, inst(dq, q), inst(dk, k), inst(dv, v), o,
                            lse, ctx.scale)
        return do, None

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash attention 'flash_jvp' (the custom_jvp kernels K2/K3) is not "
            "reverse-mode differentiable, as in the JAX package; pair it with "
            "'flash' through local_pullback's fn_vjp")

    @staticmethod
    def vmap(info, in_dims, q, k, v, scale):
        o, lse = _FlashFwdMode.apply(*_fold_all(info, in_dims, q, k, v), scale)
        r = info.batch_size
        return (_unfold(o, r), _unfold(lse, r)), (0, 0)


# ---- public entries, layout (B, S, H, D) like ops.attention ------------------

def _check_blocks(name, sq, sk):
    bq, bk = min(512, sq), min(512, sk)
    if sq % bq or sk % bk:
        raise ValueError(
            f"{name} requires sequence lengths divisible by the block size "
            f"(sq={sq}, sk={sk}, blocks=({bq},{bk})); use impl='xla' for "
            f"irregular lengths")


def _bh_call(fn, q, k, v, scale, *extra):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    sk = k.shape[1]
    to_bh = lambda x, s: x.transpose(1, 2).reshape(b * h, s, d)
    out, _ = fn(to_bh(q, sq), to_bh(k, sk), to_bh(v, sk), float(scale), *extra)
    return out.reshape(b, h, sq, d).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Reverse-mode-differentiable fused attention (the custom_vjp entry):
    K1 when no gradient is recorded, K2 + K4/K5 when one is."""
    _check_blocks("flash_attention", q.shape[1], k.shape[1])
    with_lse = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _bh_call(_Flash.apply, q, k, v, scale, with_lse)


def flash_attention_jvp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None) -> torch.Tensor:
    """Forward-mode-differentiable fused attention (the custom_jvp entry):
    K2, with K3 as its tangent rule. Not reverse-mode differentiable: pair
    it with ``flash_attention`` through local_pullback's ``fn_vjp``."""
    _check_blocks("flash_attention_jvp", q.shape[1], k.shape[1])
    return _bh_call(_FlashFwdMode.apply, q, k, v, scale)
