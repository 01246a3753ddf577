"""FLOP and MFU accounting (counterpart of diffusion_pullback_tpu/utils/flops.py,
with its functions and field names).

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over one
eager call: it counts the products (matmuls, convolutions, attention) that
PyTorch dispatches, each by its formula, and the flash kernels K1–K5 by the
formula their custom ops register (ops/flash_attention.py ``flash_ops``,
the operations chip_smoke.py's bounds count), so the CPU's plain versions
and the card's kernels count the same work. XLA's cost analysis, which the
JAX package reads, also counts elementwise work; the two packages' totals
for a whole network therefore differ by design and agree on functions made
of products only.

FlopCounterMode counts what PyTorch dispatches, which under vmap of a jvp
is not always the arithmetic's own count (a vmapped jvp of one conv2d at 3
probes dispatches 5 convolutions). So, as in the JAX package, a pass's
cost is measured at two probe counts and split into a primal and a
per-probe term by an affine fit. The per-tangent and per-cotangent terms
are exact. The primal term holds whatever the pass runs once whatever the
number of probes: the primal forward inside the jvp or the vjp and any
extra work the batching rules dispatch once.

All model callables take ``(params, x)``, the JAX package's convention
(``params`` may be None for a callable closed over its module).

MFU is reported against the card's dense bf16 peak, the tensor cores'
native rate; float32 sections read low by construction.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch.func import jvp, vjp, vmap
from torch.utils.flop_counter import FlopCounterMode

# dense bf16 tensor-core peak per card, by torch.cuda.get_device_name
# prefix (NVIDIA's data sheets: H100 SXM 989.4 TFLOP/s, H100 PCIe 756.5)
_PEAK_BF16_TFLOPS = (
    ("NVIDIA H100 80GB HBM3", 989.4),
    ("NVIDIA H100 PCIe", 756.5),
)

ModelFn = Callable[[Any, torch.Tensor], torch.Tensor]  # (params, x) -> h


def peak_bf16_tflops(device=None) -> Optional[float]:
    """Dense bf16 peak TFLOP/s of CUDA ``device`` (default: the current
    one), or None without a card and for unknown cards."""
    if not torch.cuda.is_available():
        return None
    if device is not None and torch.device(device).type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for prefix, tflops in _PEAK_BF16_TFLOPS:
        if name.startswith(prefix):
            return tflops
    return None


def compiled_flops(fn: Callable, *args, **kwargs) -> Optional[float]:
    """The FLOPs FlopCounterMode counts over one eager call ``fn(*args,
    **kwargs)`` (the port compiles no program; the name is the JAX
    package's), or None when it counts none."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None


def _fit(prog: Callable[[int], Optional[float]], r1: int, r2: int
         ) -> Optional[Tuple[float, float]]:
    """(primal, per-probe) FLOPs from the counts at r1 and r2 probes."""
    f1, f2 = prog(r1), prog(r2)
    if f1 is None or f2 is None or r2 == r1:
        return None
    per = (f2 - f1) / (r2 - r1)
    return max(f1 - r1 * per, 0.0), max(per, 0.0)


def linearized_pass_flops(fn: ModelFn, params: Any, x: torch.Tensor,
                          r1: int = 1, r2: int = 2
                          ) -> Optional[Tuple[float, float]]:
    """(primal_flops, per_tangent_flops) of a tangent pass of the pullback
    loop: the vmap over r probes of ``jvp(fn(params, ·), x)``, counted at
    r1 and r2 probes. The port's pullback runs such a pass per iteration,
    its primal with it (geometry/pullback.py)."""
    def prog(rank):
        probes = torch.zeros((rank,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        return compiled_flops(vmap(
            lambda t: jvp(lambda q: fn(params, q), (x,), (t,))[1]), probes)

    return _fit(prog, r1, r2)


def transpose_pass_flops(fn: ModelFn, params: Any, x: torch.Tensor,
                         fn_vjp: Optional[ModelFn] = None, r1: int = 1, r2: int = 2
                         ) -> Optional[Tuple[float, float]]:
    """(primal_flops, per_cotangent_flops) of the cotangent half: one vjp
    of ``fn_vjp`` (or ``fn``) at x, its function vmapped over r
    cotangents, counted at r1 and r2."""
    g = fn_vjp or fn

    def prog(rank):
        def run():
            h, vjp_fn = vjp(lambda q: g(params, q), x)
            cot = torch.zeros((rank,) + tuple(h.shape), dtype=h.dtype, device=h.device)
            return vmap(lambda u: vjp_fn(u)[0])(cot)
        return compiled_flops(run)

    return _fit(prog, r1, r2)


def pullback_fits(fn: ModelFn, params: Any, x: torch.Tensor,
                  fn_vjp: Optional[ModelFn] = None
                  ) -> Optional[Tuple[Tuple[float, float], Tuple[float, float]]]:
    """The (fwd, bwd) affine fits of the pullback loop body, independent
    of rank and iterations, so a caller can keep them and recompute totals
    with `pullback_flops_from_fits`."""
    fwd = linearized_pass_flops(fn, params, x)
    bwd = transpose_pass_flops(fn, params, x, fn_vjp=fn_vjp)
    if fwd is None or bwd is None:
        return None
    return fwd, bwd


def pullback_flops_from_fits(fits: Tuple[Tuple[float, float], Tuple[float, float]],
                             pca_rank: int, iters: int, uses_fn_vjp: bool) -> float:
    """Total pullback FLOPs from `pullback_fits`, the JAX package's count:
    one primal (plus the vjp's primal with a separate fn_vjp), iters·rank
    tangent and cotangent passes and the final rank tangent passes for u;
    the r×r SVD is left out. It counts what the algorithm needs: the port
    also runs the primal again in every tangent pass (and in the vjp
    without fn_vjp), which is recomputation and not counted."""
    (p_fwd, f_tan), (p_bwd, f_cot) = fits
    primal = p_fwd + (p_bwd if uses_fn_vjp else 0.0)
    return primal + iters * pca_rank * (f_tan + f_cot) + pca_rank * f_tan


def pullback_flops(fn: ModelFn, params: Any, x: torch.Tensor, pca_rank: int,
                   iters: int, fn_vjp: Optional[ModelFn] = None) -> Optional[float]:
    """Total FLOPs of one `geometry.local_pullback` run at a fixed
    iteration count (`pullback_flops_from_fits`)."""
    fits = pullback_fits(fn, params, x, fn_vjp=fn_vjp)
    if fits is None:
        return None
    return pullback_flops_from_fits(fits, pca_rank, iters,
                                    uses_fn_vjp=fn_vjp is not None)


def mfu_fields(flops: Optional[float], seconds: float) -> dict:
    """Achieved TFLOP/s and the model FLOPs utilisation against the card's
    bf16 peak; empty when the FLOPs are unknown, no mfu field without a
    known card."""
    if not flops or not seconds or seconds <= 0:
        return {}
    tflops_per_sec = flops / seconds / 1e12
    out = {
        "tflops": round(flops / 1e12, 3),
        "tflops_per_sec": round(tflops_per_sec, 2),
    }
    peak = peak_bf16_tflops()
    if peak:
        out["mfu_vs_bf16_peak"] = round(tflops_per_sec / peak, 4)
    return out
