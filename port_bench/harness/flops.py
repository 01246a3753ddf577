"""The yardstick: the card's published peaks, the operations and bytes of
each call of the flash kernels K1–K5 from its shapes, and the model FLOPs
of a unit of work counted on the plain reference.

Peaks (NVIDIA's data sheet, H100 SXM, dense): 989.4 TFLOP/s bf16, 494.7
TFLOP/s TF32, 3.35 TB/s HBM3. A float32 flash kernel computes each product
as three TF32 products (3xTF32), so its ceiling is a third of the TF32 rate.

Kernel operations (the fused attention pair; B·H of the tangents or of the
cotangent bh = r·bhp for r probes of a primal of bhp heads, whose QKᵀ the
probes share): K1, K2 4·bh·Sq·Sk·D; K3 8·bh·Sq·Sk·D + 2·bhp·Sq·Sk·D; K4
4·bh·… + 2·bhp·…; K5 6·bh·… + 2·bhp·…. Bytes: every input read once and
every output written once.
"""

from __future__ import annotations

import math

import torch

PEAKS = {  # device name → (bf16 FLOP/s, TF32 FLOP/s, HBM bytes/s)
    "NVIDIA H100 80GB HBM3": (989.4e12, 494.7e12, 3.35e12),
}

# op → (kernel, the argument holding the tangents' / cotangent's B·H)
FLASH_OPS = {"dpx::flash_fwd": ("K1", 0), "dpx::flash_fwd_lse": ("K2", 0),
             "dpx::flash_tangent": ("K3", 3), "dpx::flash_dq": ("K4", 3),
             "dpx::flash_dkv": ("K5", 3)}
BATCHED_ARG = dict(FLASH_OPS.values())
PRODUCTS = {"K1": 4, "K2": 4, "K3": 10, "K4": 6, "K5": 8}
# arguments kept in float32 whatever the dtype: the log-sum-exp and δ
F32_ARGS = {"K3": (7,), "K4": (4, 5), "K5": (4, 5)}


def peaks(device_name: str):
    return PEAKS.get(device_name)


def kernel_ops(kernel: str, shapes) -> float:
    """Operations of one call from its argument shapes."""
    (bhp, sq, d), sk = shapes[0], shapes[1][1]
    bh = shapes[BATCHED_ARG[kernel]][0]
    return float((PRODUCTS[kernel] - 2) * bh + 2 * bhp) * sq * sk * d


def kernel_bytes(kernel: str, shapes, elem: int) -> float:
    """Bytes in (every tensor argument) and out, ``elem`` bytes an element
    of q's dtype."""
    f32 = F32_ARGS.get(kernel, ())
    tensors = [s for s in shapes if s]
    nin = sum(math.prod(s) * (4 if i in f32 else elem) for i, s in enumerate(tensors))
    (bhp, sq, d), sk = shapes[0], shapes[1][1]
    bh = shapes[BATCHED_ARG[kernel]][0]
    nout = {"K1": bhp * sq * d * elem, "K2": bhp * sq * (d * elem + 4),
            "K3": bh * sq * d * elem, "K4": bh * sq * d * elem,
            "K5": 2 * bh * sk * d * elem}[kernel]
    return float(nin + nout)


def kernel_bound_s(kernel: str, shapes, dtype: str, device_name: str):
    """The least time the card could take for one call, or None for an
    unknown card."""
    pk = peaks(device_name)
    if pk is None:
        return None
    flops = pk[0] if dtype == "bfloat16" else pk[1] / 3.0
    elem = 2 if dtype == "bfloat16" else 4
    return max(kernel_ops(kernel, shapes) / flops,
               kernel_bytes(kernel, shapes, elem) / pk[2])


def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def pullback_flops(cfg: dict, rank: int, iterations: int) -> float:
    """Model FLOPs of one basis of the mid-tap pullback at ``rank``,
    counted by FlopCounterMode on the plain reference over the meta
    device: the vjp's primal once, and per pass its constant and per-probe
    terms from counts at one and two probes (a vmapped pass dispatches
    some products once whatever the number of probes): ``iterations``
    cotangent passes and ``iterations`` + 1 tangent passes."""
    from torch.func import jvp, vjp, vmap

    from ..reference.arith import Exact
    from ..reference.unet import layout, mid_tap_map
    from .system import context_shape, latent_shape

    u = cfg["unet"]
    with torch.device("meta"):
        P = {n: torch.empty(s) for n, s in layout(u).items()}
        z = torch.empty(latent_shape(cfg))
        f = mid_tap_map(P, u, Exact(), torch.tensor(500.0), torch.empty(context_shape(cfg)))
        h = f(z)
        primal = _count(lambda: f(z))

        def tangent(r):
            return _count(lambda: vmap(lambda v: jvp(f, (z,), (v,))[1])(
                torch.empty(r, *z.shape)))

        def cotangent(r):
            _, pull = vjp(f, z)
            return _count(lambda: vmap(lambda g: pull(g)[0])(torch.empty(r, *h.shape)))

        t1, t2, c1, c2 = tangent(1), tangent(2), cotangent(1), cotangent(2)
    tan = (t1 - (t2 - t1)) + rank * (t2 - t1)
    cot = (c1 - (c2 - c1)) + rank * (c2 - c1)
    return float(primal + (iterations + 1) * tan + iterations * cot)
