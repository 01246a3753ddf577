"""The bf16 tangent and backward kernels (csrc/flash_jvp_tc.cu, K3, and
csrc/flash_bwd_tc.cu, K4 and K5) as built, and with ``--parent DIR`` an
earlier tree's csrc/, each built into a library of its own and timed
against the other on one card, in turns, at the head dims the kernels
serve:

    python -m diffusion_pullback_tpu_torch.ops.bwd_tc_variants [--parent DIR]

Besides those, each variant of VARIANTS is built from the sources as they
stand with its edits applied (as fwd_tc_variants builds its own). K3's
ring waits for and frees the two halves of a stage (K, K̇ and V, V̇) apart
where it has one stage (D = 160) and whole where it has two; the variants
take one rule at every D:

* ``K3 whole stages``: whole stages at every D;
* ``K3 split stages``: split stages at every D.

Prints each build's registers and spill bytes per K3/K4/K5 wgmma instance
(nvcc's ``-Xptxas -v``), then per shape each build's ms per launch of K3,
K4 and K5 (CUDA events over 20 launches, the ctypes call straight into the
library; K3 with one tangent slice per primal slice), twice, the builds
timed in turns (in order, then in reverse), and their largest differences
from the plain versions (which the kernels' gate holds to two bf16 ulps of
max |plain|), then the flash SDPA backward's ms and the card. Needs nvcc
and a card; builds under ``.build/variants/bwd``.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import re
import sys

import torch

from diffusion_pullback_tpu_torch.ops import flash_attention as fa
from diffusion_pullback_tpu_torch.ops.fwd_tc_variants import CSRC, OUT, build, cuda_ms

# the pullback's (B·H, S, D) at SD 1.5's and ImageNet128Cond's head dims
# (rank 2), 8 heads of 160 at 1024 tokens, and 4096 tokens at 128 and 160
SHAPES = [(16, 4096, 40), (16, 1024, 80), (8, 1024, 128), (16, 1024, 160),
          (16, 4096, 128), (16, 4096, 160), (250, 4096, 64)]
# variant → [(file, text in it, replacement)], applied in order
VARIANTS = {
    "K3 whole stages": [("flash_jvp_tc.cu", "constexpr bool SPLIT = STAGES<DIM> == 1;",
                         "constexpr bool SPLIT = false;")],
    "K3 split stages": [("flash_jvp_tc.cu", "constexpr bool SPLIT = STAGES<DIM> == 1;",
                         "constexpr bool SPLIT = true;"),
                        ("flash_jvp_tc.cu", "+ 64 + 1024;", "+ 128 + 1024;")],
}


def registers(log):
    """{(kernel, D): (registers, spill store bytes, spill load bytes)} of
    the K3/K4/K5 wgmma instances in nvcc's -Xptxas -v output (D = 64 for a
    kernel not templated on the head dim, as before D = 40–160)."""
    label = {"tangent": "K3", "dq": "K4", "dkv": "K5"}
    out, entry, spills = {}, None, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            k = re.search(r"flash_(tangent|dq|dkv)_wgmma_kernel(?:ILi(\d+)E)?", m.group(1))
            entry = (label[k.group(1)], int(k.group(2) or 64)) if k else None
        elif entry and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                       line)):
            spills = int(m.group(1)), int(m.group(2))
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            out[entry] = (int(m.group(1)), *(spills or (0, 0)))
            entry = spills = None
    return out


def main():
    if not torch.cuda.is_available():
        print("bwd_tc_variants: needs a CUDA card", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="csrc/ of an earlier tree, timed as 'parent'")
    args = parser.parse_args()
    units = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CSRC, "*.cu")))
    builds = [("parent", args.parent, [])] if args.parent else []
    builds += [("as built", CSRC, [])] + [(name, CSRC, e) for name, e in VARIANTS.items()]
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, src, edits in builds:
        lib, log = build(name, edits, units, os.path.join(os.path.dirname(OUT), "bwd"), src)
        lib.flash_dq.argtypes = [vp] * 7 + [ci] * 6 + [ctypes.c_float, vp]
        lib.flash_dkv.argtypes = [vp] * 8 + [ci] * 6 + [ctypes.c_float, vp]
        lib.flash_tangent.argtypes = [vp] * 9 + [ci] * 6 + [ctypes.c_float, vp]
        lib.flash_dq.restype = lib.flash_dkv.restype = lib.flash_tangent.restype = ci
        libs[name] = lib
        print(f"{name}: " + "; ".join(
            f"{k} D={d} {r} registers, spills {st}/{ld} bytes"
            for (k, d), (r, st, ld) in sorted(registers(log).items())), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.ops.aten._scaled_dot_product_flash_attention
    sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    for bh, s, d in SHAPES:
        q, k, v, do, tq, tk, tv = (
            torch.randn(bh, s, d, device="cuda", generator=gen).to(torch.bfloat16)
            for _ in range(7))
        scale = d ** -0.5
        o, lse = fa.flash_forward_lse_plain(q, k, v, scale)
        delta = (do.float() * o.float()).sum(-1)
        ref_tan = fa.flash_tangent_plain(q, k, v, tq, tk, tv, o, lse, scale).float()
        ref_dq = fa.flash_dq_plain(q, k, v, do, lse, delta, scale).float()
        ref_dk, ref_dv = (t.float() for t in fa.flash_dkv_plain(q, k, v, do, lse, delta, scale))
        tan, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
        tan_ptrs = [t.data_ptr() for t in (q, k, v, tq, tk, tv, o, lse, tan)]
        times, errs = {name: ([], [], []) for name in libs}, {}
        for name in list(libs) + list(libs)[::-1]:
            lib = libs[name]

            def k3():
                if err := lib.flash_tangent(*tan_ptrs, bh, bh, s, s, d, 1, scale, stream):
                    raise RuntimeError(f"{name}: K3 cudaError {err}")

            def k4():
                if err := lib.flash_dq(*ptrs, dq.data_ptr(), bh, bh, s, s, d, 1, scale, stream):
                    raise RuntimeError(f"{name}: K4 cudaError {err}")

            def k5():
                if err := lib.flash_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), bh, bh, s, s, d,
                                        1, scale, stream):
                    raise RuntimeError(f"{name}: K5 cudaError {err}")
            k3()
            k4()
            k5()
            torch.cuda.synchronize()
            errs[name] = max((a.float() - b).abs().max().item() for a, b in (
                (tan, ref_tan), (dq, ref_dq), (dk, ref_dk), (dv, ref_dv)))
            for i, kernel in enumerate((k3, k4, k5)):
                times[name][i].append(cuda_ms(kernel))
        ms = lambda ts: "/".join(f"{t:.4f}" for t in ts)
        cells = [f"{name} K3 {ms(t3)} ms, K4 {ms(t4)} ms, K5 {ms(t5)} ms "
                 f"(err {errs[name]:.3g})" for name, (t3, t4, t5) in times.items()]
        fwd = sdpa(q[None], k[None], v[None], 0.0, False, False, scale=scale)
        args = (do[None], q[None], k[None], v[None], *fwd[:6], 0.0, False, *fwd[6:8])
        library = cuda_ms(lambda: sdpa_bwd(*args, scale=scale))
        print(f"({bh},{s},{d}): " + "; ".join(cells) + f"; sdpa bwd {library:.4f} ms",
              flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
