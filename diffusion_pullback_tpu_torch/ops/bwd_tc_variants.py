"""The tangent and backward kernels on the tensor cores, as built and with
``--parent DIR`` an earlier tree's csrc/, each built into a library of its
own and timed against the other on one card, in turns, at the shapes the
paths give them:

    python -m diffusion_pullback_tpu_torch.ops.bwd_tc_variants [--dtype bf16|f32] [--parent DIR]
        [--only PREFIX]

bf16 ('wgmma'): K3 (csrc/flash_jvp_tc.cu), K4 and K5 (csrc/flash_bwd_tc.cu).
f32 ('tf32x3'): K3 (csrc/flash_jvp_tf32_rows.cu), K4 and K5
(csrc/flash_bwd_tf32_rows.cu). With ``--parent`` the earlier tree's
kernels of the same calls are timed in turns with these (before this
tree's K3 in f32 that was the CUDA-core 'simt' K3 of its flash_jvp.cu).

Besides those, each variant of VARIANTS[dtype] is built from the sources
as they stand with its edits applied (as fwd_tc_variants builds its own);
``--only PREFIX`` builds only the variants whose name starts with PREFIX
and, where PREFIX names a kernel (K3, K4 or K5), times only that kernel.
bf16: K3's ring waits for and frees the two halves of a stage (K, K̇ and V,
V̇) apart where it has one stage (D = 160) and whole where it has two; the
variants take one rule at every D:

* ``K3 whole stages``: whole stages at every D;
* ``K3 split stages``: split stages at every D.

f32: one block shape at every grid instead of the rules (K3 and K4: 128
query rows, as 4 warps of two m16 tiles each, at D ≤ 80 where there are 3
such blocks an SM, else 64; K5: 64 key rows where they give every SM one,
else 32, each query tile split over two warps), the number of n8 output
tiles whose sums a pass of the products into Ȯ (K3), dQ (K4), dK and dV
(K5) holds apart (as built: K3 all of them; K4 all of them with one
m-tile a warp, one with two; K5 all of them at D = 40, else 4), and K3's
key tile (as built 32 keys at D = 40 and 128, 16 at 64, 80 and 160):

* ``K3 128-row blocks`` (64 at D > 80) / ``K3 64-row blocks``;
* ``K3 1 n8 tile a pass`` / ``K3 4 n8 tiles a pass``;
* ``K3 16-key tiles`` / ``K3 32-key tiles`` (16 at D = 160, where 32 do
  not fit): one key tile at every D;
* ``K4 128-row blocks`` (64 at D > 80) / ``K4 64-row blocks``;
* ``K5 64-row blocks`` / ``K5 32-row blocks``;
* ``K4 1 n8 tile a pass`` / ``K4 every n8 tile a pass``;
* ``K5 1 n8 tile a pass`` / ``K5 every n8 tile a pass``.

Prints each build's registers and spill bytes per kernel instance (nvcc's
``-Xptxas -v``: the wgmma K3/K4/K5 in bf16, the tf32x3 K3/K4/K5 in f32), then
per shape each build's ms per launch of each kernel (CUDA events over 20
launches, the ctypes call straight into the library; the cotangent or the
tangents with ``r`` probe slices per primal slice), twice, the builds timed
in turns (in order, then in reverse), TFLOP/s on the operations the
function needs (flash_ops), and their largest differences from the plain
versions (bf16: the gate is two bf16 ulps of max |plain|; f32: Ȯ, dQ, dK
and dV against TF32X3_TOL of max(1, max |plain|)), then the library's backward
(the flash SDPA backward in bf16, the memory-efficient one in f32; K4 + K5
in one op) and the card's name and power limit. Needs nvcc and a card;
builds under ``.build/variants/bwd/<dtype>``, all in parallel (a variant
that does not build is reported and skipped).
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from diffusion_pullback_tpu_torch.ops import flash_attention as fa
from diffusion_pullback_tpu_torch.ops.fwd_tc_variants import CSRC, OUT, build, cuda_ms

TF32X3_TOL = 2.5e-5  # K3, K4 and K5 on tf32x3, of max(1, max |plain|) (chip_smoke.py)
ROWS = "flash_bwd_tf32_rows.cu"
TAN = "flash_jvp_tf32_rows.cu"
RULE_TAN = "const bool rows128 = (long long)((sq + 127) / 128) * bh >= 3 * tf32::sm_count();"
GROUP_TAN = "constexpr int kGroup = D / 8;"
KEYS_TAN = "constexpr int kKeys = D == 40 || D == 128 ? 32 : 16;"
RULE_DQ = "const bool rows128 = blocks(128, sq, bh) >= 3 * tf32::sm_count();"
RULE_DKV = "const int rows = blocks(64, sk, bh) >= tf32::sm_count() ? 64 : 32;"
GROUP_DQ = "constexpr int kDqGroup = MT == 1 ? D / 8 : 1;"
GROUP_DKV = "constexpr int kDkvGroup = D < 64 ? D / 8 : 4;"
# (B·H primal, S, D, probes) by dtype. bf16: the pullback's at SD 1.5's and
# ImageNet128Cond's head dims (rank 2 folded into B·H), 8 heads of 160 at
# 1024 tokens, 4096 tokens at 128 and 160, and the rank-50 harvest at 64.
# f32: the f32 paths' pullbacks at rank 2 (SD 2.1-base: 5 heads over 4096
# tokens, 10 over 1024; SD 1.5: 8 heads of 40 over 4096, of 80 over 1024),
# ImageNet128Cond's 4 heads of 128 and 8 of 160 at 1024 tokens at rank 2,
# and the rank-50 harvest's 5 heads over 4096 tokens
SHAPES = {
    "bf16": [(16, 4096, 40, 1), (16, 1024, 80, 1), (8, 1024, 128, 1), (16, 1024, 160, 1),
             (16, 4096, 128, 1), (16, 4096, 160, 1), (250, 4096, 64, 1)],
    "f32": [(5, 4096, 64, 2), (10, 1024, 64, 2), (8, 4096, 40, 2), (8, 1024, 80, 2),
            (4, 1024, 128, 2), (8, 1024, 160, 2), (5, 4096, 64, 50)],
}
# dtype → variant → [(file, text in it, replacement)], applied in order
VARIANTS = {
    "bf16": {
        "K3 whole stages": [("flash_jvp_tc.cu", "constexpr bool SPLIT = STAGES<DIM> == 1;",
                             "constexpr bool SPLIT = false;")],
        "K3 split stages": [("flash_jvp_tc.cu", "constexpr bool SPLIT = STAGES<DIM> == 1;",
                             "constexpr bool SPLIT = true;"),
                            ("flash_jvp_tc.cu", "+ 64 + 1024;", "+ 128 + 1024;")],
    },
    "f32": {
        "K3 128-row blocks": [(TAN, RULE_TAN, "const bool rows128 = true;")],
        "K3 64-row blocks": [(TAN, RULE_TAN, "const bool rows128 = false;")],
        "K3 1 n8 tile a pass": [(TAN, GROUP_TAN, "constexpr int kGroup = 1;")],
        "K3 4 n8 tiles a pass": [(TAN, GROUP_TAN, "constexpr int kGroup = 4;")],
        "K3 16-key tiles": [(TAN, KEYS_TAN, "constexpr int kKeys = 16;")],
        "K3 32-key tiles": [(TAN, KEYS_TAN, "constexpr int kKeys = D > 128 ? 16 : 32;")],
        "K4 128-row blocks": [(ROWS, RULE_DQ, "const bool rows128 = true;")],
        "K4 64-row blocks": [(ROWS, RULE_DQ, "const bool rows128 = false;")],
        "K5 64-row blocks": [(ROWS, RULE_DKV, "const int rows = 64;")],
        "K5 32-row blocks": [(ROWS, RULE_DKV, "const int rows = 32;")],
        "K4 1 n8 tile a pass": [(ROWS, GROUP_DQ, "constexpr int kDqGroup = 1;")],
        "K4 every n8 tile a pass": [(ROWS, GROUP_DQ, "constexpr int kDqGroup = D / 8;")],
        "K5 1 n8 tile a pass": [(ROWS, GROUP_DKV, "constexpr int kDkvGroup = 1;")],
        "K5 every n8 tile a pass": [(ROWS, GROUP_DKV, "constexpr int kDkvGroup = D / 8;")],
    },
}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
KERNELS = {"bf16": ("K3", "K4", "K5"), "f32": ("K3", "K4", "K5")}


def registers(log):
    """{(kernel, design, D, rows of a block): (registers, spill store bytes,
    spill load bytes)} of the wgmma K3/K4/K5 instances (rows 64; D = 64 for
    a kernel not templated on the head dim, as before D = 40–160) and the
    tf32x3 K3/K4/K5 instances (K3 and K4 templated on (D, m-tiles a warp)
    of 4 warps, K5 on (D, row groups, m-tiles a warp)) in nvcc's -Xptxas -v
    output."""
    label = {"tangent": "K3", "dq": "K4", "dkv": "K5"}
    out, entry, spills = {}, None, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
            if k := re.search(r"flash_(tangent|dq|dkv)_wgmma_kernel(?:ILi(\d+)E)?", name):
                entry = (label[k.group(1)], "wgmma", int(k.group(2) or 64), 64)
            elif k := re.search(r"flash_(tangent|dq)_tf32_rows_kernelILi(\d+)ELi(\d+)E", name):
                entry = (label[k.group(1)], "tf32x3", int(k.group(2)), 64 * int(k.group(3)))
            elif k := re.search(r"flash_dkv_tf32_rows_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name):
                entry = ("K5", "tf32x3", int(k.group(1)), 16 * int(k.group(2)) * int(k.group(3)))
            else:
                entry = None
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
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    parser.add_argument("--parent", help="csrc/ of an earlier tree, timed as 'parent'")
    parser.add_argument("--only", default="",
                        help="time only the variants whose name starts with this, and the "
                             "kernel it names (K3, K4 or K5) if it names one")
    args = parser.parse_args()
    dtype, labels = DTYPES[args.dtype], KERNELS[args.dtype]
    if args.only[:2] in labels:
        labels = (args.only[:2],)
    flag = int(dtype == torch.bfloat16)
    builds = [("parent", args.parent, [])] if args.parent else []
    builds += [("as built", CSRC, [])] + [
        (name, CSRC, e) for name, e in VARIANTS[args.dtype].items()
        if name.startswith(args.only)]

    def make(name, src, edits):
        units = sorted(os.path.basename(p) for p in glob.glob(os.path.join(src, "*.cu")))
        try:
            return build(name, edits, units, os.path.join(os.path.dirname(OUT), "bwd",
                                                          args.dtype), src)
        except RuntimeError as e:  # reported, and the others timed all the same
            print(str(e).splitlines()[0] + " " + " ".join(
                line for line in str(e).splitlines() if "error" in line)[:300], flush=True)
            return None

    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(lambda b: make(*b), builds))
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for (name, _, _), (lib, log) in ((b, r) for b, r in zip(builds, built) if r):
        lib.flash_dq.argtypes = [vp] * 7 + [ci] * 6 + [ctypes.c_float, vp]
        lib.flash_dkv.argtypes = [vp] * 8 + [ci] * 6 + [ctypes.c_float, vp]
        lib.flash_tangent.argtypes = [vp] * 9 + [ci] * 6 + [ctypes.c_float, vp]
        lib.flash_dq.restype = lib.flash_dkv.restype = lib.flash_tangent.restype = ci
        libs[name] = lib
        design = "wgmma" if flag else "tf32x3"
        print(f"{name}: " + "; ".join(
            f"{k} D={d} {rows} rows {r} registers, spills {st}/{ld} bytes"
            for (k, dsg, d, rows), (r, st, ld) in sorted(registers(log).items())
            if dsg == design), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for bhp, s, d, r in SHAPES[args.dtype]:
        bh = r * bhp
        rnd = lambda n: torch.randn(n, s, d, device="cuda", generator=gen).to(dtype)
        q, k, v = rnd(bhp), rnd(bhp), rnd(bhp)
        do, tq, tk, tv = rnd(bh), rnd(bh), rnd(bh), rnd(bh)
        scale = d ** -0.5
        o, lse = fa.flash_forward_lse_plain(q, k, v, scale)
        delta = (do.float() * o.float().repeat(r, 1, 1)).sum(-1)
        plain = {"K3": lambda: (fa.flash_tangent_plain(q, k, v, tq, tk, tv, o, lse, scale),),
                 "K4": lambda: (fa.flash_dq_plain(q, k, v, do, lse, delta, scale),),
                 "K5": lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta, scale)}
        ref = {label: plain[label]() for label in labels}
        tan, dq, dk, dv = (torch.empty_like(do) for _ in range(4))
        out = {"K3": (tan,), "K4": (dq,), "K5": (dk, dv)}
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
        tan_ptrs = [t.data_ptr() for t in (q, k, v, tq, tk, tv, o, lse, tan)]
        times, errs = {name: {label: [] for label in labels} for name in libs}, {}
        for name in list(libs) + list(libs)[::-1]:
            lib = libs[name]
            calls = {
                "K3": lambda: lib.flash_tangent(*tan_ptrs, bh, bhp, s, s, d, flag, scale,
                                                stream),
                "K4": lambda: lib.flash_dq(*ptrs, dq.data_ptr(), bh, bhp, s, s, d, flag,
                                           scale, stream),
                "K5": lambda: lib.flash_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), bh, bhp, s,
                                            s, d, flag, scale, stream),
            }

            def launch(label):
                if err := calls[label]():
                    raise RuntimeError(f"{name}: {label} cudaError {err}")
            for label in labels:
                launch(label)
            torch.cuda.synchronize()
            errs[name] = max(
                (a.float() - b.float()).abs().max().item()
                / (TF32X3_TOL * max(1.0, b.float().abs().max().item()) if flag == 0 else 1.0)
                for label in labels for a, b in zip(out[label], ref[label]))
            for label in labels:
                times[name][label].append(cuda_ms(lambda: launch(label)))
        ms = lambda ts: "/".join(f"{t:.4f}" for t in ts)
        tflops = lambda label, ts: fa.flash_ops(label, bhp, bh, s, s, d) / min(ts) / 1e9
        err_name = "err" if flag else "err / gate"
        cells = [f"{name} " + ", ".join(
            f"{label} {ms(ts)} ms ({tflops(label, ts):.1f} TFLOP/s)"
            for label, ts in by_label.items()) + f" ({err_name} {errs[name]:.3g})"
            for name, by_label in times.items()]
        q4, k4, v4 = (t.repeat(r, 1, 1)[None] for t in (q, k, v))
        if flag:
            sdpa = torch.ops.aten._scaled_dot_product_flash_attention
            sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
            fwd = sdpa(q4, k4, v4, 0.0, False, False, scale=scale)
            bwd_args = (do[None], q4, k4, v4, *fwd[:6], 0.0, False, *fwd[6:8])
            library = cuda_ms(lambda: sdpa_bwd(*bwd_args, scale=scale))
        else:
            eff = torch.ops.aten._scaled_dot_product_efficient_attention
            eff_bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
            out4, lse4, seed, offset = eff(q4, k4, v4, None, True, 0.0, False, scale=scale)
            bwd_args = (do[None], q4, k4, v4, None, out4, lse4, seed, offset, 0.0,
                        [True, True, True, False], False)
            library = cuda_ms(lambda: eff_bwd(*bwd_args, scale=scale))
        print(f"({bh},{s},{d}) r={r}: " + "; ".join(cells)
              + f"; sdpa {args.dtype} bwd {library:.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
