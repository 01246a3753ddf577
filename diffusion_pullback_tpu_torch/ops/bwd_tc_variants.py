"""The bf16 backward kernels (csrc/flash_bwd_tc.cu, K4 and K5) as built,
and with ``--parent DIR`` an earlier tree's csrc/, each built into a
library of its own and timed against the other on one card, in turns, at
the head dims the kernels serve:

    python -m diffusion_pullback_tpu_torch.ops.bwd_tc_variants [--parent DIR]

Prints each build's registers and spill bytes per K4/K5 instance (nvcc's
``-Xptxas -v``), then per shape each build's ms per launch of K4 and of K5
(CUDA events over 20 launches, the ctypes call straight into the library),
twice, the builds timed in turns (in order, then in reverse), and their
largest differences from the plain versions (which the kernels' gate holds
to two bf16 ulps of max |plain|), then the flash SDPA backward's ms and the
card. Needs nvcc and a card; builds under ``.build/variants/bwd``.
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


def registers(log):
    """{(kernel, D): (registers, spill store bytes, spill load bytes)} of
    the K4/K5 wgmma instances in nvcc's -Xptxas -v output (D = 64 for a
    kernel not templated on the head dim, as before D = 40–160)."""
    out, entry, spills = {}, None, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            k = re.search(r"flash_(dq|dkv)_wgmma_kernel(?:ILi(\d+)E)?", m.group(1))
            entry = ("K4" if k.group(1) == "dq" else "K5", int(k.group(2) or 64)) if k else None
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
    sources = {"parent": args.parent, "as built": CSRC} if args.parent else {"as built": CSRC}
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, src in sources.items():
        lib, log = build(name, [], units, os.path.join(os.path.dirname(OUT), "bwd"), src)
        lib.flash_dq.argtypes = [vp] * 7 + [ci] * 6 + [ctypes.c_float, vp]
        lib.flash_dkv.argtypes = [vp] * 8 + [ci] * 6 + [ctypes.c_float, vp]
        lib.flash_dq.restype = lib.flash_dkv.restype = ci
        libs[name] = lib
        print(f"{name}: " + "; ".join(
            f"{k} D={d} {r} registers, spills {st}/{ld} bytes"
            for (k, d), (r, st, ld) in sorted(registers(log).items())), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.ops.aten._scaled_dot_product_flash_attention
    sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    for bh, s, d in SHAPES:
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen).to(torch.bfloat16)
                       for _ in range(4))
        scale = d ** -0.5
        o, lse = fa.flash_forward_lse_plain(q, k, v, scale)
        delta = (do.float() * o.float()).sum(-1)
        ref_dq = fa.flash_dq_plain(q, k, v, do, lse, delta, scale).float()
        ref_dk, ref_dv = (t.float() for t in fa.flash_dkv_plain(q, k, v, do, lse, delta, scale))
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
        times, errs = {name: ([], []) for name in libs}, {}
        for name in list(libs) + list(libs)[::-1]:
            lib = libs[name]

            def k4():
                if err := lib.flash_dq(*ptrs, dq.data_ptr(), bh, bh, s, s, d, 1, scale, stream):
                    raise RuntimeError(f"{name}: K4 cudaError {err}")

            def k5():
                if err := lib.flash_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), bh, bh, s, s, d,
                                        1, scale, stream):
                    raise RuntimeError(f"{name}: K5 cudaError {err}")
            k4()
            k5()
            torch.cuda.synchronize()
            errs[name] = max((a.float() - b).abs().max().item()
                             for a, b in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)))
            times[name][0].append(cuda_ms(k4))
            times[name][1].append(cuda_ms(k5))
        cells = [f"{name} K4 {'/'.join(f'{t:.4f}' for t in t4)} ms, K5 "
                 f"{'/'.join(f'{t:.4f}' for t in t5)} ms (err {errs[name]:.3g})"
                 for name, (t4, t5) in times.items()]
        fwd = sdpa(q[None], k[None], v[None], 0.0, False, False, scale=scale)
        args = (do[None], q[None], k[None], v[None], *fwd[:6], 0.0, False, *fwd[6:8])
        library = cuda_ms(lambda: sdpa_bwd(*args, scale=scale))
        print(f"({bh},{s},{d}): " + "; ".join(cells) + f"; sdpa bwd {library:.4f} ms",
              flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
