"""Design variants of the forward kernels on the tensor cores (K1 and K2:
csrc/flash_fwd_tc.cu in bf16 and csrc/flash_fwd_tf32_rows.cu in f32 at
head dims 40–160; K1 and K2 in bf16 at 512: csrc/flash_fwd_mma_bf16.cu),
each built into a library of its own and timed against the others on one
card, in turns, at the shapes the paths give them:

    python -m diffusion_pullback_tpu_torch.ops.fwd_tc_variants [--dtype bf16|f32] [--parent DIR]
        [--only PREFIX]

Variants, each one edit of the sources as they stand (``as built``: the
sources unchanged). bf16 ('wgmma'):

* ``box past row``: the last panel loaded with a box of 64 columns that
  reaches past the row's end (TMA zero-fills it) instead of one of the
  D % 64 columns the row has (the panels are csrc/hopper.cuh's);
* ``P·V at N=64``: the last panel's P·V product over all 64 columns of its
  panel instead of its D % 64;
* ``3 stages``: three K/V stages in place of two;
* ``D=512 1 stage``: K1 at D = 512 ('mma_bf16') with one K/V stage in
  place of two; ``D=512 4 slots``: the partial sums of S in four slots,
  two warps a slot, in place of one a warp;
* ``D=512 64-key tiles``: the same over key tiles of 64 in place of 32
  (one stage and four slots: no more fits).

f32 ('tf32x3'):

* ``128-row blocks`` / ``64-row blocks`` / ``32-row blocks``: one block
  shape at every grid instead of the rule (128 rows, as 4 warps of two m16
  tiles each, at D ≤ 80 where there are 3 such blocks for every 2 SMs; 64
  rows where they give every SM one; else 32, each tile's keys split over
  two warps); ``no 128-row blocks``: the rule without them (three
  instances fewer to build);
* ``P·V summed across tiles``: O accumulated on the tensor cores across
  all key tiles (rescaled by corr in place), instead of each tile's P·V
  summed from zero and added to O·corr by an f32 FMA (which keeps the
  tensor cores' rounding of the sums to one tile's).

With ``--parent DIR`` the forward sources of an earlier tree's csrc/ are
built and timed as ``parent`` too (an earlier tree may hold other kernels,
e.g. the CUDA-core 'simt' K1 in bf16 at D = 512); ``--only PREFIX`` builds
only the variants whose name starts with PREFIX besides ``as built``.
Prints each build's registers and spill bytes per f32 rows-kernel instance
and of the bf16 D = 512 kernel (nvcc's ``-Xptxas -v``), then per shape
each build's ms per launch of K1 and K2 (K1 alone where the build's design
rule refuses K2, as an earlier tree's did in bf16 at D = 512; CUDA events
over 20 launches, the ctypes call straight into the library), twice, the
builds timed in turns (in order, then in reverse), its TFLOP/s on the
4·BH·S²·D operations and its largest difference from the plain
version (O and L; the gate is two bf16 ulps of max |plain| in bf16, 2.5e-5
in f32), then SDPA's time in the dtype and the card's name and power
limit. Needs nvcc
and a card; builds under ``.build/variants/fwd/<dtype>``, all in parallel
(a variant that does not build is reported and skipped).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from diffusion_pullback_tpu_torch.ops import flash_attention as fa

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
OUT = os.path.join(fa.BUILD_DIR, "variants", "fwd")
# the sources the forward's C entry needs
UNITS = ("flash_fwd_tc.cu", "flash_fwd.cu", "flash_fwd_tf32.cu", "flash_fwd_tf32_rows.cu",
         "flash_fwd_mma_bf16.cu")
ROWS = "flash_fwd_tf32_rows.cu"
MMA = "flash_fwd_mma_bf16.cu"
STAGES_512 = "constexpr int STAGES = 2;        // of the K and V ring"
RULE = ("const int rows = 2 * n128 >= 3 * sms ? 128 : "
        "(long long)((sq + 63) / 64) * bh >= sms ? 64 : 32;")
# dtype → variant → [(file, text in it, replacement)], applied in order
VARIANTS = {
    "bf16": {
        "as built": [],
        "box past row": [
            ("hopper.cuh", "static constexpr int TX = TILE_ROWS * DIM * 2;",
             "static constexpr int TX = P * TILE;"),
            ("flash_fwd_tc.cu", "i < 3 ? D : tail);", "D);"),
        ],
        "P·V at N=64": [
            ("hopper.cuh", "static constexpr int width(int p) { return p < FULL ? D : TAIL; }",
             "static constexpr int width(int) { return D; }"),
            ("hopper.cuh", "wgmma_rs_tb<Pn::TAIL ? Pn::TAIL : D>(", "wgmma_rs_tb<D>("),
        ],
        "3 stages": [("flash_fwd_tc.cu", "STAGES = 2;", "STAGES = 3;")],
        "D=512 1 stage": [(MMA, STAGES_512, "constexpr int STAGES = 1;")],
        "D=512 4 slots": [(MMA, "constexpr int SLOTS = NW;", "constexpr int SLOTS = NW / 2;")],
        "D=512 64-key tiles": [(MMA, "constexpr int BQ = 32, BK = 32;",
                                "constexpr int BQ = 32, BK = 64;"),
                               (MMA, STAGES_512, "constexpr int STAGES = 1;"),
                               (MMA, "constexpr int SLOTS = NW;", "constexpr int SLOTS = NW / 2;")],
    },
    "f32": {
        "as built": [],
        "128-row blocks": [(ROWS, RULE, "const int rows = 128;")],
        "64-row blocks": [(ROWS, RULE, "const int rows = 64;")],
        "32-row blocks": [(ROWS, RULE, "const int rows = 32;")],
        "no 128-row blocks": [(ROWS, "if constexpr (D <= 80) {", "if constexpr (D <= 0) {")],
        "P·V summed across tiles": [
            (ROWS, "for (int e = 0; e < 4; ++e) pv[mt][n][e] = 0.f;",
             "for (int e = 0; e < 4; ++e) acc[mt][n][e] *= corr[mt][e / 2];"),
            (ROWS, "for (int mt = 0; mt < MT; ++mt) mma3(pv[mt][n], a[mt], b);",
             "for (int mt = 0; mt < MT; ++mt) mma3(acc[mt][n], a[mt], b);"),
            (ROWS, "acc[mt][n][e] = fmaf(acc[mt][n][e], corr[mt][e / 2], pv[mt][n][e]);",
             "{}")],
    },
}
# (B·H, S, D) by dtype. bf16: SD 1.5's, ImageNet128Cond's and SD 2.1's
# self-attentions, and a VAE's single 512-wide head built in bf16 (SD's
# encode and decode of 3 frames at 4096 tokens, SDXL's at 16 384). f32: the SD 2.1-base U-Net's (5 heads over 4096 tokens
# at batch 1, 4 and 6, 10 over 1024 at batch 1 and 6), SD 1.5's (8 heads
# of 40 over 4096 tokens at batch 1 and 2, of 80 over 1024),
# ImageNet128Cond's 4 heads of 128 and 8 heads of 160 over 1024 tokens
SHAPES = {
    "bf16": [(48, 4096, 40), (8, 4096, 40), (48, 1024, 80), (8, 1024, 80),
             (4, 1024, 128), (8, 1024, 160), (16, 4096, 160), (30, 4096, 64),
             (1, 4096, 512), (3, 4096, 512), (1, 16384, 512)],
    "f32": [(5, 4096, 64), (20, 4096, 64), (30, 4096, 64), (10, 1024, 64), (60, 1024, 64),
            (8, 4096, 40), (16, 4096, 40), (8, 1024, 80), (16, 1024, 80), (4, 1024, 128),
            (8, 1024, 160)],
}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build(name, edits, units=UNITS, out=OUT, src=CSRC):
    """The sources in ``src`` with ``edits`` applied, ``units`` of them built
    into one library under ``out``: (the library, nvcc's output)."""
    path = os.path.join(out, name.replace(" ", "_").replace("·", ""))
    shutil.rmtree(path, ignore_errors=True)
    shutil.copytree(src, path)
    for file, old, new in edits:
        with open(os.path.join(path, file)) as f:
            text = f.read()
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in {file}")
        with open(os.path.join(path, file), "w") as f:
            f.write(text.replace(old, new))
    nvcc = fa._nvcc()
    objs = [os.path.join(path, u + ".o") for u in units]
    procs = [subprocess.Popen([nvcc, *fa.NVCC_FLAGS, "-c", "-o", o, os.path.join(path, u)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for u, o in zip(units, objs)]
    logs = [proc.communicate(timeout=600)[0] for proc in procs]
    for proc, out in zip(procs, logs):
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} does not build:\n{out}")
    lib_path = os.path.join(path, "flash.so")
    subprocess.run([nvcc, "-shared", "-o", lib_path, *objs], check=True, timeout=600)
    return ctypes.CDLL(lib_path), "".join(logs)


def cuda_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def registers(log):
    """{(D, rows of a block, rows of a warp): (registers, spill store bytes,
    spill load bytes)} of the f32 rows-kernel instances and of the bf16 D =
    512 kernel (32 rows, each warp over all of them) in nvcc's -Xptxas -v
    output."""
    out, entry, spills = {}, None, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            k = re.search(r"flash_fwd_tf32_rows_kernelILi(\d+)ELi(\d+)ELi(\d+)E", m.group(1))
            entry = (int(k.group(1)), 16 * int(k.group(2)) * int(k.group(3)),
                     16 * int(k.group(3))) if k else (
                (512, 32, 32) if "flash_fwd_mma_bf16_kernel" in m.group(1) else None)
        elif entry and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                       line)):
            spills = int(m.group(1)), int(m.group(2))
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            out[entry] = (int(m.group(1)), *(spills or (0, 0)))
            entry = spills = None
    return out


def main():
    if not torch.cuda.is_available():
        print("fwd_tc_variants: needs a CUDA card", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    parser.add_argument("--parent", help="csrc/ of an earlier tree, timed as 'parent'")
    parser.add_argument("--only", default="",
                        help="time only the variants whose name starts with this")
    args = parser.parse_args()
    dtype = DTYPES[args.dtype]
    builds = [("parent", args.parent, [])] if args.parent else []
    builds += [(name, CSRC, e) for name, e in VARIANTS[args.dtype].items()
               if name == "as built" or name.startswith(args.only)]

    def make(name, src, edits):  # the forward's sources that ``src`` has
        units = [u for u in UNITS if os.path.exists(os.path.join(src, u))]
        try:
            return build(name, edits, units, os.path.join(OUT, args.dtype), src)
        except RuntimeError as e:  # reported, and the others timed all the same
            print(str(e).splitlines()[0] + " " + " ".join(
                line for line in str(e).splitlines() if "error" in line)[:300], flush=True)
            return None

    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(lambda b: make(*b), builds))
    libs = {}
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for (name, _, _), (lib, log) in ((b, r) for b, r in zip(builds, built) if r):
        lib.flash_fwd.argtypes = [vp] * 4 + [ci] * 5 + [cf, vp]
        lib.flash_fwd_lse.argtypes = [vp] * 5 + [ci] * 5 + [cf, vp]
        lib.flash_fwd.restype = lib.flash_fwd_lse.restype = ci
        lib.flash_design.argtypes = [ci, ci, ci]
        lib.flash_design.restype = ci
        libs[name] = lib
        if regs := registers(log):
            print(f"{name}: " + "; ".join(
                f"D={d} {rows} rows ({wq} a warp) {r} registers, spills {st}/{ld} bytes"
                for (d, rows, wq), (r, st, ld) in sorted(regs.items())), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for bh, s, d in SHAPES[args.dtype]:
        q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        scale = d ** -0.5
        ref_o, ref_l = fa.flash_forward_lse_plain(q, k, v, scale)
        o, lse = torch.empty_like(q), torch.empty(bh, s, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (q, k, v, o)]
        flag = int(dtype == torch.bfloat16)
        ops = 4.0 * bh * s * s * d
        times, errs = {name: ([], []) for name in libs}, {}
        for name in list(libs) + list(libs)[::-1]:
            lib = libs[name]

            def k1():
                if err := lib.flash_fwd(*ptrs, bh, s, s, d, flag, scale, stream):
                    raise RuntimeError(f"{name}: K1 cudaError {err}")

            def k2():
                if err := lib.flash_fwd_lse(*ptrs, lse.data_ptr(), bh, s, s, d, flag, scale,
                                            stream):
                    raise RuntimeError(f"{name}: K2 cudaError {err}")
            k1()
            torch.cuda.synchronize()
            err_o = (o.float() - ref_o.float()).abs().max().item()
            times[name][0].append(cuda_ms(k1))
            if lib.flash_design(2, d, flag) >= 0:  # the build's K2 takes the call
                k2()
                torch.cuda.synchronize()
                errs[name] = (max(err_o, (o.float() - ref_o.float()).abs().max().item()),
                              (lse - ref_l).abs().max().item())
                times[name][1].append(cuda_ms(k2))
            else:
                errs[name] = (err_o, float("nan"))
        ms = lambda ts: "/".join(f"{t:.4f}" for t in ts)
        cells = [f"{name} K1 {ms(t1)} ms ({ops / min(t1) / 1e9:.1f} TFLOP/s)"
                 + (f", K2 {ms(t2)} ms" if t2 else "")
                 + f" (err O {errs[name][0]:.3g}, L {errs[name][1]:.3g})"
                 for name, (t1, t2) in times.items()]
        library = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], scale=scale))
        print(f"({bh},{s},{d}): " + "; ".join(cells) + f"; sdpa {args.dtype} {library:.4f} ms",
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
