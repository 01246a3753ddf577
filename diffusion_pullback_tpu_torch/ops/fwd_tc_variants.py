"""Design variants of the bf16 forward kernel (csrc/flash_fwd_tc.cu, K1),
each built into a library of its own and timed against the others on one
card, in turns, at the head dims the kernel serves:

    python -m diffusion_pullback_tpu_torch.ops.fwd_tc_variants

Variants, each one edit of the sources as they stand:

* ``as built``: the sources unchanged;
* ``box past row``: the last panel loaded with a box of 64 columns that
  reaches past the row's end (TMA zero-fills it) instead of one of the
  D % 64 columns the row has (the panels are csrc/hopper.cuh's);
* ``P·V at N=64``: the last panel's P·V product over all 64 columns of its
  panel instead of its D % 64;
* ``3 stages``: three K/V stages in place of two.

Prints, per shape, each variant's ms per launch (CUDA events over 20
launches, the ctypes call straight into the library) and its largest
difference from the plain version (which the kernel's gate holds to two
bf16 ulps of max |plain|), then SDPA's ms and the card. Needs nvcc and a
card; builds under ``.build/variants``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

from diffusion_pullback_tpu_torch.ops import flash_attention as fa

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
OUT = os.path.join(fa.BUILD_DIR, "variants", "fwd")
# the sources the forward's C entry needs
UNITS = ("flash_fwd_tc.cu", "flash_fwd.cu", "flash_fwd_tf32.cu")
# variant → [(file, text in it, replacement)]
VARIANTS = {
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
}
SHAPES = [(48, 4096, 40), (8, 4096, 40), (48, 1024, 80), (8, 1024, 80),
          (4, 1024, 128), (8, 1024, 160), (16, 4096, 160), (30, 4096, 64)]


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


def main():
    if not torch.cuda.is_available():
        print("fwd_tc_variants: needs a CUDA card", file=sys.stderr)
        return 1
    libs = {}
    for name, edits in VARIANTS.items():
        lib = libs[name] = build(name, edits)[0]
        lib.flash_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.flash_fwd.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    for bh, s, d in SHAPES:
        q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        scale = d ** -0.5
        ref = fa.flash_forward_plain(q, k, v, scale).float()
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        cells = []
        for name, lib in libs.items():
            def call(lib=lib):
                err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    bh, s, s, d, 1, scale, stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            call()
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            cells.append(f"{name} {cuda_ms(call):.4f} ms (err {err:.3g})")
        sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], scale=scale))
        print(f"({bh},{s},{d}): " + "; ".join(cells) + f"; sdpa {sdpa:.4f} ms", flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
