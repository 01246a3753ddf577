"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. build   — compile the flash forward kernel (K1) from its CUDA source;
  2. K1      — the kernel against its plain PyTorch version at every shape
               the main path gives it, float32 (TF32 off) and bfloat16, with
               the kernel's, the plain version's and
               F.scaled_dot_product_attention's times (the latter a yardstick
               only; the port never calls it);
  3. U-Net   — one full-width SD 2.1-base U-Net ε with attn_impl='flash'
               (the kernel) against attn_impl='xla' (the math path), in
               float32 and in bfloat16;
  4. edit    — the main path at full width through the port's CLI builder:
               SD 2.1-base U-Net, 512 px VAE, 23-layer OpenCLIP-H text tower,
               seeded random weights, run_edit_local_encoder_pullback_zt with
               --attn_impl flash --pullback_attn_impl xla and small step
               counts; K1's launches, by shape, must equal what the path
               launches, and their summed device time is reported; then the
               pullback once more, warm.
Then a JSON line of the kernels, the card's name and power limit, and
finally {"ok": true, "device": {...}}.
"""

import collections
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "runs", "chip_smoke")

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, FP32 (CUDA cores) and dense
# BF16 tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# K1's (B·H, S, D) on the main path: the U-Net's 4096- and 1024-token
# self-attentions (5 and 10 heads of 64) at batch 1 (inversion, forward to
# the edit t), 4 (walk: 2 directions × the (null, edit) pair) and 6 (finish:
# 2 directions × 3 frames); the VAE's one 512-wide head at 4096 tokens in
# the encode (1 image) and in each direction's decode (3 frames)
K1_SHAPES = [(5 * b, 4096, 64) for b in (1, 4, 6)] + [
    (10 * b, 1024, 64) for b in (1, 4, 6)] + [(1, 4096, 512), (3, 4096, 512)]


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters):
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_tol(ref, dtype):
    """K1 against its plain version: 1e-4 in float32 (the two differ only
    in the order of f32 sums, ~4e-7 measured); in bfloat16 two ulps of
    max |ref| (the two round the same f32 value to bf16 and differ by at
    most one ulp where the sums straddle a rounding boundary)."""
    if dtype == torch.float32:
        return 1e-4
    top = ref.float().abs().max().item()
    return 2 * torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(top))


def k1_bound_ms(shape, dtype):
    """The least time for softmax(QKᵀ)V at this shape on an H100: each input
    read once and the output written once at the HBM rate, or the two
    matmuls' 4·BH·S²·D operations at the dtype's peak, whichever is larger."""
    bh, s, d = shape
    nbytes = 4 * bh * s * d * torch.tensor([], dtype=dtype).element_size()
    ops = 4.0 * bh * s * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def phase_k1(fa):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for shape in K1_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
            scale = shape[-1] ** -0.5
            out = fa.flash_forward(q, k, v, scale)
            torch.cuda.synchronize()
            ref = fa.flash_forward_plain(q, k, v, scale)
            err = (out.float() - ref.float()).abs().max().item()
            tol = k1_tol(ref, dtype)
            row = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: fa.flash_forward(q, k, v, scale), 20),
                plain_ms=cuda_ms(lambda: fa.flash_forward_plain(q, k, v, scale), 5),
                # 4-D (1, B·H, S, D): SDPA picks its fused kernels only for 4-D
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], scale=scale), 20),
            )
            row["bound_ms"], row["bound_by"] = k1_bound_ms(shape, dtype)
            rows[(shape, dtype)] = row
            log(f"[k1] {shape} {str(dtype)[6:]}: max_abs_err {err:.3g} (tol "
                f"{tol:.3g}) kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
            if not err <= tol:
                raise AssertionError(f"K1 disagrees with its plain version at "
                                     f"{shape} {dtype}: {err} > {tol}")
    return rows


def phase_unet(fa):
    from diffusion_pullback_tpu_torch.models import (
        UNet2DCondition, random_init_, sd21_base_unet)
    from diffusion_pullback_tpu_torch.models.layers import attn_impl_as

    unet = random_init_(UNet2DCondition(sd21_base_unet(attn_impl="flash")), 0)
    unet = unet.cuda().eval().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(1, 4, 64, 64, device="cuda", generator=gen)
    ctx = torch.randn(1, 77, 1024, device="cuda", generator=gen)
    with torch.no_grad():
        n0 = fa.flash_forward.launches
        eps_flash = unet(x, 500.0, ctx)
        launches = fa.flash_forward.launches - n0
        with attn_impl_as(unet, "xla"):
            eps_math = unet(x, 500.0, ctx)
    err = (eps_flash - eps_math).abs().max().item()
    scale = eps_math.abs().max().item()
    log(f"[unet] full-width SD 2.1-base eps f32, flash vs math: max_abs_err "
        f"{err:.3g} (max |eps| {scale:.3g}, tol 1e-4 relative), K1 launches "
        f"{launches}")
    if not (torch.isfinite(eps_flash).all() and err <= 1e-4 * scale):
        raise AssertionError("flash U-Net disagrees with the math path")
    if launches != 10:
        raise AssertionError(f"a U-Net call launched K1 {launches} times, not 10")

    # bf16, the main path's U-Net dtype: the two paths round differently, so
    # each is held to the f32 math ε above, and the flash path may stray from
    # it at most 1.5× as far (relative RMS) as the bf16 math path does
    unet.to(torch.bfloat16)
    with torch.no_grad():
        eps_flash = unet(x, 500.0, ctx).float()
        with attn_impl_as(unet, "xla"):
            eps_bf16 = unet(x, 500.0, ctx).float()
    rel = lambda e: (torch.linalg.norm(e - eps_math) / torch.linalg.norm(eps_math)).item()
    err_flash, err_math = rel(eps_flash), rel(eps_bf16)
    log(f"[unet] full-width SD 2.1-base eps bf16: relative RMS error against "
        f"f32 math, flash {err_flash:.4g}, math {err_math:.4g} (tol 1.5 × math "
        f"= {1.5 * err_math:.4g}); bf16 flash vs bf16 math max_abs_err "
        f"{(eps_flash - eps_bf16).abs().max().item():.3g}")
    if not (torch.isfinite(eps_flash).all() and err_flash <= 1.5 * err_math):
        raise AssertionError("bf16 flash U-Net strays from f32 further than "
                             "the bf16 math path")


@contextlib.contextmanager
def timed_launches(fa):
    """CUDA events around every K1 launch of the block, by (shape, dtype).
    The launch count stays the wrapper's own."""
    events = collections.defaultdict(list)
    launch = fa._launch

    def timed(q, k, v, scale):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = launch(q, k, v, scale)
        end.record()
        events[(tuple(q.shape), q.dtype)].append((start, end))
        return out

    fa._launch = timed
    try:
        yield events
    finally:
        fa._launch = launch


def phase_edit(fa):
    import numpy as np
    from PIL import Image

    from diffusion_pullback_tpu_torch import main as port_main
    from diffusion_pullback_tpu_torch.experiments import BasisCache
    from diffusion_pullback_tpu_torch.models import TapPoint

    shutil.rmtree(OUT, ignore_errors=True)
    args = port_main.parse_args([
        "--note", "chip_smoke", "--result_folder", OUT,
        "--attn_impl", "flash", "--pullback_attn_impl", "xla",
        "--for_steps", "10", "--inv_steps", "10", "--edit_t", "0.5",
        "--pca_rank", "2", "--x_space_guidance_num_step", "2",
        "--edit_prompt", "a photo of a smiling face"])
    t0 = time.perf_counter()
    edit = port_main.build_sd(args)
    cfg = edit.cfg
    cfg.pullback_min_iter, cfg.pullback_max_iter = 1, 3
    cfg.basis_folder = os.path.join(OUT, "inputs")
    edit.cache = BasisCache(cfg.basis_folder)
    log(f"[edit] built the SD 2.1-base driver in {time.perf_counter() - t0:.1f} s "
        f"(U-Net {next(edit.unet.parameters()).dtype}, attn "
        f"{edit.unet.config.attn_impl}, pullback attn {cfg.pullback_attn_impl})")

    vis_num, vis_num_pc = 2, 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_forward.launches = 0
    t0 = time.perf_counter()
    with timed_launches(fa) as k1_events:
        names = edit.run_edit_local_encoder_pullback_zt(
            idx=0, pca_rank=2, vis_num=vis_num, vis_num_pc=vis_num_pc)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.flash_forward.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # (shape, dtype) → [launches, summed device ms]
    k1_path = {key: [len(ev), sum(a.elapsed_time(b) for a, b in ev)]
               for key, ev in k1_events.items()}

    n_dir = 2 * vis_num_pc
    stride = max(1, (cfg.x_space_guidance_num_step + 1) // vis_num)
    frames = len(range(0, cfg.x_space_guidance_num_step + 1, stride))
    unet_dtype = next(edit.unet.parameters()).dtype
    unet_calls = {  # batch → U-Net calls (no CFG: guidance_scale is 0)
        1: (cfg.inv_steps - 2) + edit.edit_t_idx,
        2 * n_dir: cfg.x_space_guidance_num_step,
        n_dir * frames: cfg.for_steps - 1 - edit.edit_t_idx}
    expected_by_shape = collections.Counter()
    for b, calls in unet_calls.items():
        expected_by_shape[((5 * b, 4096, 64), unet_dtype)] += 5 * calls
        expected_by_shape[((10 * b, 1024, 64), unet_dtype)] += 5 * calls
    vae_dtype = next(edit.vae.parameters()).dtype
    expected_by_shape[((1, 4096, 512), vae_dtype)] += 1          # encode
    expected_by_shape[((frames, 4096, 512), vae_dtype)] += n_dir  # decodes
    expected = sum(expected_by_shape.values())
    k1_ms = sum(ms for _, ms in k1_path.values())
    for (shape, dtype), (n, ms) in sorted(k1_path.items(), key=lambda kv: -kv[1][1]):
        log(f"[edit] K1 at {shape} {str(dtype)[6:]}: {n} launches (expected "
            f"{expected_by_shape[(shape, dtype)]}), {ms:.3f} ms on the device")

    with open(os.path.join(edit.log.path)) as f:
        events = [json.loads(line) for line in f]
    for e in events:
        if "seconds" in e:
            extra = {k: v for k, v in e.items() if k not in ("ts", "event", "seconds")}
            log(f"[edit] stage {e['event']}: {e['seconds']:.3f} s {extra}")
    basis_files = os.listdir(cfg.basis_folder)
    with np.load(os.path.join(cfg.basis_folder, basis_files[0])) as z:
        u, s, vT = z["u"], z["s"], z["vT"]
    log(f"[edit] main path {seconds:.2f} s, sigma {s.tolist()}, peak memory "
        f"{peak_gb:.2f} GB, K1 launches {launches} (expected {expected}), K1 "
        f"device time {k1_ms:.2f} ms ({100 * k1_ms / 1e3 / seconds:.2f} % of "
        f"the path)")

    finite = [e for e in events if e["event"] == "sd_decode_and_save"]
    checks = {
        "two PNGs written": len(names) == n_dir and all(
            Image.open(os.path.join(cfg.result_folder, n + ".png")).size
            == (512 * frames, 512) for n in names),
        "edited latents and images finite": bool(finite and finite[-1]["finite"]),
        "basis finite, expected shapes": (
            u.shape == (8 * 8 * 1280, 2) and vT.shape == (2, 64 * 64 * 4)
            and all(np.isfinite(a).all() for a in (u, s, vT)) and (s > 0).all()),
        "K1 launch count": launches == expected and launches > 0,
        "K1 launches by shape": {k: n for k, (n, _) in k1_path.items()}
        == dict(expected_by_shape),
    }
    for what, ok in checks.items():
        log(f"[edit] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("main path checks failed")

    # the same pullback once more in this process, warm, at a latent of
    # the same shape (the main path's ran first, with one-time costs)
    zt = torch.randn(1, 64, 64, 4, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(3))
    t0 = time.perf_counter()
    res = edit.compute_local_basis(zt, edit.fwd_grid.timesteps[edit.edit_t_idx],
                                   TapPoint("mid", 0), 2)
    torch.cuda.synchronize()
    log(f"[edit] pullback again, warm: {time.perf_counter() - t0:.3f} s, "
        f"{res.iterations} iterations")
    heaviest = max(k1_path, key=lambda key: k1_path[key][1])
    return launches, heaviest, k1_ms


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    from diffusion_pullback_tpu_torch.ops import flash_attention as fa
    from diffusion_pullback_tpu_torch.utils.device import strict_f32

    strict_f32()
    t0 = time.perf_counter()
    lib, nvcc_out = fa.build()
    log(f"[build] {os.path.relpath(lib, HERE)} in {time.perf_counter() - t0:.1f} s")
    for line in nvcc_out.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    rows = phase_k1(fa)
    phase_unet(fa)
    torch.cuda.empty_cache()
    launches, (shape, dtype), path_ms = phase_edit(fa)

    # per-launch numbers at the shape that carries most of K1's device time
    # on the main path; path_ms is K1's summed device time over that run
    kernels = {"kernels": [dict(
        name="flash_fwd (K1)", route="cuda",
        source="diffusion_pullback_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="diffusion_pullback_tpu/ops/pallas/flash_attention.py:179",
        launches=launches, shape=list(shape), dtype=str(dtype)[6:],
        path_ms=path_ms, **rows[(shape, dtype)])]}
    log(json.dumps(kernels))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
