"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. build   — compile the flash kernels K1–K5 from their CUDA sources
               (one nvcc per source, in parallel, linked into one library);
  2. kernels — each kernel against its plain PyTorch version at every shape
               the main path gives it, float32 (TF32 off) and bfloat16, with
               the design that served it as the C library's one rule
               reports it ('wgmma': K1–K5 in bf16 at D=40, 64, 80, 128
               and 160; 'tf32x3': K1 and K2 in f32 at every head dim, K3,
               K4 and K5 in f32 at 40–160; 'mma_bf16': K1 and K2 in bf16
               at D=512), each launch's design as the C entries counted it, the kernel's,
               the plain version's and a PyTorch yardstick's times
               (F.scaled_dot_product_attention for K1; for K2 and K4+K5 the
               flash SDPA forward / backward ops in bf16 and the
               memory-efficient ones in f32 and for K2 in bf16 at D=512
               (with its logsumexp); for K3 torch.func.jvp of
               F.scaled_dot_product_attention on its math backend; the port
               never calls them), with the kernels the profiler saw serve
               the yardsticks of K1 at D=512 and of K3, the host's time per
               wrapper call, the bound, the achieved TFLOP/s and the bound's
               share of the kernel's time; for K1–K5 on 'tf32x3' also the
               error of one TF32 product per f32 product, which their gate
               must reject, at every shape and head dim;
               then the fused pair under torch.func (vmap of jvp, vmap of a
               vjp function) against the math path;
  3. U-Net   — one full-width SD 2.1-base U-Net: ε with attn_impl='flash'
               (K1) against attn_impl='xla' (the math path), and the mid-tap
               encoder pullback with the fused pair against the math path
               from the same probes and a fixed number of iterations, in
               float32 and in bfloat16;
  4. edit    — the main path at full width through the port's CLI builder:
               SD 2.1-base U-Net, 512 px VAE, 23-layer OpenCLIP-H text tower,
               seeded random weights, run_edit_local_encoder_pullback_zt
               with the CLI's defaults on the card (--attn_impl flash, the
               fused-pair pullback) and small step counts; each kernel's
               launches, by shape, must equal what the path launches, and
               their summed device time is reported, by shape and by design;
               then the pullback
               again, warm, and the math-path pullback, cold and warm;
  5. uncond  — the CelebA-HQ-256 edit path at full width through the CLI's
               builder (ddpm_celebahq_256 in bf16, the bundled images, 20-step
               grids with performance boosting), which must launch none of
               K1–K5 (its attention is 256- and 64-token single-head math
               path); full-width ε and the ddpm_tiny(32) config-1 smoke
               pipeline on the card against the CPU in f32, and bf16 against
               f32 at full width;
  6. sd rest — the rest of the SD 2.1-base edit path at full width through
               the CLI's builder with the with-prompt script's values (edit
               prompt 'sitting dog', CFG inside the JVP at 7.5, edit t 0.7):
               the encoder-pullback edit with CFG in the JVP, the decoder-
               and x̂₀-pullback edits, the text-driven edit, the walk and the
               finish under DeepCache (interval 1 identical to the plain
               path), run_DDIMforward, each with its launches by shape held
               to the count the code gives; then the CFG and decoder
               pullbacks on the pair against the math path in f32 and bf16;
  7. sdxl    — the SDXL-1024 edit path at full width through the CLI's
               builder: the 2.57 B-parameter U-Net in bf16 at 128² latents,
               the CLIP ViT-L and OpenCLIP bigG towers and the 1024 px VAE
               in f32, seeded random weights drawn on the card, the bundled
               example images, run_edit_local_encoder_pullback_zt with the
               CLI's defaults on the card (K1 on 'tf32x3' in the VAE at
               16 384 tokens, the fused pair in the pullback, one latent
               per VAE decode) at 10/10 steps, edit t 0.5, pca_rank 2, 2
               walk steps and 2 directions × 3 frames; its launches by
               shape held to the count the code gives, each stage's seconds
               and peak memory, the device time by shape and design; then
               the pullback at pca_rank 8 with the CLI's chunking (one
               probe per pass) and unchunked;
  8. adm     — the ADM-256 edit path at full width through the CLI's uncond
               builder: ImageNet256Uncond (552 814 086 parameters, learned
               σ) in bf16 with seeded random weights drawn on the card,
               --attn_impl flash (K1 at its 8 heads of 64 over 1024
               tokens), the fused-pair pullback (K2–K5), the bundled
               example images at 256 px, 10/10 steps, edit t 0.5, pca_rank
               2, 2 walk steps, 2 directions × 3 frames; its launches by
               shape held to the count the code gives, each stage's seconds
               and peak memory; the mid-tap pullback on the pair against
               the math path in f32 and bf16; ε on the card against the CPU
               in f32; run_ddim_forward(2) guided by adm_classifier(256) on
               the respaced 'ddim10' grid, finite and unlike the unguided
               run; and one ε pass of FFHQ_P2 (attention only at 256
               tokens), which must launch none of K1–K5;
  9. harvest — the basis harvests and PCA runs: SD 2.1-base at full width
               through the CLI's builder (U-Net bf16 drawn on the card,
               10/10 steps, edit t 0.5, one power iteration per pullback):
               the t-grid harvest at two points of the CLI's grid at its
               pca_rank 50 (K3–K5 at B·H 250 over 4096 tokens and 500 over
               1024), each rank-50 pullback's seconds and peak memory and
               the seconds per basis; the CLI's prompt sweep over 3 bundled
               prompts and its edit loop, which must read every basis from
               the cache; local PCA of 32 perturbations in chunks of 16 and
               the CLI's global PCA of 100 latents (K1 at their B·H); the
               rank-50 pullback on the pair against the math path in f32;
               then the CLI's Fréchet-mean edit on ADM-256 over two samples'
               pca_rank-10 bases; each run's launches by shape held to the
               count the code gives;
 10. uncond  — the rest of the uncond edit runs on ADM-256 at full width
     runs      through the CLI (bf16, weights drawn on the card, the fused
               pair, 10/10 steps, edit t 0.5, one power iteration per
               pullback): h-space guidance at pca_rank 2, the decoder-
               pullback edit and that pullback on the pair against the math
               path in f32 and bf16, parallel transport at pca_rank 50 (K3–
               K5 at B·H 400 over 1024 tokens), run_ddim_forward(5) with the
               power spectra of its trajectories and the inversion, each
               with its launches by shape held to the count the code gives;
               then a checkpoint round trip at full width (CelebA-HQ-256's
               U-Net and adm_classifier(256) through torch.save,
               --checkpoint_path and --classifier_path, bit for bit);
 11. extras  — the post-edit regularizers on the SD 2.1-base edit through
               the CLI (every frame at the walk start's norm after
               preserve_norm); batched_local_pullback over 4 SD latents on
               the pair (K2 at B·H 20 / 40, K3–K5 at 40 / 80) against 4
               per-sample pullbacks in f32 and bf16; the ancestral sampler
               (ddpm_forward, learned σ, respaced '10' grid) on ADM-256,
               plain and classifier-guided; uncond DeepCache on
               CelebA-HQ-256 at intervals 1 and 3 against the plain
               forward; and SDXL's rank-8 pullback unchunked with remat off
               and on (seconds, peak memory, the same basis); each with its
               launches by shape held to the count the code gives. Phase 7
               runs SDXL with remat on, as build_sdxl now sets it;
 12. head    — the model configs at head dims 40, 80 and 128 (K1–K5 on
     dims      'wgmma' in bf16), built through the library (no CLI of either package builds
               them): SD 1.5 at full width (the 859.5 M
               U-Net in bf16, the CLIP ViT-L tower and the SD VAE in f32,
               seeded random weights drawn on the card) through
               EditStableDiffusion's run_edit_local_encoder_pullback_zt at
               phase 4's settings (K1 at 8 heads of 40 over 4096 tokens and
               of 80 over 1024, K2–K5 at those heads in the pullback), its
               launches by shape, stage seconds and peak memory, the same
               edit with the U-Net in f32 (K1–K5 on 'tf32x3', as the C
               entries count them), and its mid-tap
               pullback on the pair against the math path in f32;
               ImageNet128Cond at full width with labels (K1–K5 at 4 heads
               of 128 over 1024 tokens): ε and the mid-tap rank-2 pullback
               on the pair against the math path in f32 and bf16, each
               dtype's flash run with its launches by shape held to the
               count the code gives; every bf16 K1–K5 launch of both served
               by 'wgmma', every f32 one of ImageNet128Cond by 'tf32x3';
 13. train   — training through the library API: ImageNet256Uncond at full
               width in bf16 (attn 'flash', weights drawn on the card) on
               f32 master params with AdamW and two EMA rates, the bundled
               images at 256 px, 3 steps of the hybrid objective with
               loss-aware t and 2 with accum_steps=2 (K2 forward, K4 + K5
               backward at 8 heads of 64 over 1024 tokens, on 'wgmma'),
               each step's seconds, peak memory and launches by shape; one
               step's gradients on the pair against the math path; a
               checkpoint round trip and one more step from both copies,
               bit for bit; calc_bpd_loop on the EMA params (K1);
 14. tooling — the SD 2.1-base edit at phase 4's settings through the CLI
               (main.main) on the bundled example images, with
               --profile_dir and --aot_export on in a temporary folder
               (removed after): the profiler's trace holds K1–K5's device
               kernels as often as the wrappers launched them, the
               device's idle share over the traced window and its top five
               ops; the per-step ε and the VAE encode and decode exported;
               the run again in a fresh process's state with export
               refused, every program loaded, its PNGs and σ within the
               repo's gates of the first run's (PSNR ≥ 35 dB, rtol 1e-3);
               the mid-tap pullback's FLOPs (pullback_flops at pca_rank 2,
               the pair and the math path) and its stage's TFLOP/s and MFU;
               ε at full width counting the same FLOPs with 'flash' as with
               'xla'; load_batch of the bundled images within one level of
               __getitem__, a .dpb basis bit for bit, the codecs reported;
 15. parallel — the device mesh (parallel/): ring attention's per-rank loop
               over 2 and 4 virtual ranks in one process, K2 per ring step
               at the shard shapes of SD 2.1-base's self-attentions (bf16,
               'wgmma') and of the VAE's 512-wide head (f32, 'tf32x3';
               bf16, 'mma_bf16', on random operands and on the q, k and v
               of the mid-block attention of SD's and SDXL's VAEs built in
               bf16 through the library, encoding a bundled image at 512
               and 1024 px), held to the same ring on K2's plain version
               and to dense attention, each launch's design as the C
               entries counted it where they launched; the CLI (main.main)
               with --mesh_axes sp:4 at one rank: auto becomes ring, no
               mesh is built, and a full-width U-Net pass launches K1 as
               'flash' does; then NCCL
               at world size 1: a ('dp', 'probe', 'sp', 'tp') mesh, the
               probe-sharded pullback of the full-width SD 2.1-base mid tap
               on the pair against local_pullback, dp_vmap over two
               pullbacks, and the ring over the one-rank 'sp' group against
               dense K1;
 16. f32     — the SD 2.1-base edit at --dtype fp32 through the CLI's
               builder at phase 4's settings (the 865.9 M-parameter U-Net
               in f32, weights drawn on the card, 10/10 steps, edit t 0.5,
               pca_rank 2, 2 walk steps, 1–3 power iterations, 2
               directions × 3 frames): K1–K5 on 'tf32x3' at (B·H, 4096 |
               1024, 64), K2–K5 under the fused pair; its launches by
               shape, each stage's seconds, the peak memory and the
               launches by design as the C entries counted them (every f32
               launch must be 'tf32x3'); then the same run on the
               math path (--attn_impl xla --pullback_attn_impl xla), which
               launches none of K1–K5, and the JAX package's f32 gates
               between the two: σ within rtol 1e-3, |cos| ≥ 0.99 per σ-gap
               group, the edited images ≥ 35 dB PSNR;
 17. bf16 VAE — the SD 2.1-base edit of phase 4 through main.build_sd
               (weights drawn on the card), run with its f32 VAE, then with
               the VAE built in bf16 (AutoencoderKL(sd_vae(attn_impl=
               'flash', dtype='bfloat16')), the same weights), then with
               that VAE on the math path, with the U-Net in bf16 (as the
               CLI builds it) and then cast to f32, every run after the
               first reading its basis: the bf16 VAE's K1 at (1 | 3, 4096,
               512) on 'mma_bf16', each run's launches by shape held to the
               count the code gives and by design as the C entries counted
               them; with the f32 U-Net the edited images ≥ 35 dB PSNR
               against the math-path VAE's, with the bf16 U-Net within
               1.5× the math path's distance from the f32 VAE's, and every
               PSNR reported; then one bundled image encoded and decoded
               through SDXL's 1024 px VAE in bf16 (K1 at (1, 16384, 512) on
               'mma_bf16'), held to the f32 math path within 1.5× the bf16
               math path's error.
Phases 1–2 hold every (kernel, shape) that phases 4 and 6–17 launch.
Then a JSON line of the kernels (one entry per kernel, design and head dim
over phases 4 and 6–17, at the shape that carries most of that entry's
device time there), the card's name and power limit, and
finally {"ok": true, "device": {...}}.
"""

import collections
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "runs", "chip_smoke")

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense tensor-core peaks.
# An f32-accurate product runs on the tensor cores as three TF32 products
# (the 'tf32x3' design), so the least time of f32 work is its operations at
# a third of the dense TF32 rate, 494.7 / 3 ≈ 164.9 TFLOP/s (the CUDA
# cores' FP32 peak, 67 TFLOP/s, is slower).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 494.7e12 / 3, torch.bfloat16: 989e12}
# K1's (B·H, S, D) on the main path: the U-Net's 4096- and 1024-token
# self-attentions (5 and 10 heads of 64) at batch 1 (inversion, forward to
# the edit t), 4 (walk: 2 directions × the (null, edit) pair) and 6 (finish:
# 2 directions × 3 frames); the VAE's one 512-wide head at 4096 tokens in
# the encode (1 image) and in each direction's decode (3 frames)
K1_SHAPES = [(5 * b, 4096, 64) for b in (1, 4, 6)] + [
    (10 * b, 1024, 64) for b in (1, 4, 6)] + [(1, 4096, 512), (3, 4096, 512)]
F32, BF16 = torch.float32, torch.bfloat16
# (shape, dtype) of each K1 case: every K1_SHAPES entry in both dtypes, and
# phase 6's new shapes in the path's dtype only: run_DDIMforward's 5
# samples through the U-Net (bf16) and the VAE (f32)
K1_CASES = [(s, dt) for s in K1_SHAPES for dt in (F32, BF16)] + [
    ((25, 4096, 64), BF16), ((50, 1024, 64), BF16), ((5, 4096, 512), F32)]
# K1 launches of one U-Net pass at batch b: (heads · b, S, 64) for the
# heads at 4096 and at 1024 tokens, and the number of calls at each. SD
# 2.1-base: 5 and 10 heads, 5 calls each (down blocks 0–1, up blocks 2–3);
# SDXL (depths 1, 2, 10; two layers down, three up): 10 heads, 10 calls
# (down 1: 2×2, up 1: 3×2) and 20 heads, 60 calls (down 2: 2×10, mid: 10,
# up 0: 3×10). tests/test_torch_port_sdxl_models.py counts them on the CPU
SD_UNET = dict(at_4096=5, at_1024=5, heads=(5, 10))
SDXL_UNET = dict(at_4096=10, at_1024=60, heads=(10, 20))
# phase 7's K1 shapes, in the path's dtypes: the SDXL U-Net at batch 1, 4
# (walk) and 6 (finish), and its VAE's one 512-wide head at 1024 px, 16 384
# tokens, one image per call
K1_CASES += [((10 * b, 4096, 64), BF16) for b in (1, 4, 6)] + [
    ((20 * b, 1024, 64), BF16) for b in (1, 4, 6)] + [((1, 16384, 512), F32)]
# phase 8's K1 shapes: the ADM-256 U-Net's 8 heads of 64 at 1024 tokens
# (32²) at batch 1, 2 (the guided run_ddim_forward; the walk of 2
# directions, its (null, edit) pair split as the uncond family's
# --xsg_pair_impl auto), 4 (the split walk of 4 directions in phases 9–10)
# and 6 (finish); its 256- and 64-token layers take the math path
K1_CASES += [((8 * b, 1024, 64), BF16) for b in (1, 2, 4, 6)]
# phase 17: SDXL's 1024 px VAE built in bf16, its one 512-wide head over
# 16 384 tokens ('mma_bf16'; the SD VAE's (1 | 3, 4096, 512) are K1_SHAPES')
K1_CASES += [((1, 16384, 512), BF16)]
# phase 9's K1 shapes: the SD 2.1-base U-Net over 16 latents at once (local
# PCA's chunk of 16 perturbations through the mid-tap encoder) and over 100
# (the CLI's global PCA population, --num_local_basis), and the ADM-256
# U-Net at batch 8 (phase 10's h-space guidance decodes 8 rows from the
# tap) and 12 (finish: 4 directions × 3 frames)
K1_CASES += [((80, 4096, 64), BF16), ((160, 1024, 64), BF16),
             ((500, 4096, 64), BF16), ((1000, 1024, 64), BF16),
             ((64, 1024, 64), BF16), ((96, 1024, 64), BF16)]
# ADM-256: 5 self-attentions at 1024 tokens per pass (2 on the down path at
# 32², 3 on the up path); the mid-tap encoder reaches 2 of them
ADM_UNET = dict(at_4096=0, at_1024=5, heads=(8, 8))
ADM_PAIR = [(8, 1024, 64)]
# the SDXL pullback's encoder (batch 1, mid tap) reaches the pair at these
# primal shapes, 4 and 30 times per pass (down block 1; down block 2 and
# the mid block); phase 2 holds them (PAIR_CASES' 2·B cases of SD)
SDXL_PAIR = ([(10, 4096, 64), (20, 1024, 64)], (4, 30))
# the pullback's encoder (batch 1, mid tap) reaches the pair at these
# primal (B·H, S, D); K3–K5 see the probes folded into B·H
PCA_RANK = 2
PAIR_SHAPES = [(5, 4096, 64), (10, 1024, 64)]
# (primal B·H, S, D, probes, dtypes, kernels) of each K2–K5 case: the
# pullback's encoder at batch 1 in both dtypes; phase 6's CFG pullback, its
# 2·B primal (K2) with the probes folded outside it (K3–K5); and phase 6's
# covector VJPs (Jᵀu), one cotangent against the primal (K4, K5 unfolded)
PAIR_CASES = [(*shape, PCA_RANK, (F32, BF16), ("K2", "K3", "K4", "K5"))
              for shape in PAIR_SHAPES] + [
    (10, 4096, 64, PCA_RANK, (BF16,), ("K2", "K3", "K4", "K5")),
    (20, 1024, 64, PCA_RANK, (BF16,), ("K2", "K3", "K4", "K5")),
    (5, 4096, 64, 1, (BF16,), ("K4", "K5")),
    (10, 1024, 64, 1, (BF16,), ("K4", "K5")),
    (8, 1024, 64, PCA_RANK, (BF16,), ("K2", "K3", "K4", "K5"))]
# phase 9: the SD harvest's rank-50 pullback (K3–K5 at B·H 250 over 4096
# tokens and 500 over 1024, bf16 on the path and f32 in its check against
# the math path; its K2 is the rank-2 cases' primal), the ADM Fréchet
# harvest's rank-10 pullback (K3–K5 at 80 over 1024) and the ADM covector
# VJPs (one cotangent)
HARVEST_RANK, MEAN_RANK = 50, 10
PAIR_CASES += [(*shape, HARVEST_RANK, (F32, BF16), ("K3", "K4", "K5"))
               for shape in PAIR_SHAPES]
PAIR_CASES += [(8, 1024, 64, MEAN_RANK, (BF16,), ("K3", "K4", "K5")),
               (8, 1024, 64, 1, (BF16,), ("K4", "K5"))]
# phase 10: parallel transport's two rank-50 pullbacks on ADM-256 (K3–K5 at
# B·H 400 over 1024 tokens; the decoder pullback's are the rank-2 cases')
PAIR_CASES += [(8, 1024, 64, HARVEST_RANK, (BF16,), ("K3", "K4", "K5"))]
# phase 11: the batched pullback over BATCH SD latents at once (the primal
# at B·H = BATCH·heads, K3–K5 at PCA_RANK·BATCH·heads), in the path's bf16
# and in f32 (its check against per-sample pullbacks); and SDXL's rank-8
# pullback unchunked (K3–K5 at B·H 80 over 4096 tokens and 160 over 1024;
# its K1 in the remat'd forward and K2 are phase 7's batch-1 shapes)
BATCH, SDXL_RANK = 4, 8
PAIR_CASES += [(BATCH * bh, s, d, PCA_RANK, (F32, BF16), ("K2", "K3", "K4", "K5"))
               for bh, s, d in PAIR_SHAPES]
PAIR_CASES += [(*shape, SDXL_RANK, (BF16,), ("K3", "K4", "K5")) for shape in SDXL_PAIR[0]]
# phase 12: SD 1.5 (8 heads per block: 40 at 4096 tokens, 80 at 1024, 160
# at 256 and 64 tokens, which take the math path) and ImageNet128Cond (4
# heads of 128 at 1024 tokens; 192 at 256 and 256 at 64, math path): K1–K5
# on 'wgmma' in bf16 and on 'tf32x3' in f32. K1:
# the SD 1.5 edit's U-Net at batch 1, 4 (walk) and 6 (finish) in both
# dtypes (the edit runs in bf16 and in f32); SD 1.5's
# self-attentions at batch 1 and 2, ImageNet128Cond's at batch 1 and 8
# heads of 160 at 1024 tokens (SD 1.5's third block at 1024 px) in both
# dtypes. K2–K5: the
# mid-tap pullbacks at rank 2 (SD 1.5: 2 layers at each of (8, 4096, 40)
# and (8, 1024, 80); ImageNet128Cond: 2 at (4, 1024, 128)) and 8 heads of
# 160, in both dtypes
SD15_UNET = dict(at_4096=5, at_1024=5, heads=(8, 8), dims=(40, 80))
SD15_PAIR = [(8, 4096, 40), (8, 1024, 80)]
ADM128_UNET = dict(at_4096=0, at_1024=5, heads=(4, 4), dims=(128, 128))
ADM128_PAIR = [(4, 1024, 128)]
HEAD_DIM_K1 = [(8, 4096, 40), (16, 4096, 40), (8, 1024, 80), (16, 1024, 80),
               (4, 1024, 128), (8, 1024, 160)]
K1_CASES += [(s, dt) for s in HEAD_DIM_K1 for dt in (F32, BF16)] + [
    ((8 * b, s, d), dt) for b in (4, 6) for _, s, d in SD15_PAIR for dt in (F32, BF16)]
PAIR_CASES += [(*shape, PCA_RANK, (F32, BF16), ("K2", "K3", "K4", "K5"))
               for shape in SD15_PAIR + ADM128_PAIR + [(8, 1024, 160)]]
# phase 13: training ImageNet256Uncond in bf16, K2 in each forward and K4 +
# K5 in each backward (one cotangent) at its 8 heads of 64 over 1024 tokens,
# at the batch TRAIN_BATCH and at accum_steps=2's microbatch of half of it
# (at a smaller batch that does not fit 4, B·H 8 is the rank-2 and covector
# cases'); calc_bpd_loop's K1 at batch 1 is phase 8's (8, 1024, 64)
TRAIN_BATCH = 4
PAIR_CASES += [(8 * b, 1024, 64, 1, (BF16,), ("K2", "K4", "K5"))
               for b in (TRAIN_BATCH, TRAIN_BATCH // 2)]
# phase 15: ring attention's K2 at its shard shapes, the ring over n = 2
# and 4 virtual ranks: SD 2.1-base's self-attentions in bf16 (5 heads of
# 64 over 4096 tokens, 10 over 1024), the VAE's single 512-wide head over
# 4096 tokens in f32 ('tf32x3'), and that head of a VAE built in bf16
# ('mma_bf16') over SD's 4096 tokens and SDXL's 16 384 (random operands,
# then the q, k and v the bf16 VAEs' encoders hand their mid-block
# attention at 512 and 1024 px); each rank runs K2 at (B·H, S/n, D)
RING_CASES = [((5, 4096, 64), BF16), ((10, 1024, 64), BF16), ((1, 4096, 512), F32),
              ((1, 4096, 512), BF16), ((1, 16384, 512), BF16)]
RING_NS = (2, 4)
PAIR_CASES += [(bh, s // n, d, 1, (dt,), ("K2",)) for (bh, s, d), dt in RING_CASES
               for n in RING_NS]
# C symbol → (label, wrapper, source in ops/csrc by design, line of the
# pl.pallas_call it replaces in diffusion_pullback_tpu/ops/pallas/flash_attention.py)
KERNELS = {
    "flash_fwd": ("K1", "flash_forward",
                  {"mma_bf16": "flash_fwd_mma_bf16.cu", "wgmma": "flash_fwd_tc.cu",
                   "tf32x3": "flash_fwd_tf32_rows.cu"}, 190),
    "flash_fwd_lse": ("K2", "flash_forward_lse",
                      {"mma_bf16": "flash_fwd_mma_bf16.cu", "wgmma": "flash_fwd_tc.cu",
                       "tf32x3": "flash_fwd_tf32_rows.cu"}, 262),
    "flash_tangent": ("K3", "flash_tangent",
                      {"wgmma": "flash_jvp_tc.cu", "tf32x3": "flash_jvp_tf32_rows.cu"}, 505),
    "flash_dq": ("K4", "flash_dq",
                 {"wgmma": "flash_bwd_tc.cu", "tf32x3": "flash_bwd_tf32_rows.cu"}, 378),
    "flash_dkv": ("K5", "flash_dkv",
                  {"wgmma": "flash_bwd_tc.cu", "tf32x3": "flash_bwd_tf32_rows.cu"}, 396),
}
KERNELS_BY_LABEL = {label: sym for sym, (label, *_) in KERNELS.items()}


def kernel_source(sources, design, d):
    """The csrc file of a kernel's ``design`` at head dim d: 'tf32x3' at
    D = 512 is flash_fwd_tf32.cu (warps split D), at 40–160
    flash_fwd_tf32_rows.cu (warps own rows)."""
    return "flash_fwd_tf32.cu" if design == "tf32x3" and d == 512 else sources[design]
# K2–K5's operations per (B·H)·S²·D, B·H the tangents' or the cotangent's,
# with the primal's QKᵀ (2 of them) recomputed for every probe, as the
# kernels do; pair_ops counts what the function needs
PAIR_OPS = {"K2": 4, "K3": 10, "K4": 6, "K5": 8}
# K1 and K2 on 'tf32x3' against their plain versions (f32, TF32 off); K4
# and K5 on 'tf32x3' against TF32X3_TOL of max(1, max |plain|) (pair_tol).
# Three TF32 products per f32 product read 9.39e-6 at (3,4096,512) and
# 5.25e-6 at (1,4096,512) on an H100, and under 1.8e-6 at the f32 path
# shapes of head dims 40–160 (phases 1–2); one TF32 product
# per f32 product stays under 1e-4 at the VAE's shapes, so 1e-4 would pass
# a kernel that dropped the two small products. Phases 1–2 measure the
# one-product error too and fail unless this gate lies below it.
TF32X3_TOL = 2.5e-5


def log(msg):
    print(msg, flush=True)


def load_basis(path):
    """(u, s, vT) of a basis file, .dpb or .npz, by the port's reader."""
    from diffusion_pullback_tpu_torch.experiments.cache import load_basis as read

    return read(path)


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


def host_us(fn, iters=20):
    """Host microseconds per call of fn, issued back to back without
    waiting for the card (20 launches do not fill the launch queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / iters


def served_by(fn, n=2):
    """The names of the n device kernels with the most device time in one
    call of fn, as torch.profiler records them ('not traced' if it records
    no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)
    top = sorted((e for e in prof.key_averages() if dev(e) > 0), key=dev, reverse=True)
    return "; ".join(e.key[:100] for e in top[:n]) or "not traced"


def k1_tol(ref, dtype):
    """K1 against its plain version: in float32 TF32X3_TOL (every f32 call
    runs 'tf32x3'); in bfloat16 two ulps of max |ref| (the two round the
    same f32 value to bf16 and differ by at most one ulp where the sums
    straddle a rounding boundary)."""
    if dtype == torch.float32:
        return TF32X3_TOL
    top = ref.float().abs().max().item()
    return 2 * torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(top))


def tf32(x):
    """x (f32) rounded to TF32 as cvt.rna.tf32.f32 rounds: to nearest, ties
    away from zero, keeping 10 of the 23 mantissa bits."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def one_tf32_forward(q, k, v, scale):
    """K1 in f32 with one TF32 product per f32 product: the operands of
    Q·Kᵀ and P·V rounded to TF32, the products (exact in f32) summed in f32.
    This is 'tf32x3' with its two small products dropped."""
    p = torch.softmax(tf32(q) @ tf32(k).transpose(-1, -2) * scale, dim=-1)
    return tf32(p) @ tf32(v)


def pair_tol(ref, label="K2"):
    """K2–K5 against their plain versions. A float32 output ('tf32x3'):
    TF32X3_TOL, absolute for K2's O and L (K1's gate), of max(1, max |ref|)
    for K3's Ȯ, K4's dQ and K5's dK and dV, sums over every key or query
    whose size follows the inputs'. In the CPU emulation of 3xTF32
    (tests/test_torch_port_tf32.py; one head over 1024 tokens at D =
    40–160, Sq ≠ Sk and probes folded, max |plain| about 1) three TF32
    products per f32 product land 2.4e-7–2.7e-6 from the references and
    one 1.5e-4–7.6e-4; on an H100 at the f32 path shapes (phases 1–2)
    three read 6.7e-7–3.8e-6 (K2, K4, K5) and one 1.2e-4–1.6e-3. Phases
    1–2 measure the one-product error and fail unless this gate lies below
    it. A bfloat16 output: two ulps of max |ref| (as K1). Dropping one
    64-key tile (K5: one 64-query tile) from the plain versions at these
    shapes moves the outputs by far more than any of them."""
    top = ref.float().abs().max().item()
    if ref.dtype == torch.float32:
        return TF32X3_TOL * (max(1.0, top) if label in ("K3", "K4", "K5") else 1.0)
    return 2 * torch.finfo(ref.dtype).eps * 2.0 ** math.floor(math.log2(top))


def one_tf32_backward(q, k, v, do, lse, delta, scale, block=512):
    """K4 and K5 in f32 with one TF32 product per f32 product, (dQ, dK,
    dV): the operands of Q·Kᵀ, dO·Vᵀ, dS·K, Pᵀ·dO and dSᵀ·Q rounded to
    TF32, the products (exact in f32) summed in f32, over key blocks; the
    cotangent may carry r times the primal's B·H. This is 'tf32x3' with its
    two small products dropped."""
    r = do.shape[0] // q.shape[0]
    q, k, v, lse = (x.repeat(r, *(1,) * (x.ndim - 1)) for x in (q, k, v, lse))
    dq, dk, dv = torch.zeros_like(do), torch.empty_like(k), torch.empty_like(v)
    for i in range(0, k.shape[1], block):
        kb, vb = k[:, i:i + block], v[:, i:i + block]
        p = torch.exp(tf32(q) @ tf32(kb).transpose(1, 2) * scale - lse[..., None])
        ds = p * (tf32(do) @ tf32(vb).transpose(1, 2) - delta[..., None])
        dq += tf32(ds) @ tf32(kb)
        dv[:, i:i + block] = tf32(p).transpose(1, 2) @ tf32(do)
        dk[:, i:i + block] = tf32(ds).transpose(1, 2) @ tf32(q) * scale
    return dq * scale, dk, dv


def one_tf32_tangent(q, k, v, dq, dk, dv, o, lse, scale, block=512):
    """K3 in f32 with one TF32 product per f32 product, Ȯ: the operands of
    Q·Kᵀ, Q̇·Kᵀ, Q·K̇ᵀ, (P∘Ṡ)·V and P·V̇ rounded to TF32, the products
    (exact in f32) summed in f32, over key blocks; the tangents may carry r
    times the primal's B·H. This is 'tf32x3' with its two small products
    dropped."""
    r = dq.shape[0] // q.shape[0]
    q, k, v, o, lse = (x.repeat(r, *(1,) * (x.ndim - 1)) for x in (q, k, v, o, lse))
    acc = torch.zeros_like(dq)
    rsum = torch.zeros(*dq.shape[:2], 1, device=dq.device)
    for i in range(0, k.shape[1], block):
        kb = tf32(k[:, i:i + block]).transpose(1, 2)
        p = torch.exp(tf32(q) @ kb * scale - lse[..., None])
        pds = p * (tf32(dq) @ kb + tf32(q) @ tf32(dk[:, i:i + block]).transpose(1, 2)) * scale
        acc += tf32(pds) @ tf32(v[:, i:i + block]) + tf32(p) @ tf32(dv[:, i:i + block])
        rsum += pds.sum(-1, keepdim=True)
    return acc - rsum * o


def rate(row, ops):
    """The row's achieved TFLOP/s on the function's operations ``ops`` (the
    bound's) and its bound's share of its time."""
    row["tflops"] = ops / row["ms"] / 1e9
    row["bound_frac"] = row["bound_ms"] / row["ms"]
    return (f"{row['design']}, {row['tflops']:.1f} TFLOP/s, "
            f"{100 * row['bound_frac']:.1f} % of the bound, host "
            f"{row['host_us']:.1f} µs per call")


def bound_ms(nbytes, ops, dtype):
    """The least time on an H100: the bytes at the HBM rate or the
    operations at the dtype's peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def k1_bound_ms(shape, dtype):
    """softmax(QKᵀ)V: each input read once and the output written once, or
    the two matmuls' 4·BH·S²·D operations."""
    bh, s, d = shape
    return bound_ms(4 * bh * s * d * torch.tensor([], dtype=dtype).element_size(),
                    4.0 * bh * s * s * d, dtype)


def pair_ops(label, bhp, r, s, d):
    """The operations K2–K5 must do with the primal at B·H = bhp and r
    probes: PAIR_OPS·(r·bhp)·S²·D less the primal's QKᵀ, which the r
    probes share, counted once per primal head: (PAIR_OPS − 2)·r·bhp·S²·D
    + 2·bhp·S²·D (K2, r = 1: 4·bhp·S²·D)."""
    return float((PAIR_OPS[label] - 2) * r * bhp + 2 * bhp) * s * s * d


def pair_bound_ms(label, bhp, r, s, d, dtype):
    """K2–K5 with the primal at B·H = bhp and r probes: bytes of each input
    read once and each output written once (primal q, k, v, o in the dtype,
    L and δ in f32), operations pair_ops."""
    e, bh = torch.tensor([], dtype=dtype).element_size(), r * bhp
    sd = s * d
    nbytes = {
        "K2": 4 * bhp * sd * e + 4 * bhp * s,               # q k v → o, L
        "K3": 4 * bhp * sd * e + 4 * bhp * s + 4 * bh * sd * e,  # + q̇ k̇ v̇ → ȯ
        "K4": 3 * bhp * sd * e + 4 * bhp * s + 2 * bh * sd * e + 4 * bh * s,
        "K5": 3 * bhp * sd * e + 4 * bhp * s + 3 * bh * sd * e + 4 * bh * s,
    }[label]
    return bound_ms(nbytes, pair_ops(label, bhp, r, s, d), dtype)


def phase_k1(fa):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for shape, dtype in K1_CASES:
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        scale = shape[-1] ** -0.5
        out = fa.flash_forward(q, k, v, scale)
        torch.cuda.synchronize()
        ref = fa.flash_forward_plain(q, k, v, scale)
        err = (out.float() - ref.float()).abs().max().item()
        design = fa.design("K1", shape[-1], dtype)
        tol = k1_tol(ref, dtype)
        row = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: fa.flash_forward(q, k, v, scale), 20),
            host_us=host_us(lambda: fa.flash_forward(q, k, v, scale)),
            plain_ms=cuda_ms(lambda: fa.flash_forward_plain(q, k, v, scale), 5),
            # 4-D (1, B·H, S, D): SDPA picks its fused kernels only for 4-D
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale), 20),
        )
        row["bound_ms"], row["bound_by"] = k1_bound_ms(shape, dtype)
        row["design"] = design
        rows[(shape, dtype)] = row
        if shape[-1] == 512:
            log(f"[k1] {shape} {str(dtype)[6:]}: sdpa served by " + served_by(
                lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=scale)))
        if design == "tf32x3":
            row["one_tf32_err"] = (one_tf32_forward(q, k, v, scale)
                                   - ref).abs().max().item()
            log(f"[k1] {shape} f32: one TF32 product per f32 product: max_abs_err "
                f"{row['one_tf32_err']:.3g} (must exceed the tol {tol:.3g})")
            if not row["one_tf32_err"] > tol:
                raise AssertionError(f"K1's tf32x3 gate {tol} does not part "
                                     f"three TF32 products from one at {shape}")
        log(f"[k1] {shape} {str(dtype)[6:]}: max_abs_err {err:.3g} (tol "
            f"{tol:.3g}) kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
            + rate(row, 4.0 * shape[0] * shape[1] ** 2 * shape[2]))
        if not err <= tol:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{shape} {dtype}: {err} > {tol}")
    return rows


def phase_pair(fa):
    """K2–K5 against their plain versions at the pullback's shapes
    (PAIR_CASES): K2 at the primal (B·H, S, D), K3–K5 with the tangents /
    cotangent batched over the case's probes against one primal, as the
    main path calls them; each checked launch counted on the design the
    rule gives, as the C entries count it; on 'tf32x3' the one-TF32-product
    error of each output above its gate."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator(device="cuda").manual_seed(2)
    sdpa = torch.ops.aten._scaled_dot_product_flash_attention
    sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    eff_bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
    rows = {}
    for bhp, s, d, r, dtypes, labels in PAIR_CASES:
        for dtype in dtypes:
            rnd = lambda n: torch.randn(n, s, d, device="cuda", generator=gen).to(dtype)
            q, k, v = rnd(bhp), rnd(bhp), rnd(bhp)
            dq, dk, dv, do = rnd(r * bhp), rnd(r * bhp), rnd(r * bhp), rnd(r * bhp)
            scale = d ** -0.5
            o, lse = fa.flash_forward_lse(q, k, v, scale)
            delta = (do.float() * o.float().repeat(r, 1, 1)).sum(-1)
            calls = {
                "K2": (lambda: fa.flash_forward_lse(q, k, v, scale),
                       lambda: fa.flash_forward_lse_plain(q, k, v, scale)),
                "K3": (lambda: fa.flash_tangent(q, k, v, dq, dk, dv, o, lse, scale),
                       lambda: fa.flash_tangent_plain(q, k, v, dq, dk, dv, o, lse,
                                                      scale)),
                "K4": (lambda: fa.flash_dq(q, k, v, do, lse, delta, scale),
                       lambda: fa.flash_dq_plain(q, k, v, do, lse, delta, scale)),
                "K5": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, scale),
                       lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta, scale)),
            }
            calls = {label: calls[label] for label in labels}
            library, library_calls = {}, {}
            q4, k4, v4 = (t.repeat(r, 1, 1)[None] for t in (q, k, v))
            # K3's yardstick: the tangent of SDPA along the probes' tangents
            # at the primal repeated per probe, torch.func.jvp. The fused
            # backends SDPA picks have no forward-mode rule, so it is timed on
            # the math backend (the one that has it), which holds B·H × S²
            # scores and their tangents: where one call over all of B·H does
            # not fit in the card's memory (B·H 250 over 4096 tokens), the
            # time is the sum of the fewest equal B·H chunks that fit
            if "K3" in labels:
                bh = r * bhp

                def sdpa_jvp(n=1):
                    step = bh // n
                    for i in range(0, bh, step):
                        sl = slice(i, i + step)
                        torch.func.jvp(
                            lambda a, b, c: F.scaled_dot_product_attention(
                                a, b, c, scale=scale),
                            (q4[:, sl], k4[:, sl], v4[:, sl]),
                            (dq[None, sl], dk[None, sl], dv[None, sl]))
                try:
                    sdpa_jvp()
                    default = "runs"
                except RuntimeError as e:
                    default = "raises: " + str(e).splitlines()[0]
                library["K3"] = None
                with sdpa_kernel(SDPBackend.MATH):
                    for n in (n for n in range(1, bh + 1) if bh % n == 0):
                        try:
                            library["K3"] = cuda_ms(lambda: sdpa_jvp(n), 5)
                            break
                        except torch.OutOfMemoryError:
                            torch.cuda.empty_cache()
                    served = (f"in {n} call(s) of B·H {bh // n}, served by "
                              f"{served_by(lambda: sdpa_jvp(n))}"
                              if library["K3"] is not None else
                              "does not fit in the card's memory at B·H 1")
                    library_calls["K3"] = n
                    log(f"[k3] ({bh}, {s}, {d}) {str(dtype)[6:]}: "
                        f"torch.func.jvp of SDPA on the math backend {served} (on "
                        f"SDPA's own choice it {default})")
            backward = {"K4", "K5"} & set(labels)
            # the flash SDPA ops take bf16 only, at head dims up to 256
            if dtype == torch.bfloat16 and d <= 256:
                library["K2"] = cuda_ms(lambda: sdpa(
                    q[None], k[None], v[None], 0.0, False, False, scale=scale), 20)
                if backward:
                    fwd4 = sdpa(q4, k4, v4, 0.0, False, False, scale=scale)
                    bwd_args = (do[None], q4, k4, v4, *fwd4[:6], 0.0, False, *fwd4[6:8])
                    library["K4"] = library["K5"] = cuda_ms(
                        lambda: sdpa_bwd(*bwd_args, scale=scale), 20)
            else:  # f32, and bf16 at D = 512: the memory-efficient SDPA ops
                # (output + logsumexp)
                try:
                    library["K2"] = cuda_ms(lambda: eff(
                        q[None], k[None], v[None], None, True, 0.0, False,
                        scale=scale), 20)
                except RuntimeError as e:  # e.g. a head dim it does not take
                    library["K2"] = None
                    log(f"[k2] ({bhp}, {s}, {d}) {str(dtype)[6:]}: the memory-efficient "
                        f"SDPA forward with logsumexp refuses it: {str(e).splitlines()[0]}")
                if backward:
                    out4, lse4, seed, offset = eff(q4, k4, v4, None, True, 0.0, False,
                                                   scale=scale)
                    bwd_args = (do[None], q4, k4, v4, None, out4, lse4, seed, offset,
                                0.0, [True, True, True, False], False)
                    library["K4"] = library["K5"] = cuda_ms(
                        lambda: eff_bwd(*bwd_args, scale=scale), 20)
            one_bwd = None
            for label, (kernel, plain) in calls.items():
                design = fa.design(label, d, dtype)
                n0 = fa.served(label, design)
                outs, refs = kernel(), plain()
                torch.cuda.synchronize()
                if fa.served(label, design) != n0 + 1:
                    raise AssertionError(f"{label} at ({bhp}, {s}, {d}) {dtype} was not "
                                         f"launched on {design}, the rule's design")
                outs = outs if isinstance(outs, tuple) else (outs,)
                refs = refs if isinstance(refs, tuple) else (refs,)
                errs = [((a.float() - b.float()).abs().max().item(), pair_tol(b, label))
                        for a, b in zip(outs, refs)]
                one_errs = []
                if design == "tf32x3":
                    # the gate must reject one TF32 product per f32 product
                    if label == "K2":
                        ones = (one_tf32_forward(q, k, v, scale),)
                    elif label == "K3":
                        ones = (one_tf32_tangent(q, k, v, dq, dk, dv, o, lse, scale),)
                    else:
                        one_bwd = one_bwd or one_tf32_backward(q, k, v, do, lse, delta, scale)
                        ones = one_bwd[:1] if label == "K4" else one_bwd[1:]
                    one_errs = [(one - ref).abs().max().item() for one, ref in zip(ones, refs)]
                    log(f"[{label.lower()}] ({bhp}, {s}, {d}) f32: one TF32 product "
                        f"per product reads " + ", ".join(
                            f"{one:.3g} (gate {tol:.3g})"
                            for one, (_, tol) in zip(one_errs, errs)))
                    if not all(one > tol for one, (_, tol) in zip(one_errs, errs)):
                        raise AssertionError(f"{label}'s tf32x3 gate passes one TF32 "
                                             f"product at ({bhp}, {s}, {d})")
                shape = (bhp if label == "K2" else r * bhp, s, d)
                row = dict(max_abs_err=max(e for e, _ in errs),
                           ms=cuda_ms(kernel, 20), host_us=host_us(kernel),
                           plain_ms=cuda_ms(plain, 3),
                           library_ms=library[label],
                           library_calls=library_calls.get(label, 1))
                if one_errs:
                    row["one_tf32_err"] = min(one_errs)
                rr = 1 if label == "K2" else r
                row["bound_ms"], row["bound_by"] = pair_bound_ms(
                    label, bhp, rr, s, d, dtype)
                row["design"] = design
                rows[(label, shape, dtype)] = row
                log(f"[{label.lower()}] {shape} {str(dtype)[6:]}: max_abs_err "
                    + ", ".join(f"{e:.3g} (tol {t:.3g})" for e, t in errs)
                    + f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
                    f"ms, library {row['library_ms'] or float('nan'):.4f} ms, bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}); "
                    + rate(row, pair_ops(label, bhp, rr, s, d)))
                if not all(e <= t for e, t in errs):
                    raise AssertionError(f"{label} disagrees with its plain "
                                         f"version at {shape} {dtype}: {errs}")
    return rows


def phase_compose(fa):
    """The pair's Functions under torch.func on the card, as the pullback
    composes them (primal fixed, probes vmapped), against the math path."""
    from torch.func import jvp, vjp, vmap

    from diffusion_pullback_tpu_torch.ops.attention import attention

    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(1, 1024, 10, 64, device="cuda", generator=gen)
    ts = torch.randn(PCA_RANK, *x.shape, device="cuda", generator=gen)
    f = lambda impl: (lambda y: attention(y, y * 0.5, torch.tanh(y), impl=impl))
    n0 = {w: getattr(fa, w).launches for _, w, _, _ in KERNELS.values()}
    tan = {i: vmap(lambda t: jvp(f(i), (x,), (t,))[1])(ts) for i in ("flash_jvp", "xla")}
    cot = {i: vmap(vjp(f(i), x)[1])(ts)[0] for i in ("flash", "xla")}
    torch.cuda.synchronize()
    launched = {w: getattr(fa, w).launches - n for w, n in n0.items()}
    for what, a, b in (("vmap(jvp)", tan["flash_jvp"], tan["xla"]),
                       ("vmap(vjp_fn)", cot["flash"], cot["xla"])):
        err, tol = (a - b).abs().max().item(), 1e-4 * max(1.0, b.abs().max().item())
        log(f"[compose] {what} at (1,1024,10,64) f32, pair vs math: max_abs_err "
            f"{err:.3g} (tol {tol:.3g})")
        if not err <= tol:
            raise AssertionError(f"{what} through the pair disagrees with the "
                                 f"math path: {err} > {tol}")
    want = {"flash_forward": 0, "flash_forward_lse": 2, "flash_tangent": 1,
            "flash_dq": 1, "flash_dkv": 1}
    log(f"[compose] launches {launched} (expected {want})")
    if launched != want:
        raise AssertionError("the composed pair did not launch its kernels once each")


def phase_unet_eps(fa, unet, dtype, eps_math=None):
    from diffusion_pullback_tpu_torch.models.layers import attn_impl_as

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(1, 4, 64, 64, device="cuda", generator=gen)
    ctx = torch.randn(1, 77, 1024, device="cuda", generator=gen)
    with torch.no_grad():
        n0 = fa.flash_forward.launches
        eps_flash = unet(x, 500.0, ctx).float()
        launches = fa.flash_forward.launches - n0
        with attn_impl_as(unet, "xla"):
            eps_this = unet(x, 500.0, ctx).float()
    if dtype == torch.float32:
        err = (eps_flash - eps_this).abs().max().item()
        scale = eps_this.abs().max().item()
        log(f"[unet] full-width SD 2.1-base eps f32, flash vs math: max_abs_err "
            f"{err:.3g} (max |eps| {scale:.3g}, tol 1e-4 relative), K1 launches "
            f"{launches}")
        if not (torch.isfinite(eps_flash).all() and err <= 1e-4 * scale):
            raise AssertionError("flash U-Net disagrees with the math path")
        if launches != 10:
            raise AssertionError(f"a U-Net call launched K1 {launches} times, not 10")
        return eps_this
    # bf16, the main path's U-Net dtype: the two paths round differently, so
    # each is held to the f32 math ε, and the flash path may stray from it at
    # most 1.5× as far (relative RMS) as the bf16 math path does
    rel = lambda e: (torch.linalg.norm(e - eps_math) / torch.linalg.norm(eps_math)).item()
    err_flash, err_math = rel(eps_flash), rel(eps_this)
    log(f"[unet] full-width SD 2.1-base eps bf16: relative RMS error against "
        f"f32 math, flash {err_flash:.4g}, math {err_math:.4g} (tol 1.5 × math "
        f"= {1.5 * err_math:.4g}); bf16 flash vs bf16 math max_abs_err "
        f"{(eps_flash - eps_this).abs().max().item():.3g}")
    if not (torch.isfinite(eps_flash).all() and err_flash <= 1.5 * err_math):
        raise AssertionError("bf16 flash U-Net strays from f32 further than "
                             "the bf16 math path")


def config1_smoke(unet, x0, v_init):
    """The config-1 smoke pipeline of scripts/make_goldens.py
    (compute_config1_smoke_artifacts) through the port's modules, on the
    device of ``unet``: an 8-step inversion and forward to grid index 2, the
    mid-tap pullback from ``v_init`` (4 probes, 3 iterations), a 4-step walk
    along v_0 and the finish. x0 is (1, S, S, 3); returns the golden's
    u_norms, s, vT and edit (in [0, 1]) as numpy arrays. On the CPU the
    tests hold it to tests/goldens/config1_smoke_*."""
    from diffusion_pullback_tpu_torch.experiments._common import to_nchw, to_nhwc
    from diffusion_pullback_tpu_torch.geometry import local_pullback
    from diffusion_pullback_tpu_torch.models import TapPoint
    from diffusion_pullback_tpu_torch.ops.schedule import (
        DiffusionSchedule, ddim_timestep_grid)
    from diffusion_pullback_tpu_torch.samplers.ddim_loop import ddim_forward, ddim_invert
    from diffusion_pullback_tpu_torch.samplers.guidance import x_space_guidance_scan

    dev = next(unet.parameters()).device
    sched, grid8, edit_idx = DiffusionSchedule.linear().to(dev), ddim_timestep_grid(8), 2
    t_edit = grid8.timesteps[edit_idx]
    eps = lambda q, t: to_nhwc(unet(to_nchw(q), t))
    x0 = x0.to(dev)
    with torch.no_grad():
        xt = ddim_forward(eps, ddim_invert(eps, x0, sched, grid8), sched, grid8,
                          end_idx=edit_idx)
    res = local_pullback(
        lambda z: to_nhwc(unet.encode(to_nchw(z), t_edit, TapPoint("mid", 0))),
        xt, pca_rank=4, min_iter=3, max_iter=3, atol=0.0, v_init=v_init.to(dev))
    with torch.no_grad():
        traj = x_space_guidance_scan(eps, xt, t_edit, res.vT[0].reshape(x0.shape),
                                     num_steps=4, edit_step=0.1, scale=0.1)
        x0_edit = ddim_forward(eps, traj[-1], sched, grid8, start_idx=edit_idx)
    host = lambda a: a.float().cpu().numpy()
    return {"u_norms": host(torch.linalg.norm(res.u.float(), dim=0)),
            "s": host(res.s), "vT": host(res.vT),
            "edit": host(torch.clamp(x0_edit * 0.5 + 0.5, 0.0, 1.0))}


def pullback_dist(res, ref):
    """Relative Frobenius distance between the rank-r pullback metrics
    Vᵀ diag(σ²) V of two results: blind to signs and to rotations inside a
    degenerate σ group, so it measures σ and the subspace together."""
    s2, r2 = res.s.double() ** 2, ref.s.double() ** 2
    c2 = (res.vT.double() @ ref.vT.double().T) ** 2
    cross = (s2[:, None] * r2[None, :] * c2).sum()
    d2 = (s2 ** 2).sum() + (r2 ** 2).sum() - 2 * cross
    return math.sqrt(max(d2.item(), 0.0) / (r2 ** 2).sum().item())


def phase_unet_pullback(unet, dtype, ref=None):
    """The mid-tap encoder pullback of the full-width U-Net: the fused pair
    ('flash_jvp' tangents, 'flash' cotangents) and the math path from the
    same probes, 3 iterations each."""
    from diffusion_pullback_tpu_torch.geometry import local_pullback
    from diffusion_pullback_tpu_torch.models import TapPoint
    from diffusion_pullback_tpu_torch.models.layers import attn_impl_as

    gen = torch.Generator(device="cuda").manual_seed(5)
    z = torch.randn(1, 4, 64, 64, device="cuda", generator=gen)
    ctx = torch.randn(1, 77, 1024, device="cuda", generator=gen)
    v0 = torch.linalg.qr(torch.randn(z.numel(), PCA_RANK, device="cuda",
                                     generator=gen))[0].T

    def enc(impl):
        def f(x):
            with attn_impl_as(unet, impl):
                return unet.encode(x, 500.0, ctx, TapPoint("mid"))
        return f

    kw = dict(pca_rank=PCA_RANK, min_iter=3, max_iter=3, atol=0.0, v_init=v0)
    out = {}
    for name, fn, fn_vjp in (("pair", enc("flash_jvp"), enc("flash")),
                             ("math", enc("xla"), None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = local_pullback(fn, z, fn_vjp=fn_vjp, **kw)
        torch.cuda.synchronize()
        log(f"[pullback] {str(dtype)[6:]} {name}: sigma "
            f"{out[name].s.tolist()}, {time.perf_counter() - t0:.3f} s")
    pair, math_ = out["pair"], out["math"]
    if dtype == torch.float32:
        srel = ((pair.s - math_.s).abs() / math_.s).max().item()
        cos = (pair.vT * math_.vT).sum(dim=1).abs()
        log(f"[pullback] f32 pair vs math: sigma max rel err {srel:.3g} (tol "
            f"1e-3), |cos| per direction {cos.tolist()} (tol ≥ 0.99)")
        if not (srel <= 1e-3 and cos.min().item() >= 0.99):
            raise AssertionError("the f32 fused-pair pullback disagrees with "
                                 "the math path")
        return math_
    # bf16: each held to the f32 math result; the pair may stray at most
    # 1.5× as far as the bf16 math pullback
    d_pair, d_math = pullback_dist(pair, ref), pullback_dist(math_, ref)
    log(f"[pullback] bf16 distance of the metric Vᵀσ²V from f32 math: pair "
        f"{d_pair:.4g}, math {d_math:.4g} (tol 1.5 × math = {1.5 * d_math:.4g})")
    if not (all(torch.isfinite(r.s).all() for r in out.values())
            and d_pair <= 1.5 * d_math):
        raise AssertionError("the bf16 fused-pair pullback strays from f32 "
                             "further than the bf16 math pullback")


@contextlib.contextmanager
def timed_launches(fa):
    """CUDA events around every kernel launch of the block, by (symbol,
    shape, dtype); the shape is q's for K1/K2, the tangents' or the
    cotangent's for K3–K5. The launch counts stay the wrappers' own."""
    events = collections.defaultdict(list)
    launch = fa._launch

    def timed(name, q, *args):
        key = args[0] if name in ("flash_fwd", "flash_fwd_lse") else args[3]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        launch(name, q, *args)
        end.record()
        events[(name, tuple(key.shape), key.dtype)].append((start, end))

    fa._launch = timed
    try:
        yield events
    finally:
        fa._launch = launch


def reset_launches(fa):
    for _, wrapper, _, _ in KERNELS.values():
        getattr(fa, wrapper).launches = 0


def drive(fa, fn):
    """One run of a main path: the launch counts set to 0 just before it,
    CUDA events around every launch. Returns (fn's result, seconds, peak
    memory in GB, launches by symbol as the wrappers count them, and
    {(symbol, shape, dtype): [launches, summed device ms]})."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fa)
    t0 = time.perf_counter()
    with timed_launches(fa) as events:
        out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {sym: getattr(fa, k[1]).launches for sym, k in KERNELS.items()}
    path = {key: [len(ev), sum(a.elapsed_time(b) for a, b in ev)]
            for key, ev in events.items()}
    return out, seconds, torch.cuda.max_memory_allocated() / 1e9, launches, path


def unet_k1(expected, batch, calls, dtype, at_4096=5, at_1024=5, heads=(5, 10),
            dims=(64, 64)):
    """K1 launches of ``calls`` U-Net passes at ``batch``: a whole SD
    2.1-base pass runs five 4096-token self-attentions of 5 heads of 64
    (down block 0, up block 3) and five 1024-token ones of 10 heads (down
    block 1, up block 2); SDXL_UNET, SD15_UNET, ADM_UNET and ADM128_UNET
    give the others' heads, head dims and counts; a partial pass gives its
    own counts."""
    expected[("flash_fwd", (heads[0] * batch, 4096, dims[0]), dtype)] += at_4096 * calls
    expected[("flash_fwd", (heads[1] * batch, 1024, dims[1]), dtype)] += at_1024 * calls


def walk_k1(expected, cfg, n_dir, dtype, **unet):
    """K1 launches of the x-space-guidance walk of ``n_dir`` directions
    (``cfg`` the driver's config): per micro-step the (null, edit) pair as
    one U-Net pass at batch 2·n_dir (xsg_pair_impl 'batch', the SD
    family's 'auto') or two at n_dir ('split', the uncond family's)."""
    if cfg.xsg_pair_impl == "split":
        unet_k1(expected, n_dir, 2 * cfg.x_space_guidance_num_step, dtype, **unet)
    else:
        unet_k1(expected, 2 * n_dir, cfg.x_space_guidance_num_step, dtype, **unet)


def pair_k2_k5(expected, dtype, iterations, layers, primal=1, shapes=PAIR_SHAPES,
               rank=PCA_RANK, remat=False):
    """K1–K5 launches of a fused-pair pullback of ``rank`` probes over a map
    that runs ``layers`` self-attentions at each of the primal ``shapes``
    (an int: that many at each; a tuple: one count per shape), at a primal
    batch ``primal``: one jvp per tangent pass (each iteration and the final
    u), each running K2 and K3; one vjp (K2) whose function runs K4 and K5
    once per iteration; K3–K5 with the probes folded into B·H. ``remat``
    (SDXL's, from build_sdxl: pullback_remat and remat_transformer): each
    cotangent pass takes its own vjp, whose forward runs each transformer
    block under no_grad (K1) and whose backward recomputes it (K2) before
    K4 and K5."""
    passes = iterations + 1
    counts = layers if isinstance(layers, tuple) else (layers,) * len(shapes)
    for (bh, s, d), layers in zip(shapes, counts):
        bhp = primal * bh
        folded = (rank * bhp, s, d)
        if remat:
            expected[("flash_fwd", (bhp, s, d), dtype)] += layers * iterations
        expected[("flash_fwd_lse", (bhp, s, d), dtype)] += layers * (
            passes + (iterations if remat else 1))
        expected[("flash_tangent", folded, dtype)] += layers * passes
        expected[("flash_dq", folded, dtype)] += layers * iterations
        expected[("flash_dkv", folded, dtype)] += layers * iterations


def covector_k2_k5(expected, dtype, vjps, layers=2, shapes=PAIR_SHAPES):
    """K2, K4 and K5 launches of ``vjps`` covector VJPs (Jᵀu, one cotangent)
    of the mid-tap encoder (``layers`` self-attentions at each of the
    primal ``shapes``)."""
    for shape in shapes:
        for sym in ("flash_fwd_lse", "flash_dq", "flash_dkv"):
            expected[(sym, shape, dtype)] += layers * vjps


def edit_k1(expected, edit, n_dir, frames, dtypes, unet=SD_UNET, vae_tokens=4096):
    """K1 launches of an SD-family edit run outside its direction: VAE
    encode, inversion and forward to the edit t at batch 1; the walk's
    (null, edit) pairs of every direction (walk_k1); the finish of every
    direction's frames as one batch; per direction the VAE decodes of its
    frames, decode_chunk of them per call (all at once when it is None; no
    classifier-free guidance: guidance_scale is 0). ``unet`` is the U-Net's
    K1 geometry (SD_UNET, SDXL_UNET), ``vae_tokens`` the VAE's mid-block
    tokens (4096 at 512 px, 16 384 at 1024 px)."""
    cfg, (unet_dtype, vae_dtype) = edit.cfg, dtypes
    unet_k1(expected, 1, (cfg.inv_steps - 2) + edit.edit_t_idx, unet_dtype, **unet)
    walk_k1(expected, cfg, n_dir, unet_dtype, **unet)
    unet_k1(expected, n_dir * frames, edit.fwd_grid.num_steps - edit.edit_t_idx,
            unet_dtype, **unet)
    expected[("flash_fwd", (1, vae_tokens, 512), vae_dtype)] += 1
    chunk = cfg.decode_chunk or frames
    for start in range(0, frames, chunk):
        expected[("flash_fwd", (min(chunk, frames - start), vae_tokens, 512),
                  vae_dtype)] += n_dir


def check_launches(tag, launches, path, expected):
    """Log each (kernel, shape) of a run with its launches, the expected
    count and its device time; True when the counts by shape equal the
    expected ones and each kernel's total matches its wrapper's count."""
    for (sym, shape, dtype), (n, ms) in sorted(path.items(), key=lambda kv: -kv[1][1]):
        log(f"[{tag}] {KERNELS[sym][0]} at {shape} {str(dtype)[6:]}: {n} launches "
            f"(expected {expected[(sym, shape, dtype)]}), {ms:.3f} ms on the device")
    totals = {sym: sum(n for (s, _, _), n in expected.items() if s == sym)
              for sym in KERNELS}
    return ({k: n for k, (n, _) in path.items()} == +expected
            and launches == totals)


def read_events(edit, start=0):
    with open(edit.log.path) as f:
        return [json.loads(line) for line in f][start:]


def log_stages(tag, events):
    for e in events:
        if "seconds" in e:
            extra = {k: v for k, v in e.items() if k not in ("ts", "event", "seconds")}
            log(f"[{tag}] stage {e['event']}: {e['seconds']:.3f} s {extra}")


def by_design(fa, paths, head_dim=False):
    """(symbol, design) → (its heaviest (symbol, shape, dtype), launches,
    summed device ms) over the runs' path dicts; with ``head_dim`` keyed
    (symbol, design, head dim)."""
    total = collections.defaultdict(lambda: [0, 0.0])
    for path in paths:
        for key, (n, ms) in path.items():
            total[key][0] += n
            total[key][1] += ms
    out = {}
    for key, (n, ms) in total.items():
        sym, shape, dtype = key
        kd = (sym, fa.design(KERNELS[sym][0], shape[-1], dtype)) + (
            (shape[-1],) if head_dim else ())
        heaviest, n0, ms0 = out.get(kd, (key, 0, 0.0))
        if ms > total[heaviest][1]:
            heaviest = key
        out[kd] = (heaviest, n0 + n, ms0 + ms)
    return out


def timed_pullback(edit, zt, impl, what):
    """One compute_local_basis with ``impl``: seconds and peak memory."""
    from diffusion_pullback_tpu_torch.models import TapPoint

    edit.cfg.pullback_attn_impl = impl
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = edit.compute_local_basis(zt, edit.fwd_grid.timesteps[edit.edit_t_idx],
                                   TapPoint("mid", 0), PCA_RANK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[edit] pullback {what}: {seconds:.3f} s, peak memory {peak:.2f} GB, "
        f"{res.iterations} iterations, sigma {res.s.tolist()}")
    return seconds, peak


def phase_edit(fa):
    import numpy as np
    from PIL import Image

    from diffusion_pullback_tpu_torch import main as port_main
    from diffusion_pullback_tpu_torch.experiments import BasisCache

    shutil.rmtree(OUT, ignore_errors=True)
    args = port_main.parse_args([
        "--note", "chip_smoke", "--result_folder", OUT,
        "--for_steps", "10", "--inv_steps", "10", "--edit_t", "0.5",
        "--pca_rank", str(PCA_RANK), "--x_space_guidance_num_step", "2",
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
    if cfg.pullback_attn_impl != "flash":
        raise AssertionError("the CLI's default pullback on CUDA is not the pair")

    vis_num, vis_num_pc = 2, 1
    names, seconds, peak_gb, launches, path = drive(
        fa, lambda: edit.run_edit_local_encoder_pullback_zt(
            idx=0, pca_rank=PCA_RANK, vis_num=vis_num, vis_num_pc=vis_num_pc))
    events = read_events(edit)
    log_stages("edit", events)
    pullback = [e for e in events if e["event"] == "sd_local_pullback"][-1]
    iterations = pullback["iterations"]

    n_dir = 2 * vis_num_pc
    stride = max(1, (cfg.x_space_guidance_num_step + 1) // vis_num)
    frames = len(range(0, cfg.x_space_guidance_num_step + 1, stride))
    dtypes = (next(edit.unet.parameters()).dtype, next(edit.vae.parameters()).dtype)
    expected = collections.Counter()
    edit_k1(expected, edit, n_dir, frames, dtypes)
    # the pullback: two self-attentions at each primal shape (mid tap)
    pair_k2_k5(expected, dtypes[0], iterations, layers=2)
    launches_by_shape = check_launches("edit", launches, path, expected)
    kernel_ms = {sym: sum(ms for (s, _, _), (_, ms) in path.items() if s == sym)
                 for sym in KERNELS}
    designs = by_design(fa, [path])
    expected_total = {sym: sum(n for (s, _, _), n in expected.items() if s == sym)
                      for sym in KERNELS}

    basis_files = os.listdir(cfg.basis_folder)
    u, s, vT = load_basis(os.path.join(cfg.basis_folder, basis_files[0]))
    log(f"[edit] main path {seconds:.2f} s, sigma {s.tolist()}, peak memory "
        f"{peak_gb:.2f} GB, pullback {pullback['seconds']:.3f} s (encoder "
        f"{pullback['encoder']}, {iterations} iterations)")
    for sym, (label, *_) in KERNELS.items():
        log(f"[edit] {label}: {launches[sym]} launches (expected "
            f"{expected_total[sym]}), {kernel_ms[sym]:.2f} ms on the device "
            f"({100 * kernel_ms[sym] / 1e3 / seconds:.2f} % of the path)")
        log(f"[edit] {label} by design: " + ", ".join(
            f"{dsg} {n} launches, {ms:.2f} ms" for (of, dsg), (_, n, ms)
            in sorted(designs.items()) if of == sym))

    finite = [e for e in events if e["event"] == "sd_decode_and_save"]
    checks = {
        "two PNGs written": len(names) == n_dir and all(
            Image.open(os.path.join(cfg.result_folder, n + ".png")).size
            == (512 * frames, 512) for n in names),
        "edited latents and images finite": bool(finite and finite[-1]["finite"]),
        "basis finite, expected shapes": (
            u.shape == (8 * 8 * 1280, PCA_RANK) and vT.shape == (PCA_RANK, 64 * 64 * 4)
            and all(np.isfinite(a).all() for a in (u, s, vT)) and (s > 0).all()),
        "pullback through the fused pair": pullback["encoder"] == "flashpair",
        "launch counts": launches == expected_total and all(launches.values()),
        "launches by shape": launches_by_shape,
    }
    for what, ok in checks.items():
        log(f"[edit] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("main path checks failed")

    # the pullback again in this process at a latent of the same shape:
    # the pair warm, then the math path (its first run here) and again warm
    zt = torch.randn(1, 64, 64, 4, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(3))
    timed_pullback(edit, zt, "flash", "fused pair, warm")
    timed_pullback(edit, zt, "xla", "math path, first in this process")
    timed_pullback(edit, zt, "xla", "math path, warm")
    return path


def pair_vs_math(tag, out, ref=None, phase="sd6"):
    """Phase 3's gates for a pullback run on the pair and on the math path
    from the same probes: in f32 σ within 1e-3 and |cos| ≥ 0.99 per
    direction; in bf16 each held to the f32 math result, the pair at most
    1.5× as far (metric distance) as the bf16 math path. Returns the f32
    math result (the reference) or None."""
    pair, math_ = out["flash"], out["xla"]
    srel = ((pair.s - math_.s).abs() / math_.s).max().item()
    cos = (pair.vT * math_.vT).sum(dim=1).abs()
    log(f"[{phase}] {tag} pair vs math: sigma pair {pair.s.tolist()}, math "
        f"{math_.s.tolist()}, max rel err {srel:.3g}, |cos| per direction "
        f"{cos.tolist()}, metric distance {pullback_dist(pair, math_):.4g}")
    if ref is None:
        if not (srel <= 1e-3 and cos.min().item() >= 0.99):
            raise AssertionError(f"the f32 {tag} pullback on the pair disagrees "
                                 f"with the math path")
        return math_
    d_pair, d_math = pullback_dist(pair, ref), pullback_dist(math_, ref)
    log(f"[{phase}] {tag} bf16 distance of the metric from f32 math: pair "
        f"{d_pair:.4g}, math {d_math:.4g} (tol 1.5 × math = {1.5 * d_math:.4g})")
    if not (all(torch.isfinite(r.s).all() for r in out.values())
            and d_pair <= 1.5 * d_math):
        raise AssertionError(f"the bf16 {tag} pullback on the pair strays from "
                             f"f32 further than the bf16 math path")
    return None


def phase_sd_rest(fa):
    """Phase 6: the rest of the SD 2.1-base edit path at full width through
    the CLI's builder, with the with-prompt script's values (edit prompt
    'sitting dog', CFG inside the JVP at 7.5, edit t 0.7) at 10/10 steps, 2
    walk steps, pca_rank 2, pullback 1–3 iterations: (a) the encoder-pullback
    edit with CFG in the JVP; (c) the decoder- and x̂₀-pullback edits; (d)
    the text-driven edit; (e) the walk and the finish under DeepCache; (f)
    run_DDIMforward; each with its K1–K5 launches by shape held to the count
    the code gives; then (b) the CFG and decoder pullbacks on the pair
    against the math path from the same probes, f32 and bf16. Returns the
    path dicts of the runs."""
    import numpy as np
    from PIL import Image

    from diffusion_pullback_tpu_torch import main as port_main
    from diffusion_pullback_tpu_torch.experiments import BasisCache
    from diffusion_pullback_tpu_torch.experiments._common import to_nchw, to_nhwc
    from diffusion_pullback_tpu_torch.models import TapPoint
    from diffusion_pullback_tpu_torch.samplers.deepcache import (
        ddim_forward_deepcache_cond)
    from diffusion_pullback_tpu_torch.samplers.guidance import (
        x_space_guidance_scan_deepcache)

    out = os.path.join(OUT, "sd_rest")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    args = port_main.parse_args([
        "--note", "chip_smoke", "--result_folder", out, "--for_steps", "10",
        "--inv_steps", "10", "--edit_t", "0.7", "--pca_rank", str(PCA_RANK),
        "--x_space_guidance_num_step", "2", "--edit_prompt", "sitting dog",
        "--pullback_guidance_scale", "7.5"])
    t0 = time.perf_counter()
    edit = port_main.build_sd(args)
    cfg = edit.cfg
    cfg.pullback_min_iter, cfg.pullback_max_iter = 1, 3
    cfg.basis_folder = os.path.join(out, "inputs")
    edit.cache = BasisCache(cfg.basis_folder)
    dtypes = (next(edit.unet.parameters()).dtype, next(edit.vae.parameters()).dtype)
    unet_dtype = dtypes[0]
    log(f"[sd6] built the SD 2.1-base driver in {time.perf_counter() - t0:.1f} s "
        f"(U-Net {unet_dtype}, pullback attn {cfg.pullback_attn_impl}, pullback "
        f"guidance {cfg.pullback_guidance_scale}, edit t index {edit.edit_t_idx})")
    vis_num, vis_num_pc = 2, 1
    n_dir = 2 * vis_num_pc
    stride = max(1, (cfg.x_space_guidance_num_step + 1) // vis_num)
    frames = len(range(0, cfg.x_space_guidance_num_step + 1, stride))
    paths, checks = [], {}

    def run(tag, fn, expected_fn):
        """Drive one run; check its launches by shape and its PNGs."""
        start = len(read_events(edit))
        names, seconds, peak, launches, path = drive(fa, fn)
        events = read_events(edit, start)
        log_stages(f"sd6 {tag}", events)
        expected = collections.Counter()
        expected_fn(expected, events)
        checks[f"({tag}) launches by shape"] = check_launches(
            f"sd6 {tag}", launches, path, expected)
        log(f"[sd6] ({tag}) {seconds:.2f} s, peak memory {peak:.2f} GB, launches "
            + ", ".join(f"{KERNELS[k][0]} {n}" for k, n in launches.items()))
        saved = [e for e in events if e["event"] == "sd_decode_and_save"]
        if isinstance(names, list):
            checks[f"({tag}) PNGs written, finite"] = bool(
                saved and saved[-1]["finite"]) and all(
                Image.open(os.path.join(cfg.result_folder, n + ".png")).size
                == (512 * frames, 512) for n in names)
        paths.append(path)
        return names, events

    def last(events, name):
        return [e for e in events if e["event"] == name][-1]

    # (a) the encoder pullback with CFG inside the JVP: the 2·B primal
    def exp_a(expected, events):
        edit_k1(expected, edit, n_dir, frames, dtypes)
        pair_k2_k5(expected, unet_dtype, last(events, "sd_local_pullback")["iterations"],
                   layers=2, primal=2)

    _, events = run("a", lambda: edit.run_edit_local_encoder_pullback_zt(
        idx=0, pca_rank=PCA_RANK, vis_num=vis_num, vis_num_pc=vis_num_pc), exp_a)
    basis = os.listdir(cfg.basis_folder)
    checks["(a) encoder flashpair_cfg7.5"] = (
        last(events, "sd_local_pullback")["encoder"] == "flashpair_cfg7.5")
    checks["(a) basis name ends -cfg7.5"] = (
        len(basis) == 1 and os.path.splitext(basis[0])[0].endswith("-cfg7.5"))
    z = dict(zip(("u", "s", "vT"), load_basis(os.path.join(cfg.basis_folder, basis[0]))))
    checks["(a) basis finite, expected shapes"] = (
        z["u"].shape == (8 * 8 * 1280, PCA_RANK)
        and z["vT"].shape == (PCA_RANK, 64 * 64 * 4)
        and all(np.isfinite(z[k]).all() for k in ("u", "s", "vT")))

    # (c) the decoder and x̂₀ pullbacks: the state from one forward to the
    # mid tap (K1), the pair through the decode (three self-attentions at
    # each length, up blocks 2 and 3), one Jᵀu per direction pair
    for x0 in (False, True):
        def exp_c(expected, events):
            edit_k1(expected, edit, n_dir, frames, dtypes)
            unet_k1(expected, 1, 1, unet_dtype, at_4096=2, at_1024=2)
            pair_k2_k5(expected, unet_dtype,
                       last(events, "sd_decoder_pullback")["iterations"], layers=3)
            covector_k2_k5(expected, unet_dtype, vis_num_pc)

        run("c x0" if x0 else "c eps", lambda: edit.run_edit_local_decoder_pullback_zt(
            idx=0, pca_rank=PCA_RANK, vis_num=vis_num, vis_num_pc=vis_num_pc,
            x0_pullback=x0), exp_c)

    # (d) the text-driven direction: Δh from two forwards to the mid tap,
    # one Jᵀ Δh
    def exp_d(expected, events):
        edit_k1(expected, edit, 2, frames, dtypes)
        unet_k1(expected, 1, 2, unet_dtype, at_4096=2, at_1024=2)
        covector_k2_k5(expected, unet_dtype, 1)

    run("d", lambda: edit.run_edit_text_driven_direction(idx=0, vis_num=vis_num), exp_d)

    # (e) DeepCache on the walk and the finish at the edit t, 2 directions:
    # interval 1 through the DeepCache samplers against the plain path,
    # then the driver at walk interval 2 and finish interval 3
    gen = torch.Generator(device="cuda").manual_seed(6)
    zt = torch.randn(1, 64, 64, 4, device="cuda", generator=gen)
    vks = torch.randn(n_dir, 64, 64, 4, device="cuda", generator=gen)
    vks = vks / torch.linalg.norm(vks.flatten(1), dim=1)[:, None, None, None]
    t_edit = edit.fwd_grid.timesteps[edit.edit_t_idx]
    steps = cfg.x_space_guidance_num_step
    finish_steps = edit.fwd_grid.num_steps - edit.edit_t_idx
    walk_kw = dict(num_steps=steps, edit_step=cfg.x_space_guidance_edit_step,
                   scale=cfg.x_space_guidance_scale)

    def select(traj):
        sel = traj[::stride].transpose(0, 1)
        return sel.reshape(-1, *sel.shape[2:])

    def exp_e(walk_interval, finish_interval):
        def fn(expected, events):
            for i in range(steps):
                full = i % walk_interval == 0
                unet_k1(expected, 2 * n_dir, 1, unet_dtype, 5, 5 if full else 0)
            for i in range(finish_steps):
                full = i % finish_interval == 0
                unet_k1(expected, n_dir * frames, 1, unet_dtype, 5, 5 if full else 0)
        return fn

    def walk_and_finish():
        walk = edit._guidance_walk(zt, vks, t_edit)
        return walk, edit._finish_forward(select(walk))

    timing = {}
    for itv in ((0, 0), (2, 3)):
        cfg.guidance_deepcache_interval, cfg.edit_deepcache_interval = itv
        tag = "e plain" if itv == (0, 0) else "e deepcache"
        start = len(read_events(edit))
        (walk, z0), seconds, peak, launches, path = drive(fa, walk_and_finish)
        events = read_events(edit, start)
        expected = collections.Counter()
        exp_e(*(max(1, i) for i in itv))(expected, events)
        checks[f"({tag}) launches by shape"] = check_launches(
            f"sd6 {tag}", launches, path, expected)
        paths.append(path)
        timing[tag] = (walk, z0, seconds, peak)
        log(f"[sd6] ({tag}) walk interval {itv[0]}, finish interval {itv[1]}: walk + "
            f"finish {seconds:.3f} s, peak memory {peak:.2f} GB")
    cfg.guidance_deepcache_interval = cfg.edit_deepcache_interval = 0
    walk, z0 = timing["e plain"][:2]
    with torch.no_grad():
        walk1 = x_space_guidance_scan_deepcache(
            *edit._deepcache_walk_fns(), zt.expand(n_dir, -1, -1, -1), t_edit, vks,
            interval=1, **walk_kw)
        z01 = to_nhwc(ddim_forward_deepcache_cond(
            edit.unet, to_nchw(select(walk)), edit.for_prompt_emb, edit.schedule,
            edit.fwd_grid, interval=1, start_idx=edit.edit_t_idx))
    torch.cuda.synchronize()
    diff = lambda a, b: (a.float() - b.float()).abs().max().item()
    log(f"[sd6] (e) DeepCache interval 1 against the plain path: walk max_abs_err "
        f"{diff(walk1, walk):.3g}, finish {diff(z01, z0):.3g} (must be 0)")
    checks["(e) interval 1 identical to the plain walk"] = torch.equal(walk1, walk)
    checks["(e) interval 1 identical to the plain finish"] = torch.equal(z01, z0)
    walk_dc, z0_dc = timing["e deepcache"][:2]
    rel = lambda a, b: (torch.linalg.norm((a - b).float()) / torch.linalg.norm(
        b.float())).item()
    log(f"[sd6] (e) DeepCache (walk 2, finish 3) against the plain path: walk "
        f"relative error {rel(walk_dc[1:] - zt, walk[1:] - zt):.4g} (of the walk's "
        f"displacement), finished latents relative error {rel(z0_dc, z0):.4g}; "
        f"seconds {timing['e deepcache'][2]:.3f} against {timing['e plain'][2]:.3f}")
    checks["(e) DeepCache output finite"] = bool(
        torch.isfinite(walk_dc).all() and torch.isfinite(z0_dc).all())

    # (f) run_DDIMforward: 5 samples through the whole grid, one VAE decode
    def exp_f(expected, events):
        unet_k1(expected, 5, edit.fwd_grid.num_steps, unet_dtype)
        expected[("flash_fwd", (5, 4096, 512), dtypes[1])] += 1

    grid_png = os.path.join(out, "DDIMforward.png")
    imgs, _ = run("f", lambda: edit.run_DDIMforward(num_samples=5, save_as=grid_png),
                  exp_f)
    checks["(f) 5-image grid finite"] = (
        imgs.shape == (5, 512, 512, 3) and bool(np.isfinite(imgs).all())
        and Image.open(grid_png).size == (5 * 512, 512))

    # (b) the CFG and decoder pullbacks, pair against math, from the same
    # probes (the driver's seeded ones), 3 iterations, f32 then bf16
    cfg.pullback_min_iter = cfg.pullback_max_iter = 3
    cfg.pullback_atol = 0.0
    zb = torch.randn(1, 64, 64, 4, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(7))
    ref = {}
    for dtype in (torch.float32, torch.bfloat16):
        edit.unet.to(dtype)   # the same weights, bf16-valued either way
        for what, compute in (("CFG", edit.compute_local_basis),
                              ("decoder", edit.compute_local_decoder_basis)):
            res = {}
            for impl in ("flash", "xla"):
                cfg.pullback_attn_impl = impl
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[impl] = compute(zb, t_edit, TapPoint("mid"), PCA_RANK)
                torch.cuda.synchronize()
                log(f"[sd6] (b) {what} pullback {str(dtype)[6:]} {impl}: "
                    f"{time.perf_counter() - t0:.3f} s")
            tag = f"{what} {str(dtype)[6:]}"
            if dtype == torch.float32:
                ref[what] = pair_vs_math(tag, res)
            else:
                pair_vs_math(tag, res, ref[what])
    cfg.pullback_attn_impl = "flash"

    for what, ok in checks.items():
        log(f"[sd6] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("phase 6 checks failed")
    return paths


@contextlib.contextmanager
def stage_peaks(edit):
    """Each driver stage's peak memory in GB (the card's peak counter reset
    at the stage's start), as {event: [GB, ...]}; before each reset the
    peak so far is kept under 'overall', so its max is the run's peak."""
    peaks = collections.defaultdict(list)
    real = edit._stage

    @contextlib.contextmanager
    def stage(event, **fields):
        torch.cuda.synchronize()
        peaks["overall"].append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        with real(event, **fields) as f:
            yield f
            torch.cuda.synchronize()
            peaks[event].append(torch.cuda.max_memory_allocated() / 1e9)

    edit._stage = stage
    try:
        yield peaks
    finally:
        del edit._stage


def named(events, name):
    return [e for e in events if e["event"] == name]


def checked_run(fa, prefix, tag, drv, fn, expected_fn, checks, paths):
    """Drive one run of the driver ``drv`` with each stage's peak memory;
    hold its launches by shape to expected_fn(expected, the run's events)
    under checks[f"({tag}) launches by shape"] and append its path dict to
    ``paths``. Returns (fn's result, its events, stage peaks, seconds)."""
    start = len(read_events(drv))
    with stage_peaks(drv) as peaks:
        res, seconds, peak, launches, path = drive(fa, fn)
    events = read_events(drv, start)
    for e in events:
        if "seconds" in e:
            extra = {k: v for k, v in e.items() if k not in ("ts", "event", "seconds")}
            log(f"[{prefix} {tag}] stage {e['event']}: {e['seconds']:.3f} s, peak "
                f"memory {max(peaks[e['event']]):.2f} GB {extra}")
    expected = collections.Counter()
    expected_fn(expected, events)
    checks[f"({tag}) launches by shape"] = check_launches(
        f"{prefix} {tag}", launches, path, expected)
    log(f"[{prefix}] ({tag}) {seconds:.2f} s, peak memory "
        f"{max([peak] + [g for v in peaks.values() for g in v]):.2f} GB, launches "
        + ", ".join(f"{KERNELS[k][0]} {n}" for k, n in launches.items()))
    paths.append(path)
    return res, events, peaks, seconds


def phase_sdxl(fa):
    """Phase 7: the SDXL-1024 edit path at full width through the CLI's
    builder (sdxl_base_unet in bf16, both text towers and the 1024 px VAE in
    f32, --attn_impl flash, the fused-pair pullback, decode_chunk 1), the
    bundled example images, edit t 0.5, 10/10 steps, pca_rank 2, pullback
    1–3 iterations, 2 walk steps, 2 directions × 3 frames; its K1–K5
    launches by shape held to the count the code gives; each stage's
    seconds and peak memory; then the pullback at pca_rank 8 with the CLI's
    chunking and unchunked. Returns the path dict of the run."""
    import numpy as np
    from PIL import Image

    from diffusion_pullback_tpu_torch import main as port_main
    from diffusion_pullback_tpu_torch.experiments import BasisCache
    from diffusion_pullback_tpu_torch.models import TapPoint

    out = os.path.join(OUT, "sdxl")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    flags = ["--note", "chip_smoke", "--model_name", port_main.SDXL_MODEL,
             "--result_folder", out, "--dataset_name", "Examples", "--for_steps", "10",
             "--inv_steps", "10", "--edit_t", "0.5", "--x_space_guidance_num_step", "2",
             "--edit_prompt", "a photo of a tree"]
    args = port_main.parse_args(flags + ["--pca_rank", str(PCA_RANK)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    edit = port_main.build_sdxl(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = edit.cfg
    cfg.pullback_min_iter, cfg.pullback_max_iter = 1, 3
    cfg.basis_folder = os.path.join(out, "inputs")
    edit.cache = BasisCache(cfg.basis_folder)
    models = {"U-Net": edit.unet, "VAE": edit.vae, "CLIP-L": edit.text_model,
              "bigG": edit.text_model_2}
    dtypes = (next(edit.unet.parameters()).dtype, next(edit.vae.parameters()).dtype)
    log(f"[sdxl] built the SDXL driver in {build_s:.1f} s (models built and drawn "
        f"on the card, prompts embedded), peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; " + ", ".join(
            f"{k} {sum(p.numel() for p in m.parameters())} parameters "
            f"{next(m.parameters()).dtype}" for k, m in models.items())
        + f"; attn {edit.unet.config.attn_impl}, pullback attn "
        f"{cfg.pullback_attn_impl}, pullback chunk {cfg.pullback_chunk_size}, "
        f"decode chunk {cfg.decode_chunk}, VAE scaling {edit.vae.config.scaling_factor}, "
        f"dataset {type(edit.dataset).__name__} of {len(edit.dataset)}")

    vis_num, vis_num_pc = 2, 1
    n_dir = 2 * vis_num_pc
    stride = max(1, (cfg.x_space_guidance_num_step + 1) // vis_num)
    frames = len(range(0, cfg.x_space_guidance_num_step + 1, stride))
    with stage_peaks(edit) as peaks:
        names, seconds, peak_gb, launches, path = drive(
            fa, lambda: edit.run_edit_local_encoder_pullback_zt(
                idx=0, pca_rank=PCA_RANK, vis_num=vis_num, vis_num_pc=vis_num_pc))
    peak_gb = max([peak_gb] + [g for v in peaks.values() for g in v])
    events = read_events(edit)
    for e in events:
        if "seconds" in e:
            extra = {k: v for k, v in e.items() if k not in ("ts", "event", "seconds")}
            pk = peaks.get(e["event"])
            log(f"[sdxl] stage {e['event']}: {e['seconds']:.3f} s, peak memory "
                + (f"{max(pk):.2f} GB" if pk else "not measured (built before)")
                + f" {extra}")
    pullback = [e for e in events if e["event"] == "sd_local_pullback"][-1]
    expected = collections.Counter()
    edit_k1(expected, edit, n_dir, frames, dtypes, unet=SDXL_UNET, vae_tokens=16384)
    pair_k2_k5(expected, dtypes[0], pullback["iterations"], SDXL_PAIR[1],
               shapes=SDXL_PAIR[0], remat=True)
    launches_by_shape = check_launches("sdxl", launches, path, expected)
    for (sym, dsg), (_, n, ms) in sorted(by_design(fa, [path]).items()):
        log(f"[sdxl] {KERNELS[sym][0]} on {dsg}: {n} launches, {ms:.2f} ms on the "
            f"device ({100 * ms / 1e3 / seconds:.2f} % of the path)")
    basis = os.listdir(cfg.basis_folder)
    u, s, vT = load_basis(os.path.join(cfg.basis_folder, basis[0]))
    log(f"[sdxl] main path {seconds:.2f} s, peak memory {peak_gb:.2f} GB, sigma "
        f"{s.tolist()}, pullback {pullback['seconds']:.3f} s (encoder "
        f"{pullback['encoder']}, {pullback['iterations']} iterations)")
    saved = [e for e in events if e["event"] == "sd_decode_and_save"]
    checks = {
        "two PNGs of 3 frames at 1024 px": len(names) == n_dir and all(
            Image.open(os.path.join(cfg.result_folder, n + ".png")).size
            == (1024 * frames, 1024) for n in names),
        "edited latents and images finite": bool(saved and saved[-1]["finite"]),
        "basis finite, expected shapes": (
            u.shape == (32 * 32 * 1280, PCA_RANK) and vT.shape == (PCA_RANK, 128 * 128 * 4)
            and all(np.isfinite(a).all() for a in (u, s, vT)) and (s > 0).all()),
        "pullback through the fused pair": pullback["encoder"] == "flashpair",
        "remat on, as the JAX CLI's SDXL": cfg.pullback_remat and all(
            m.remat for m in edit.unet.modules() if hasattr(m, "remat")),
        "every kernel launched": all(launches.values()),
        "launches by shape": launches_by_shape,
    }

    # the pullback at BASELINE config 5's rank, at a latent of the path's
    # shape: with the CLI's chunking for it (one probe per pass, the JAX
    # CLI's choice for a 16 GB chip), then all 8 probes in one batch; one
    # power iteration each, as they measure the cost of the chunking per
    # pass, not convergence
    log(f"[sdxl] pullback at pca_rank 2 (the main path, unchunked): "
        f"{pullback['seconds']:.3f} s, {pullback['iterations']} iterations, peak "
        f"memory {max(peaks['sd_local_pullback']):.2f} GB")
    zt = torch.randn(1, 128, 128, 4, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(8))
    rank8 = {}
    cfg.pullback_max_iter = 1
    for chunk in (port_main.sdxl_pullback_chunk(
            port_main.parse_args(flags + ["--pca_rank", "8"])), None):
        cfg.pullback_chunk_size = chunk
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rank8[chunk] = edit.compute_local_basis(
            zt, edit.fwd_grid.timesteps[edit.edit_t_idx], TapPoint("mid", 0), 8)
        torch.cuda.synchronize()
        log(f"[sdxl] pullback at pca_rank 8, chunk {chunk}: "
            f"{time.perf_counter() - t0:.3f} s, {rank8[chunk].iterations} iterations, "
            f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, sigma "
            f"{rank8[chunk].s.tolist()}")
    checks["rank-8 pullbacks finite"] = all(
        bool(torch.isfinite(r.s).all() and torch.isfinite(r.vT).all())
        for r in rank8.values())
    for what, ok in checks.items():
        log(f"[sdxl] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("phase 7 checks failed")
    return path


def golden_gates(art, ref):
    """tests/test_golden_config1.py's gates of ``art`` against ``ref``: σ and
    the u column norms to rtol 1e-3, the principal cosines of each group of
    near-equal σ (gaps under 5 % of σ_0) ≥ 0.99, the edit's PSNR ≥ 35 dB.
    Returns {gate: (value, passed)}."""
    import numpy as np

    s = ref["s"]
    groups, cur = [], [0]
    for i in range(1, len(s)):
        if (s[i - 1] - s[i]) / max(s[0], 1e-12) < 0.05:
            cur.append(i)
        else:
            groups, cur = groups + [cur], [i]
    groups.append(cur)
    cos = min(np.linalg.svd(np.linalg.qr(art["vT"][g].T)[0].T
                            @ np.linalg.qr(ref["vT"][g].T)[0], compute_uv=False).min()
              for g in groups)
    srel = float(np.max(np.abs(art["s"] - s) / np.abs(s)))
    urel = float(np.max(np.abs(art["u_norms"] - ref["u_norms"]) / np.abs(ref["u_norms"])))
    mse = float(np.mean((art["edit"] - ref["edit"]) ** 2))
    psnr = 10.0 * math.log10(1.0 / max(mse, 1e-12))
    return {"sigma max rel err": (srel, srel <= 1e-3),
            "u norms max rel err": (urel, urel <= 1e-3),
            "min principal cos per sigma group": (float(cos), cos >= 0.99),
            "edit PSNR dB": (psnr, psnr >= 35.0)}


def phase_uncond(fa):
    """The CelebA-HQ-256 uncond edit path at full width through the port
    CLI's builder (ddpm_celebahq_256, 113.7 M parameters, bf16 on the card,
    the bundled CelebA-HQ images), 20-step grids so that η = 1 runs on the
    last three finish steps; it must launch none of K1–K5. Then the card
    against the port on the CPU in f32 (TF32 off): full-width ε, and the
    ddpm_tiny(32) config-1 smoke pipeline at the golden gates; and bf16
    against f32 at full width (printed, no gate)."""
    import copy

    import numpy as np
    from PIL import Image

    from diffusion_pullback_tpu_torch import main as port_main
    from diffusion_pullback_tpu_torch.experiments import BasisCache
    from diffusion_pullback_tpu_torch.experiments._common import to_nchw, to_nhwc
    from diffusion_pullback_tpu_torch.geometry import local_pullback
    from diffusion_pullback_tpu_torch.geometry.pullback import _orthonormal_probes
    from diffusion_pullback_tpu_torch.models import (
        TapPoint, UNet2D, ddpm_tiny, model_for_name, random_init_)

    out = os.path.join(OUT, "uncond")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    args = port_main.parse_args([
        "--note", "chip_smoke", "--result_folder", out, "--model_name",
        "CelebA_HQ_HF", "--dataset_name", "CelebA_HQ", "--for_steps", "20",
        "--inv_steps", "20", "--edit_t", "0.5", "--performance_boosting_t", "0.2",
        "--pca_rank", str(PCA_RANK), "--x_space_guidance_num_step", "2"])
    t0 = time.perf_counter()
    edit = port_main.build_uncond(args)
    cfg = edit.cfg
    cfg.pullback_min_iter, cfg.pullback_max_iter = 1, 3
    cfg.basis_folder = os.path.join(out, "inputs")
    edit.cache = BasisCache(cfg.basis_folder)
    n_params = sum(p.numel() for p in edit.model.parameters())
    log(f"[uncond] built the CelebA_HQ_HF driver in {time.perf_counter() - t0:.1f} s "
        f"({n_params} parameters, {next(edit.model.parameters()).dtype}, dataset "
        f"{type(edit.dataset).__name__} of {len(edit.dataset)}, boost from step "
        f"{edit.boost_start_idx} of {edit.fwd_grid.num_steps})")

    vis_num, vis_num_pc = 4, 2   # the CLI's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _, wrapper, _, _ in KERNELS.values():
        getattr(fa, wrapper).launches = 0
    t0 = time.perf_counter()
    names = edit.run_edit_local_encoder_pullback_zt(
        idx=0, pca_rank=PCA_RANK, vis_num=vis_num, vis_num_pc=vis_num_pc)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {label: getattr(fa, wrapper).launches
                for label, wrapper, _, _ in KERNELS.values()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with open(edit.log.path) as f:
        events = [json.loads(line) for line in f]
    for e in events:
        if "seconds" in e:
            extra = {k: v for k, v in e.items() if k not in ("ts", "event", "seconds")}
            log(f"[uncond] stage {e['event']}: {e['seconds']:.3f} s {extra}")
    pullback = [e for e in events if e["event"] == "local_pullback"][-1]
    u, s, vT = load_basis(os.path.join(cfg.basis_folder, os.listdir(cfg.basis_folder)[0]))
    frames = len(range(0, cfg.x_space_guidance_num_step + 1,
                       max(1, (cfg.x_space_guidance_num_step + 1) // vis_num)))
    log(f"[uncond] main path {seconds:.2f} s, peak memory {peak_gb:.2f} GB, "
        f"pullback {pullback['seconds']:.3f} s ({pullback['iterations']} "
        f"iterations), sigma {s.tolist()}, K1–K5 launches {launches}")
    finish = [e for e in events if e["event"] == "finish_and_save"]
    checks = {
        "four PNGs written": len(names) == 2 * vis_num_pc and all(
            Image.open(os.path.join(cfg.result_folder, n + ".png")).size
            == (256 * frames, 256) for n in names),
        "edited images finite": bool(finish and finish[-1]["finite"]),
        "basis finite, expected shapes": (
            u.shape == (8 * 8 * 512, PCA_RANK) and vT.shape == (PCA_RANK, 256 * 256 * 3)
            and all(np.isfinite(a).all() for a in (u, s, vT)) and (s > 0).all()),
        "boosting on the last three finish steps": edit.boost_start_idx == 16,
        "no K1–K5 launch": not any(launches.values()),
    }
    for what, ok in checks.items():
        log(f"[uncond] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("uncond path checks failed")

    # the card against the CPU, f32, and bf16 against f32 on the card
    x = torch.as_tensor(edit.dataset[0])                   # (1, 256, 256, 3)
    cpu = random_init_(model_for_name("CelebA_HQ_HF"), args.seed).eval().requires_grad_(False)
    card = copy.deepcopy(cpu).cuda()
    with torch.no_grad():
        eps_cpu = cpu(to_nchw(x), 500.0)
        eps_card = card(to_nchw(x).cuda(), 500.0).cpu()
        eps_bf16 = copy.deepcopy(card).to(torch.bfloat16)(to_nchw(x).cuda(), 500.0)
    scale = eps_cpu.abs().max().item()
    err = (eps_card - eps_cpu).abs().max().item()
    rel_bf16 = (eps_bf16.float().cpu() - eps_card).abs().max().item() / scale
    log(f"[uncond] full-width eps f32, card vs CPU: max_abs_err {err:.3g} (max |eps| "
        f"{scale:.3g}, tol 1e-4 relative); bf16 vs f32 on the card: max rel err "
        f"{rel_bf16:.4g}")
    if not (torch.isfinite(eps_card).all() and err <= 1e-4 * scale):
        raise AssertionError("the full-width U-Net on the card disagrees with the CPU")
    del cpu

    xt = x.cuda()
    v0 = _orthonormal_probes(torch.Generator().manual_seed(2), xt.numel(), PCA_RANK)
    enc = lambda z: to_nhwc(card.encode(to_nchw(z), 500.0, TapPoint("mid", 0)))
    res = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        card.to(dtype)   # the same weights, rounded to bf16 the second time
        res[name] = local_pullback(enc, xt, pca_rank=PCA_RANK, min_iter=3,
                                             max_iter=3, atol=0.0, v_init=v0)
    srel = ((res["bf16"].s - res["f32"].s).abs() / res["f32"].s).max().item()
    cos = (res["bf16"].vT * res["f32"].vT).sum(dim=1).abs()
    log(f"[uncond] full-width mid-tap pullback bf16 vs f32 (3 iterations, same "
        f"probes): sigma f32 {res['f32'].s.tolist()}, max rel err {srel:.4g}, |cos| "
        f"per direction {cos.tolist()}, metric distance "
        f"{pullback_dist(res['bf16'], res['f32']):.4g}")
    del card, res
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(1)
    tiny = random_init_(UNet2D(ddpm_tiny(32)), 0).eval().requires_grad_(False)
    x0 = torch.randn(1, 32, 32, 3, generator=gen)
    v0 = _orthonormal_probes(torch.Generator().manual_seed(2), x0.numel(), 4)
    ref = config1_smoke(tiny, x0, v0)
    gates = golden_gates(config1_smoke(copy.deepcopy(tiny).cuda(), x0, v0), ref)
    log("[uncond] ddpm_tiny(32) config-1 smoke pipeline, card vs CPU f32: " + ", ".join(
        f"{k} {v:.4g} ({'ok' if ok else 'FAILED'})" for k, (v, ok) in gates.items()))
    if not all(ok for _, ok in gates.values()):
        raise AssertionError("the smoke pipeline on the card misses the golden gates")

def phase_adm(fa):
    """Phase 8: the ADM-256 edit path at full width through the CLI's uncond
    builder (ImageNet256Uncond in bf16, weights drawn on the card,
    --attn_impl flash, the fused-pair pullback), the bundled example images
    at 256 px, 10/10 steps, edit t 0.5, pca_rank 2, pullback 1–3
    iterations, 2 walk steps, 2 directions × 3 frames; its K1–K5 launches by
    shape held to the count the code gives, each stage's seconds and peak
    memory; then the mid-tap pullback on the pair against the math path
    from the same probes in f32 and bf16, ε on the card against the CPU in
    f32, a classifier-guided run_ddim_forward(2) on the respaced 'ddim10'
    grid against the unguided one, and one ε pass of FFHQ_P2, which
    launches no K1–K5. Returns the path dicts of the edit and of the guided
    forward."""
    import copy

    import numpy as np
    from PIL import Image

    from diffusion_pullback_tpu_torch import main as port_main
    from diffusion_pullback_tpu_torch.experiments import BasisCache
    from diffusion_pullback_tpu_torch.experiments._common import to_nchw
    from diffusion_pullback_tpu_torch.models import TapPoint, model_for_name, random_init_

    out = os.path.join(OUT, "adm")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    flags = ["--note", "chip_smoke", "--model_name", "ImageNet256Uncond",
             "--result_folder", out, "--dataset_name", "Examples", "--for_steps", "10",
             "--inv_steps", "10", "--edit_t", "0.5", "--performance_boosting_t", "0.2",
             "--pca_rank", str(PCA_RANK), "--x_space_guidance_num_step", "2"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    edit = port_main.build_uncond(port_main.parse_args(flags))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg, model = edit.cfg, edit.model
    cfg.pullback_min_iter, cfg.pullback_max_iter = 1, 3
    cfg.basis_folder = os.path.join(out, "inputs")
    edit.cache = BasisCache(cfg.basis_folder)
    n_params = sum(p.numel() for p in model.parameters())
    dtype = next(model.parameters()).dtype
    log(f"[adm] built the ImageNet256Uncond driver in {build_s:.1f} s (weights drawn "
        f"on the card), peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"{type(model).__name__} {n_params} parameters {dtype}, attn "
        f"{model.config.attn_impl}, pullback attn {cfg.pullback_attn_impl}, dataset "
        f"{type(edit.dataset).__name__} of {len(edit.dataset)}, edit t index "
        f"{edit.edit_t_idx}, boost from step {edit.boost_start_idx}")

    vis_num, vis_num_pc = 2, 1
    n_dir = 2 * vis_num_pc
    stride = max(1, (cfg.x_space_guidance_num_step + 1) // vis_num)
    frames = len(range(0, cfg.x_space_guidance_num_step + 1, stride))
    with stage_peaks(edit) as peaks:
        names, seconds, peak_gb, launches, path = drive(
            fa, lambda: edit.run_edit_local_encoder_pullback_zt(
                idx=0, pca_rank=PCA_RANK, vis_num=vis_num, vis_num_pc=vis_num_pc))
    peak_gb = max([peak_gb] + [g for v in peaks.values() for g in v])
    events = read_events(edit)
    for e in events:
        if "seconds" in e:
            extra = {k: v for k, v in e.items() if k not in ("ts", "event", "seconds")}
            log(f"[adm] stage {e['event']}: {e['seconds']:.3f} s, peak memory "
                f"{max(peaks[e['event']]):.2f} GB {extra}")
    pullback = [e for e in events if e["event"] == "local_pullback"][-1]
    # inversion (inv_steps − 2 passes) and the forward to the edit t at batch
    # 1, the walk's (null, edit) pairs of both directions, the finish of
    # every direction's frames; the pullback's encoder on the pair
    expected = collections.Counter()
    unet_k1(expected, 1, (cfg.inv_steps - 2) + edit.edit_t_idx, dtype, **ADM_UNET)
    walk_k1(expected, cfg, n_dir, dtype, **ADM_UNET)
    unet_k1(expected, n_dir * frames, edit.fwd_grid.num_steps - edit.edit_t_idx, dtype,
            **ADM_UNET)
    pair_k2_k5(expected, dtype, pullback["iterations"], layers=2, shapes=ADM_PAIR)
    launches_by_shape = check_launches("adm", launches, path, expected)
    for (sym, dsg), (_, n, ms) in sorted(by_design(fa, [path]).items()):
        log(f"[adm] {KERNELS[sym][0]} on {dsg}: {n} launches, {ms:.2f} ms on the "
            f"device ({100 * ms / 1e3 / seconds:.2f} % of the path)")
    u, s, vT = load_basis(os.path.join(cfg.basis_folder, os.listdir(cfg.basis_folder)[0]))
    log(f"[adm] main path {seconds:.2f} s, peak memory {peak_gb:.2f} GB, sigma "
        f"{s.tolist()}, pullback {pullback['seconds']:.3f} s (encoder "
        f"{pullback['encoder']}, {pullback['iterations']} iterations)")
    finish = [e for e in events if e["event"] == "finish_and_save"]
    checks = {
        "552 814 086 parameters in bf16, attn flash": (
            n_params == 552_814_086 and dtype == torch.bfloat16
            and model.config.attn_impl == "flash"),
        "two PNGs of 3 frames at 256 px": len(names) == n_dir and all(
            Image.open(os.path.join(cfg.result_folder, n + ".png")).size
            == (256 * frames, 256) for n in names),
        "edited images finite": bool(finish and finish[-1]["finite"]),
        "basis finite, expected shapes": (
            u.shape == (8 * 8 * 1024, PCA_RANK) and vT.shape == (PCA_RANK, 256 * 256 * 3)
            and all(np.isfinite(a).all() for a in (u, s, vT)) and (s > 0).all()),
        "pullback through the fused pair": pullback["encoder"] == "flashpair",
        "every kernel launched": all(launches.values()),
        "launches by shape": launches_by_shape,
    }
    paths = [path]

    # the mid-tap pullback on the pair and on the math path from the same
    # probes (the driver's seeded ones), 3 iterations, f32 then bf16 (the
    # same bf16-valued weights); between them ε on the card against the CPU
    cfg.pullback_min_iter = cfg.pullback_max_iter = 3
    cfg.pullback_atol = 0.0
    xb = torch.as_tensor(edit.dataset[0]).cuda()
    t_edit = edit.fwd_grid.timesteps[edit.edit_t_idx]
    ref = None
    for dt in (torch.float32, torch.bfloat16):
        model.to(dt)
        res = {}
        for impl in ("flash", "xla"):
            cfg.pullback_attn_impl = impl
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[impl] = edit.compute_local_basis(xb, t_edit, TapPoint("mid"), PCA_RANK)
            torch.cuda.synchronize()
            log(f"[adm] mid-tap pullback {str(dt)[6:]} {impl}: "
                f"{time.perf_counter() - t0:.3f} s")
        if dt == torch.float32:
            ref = pair_vs_math("mid-tap f32", res, phase="adm")
            cpu = copy.deepcopy(model).cpu()
            with torch.no_grad():
                eps_card = model(to_nchw(xb), 500.0).cpu()
                eps_cpu = cpu(to_nchw(xb).cpu(), 500.0)
            del cpu
            scale = eps_cpu.abs().max().item()
            err = (eps_card - eps_cpu).abs().max().item()
            log(f"[adm] full-width eps f32, card vs CPU: max_abs_err {err:.3g} (max "
                f"|eps| {scale:.3g}, tol 1e-4 relative)")
            checks["eps f32 card vs CPU"] = bool(
                torch.isfinite(eps_card).all() and err <= 1e-4 * scale)
        else:
            pair_vs_math("mid-tap bf16", res, ref, phase="adm")
    cfg.pullback_attn_impl = "flash"
    del edit, model, res, ref
    torch.cuda.empty_cache()

    # classifier guidance on the respaced grid, through the CLI's builder
    gedit = port_main.build_uncond(port_main.parse_args(
        flags + ["--classifier_scale", "10", "--sampling_timesteps", "ddim10"]))
    grid = gedit.fwd_grid
    log(f"[adm] guided driver: {len(grid.timesteps)} steps from "
        f"{grid.timesteps[0].item():.0f}, classifier guidance scale "
        f"{gedit.cfg.classifier_scale}, label {gedit.cfg.classifier_label}")
    gen = lambda: torch.Generator().manual_seed(11)
    guided, g_s, g_peak, g_launches, g_path = drive(
        fa, lambda: gedit.run_ddim_forward(num_samples=2, generator=gen()))
    expected = collections.Counter()
    unet_k1(expected, 2, grid.num_steps, next(gedit.model.parameters()).dtype, **ADM_UNET)
    checks["(guided) launches by shape"] = check_launches("adm guided", g_launches,
                                                          g_path, expected)
    paths.append(g_path)
    cond_fn, gedit.cond_fn = gedit.cond_fn, None
    t0 = time.perf_counter()
    plain = gedit.run_ddim_forward(num_samples=2, generator=gen())
    torch.cuda.synchronize()
    diff = (guided.float() - plain.float()).abs().max().item()
    log(f"[adm] guided run_ddim_forward(2) on ddim10: {g_s:.3f} s, peak memory "
        f"{g_peak:.2f} GB; unguided {time.perf_counter() - t0:.3f} s; max |guided − "
        f"unguided| {diff:.4g}")
    checks["(guided) grid ddim10 from 900"] = (
        grid.num_steps == 9 and grid.timesteps[0].item() == 900.0 and cond_fn is not None)
    checks["(guided) finite, unlike the unguided run"] = bool(
        torch.isfinite(guided).all() and diff > 1e-3)
    del gedit, guided, plain
    torch.cuda.empty_cache()

    # FFHQ_P2: attention only at 16² (256 tokens), math path, no K1–K5
    with torch.device("cuda"):
        p2 = random_init_(model_for_name("FFHQ_P2", dtype="bfloat16", attn_impl="flash"),
                          0).eval().requires_grad_(False)
    x = torch.randn(1, 3, 256, 256, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(12))
    with torch.no_grad():
        eps, p2_s, _, p2_launches, _ = drive(fa, lambda: p2(x, 500.0))
    log(f"[adm] FFHQ_P2 ({sum(p.numel() for p in p2.parameters())} parameters) one eps "
        f"pass: {p2_s:.3f} s, shape {tuple(eps.shape)}, K1–K5 launches "
        f"{ {KERNELS[k][0]: n for k, n in p2_launches.items()} }")
    checks["FFHQ_P2 finite eps, no K1–K5 launch"] = bool(
        eps.shape == (1, 6, 256, 256) and torch.isfinite(eps).all()
        and not any(p2_launches.values()))
    for what, ok in checks.items():
        log(f"[adm] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("phase 8 checks failed")
    return paths


def phase_harvest(fa):
    """Phase 9: the basis harvests and PCA runs at full width. SD 2.1-base
    through the CLI's builder (U-Net bf16, drawn on the card), 10/10 steps,
    edit t 0.5, one power iteration per pullback: (a) the t-grid harvest at
    two points of the CLI's grid (1.0 and 0.5) at its pca_rank 50, with
    each pullback's seconds and peak memory; (b) the CLI's prompt sweep
    over the first 3 prompts of inputs/prompts_coco50.txt and the edit loop
    that follows, which must read every basis from the cache; (c) local PCA
    of 32 perturbations in chunks of 16; (d) the CLI's global PCA (100
    latents); (e) the rank-50 pullback on the pair against the math path in
    f32; then (f) the CLI's Fréchet-mean edit on ADM-256 over two samples'
    pca_rank-10 bases. Each run's K1–K5 launches by shape are held to the
    count the code gives. Returns the path dicts of the runs."""
    import numpy as np
    from PIL import Image

    from diffusion_pullback_tpu_torch import main as port_main
    from diffusion_pullback_tpu_torch.experiments import BasisCache

    out = os.path.join(OUT, "harvest")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    flags = ["--note", "chip_smoke", "--result_folder", out, "--for_steps", "10",
             "--inv_steps", "10", "--edit_t", "0.5", "--x_space_guidance_num_step", "2",
             "--edit_prompt", "a photo of a smiling face"]
    t0 = time.perf_counter()
    with torch.device("cuda"):      # weights drawn on the card
        edit = port_main.build_sd(port_main.parse_args(flags))
    torch.cuda.synchronize()
    cfg = edit.cfg
    cfg.pullback_max_iter = 1
    cfg.basis_folder = os.path.join(out, "inputs")
    edit.cache = BasisCache(cfg.basis_folder)
    dtypes = (next(edit.unet.parameters()).dtype, next(edit.vae.parameters()).dtype)
    unet_dtype = dtypes[0]
    log(f"[harvest] built the SD 2.1-base driver in {time.perf_counter() - t0:.1f} s "
        f"(drawn on the card; U-Net {unet_dtype}, pullback attn {cfg.pullback_attn_impl}, "
        f"edit t index {edit.edit_t_idx}, {cfg.pullback_max_iter} power iteration)")
    paths, checks = [], {}

    def run(tag, drv, fn, expected_fn):
        return checked_run(fa, "harvest", tag, drv, fn, expected_fn, checks, paths)

    def pngs(names, size=512, frames=3):
        return len(names) > 0 and all(
            Image.open(os.path.join(cfg.result_folder, n + ".png")).size
            == (size * frames, size) for n in names)

    def encode_invert_forward(expected, steps=None):
        """VAE encode, inversion and forward to grid index ``steps`` (the
        edit t by default) at batch 1."""
        expected[("flash_fwd", (1, 4096, 512), dtypes[1])] += 1
        unet_k1(expected, 1, (cfg.inv_steps - 2) + (
            edit.edit_t_idx if steps is None else steps), unet_dtype)

    # (a) the t-grid harvest at the CLI's rank: one walk down the
    # trajectory, a rank-50 pullback at each point
    grid = (port_main.HARVEST_T_GRID[0], port_main.HARVEST_T_GRID[10])

    def exp_a(expected, events):
        encode_invert_forward(expected, max(edit._t_index(t) for t in grid))
        for e in named(events, "sd_local_pullback"):
            pair_k2_k5(expected, unet_dtype, e["iterations"], layers=2, rank=HARVEST_RANK)

    files, events, peaks, _ = run("a", edit, lambda: edit.run_sample_encoder_local_tangent_space_zt_batched(
        idx=0, pca_rank=HARVEST_RANK, t_grid=grid), exp_a)
    pulls = named(events, "sd_local_pullback")
    harvest = named(events, "sd_tangent_harvest")[0]
    for t, e, gb in zip(grid, pulls, peaks["sd_local_pullback"]):
        log(f"[harvest] rank-{HARVEST_RANK} pullback at t {t} (unchunked, "
            f"{e['iterations']} power iteration): {e['seconds']:.3f} s, peak memory "
            f"{gb:.2f} GB, top sigma {e['top_s']}")
    log(f"[harvest] (a) {len(grid)} bases in {harvest['seconds']:.3f} s: "
        f"{harvest['seconds'] / len(grid):.3f} s per basis (inversion and walk "
        f"included), {sum(e['seconds'] for e in pulls) / len(pulls):.3f} s per pullback")
    bases = [BasisCache(cfg.basis_folder).load(os.path.splitext(os.path.basename(f))[0])
             for f in files.values()]
    checks["(a) rank-50 bases finite, expected shapes"] = len(bases) == 2 and all(
        b is not None and b[0].shape == (8 * 8 * 1280, HARVEST_RANK)
        and b[2].shape == (HARVEST_RANK, 64 * 64 * 4)
        and all(np.isfinite(a).all() for a in b) and (b[1] > 0).all() for b in bases)
    checks["(a) pullbacks through the fused pair"] = all(
        e["encoder"] == "flashpair" for e in pulls) and len(pulls) == 2

    # (b) the CLI's prompt sweep and the edit loop after it (vis_num 4,
    # vis_num_pc 2: 4 directions of 3 frames per prompt)
    sweep_args = port_main.parse_args(flags + [
        "--run_edit_local_encoder_pullback_zt_with_various_prompt", "True",
        "--num_local_basis", "3"])

    def exp_b(expected, events):
        encode_invert_forward(expected)
        for e in named(events, "sd_local_pullback"):
            pair_k2_k5(expected, unet_dtype, e["iterations"], layers=2)
        for _ in range(3):
            edit_k1(expected, edit, 4, 3, dtypes)

    _, events, _, seconds = run("b", edit, lambda: port_main.dispatch(edit, sweep_args),
                                exp_b)
    hits = [e["name"] for e in named(events, "basis_cache_hit")]
    log(f"[harvest] (b) sweep {named(events, 'sd_prompt_sweep')[0]['seconds']:.3f} s "
        f"for 3 prompts, then 3 edits from the cache: {seconds:.2f} s in all")
    checks["(b) one pullback per prompt, in the sweep only"] = (
        len(named(events, "sd_local_pullback")) == 3 and len(hits) == 3
        and [e["event"] for e in events].index("sd_prompt_sweep")
        < [e["event"] for e in events].index("basis_cache_hit"))
    names = [n for n in os.listdir(cfg.result_folder) if n.startswith("Edit_zt-")]
    checks["(b) 12 PNGs, finite"] = len(names) == 12 and pngs(
        [os.path.splitext(n)[0] for n in names]) and all(
        e["finite"] for e in named(events, "sd_decode_and_save"))

    # (c) local PCA: 2 chunks of 16 perturbations through the mid-tap
    # encoder in each of the two passes, one Jᵀ per direction pair
    def exp_c(expected, events):
        edit_k1(expected, edit, 2, 3, dtypes)
        unet_k1(expected, 16, 4, unet_dtype, at_4096=2, at_1024=2)
        covector_k2_k5(expected, unet_dtype, 1)

    names, events, _, _ = run("c", edit, lambda: edit.run_edit_local_pca_zt(
        idx=0, pca_rank=4, num_samples=32, vis_num=2, vis_num_pc=1), exp_c)
    checks["(c) local-PCA PNGs, finite"] = pngs(names) and all(
        e["finite"] for e in named(events, "sd_decode_and_save"))

    # (d) the CLI's global PCA: --num_local_basis (100 by default) latents
    # forwarded to the edit t as one batch and tapped there, then the edit
    # of sample 0 (vis_num 4, vis_num_pc 2: 2 Jᵀ, 4 directions of 3 frames)
    gpca_args = port_main.parse_args(flags + ["--run_edit_global_pca_zt", "True"])
    n_lat = gpca_args.num_local_basis

    def exp_d(expected, events):
        unet_k1(expected, n_lat, edit.edit_t_idx, unet_dtype)
        unet_k1(expected, n_lat, 1, unet_dtype, at_4096=2, at_1024=2)
        edit_k1(expected, edit, 4, 3, dtypes)
        covector_k2_k5(expected, unet_dtype, 2)

    _, events, _, _ = run("d", edit, lambda: port_main.dispatch(edit, gpca_args), exp_d)
    names = [os.path.splitext(n)[0] for n in os.listdir(cfg.result_folder)
             if n.startswith("Edit_global_pca-")]
    checks[f"(d) global PCA of {n_lat} latents: 4 PNGs, finite"] = (
        [e["num_samples"] for e in named(events, "sd_global_pca_harvest")] == [n_lat]
        and len(names) == 4 and pngs(names)
        and all(e["finite"] for e in named(events, "sd_decode_and_save")))

    # (e) the composed rank-50 pullback at the grid's t 0.5 in f32: the
    # fused pair unchunked (K3–K5 at B·H 250 and 500) against the math path
    # from the same probes, one power iteration each; the math path takes
    # 10 probes per pass (its B·H × S² scores at 50 probes would not fit).
    # Held as the CPU tests hold harvested bases: σ within 1e-3, |cos| ≥
    # 0.99 per σ-gap group (geometry.metrics); the 50 σ of a random U-Net
    # may chain into one group, so the metric Vᵀσ²V is held too, within
    # 1e-3 (relative Frobenius distance)
    from diffusion_pullback_tpu_torch.geometry import compare_bases, passes_acceptance

    edit.unet.to(torch.float32)    # the same weights, bf16-valued
    zb = torch.randn(1, 64, 64, 4, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(7))
    t_b, res = edit.fwd_grid.timesteps[edit._t_index(grid[1])], {}
    for impl, chunk in (("flash", None), ("xla", 10)):
        cfg.pullback_attn_impl, cfg.pullback_chunk_size = impl, chunk
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res[impl] = edit.compute_local_basis(zb, t_b, edit._make_tap("mid", 0),
                                             HARVEST_RANK)
        torch.cuda.synchronize()
        log(f"[harvest] (e) rank-{HARVEST_RANK} pullback f32 {impl} (chunk "
            f"{chunk}): {time.perf_counter() - t0:.3f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    cfg.pullback_attn_impl, cfg.pullback_chunk_size = "flash", None
    host = lambda r: (r.vT.float().cpu().numpy(), r.s.float().cpu().numpy())
    cmp = compare_bases(*host(res["flash"]), *host(res["xla"]))
    dist = pullback_dist(res["flash"], res["xla"])
    log(f"[harvest] (e) f32 pair vs math at rank {HARVEST_RANK}: sigma max rel err "
        f"{cmp.sigma_rel_err.max():.3g} (tol 1e-3), min |cos| per σ-gap group "
        f"{cmp.per_direction_cos.min():.6f} (tol ≥ 0.99) over "
        f"{len(cmp.gap_groups)} groups, metric distance {dist:.3g} (tol 1e-3)")
    checks[f"(e) f32 rank-{HARVEST_RANK} pair pullback vs math"] = passes_acceptance(
        cmp, cos_min=0.99, sigma_rtol=1e-3) and dist <= 1e-3
    del edit
    torch.cuda.empty_cache()

    # (f) the CLI's Fréchet-mean edit on ADM-256: two samples' pca_rank-10
    # bases (inversion, forward, pullback each), their mean, the edit of
    # sample 0 along its 2 directions (4 walks of 3 frames)
    adm_flags = ["--note", "chip_smoke", "--model_name", "ImageNet256Uncond",
                 "--result_folder", os.path.join(out, "adm"), "--dataset_name", "Examples",
                 "--for_steps", "10", "--inv_steps", "10", "--edit_t", "0.5",
                 "--performance_boosting_t", "0.2", "--x_space_guidance_num_step", "2",
                 "--run_edit_global_frechet_mean_zt", "True", "--num_local_basis", "2"]
    adm_args = port_main.parse_args(adm_flags)
    adm = port_main.build_uncond(adm_args)
    adm.cfg.pullback_max_iter = 1
    adm.cfg.basis_folder = os.path.join(out, "adm", "inputs")
    adm.cache = BasisCache(adm.cfg.basis_folder)
    adm_dtype = next(adm.model.parameters()).dtype

    def exp_f(expected, events):
        for _ in range(3):   # the two samples' harvest, then sample 0's edit
            unet_k1(expected, 1, (adm.cfg.inv_steps - 2) + adm.edit_t_idx, adm_dtype,
                    **ADM_UNET)
        for e in named(events, "local_pullback"):
            pair_k2_k5(expected, adm_dtype, e["iterations"], layers=2, shapes=ADM_PAIR,
                       rank=MEAN_RANK)
        covector_k2_k5(expected, adm_dtype, 2, shapes=ADM_PAIR)
        walk_k1(expected, adm.cfg, 4, adm_dtype, **ADM_UNET)
        unet_k1(expected, 4 * 3, adm.fwd_grid.num_steps - adm.edit_t_idx, adm_dtype,
                **ADM_UNET)

    _, events, _, seconds = run("f", adm, lambda: port_main.dispatch(adm, adm_args), exp_f)
    names = [os.path.splitext(n)[0] for n in os.listdir(adm.cfg.result_folder)
             if n.startswith("Edit_global_frechet-")]
    checks["(f) two rank-10 bases, four PNGs, finite"] = (
        len(os.listdir(adm.cfg.basis_folder)) == 2 and len(names) == 4
        and all(Image.open(os.path.join(adm.cfg.result_folder, n + ".png")).size
                == (256 * 3, 256) for n in names)
        and all(e["finite"] for e in named(events, "finish_and_save")))
    del adm
    torch.cuda.empty_cache()

    for what, ok in checks.items():
        log(f"[harvest] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("phase 9 checks failed")
    return paths


# guided-diffusion keeps these attention projections as conv_nd(1, …): (out, in, 1)
CONV1D_PROJECTIONS = ("qkv", "proj_out", "qkv_proj", "c_proj")


def phase_uncond_runs(fa):
    """Phase 10: the rest of the uncond edit runs on ADM-256 at full width
    through the CLI (build_uncond, main.dispatch): ImageNet256Uncond in bf16
    with weights drawn on the card, --attn_impl flash, the fused-pair
    pullbacks, the bundled example images at 256 px, 10/10 steps, edit t
    0.5, 2 walk steps, one power iteration per pullback. (a) h-space
    guidance at pca_rank 2; (b) the decoder-pullback edit, then the decoder
    pullback on the pair against the math path in f32 and bf16; (c)
    parallel transport at pca_rank 50 (two rank-50 pullbacks, unchunked),
    each pullback's seconds and peak memory; (d) run_ddim_forward(5) with
    --vis_psd (the radial power spectra of its x_t and ε_t trajectories;
    plotted only where matplotlib is installed) and --run_ddim_inversion;
    (e) a checkpoint round trip at full width: CelebA-HQ-256's U-Net and
    adm_classifier(256) (its attention projections stored as
    guided-diffusion's 1-D convs) saved with torch.save and loaded back
    through --checkpoint_path / --classifier_path, ε and logits equal to
    the in-memory models' bit for bit. Each run's K1–K5 launches by shape
    are held to the count the code gives. Returns the path dicts of
    (a)–(d)."""
    import importlib.util

    import numpy as np
    from PIL import Image

    from diffusion_pullback_tpu_torch import main as port_main
    from diffusion_pullback_tpu_torch.experiments import BasisCache
    from diffusion_pullback_tpu_torch.experiments import vis as port_vis
    from diffusion_pullback_tpu_torch.models import (
        EncoderUNetADM, TapPoint, adm_classifier, model_for_name, random_init_)

    out = os.path.join(OUT, "uncond_runs")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    flags = ["--note", "chip_smoke", "--model_name", "ImageNet256Uncond",
             "--result_folder", out, "--dataset_name", "Examples", "--for_steps", "10",
             "--inv_steps", "10", "--edit_t", "0.5", "--performance_boosting_t", "0.2",
             "--x_space_guidance_num_step", "2"]
    cli = lambda *more: port_main.parse_args(flags + list(more))
    t0 = time.perf_counter()
    edit = port_main.build_uncond(cli())
    torch.cuda.synchronize()
    cfg, model = edit.cfg, edit.model
    cfg.pullback_max_iter = 1
    cfg.basis_folder = os.path.join(out, "inputs")
    edit.cache = BasisCache(cfg.basis_folder)
    dtype = next(model.parameters()).dtype
    log(f"[uncond10] built the ImageNet256Uncond driver in {time.perf_counter() - t0:.1f} "
        f"s (drawn on the card; {dtype}, attn {model.config.attn_impl}, pullback attn "
        f"{cfg.pullback_attn_impl}, edit t index {edit.edit_t_idx}, "
        f"{cfg.pullback_max_iter} power iteration per pullback)")
    paths, checks = [], {}
    run = lambda tag, fn, expected_fn: checked_run(fa, "uncond10", tag, edit, fn,
                                                   expected_fn, checks, paths)
    to_t = (cfg.inv_steps - 2) + edit.edit_t_idx        # inversion + forward to t
    finish = edit.fwd_grid.num_steps - edit.edit_t_idx
    # the mid-tap encoder reaches 2 of ADM-256's 1024-token self-attentions,
    # the decode from the tap the other 3
    encoder, decoder = dict(at_4096=0, at_1024=2, heads=(8, 8)), dict(
        at_4096=0, at_1024=3, heads=(8, 8))

    def walk_and_finish(expected, n_dir=4, frames=3):
        walk_k1(expected, cfg, n_dir, dtype, **ADM_UNET)
        unet_k1(expected, n_dir * frames, finish, dtype, **ADM_UNET)

    def pngs(prefix, n=4):
        names = sorted(f for f in os.listdir(cfg.result_folder) if f.startswith(prefix))
        return len(names) == n and all(
            Image.open(os.path.join(cfg.result_folder, f)).size == (256 * 3, 256)
            for f in names)

    # (a) h-space guidance: per micro-step the encoder at the 4 directions'
    # rows, the decode of the 8 [h; h + δ·û] rows; then the finish
    def exp_a(expected, events):
        unet_k1(expected, 1, to_t, dtype, **ADM_UNET)
        for e in named(events, "local_pullback"):
            pair_k2_k5(expected, dtype, e["iterations"], layers=2, shapes=ADM_PAIR)
        unet_k1(expected, 4, cfg.x_space_guidance_num_step, dtype, **encoder)
        unet_k1(expected, 8, cfg.x_space_guidance_num_step, dtype, **decoder)
        unet_k1(expected, 4 * 3, finish, dtype, **ADM_UNET)

    _, events, _, _ = run("a", lambda: port_main.dispatch(edit, cli(
        "--run_edit_h_space_guidance", "True", "--pca_rank", str(PCA_RANK))), exp_a)
    checks["(a) 4 h-space PNGs of 3 frames, finite"] = pngs(
        "Edit_h_space-Examples_0-edit_0.5T-mid-block_0-scale_0.1-pc_") and all(
        e["finite"] for e in named(events, "h_space_guidance_edit"))

    # (b) the decoder-pullback edit: the state from one pass to the tap, the
    # pullback through the decode on the pair, one Jᵀu per direction pair
    def exp_b(expected, events):
        unet_k1(expected, 1, to_t, dtype, **ADM_UNET)
        unet_k1(expected, 1, 1, dtype, **encoder)
        for e in named(events, "local_decoder_pullback"):
            pair_k2_k5(expected, dtype, e["iterations"], layers=3, shapes=ADM_PAIR)
        covector_k2_k5(expected, dtype, 2, shapes=ADM_PAIR)
        walk_and_finish(expected)

    _, events, _, _ = run("b", lambda: port_main.dispatch(edit, cli(
        "--run_edit_local_decoder_pullback_zt", "True")), exp_b)
    dec = named(events, "local_decoder_pullback")
    checks["(b) decoder pullback on the pair, 4 PNGs, finite"] = (
        [e["decoder"] for e in dec] == ["flashpair"] and pngs("Edit_local_dec-")
        and all(e["finite"] for e in named(events, "finish_and_save")))
    # the same pullback on the pair and on the math path from the same
    # probes, 3 iterations, f32 then bf16 (the same bf16-valued weights)
    cfg.pullback_min_iter = cfg.pullback_max_iter = 3
    cfg.pullback_atol = 0.0
    xb = torch.as_tensor(edit.dataset[0]).cuda()
    t_edit = edit.fwd_grid.timesteps[edit.edit_t_idx]
    ref = None
    for dt in (torch.float32, torch.bfloat16):
        model.to(dt)
        res = {}
        for impl in ("flash", "xla"):
            cfg.pullback_attn_impl = impl
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[impl] = edit.compute_local_decoder_basis(xb, t_edit, TapPoint("mid"),
                                                         PCA_RANK)
            torch.cuda.synchronize()
            log(f"[uncond10] decoder pullback {str(dt)[6:]} {impl}: "
                f"{time.perf_counter() - t0:.3f} s")
        if dt == torch.float32:
            ref = pair_vs_math("decoder f32", res, phase="uncond10")
        else:
            pair_vs_math("decoder bf16", res, ref, phase="uncond10")
    cfg.pullback_attn_impl, cfg.pullback_min_iter, cfg.pullback_max_iter = "flash", 10, 1
    del res, ref
    torch.cuda.empty_cache()

    # (c) parallel transport at the CLI's pca_rank 50: samples 0 and 1
    # inverted, each one's rank-50 basis (K3–K5 at B·H 400), the edit of 1
    def exp_c(expected, events):
        for _ in range(2):
            unet_k1(expected, 1, to_t, dtype, **ADM_UNET)
        for e in named(events, "local_pullback"):
            pair_k2_k5(expected, dtype, e["iterations"], layers=2, shapes=ADM_PAIR,
                       rank=HARVEST_RANK)
        walk_and_finish(expected)

    _, events, peaks, seconds = run("c", lambda: port_main.dispatch(edit, cli(
        "--run_edit_parallel_transport", "True", "--sample_idx_0", "0",
        "--sample_idx_1", "1")), exp_c)
    pulls = named(events, "local_pullback")
    for i, (e, gb) in enumerate(zip(pulls, peaks["local_pullback"])):
        log(f"[uncond10] (c) rank-{HARVEST_RANK} pullback of sample {i} (unchunked, "
            f"{e['iterations']} power iteration): {e['seconds']:.3f} s, peak memory "
            f"{gb:.2f} GB, top sigma {e['top_s']}")
    bases = [BasisCache(cfg.basis_folder).load(
        f"local_basis-Examples_{i}-0.5T-mid-block_0-seed_0-pca_rank_{HARVEST_RANK}")
        for i in (0, 1)]
    checks["(c) two rank-50 bases through the pair, 4 transport PNGs"] = (
        len(pulls) == 2 and all(e["encoder"] == "flashpair" for e in pulls)
        and all(b is not None and b[0].shape == (8 * 8 * 1024, HARVEST_RANK)
                and b[2].shape == (HARVEST_RANK, 256 * 256 * 3)
                and all(np.isfinite(a).all() for a in b) for b in bases)
        and pngs("Edit_transport-Examples_0to1-"))

    # (d) run_ddim_forward(5) with the trajectories' power spectra (plotted
    # where matplotlib is installed), then the inversion of sample 0
    curves = []
    plot = importlib.util.find_spec("matplotlib") is not None
    real_psd = port_vis.vis_power_spectral_density

    def psd(traj, path, **kw):
        curves.append(port_vis.psd_curves(traj, **kw))
        return real_psd(traj, path, **kw) if plot else curves[-1]

    def exp_d(expected, events):
        unet_k1(expected, 5, edit.fwd_grid.num_steps, dtype, **ADM_UNET)
        unet_k1(expected, 1, cfg.inv_steps - 2, dtype, **ADM_UNET)

    port_vis.vis_power_spectral_density = psd
    try:
        run("d", lambda: port_main.dispatch(edit, cli(
            "--run_ddim_forward", "True", "--vis_psd", "True",
            "--run_ddim_inversion", "True")), exp_d)
    finally:
        port_vis.vis_power_spectral_density = real_psd
    log(f"[uncond10] (d) radial PSD of x_t and eps_t: shapes "
        f"{[c.shape for c in curves]}, matplotlib {'present' if plot else 'absent'}"
        + ("" if plot else ": the plot call was replaced by psd_curves in this run; "
           "the CLI's own --vis_psd raises ModuleNotFoundError after the forward "
           "pass here, as the JAX CLI does"))
    checks["(d) PSD curves (steps, 64), finite, positive"] = len(curves) == 2 and all(
        c.shape == (edit.fwd_grid.num_steps, 64) and np.isfinite(c).all()
        and (c > 0).all() for c in curves) and (not plot or {"xt_psd.png", "et_psd.png"}
                                                <= set(os.listdir(cfg.obs_folder)))
    checks["(d) DDIMforward.png of 5 samples"] = Image.open(os.path.join(
        cfg.result_folder, "DDIMforward.png")).size == (256 * 5, 256)
    del edit, model
    torch.cuda.empty_cache()

    # (e) the checkpoint round trip at full width
    ckpt = os.path.join(out, "checkpoints")
    os.makedirs(ckpt)
    with torch.device("cuda"):
        unet = random_init_(model_for_name("CelebA_HQ_HF"), 21).eval().requires_grad_(False)
        clf = random_init_(EncoderUNetADM(adm_classifier(256)), 22).eval().requires_grad_(False)
    t0 = time.perf_counter()
    torch.save(unet.state_dict(), os.path.join(ckpt, "celebahq.pt"))
    torch.save({k: v[:, :, None] if k.rsplit(".", 2)[-2] in CONV1D_PROJECTIONS
                and v.ndim == 2 else v for k, v in clf.state_dict().items()},
               os.path.join(ckpt, "classifier.pt"))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = port_main.build_uncond(port_main.parse_args([
        "--note", "chip_smoke", "--model_name", "CelebA_HQ_HF", "--result_folder",
        os.path.join(out, "ckpt"), "--dataset_name", "Examples",
        "--performance_boosting_t", "0.2", "--classifier_scale", "1",
        "--checkpoint_path", os.path.join(ckpt, "celebahq.pt"),
        "--classifier_path", os.path.join(ckpt, "classifier.pt")]))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_unet = sum(p.numel() for p in unet.parameters())
    n_clf = sum(p.numel() for p in clf.parameters())
    sizes = {f: os.path.getsize(os.path.join(ckpt, f)) / 1e6 for f in os.listdir(ckpt)}
    x = torch.randn(2, 3, 256, 256, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(23))
    unet.to(next(loaded.model.parameters()).dtype)
    with torch.no_grad():
        eps_equal = torch.equal(loaded.model(x, 500.0), unet(x, 500.0))
        logits_equal = torch.equal(loaded.classifier(x, 500.0), clf(x, 500.0))
    log(f"[uncond10] (e) saved {n_unet} U-Net and {n_clf} classifier parameters in "
        f"{save_s:.2f} s ({ {f: round(mb, 1) for f, mb in sizes.items()} } MB), built "
        f"the driver from them in {load_s:.2f} s; eps equal bit for bit: {eps_equal}, "
        f"logits equal bit for bit: {logits_equal}")
    checks["(e) CelebA-HQ-256 U-Net and ADM-256 classifier round trip, bit for bit"] = (
        eps_equal and logits_equal and n_unet == 113_673_219)
    del unet, clf, loaded
    shutil.rmtree(ckpt)
    torch.cuda.empty_cache()

    for what, ok in checks.items():
        log(f"[uncond10] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("phase 10 checks failed")
    return paths


def phase_extras(fa):
    """Phase 11: the post-edit regularizers, the ancestral sampler, uncond
    DeepCache, the batched pullback and SDXL's remat, at full width.
    (a) SD 2.1-base through build_sd and main.dispatch (U-Net bf16 drawn on
    the card, 10/10 steps, edit t 0.5, one power iteration) with dynamic
    thresholding, preserve_contrast and preserve_norm on: launches by
    shape, finite PNGs, every finished frame at ‖z_start‖, the
    regularizers' milliseconds; (d) on that driver, batched_local_pullback
    over BATCH latents at the mid tap, pca_rank 2, one iteration, on the
    pair (K2 at B·H 20 / 40, K3–K5 at 40 / 80), in bf16 and in f32, against
    BATCH per-sample pullbacks from the same probes (in f32 σ rtol 1e-3,
    |cos| ≥ 0.99 per σ-gap group), seconds of both; (b) ADM-256 through
    build_uncond (bf16, --attn_impl flash, --classifier_scale 1):
    ddpm_forward with the learned-range variance over the respaced '10'
    grid, plain and guided by adm_classifier(256): K1 at (8,1024,64) per
    step, finite, guided unlike plain; (c) CelebA-HQ-256 (build_uncond,
    bf16) ddim_forward_deepcache at intervals 1 and 3 against ddim_forward
    over its 20-step grid at batch 2: seconds, the distance, no launch;
    (e) SDXL through build_sdxl, the rank-8 pullback unchunked with remat
    off and on (pullback_remat and remat_transformer together): seconds,
    peak memory, the same basis, launches by shape as derived. Returns the
    path dicts of the bf16 runs."""
    from diffusion_pullback_tpu_torch import main as port_main
    from diffusion_pullback_tpu_torch.experiments import BasisCache
    from diffusion_pullback_tpu_torch.experiments._common import to_nchw, to_nhwc
    from diffusion_pullback_tpu_torch.geometry import (
        batched_local_pullback, compare_bases, local_pullback, passes_acceptance)
    from diffusion_pullback_tpu_torch.models import TapPoint
    from diffusion_pullback_tpu_torch.ops.schedule import space_timesteps
    from diffusion_pullback_tpu_torch.samplers.ddim_loop import ddim_forward, ddpm_forward
    from diffusion_pullback_tpu_torch.samplers.deepcache import ddim_forward_deepcache

    out = os.path.join(OUT, "extras")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    paths, checks = [], {}
    cuda_gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    host = lambda r: (r.vT.float().cpu().numpy(), r.s.float().cpu().numpy())

    # (a) the regularized SD edit through the CLI
    flags = ["--note", "chip_smoke", "--result_folder", os.path.join(out, "sd"),
             "--for_steps", "10", "--inv_steps", "10", "--edit_t", "0.5",
             "--x_space_guidance_num_step", "2", "--run_edit_local_encoder_pullback_zt",
             "True", "--use_dynamic_thresholding", "True", "--use_preserve_contrast",
             "True", "--use_preserve_norm", "True"]
    args = port_main.parse_args(flags)
    t0 = time.perf_counter()
    with torch.device("cuda"):      # weights drawn on the card
        edit = port_main.build_sd(args)
    torch.cuda.synchronize()
    cfg = edit.cfg
    cfg.pullback_max_iter = 1
    cfg.basis_folder = os.path.join(out, "sd", "inputs")
    edit.cache = BasisCache(cfg.basis_folder)
    dtypes = (next(edit.unet.parameters()).dtype, next(edit.vae.parameters()).dtype)
    log(f"[extras] built the SD 2.1-base driver in {time.perf_counter() - t0:.1f} s; "
        f"regularizers: dynamic thresholding q {cfg.dynamic_thresholding_q}, contrast "
        f"{cfg.use_preserve_contrast}, norm {cfg.use_preserve_norm}")
    seen, regularize = [], edit._regularize

    def timed_regularize(sel, z_start):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg = regularize(sel, z_start)
        torch.cuda.synchronize()
        seen.append((time.perf_counter() - t0, sel, z_start, reg))
        return reg

    def exp_a(expected, events):
        edit_k1(expected, edit, 4, 3, dtypes)
        for e in named(events, "sd_local_pullback"):
            pair_k2_k5(expected, dtypes[0], e["iterations"], layers=2)

    edit._regularize = timed_regularize
    _, events, _, _ = checked_run(fa, "extras", "a", edit,
                                  lambda: port_main.dispatch(edit, args), exp_a, checks,
                                  paths)
    del edit._regularize
    (reg_s, sel, z_start, reg), = seen
    warm_s = cuda_ms(lambda: regularize(sel, z_start), 5) / 1e3
    ref_norm = torch.linalg.norm(z_start.float())
    norm_err = ((torch.linalg.norm(reg.reshape(reg.shape[0], -1).float(), dim=1)
                 - ref_norm).abs().max() / ref_norm).item()
    moved = (reg.float() - sel.float()).abs().max().item()
    log(f"[extras] (a) the regularizers on {reg.shape[0]} frames of "
        f"{tuple(reg.shape[1:])}: {1e3 * reg_s:.3f} ms in the run (the first call), "
        f"{1e3 * warm_s:.3f} ms warm; each frame's norm against "
        f"‖z_start‖ {ref_norm:.4f}: max rel err {norm_err:.3g} (tol 1e-4); max |moved| "
        f"{moved:.4g}")
    names = [n for n in os.listdir(cfg.result_folder) if n.startswith("Edit_zt-")]
    checks["(a) preserve_norm: every frame at ‖z_start‖, frames moved"] = (
        norm_err <= 1e-4 and moved > 1e-3)
    checks["(a) 4 PNGs, finite"] = len(names) == 4 and all(
        e["finite"] for e in named(events, "sd_decode_and_save"))

    # (d) the batched pullback: BATCH latents as one batch against BATCH
    # per-sample pullbacks from the same probes, one power iteration each
    tap, t_edit = TapPoint("mid", 0), edit.fwd_grid.timesteps[edit.edit_t_idx]
    zs = torch.randn(BATCH, 64, 64, 4, device="cuda", generator=cuda_gen(12))
    v0 = torch.linalg.qr(torch.randn(BATCH, zs[0].numel(), PCA_RANK, device="cuda",
                                     generator=cuda_gen(13)))[0].mT.contiguous()
    kw = dict(pca_rank=PCA_RANK, min_iter=0, max_iter=1, atol=0.0)
    for dtype in (BF16, F32):
        edit.unet.to(dtype)         # the same weights, bf16-valued
        enc, enc_vjp, tag = edit._pullback_tap_encoders(t_edit, tap)
        runs = {}
        for what, batch, fn in (
                ("batched", BATCH, lambda: batched_local_pullback(
                    enc, zs, v_init=v0, fn_vjp=enc_vjp, **kw)),
                ("per-sample", 1, lambda: [local_pullback(
                    enc, zs[b:b + 1], v_init=v0[b], fn_vjp=enc_vjp, **kw)
                    for b in range(BATCH)])):
            res, seconds, peak, launches, path = drive(fa, fn)
            expected = collections.Counter()
            for _ in range(BATCH // batch):
                pair_k2_k5(expected, dtype, 1, layers=2, primal=batch)
            tag_d = f"(d) {what} {str(dtype)[6:]}"
            checks[f"{tag_d} launches by shape"] = check_launches(
                f"extras {tag_d}", launches, path, expected)
            if dtype == BF16:
                paths.append(path)
            log(f"[extras] {tag_d} pullback of {BATCH} latents ({tag}): {seconds:.3f} s, "
                f"peak memory {peak:.2f} GB")
            runs[what] = res
        batched = runs["batched"]
        cmps = [compare_bases(*host(single), batched.vT[b].float().cpu().numpy(),
                              batched.s[b].float().cpu().numpy())
                for b, single in enumerate(runs["per-sample"])]
        log(f"[extras] (d) {str(dtype)[6:]} batched vs per-sample: sigma max rel err "
            f"{max(c.sigma_rel_err.max() for c in cmps):.3g}, min |cos| per σ-gap group "
            f"{min(c.per_direction_cos.min() for c in cmps):.6f}")
        finite = bool(torch.isfinite(batched.s).all() and torch.isfinite(batched.vT).all())
        checks[f"(d) {str(dtype)[6:]} batched basis finite, (B, r, dim) shapes"] = (
            finite and tuple(batched.vT.shape) == (BATCH, PCA_RANK, zs[0].numel()))
        if dtype == F32:
            checks["(d) f32 batched vs per-sample: σ rtol 1e-3, |cos| ≥ 0.99"] = all(
                passes_acceptance(c, cos_min=0.99, sigma_rtol=1e-3) for c in cmps)
    del edit, runs, batched
    torch.cuda.empty_cache()

    # (b) the ancestral sampler on ADM-256, plain and classifier-guided
    adm = port_main.build_uncond(port_main.parse_args(
        ["--note", "chip_smoke", "--model_name", "ImageNet256Uncond", "--result_folder",
         os.path.join(out, "adm"), "--performance_boosting_t", "0.2",
         "--classifier_scale", "1"]))
    model, adm_dtype = adm.model, next(adm.model.parameters()).dtype
    steps = torch.tensor(sorted(space_timesteps(1000, "10"), reverse=True),
                         dtype=torch.float32)
    x = torch.randn(1, 256, 256, 3, generator=torch.Generator().manual_seed(14)).cuda()
    eps = lambda z, t: to_nhwc(model(to_nchw(z), t))     # [ε, v] on the channel axis
    samples = {}
    for what, cond_fn in (("plain", None), ("guided", adm.cond_fn)):
        with torch.no_grad():
            samples[what], seconds, peak, launches, path = drive(fa, lambda: ddpm_forward(
                eps, x, adm.schedule, torch.Generator().manual_seed(15), timesteps=steps,
                learn_sigma=True, cond_fn=cond_fn))
        expected = collections.Counter()
        unet_k1(expected, 1, len(steps), adm_dtype, **ADM_UNET)
        checks[f"(b) {what} launches by shape"] = check_launches(
            f"extras (b) {what}", launches, path, expected)
        paths.append(path)
        log(f"[extras] (b) ddpm_forward {what}, learned σ, {len(steps)} respaced steps "
            f"from {steps[0].item():.0f}: {seconds:.3f} s, peak memory {peak:.2f} GB")
    diff = (samples["guided"] - samples["plain"]).abs().max().item()
    log(f"[extras] (b) max |guided − plain| {diff:.4g} (classifier scale "
        f"{adm.cfg.classifier_scale}); max |x| plain "
        f"{samples['plain'].abs().max().item():.4g}, guided "
        f"{samples['guided'].abs().max().item():.4g}")
    checks["(b) samples finite, (1, 256, 256, 3), guided unlike plain"] = all(
        bool(torch.isfinite(s).all()) and s.shape == x.shape
        for s in samples.values()) and diff > 1e-3
    del adm, model, samples
    torch.cuda.empty_cache()

    # (c) DeepCache on the CelebA-HQ-256 U-Net (no custom kernel)
    celeba = port_main.build_uncond(port_main.parse_args(
        ["--note", "chip_smoke", "--model_name", "CelebA_HQ_HF", "--result_folder",
         os.path.join(out, "celeba"), "--for_steps", "20", "--inv_steps", "20",
         "--performance_boosting_t", "0.2"]))
    unet2d, grid = celeba.model, celeba.fwd_grid
    xc = torch.randn(2, 3, 256, 256, device="cuda", generator=cuda_gen(16))
    outs = {}
    for what, fn in (
            ("plain", lambda: ddim_forward(unet2d, xc, celeba.schedule, grid)),
            ("interval 1", lambda: ddim_forward_deepcache(unet2d, xc, celeba.schedule,
                                                          grid, interval=1)),
            ("interval 3", lambda: ddim_forward_deepcache(unet2d, xc, celeba.schedule,
                                                          grid, interval=3))):
        with torch.no_grad():
            outs[what], seconds, _, launches, _ = drive(fa, fn)
        checks[f"(c) {what}: no K1–K5 launch"] = not any(launches.values())
        log(f"[extras] (c) CelebA-HQ-256 {what}, {grid.num_steps} steps at batch 2: "
            f"{seconds:.3f} s")
    top = outs["plain"].abs().max().item()
    d1 = (outs["interval 1"] - outs["plain"]).abs().max().item()
    rel3 = (torch.linalg.norm(outs["interval 3"] - outs["plain"])
            / torch.linalg.norm(outs["plain"])).item()
    log(f"[extras] (c) max |interval 1 − plain| {d1:.3g} (tol 1e-3 of max |x| {top:.3g}); "
        f"interval 3 relative distance {rel3:.4g}")
    checks["(c) interval 1 is the plain forward, interval 3 finite and near it"] = (
        d1 <= 1e-3 * top and bool(torch.isfinite(outs["interval 3"]).all())
        and 0 < rel3 < 1)
    del celeba, unet2d, outs
    torch.cuda.empty_cache()

    # (e) SDXL's rank-8 pullback, unchunked, with remat off and on
    xl = port_main.build_sdxl(port_main.parse_args(
        ["--note", "chip_smoke", "--model_name", port_main.SDXL_MODEL, "--result_folder",
         os.path.join(out, "sdxl"), "--for_steps", "10", "--inv_steps", "10",
         "--edit_t", "0.5", "--edit_prompt", "a photo of a tree"]))
    xl.cfg.pullback_chunk_size, xl.cfg.pullback_max_iter = None, 1
    xl_dtype = next(xl.unet.parameters()).dtype
    blocks = [m for m in xl.unet.modules() if hasattr(m, "remat")]
    zt = torch.randn(1, 128, 128, 4, device="cuda", generator=cuda_gen(8))
    t_xl = xl.fwd_grid.timesteps[xl.edit_t_idx]
    remat_runs = {}
    for remat in (False, True):
        xl.cfg.pullback_remat = remat
        for m in blocks:
            m.remat = remat
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() / 1e9
        res, seconds, peak, launches, path = drive(fa, lambda: xl.compute_local_basis(
            zt, t_xl, TapPoint("mid", 0), SDXL_RANK))
        expected = collections.Counter()
        pair_k2_k5(expected, xl_dtype, res.iterations, SDXL_PAIR[1], shapes=SDXL_PAIR[0],
                   rank=SDXL_RANK, remat=remat)
        checks[f"(e) remat {remat} launches by shape"] = check_launches(
            f"extras (e) remat {remat}", launches, path, expected)
        paths.append(path)
        remat_runs[remat] = res
        log(f"[extras] (e) SDXL rank-{SDXL_RANK} pullback unchunked, remat {remat} "
            f"({len(blocks)} transformers): {seconds:.3f} s, peak memory {peak:.2f} GB "
            f"({peak - base:.2f} GB above the {base:.2f} GB before it), "
            f"{res.iterations} iteration, sigma {res.s.tolist()}")
    cmp = compare_bases(*host(remat_runs[True]), *host(remat_runs[False]))
    log(f"[extras] (e) remat on vs off: sigma max rel err {cmp.sigma_rel_err.max():.3g}, "
        f"min |cos| per σ-gap group {cmp.per_direction_cos.min():.6f}")
    checks["(e) remat changes no number: σ rtol 1e-3, |cos| ≥ 0.99"] = passes_acceptance(
        cmp, cos_min=0.99, sigma_rtol=1e-3)
    del xl, remat_runs
    torch.cuda.empty_cache()

    for what, ok in checks.items():
        log(f"[extras] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("phase 11 checks failed")
    return paths


def phase_head_dim_models(fa):
    """Phase 12: the two model configs at head dims other than 64 and 512,
    where K1–K5 run 'wgmma' in bf16 and 'tf32x3' in f32.
    (b) SD 1.5 at full width, built directly into
    EditStableDiffusion as a user of the library builds it (no CLI of
    either package builds SD 1.5): the 859.5 M-parameter U-Net in bf16 with
    attn 'flash' (K1 at 8 heads of 40 over 4096 tokens and of 80 over
    1024), the SD VAE and the CLIP ViT-L tower in f32, seeded random
    weights drawn on the card, the bundled example images at 512 px,
    run_edit_local_encoder_pullback_zt at phase 4's settings with the
    fused pair in the pullback; its launches by shape held to the count the
    code gives, each stage's seconds and peak memory; (b') the same edit
    with the U-Net cast to f32, its launches by shape held likewise, every
    K1–K5 launch served by 'tf32x3' (at D = 40 and 80 among them), as the
    C entries count them; then its mid-tap
    pullback on the pair against the math path in f32. (c) ImageNet128Cond
    (421.5 M parameters, labels y) at full width: ε with K1 (4 heads of 128
    over 1024 tokens) against the math path in f32 and bf16, and the
    mid-tap rank-2 pullback on the pair against the math path in f32 and
    bf16; the f32 and the bf16 ε and pair pullback with their launches by
    shape, every f32 launch served by 'tf32x3' at D = 128, as the C entries
    count them. Every bf16 launch of these runs at the head dims 40, 80 and
    128 must have been served by 'wgmma', for each of K1–K5.
    Returns the path dicts of the SD 1.5 edits (bf16, f32) and of
    ImageNet128Cond's f32 and bf16 ε and pair pullback."""
    import numpy as np
    from PIL import Image

    from diffusion_pullback_tpu_torch.experiments import (
        BasisCache, EditStableDiffusion, SDExperimentConfig)
    from diffusion_pullback_tpu_torch.geometry import local_pullback
    from diffusion_pullback_tpu_torch.models import (
        AutoencoderKL, CLIPTextModel, TapPoint, UNet2DCondition, model_for_name,
        random_init_, sd15_text_encoder, sd15_unet, sd_vae)
    from diffusion_pullback_tpu_torch.models.layers import attn_impl_as
    from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
    from diffusion_pullback_tpu_torch.utils.datasets import get_dataset
    from diffusion_pullback_tpu_torch.utils.logging import JSONLLogger

    out = os.path.join(OUT, "sd15")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.device("cuda"):
        unet = random_init_(UNet2DCondition(sd15_unet(attn_impl="flash",
                                                      dtype="bfloat16")), 0)
        vae = random_init_(AutoencoderKL(sd_vae(attn_impl="flash")), 1)
        text = random_init_(CLIPTextModel(sd15_text_encoder()), 2)
    cfg = SDExperimentConfig(
        dataset_name="Examples", for_steps=10, inv_steps=10, edit_t=0.5,
        edit_prompt="a photo of a smiling face", pca_rank=PCA_RANK,
        x_space_guidance_num_step=2, pullback_min_iter=1, pullback_max_iter=3,
        pullback_attn_impl="flash", result_folder=out,
        obs_folder=os.path.join(out, "obs"), basis_folder=os.path.join(out, "inputs"))
    edit = EditStableDiffusion(
        unet, vae, text, DiffusionSchedule.from_name("scaled_linear"),
        get_dataset("Examples", 512), cfg,
        logger=JSONLLogger(os.path.join(out, "log.jsonl")), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in unet.parameters())
    log(f"[sd15] built the SD 1.5 driver in {time.perf_counter() - t0:.1f} s (weights "
        f"drawn on the card), peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB; U-Net {n_params} parameters {next(unet.parameters()).dtype}, head dims "
        f"{unet.config.attention_head_dim}, attn {unet.config.attn_impl}; CLIP ViT-L "
        f"{sum(p.numel() for p in text.parameters())} parameters; dataset of "
        f"{len(edit.dataset)}")

    vis_num, vis_num_pc = 2, 1
    n_dir = 2 * vis_num_pc
    stride = max(1, (cfg.x_space_guidance_num_step + 1) // vis_num)
    frames = len(range(0, cfg.x_space_guidance_num_step + 1, stride))
    paths, checks = [], {}

    def expected_edit(expected, events):
        edit_k1(expected, edit, n_dir, frames, (torch.bfloat16, torch.float32),
                unet=SD15_UNET)
        # the pullback: two self-attentions at each primal shape (mid tap)
        pair_k2_k5(expected, torch.bfloat16, named(events, "sd_local_pullback")[-1][
            "iterations"], layers=2, shapes=SD15_PAIR)

    names, events, _, seconds = checked_run(
        fa, "sd15", "edit", edit, lambda: edit.run_edit_local_encoder_pullback_zt(
            idx=0, pca_rank=PCA_RANK, vis_num=vis_num, vis_num_pc=vis_num_pc),
        expected_edit, checks, paths)
    for (sym, dsg), (_, n, ms) in sorted(by_design(fa, paths).items()):
        log(f"[sd15] {KERNELS[sym][0]} on {dsg}: {n} launches, {ms:.2f} ms on the "
            f"device ({100 * ms / 1e3 / seconds:.2f} % of the path)")
    pullback = named(events, "sd_local_pullback")[-1]
    u, s, vT = load_basis(os.path.join(cfg.basis_folder, os.listdir(cfg.basis_folder)[0]))
    log(f"[sd15] sigma {s.tolist()}, pullback {pullback['seconds']:.3f} s (encoder "
        f"{pullback['encoder']}, {pullback['iterations']} iterations)")
    finite = named(events, "sd_decode_and_save")
    checks.update({
        "(sd15) 859 520 964 parameters in bf16, attn flash": (
            n_params == 859_520_964 and next(unet.parameters()).dtype == torch.bfloat16
            and unet.config.attn_impl == "flash"),
        "(sd15) two PNGs of 3 frames at 512 px": len(names) == n_dir and all(
            Image.open(os.path.join(cfg.result_folder, n + ".png")).size
            == (512 * frames, 512) for n in names),
        "(sd15) edited latents and images finite": bool(finite and finite[-1]["finite"]),
        "(sd15) basis finite, expected shapes": (
            u.shape == (8 * 8 * 1280, PCA_RANK) and vT.shape == (PCA_RANK, 64 * 64 * 4)
            and all(np.isfinite(a).all() for a in (u, s, vT)) and (s > 0).all()),
        "(sd15) pullback through the fused pair": pullback["encoder"] == "flashpair",
        "(sd15) every kernel launched": {sym for sym, _, _ in paths[0]} == set(KERNELS),
    })

    # (b') the same edit with the U-Net in f32 (the same bf16-valued
    # weights), into basis and result folders of its own so that its
    # pullback and edits run: K1–K5 on 'tf32x3' at 8 heads of 40 over 4096
    # tokens and of 80 over 1024
    unet.to(torch.float32)
    cfg.basis_folder = os.path.join(out, "inputs_f32")
    cfg.result_folder = os.path.join(out, "f32")
    os.makedirs(cfg.result_folder, exist_ok=True)
    edit.cache = BasisCache(cfg.basis_folder)

    def expected_f32(expected, events):
        edit_k1(expected, edit, n_dir, frames, (F32, F32), unet=SD15_UNET)
        pair_k2_k5(expected, F32, named(events, "sd_local_pullback")[-1]["iterations"],
                   layers=2, shapes=SD15_PAIR)

    (names, designs), events, _, seconds = checked_run(
        fa, "sd15", "edit f32", edit, lambda: served_designs(
            fa, lambda: edit.run_edit_local_encoder_pullback_zt(
                idx=0, pca_rank=PCA_RANK, vis_num=vis_num, vis_num_pc=vis_num_pc)),
        expected_f32, checks, paths)
    launched = collections.Counter()
    for (sym, shape, _), (n, _) in paths[-1].items():
        launched[KERNELS[sym][0]] += n
        launched[(KERNELS[sym][0], shape[-1])] += n
    for (sym, dsg, d), (_, n, ms) in sorted(by_design(fa, paths[-1:], head_dim=True).items()):
        log(f"[sd15] f32 {KERNELS[sym][0]} on {dsg} at D={d}: {n} launches, {ms:.2f} ms on "
            f"the device ({100 * ms / 1e3 / seconds:.2f} % of the path)")
    s32 = load_basis(os.path.join(cfg.basis_folder, os.listdir(cfg.basis_folder)[0]))[1]
    log(f"[sd15] f32 edit: sigma {s32.tolist()}, launches by design as the C entries "
        f"counted them {dict(designs)}")
    finite = named(events, "sd_decode_and_save")
    checks.update({
        "(sd15) f32 edit: two PNGs of 3 frames, finite": len(names) == n_dir and all(
            Image.open(os.path.join(cfg.result_folder, n + ".png")).size
            == (512 * frames, 512) for n in names) and bool(finite and finite[-1]["finite"]),
        "(sd15) f32 edit: every K1–K5 launch on tf32x3": (
            sum(designs.values()) == sum(launched[k] for k in KERNELS_BY_LABEL)
            and all(designs[(k, "tf32x3")] == launched[k] > 0 for k in KERNELS_BY_LABEL)),
        "(sd15) f32 edit: K1–K5 at D = 40 and 80": all(
            launched[(k, d)] > 0 for k in KERNELS_BY_LABEL for d in (40, 80)),
    })

    # the mid-tap pullback on the pair and on the math path from the same
    # probes (the driver's seeded ones), 3 iterations, in f32 (the same
    # bf16-valued weights)
    cfg.pullback_min_iter = cfg.pullback_max_iter = 3
    cfg.pullback_atol = 0.0
    zt = torch.randn(1, 64, 64, 4, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(13))
    res = {}
    for impl in ("flash", "xla"):
        cfg.pullback_attn_impl = impl
        res[impl], seconds, peak, _, path = drive(fa, lambda: edit.compute_local_basis(
            zt, edit.fwd_grid.timesteps[edit.edit_t_idx], TapPoint("mid", 0), PCA_RANK))
        # K3's events on this pullback alone, beside the edit's above
        k3 = ", ".join(f"{shape} {n} launches {ms:.2f} ms" for (sym, shape, _), (n, ms)
                       in sorted(path.items()) if sym == "flash_tangent")
        log(f"[sd15] mid-tap pullback f32 {impl}: {seconds:.3f} s, peak memory {peak:.2f} GB"
            + (f"; K3 on the device: {k3}" if k3 else ""))
    pair_vs_math("mid-tap f32", res, phase="sd15")
    del edit, unet, vae, text, res
    torch.cuda.empty_cache()

    # ImageNet128Cond: ε and the mid-tap pullback with labels y, on the
    # same bf16-valued weights in f32 and in bf16
    with torch.device("cuda"):
        adm = random_init_(model_for_name("ImageNet128Cond", dtype="bfloat16",
                                          attn_impl="flash"), 0)
    adm = adm.eval().requires_grad_(False)
    n_params = sum(p.numel() for p in adm.parameters())
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn(1, 3, 128, 128, device="cuda", generator=gen)
    y = torch.tensor([207], device="cuda")
    v0 = torch.linalg.qr(torch.randn(x.numel(), PCA_RANK, device="cuda",
                                     generator=gen))[0].T
    checks["(adm128) 421 529 606 parameters, 1000 classes, attn flash"] = (
        n_params == 421_529_606 and adm.config.num_classes == 1000
        and adm.config.attn_impl == "flash")

    def eps(impl):
        with torch.no_grad(), attn_impl_as(adm, impl):
            return adm(x, 500.0, y=y).float()

    def enc(impl):
        def f(z):
            with attn_impl_as(adm, impl):
                return adm.encode(z, 500.0, TapPoint("mid"), y=y)
        return f

    kw = dict(pca_rank=PCA_RANK, min_iter=3, max_iter=3, atol=0.0, v_init=v0)
    pair_pullback = lambda: local_pullback(enc("flash_jvp"), x, fn_vjp=enc("flash"), **kw)
    math_pullback = lambda: local_pullback(enc("xla"), x, **kw)

    adm.to(torch.float32)
    eps_math = eps("xla")
    ((eps_flash, pair32), designs), seconds, peak_gb, launches, path = drive(
        fa, lambda: served_designs(fa, lambda: (eps("flash"), pair_pullback())))
    expected = collections.Counter()
    unet_k1(expected, 1, 1, F32, **ADM128_UNET)
    pair_k2_k5(expected, F32, pair32.iterations, layers=2, shapes=ADM128_PAIR)
    checks["(adm128) f32 launches by shape"] = check_launches("adm128 f32", launches, path,
                                                              expected)
    log(f"[adm128] f32 eps + pair pullback: {seconds:.3f} s, peak memory {peak_gb:.2f} GB, "
        f"launches by design as the C entries counted them {dict(designs)}")
    checks["(adm128) f32: every K1–K5 launch on tf32x3 at D = 128"] = (
        sum(designs.values()) == sum(launches.values())
        and {label for label, _ in designs} == set(KERNELS_BY_LABEL)
        and all(dsg == "tf32x3" for _, dsg in designs)
        and all(shape[-1] == 128 for _, shape, _ in path))
    paths.append(path)
    err, top = (eps_flash - eps_math).abs().max().item(), eps_math.abs().max().item()
    log(f"[adm128] full-width eps f32 (labels {y.tolist()}), flash vs math: "
        f"max_abs_err {err:.3g} (max |eps| {top:.3g}, tol 1e-4 relative)")
    checks["(adm128) eps f32 flash vs math"] = bool(
        torch.isfinite(eps_flash).all() and eps_flash.shape == (1, 6, 128, 128)
        and err <= 1e-4 * top)
    ref = pair_vs_math("mid-tap f32", {"flash": pair32, "xla": math_pullback()},
                       phase="adm128")

    adm.to(torch.bfloat16)
    (eps_bf16, pair), seconds, peak_gb, launches, path = drive(
        fa, lambda: (eps("flash"), pair_pullback()))
    expected = collections.Counter()
    unet_k1(expected, 1, 1, torch.bfloat16, **ADM128_UNET)
    pair_k2_k5(expected, torch.bfloat16, pair.iterations, layers=2, shapes=ADM128_PAIR)
    checks["(adm128) launches by shape"] = check_launches("adm128", launches, path,
                                                          expected)
    log(f"[adm128] bf16 eps + pair pullback: {seconds:.3f} s, peak memory "
        f"{peak_gb:.2f} GB, sigma {pair.s.tolist()}")
    paths.append(path)
    rel = lambda e: (torch.linalg.norm(e - eps_math) / torch.linalg.norm(eps_math)).item()
    err_flash, err_math = rel(eps_bf16), rel(eps("xla"))
    log(f"[adm128] full-width eps bf16: relative RMS error against f32 math, flash "
        f"{err_flash:.4g}, math {err_math:.4g} (tol 1.5 × math = {1.5 * err_math:.4g})")
    checks["(adm128) eps bf16 within 1.5x the bf16 math path"] = bool(
        torch.isfinite(eps_bf16).all() and err_flash <= 1.5 * err_math)
    pair_vs_math("mid-tap bf16", {"flash": pair, "xla": math_pullback()}, ref,
                 phase="adm128")
    del adm
    torch.cuda.empty_cache()
    served = collections.Counter()
    for path in paths:
        for (sym, shape, dtype), (n, _) in path.items():
            if dtype == torch.bfloat16:  # the f32 edit's are checked above
                label = KERNELS[sym][0]
                served[(label, fa.design(label, shape[-1], dtype))] += n
    log(f"[dims] launches by kernel and design: {dict(served)}")
    checks["(sd15, adm128) K1–K5 on wgmma"] = (
        {label for label, _ in served} == set(KERNELS_BY_LABEL) and all(
            dsg == "wgmma" for _, dsg in served))
    for what, ok in checks.items():
        log(f"[dims] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("phase 12 checks failed")
    return paths


def phase_train(fa):
    """Phase 13: training through the library API (the JAX package has no
    training CLI): ImageNet256Uncond at full width in bf16 with attn
    'flash', seeded random weights drawn on the card, f32 master params in
    create_train_state with AdamW (lr 1e-4, no weight decay) and EMA rates
    (0.9999, 0.99995); a batch of the bundled images at 256 px (TRAIN_BATCH,
    or the largest of 2 and 1 that fits); 3 steps of the hybrid objective
    (λ 0.001) with loss-aware t, then 2 with accum_steps=2. Each step: the
    loss and grad_norm finite, the counter advancing, each EMA copy closer
    to the params by its own rate, its seconds and peak memory, and its
    K2/K4/K5 launches by shape (5 layers × one each per microbatch), all on
    'wgmma'. Then one step's gradients on the fused pair against the math
    path from the same params, batch and draws in bf16 (the losses held to
    f32 math as phase 8's bf16 gates, the per-tensor gradient cosine ≥ 0.99
    on every tensor whose norm is above 1e-3 of the largest); a
    CheckpointManager round trip, bit for bit, and one more step from the
    state and from its restored copy, bit for bit; and calc_bpd_loop on the
    first EMA copy over a 50-step linear schedule at batch 1 (K1), finite.
    Returns the path dicts of the steps and of calc_bpd_loop."""
    import functools

    from diffusion_pullback_tpu_torch.models import model_for_name, random_init_
    from diffusion_pullback_tpu_torch.models.layers import attn_impl_as
    from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
    from diffusion_pullback_tpu_torch.training import (
        create_train_state, init_loss_aware, make_train_step)
    from diffusion_pullback_tpu_torch.training.checkpoint import CheckpointManager
    from diffusion_pullback_tpu_torch.training.losses import calc_bpd_loop
    from diffusion_pullback_tpu_torch.training.train import draws_of
    from diffusion_pullback_tpu_torch.utils.datasets import get_dataset

    out = os.path.join(OUT, "train")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.device("cuda"):
        model = random_init_(model_for_name("ImageNet256Uncond", dtype="bfloat16",
                                            attn_impl="flash"), 0)
    adamw = functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=0.0)
    rates = (0.9999, 0.99995)
    state = create_train_state(model.state_dict(), adamw, n_ema=len(rates))
    sched = DiffusionSchedule.linear()
    ds = get_dataset("Examples", 256)
    images = torch.cat([torch.from_numpy(ds[i]) for i in range(len(ds))]).permute(
        0, 3, 1, 2).contiguous().cuda()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    log(f"[train] built ImageNet256Uncond ({n_params} parameters, module "
        f"{next(model.parameters()).dtype}, attn {model.config.attn_impl}) and its "
        f"train state (f32 masters, EMA {rates}, AdamW) in "
        f"{time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {len(ds)} bundled images "
        f"at 256 px in [{images.min().item():.3f}, {images.max().item():.3f}]")
    checks = {
        "552 814 086 parameters, f32 masters of a bf16 module, attn flash": (
            n_params == 552_814_086 and next(model.parameters()).dtype == BF16
            and model.config.attn_impl == "flash"
            and all(v.dtype == F32 for v in state.params.values())),
    }
    hybrid = dict(learn_sigma_vb_weight=0.001, loss_aware=True)
    gen = torch.Generator(device="cuda").manual_seed(15)
    sampler = init_loss_aware(sched.num_train_timesteps, device="cuda")
    paths, steps = [], []

    def train_step(step_fn, x0, accum, tag):
        """One driven step: its launches by shape, the step checks."""
        nonlocal state, sampler
        # every 8th tensor of each EMA copy as it was (all of them would add
        # 4.4 GB to the step's peak)
        names = list(state.params)[::8]
        old = [{k: ema[k].clone() for k in names} for ema in state.ema_params]
        before = state.step
        (state, metrics, sampler), seconds, peak, launches, path = drive(
            fa, lambda: step_fn(state, x0, gen, sampler))
        bh = 8 * x0.shape[0] // accum
        expected = collections.Counter({
            (sym, (bh, 1024, 64), BF16): ADM_UNET["at_1024"] * accum
            for sym in ("flash_fwd_lse", "flash_dq", "flash_dkv")})
        ok = check_launches(f"train {tag}", launches, path, expected)
        ok &= all(fa.design(KERNELS[sym][0], shape[-1], dt) == "wgmma"
                  for sym, shape, dt in path)
        ratios = []
        with torch.no_grad():
            for ema, prev in zip(state.ema_params, old):
                sq = lambda tree: sum(((tree[k] - state.params[k]).double() ** 2).sum()
                                      for k in names)
                ratios.append(math.sqrt(sq(ema).item() / sq(prev).item()))
        del old
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        kernel_ms = sum(ms for _, ms in path.values())
        log(f"[train] step {state.step} ({tag}, batch {x0.shape[0]}, accum_steps "
            f"{accum}): {seconds:.3f} s, peak memory {peak:.2f} GB, loss {loss:.5f}, "
            f"grad_norm {gnorm:.5f}, |EMA − p| ratios {ratios} (rates {rates}), "
            f"K2/K4/K5 {kernel_ms:.2f} ms on the device "
            f"({100 * kernel_ms / 1e3 / seconds:.2f} % of the step)")
        checks[f"(step {state.step}) loss and grad_norm finite, counter advanced, "
               "EMA by its rates, launches by shape on wgmma"] = bool(
            math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0
            and state.step == metrics["step"] == before + 1 and ok
            and all(abs(r - rate) <= 1e-5 for r, rate in zip(ratios, rates)))
        paths.append(path)
        steps.append((seconds, peak))

    step = make_train_step(model, sched, adamw, ema_rate=rates, **hybrid)
    for batch in (TRAIN_BATCH, TRAIN_BATCH // 2, 1):
        try:
            train_step(step, images[:batch], 1, "hybrid, loss-aware")
            break
        except torch.OutOfMemoryError:
            for p in state.params.values():
                p.grad = None
            torch.cuda.empty_cache()
            log(f"[train] batch {batch} does not fit in the card's memory")
    else:
        raise AssertionError("no batch of 4, 2 or 1 fits for training")
    x0 = images[:batch]
    log(f"[train] batch {batch}")
    for _ in range(2):
        train_step(step, x0, 1, "hybrid, loss-aware")
    accum = min(2, batch)
    step2 = make_train_step(model, sched, adamw, ema_rate=rates, accum_steps=accum,
                            **hybrid)
    for _ in range(2):
        train_step(step2, x0, accum, "hybrid, loss-aware")
    checks["sampler history recorded"] = int(sampler.counts.sum()) == 5 * batch
    seconds = [s for s, _ in steps]
    log(f"[train] step seconds {seconds}, peak memory {max(p for _, p in steps):.2f} GB")

    # one step's gradients on the fused pair and on the math path from the
    # same params, batch and draws (SGD at lr 0 leaves the params), in bf16
    # and, as the reference, in f32 on the math path
    t = torch.randint(0, sched.num_train_timesteps, (batch,), device="cuda",
                      generator=gen)
    noise = torch.randn(x0.shape, device="cuda", generator=gen)
    draw = draws_of(t, torch.ones(batch, device="cuda"), noise)
    still = functools.partial(torch.optim.SGD, lr=0.0)
    probe = create_train_state(state.params, still)
    loss, grads = {}, {}
    for name, dtype, impl in (("pair", BF16, "flash"), ("math", BF16, "xla"),
                              ("f32 math", F32, "xla")):
        model.to(dtype)
        with attn_impl_as(model, impl):
            probe, metrics = make_train_step(model, sched, still, ema_rate=0.0,
                                             learn_sigma_vb_weight=0.001)(
                probe, x0, draw=draw)
        loss[name] = metrics["loss"].item()
        if name != "f32 math":
            grads[name] = {k: p.grad.clone() for k, p in probe.params.items()}
    model.to(BF16)
    norms = {k: g.norm().item() for k, g in grads["math"].items()}
    top = max(norms.values())
    cos = {k: (torch.dot(grads["pair"][k].flatten(), g.flatten())
               / (grads["pair"][k].norm() * g.norm())).item()
           for k, g in grads["math"].items() if norms[k] > 1e-3 * top}
    d_pair, d_math = (abs(loss[n] - loss["f32 math"]) for n in ("pair", "math"))
    worst = min(cos, key=cos.get)
    log(f"[train] one step's loss: pair {loss['pair']:.6f}, math {loss['math']:.6f} "
        f"(bf16), f32 math {loss['f32 math']:.6f}; distance from f32 math: pair "
        f"{d_pair:.4g}, math {d_math:.4g} (tol 1.5 × math = {1.5 * d_math:.4g}); "
        f"gradient cosine pair vs math over {len(cos)} of {len(norms)} tensors "
        f"(norm > 1e-3 of the largest): min {cos[worst]:.6f} at {worst}, mean "
        f"{sum(cos.values()) / len(cos):.6f}")
    checks["(pair vs math) losses within phase 8's bf16 gate"] = d_pair <= 1.5 * d_math
    checks["(pair vs math) gradient cosine >= 0.99"] = min(cos.values()) >= 0.99
    del probe, grads

    # checkpoint round trip, then one more step from both copies
    mgr = CheckpointManager(os.path.join(out, "ckpt"), keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = mgr.save(state)
    save_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)) / 1e9
    t0 = time.perf_counter()
    restored = mgr.restore(create_train_state(state.params, adamw, n_ema=len(rates)))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0

    def same(a, b):
        trees = lambda s: (s.params, *s.ema_params)
        oa, ob = a.opt_state.state_dict(), b.opt_state.state_dict()
        return (a.step == b.step and all(
            torch.equal(ta[k], tb[k]) for ta, tb in zip(trees(a), trees(b)) for k in ta)
            and oa["param_groups"] == ob["param_groups"] and all(
                torch.equal(v, ob["state"][i][n]) for i, st in oa["state"].items()
                for n, v in st.items()))

    checks["(checkpoint) restored bit for bit"] = same(state, restored)
    plain_step = make_train_step(model, sched, adamw, ema_rate=rates,
                                 learn_sigma_vb_weight=0.001)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state, _ = plain_step(state, x0, draw=draw)
        restored, _ = plain_step(restored, x0, draw=draw)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    checks["(checkpoint) one more step from both copies bit for bit"] = same(state, restored)
    log(f"[train] checkpoint step {mgr.latest_step()}: {size:.2f} GB written in "
        f"{save_s:.1f} s, restored in {restore_s:.1f} s")
    del restored
    shutil.rmtree(out, ignore_errors=True)

    # the bound on the first EMA copy, 50-step linear schedule, batch 1
    cast = {k: v.to(BF16) for k, v in state.ema_params[0].items()}

    def model_fn(xt, tb):
        eps = torch.func.functional_call(model, cast, (xt, tb)).float()
        return eps[:, :3], eps[:, 3:]

    sched50 = DiffusionSchedule.linear(num_train_timesteps=50)
    noise = torch.randn((50, 1, 3, 256, 256), device="cuda", generator=gen)
    bpd, seconds, peak, launches, path = drive(
        fa, lambda: calc_bpd_loop(sched50, model_fn, x0[:1], noise=noise))
    expected = collections.Counter({("flash_fwd", (8, 1024, 64), BF16): 5 * 50})
    checks["(calc_bpd_loop) launches by shape"] = check_launches(
        "train bpd", launches, path, expected)
    paths.append(path)
    log(f"[train] calc_bpd_loop (T = 50, batch 1, EMA 0.9999): {seconds:.3f} s, peak "
        f"memory {peak:.2f} GB, total_bpd {bpd['total_bpd'].tolist()}, prior_bpd "
        f"{bpd['prior_bpd'].tolist()}")
    checks["(calc_bpd_loop) finite, (50, 1) per step"] = all(
        torch.isfinite(v).all().item() for v in bpd.values()) and all(
        bpd[k].shape == (50, 1) for k in ("vb", "xstart_mse", "mse"))
    del model, state, cast
    torch.cuda.empty_cache()
    for what, ok in checks.items():
        log(f"[train] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("phase 13 checks failed")
    return paths

def trace_label(name):
    """K1–K5 of a device kernel's name in a profiler trace (K2 is the
    forward kernel instantiated with its LSE output on), None for others
    (PyTorch's own flash kernels, pytorch_flash::…, included)."""
    if "pytorch" in name:
        return None
    for stem, label in (("flash_tangent", "K3"), ("flash_dkv", "K5"), ("flash_dq", "K4")):
        if stem in name:
            return label
    if "flash_fwd" in name:
        return "K2" if "true>(" in name else "K1"
    return None


def read_trace(folder):
    """(K1–K5 device kernel counts, the device's idle share over the traced
    window, the top five device ops by summed time as (name, ms, count),
    the window's seconds) of the one Chrome trace in ``folder``. The window
    runs from the first device event's start to the last one's end; idle is
    1 − (union of kernel, memcpy and memset intervals) ÷ window."""
    (name,) = os.listdir(folder)
    with open(os.path.join(folder, name)) as f:
        events = json.load(f)["traceEvents"]
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e)
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda x: x[0])
    if not dev:
        raise AssertionError(f"the trace {name} holds no device event")
    busy, (cur0, cur1) = 0.0, dev[0][:2]
    for t0, t1, _ in dev[1:]:
        if t0 > cur1:
            busy, cur0, cur1 = busy + cur1 - cur0, t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    window = max(t1 for _, t1, _ in dev) - dev[0][0]
    counts, by_name = collections.Counter(), collections.defaultdict(lambda: [0.0, 0])
    for t0, t1, e in dev:
        by_name[e["name"]][0] += (t1 - t0) / 1e3
        by_name[e["name"]][1] += 1
        if e["cat"] == "kernel" and trace_label(e["name"]):
            counts[trace_label(e["name"])] += 1
    top = sorted(((n, ms, c) for n, (ms, c) in by_name.items()), key=lambda x: -x[1])[:5]
    return counts, 1.0 - busy / window, top, window / 1e6


def psnr(a, b):
    """PSNR in dB of two uint8 images scaled to [0, 1]."""
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) / 255 - b.astype(np.float64) / 255) ** 2))
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))


def phase_tooling(fa):
    """Phase 14 (module docstring)."""
    import numpy as np
    from PIL import Image

    from diffusion_pullback_tpu_torch import main as port_main
    from diffusion_pullback_tpu_torch.experiments import BasisCache
    from diffusion_pullback_tpu_torch.models import TapPoint
    from diffusion_pullback_tpu_torch.models.layers import attn_impl_as
    from diffusion_pullback_tpu_torch.utils import aot, flops, native
    from diffusion_pullback_tpu_torch.utils.datasets import ImgDataset

    root = tempfile.mkdtemp(prefix="chip_smoke_tooling_")
    exports = os.path.join(root, "exports")
    checks, paths, runs = {}, [], {}
    real_dir, real_export, cwd = aot.default_export_dir, torch.export.export, os.getcwd()

    def refused(*args, **kwargs):
        raise AssertionError("a program was exported again instead of loaded")

    real_build = port_main.build_sd

    def build_sd(args):
        """build_sd with phase 4's settings: the weights drawn on the card
        (as phase 9 draws them), 1–3 power iterations."""
        with torch.device("cuda"):
            edit = real_build(args)
        edit.cfg.pullback_min_iter, edit.cfg.pullback_max_iter = 1, 3
        return edit

    aot.default_export_dir = lambda: exports
    port_main.build_sd = build_sd
    try:
        for run in ("export", "load"):
            folder = os.path.join(root, run)
            os.makedirs(folder)
            os.chdir(folder)   # the CLI's ./inputs basis cache, one per run
            argv = ["--note", "chip_smoke_tooling", "--result_folder",
                    os.path.join(folder, "runs"), "--dataset_name", "Examples",
                    "--for_steps", "10", "--inv_steps", "10", "--edit_t", "0.5",
                    "--pca_rank", str(PCA_RANK), "--x_space_guidance_num_step", "2",
                    "--edit_prompt", "a photo of a smiling face",
                    "--run_edit_local_encoder_pullback_zt", "True",
                    "--profile_dir", os.path.join(folder, "trace"), "--aot_export", "on"]
            torch.export.export = real_export if run == "export" else refused
            edit, seconds, peak, launches, path = drive(fa, lambda: port_main.main(argv))
            torch.export.export = real_export
            os.chdir(cwd)
            events = read_events(edit)
            log_stages(f"tooling {run}", events)
            cfg = edit.cfg
            pullback = named(events, "sd_local_pullback")[-1]
            n_dir, frames = 4, len(range(0, cfg.x_space_guidance_num_step + 1,
                                         max(1, (cfg.x_space_guidance_num_step + 1) // 4)))
            dtypes = (next(edit.unet.parameters()).dtype, next(edit.vae.parameters()).dtype)
            expected = collections.Counter()
            edit_k1(expected, edit, n_dir, frames, dtypes)
            pair_k2_k5(expected, dtypes[0], pullback["iterations"], layers=2)
            checks[f"({run}) launches by shape"] = check_launches(
                f"tooling {run}", launches, path, expected)
            counts, idle, top, window = read_trace(os.path.join(folder, "trace"))
            by_label = {KERNELS[sym][0]: n for sym, n in launches.items()}
            staged = sum(e["seconds"] for e in events if "seconds" in e
                         and e["event"] != "aot_program")
            log(f"[tooling {run}] main path {seconds:.3f} s under the profiler (its "
                f"stages {staged:.3f} s), peak "
                f"memory {peak:.2f} GB; trace window {window:.3f} s, device idle share "
                f"{idle:.4f}; K1–K5 in the trace {dict(sorted(counts.items()))}, "
                f"launched {by_label}")
            for name, ms, n in top:
                log(f"[tooling {run}] top device op {ms:.3f} ms over {n} calls: {name[:120]}")
            checks[f"({run}) K1–K5 in the trace as often as launched"] = (
                dict(counts) == {k: n for k, n in by_label.items() if n}
                and all(by_label.values()))
            programs = [(e["name"], e["status"], e.get("seconds", 0.0)) for e in events
                        if e["event"] == "aot_program"]
            log(f"[tooling {run}] programs " + ", ".join(
                f"{n} {st} in {sec:.3f} s" for n, st, sec in programs))
            want = "exported" if run == "export" else "loaded"
            checks[f"({run}) every program {want}"] = sorted(
                (n, st) for n, st, _ in programs) == sorted(
                [("vae_encode", want), ("eps", want), ("eps", want), ("vae_decode", want)])
            basis_folder = os.path.join(folder, cfg.basis_folder)   # ./inputs/…
            basis = os.listdir(basis_folder)
            pngs = sorted(n for n in os.listdir(cfg.result_folder) if n.endswith(".png"))
            runs[run] = dict(
                basis=load_basis(os.path.join(basis_folder, basis[0])),
                pngs={n: np.asarray(Image.open(os.path.join(cfg.result_folder, n)))
                      for n in pngs},
                pullback=pullback, edit=edit if run == "load" else None,
                format=os.path.splitext(basis[0])[1])
            paths.append(path)
            del edit
    finally:
        torch.export.export = real_export
        aot.default_export_dir = real_dir
        port_main.build_sd = real_build
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)

    first, second = runs["export"], runs["load"]
    worst = min(psnr(first["pngs"][n], second["pngs"][n]) for n in first["pngs"])
    s0, s1 = first["basis"][1], second["basis"][1]
    srel = float(np.max(np.abs(s1 - s0) / np.abs(s0)))
    log(f"[tooling] loaded run against the exported one: {len(first['pngs'])} PNGs, "
        f"worst PSNR {worst:.2f} dB, sigma {s0.tolist()} vs {s1.tolist()} (max rel "
        f"err {srel:.3g}); basis files {first['format']}")
    checks["(load) same PNGs, PSNR >= 35 dB"] = (
        len(first["pngs"]) == 4 and first["pngs"].keys() == second["pngs"].keys()
        and worst >= 35.0)
    checks["(load) sigma within rtol 1e-3"] = srel <= 1e-3
    checks["basis written as .dpb by the native library"] = (
        native.get_lib() is not None and first["format"] == ".dpb")

    # the mid-tap pullback's FLOPs at pca_rank 2 and its stage's MFU (the
    # loaded run's stage: no export and no profiler in it)
    edit = second["edit"]
    t_edit = edit.fwd_grid.timesteps[edit.edit_t_idx]
    zt = torch.randn(1, 64, 64, 4, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(14))
    counted = {}
    for impl in ("flash", "xla"):
        edit.cfg.pullback_attn_impl = impl
        enc, enc_vjp, tag = edit._pullback_tap_encoders(t_edit, TapPoint("mid", 0))
        t0 = time.perf_counter()
        counted[impl] = flops.pullback_flops(
            lambda _, z: enc(z), None, zt, PCA_RANK, second["pullback"]["iterations"],
            fn_vjp=enc_vjp and (lambda _, z: enc_vjp(z)))
        log(f"[tooling] pullback FLOPs ({tag}, pca_rank {PCA_RANK}, "
            f"{second['pullback']['iterations']} iterations): {counted[impl]:.6g}, "
            f"counted in {time.perf_counter() - t0:.2f} s")
    edit.cfg.pullback_attn_impl = "flash"
    fields = flops.mfu_fields(counted["flash"], second["pullback"]["seconds"])
    log(f"[tooling] pullback stage {second['pullback']['seconds']:.3f} s on the pair: "
        f"{json.dumps(fields)} (peak {flops.peak_bf16_tflops()} TFLOP/s bf16)")
    checks["pullback FLOPs counted, MFU reported"] = (
        all(v and v > 0 for v in counted.values()) and "mfu_vs_bf16_peak" in fields)

    # ε at full width: the same FLOPs with K1 as with the math path
    emb = edit.for_prompt_emb
    eps = {}
    for impl in ("flash", "xla"):
        with torch.no_grad(), attn_impl_as(edit.unet, impl):
            eps[impl] = flops.compiled_flops(edit.eps_with(emb), zt, t_edit)
    log(f"[tooling] full-width eps FLOPs: flash {eps['flash']:.6g}, xla {eps['xla']:.6g}")
    checks["eps counts the same FLOPs with flash and xla"] = eps["flash"] == eps["xla"]

    # native I/O: the bundled images through the threaded decoder, a basis
    # through the .dpb store
    ds = ImgDataset(os.path.join(HERE, "datasets", "examples"), 512)
    t0 = time.perf_counter()
    batch = ds.load_batch()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    items = np.concatenate([ds[i] for i in range(len(ds))])
    item_s = time.perf_counter() - t0
    levels = float(np.abs(batch - items).max() * 255 / 2)
    log(f"[tooling] has_codecs() {native.has_codecs()}; load_batch of {len(ds)} images "
        f"at 512 px {load_s:.3f} s against {item_s:.3f} s by __getitem__, max "
        f"difference {levels:.3f} levels")
    checks["load_batch within one level of __getitem__"] = (
        batch.shape == items.shape and levels <= 1.0)
    u, s, vT = (np.random.default_rng(14).standard_normal(shape).astype(np.float32)
                for shape in ((8 * 8 * 1280, PCA_RANK), (PCA_RANK,), (PCA_RANK, 64 * 64 * 4)))
    with tempfile.TemporaryDirectory() as tmp:
        written = BasisCache(tmp).save("b", u, s, vT)
        back = load_basis(written)
    checks[".dpb basis bit for bit"] = written.endswith(".dpb") and all(
        np.array_equal(np.asarray(a), b) for a, b in zip(back, (u, s, vT)))
    del edit, runs, first, second
    torch.cuda.empty_cache()
    for what, ok in checks.items():
        log(f"[tooling] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("phase 14 checks failed")
    return paths

def ring_gate(out, dense, math32, dtype):
    """The merged ring against the dense f32 math: in f32 TF32X3_TOL (the
    shards' K2 on 'tf32x3' and the merge in f32), in bf16 no further than
    twice dense K1's own distance from it (the ring rounds P to bf16
    against each shard's running max, K1 against the whole row's) plus half
    a bf16 ulp of max |math|: each shard's output reaches the merge rounded
    to bf16 (K2's O is in q's dtype, as in the JAX ring), one rounding more
    than K1's. On the q, k and v of SD's bf16 VAE at sp 2 that rounding
    alone takes the ring 2.11x dense K1's distance from the math, on K2 and
    on its plain version alike, while the same ring fed f32 shard outputs
    lands on dense K1's distance."""
    err = (out.float() - math32).abs().max().item()
    if dtype == torch.float32:
        return err, TF32X3_TOL
    half_ulp = 0.5 * torch.finfo(dtype).eps * 2.0 ** math.floor(
        math.log2(math32.abs().max().item()))
    return err, 2 * (dense.float() - math32).abs().max().item() + half_ulp


def served_designs(fa, fn):
    """(fn's result, its launches by (kernel, design) as the C entries count
    them in the branch that launched each kernel)."""
    pairs = [(k, d) for k in fa.KERNELS for d in fa.DESIGNS]
    before = {kd: fa.served(*kd) for kd in pairs}
    out = fn()
    torch.cuda.synchronize()
    return out, collections.Counter(
        {kd: fa.served(*kd) - before[kd] for kd in pairs if fa.served(*kd) > before[kd]})


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def vae_qkv():
    """[(label, (q, k, v))]: the q, k and v (1, S, 1, 512) that the
    encoder's mid-block attention of a VAE built in bf16 through the
    library (sd_vae(dtype='bfloat16'), full width, seeded weights drawn on
    the card) computes from a bundled image: SD's VAE at 512 px (4096
    tokens) and SDXL's at 1024 px (16 384), captured where the attention
    layer calls ``attention``."""
    import numpy as np

    from diffusion_pullback_tpu_torch.models import AutoencoderKL, layers, random_init_, sd_vae
    from diffusion_pullback_tpu_torch.utils.datasets import get_dataset

    out = []
    for name, px, over, seed in (("SD VAE", 512, {}, 1),
                                 ("SDXL VAE", 1024, {"scaling_factor": 0.13025}, 3)):
        with torch.device("cuda"):
            vae = random_init_(AutoencoderKL(sd_vae(attn_impl="flash", dtype="bfloat16",
                                                    **over)), seed)
        vae.eval().requires_grad_(False)
        x = torch.as_tensor(np.asarray(get_dataset("Examples", px)[0]), device="cuda")
        x = x.reshape(1, px, px, 3).permute(0, 3, 1, 2).contiguous()
        seen, attention = [], layers.attention

        def capture(q, k, v, *args, **kwargs):
            seen.append((q, k, v))
            return attention(q, k, v, *args, **kwargs)

        layers.attention = capture
        try:
            with torch.no_grad():
                vae.encode(x)
        finally:
            layers.attention = attention
        if len(seen) != 1 or seen[0][0].shape != (1, (px // 8) ** 2, 1, 512):
            raise AssertionError(f"{name}: the encoder's attention calls "
                                 f"{[tuple(t[0].shape) for t in seen]}, expected one "
                                 f"at (1, {(px // 8) ** 2}, 1, 512)")
        q, k, v = (t.contiguous() for t in seen[0])
        log(f"[ring] {name} bf16 at {px} px: captured q, k, v {tuple(q.shape)} "
            f"{q.dtype}, max |q| {q.abs().max().item():.3g}")
        out.append((f"{name} {px} px {tuple(q.shape)} bf16", (q, k, v)))
        del vae, x
    torch.cuda.empty_cache()
    return out


def phase_parallel(fa):
    """Phase 15, the device mesh (parallel/):
    (a) ring attention's per-rank loop (ring_merge) over n = 2 and 4
        virtual ranks in one process, the K/V shards handed in ring order,
        K2 per ring step at the shard shapes of RING_CASES (SD 2.1-base's
        self-attentions in bf16 on 'wgmma', the VAE's 512-wide head in f32
        on 'tf32x3' and in bf16 on 'mma_bf16', the latter also on the q, k
        and v that bf16 VAEs built through the library compute at 512 and
        1024 px, vae_qkv): its n² K2 launches counted, the ring held to the
        same ring on K2's plain version (K2's gates, one more bf16 ulp for
        the merged output's final rounding) and to the dense f32 math
        (ring_gate), the design of each launch as the C entries counted
        it in the branch that launched it (served_designs);
    (b) NCCL at world size 1: make_mesh(('dp', 'probe', 'sp', 'tp')), the
        probe-sharded pullback of the full-width SD 2.1-base U-Net's mid
        tap (the fused pair, pca_rank 2, injected probes) against
        local_pullback, dp_vmap over two such pullbacks, and ring_attention
        over the one-rank 'sp' group (one K2) against dense K1;
    (c) the CLI at one rank with --mesh_axes sp:4: the preset's auto →
        ring, build_mesh's single-chip line and no mesh, the pullback on
        the pair, and one full-width U-Net pass of the driver main.main
        built launching K1 at every self-attention, as 'flash' does (the
        ring's fallback on the card)."""
    import torch.distributed as dist

    from diffusion_pullback_tpu_torch.geometry import local_pullback
    from diffusion_pullback_tpu_torch.models import (TapPoint, UNet2DCondition,
                                                     random_init_, sd21_base_unet)
    from diffusion_pullback_tpu_torch.models.layers import attn_impl_as
    from diffusion_pullback_tpu_torch.parallel import (dp_vmap, make_mesh,
                                                       make_sharded_pullback,
                                                       ring_attention)
    from diffusion_pullback_tpu_torch.parallel.mesh import mesh_shape
    from diffusion_pullback_tpu_torch.parallel.ring_attention import (
        _partial_flash, ring_attention_virtual)

    paths, checks = [], {}
    gen = torch.Generator(device="cuda").manual_seed(15)
    fold = lambda x: x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[-1])
    cases = [(f"({bh},{s},{d}) {str(dtype)[6:]}", tuple(
        torch.randn(1, s, bh, d, device="cuda", generator=gen).to(dtype) for _ in range(3)))
        for (bh, s, d), dtype in RING_CASES]
    cases += vae_qkv()
    for what, (q, k, v) in cases:
        _, s, bh, d = q.shape
        dtype = q.dtype
        scale = d ** -0.5
        dense = fa.flash_forward(fold(q), fold(k), fold(v), scale)
        math32 = fa.flash_forward_plain(*(fold(t).float() for t in (q, k, v)), scale)
        for n in RING_NS:
            (out, designs), seconds, _, launches, path = drive(
                fa, lambda: served_designs(
                    fa, lambda: ring_attention_virtual(q, k, v, n, inner="flash")))
            expected = collections.Counter({("flash_fwd_lse", (bh, s // n, d), dtype): n * n})
            tag = f"{what} over {n}"
            checks[f"(a) {tag}: {n * n} K2 launches at the shard shape"] = check_launches(
                "ring", launches, path, expected)
            plain = ring_attention_virtual(
                q, k, v, n, partial=lambda a, b, c: _partial_flash(
                    a, b, c, scale, fa.flash_forward_lse_plain))
            out_bh = fold(out)
            design = fa.design("K2", d, dtype)
            # the merge is a convex combination of the shards' outputs in
            # f32, so it keeps K2's gate; in bf16 the final cast may round
            # the other way, one ulp of max |plain| more
            ref = fold(plain)
            e_plain = (out_bh.float() - ref.float()).abs().max().item()
            t_plain = pair_tol(ref) * (1.0 if dtype == torch.float32 else 1.5)
            e_dense, t_dense = ring_gate(out_bh, dense, math32, dtype)
            e_k1 = (dense.float() - math32).abs().max().item()
            log(f"[ring] {tag}: {seconds:.4f} s, vs the ring on K2's plain version "
                f"{e_plain:.3g} (tol {t_plain:.3g}), vs the dense f32 math {e_dense:.3g} "
                f"(tol {t_dense:.3g}; dense K1's {e_k1:.3g}), "
                f"the rule's design {design}, launches by design as the C entries "
                f"counted them {dict(designs)}")
            checks[f"(a) {tag}: within K2's gate of the plain ring"] = e_plain <= t_plain
            checks[f"(a) {tag}: within the ring gate of dense attention"] = e_dense <= t_dense
            want = "tf32x3" if dtype == torch.float32 else "mma_bf16" if d == 512 else "wgmma"
            checks[f"(a) {tag}: every K2 launch served by {want}"] = (
                design == want and designs == {("K2", want): n * n})
            paths.append(path)
        del q, k, v, dense, math32
    del cases
    torch.cuda.empty_cache()

    # (b) NCCL at world size 1
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(("dp", "probe", "sp", "tp"), device="cuda")
        log(f"[mesh] {dist.get_backend()} mesh {mesh_shape(mesh)}")
        checks["(b) the mesh: NCCL, every axis 1"] = (
            dist.get_backend() == "nccl" and set(mesh_shape(mesh).values()) == {1})
        unet = random_init_(UNet2DCondition(sd21_base_unet(attn_impl="flash")), 0)
        unet = unet.cuda().eval().requires_grad_(False).to(torch.bfloat16)
        z = torch.randn(2, 1, 4, 64, 64, device="cuda", generator=gen)
        ctx = torch.randn(1, 77, 1024, device="cuda", generator=gen)
        v0 = torch.stack([torch.linalg.qr(torch.randn(z[0].numel(), PCA_RANK, device="cuda",
                                                      generator=gen))[0].T for _ in range(2)])

        def enc(impl):
            def f(x):
                with attn_impl_as(unet, impl):
                    return unet.encode(x, 500.0, ctx, TapPoint("mid"))
            return f

        kw = dict(pca_rank=PCA_RANK, min_iter=3, max_iter=3, atol=0.0)
        runner = make_sharded_pullback(enc("flash_jvp"), mesh, fn_vjp=enc("flash"),
                                       v_init=v0[0], **kw)
        res, seconds, peak, launches, path = drive(fa, lambda: runner(z[0], None))
        expected = collections.Counter()
        pair_k2_k5(expected, torch.bfloat16, 3, layers=2)
        checks["(b) sharded pullback: K2–K5 launches"] = check_launches(
            "mesh", launches, path, expected)
        paths.append(path)
        ref = local_pullback(enc("flash_jvp"), z[0], fn_vjp=enc("flash"), v_init=v0[0], **kw)
        srel = ((res.s - ref.s).abs() / ref.s).max().item()
        cos = (res.vT * ref.vT).sum(dim=1).abs().min().item()
        same = torch.equal(res.s, ref.s) and torch.equal(res.vT, ref.vT)
        log(f"[mesh] sharded pullback: {seconds:.3f} s, peak {peak:.2f} GB, sigma "
            f"{res.s.tolist()} vs {ref.s.tolist()} (max rel {srel:.3g}, tol 1e-3), "
            f"min |cos| {cos:.6f} (tol 0.99), bit for bit {same}")
        checks["(b) sharded pullback equals local_pullback"] = srel <= 1e-3 and cos >= 0.99

        sweep = dp_vmap(lambda x, v: local_pullback(
            enc("flash_jvp"), x, fn_vjp=enc("flash"), v_init=v, **kw), mesh)
        out, seconds, _, launches, path = drive(fa, lambda: sweep(z, v0))
        expected = collections.Counter()
        for _ in range(2):
            pair_k2_k5(expected, torch.bfloat16, 3, layers=2)
        checks["(b) dp_vmap: K2–K5 launches of two pullbacks"] = check_launches(
            "mesh", launches, path, expected)
        paths.append(path)
        same0 = torch.equal(out.s[0], ref.s) and torch.equal(out.vT[0], ref.vT)
        log(f"[mesh] dp_vmap over 2 pullbacks: {seconds:.3f} s, sigma {out.s.tolist()}, "
            f"first equals local_pullback bit for bit: {same0}")
        checks["(b) dp_vmap: the first pullback equals local_pullback"] = bool(
            torch.isfinite(out.s).all() and
            ((out.s[0] - ref.s).abs() / ref.s).max().item() <= 1e-3
            and (out.vT[0] * ref.vT).sum(dim=1).abs().min().item() >= 0.99)
        del unet
        torch.cuda.empty_cache()

        q, k, v = (torch.randn(1, 4096, 5, 64, device="cuda", generator=gen).to(BF16)
                   for _ in range(3))
        out, _, _, launches, path = drive(fa, lambda: ring_attention(q, k, v, mesh=mesh))
        checks["(b) the one-rank ring: one K2"] = check_launches(
            "mesh", launches, path,
            collections.Counter({("flash_fwd_lse", (5, 4096, 64), BF16): 1}))
        paths.append(path)
        dense = fa.flash_forward(fold(q), fold(k), fold(v), 64 ** -0.5)
        err = (fold(out).float() - dense.float()).abs().max().item()
        tol = k1_tol(dense, BF16)
        log(f"[mesh] ring over the one-rank sp group vs dense K1: {err:.3g} (tol {tol:.3g})")
        checks["(b) the one-rank ring equals dense K1"] = err <= tol
    finally:
        dist.destroy_process_group()

    # (c) --mesh_axes sp:4 on one card: the single-chip run keeps the kernels
    from diffusion_pullback_tpu_torch import main as port_main
    from diffusion_pullback_tpu_torch.parallel import get_ring_mesh

    out_dir = os.path.join(OUT, "mesh_sp")
    shutil.rmtree(out_dir, ignore_errors=True)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with torch.device("cuda"), contextlib.redirect_stdout(printed):  # weights on the card
        edit = port_main.main(["--note", "chip_smoke", "--result_folder", out_dir,
                               "--mesh_axes", "sp:4"])
    for line in printed.getvalue().splitlines():
        log(f"[mesh sp:4] {line}")
    unet = edit.unet
    dtype = next(unet.parameters()).dtype
    z = torch.randn(1, 4, 64, 64, device="cuda", generator=gen)
    ctx = torch.randn(1, 77, 1024, device="cuda", generator=gen)
    with torch.no_grad():
        eps, seconds, _, launches, path = drive(fa, lambda: unet(z, 500.0, ctx))
    expected = collections.Counter()
    unet_k1(expected, 1, 1, dtype)
    log(f"[mesh sp:4] built in {time.perf_counter() - t0:.1f} s, attn "
        f"{unet.config.attn_impl}, pullback attn {edit.cfg.pullback_attn_impl}, ring "
        f"mesh {get_ring_mesh()[0]}, one U-Net pass {seconds:.3f} s")
    checks["(c) sp:4 at one rank: auto -> ring, no mesh, the pair for the pullback"] = (
        unet.config.attn_impl == "ring" and edit.cfg.mesh is None
        and get_ring_mesh()[0] is None and edit.cfg.pullback_attn_impl == "flash"
        and "only 1 device visible; running single-chip" in printed.getvalue())
    checks["(c) sp:4 at one rank: a U-Net pass launches K1 at every self-attention"] = (
        check_launches("mesh sp:4", launches, path, expected)
        and bool(torch.isfinite(eps).all()) and eps.shape == z.shape)
    paths.append(path)
    del edit, unet, eps
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    for what, ok in checks.items():
        log(f"[parallel] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("phase 15 checks failed")
    return paths


def phase_f32_edit(fa):
    """Phase 16 (module docstring): the SD 2.1-base edit at --dtype fp32
    through main.build_sd at phase 4's settings, its K1–K5 on 'tf32x3'
    at (B·H, 4096 | 1024, 64), against the same run on the math path."""
    import numpy as np
    from PIL import Image

    from diffusion_pullback_tpu_torch import main as port_main
    from diffusion_pullback_tpu_torch.experiments import BasisCache
    from diffusion_pullback_tpu_torch.geometry import compare_bases, passes_acceptance

    runs, checks, vis_num, vis_num_pc = {}, {}, 2, 1
    for impl in ("flash", "xla"):
        folder = os.path.join(OUT, f"f32_{impl}")
        shutil.rmtree(folder, ignore_errors=True)
        math_path = ["--attn_impl", "xla", "--pullback_attn_impl", "xla"]
        args = port_main.parse_args([
            "--note", "chip_smoke_f32", "--result_folder", folder, "--dtype", "fp32",
            "--for_steps", "10", "--inv_steps", "10", "--edit_t", "0.5",
            "--pca_rank", str(PCA_RANK), "--x_space_guidance_num_step", "2",
            "--edit_prompt", "a photo of a smiling face"] + (math_path if impl == "xla" else []))
        t0 = time.perf_counter()
        with torch.device("cuda"):  # the weights drawn on the card
            edit = port_main.build_sd(args)
        cfg = edit.cfg
        cfg.pullback_min_iter, cfg.pullback_max_iter = 1, 3
        cfg.basis_folder = os.path.join(folder, "inputs")
        edit.cache = BasisCache(cfg.basis_folder)
        dtypes = (next(edit.unet.parameters()).dtype, next(edit.vae.parameters()).dtype)
        log(f"[f32] built the SD 2.1-base driver in {time.perf_counter() - t0:.1f} s "
            f"(U-Net {dtypes[0]}, {sum(p.numel() for p in edit.unet.parameters())} "
            f"parameters, attn {edit.unet.config.attn_impl}, pullback attn "
            f"{cfg.pullback_attn_impl})")
        (names, designs), seconds, peak, launches, path = drive(
            fa, lambda: served_designs(fa, lambda: edit.run_edit_local_encoder_pullback_zt(
                idx=0, pca_rank=PCA_RANK, vis_num=vis_num, vis_num_pc=vis_num_pc)))
        events = read_events(edit)
        log_stages(f"f32 {impl}", events)
        pullback = named(events, "sd_local_pullback")[-1]
        basis = os.listdir(cfg.basis_folder)
        runs[impl] = dict(
            basis=load_basis(os.path.join(cfg.basis_folder, basis[0])),
            pngs={n: np.asarray(Image.open(os.path.join(cfg.result_folder, n + ".png")))
                  for n in names})
        log(f"[f32 {impl}] main path {seconds:.3f} s, peak memory {peak:.2f} GB, pullback "
            f"{pullback['seconds']:.3f} s (encoder {pullback['encoder']}, "
            f"{pullback['iterations']} iterations), sigma {runs[impl]['basis'][1].tolist()}; "
            f"launches by design as the C entries counted them {dict(designs)}")
        if impl == "flash":
            n_dir = 2 * vis_num_pc
            stride = max(1, (cfg.x_space_guidance_num_step + 1) // vis_num)
            frames = len(range(0, cfg.x_space_guidance_num_step + 1, stride))
            expected = collections.Counter()
            edit_k1(expected, edit, n_dir, frames, dtypes)
            pair_k2_k5(expected, dtypes[0], pullback["iterations"], layers=2)
            checks["U-Net in f32, K1 and the pair on the card"] = (
                dtypes == (F32, F32) and edit.unet.config.attn_impl == "flash"
                and cfg.pullback_attn_impl == "flash" and pullback["encoder"] == "flashpair")
            checks["launches by shape"] = check_launches("f32", launches, path, expected)
            served = by_design(fa, [path], head_dim=True)
            for (sym, dsg, d), (_, n, ms) in sorted(served.items()):
                log(f"[f32] {KERNELS[sym][0]} on {dsg} at D={d}: {n} launches, "
                    f"{ms:.2f} ms on the device ({100 * ms / 1e3 / seconds:.2f} % of the path)")
            checks["every f32 K1/K2 launch served by tf32x3, K1 and K2 at D=64 among them"] = (
                designs[("K1", "tf32x3")] == launches["flash_fwd"]
                and designs[("K2", "tf32x3")] == launches["flash_fwd_lse"]
                and served.get(("flash_fwd", "tf32x3", 64), (0, 0))[1] > 0
                and served.get(("flash_fwd_lse", "tf32x3", 64), (0, 0))[1] > 0)
            checks["every f32 K3/K4/K5 launch served by tf32x3, at D=64"] = (
                sum(designs.values()) == sum(launches.values())
                and all(designs[(k, "tf32x3")] == launches[KERNELS_BY_LABEL[k]] > 0
                        for k in ("K3", "K4", "K5"))
                and all(served.get((KERNELS_BY_LABEL[k], "tf32x3", 64), (0, 0))[1] > 0
                        for k in ("K3", "K4", "K5")))
            flash_path = path
        else:
            checks["the math path launches none of K1–K5"] = not any(launches.values())
        del edit
        torch.cuda.empty_cache()

    (_, s0, v0), (_, s1, v1) = runs["flash"]["basis"], runs["xla"]["basis"]
    cmp = compare_bases(v0, s0, v1, s1)
    first, second = runs["flash"]["pngs"], runs["xla"]["pngs"]
    worst = min(psnr(first[n], second[n]) for n in first) if first.keys() == second.keys() \
        else float("nan")
    log(f"[f32] flash against the math path: sigma max rel err "
        f"{cmp.sigma_rel_err.max():.3g} (tol 1e-3), min |cos| per σ-gap group "
        f"{cmp.per_direction_cos.min():.6f} (tol ≥ 0.99) over {len(cmp.gap_groups)} "
        f"groups, {len(first)} PNGs, worst PSNR {worst:.2f} dB (tol ≥ 35)")
    checks["basis: sigma rtol 1e-3, cos >= 0.99 per σ-gap group"] = passes_acceptance(
        cmp, cos_min=0.99, sigma_rtol=1e-3)
    checks["edited images: PSNR >= 35 dB"] = len(first) == 2 * vis_num_pc and worst >= 35.0
    for folder in ("f32_flash", "f32_xla"):
        shutil.rmtree(os.path.join(OUT, folder), ignore_errors=True)
    for what, ok in checks.items():
        log(f"[f32] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("phase 16 checks failed")
    return [flash_path]


def phase_bf16_vae(fa):
    """Phase 17 (module docstring): the SD 2.1-base edit at phase 4's
    settings with its f32 VAE, then with the VAE built in bf16 (K1 at D =
    512 on 'mma_bf16') and with that VAE on the math path, with the U-Net
    in bf16 and in f32, all but the first reading the first run's basis;
    then SDXL's 1024 px VAE in bf16 against the same VAE on the math path.
    Returns the path dicts of the runs."""
    import numpy as np
    from PIL import Image

    from diffusion_pullback_tpu_torch import main as port_main
    from diffusion_pullback_tpu_torch.experiments import BasisCache
    from diffusion_pullback_tpu_torch.models import AutoencoderKL, random_init_, sd_vae
    from diffusion_pullback_tpu_torch.models.layers import attn_impl_as
    from diffusion_pullback_tpu_torch.utils.datasets import get_dataset

    out = os.path.join(OUT, "bf16_vae")
    shutil.rmtree(out, ignore_errors=True)
    args = port_main.parse_args([
        "--note", "chip_smoke_bf16_vae", "--result_folder", out,
        "--for_steps", "10", "--inv_steps", "10", "--edit_t", "0.5",
        "--pca_rank", str(PCA_RANK), "--x_space_guidance_num_step", "2",
        "--edit_prompt", "a photo of a smiling face"])
    t0 = time.perf_counter()
    with torch.device("cuda"):  # the weights drawn on the card
        edit = port_main.build_sd(args)
        vae16 = AutoencoderKL(sd_vae(attn_impl="flash", dtype="bfloat16"))
    vae16.load_state_dict(edit.vae.state_dict())  # the f32 VAE's weights, rounded
    vae16.eval().requires_grad_(False)
    vae32, cfg = edit.vae, edit.cfg
    cfg.pullback_min_iter, cfg.pullback_max_iter = 1, 3
    cfg.basis_folder = os.path.join(out, "inputs")
    edit.cache = BasisCache(cfg.basis_folder)
    log(f"[vae16] built the SD 2.1-base driver and a bf16 copy of its VAE in "
        f"{time.perf_counter() - t0:.1f} s (U-Net {next(edit.unet.parameters()).dtype}, "
        f"VAE attn {vae16.config.attn_impl}, {vae16.config.dtype})")

    vis_num, vis_num_pc = 2, 1
    n_dir = 2 * vis_num_pc
    stride = max(1, (cfg.x_space_guidance_num_step + 1) // vis_num)
    frames = len(range(0, cfg.x_space_guidance_num_step + 1, stride))
    runs, paths, checks = {}, [], {}
    # the U-Net as the CLI builds it on the card (bf16), then cast to f32,
    # each with the three VAEs; every run after the first reads its basis
    for udt in (BF16, F32):
        edit.unet.to(udt)
        for vtag, vae, impl in (("f32 VAE", vae32, "flash"), ("bf16 VAE", vae16, "flash"),
                                ("bf16 VAE math", vae16, "xla")):
            tag = f"{str(udt)[6:]} U-Net, {vtag}"
            first = not runs
            edit.vae = vae
            cfg.result_folder = os.path.join(out, f"{str(udt)[6:]}_{vtag.replace(' ', '_')}")
            os.makedirs(cfg.result_folder, exist_ok=True)
            vae_dtype = next(vae.parameters()).dtype

            def expected_fn(expected, events):
                edit_k1(expected, edit, n_dir, frames, (udt, vae_dtype))
                if impl == "xla":  # the VAE's attention on the math path
                    for key in [key for key in expected if key[1][-1] == 512]:
                        del expected[key]
                if named(events, "sd_local_pullback"):  # the first run's basis
                    pair_k2_k5(expected, udt,
                               named(events, "sd_local_pullback")[-1]["iterations"], layers=2)

            with attn_impl_as(vae, impl):
                (names, designs), events, _, seconds = checked_run(
                    fa, "vae16", tag, edit, lambda: served_designs(
                        fa, lambda: edit.run_edit_local_encoder_pullback_zt(
                            idx=0, pca_rank=PCA_RANK, vis_num=vis_num, vis_num_pc=vis_num_pc)),
                    expected_fn, checks, paths)
            k1_512 = sum(n for (sym, shape, _), (n, _) in paths[-1].items()
                         if sym == "flash_fwd" and shape[-1] == 512)
            ms_512 = sum(ms for (sym, shape, _), (_, ms) in paths[-1].items()
                         if sym == "flash_fwd" and shape[-1] == 512)
            finite = named(events, "sd_decode_and_save")
            runs[(udt, vtag)] = {
                n: np.asarray(Image.open(os.path.join(cfg.result_folder, n + ".png")))
                for n in names}
            log(f"[vae16] ({tag}) {seconds:.3f} s, K1 at D=512: {k1_512} launches, "
                f"{ms_512:.3f} ms on the device; launches by design as the C entries counted "
                f"them {dict(designs)}")
            checks[f"({tag}) two PNGs of 3 frames, finite"] = (
                len(names) == n_dir and bool(finite and finite[-1]["finite"])
                and all(a.shape == (512, 512 * frames, 3) for a in runs[(udt, vtag)].values()))
            checks[f"({tag}) the basis {'computed' if first else 'read from the cache'}"] = (
                bool(named(events, "sd_local_pullback")) == first
                and bool(named(events, "basis_cache_hit")) != first)
            on_mma = designs[("K1", "mma_bf16")]
            if vtag == "bf16 VAE":
                checks[f"({tag}) every K1 launch at D=512 on mma_bf16"] = on_mma == k1_512 > 0
            else:
                checks[f"({tag}) no K1 launch on mma_bf16"] = on_mma == 0
            if impl == "xla":
                checks[f"({tag}) the VAE launches none of K1–K5"] = k1_512 == 0

        def worst(a, b):
            first, second = runs[(udt, a)], runs[(udt, b)]
            return min(psnr(first[n], second[n]) for n in first) \
                if first.keys() == second.keys() else float("nan")
        against_math = worst("bf16 VAE", "bf16 VAE math")
        kernel_f32, math_f32 = worst("bf16 VAE", "f32 VAE"), worst("bf16 VAE math", "f32 VAE")
        log(f"[vae16] {str(udt)[6:]} U-Net, edited images, worst PSNR: the bf16 VAE against "
            f"its math path {against_math:.2f} dB, against the f32 VAE {kernel_f32:.2f} dB; "
            f"the bf16 math path against the f32 VAE {math_f32:.2f} dB")
        if udt == BF16:
            # the bf16 U-Net's own rounding spreads a one-ulp difference in
            # the encoded latent over the inversion and the edit, for the
            # math path as for the kernel: the bf16 VAE is held as every
            # bf16 output here, to the f32 result no farther than 1.5× the
            # bf16 math path (20·log10 1.5 = 3.52 dB)
            checks["(bf16 U-Net) the bf16 VAE's images within 1.5x the math path's distance "
                   "from the f32 VAE's"] = kernel_f32 >= math_f32 - 20 * math.log10(1.5)
        else:
            checks["(f32 U-Net) the bf16 VAE's images against its math path: PSNR >= 35 dB"] = (
                against_math >= 35.0)
    edit.vae = vae32
    del edit, vae16, vae32
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()

    # SDXL's VAE at 1024 px (scaling factor 0.13025) in bf16: K1 at (1,
    # 16384, 512) in the encode and in the decode, against the same bf16
    # VAE on the math path, both held to the f32 VAE on the math path
    with torch.device("cuda"):
        xl = random_init_(AutoencoderKL(sd_vae(attn_impl="flash", scaling_factor=0.13025)), 3)
    xl.eval().requires_grad_(False)
    x = torch.as_tensor(np.asarray(get_dataset("Examples", 1024)[0]), device="cuda")
    x = x.reshape(1, 1024, 1024, 3).permute(0, 3, 1, 2).contiguous()

    def roundtrip(impl):
        with torch.no_grad(), attn_impl_as(xl, impl):
            z = xl.encode(x)
            return z.float(), xl.decode(z).float()

    ref = roundtrip("xla")
    xl.to(torch.bfloat16)
    (got, designs), seconds, peak, launches, path = drive(
        fa, lambda: served_designs(fa, lambda: roundtrip("flash")))
    checks["(sdxl vae) two K1 launches at (1, 16384, 512) in bf16"] = check_launches(
        "vae16 sdxl", launches, path,
        collections.Counter({("flash_fwd", (1, 16384, 512), BF16): 2}))
    checks["(sdxl vae) both on mma_bf16"] = designs == {("K1", "mma_bf16"): 2}
    paths.append(path)
    math16 = roundtrip("xla")
    rel = lambda a, b: (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()
    to8 = lambda img: ((img[0].permute(1, 2, 0).clamp(-1, 1) + 1) * 127.5).round().to(
        torch.uint8).cpu().numpy()
    for i, what in enumerate(("latent", "image")):
        e_flash, e_math = rel(got[i], ref[i]), rel(math16[i], ref[i])
        log(f"[vae16] SDXL VAE bf16 {what}: relative RMS error against the f32 math path, "
            f"flash {e_flash:.4g}, math {e_math:.4g} (tol 1.5 × math = {1.5 * e_math:.4g})")
        checks[f"(sdxl vae) bf16 {what} within 1.5x the bf16 math path"] = bool(
            torch.isfinite(got[i]).all() and got[i].shape == ref[i].shape
            and e_flash <= 1.5 * e_math)
    log(f"[vae16] SDXL VAE bf16 round trip {seconds:.3f} s, peak memory {peak:.2f} GB; "
        f"image PSNR flash against the bf16 math path {psnr(to8(got[1]), to8(math16[1])):.2f} "
        f"dB, against the f32 one {psnr(to8(got[1]), to8(ref[1])):.2f} dB")
    del xl, x, ref, got, math16
    torch.cuda.empty_cache()
    for what, ok in checks.items():
        log(f"[vae16] check {what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("phase 17 checks failed")
    return paths


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    from diffusion_pullback_tpu_torch.models import (
        UNet2DCondition, random_init_, sd21_base_unet)
    from diffusion_pullback_tpu_torch.ops import flash_attention as fa
    from diffusion_pullback_tpu_torch.utils.device import strict_f32

    strict_f32()
    t_start = t0 = time.perf_counter()
    lib, nvcc_out = fa.build()
    log(f"[build] {os.path.relpath(lib, HERE)} in {time.perf_counter() - t0:.1f} s")
    for line in nvcc_out.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        log(f"[smoke] {what}: {now - clock[0]:.1f} s")
        clock[0] = now

    k1_rows = phase_k1(fa)
    pair_rows = phase_pair(fa)
    phase_compose(fa)
    lap("phases 1–2")

    unet = random_init_(UNet2DCondition(sd21_base_unet(attn_impl="flash")), 0)
    unet = unet.cuda().eval().requires_grad_(False)
    eps_math = phase_unet_eps(fa, unet, torch.float32)
    ref = phase_unet_pullback(unet, torch.float32)
    unet.to(torch.bfloat16)
    phase_unet_eps(fa, unet, torch.bfloat16, eps_math)
    phase_unet_pullback(unet, torch.bfloat16, ref)
    del unet
    torch.cuda.empty_cache()
    lap("phase 3")

    paths = [phase_edit(fa)]
    lap("phase 4")
    phase_uncond(fa)
    lap("phase 5")
    paths += phase_sd_rest(fa)
    lap("phase 6")
    paths.append(phase_sdxl(fa))
    lap("phase 7")
    paths += phase_adm(fa)
    lap("phase 8")
    paths += phase_harvest(fa)
    lap("phase 9")
    paths += phase_uncond_runs(fa)
    lap("phase 10")
    paths += phase_extras(fa)
    lap("phase 11")
    paths += phase_head_dim_models(fa)
    lap("phase 12")
    paths += phase_train(fa)
    lap("phase 13")
    paths += phase_tooling(fa)
    lap("phase 14")
    paths += phase_parallel(fa)
    lap("phase 15")
    paths += phase_f32_edit(fa)
    lap("phase 16")
    paths += phase_bf16_vae(fa)
    lap("phase 17")

    # every (kernel, shape, dtype) the main paths launched was held against
    # its plain version in phases 1–2
    held = {("flash_fwd", *key) for key in k1_rows} | {
        (KERNELS_BY_LABEL[label], shape, dtype) for label, shape, dtype in pair_rows}
    missing = {key for path in paths for key in path} - held
    if missing:
        raise AssertionError(f"main paths launched kernels at shapes phases 1–2 "
                             f"did not hold against their plain versions: {missing}")

    # launches and summed device time of each (kernel, shape) over the main
    # paths of phases 4 and 6–17
    merged = collections.defaultdict(lambda: [0, 0.0])
    for path in paths:
        for key, (n, ms) in path.items():
            merged[key][0] += n
            merged[key][1] += ms
    for (sym, shape, dtype), (n, ms) in sorted(merged.items(), key=lambda kv: -kv[1][1]):
        log(f"[paths] {KERNELS[sym][0]} at {shape} {str(dtype)[6:]}: {n} launches, "
            f"{ms:.3f} ms on the device over phases 4 and 6–17")
    log(f"[smoke] phases 1–17 in {time.perf_counter() - t_start:.1f} s")

    # one entry per kernel, design and head dim on the main paths (phases
    # 4, 6–17): their launches and summed device time there (path_ms), and
    # the per-launch numbers of phases 1–2 at the shape that carries most
    # of that device time
    kernels = []
    for (sym, dsg, d), ((_, shape, dtype), n, ms) in sorted(
            by_design(fa, paths, head_dim=True).items(),
            key=lambda kv: (list(KERNELS).index(kv[0][0]), kv[0][1], kv[0][2])):
        label, _, sources, line = KERNELS[sym]
        row = k1_rows[(shape, dtype)] if label == "K1" else pair_rows[(label, shape, dtype)]
        kernels.append(dict(
            name=f"{sym} ({label}, {dsg}, D={d})", route="cuda",
            source=f"diffusion_pullback_tpu_torch/ops/csrc/{kernel_source(sources, dsg, d)}",
            replaces=f"diffusion_pullback_tpu/ops/pallas/flash_attention.py:{line}",
            launches=n, shape=list(shape), dtype=str(dtype)[6:], path_ms=ms, **row))
    log(json.dumps({"kernels": kernels}))
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
