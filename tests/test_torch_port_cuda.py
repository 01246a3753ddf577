"""K1–K5 on the card: each CUDA kernel against its plain version, with the
design the C library's rule reports ('wgmma' for K1–K5 in bf16 at D=64 and
at SD 1.5's and ImageNet128Cond's head dims 40, 80, 128 and 160, 'tf32x3'
for K1–K5 in f32 there and K1 and K2 in f32 at 512, 'mma_bf16' for K1 and
K2 in bf16 at 512), the fused pair under torch.func against
the math path, the kernels' custom ops counting the CPU's FLOPs, and a K1
program exported and reloaded. Marked ``cuda``: these
skip without a GPU and run on one with

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

(``--noconftest``: tests/conftest.py imports jax, which a machine with
the card need not have; this file imports only the port.)
"""

import math

import pytest
import torch

from diffusion_pullback_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# K1 and K2 on 'tf32x3' against their plain versions, as chip_smoke.py
# holds them: three TF32 products per f32 product read ≤ 9.39e-6 at the
# VAE's shapes and under 1.8e-6 at the U-Nets' (head dims 40–160) on an
# H100, one TF32 product stays under 1e-4 at the VAE's
TF32X3_TOL = 2.5e-5


def _one_tf32_forward(q, k, v, scale):
    """K1 in f32 with one TF32 product per f32 product: operands rounded to
    TF32 (to nearest, ties away, 10 mantissa bits, as cvt.rna.tf32.f32),
    the exact products summed in f32."""
    tf32 = lambda x: ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    p = torch.softmax(tf32(q) @ tf32(k).transpose(-1, -2) * scale, dim=-1)
    return tf32(p) @ tf32(v)


def _design(kernel, d, dtype):
    """The design the C rule gives: at D = 40, 64, 80, 128 and 160 'wgmma'
    in bf16 and 'tf32x3' in f32 for K1–K5; at 512 (K1 and K2) 'mma_bf16'
    in bf16 and 'tf32x3' in f32."""
    if d in (40, 64, 80, 128, 160):
        return "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    return "mma_bf16" if dtype == torch.bfloat16 else "tf32x3"


# (B·H, Sq, Sk, D). At D=64 in bf16 the wgmma design serves K1 and K2 with
# 64-row query tiles and 64-key tiles: Sq and Sk off those multiples (1000,
# 700, 200, 130), Sq < 64, Sq ≠ Sk both ways, B·H = 1, and B·H > 1 with a
# ragged last query tile (a 2-D tensor map would read the next head's rows
# there). At D=512 in f32 the tf32x3 design has 32-row query tiles and
# 32-key tiles: Sq < 32, Sq ≠ Sk both ways, a ragged last query tile with
# B·H > 1, and B·H = 1 at the VAE's 4096 tokens; the U-Net's and the
# VAE's calls of the SD driver's run_DDIMforward (5 samples); the SDXL
# U-Net's self-attentions at batch 1 (10 heads at 4096 tokens, 20 at 1024);
# the ADM-256 U-Net's 8 heads at 1024 tokens at batch 1, 2 (guided
# run_ddim_forward), 4 (walk) and 6 (finish); and the SD U-Net's 10 heads
# at 1024 tokens over global PCA's 16 latents; the batched pullback's
# primal over 4 SD latents (20 heads at 4096 tokens, 40 at 1024). At D =
# 40, 80, 128 and 160 (f32 on tf32x3, 64- or 32-row query tiles and 64-key
# tiles, 32 at 160; bf16 on
# wgmma, a row as 1, 2, 2 or 3 panels of 64 columns, the columns past D
# zero-filled): ragged Sq and Sk both ways with B·H > 1 at every D, Sq < 64
# at 40, 128 and 160, Sk off the 64-key tiles at every D, and SD 1.5's and
# ImageNet128Cond's self-attentions (8 heads of 40 at 4096 tokens at batch
# 1 and 2, 8 of 80 and 8 of 160 at 1024, 4 of 128 at 1024)
@pytest.mark.parametrize("shape", [
    (3, 1000, 1000, 64), (2, 700, 700, 512), (10, 1024, 1024, 64),
    (3, 1000, 700, 64), (2, 700, 1000, 64), (1, 50, 700, 64),
    (1, 4096, 4096, 64), (4, 200, 130, 64), (30, 4096, 4096, 64),
    (1, 20, 300, 512), (2, 300, 130, 512), (2, 130, 300, 512),
    (3, 250, 250, 512), (1, 4096, 4096, 512), (25, 4096, 4096, 64),
    (50, 1024, 1024, 64), (5, 4096, 4096, 512), (10, 4096, 4096, 64),
    (20, 1024, 1024, 64), (8, 1024, 1024, 64), (16, 1024, 1024, 64),
    (32, 1024, 1024, 64), (48, 1024, 1024, 64), (160, 1024, 1024, 64),
    (40, 1024, 1024, 64), (20, 4096, 4096, 64),
    (3, 1000, 700, 40), (2, 700, 1000, 80), (3, 700, 1000, 128), (2, 1000, 700, 160),
    (1, 50, 300, 40), (1, 20, 130, 160), (8, 4096, 4096, 40), (16, 4096, 4096, 40),
    (8, 1024, 1024, 80), (16, 1024, 1024, 80), (4, 1024, 1024, 128),
    (8, 1024, 1024, 160), (1, 50, 300, 128), (2, 40, 100, 160), (2, 130, 300, 160),
    (4, 200, 130, 40), (4, 200, 130, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, shape, dtype):
    """K1 and K2 against their plain versions, one launch each, on the
    wgmma design in bf16 at D = 40, 64, 80, 128 and 160, tf32x3 in f32 and
    mma_bf16 in bf16 at D=512, each launch counted on that design where the
    C entry launched it; on tf32x3 the gate rejects one TF32 product."""
    bh, sq, sk, d = shape
    want = _design("K1", d, dtype)
    assert fa.design("K1", d, dtype) == fa.design("K2", d, dtype) == want
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(n, s, d, device=cuda, generator=gen).to(dtype)
               for n, s in ((bh, sq), (bh, sk), (bh, sk)))
    n0 = fa.flash_forward.launches, fa.served("K1", want)
    out = fa.flash_forward(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.served("K1", want)) == (n0[0] + 1, n0[1] + 1)
    ref = fa.flash_forward_plain(q, k, v, d ** -0.5)
    assert out.dtype == dtype
    # f32 (tf32x3): TF32X3_TOL, which one TF32 product per f32 product must
    # miss; bf16: both round the same f32 value, so at most an ulp apart —
    # two ulps of max |ref|
    top = ref.float().abs().max().item()
    tol = TF32X3_TOL if dtype == torch.float32 else (
        2 * torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(top)))
    assert (out.float() - ref.float()).abs().max().item() <= tol
    if want == "tf32x3":
        assert (_one_tf32_forward(q, k, v, d ** -0.5) - ref).abs().max().item() > tol
    n0 = fa.flash_forward_lse.launches
    out, lse = fa.flash_forward_lse(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_forward_lse.launches == n0 + 1
    ref_o, ref_lse = fa.flash_forward_lse_plain(q, k, v, d ** -0.5)
    assert (out.float() - ref_o.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= (TF32X3_TOL if want == "tf32x3" else 1e-4)


def test_tf32x3_at_the_sdxl_vae_tokens(cuda):
    """K1 on 'tf32x3' at the SDXL VAE's mid-block attention, (1, 16384,
    512) f32 at 1024 px: 512 query tiles and a key loop four times the 4096
    tokens of SD's VAE, so the error sums over four times the keys. Held to
    its plain version (blockwise over the keys) at TF32X3_TOL, and one TF32
    product per f32 product must miss that gate there."""
    assert fa.design("K1", 512, torch.float32) == "tf32x3"
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(1, 16384, 512, device=cuda, generator=gen) for _ in range(3))
    n0 = fa.flash_forward.launches
    out = fa.flash_forward(q, k, v, 512 ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_forward.launches == n0 + 1
    ref = fa.flash_forward_plain(q, k, v, 512 ** -0.5)
    assert (out - ref).abs().max().item() <= TF32X3_TOL
    assert (_one_tf32_forward(q, k, v, 512 ** -0.5) - ref).abs().max().item() > TF32X3_TOL


# (B·H, Sq, Sk) of f32 K1 and K2 at each head dim the rows kernel serves,
# on each of its block shapes: a grid of 64-row tiles under one block an SM
# (32-row blocks, each key tile split over two warps and merged), over it
# (64-row blocks: at D ≤ 64 two pairs of warps of two m16 tiles, each pair
# on half of each key tile and merged, (10, 1000, 700)), and at D ≤ 80 at
# least 3 blocks of 128 rows for every 2 SMs (two m16 tiles a warp;
# (40, 1000, 700) and (300, 130, 300), the latter with 2 rows in its last
# block); ragged Sq and Sk both ways, a key tile of 32 at D = 160, and Sk
# < one key tile
@pytest.mark.parametrize("d", [40, 64, 80, 128, 160])
@pytest.mark.parametrize("shape", [(1, 1000, 700), (2, 700, 1000), (10, 1000, 700),
                                   (40, 1000, 700), (300, 130, 300), (3, 70, 20)])
def test_tf32x3_rows_at_each_block_shape(cuda, shape, d):
    """K1 and K2 in f32 on 'tf32x3' (csrc/flash_fwd_tf32_rows.cu) against
    their plain versions at TF32X3_TOL (O and L),
    each launch counted on 'tf32x3' where the C entry launched it, and one
    TF32 product per f32 product outside the gate."""
    bh, sq, sk = shape
    assert fa.design("K1", d, torch.float32) == fa.design("K2", d, torch.float32) == "tf32x3"
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(bh, n, d, device=cuda, generator=gen) for n in (sq, sk, sk))
    scale = d ** -0.5
    n0 = fa.served("K1", "tf32x3"), fa.served("K2", "tf32x3")
    out = fa.flash_forward(q, k, v, scale)
    o2, lse = fa.flash_forward_lse(q, k, v, scale)
    torch.cuda.synchronize()
    assert (fa.served("K1", "tf32x3"), fa.served("K2", "tf32x3")) == (n0[0] + 1, n0[1] + 1)
    ref_o, ref_lse = fa.flash_forward_lse_plain(q, k, v, scale)
    assert (out - ref_o).abs().max().item() <= TF32X3_TOL
    assert (o2 - ref_o).abs().max().item() <= TF32X3_TOL
    assert (lse - ref_lse).abs().max().item() <= TF32X3_TOL
    assert (_one_tf32_forward(q, k, v, scale) - ref_o).abs().max().item() > TF32X3_TOL


def _one_tf32_backward(q, k, v, do, lse, delta, scale, block=512):
    """K4 and K5 in f32 with one TF32 product per f32 product, (dQ, dK, dV):
    the operands of Q·Kᵀ, dO·Vᵀ, dS·K, Pᵀ·dO and dSᵀ·Q rounded to TF32, the
    exact products summed in f32, over key blocks; the cotangent may carry
    r times the primal's B·H."""
    tf32 = lambda x: ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    r = do.shape[0] // q.shape[0]
    q, k, v, lse = (x.repeat(r, *(1,) * (x.ndim - 1)) for x in (q, k, v, lse))
    dq = torch.zeros_like(do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for i in range(0, k.shape[1], block):
        kb, vb = k[:, i:i + block], v[:, i:i + block]
        p = torch.exp(tf32(q) @ tf32(kb).transpose(1, 2) * scale - lse[..., None])
        ds = p * (tf32(do) @ tf32(vb).transpose(1, 2) - delta[..., None])
        dq += tf32(ds) @ tf32(kb)
        dv[:, i:i + block] = tf32(p).transpose(1, 2) @ tf32(do)
        dk[:, i:i + block] = tf32(ds).transpose(1, 2) @ tf32(q) * scale
    return dq * scale, dk, dv


# (B·H primal, Sq, Sk, probes) of f32 K4 and K5 at each head dim, on each
# block shape of their rules: K4 on 64-row blocks, and at D ≤ 80 on
# 128-row blocks (two m16 tiles a warp) at 3 such blocks an SM ((50, 1000,
# 700, 1), and (100, 130, 300, 3) with 2 rows in the last block); K5 on
# 32-row blocks (each query tile split over two warps) under one 64-row
# block an SM, else on 64-row blocks ((10, 1000, 700, 2) and the two
# above); ragged Sq and Sk both ways, Sk and Sq under one tile, probes
# folded (cotangent slice b reads primal slice b % B·H)
@pytest.mark.parametrize("d", [40, 64, 80, 128, 160])
@pytest.mark.parametrize("shape", [(1, 1000, 700, 2), (2, 700, 1000, 3), (10, 1000, 700, 2),
                                   (50, 1000, 700, 1), (100, 130, 300, 3), (3, 70, 20, 1)])
def test_tf32x3_backward_at_each_block_shape(cuda, shape, d):
    """K4 and K5 in f32 on 'tf32x3' (csrc/flash_bwd_tf32_rows.cu) against
    their plain versions at TF32X3_TOL of max(1, max |plain|) (dQ, dK, dV),
    each launch counted on 'tf32x3' where the C entry launched it, and one
    TF32 product per f32 product outside the gate."""
    bhp, sq, sk, r = shape
    assert fa.design("K4", d, torch.float32) == fa.design("K5", d, torch.float32) == "tf32x3"
    gen = torch.Generator(device=cuda).manual_seed(5)
    rnd = lambda n, s: torch.randn(n, s, d, device=cuda, generator=gen)
    q, k, v, do = rnd(bhp, sq), rnd(bhp, sk), rnd(bhp, sk), rnd(r * bhp, sq)
    scale = d ** -0.5
    o, lse = fa.flash_forward_lse_plain(q, k, v, scale)
    delta = (do * o.repeat(r, 1, 1)).sum(-1)
    n0 = fa.served("K4", "tf32x3"), fa.served("K5", "tf32x3")
    got = (fa.flash_dq(q, k, v, do, lse, delta, scale), *fa.flash_dkv(q, k, v, do, lse, delta,
                                                                       scale))
    torch.cuda.synchronize()
    assert (fa.served("K4", "tf32x3"), fa.served("K5", "tf32x3")) == (n0[0] + 1, n0[1] + 1)
    ref = (fa.flash_dq_plain(q, k, v, do, lse, delta, scale),
           *fa.flash_dkv_plain(q, k, v, do, lse, delta, scale))
    one = _one_tf32_backward(q, k, v, do, lse, delta, scale)
    for name, out, want, bad in zip(("dq", "dk", "dv"), got, ref, one):
        tol = _tol(want, torch.float32)
        err = (out - want).abs().max().item()
        assert out.shape == want.shape and err <= tol, (name, err, tol)
        assert (bad - want).abs().max().item() > tol, name


def _one_tf32_tangent(q, k, v, dq, dk, dv, o, lse, scale, block=512):
    """K3 in f32 with one TF32 product per f32 product, Ȯ: the operands of
    Q·Kᵀ, Q̇·Kᵀ, Q·K̇ᵀ, (P∘Ṡ)·V and P·V̇ rounded to TF32, the exact
    products summed in f32, over key blocks; the tangents may carry r times
    the primal's B·H."""
    tf32 = lambda x: ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
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


# (B·H primal, Sq, Sk, probes) of f32 K3 at each head dim, on each block
# shape of its rule: 64-row blocks, and at D ≤ 80 128-row blocks (two m16
# tiles a warp) at 3 such blocks an SM ((50, 1000, 700, 1), and (100, 130,
# 300, 3) with 2 rows in the last block); ragged Sq and Sk both ways, Sk
# under one key tile (16 at D = 160, else 32), probes folded (tangent slice
# b reads primal slice b % B·H)
@pytest.mark.parametrize("d", [40, 64, 80, 128, 160])
@pytest.mark.parametrize("shape", [(1, 1000, 700, 2), (2, 700, 1000, 3), (10, 1000, 700, 2),
                                   (50, 1000, 700, 1), (100, 130, 300, 3), (3, 70, 12, 1)])
def test_tf32x3_tangent_at_each_block_shape(cuda, shape, d):
    """K3 in f32 on 'tf32x3' (csrc/flash_jvp_tf32_rows.cu) against its plain
    version at TF32X3_TOL of max(1, max |plain|), each launch counted on
    'tf32x3' where the C entry launched it, and one TF32 product per f32
    product outside the gate."""
    bhp, sq, sk, r = shape
    assert fa.design("K3", d, torch.float32) == "tf32x3"
    gen = torch.Generator(device=cuda).manual_seed(7)
    rnd = lambda n, s: torch.randn(n, s, d, device=cuda, generator=gen)
    q, k, v = rnd(bhp, sq), rnd(bhp, sk), rnd(bhp, sk)
    dq, dk, dv = rnd(r * bhp, sq), rnd(r * bhp, sk), rnd(r * bhp, sk)
    scale = d ** -0.5
    o, lse = fa.flash_forward_lse_plain(q, k, v, scale)
    n0 = fa.served("K3", "tf32x3")
    out = fa.flash_tangent(q, k, v, dq, dk, dv, o, lse, scale)
    torch.cuda.synchronize()
    assert fa.served("K3", "tf32x3") == n0 + 1
    ref = fa.flash_tangent_plain(q, k, v, dq, dk, dv, o, lse, scale)
    tol = _tol(ref, torch.float32)
    assert out.shape == ref.shape and (out - ref).abs().max().item() <= tol
    one = _one_tf32_tangent(q, k, v, dq, dk, dv, o, lse, scale)
    assert (one - ref).abs().max().item() > tol


# (B·H, S, D): the VAE's single 512-wide head built in bf16: SD's encode
# (1 image) and decode of 3 frames at 4096 tokens, SDXL's at 16 384
@pytest.mark.parametrize("shape", [(1, 4096, 512), (3, 4096, 512), (1, 16384, 512)])
def test_mma_bf16_at_the_vae_shapes(cuda, shape):
    """K1 in bf16 at D = 512 on 'mma_bf16' (csrc/flash_fwd_mma_bf16.cu)
    against its plain version within two bf16 ulps of max |plain|, the
    launch counted on 'mma_bf16' where the C entry launched it."""
    assert fa.design("K1", 512, torch.bfloat16) == "mma_bf16"
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    n0 = fa.served("K1", "mma_bf16")
    out = fa.flash_forward(q, k, v, 512 ** -0.5)
    torch.cuda.synchronize()
    assert fa.served("K1", "mma_bf16") == n0 + 1
    ref = fa.flash_forward_plain(q, k, v, 512 ** -0.5)
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= _tol(ref, torch.bfloat16)


# (B·H, S, D): ring attention's shards of the bf16 VAE's 512-wide head: SD
# 2.1-base's 4096 tokens over sp = 2 and 4, for one image and for a decode
# of 3 frames, and SDXL's 16 384 over sp = 2 and 4; one head over 4096
# tokens unsharded
@pytest.mark.parametrize("shape", [(1, 2048, 512), (1, 1024, 512), (3, 2048, 512),
                                   (3, 1024, 512), (1, 8192, 512), (1, 4096, 512)])
def test_k2_mma_bf16_at_the_ring_shards(cuda, shape):
    """K2 in bf16 at D = 512 on 'mma_bf16' (K1's kernel with the L store)
    against its plain version: O within two bf16 ulps of max |plain|, L
    within TF32X3_TOL (K2's L gate at every head dim, chip_smoke.py's
    pair_tol), the launch counted on 'mma_bf16' where the C entry launched
    it."""
    assert fa.design("K2", 512, torch.bfloat16) == "mma_bf16"
    gen = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    n0 = fa.served("K2", "mma_bf16")
    out, lse = fa.flash_forward_lse(q, k, v, 512 ** -0.5)
    torch.cuda.synchronize()
    assert fa.served("K2", "mma_bf16") == n0 + 1
    ref_o, ref_lse = fa.flash_forward_lse_plain(q, k, v, 512 ** -0.5)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert lse.shape == ref_lse.shape == shape[:2]
    assert (out.float() - ref_o.float()).abs().max().item() <= _tol(ref_o, torch.bfloat16)
    assert (lse - ref_lse).abs().max().item() <= TF32X3_TOL


def _tol(ref, dtype):
    """f32 ('tf32x3', K3, K4 and K5): TF32X3_TOL of max(1, max |ref|), which
    one TF32 product per f32 product must miss; bf16: two ulps of max |ref|
    (both round the same f32 values)."""
    top = ref.float().abs().max().item()
    if dtype == torch.float32:
        return TF32X3_TOL * max(1.0, top)
    return 2 * torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(top))


# (B·H, Sq, Sk, probes) at D=64. The bf16 K3–K5 run the wgmma design with
# 64-row tiles: ragged Sq and Sk, Sq ≠ Sk both ways, Sq < 64 with B·H = 1,
# and B·H > 1 with a ragged last tile in each head (a map over the wrong
# heads would read the next head's rows there); two probes as the main
# path, and three (tangent slice b reads primal slice b % B·H); the CFG
# pullback's 2·B primal with two probes, the covector VJPs' one cotangent
# (r = 1) at the U-Net's shapes, the ADM-256 encoder's 8 heads at 1024
# tokens with two probes and with the mean-basis harvest's ten, and the SD
# harvest's rank-50 pullback at 1024 tokens (B·H 500), and the batched
# pullback over 4 SD latents (primal B·H 20 at 4096 tokens, 40 at 1024)
@pytest.mark.parametrize("shape", [
    (3, 1000, 1000, 2), (3, 1000, 700, 2), (3, 700, 1000, 2), (1, 50, 700, 2),
    (4, 200, 130, 2), (3, 1000, 700, 3), (10, 4096, 4096, 2), (20, 1024, 1024, 2),
    (5, 4096, 4096, 1), (10, 1024, 1024, 1), (8, 1024, 1024, 2), (8, 1024, 1024, 10),
    (10, 1024, 1024, 50), (8, 1024, 1024, 50), (20, 4096, 4096, 2),
    (40, 1024, 1024, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_kernels_match_plain_versions(cuda, shape, dtype):
    """K2–K5 against their plain versions, one launch each, with the
    tangents and the cotangent batched over r probes against one primal
    (the pullback's batching), on the design the rule reports, in the
    input dtype."""
    _check_pair(cuda, *shape, 64, dtype)


# (B·H, Sq, Sk, probes, D) at D = 40, 80, 128, 160, where K2–K5 run wgmma
# in bf16 (a row as 1, 2, 2 or 3 panels of 64 columns; K3 with one stage of
# its ring at 160) and tf32x3 in f32: ragged Sq and Sk both ways, Sk off the
# 64-row tiles at every D, Sq < 64 at every D, a last query tile of 36 rows
# at 160, B·H > 1 with a ragged last tile in each head at every D, three
# probes; SD 1.5's mid-tap pullback at rank 2 (8 heads of 40 at 4096
# tokens, 8 of 80 at 1024), ImageNet128Cond's (4 heads of 128 at 1024) and
# 8 heads of 160 at 1024 tokens
@pytest.mark.parametrize("shape", [
    (3, 1000, 700, 2, 40), (3, 700, 1000, 3, 80), (1, 50, 300, 2, 128),
    (2, 300, 130, 2, 160), (8, 4096, 4096, 2, 40), (8, 1024, 1024, 2, 80),
    (4, 1024, 1024, 2, 128), (8, 1024, 1024, 2, 160),
    (2, 700, 1000, 3, 40), (3, 1000, 700, 2, 80), (2, 1000, 700, 2, 128),
    (2, 700, 1000, 3, 160), (1, 20, 130, 2, 160), (2, 100, 300, 2, 160),
    (3, 200, 130, 2, 40), (3, 130, 200, 2, 128), (2, 40, 300, 3, 40),
    (1, 30, 200, 2, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_kernels_at_head_dims_40_to_160(cuda, shape, dtype):
    """K2–K5 against their plain versions at the head dims other than 64
    (every kernel on 'wgmma' in bf16 and on 'tf32x3' in f32), as
    test_pair_kernels_match_plain_versions."""
    _check_pair(cuda, *shape, dtype)


def _check_pair(cuda, bh, sq, sk, r, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    rnd = lambda *shape: torch.randn(shape, device=cuda, generator=gen).to(dtype)
    scale = d ** -0.5
    assert [fa.design(f"K{i}", d, dtype) for i in range(2, 6)] == [
        _design(f"K{i}", d, dtype) for i in range(2, 6)]
    q, k, v = rnd(bh, sq, d), rnd(bh, sk, d), rnd(bh, sk, d)
    dq, do = rnd(r * bh, sq, d), rnd(r * bh, sq, d)
    dk, dv = rnd(r * bh, sk, d), rnd(r * bh, sk, d)
    n0 = {f: getattr(fa, f).launches
          for f in ("flash_forward_lse", "flash_tangent", "flash_dq", "flash_dkv")}
    o, lse = fa.flash_forward_lse(q, k, v, scale)
    delta = (do.float() * o.float().repeat(r, 1, 1)).sum(-1)
    got = {"o": o, "lse": lse,
           "tangent": fa.flash_tangent(q, k, v, dq, dk, dv, o, lse, scale),
           "dq": fa.flash_dq(q, k, v, do, lse, delta, scale)}
    got["dk"], got["dv"] = fa.flash_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert {f: getattr(fa, f).launches - n for f, n in n0.items()} == dict.fromkeys(n0, 1)
    cpu = lambda *ts: [t.cpu() for t in ts]
    ref = dict(zip(("o", "lse"), fa.flash_forward_lse_plain(*cpu(q, k, v), scale)))
    ref["tangent"] = fa.flash_tangent_plain(*cpu(q, k, v, dq, dk, dv, o, lse), scale)
    ref["dq"] = fa.flash_dq_plain(*cpu(q, k, v, do, lse, delta), scale)
    ref["dk"], ref["dv"] = fa.flash_dkv_plain(*cpu(q, k, v, do, lse, delta), scale)
    for name, out in got.items():
        if dtype == torch.float32 and name in ("o", "lse"):  # K2's gate on tf32x3, as chip_smoke.py's
            tol = TF32X3_TOL
        else:
            tol = 1e-4 if name == "lse" else _tol(ref[name], dtype)
        err = (out.cpu().float() - ref[name].float()).abs().max().item()
        want = torch.float32 if name == "lse" else dtype
        assert out.dtype == ref[name].dtype == want and err <= tol, (name, err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_under_torch_func_matches_math_path(cuda, dtype):
    """The pair under torch.func (probes vmapped) against the math path; the
    head-dim guard."""
    from torch.func import jvp, vjp, vmap

    from diffusion_pullback_tpu_torch.ops.attention import attention

    gen = torch.Generator(device=cuda).manual_seed(1)
    rnd = lambda *shape: torch.randn(shape, device=cuda, generator=gen).to(dtype)
    r = 2
    x = rnd(1, 1024, 4, 64)
    f = lambda impl: (lambda y: attention(y, y * 0.5, torch.tanh(y), impl=impl))
    ts = rnd(r, *x.shape)
    tan = {impl: vmap(lambda t: jvp(f(impl), (x,), (t,))[1])(ts)
           for impl in ("flash_jvp", "xla")}
    cot = {impl: vmap(vjp(f(impl), x)[1])(ts)[0] for impl in ("flash", "xla")}
    for mine, math_path in ((tan["flash_jvp"], tan["xla"]), (cot["flash"], cot["xla"])):
        assert (mine.float() - math_path.float()).abs().max().item() <= 4 * _tol(
            math_path, dtype)

    with pytest.raises(ValueError, match="head dims"):
        y = torch.randn(1, 1024, 32, device=cuda)
        fa.flash_forward_lse(y, y, y, 0.125)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_under_torch_func_at_head_dim_40(cuda, dtype):
    """The pair under torch.func (two probes vmapped) at SD 1.5's 8 heads of
    40 over 1024 tokens (K2–K5 on 'wgmma' in bf16 and on 'tf32x3' in f32)
    against the math path; each of K2–K5 launches,
    and head dim 32 still raises."""
    from torch.func import jvp, vjp, vmap

    from diffusion_pullback_tpu_torch.ops.attention import attention

    gen = torch.Generator(device=cuda).manual_seed(7)
    rnd = lambda *shape: torch.randn(shape, device=cuda, generator=gen).to(dtype)
    x, ts = rnd(1, 1024, 8, 40), rnd(2, 1, 1024, 8, 40)
    f = lambda impl: (lambda y: attention(y, y * 0.5, torch.tanh(y), impl=impl))
    n0 = {w: getattr(fa, w).launches
          for w in ("flash_forward_lse", "flash_tangent", "flash_dq", "flash_dkv")}
    tan = {impl: vmap(lambda t: jvp(f(impl), (x,), (t,))[1])(ts)
           for impl in ("flash_jvp", "xla")}
    cot = {impl: vmap(vjp(f(impl), x)[1])(ts)[0] for impl in ("flash", "xla")}
    torch.cuda.synchronize()
    assert all(getattr(fa, w).launches > n for w, n in n0.items())
    for mine, math_path in ((tan["flash_jvp"], tan["xla"]), (cot["flash"], cot["xla"])):
        assert (mine.float() - math_path.float()).abs().max().item() <= 4 * _tol(
            math_path, dtype)
    with pytest.raises(ValueError, match="head dims"):
        y = torch.randn(8, 1024, 32, device=cuda, dtype=dtype)
        fa.flash_forward(y, y, y, 32 ** -0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cfg_pair_under_torch_func_matches_math_path(cuda, dtype):
    """The pair under a CFG-style extrapolation built inside the
    differentiated function ((1+s)·a[:1] − s·a[1:] of a 2-row primal made
    by torch.cat), probes vmapped outside it: each probe must meet its own
    rows of the 2-row primal, as the math path has them."""
    from torch.func import jvp, vjp, vmap

    from diffusion_pullback_tpu_torch.ops.attention import attention

    gen = torch.Generator(device=cuda).manual_seed(2)
    rnd = lambda *shape: torch.randn(shape, device=cuda, generator=gen).to(dtype)
    s, r = 2.5, 2
    x = rnd(1, 1024, 4, 64)

    def f(impl):
        def g(y):
            y2 = torch.cat([y, 0.5 * y])
            a = attention(y2, torch.tanh(y2), y2 * y2, impl=impl)
            return (1 + s) * a[:1] - s * a[1:]
        return g

    ts = rnd(r, *x.shape)
    tan = {impl: vmap(lambda t: jvp(f(impl), (x,), (t,))[1])(ts)
           for impl in ("flash_jvp", "xla")}
    cot = {impl: vmap(vjp(f(impl), x)[1])(ts)[0] for impl in ("flash", "xla")}
    for mine, math_path in ((tan["flash_jvp"], tan["xla"]), (cot["flash"], cot["xla"])):
        assert (mine.float() - math_path.float()).abs().max().item() <= 4 * (
            1 + 2 * s) * _tol(math_path, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_block_on_the_pair_matches_the_plain_block(cuda, dtype):
    """An SDXL-width transformer block (10 heads of 64 at 1024 tokens, a
    77-token context) through remat_block on the fused pair: the vjp over
    two vmapped probes and the jvp equal the block's own on the card, and
    the recomputed backward launches K2, K4 and K5 once for both probes,
    at the folded B·H."""
    from torch.func import jvp, vjp, vmap

    from diffusion_pullback_tpu_torch.models.layers import attn_impl_as
    from diffusion_pullback_tpu_torch.models.transformer2d import (
        BasicTransformerBlock, remat_block)

    torch.manual_seed(5)
    block = BasicTransformerBlock(640, 10, 64, 2048).to(cuda, dtype).requires_grad_(False)
    gen = torch.Generator(device=cuda).manual_seed(6)
    rnd = lambda *shape: torch.randn(shape, device=cuda, generator=gen).to(dtype)
    x, ctx, us = rnd(1, 1024, 640), rnd(1, 77, 2048), rnd(2, 1, 1024, 640)

    def run(f, impl):
        with attn_impl_as(block, impl):
            return vmap(vjp(lambda a: f(block, a, ctx), x)[1])(us)[0]

    plain = run(lambda b, a, c: b(a, c), "flash")
    n0 = {f: getattr(fa, f).launches for f in ("flash_forward", "flash_forward_lse",
                                               "flash_dq", "flash_dkv")}
    remat = run(remat_block, "flash")
    torch.cuda.synchronize()
    got = {f: getattr(fa, f).launches - n for f, n in n0.items()}
    assert got == dict.fromkeys(n0, 1), got
    assert (remat.float() - plain.float()).abs().max().item() <= 4 * _tol(plain, dtype)
    xr = x.clone().requires_grad_()
    with attn_impl_as(block, "flash_jvp"):
        _, t_remat = jvp(lambda a: remat_block(block, a, ctx), (xr,), (us[0],))
        _, t_plain = jvp(lambda a: block(a, ctx), (x,), (us[0],))
    assert (t_remat.detach().float() - t_plain.float()).abs().max().item() <= 4 * _tol(
        t_plain, dtype)


def test_train_step_on_the_pair_matches_plain_versions(cuda, monkeypatch):
    """One train step (the hybrid objective) of a small ADM net in bf16 with
    attn 'flash' at 1024 tokens (one head of 64, two levels, attention at
    32² and in the mid block): K2 in the forward and K4 + K5 in the plain
    backward, one launch per attention layer each, and the loss and every
    master gradient against the same step on the kernels' plain versions,
    within the pair gates (4 × two bf16 ulps of max |ref|)."""
    import functools

    from diffusion_pullback_tpu_torch.models import ADMConfig, UNetADM, random_init_
    from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
    from diffusion_pullback_tpu_torch.training import create_train_state, make_train_step
    from diffusion_pullback_tpu_torch.training.train import draws_of

    cfg = ADMConfig(image_size=64, model_channels=32, channel_mult=(1, 2),
                    num_res_blocks=1, attention_resolutions=(2,), num_head_channels=64,
                    norm_num_groups=8, attn_impl="flash", dtype="bfloat16")
    with torch.device(cuda):
        model = random_init_(UNetADM(cfg), 0)
    layers = sum(hasattr(m, "attn_impl") for m in model.modules())
    gen = torch.Generator(device=cuda).manual_seed(8)
    x0 = 0.5 * torch.randn(2, 3, 64, 64, device=cuda, generator=gen)
    draw = draws_of(torch.randint(0, 1000, (2,), device=cuda, generator=gen),
                    torch.ones(2, device=cuda),
                    torch.randn(x0.shape, device=cuda, generator=gen))
    still = functools.partial(torch.optim.SGD, lr=0.0)

    def step():
        state = create_train_state(model.state_dict(), still)
        state, metrics = make_train_step(model, DiffusionSchedule.linear(), still,
                                         learn_sigma_vb_weight=0.001)(state, x0, draw=draw)
        return metrics["loss"], {k: p.grad for k, p in state.params.items()}

    wrappers = ("flash_forward", "flash_forward_lse", "flash_dq", "flash_dkv")
    n0 = {w: getattr(fa, w).launches for w in wrappers}
    loss, grads = step()
    torch.cuda.synchronize()
    assert {w: getattr(fa, w).launches - n for w, n in n0.items()} == {
        "flash_forward": 0, "flash_forward_lse": layers, "flash_dq": layers,
        "flash_dkv": layers}
    for w in ("flash_forward_lse", "flash_dq", "flash_dkv"):
        monkeypatch.setattr(fa, w, getattr(fa, w + "_plain"))
    ref_loss, ref = step()
    assert abs(loss.item() - ref_loss.item()) <= 4 * _tol(ref_loss, torch.bfloat16)
    for k, g in grads.items():
        err = (g - ref[k]).abs().max().item()
        assert g.dtype == torch.float32 and err <= 4 * _tol(ref[k], torch.bfloat16), (k, err)


def _op_counts(fn, *args):
    """{op name: FLOPs} that FlopCounterMode counts over fn(*args)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {str(op).split(".")[-1]: n for op, n in counter.get_flop_counts()["Global"].items()}


@pytest.mark.parametrize("shape", [(2, 1024, 64), (10, 4096, 40)])
def test_custom_op_counts_on_the_card_equal_the_cpu(cuda, shape):
    """Each kernel's custom op counts the same FLOPs whether the card's
    kernel or the CPU's plain version runs it (K3–K5 with 3 probes' slices),
    and the card's count launches the kernel once."""
    bh, s, d = shape
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(bh, s, d, generator=gen) for _ in range(3))
    t = torch.randn(3 * bh, s, d, generator=gen)
    o, lse = fa.flash_forward_lse_plain(q, k, v, d ** -0.5)
    delta = torch.randn(3 * bh, s, generator=gen)
    calls = {"flash_forward": lambda *a: fa.flash_forward(*a[:3], d ** -0.5),
             "flash_forward_lse": lambda *a: fa.flash_forward_lse(*a[:3], d ** -0.5),
             "flash_tangent": lambda q, k, v, t, o, lse, delta: fa.flash_tangent(
                 q, k, v, t, t, t, o, lse, d ** -0.5),
             "flash_dq": lambda q, k, v, t, o, lse, delta: fa.flash_dq(
                 q, k, v, t, lse, delta, d ** -0.5),
             "flash_dkv": lambda q, k, v, t, o, lse, delta: fa.flash_dkv(
                 q, k, v, t, lse, delta, d ** -0.5)}
    for name, call in calls.items():
        # the operands in bf16, L and δ (two dims) in f32
        args = [a.to(torch.bfloat16) if a.dim() == 3 else a
                for a in (q, k, v, t, o, lse, delta)]
        cpu = _op_counts(call, *args)
        before = getattr(fa, name).launches
        card = _op_counts(call, *(a.to(cuda) for a in args))
        torch.cuda.synchronize()
        assert card == cpu and len(card) == 1, name
        assert getattr(fa, name).launches == before + 1, name


def test_k1_program_exports_and_reloads_on_the_card(cuda, tmp_path, monkeypatch):
    """An SD-shaped self-attention through K1 (the custom op) as a stored
    program: exported on the card, reloaded by a fresh cache with export
    refused, launching K1 with the eager output bit for bit."""
    from diffusion_pullback_tpu_torch.utils.aot import AOTProgramCache

    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn(1, 4096, 5, 64, device=cuda, generator=gen,
                           dtype=torch.bfloat16) for _ in range(3))
    attend = lambda q, k, v: fa.flash_attention(q, k, v) * 2.0
    with torch.no_grad():
        eager = attend(q, k, v)
        out = AOTProgramCache(str(tmp_path)).wrap("attend", attend)(q, k, v)
        (path,) = tmp_path.iterdir()
        assert "dpx.flash_fwd" in str(torch.export.load(str(path)).graph)

        def refuse(*a, **kw):
            raise AssertionError("exported again instead of loading")
        monkeypatch.setattr(torch.export, "export", refuse)
        before = fa.flash_forward.launches
        again = AOTProgramCache(str(tmp_path)).wrap("attend", attend)(q, k, v)
        torch.cuda.synchronize()
    assert fa.flash_forward.launches == before + 1
    assert torch.equal(out, eager) and torch.equal(again, eager)
