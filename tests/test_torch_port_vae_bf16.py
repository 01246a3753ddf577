"""K1 and K2 in bf16 at head dim 512 (ops/csrc/flash_fwd_mma_bf16.cu,
design 'mma_bf16') and the VAE built in bf16 that runs K1, on the CPU with
the JAX package as the oracle.

The kernels' plain versions (``flash_forward_plain``,
``flash_forward_lse_plain``) at the kernel's key tile of 32 are held
against the Pallas `_flash_forward` and `_flash_forward_lse` in bf16 in
interpret mode (the same 32-key tile; 128-row query blocks), O to two bf16
ulps of max |reference|, as the card holds the kernel against the plain
version, and K2's L in f32 to 1e-5. Then the port's AutoencoderKL at a width whose mid-block is one
512-wide head over 1024 tokens (block_out_channels (512,), one resnet a
level, 32 px: no down- or upsampler, so the encoder's and the decoder's
mid-block attentions both see 32² tokens and take 'flash') against the
JAX VAE on the same weights, in f32 and in bf16. Inputs are made with
numpy from a seed."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import flax_params, nchw, nhwc, one_torch_thread  # noqa: F401

import diffusion_pullback_tpu.ops.pallas.flash_attention as jfa
from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.ops import flash_attention as tfa

KEY_TILE = 32  # keys a tile of the mma_bf16 kernel (BK in flash_fwd_mma_bf16.cu)


def _two_ulps(ref: np.ndarray) -> float:
    top = float(np.abs(ref).max())
    return 2 * 2.0 ** -7 * 2.0 ** math.floor(math.log2(top))


# (B·H, Sq, Sk): one 512-wide head over 1024 tokens, as the bf16 VAE's
# mid-block at 32² latents; Sq ≠ Sk both ways; two heads
@pytest.mark.parametrize("shape", [(1, 1024, 1024), (1, 384, 640), (2, 640, 256)])
def test_k1_bf16_d512_plain_version_matches_pallas(shape):
    """The plain version at the kernel's 32-key tile, probabilities rounded
    to bf16 before P·V, against `_flash_forward` in bf16 in interpret mode
    at the same key tile: within two bf16 ulps of max |reference| (measured
    one ulp or less)."""
    bh, sq, sk = shape
    rng = np.random.default_rng(sq + sk + bh)
    q, k, v = (rng.normal(size=(bh, n, 512)).astype(np.float32) for n in (sq, sk, sk))
    scale = 512 ** -0.5
    ref = np.asarray(jfa._flash_forward(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), scale, block_q=128,
        block_k=KEY_TILE, interpret=True).astype(jnp.float32))
    out = tfa.flash_forward_plain(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                                  scale, block_k=KEY_TILE)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= _two_ulps(ref)


# (B·H, Sq, Sk): one head over 256 tokens; Sq ≠ Sk both ways, two heads
# (ring attention's shards of the VAE's head hand K2 Sq = Sk)
@pytest.mark.parametrize("shape", [(1, 256, 256), (1, 128, 384), (2, 384, 256)])
def test_k2_bf16_d512_plain_version_matches_pallas(shape):
    """K2's plain version at the kernel's 32-key tile against
    `_flash_forward_lse` in bf16 in interpret mode at the same key tile: O
    (bf16) within two bf16 ulps of max |reference|, L (f32, Pallas's
    first of its 128 lanes) within 1e-5 absolute (|L| is about 6 here; the
    two sum the same f32 terms in other orders; measured half an ulp or
    less on O, 4.8e-7 on L)."""
    bh, sq, sk = shape
    rng = np.random.default_rng(3 * sq + sk + bh)
    q, k, v = (rng.normal(size=(bh, n, 512)).astype(np.float32) for n in (sq, sk, sk))
    scale = 512 ** -0.5
    ref_o, ref_l = jfa._flash_forward_lse(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), scale, block_q=128,
        block_k=KEY_TILE, interpret=True)
    assert ref_o.dtype == jnp.bfloat16 and ref_l.dtype == jnp.float32
    ref_o, ref_l = np.asarray(ref_o.astype(jnp.float32)), np.asarray(ref_l[..., 0])
    out, lse = tfa.flash_forward_lse_plain(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), scale, block_k=KEY_TILE)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert lse.shape == ref_l.shape == (bh, sq)
    assert np.abs(out.float().numpy() - ref_o).max() <= _two_ulps(ref_o)
    assert np.abs(lse.numpy() - ref_l).max() <= 1e-5


VAE = dict(block_out_channels=(512,), layers_per_block=1, sample_size=32, attn_impl="flash")


@pytest.fixture(scope="module")
def vae_params():
    jvae = jmodels.AutoencoderKL(jmodels.sd_vae(**VAE))
    return flax_params(jvae, jnp.zeros((1, 32, 32, 3)), seed=5)


def _vae_pair(params, dtype):
    jvae = jmodels.AutoencoderKL(jmodels.sd_vae(**VAE, dtype=dtype))
    tvae = tmodels.load_flax_params(
        tmodels.AutoencoderKL(tmodels.sd_vae(**VAE, dtype=dtype)), params)
    return jvae, tvae.eval()


def _encode_decode(params, dtype, monkeypatch):
    """(JAX, port) latents and images of one seeded image through both
    VAEs, and the K1 launches of the port's pass (its plain version, on the
    CPU) at (1, 1024, 512)."""
    jvae, tvae = _vae_pair(params, dtype)
    assert tvae.encoder.mid_block.attentions[0].attn_impl == "flash"
    x = np.random.default_rng(7).uniform(-1, 1, size=(1, 32, 32, 3)).astype(np.float32)
    jz = jvae.apply(params, jnp.asarray(x), method=jvae.encode)
    jimg = jvae.apply(params, jz, method=jvae.decode)
    shapes = []
    plain = tfa.flash_forward_plain
    monkeypatch.setattr(tfa, "flash_forward_plain", lambda q, *a, **kw: (
        shapes.append((tuple(q.shape), q.dtype)), plain(q, *a, **kw))[1])
    with torch.no_grad():
        tz = tvae.encode(nchw(x))
        timg = tvae.decode(tz)
    monkeypatch.undo()
    to_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return ((to_np(jz), to_np(jimg)), (nhwc(tz.float()), nhwc(timg.float())), shapes)


def test_vae_f32_with_flash_matches_jax(vae_params, monkeypatch):
    """f32: the port's VAE (K1's plain version at the mid-blocks) against
    the JAX VAE (the Pallas kernel in interpret mode there) on the same
    weights: latents and images within 1e-5 of max(1, max |JAX|) (measured
    9.9e-7 on the latents, 1.0e-5 on the images, max |image| 2.48)."""
    (jz, jimg), (tz, timg), shapes = _encode_decode(vae_params, "float32", monkeypatch)
    assert shapes == [((1, 1024, 512), torch.float32)] * 2
    for got, want in ((tz, jz), (timg, jimg)):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_vae_bf16_with_flash_matches_jax(vae_params, monkeypatch):
    """bf16, as `sd_vae(dtype="bfloat16")` builds it in both packages: the
    two VAEs round at other places (torch's and XLA's bf16 convolutions and
    norms), so they are held to a bf16 scale, 8 ulps of the largest value
    (2^-4 of max |JAX| at most; measured 4 ulps on the latents, 3.6 on the
    images), and to the JAX f32 VAE no farther than twice the JAX bf16 VAE's
    distance from it (measured 0.72× and 0.80×)."""
    (jz, jimg), (tz, timg), shapes = _encode_decode(vae_params, "bfloat16", monkeypatch)
    assert shapes == [((1, 1024, 512), torch.bfloat16)] * 2
    (jz32, jimg32), _, _ = _encode_decode(vae_params, "float32", monkeypatch)
    for got, want, want32 in ((tz, jz, jz32), (timg, jimg, jimg32)):
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() <= 4 * _two_ulps(want)
        assert np.abs(got - want32).max() <= 2 * np.abs(want - want32).max()
