"""Port K1 module (diffusion_pullback_tpu_torch/ops/flash_attention.py) on
the CPU: the plain version behind attention(impl='flash') against the
Pallas kernel in interpret mode, and the flash/math dispatch of both
packages. Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401

import diffusion_pullback_tpu.ops.pallas.flash_attention as jfa
from diffusion_pullback_tpu.ops.attention import attention as jattention
from diffusion_pullback_tpu_torch.ops import attention as tattn_mod
from diffusion_pullback_tpu_torch.ops import flash_attention as tfa
from diffusion_pullback_tpu_torch.ops.attention import attention, xla_attention


def _qkv(b, sq, sk, h, d, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, d)).astype(dtype)
                 for s in (sq, sk, sk))


@pytest.mark.parametrize("b,s,h,d", [(1, 1024, 2, 16), (1, 1024, 1, 64)])
def test_flash_plain_matches_pallas_interpret(b, s, h, d):
    q, k, v = _qkv(b, s, s, h, d)
    out = attention(*map(torch.from_numpy, (q, k, v)), impl="flash").numpy()
    ref = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)),
                                         interpret=True))
    np.testing.assert_allclose(out, ref, atol=1e-5)

    # the kernel-level entry at 128×128 Pallas blocks, on (B·H, S, D)
    to_bh = lambda x: x.transpose(0, 2, 1, 3).reshape(b * h, s, d)
    qb, kb, vb = map(to_bh, (q, k, v))
    ref_bh = np.asarray(jfa._flash_forward(
        *map(jnp.asarray, (qb, kb, vb)), d ** -0.5, block_q=128, block_k=128,
        interpret=True))
    out_bh = tfa.flash_forward(*map(torch.from_numpy, (qb, kb, vb)),
                               d ** -0.5).numpy()
    np.testing.assert_allclose(out_bh, ref_bh, atol=1e-5)


# key blocks: the plain version's default (512) and the wgmma kernel's key
# tile (64; ops/csrc/flash_fwd_tc.cu)
@pytest.mark.parametrize("block_k", [512, 64])
def test_flash_plain_bf16_matches_pallas_interpret(block_k):
    """bf16 inputs: both round the probabilities to bf16 before P·V and the
    output to bf16; one bf16 ulp (2⁻⁷ at |x|≈1) is the tolerance. At each
    key block, K1 (Pallas at block_q = block_k) against the plain version at
    that block, and K2 likewise, its L against the Pallas kernel's lane 0 to
    1e-5."""
    import ml_dtypes

    q, k, v = _qkv(2, 1024, 1024, 1, 64, seed=3)
    qb, kb, vb = (x[:, :, 0].astype(ml_dtypes.bfloat16) for x in (q, k, v))
    jq, jk, jv = map(jnp.asarray, (qb, kb, vb))
    blocks = dict(block_q=block_k, block_k=block_k, interpret=True)
    ref = np.asarray(jfa._flash_forward(jq, jk, jv, 0.125, **blocks), np.float32)
    tt = lambda x: torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    tq, tk, tv = tt(qb), tt(kb), tt(vb)
    out = tfa.flash_forward_plain(tq, tk, tv, 0.125, block_k=block_k)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2 ** -7)
    if block_k == 512:  # the wrapper's CPU path is the plain version at 512
        assert torch.equal(tfa.flash_forward(tq, tk, tv, 0.125), out)

    ref_o, ref_l = jfa._flash_forward_lse(jq, jk, jv, 0.125, **blocks)
    out_o, out_l = tfa.flash_forward_lse_plain(tq, tk, tv, 0.125, block_k=block_k)
    np.testing.assert_allclose(out_o.float().numpy(),
                               np.asarray(ref_o, np.float32), atol=2 ** -7)
    np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l)[..., 0],
                               atol=1e-5, rtol=0)


def test_flash_plain_ragged_blocks_match_math_path():
    """Sk not a multiple of the 512-key block: the last block is short."""
    q, k, v = map(torch.from_numpy, _qkv(2, 300, 700, 3, 8, seed=1))
    to_bh = lambda x: x.transpose(1, 2).reshape(6, x.shape[1], 8)
    out = tfa.flash_forward(to_bh(q), to_bh(k), to_bh(v), 8 ** -0.5)
    ref = to_bh(xla_attention(q, k, v))
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("sq,sk,flash", [
    (1024, 1024, True), (4096, 4096, True), (1536, 1536, True),
    (2048, 128, True), (1024, 77, False), (512, 512, False),
    (1280, 1280, False), (2048, 127, False), (4096, 1000, False),
])
def test_dispatch_thresholds_match_jax(monkeypatch, sq, sk, flash):
    """Flash only when sq ≥ 1024, sk ≥ 128 and both divide by min(512, s)
    (ops/attention.py:96 of the JAX package), in both packages."""
    took = {}

    def spy(tag):
        def f(q, k, v, scale=None, interpret=False):
            took[tag] = True
            return q
        return f

    monkeypatch.setattr(jfa, "flash_attention", spy("jax"))
    monkeypatch.setattr(tattn_mod, "flash_attention", spy("torch"))
    q, k, v = _qkv(1, sq, sk, 1, 4)
    jattention(*map(jnp.asarray, (q, k, v)), impl="flash")
    attention(*map(torch.from_numpy, (q, k, v)), impl="flash")
    assert took == ({"jax": True, "torch": True} if flash else {})
