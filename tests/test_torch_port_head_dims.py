"""Port K1–K5 at the head dims that SD 1.5 (8 heads of 40, 80 and 160) and
ImageNet128Cond (4 heads of 128) give the kernels, on the CPU: the
kernels' plain versions (diffusion_pullback_tpu_torch/ops/flash_attention.py)
against the Pallas kernels in interpret mode (_flash_forward,
_flash_forward_lse, _flash_tangent, _flash_backward, with 128-blocks over
256 tokens, as tests/test_flash_attention.py runs them). Inputs are made
with numpy from a seed.

Gates: f32 within 1e-5 (the two take their f32 sums in another order);
bf16 within one bf16 ulp of max |Pallas| (both round P, P∘Ṡ and dS to bf16
before their products and the outputs to bf16), L within 1e-5."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401

import diffusion_pullback_tpu.ops.pallas.flash_attention as jfa
from diffusion_pullback_tpu_torch.ops import flash_attention as tfa

BLOCKS = dict(block_q=128, block_k=128, interpret=True)
S = 256
HEAD_DIMS = (40, 80, 128, 160)


def _arrays(n, shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype) for _ in range(n)]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _lse128(lse):
    return jnp.broadcast_to(jnp.asarray(lse)[..., None], (*lse.shape, 128))


def test_the_port_takes_every_head_dim_a_model_config_routes_to_the_kernels():
    assert set(HEAD_DIMS) <= set(tfa.PAIR_HEAD_DIMS)
    assert tfa.HEAD_DIMS == tfa.PAIR_HEAD_DIMS + (512,)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_forward_plain_matches_pallas(d):
    q, k, v = _arrays(3, (2, S, d), seed=d)
    ref = jfa._flash_forward(*map(jnp.asarray, (q, k, v)), d ** -0.5, **BLOCKS)
    out = tfa.flash_forward(_t(q), _t(k), _t(v), d ** -0.5)
    assert out.shape == (2, S, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_forward_lse_plain_matches_pallas(d):
    q, k, v = _arrays(3, (2, S, d), seed=d + 1)
    o, lse = jfa._flash_forward_lse(*map(jnp.asarray, (q, k, v)), d ** -0.5, **BLOCKS)
    out, tlse = tfa.flash_forward_lse(_t(q), _t(k), _t(v), d ** -0.5)
    assert tlse.shape == (2, S) and tlse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(o), atol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse)[..., 0], atol=1e-5)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tangent_plain_matches_pallas(d):
    q, k, v, dq, dk, dv = _arrays(6, (2, S, d), seed=d + 2)
    o, lse = jfa._flash_forward_lse(*map(jnp.asarray, (q, k, v)), d ** -0.5, **BLOCKS)
    ref = jfa._flash_tangent(*map(jnp.asarray, (q, k, v, dq, dk, dv)), o, lse,
                             d ** -0.5, **BLOCKS)
    out = tfa.flash_tangent(*map(_t, (q, k, v, dq, dk, dv, o)),
                            _t(np.asarray(lse)[..., 0]), d ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_backward_plain_matches_pallas(d):
    q, k, v, do = _arrays(4, (2, S, d), seed=d + 3)
    o, lse = jfa._flash_forward_lse(*map(jnp.asarray, (q, k, v)), d ** -0.5, **BLOCKS)
    ref = jfa._flash_backward(*map(jnp.asarray, (q, k, v)), o, jnp.asarray(do), lse,
                              d ** -0.5, **BLOCKS)
    tq, tk, tv, to, tdo = map(_t, (q, k, v, o, do))
    tlse = _t(np.asarray(lse)[..., 0])
    delta = (tdo * to).sum(-1)
    dq = tfa.flash_dq(tq, tk, tv, tdo, tlse, delta, d ** -0.5)
    dk, dv = tfa.flash_dkv(tq, tk, tv, tdo, tlse, delta, d ** -0.5)
    for mine, theirs in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-5)


def _bf16_close(mine, theirs):
    assert mine.dtype == torch.bfloat16
    ref = np.asarray(theirs, np.float32)
    ulp = 2.0 ** -7 * 2.0 ** np.floor(np.log2(np.abs(ref).max()))
    np.testing.assert_allclose(mine.float().numpy(), ref, atol=ulp)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bf16_plain_matches_pallas(d):
    """K1–K5 in bf16 at each head dim: one case per kernel."""
    bf = ml_dtypes.bfloat16
    q, k, v, dq, dk, dv, do = (x.astype(bf) for x in _arrays(7, (2, S, d), d + 4))
    tb = lambda x: torch.from_numpy(np.asarray(x).astype(np.float32)).to(torch.bfloat16)
    j = lambda *xs: [jnp.asarray(x) for x in xs]
    scale = d ** -0.5
    o1 = jfa._flash_forward(*j(q, k, v), scale, **BLOCKS)
    o, lse = jfa._flash_forward_lse(*j(q, k, v), scale, **BLOCKS)
    tan = jfa._flash_tangent(*j(q, k, v, dq, dk, dv), o, lse, scale, **BLOCKS)
    grads = jfa._flash_backward(*j(q, k, v), o, jnp.asarray(do), lse, scale, **BLOCKS)

    tlse_ref = _t(np.asarray(lse)[..., 0])
    to1 = tfa.flash_forward(tb(q), tb(k), tb(v), scale)
    to, tlse = tfa.flash_forward_lse(tb(q), tb(k), tb(v), scale)
    ttan = tfa.flash_tangent(*map(tb, (q, k, v, dq, dk, dv)), tb(o), tlse_ref, scale)
    tdo = tb(do)
    delta = (tdo.float() * tb(o).float()).sum(-1)
    args = (tb(q), tb(k), tb(v), tdo, tlse_ref, delta, scale)
    tgrads = (tfa.flash_dq(*args), *tfa.flash_dkv(*args))

    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse)[..., 0], atol=1e-5)
    pairs = [(to1, o1), (to, o), (ttan, tan.astype(jnp.bfloat16))] + list(
        zip(tgrads, grads))
    for mine, theirs in pairs:
        _bf16_close(mine, theirs)
