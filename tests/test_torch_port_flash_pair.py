"""Port K2–K5 (diffusion_pullback_tpu_torch/ops/flash_attention.py) on the
CPU: the kernels' plain versions against the Pallas kernels in interpret
mode, and the autograd Functions (_Flash, _FlashFwdMode) under torch.func
against the JAX package's custom_vjp / custom_jvp pair under jax.jvp,
jax.vmap and jax.vjp. Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.func import jvp, vjp, vmap
from torch_port_common import one_torch_thread  # noqa: F401

import diffusion_pullback_tpu.ops.pallas.flash_attention as jfa
from diffusion_pullback_tpu_torch.ops import flash_attention as tfa
from diffusion_pullback_tpu_torch.ops.attention import attention, xla_attention

BLOCKS = dict(block_q=128, block_k=128, interpret=True)


def _arrays(n, shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype) for _ in range(n)]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _primal(bh, s, d, seed, sk=None):
    """q (bh, s, d), k, v (bh, sk or s, d) and K2's (o, lse) from the
    Pallas kernel, as numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(bh, n, d)).astype(np.float32)
               for n in (s, sk or s, sk or s))
    o, lse = jfa._flash_forward_lse(*map(jnp.asarray, (q, k, v)), d ** -0.5,
                                    **BLOCKS)
    return q, k, v, np.asarray(o), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("bh,s,d", [(2, 256, 16), (1, 512, 64)])
def test_forward_lse_plain_matches_pallas(bh, s, d):
    q, k, v, o, lse = _primal(bh, s, d, seed=0)
    out, tlse = tfa.flash_forward_lse(_t(q), _t(k), _t(v), d ** -0.5)
    assert tlse.shape == (bh, s) and tlse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), o, atol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), lse, atol=1e-5)


@pytest.mark.parametrize("bh,s,d", [(2, 256, 16), (1, 512, 64)])
def test_tangent_plain_matches_pallas(bh, s, d):
    q, k, v, o, lse = _primal(bh, s, d, seed=1)
    dq, dk, dv = _arrays(3, (bh, s, d), seed=2)
    lse128 = jnp.broadcast_to(jnp.asarray(lse)[..., None], (bh, s, 128))
    ref = jfa._flash_tangent(*map(jnp.asarray, (q, k, v, dq, dk, dv, o)),
                             lse128, d ** -0.5, **BLOCKS)
    out = tfa.flash_tangent(*map(_t, (q, k, v, dq, dk, dv, o, lse)), d ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# (B·H, Sq, Sk, D): square, and Sq ≠ Sk both ways (the card tests hold the
# kernels K4 and K5 to these plain versions at unequal lengths)
@pytest.mark.parametrize("bh,s,sk,d", [
    pytest.param(2, 256, 256, 16, id="2-256-16"),
    pytest.param(1, 512, 512, 64, id="1-512-64"),
    pytest.param(2, 256, 512, 64, id="2-256x512-64"),
    pytest.param(2, 512, 256, 64, id="2-512x256-64")])
def test_backward_plain_matches_pallas(bh, s, sk, d):
    q, k, v, o, lse = _primal(bh, s, d, seed=3, sk=sk)
    (do,) = _arrays(1, (bh, s, d), seed=4)
    lse128 = jnp.broadcast_to(jnp.asarray(lse)[..., None], (bh, s, 128))
    ref = jfa._flash_backward(*map(jnp.asarray, (q, k, v, o, do)), lse128,
                              d ** -0.5, **BLOCKS)
    tq, tk, tv, to, tdo, tlse = map(_t, (q, k, v, o, do, lse))
    delta = (tdo * to).sum(-1)
    dq = tfa.flash_dq(tq, tk, tv, tdo, tlse, delta, d ** -0.5)
    dk, dv = tfa.flash_dkv(tq, tk, tv, tdo, tlse, delta, d ** -0.5)
    for mine, theirs in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-5)


def test_bf16_plain_matches_pallas():
    """bf16 inputs: both round P, P∘Ṡ and dS to bf16 before their products
    and the outputs to bf16, from f32 sums taken in another order; one bf16
    ulp of max |Pallas| is the tolerance."""
    bh, s, d = 2, 256, 64
    bf = ml_dtypes.bfloat16
    q, k, v, dq, dk, dv, do = (x.astype(bf) for x in _arrays(7, (bh, s, d), 5))
    tb = lambda x: torch.from_numpy(np.asarray(x).astype(np.float32)).to(torch.bfloat16)
    j = lambda *xs: [jnp.asarray(x) for x in xs]
    scale = d ** -0.5
    o, lse = jfa._flash_forward_lse(*j(q, k, v), scale, **BLOCKS)
    tan = jfa._flash_tangent(*j(q, k, v, dq, dk, dv), o, lse, scale, **BLOCKS)
    grads = jfa._flash_backward(*j(q, k, v), o, jnp.asarray(do), lse, scale,
                                **BLOCKS)

    to, tlse = tfa.flash_forward_lse(tb(q), tb(k), tb(v), scale)
    ttan = tfa.flash_tangent(*map(tb, (q, k, v, dq, dk, dv)), tb(o),
                             _t(lse[..., 0]), scale)
    tdo = tb(do)
    delta = (tdo.float() * tb(o).float()).sum(-1)
    args = (tb(q), tb(k), tb(v), tdo, _t(lse[..., 0]), delta, scale)
    tgrads = (tfa.flash_dq(*args), *tfa.flash_dkv(*args))

    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse)[..., 0], atol=1e-5)
    pairs = [(to, o), (ttan, tan.astype(jnp.bfloat16))] + list(zip(tgrads, grads))
    for mine, theirs in pairs:
        assert mine.dtype == torch.bfloat16
        ref = np.asarray(theirs, np.float32)
        ulp = 2.0 ** -7 * 2.0 ** np.floor(np.log2(np.abs(ref).max()))
        np.testing.assert_allclose(mine.float().numpy(), ref, atol=ulp)


# ---- the Functions under torch.func against the JAX pair --------------------

def _bshd(seed, n=3, b=1, s=256, h=2, d=16):
    return _arrays(n, (b, s, h, d), seed)


def _jvp_jax(fn, primals, tangents):
    return jax.jvp(fn, tuple(map(jnp.asarray, primals)),
                   tuple(map(jnp.asarray, tangents)))


@pytest.mark.parametrize("tangents", ["all", "k_none", "v_zero"])
def test_jvp_matches_jax(tangents):
    q, k, v = _bshd(10)
    dq, dk, dv = _bshd(11)
    if tangents == "v_zero":
        dv = np.zeros_like(dv)
    jf = lambda q, k, v: jfa.flash_attention_jvp(q, k, v, interpret=True)
    if tangents == "k_none":  # k a constant: no tangent reaches the rule
        o_ref, t_ref = _jvp_jax(lambda q, v: jf(q, jnp.asarray(k), v), (q, v), (dq, dv))
        o, t = jvp(lambda q, v: tfa.flash_attention_jvp(q, _t(k), v),
                   (_t(q), _t(v)), (_t(dq), _t(dv)))
    else:
        o_ref, t_ref = _jvp_jax(jf, (q, k, v), (dq, dk, dv))
        o, t = jvp(tfa.flash_attention_jvp, tuple(map(_t, (q, k, v))),
                   tuple(map(_t, (dq, dk, dv))))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=1e-5)


def test_vmapped_jvp_unbatched_primals_matches_jax():
    """The pullback's tangent half: primals fixed, tangents vmapped over
    probes (the K3 rule folds them into B·H and shares the primal)."""
    q, k, v = _bshd(12)
    (dqs,) = _arrays(1, (3, 1, 256, 2, 16), 13)
    jf = lambda x: jfa.flash_attention_jvp(x, jnp.asarray(k), jnp.asarray(v),
                                           interpret=True)
    ref = jax.vmap(lambda t: jax.jvp(jf, (jnp.asarray(q),), (t,))[1])(
        jnp.asarray(dqs))
    tf = lambda x: tfa.flash_attention_jvp(x, _t(k), _t(v))
    out = vmap(lambda t: jvp(tf, (_t(q),), (t,))[1])(_t(dqs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_vmapped_vjp_matches_jax():
    """The pullback's cotangent half: one vjp, its function vmapped over
    cotangents (the K4/K5 rules fold them into B·H)."""
    q, k, v = _bshd(14)
    (gs,) = _arrays(1, (3, 1, 256, 2, 16), 15)
    jf = lambda q, k, v: jfa.flash_attention(q, k, v, interpret=True)
    _, jvjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    ref = jax.vmap(jvjp)(jnp.asarray(gs))
    _, tvjp = vjp(tfa.flash_attention, *map(_t, (q, k, v)))
    out = vmap(tvjp)(_t(gs))
    for mine, theirs in zip(out, ref):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-5)


def test_pair_through_dispatch_matches_math_path():
    """attention(impl='flash_jvp' / 'flash') at 1024 tokens, differentiated
    as the pullback does, equals the math path's jvp and vjp."""
    q, k, v = map(_t, _bshd(16, s=1024))
    (t,) = map(_t, _bshd(17, n=1, s=1024))
    f = lambda impl: (lambda x: attention(x, k, torch.tanh(x), impl=impl))
    _, t_pair = jvp(f("flash_jvp"), (q,), (t,))
    _, t_math = jvp(f("xla"), (q,), (t,))
    torch.testing.assert_close(t_pair, t_math, atol=1e-5, rtol=0)
    _, vjp_pair = vjp(f("flash"), q)
    _, vjp_math = vjp(f("xla"), q)
    torch.testing.assert_close(vjp_pair(t)[0], vjp_math(t)[0], atol=1e-5, rtol=0)


def test_flash_takes_k1_without_grad_and_k2_with(monkeypatch):
    calls = []
    for name in ("flash_forward_plain", "flash_forward_lse_plain"):
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _f=real, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    q, k, v = map(_t, _bshd(18))
    with torch.no_grad():
        tfa.flash_attention(q, k, v)
    assert calls == ["flash_forward_plain"]
    calls.clear()
    out = tfa.flash_attention(q.requires_grad_(), k, v)
    assert calls == ["flash_forward_lse_plain"]
    out.sum().backward()
    ref = q.detach().requires_grad_()
    xla_attention(ref, k, v).sum().backward()
    torch.testing.assert_close(q.grad, ref.grad, atol=1e-5, rtol=0)


def test_raise_rules():
    """_Flash (custom_vjp) has no forward-mode rule, _FlashFwdMode
    (custom_jvp) no reverse-mode rule, as in the JAX package."""
    q, k, v = map(_t, _bshd(19))
    with pytest.raises(NotImplementedError, match="no forward-mode rule"):
        jvp(tfa.flash_attention, (q, k, v), (q, k, v))
    _, back = vjp(tfa.flash_attention_jvp, q, k, v)
    with pytest.raises(NotImplementedError, match="not reverse-mode"):
        back(q)
    x = _t(_bshd(20, n=1, s=700)[0])
    for entry in (tfa.flash_attention, tfa.flash_attention_jvp):
        with pytest.raises(ValueError, match="divisible"):
            entry(x, x, x)
