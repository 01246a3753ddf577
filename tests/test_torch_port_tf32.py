"""The precision argument of the 'tf32x3' design, K1 and K2
(ops/csrc/flash_fwd_tf32.cu at D = 512, ops/csrc/flash_fwd_tf32_rows.cu at
D = 40, 64, 80, 128 and 160), K3 (ops/csrc/flash_jvp_tf32_rows.cu) and K4
and K5 (ops/csrc/flash_bwd_tf32_rows.cu) at D = 40–160 (the split in
ops/csrc/tf32.cuh), on the CPU: each f32 product as three TF32 products
keeps the design's f32 gate, and one TF32 product does not. The gate is
2.5e-5, not 1e-4: at the VAE's 4096 tokens one TF32 product stays under
1e-4. K1 and K2 are held to it absolutely; K3's Ȯ, K4's dQ and K5's dK
and dV, sums over every key or query, to 2.5e-5 of max(1, max
|reference|).

TF32 rounding is emulated here with integer bit masks (round to nearest,
ties away from zero, to 10 stored mantissa bits, as cvt.rna.tf32.f32), and
the split as the kernels make it: hi rounded, lo = x − hi passed whole, of
which the tensor core reads the TF32 bits (lo truncated). A product of two
TF32 values is exact in f32, so an f32 matrix product of TF32 operands is
what the tensor cores compute, up to the order of the f32 sums. The
attention is computed at the VAE mid-block head's width (D = 512) and at
the U-Nets' head dims, with inputs made with numpy from a seed, and held
against the JAX package's f32 reference and its Pallas kernels in
interpret mode; the backward against `_flash_backward` in interpret mode,
`jax.vjp` of the f32 reference and the port's plain versions; the tangent
against `_flash_tangent` in interpret mode, `jax.jvp` of the f32 reference
and the port's plain version.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401

import diffusion_pullback_tpu.ops.pallas.flash_attention as jfa
from diffusion_pullback_tpu_torch.ops import flash_attention as tfa

GATE = 2.5e-5  # K1 and K2 on tf32x3 against their plain versions (chip_smoke.py, card tests)
SHAPE = (1, 256, 512)  # (B·H, S, D): one 512-wide head, as the VAE's
HEAD_DIMS = [40, 64, 80, 128, 160]  # the U-Nets' self-attentions, on flash_fwd_tf32_rows.cu


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32: to nearest, ties away from zero, keeping 10
    of the 23 mantissa bits (the low 13 bits cleared)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncated(x: torch.Tensor) -> torch.Tensor:
    """The TF32 bits of x (f32), the low 13 mantissa bits cleared: what the
    tensor core reads of an operand that is not rounded to TF32."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    """x as hi + lo as the kernels split it: hi = tf32(x), lo = x − hi of
    which the tensor core reads truncated(lo)."""
    hi = tf32(x)
    return hi, truncated(x - hi)


def matmul_tf32(a, b, terms):
    """a·b with TF32 operands: one product (hi·hi) or three, the small
    terms first (lo·hi + hi·lo + hi·hi), summed in f32."""
    (ah, al), (bh, bl) = split(a), split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def attention_tf32(q, k, v, scale, terms):
    """softmax(Q Kᵀ·scale)·V in f32 with both products in TF32 (P split
    like the inputs: in f32 the kernel does not round it)."""
    return attention_lse_tf32(q, k, v, scale, terms)[0]


def attention_lse_tf32(q, k, v, scale, terms):
    """(O, L): attention_tf32 and the row logsumexp of its logits (K2)."""
    s = matmul_tf32(q, k.transpose(-1, -2), terms) * scale
    return matmul_tf32(torch.softmax(s, dim=-1), v, terms), torch.logsumexp(s, dim=-1)


def _inputs(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def _xla_reference(q, k, v, scale):
    """The JAX package's f32 attention, (B, S, H, D) with one head."""
    return np.asarray(jfa._xla_reference(
        *(jnp.asarray(x[:, :, None]) for x in (q, k, v)), scale))[:, :, 0]


def test_tf32_rounding_emulation():
    """Round to nearest on the 10th mantissa bit, ties away from zero, sign
    kept; a TF32 value is unchanged; hi + lo holds about 21 bits of x."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4, -(1 + ulp / 2),
                      1 + ulp, 3.0], dtype=torch.float32)
    want = torch.tensor([1, 1 + ulp, 1 + ulp, -(1 + ulp), 1 + ulp, 3.0])
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(_inputs()[0])
    assert torch.equal(tf32(tf32(y)), tf32(y))
    hi, lo = split(y)
    rel = ((hi + lo - y).abs() / y.abs()).max().item()
    assert rel <= 2.0 ** -21
    assert ((tf32(y) - y).abs() / y.abs()).max().item() > 2.0 ** -13


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("terms", [3, 1])
def test_tf32x3_keeps_the_f32_gate(reference, terms):
    """Three TF32 products per f32 product stay within a tenth of K1's
    tf32x3 gate of the JAX package's f32 attention (measured 1.0e-6); one
    TF32 product misses the gate by more than 2× (measured 3.1e-4)."""
    q, k, v = _inputs()
    scale = SHAPE[-1] ** -0.5
    if reference == "xla":
        ref = _xla_reference(q, k, v, scale)
    else:
        ref = np.asarray(jfa._flash_forward(
            *map(jnp.asarray, (q, k, v)), scale, interpret=True))
    out = attention_tf32(*map(torch.from_numpy, (q, k, v)), scale, terms).numpy()
    err = np.abs(out - ref).max()
    if terms == 3:
        assert err <= GATE / 10, err
    else:
        assert err > 2 * GATE, err


def test_one_tf32_product_passes_1e4_at_4096_tokens():
    """At the VAE's 4096 tokens each output averages over more keys: one
    TF32 product per f32 product falls under 1e-4 of the JAX package's f32
    attention (measured 7.5e-5), so 1e-4 would not tell it from three, and
    the tf32x3 gate still rejects it; three stay within a tenth of the gate
    (measured 2.8e-7)."""
    shape = (1, 4096, 512)
    q, k, v = _inputs(shape=shape)
    scale = shape[-1] ** -0.5
    ref = _xla_reference(q, k, v, scale)
    err = {terms: np.abs(attention_tf32(*map(torch.from_numpy, (q, k, v)), scale,
                                        terms).numpy() - ref).max()
           for terms in (3, 1)}
    assert err[3] <= GATE / 10, err
    assert GATE < err[1] < 1e-4, err


@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tf32x3_rows_keep_the_f32_gate_at_1024_tokens(d, terms):
    """At the U-Nets' head dims over 1024 tokens (one head, the JAX
    package's f32 attention as the reference): three TF32 products per f32
    product stay within a tenth of the gate (measured 3.0e-7 to 5.1e-7 at
    D = 40–160); one TF32 product lies above the gate (measured 1.2e-4 to
    2.5e-4), so the card's gate tells the two apart at every head dim the
    rows kernel serves."""
    q, k, v = _inputs(shape=(1, 1024, d))
    scale = d ** -0.5
    ref = _xla_reference(q, k, v, scale)
    out = attention_tf32(*map(torch.from_numpy, (q, k, v)), scale, terms).numpy()
    err = np.abs(out - ref).max()
    if terms == 3:
        assert err <= GATE / 10, err
    else:
        assert err > GATE, err


@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tf32x3_rows_keep_the_f32_gate_against_pallas(d, terms):
    """The same against the Pallas kernels K1 and K2 replace, in interpret
    mode over 256 tokens: three TF32 products keep O (against
    `_flash_forward` and `_flash_forward_lse`) and K2's L within a tenth of
    the gate (measured O 5.2e-7 to 7.8e-7, L 4.8e-7: one f32 ulp of |L| ≈
    6.4); one TF32 product puts O above the gate (measured 2.5e-4 to
    4.0e-4)."""
    q, k, v = _inputs(shape=(1, 256, d))
    scale = d ** -0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref_o = np.asarray(jfa._flash_forward(jq, jk, jv, scale, interpret=True))
    ref_o2, ref_l = (np.asarray(x) for x in jfa._flash_forward_lse(jq, jk, jv, scale,
                                                                   interpret=True))
    out, lse = (x.numpy() for x in attention_lse_tf32(*map(torch.from_numpy, (q, k, v)),
                                                      scale, terms))
    err_o = max(np.abs(out - ref_o).max(), np.abs(out - ref_o2).max())
    if terms == 3:
        assert err_o <= GATE / 10, err_o
        err_l = np.abs(lse - ref_l[..., 0]).max()  # Pallas broadcasts L over 128 lanes
        assert err_l <= GATE / 10, err_l
    else:
        assert err_o > GATE, err_o


def backward_tf32(q, k, v, do, lse, delta, scale, terms):
    """(dQ, dK, dV) of K4 and K5 with the operands of Q·Kᵀ, dO·Vᵀ, dS·K,
    Pᵀ·dO and dSᵀ·Q in TF32 (matmul_tf32; P and dS split like the inputs:
    in f32 the kernels do not round them), P = exp(S·scale − L), dS = P ∘
    (dO·Vᵀ − δ). The cotangent (do, delta) may carry r times the primal's
    B·H, slice b reading primal slice b % B·H, as the kernels index them."""
    r = do.shape[0] // q.shape[0]
    q, k, v, lse = (x.repeat(r, *(1,) * (x.ndim - 1)) for x in (q, k, v, lse))
    p = torch.exp(matmul_tf32(q, k.transpose(-1, -2), terms) * scale - lse[..., None])
    ds = p * (matmul_tf32(do, v.transpose(-1, -2), terms) - delta[..., None])
    return (matmul_tf32(ds, k, terms) * scale,
            matmul_tf32(ds.transpose(-1, -2), q, terms) * scale,
            matmul_tf32(p.transpose(-1, -2), do, terms))


@functools.lru_cache(maxsize=None)
def _backward_case(bhp, sq, sk, r, d):
    """Inputs from a numpy seed and the references of one backward case:
    q (bhp, sq, d), k/v (bhp, sk, d), a cotangent of r·bhp slices; L and O
    from the Pallas forward (K2) in interpret mode, δ = rowsum(dO∘O); the
    references (dQ, dK, dV) of `_flash_backward` in interpret mode (blocks
    of 512, 256 or 128 rows, over the primal tiled r times), of `jax.vjp` of the JAX
    package's f32 attention and of the port's plain versions."""
    rng = np.random.default_rng(d + sq + 7 * sk + r)
    q, k, v = (rng.normal(size=(bhp, n, d)).astype(np.float32) for n in (sq, sk, sk))
    do = rng.normal(size=(r * bhp, sq, d)).astype(np.float32)
    scale = d ** -0.5
    block = lambda n: next(b for b in (512, 256, 128) if n % b == 0)
    blocks = dict(block_q=block(sq), block_k=block(sk), interpret=True)
    tile = lambda x: jnp.asarray(np.tile(x, (r, 1, 1)))
    o, lse = jfa._flash_forward_lse(*map(tile, (q, k, v)), scale, **blocks)
    pallas = jfa._flash_backward(*map(tile, (q, k, v)), o, jnp.asarray(do), lse, scale,
                                 **blocks)
    to_bshd = lambda x: jnp.asarray(x)[:, :, None]
    _, vjp = jax.vjp(lambda a, b, c: jfa._xla_reference(a, b, c, scale),
                     *map(to_bshd, (np.tile(q, (r, 1, 1)), np.tile(k, (r, 1, 1)),
                                    np.tile(v, (r, 1, 1)))))
    xla = [np.asarray(g)[:, :, 0] for g in vjp(to_bshd(do))]
    t = lambda x: torch.from_numpy(np.array(x, np.float32))
    tq, tk, tv, tdo = map(t, (q, k, v, do))
    tlse = t(np.asarray(lse)[:bhp, :, 0])
    delta = (tdo * t(o)).sum(-1)
    plain = (tfa.flash_dq_plain(tq, tk, tv, tdo, tlse, delta, scale),
             *tfa.flash_dkv_plain(tq, tk, tv, tdo, tlse, delta, scale))
    refs = {"pallas_interpret": [np.asarray(x) for x in pallas], "xla_vjp": xla,
            "plain": [x.numpy() for x in plain]}
    return (tq, tk, tv, tdo, tlse, delta, scale), refs


def _backward_errors(case, terms):
    """{reference: [(max |emulation − reference|, gate) for dQ, dK, dV]}."""
    args, refs = _backward_case(*case)
    out = [x.numpy() for x in backward_tf32(*args, terms)]
    return {name: [(np.abs(o - r).max(), GATE * max(1.0, np.abs(r).max()))
                   for o, r in zip(out, ref)] for name, ref in refs.items()}


@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tf32x3_backward_keeps_the_gate_at_1024_tokens(d, terms):
    """K4 and K5 at the U-Nets' head dims over 1024 tokens (one head): with
    three TF32 products per f32 product dQ, dK and dV stay within a tenth of
    the gate of the Pallas backward in interpret mode, of jax.vjp of the
    JAX package's f32 attention and of the plain versions (measured 2.4e-7
    to 7.0e-7 at D = 40–160, max |plain| under 1, so the gate is 2.5e-5);
    with one TF32 product each lies above the gate (measured 1.5e-4 to
    4.9e-4), so the card's gate tells the two apart at every head dim the
    backward's rows kernels serve."""
    for name, errs in _backward_errors((1, 1024, 1024, 1, d), terms).items():
        for err, gate in errs:
            if terms == 3:
                assert err <= gate / 10, (name, err, gate)
            else:
                assert err > gate, (name, err, gate)


# (primal B·H, Sq, Sk, probes, D): ragged Sq ≠ Sk both ways, and the
# cotangent folded over three probes (B·H 3·bh_primal) against one primal
@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("case", [(1, 384, 640, 1, 40), (1, 640, 384, 1, 160),
                                  (2, 256, 512, 3, 64), (1, 512, 256, 3, 80)])
def test_tf32x3_backward_keeps_the_gate_ragged_and_folded(case, terms):
    """As test_tf32x3_backward_keeps_the_gate_at_1024_tokens with Sq ≠ Sk
    and with probes folded into the cotangent's B·H: three TF32 products
    within a tenth of the gate of every reference (measured 2.4e-7 to
    1.1e-6), one above it (measured 2.4e-4 to 7.6e-4)."""
    for name, errs in _backward_errors(case, terms).items():
        for err, gate in errs:
            if terms == 3:
                assert err <= gate / 10, (name, err, gate)
            else:
                assert err > gate, (name, err, gate)


def tangent_tf32(q, k, v, dq, dk, dv, o, lse, scale, terms):
    """Ȯ of K3 with the operands of Q·Kᵀ, Q̇·Kᵀ, Q·K̇ᵀ, (P∘Ṡ)·V and P·V̇
    in TF32 (matmul_tf32; P∘Ṡ and P split like the inputs: in f32 the
    kernel does not round them), P = exp(S·scale − L), Ṡ = (Q̇Kᵀ + QK̇ᵀ)·
    scale, Ȯ = (P∘Ṡ)·V + P·V̇ − rowsum(P∘Ṡ)∘O. The tangents may carry r
    times the primal's B·H, slice b reading primal slice b % B·H, as the
    kernel indexes them."""
    r = dq.shape[0] // q.shape[0]
    q, k, v, o, lse = (x.repeat(r, *(1,) * (x.ndim - 1)) for x in (q, k, v, o, lse))
    kt = k.transpose(-1, -2)
    p = torch.exp(matmul_tf32(q, kt, terms) * scale - lse[..., None])
    pds = p * (matmul_tf32(dq, kt, terms) + matmul_tf32(q, dk.transpose(-1, -2), terms)) * scale
    return (matmul_tf32(pds, v, terms) + matmul_tf32(p, dv, terms)
            - pds.sum(-1, keepdim=True) * o)


@functools.lru_cache(maxsize=None)
def _tangent_case(bhp, sq, sk, r, d):
    """Inputs from a numpy seed and the references of one tangent case: q
    (bhp, sq, d), k/v (bhp, sk, d), tangents of r·bhp slices; O and L from
    the Pallas forward (K2) in interpret mode; the references Ȯ of
    `_flash_tangent` in interpret mode (blocks of 512, 256 or 128 rows, over
    the primal tiled r times), of `jax.jvp` of the JAX package's f32
    attention and of the port's plain version."""
    rng = np.random.default_rng(3 * d + sq + 5 * sk + r)
    q, k, v = (rng.normal(size=(bhp, n, d)).astype(np.float32) for n in (sq, sk, sk))
    dq, dk, dv = (rng.normal(size=(r * bhp, n, d)).astype(np.float32) for n in (sq, sk, sk))
    scale = d ** -0.5
    block = lambda n: next(b for b in (512, 256, 128) if n % b == 0)
    blocks = dict(block_q=block(sq), block_k=block(sk), interpret=True)
    tile = lambda x: jnp.asarray(np.tile(x, (r, 1, 1)))
    o, lse = jfa._flash_forward_lse(*map(tile, (q, k, v)), scale, **blocks)
    pallas = jfa._flash_tangent(*map(tile, (q, k, v)), *map(jnp.asarray, (dq, dk, dv)), o, lse,
                                scale, **blocks)
    to_bshd = lambda x: jnp.asarray(x)[:, :, None]
    _, xla = jax.jvp(lambda a, b, c: jfa._xla_reference(a, b, c, scale),
                     tuple(to_bshd(np.tile(x, (r, 1, 1))) for x in (q, k, v)),
                     tuple(to_bshd(x) for x in (dq, dk, dv)))
    t = lambda x: torch.from_numpy(np.array(x, np.float32))
    args = (*map(t, (q, k, v, dq, dk, dv)), t(np.asarray(o)[:bhp]),
            t(np.asarray(lse)[:bhp, :, 0]), scale)
    refs = {"pallas_interpret": np.asarray(pallas), "xla_jvp": np.asarray(xla)[:, :, 0],
            "plain": tfa.flash_tangent_plain(*args).numpy()}
    return args, refs


def _tangent_errors(case, terms):
    """{reference: (max |emulation − reference|, gate)} of Ȯ."""
    args, refs = _tangent_case(*case)
    out = tangent_tf32(*args, terms).numpy()
    return {name: (np.abs(out - ref).max(), GATE * max(1.0, np.abs(ref).max()))
            for name, ref in refs.items()}


# (primal B·H, Sq, Sk, probes, D): one head over 1024 tokens at every head
# dim the tangent's rows kernel serves; ragged Sq ≠ Sk both ways, and the
# tangents folded over three probes (B·H 3·bh_primal) against one primal
@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("case", [(1, 1024, 1024, 1, d) for d in HEAD_DIMS] + [
    (1, 384, 640, 1, 40), (1, 640, 384, 1, 160), (2, 256, 512, 3, 64), (1, 512, 256, 3, 80)])
def test_tf32x3_tangent_keeps_the_gate(case, terms):
    """K3 (ops/csrc/flash_jvp_tf32_rows.cu): with three TF32 products per
    f32 product Ȯ stays within a fifth of the gate (2.5e-5 of max(1, max
    |reference|), as K4's dQ: a sum over every key) of the Pallas tangent
    in interpret mode, of jax.jvp of the JAX package's f32 attention and of
    the plain version (measured 5.5e-7 to 2.7e-6, max |Ȯ| 0.56 to 1.01); with
    one TF32 product it lies above the gate (measured 3.4e-4 to 7.5e-4), so
    the card's gate tells the two apart at every head dim and batching the
    kernel serves. A fifth, not the tenth of K4's and K5's test: the three
    f32 references differ among themselves by up to 1.3e-6 (the order of
    their f32 sums, and Ȯ = acc − rowsum(P∘Ṡ)∘O cancels), half of a tenth
    of the gate."""
    for name, (err, gate) in _tangent_errors(case, terms).items():
        if terms == 3:
            assert err <= gate / 5, (name, err, gate)
        else:
            assert err > gate, (name, err, gate)
