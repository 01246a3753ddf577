"""The rest of the port's geometry/pullback.py against the JAX package on the
CPU, f32: the Gram SVD (``svd_method='gram'``) against the QR one and JAX's,
its guard on a rank-deficient Gram; ``batched_local_pullback`` against B
per-sample ``local_pullback`` runs and against JAX's on the same v_init
(fixed iterations), with ``chunk_size``, ``fn_vjp`` and ``remat``; the
batched pullback through the fused pair's plain versions on the tiny SD
U-Net (primal B·H = B·heads, K3–K5 at probes·B·heads) against per-sample
math-path pullbacks; and ``remat`` on ``local_pullback``.

Gates: σ rtol 1e-3 and |cos| ≥ 0.99 per direction where two solvers or
two attention paths meet (the repo's pullback gates); 2e-5 (JAX's own
batched-vs-per-sample gate) where the same iteration runs batched and per
sample; 1e-6 where remat, chunking or fn_vjp change only what is held in
memory."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import flax_params, one_torch_thread, plain_shapes  # noqa: F401

from diffusion_pullback_tpu.geometry import batched_local_pullback as jbatched
from diffusion_pullback_tpu.geometry import local_pullback as jlocal
from diffusion_pullback_tpu.models import configs as jcfg
from diffusion_pullback_tpu.models.unet2d_condition import UNet2DCondition as JUNet
from diffusion_pullback_tpu_torch.geometry import batched_local_pullback, local_pullback
from diffusion_pullback_tpu_torch.geometry.pullback import _short_fat_svd
from diffusion_pullback_tpu_torch.models import (
    TapPoint,
    UNet2DCondition,
    load_flax_params,
    sd_tiny_unet,
)
from diffusion_pullback_tpu_torch.models.layers import attn_impl_as

RNG = np.random.default_rng(11)
W1 = RNG.normal(size=(24, 32)).astype(np.float32) / 5
W2 = RNG.normal(size=(32, 16)).astype(np.float32) / 5
XS = RNG.normal(size=(3, 24)).astype(np.float32)


def tmlp(x):   # rows independent: the Jacobian is block-diagonal over B
    return torch.tanh(torch.tanh(x @ torch.from_numpy(W1)) @ torch.from_numpy(W2))


def jmlp(x):
    return jnp.tanh(jnp.tanh(x @ W1) @ W2)


def probes(n, dim, rank, seed):
    rng = np.random.default_rng(seed)
    return np.stack([np.linalg.qr(rng.normal(size=(dim, rank)))[0].T
                     for _ in range(n)]).astype(np.float32)


def same_subspace(s_a, vT_a, s_b, vT_b, rtol=1e-3, cos_min=0.99):
    np.testing.assert_allclose(np.asarray(s_a), np.asarray(s_b), rtol=rtol)
    cos = np.abs(np.sum(np.asarray(vT_a) * np.asarray(vT_b), axis=-1))
    assert cos.min() >= cos_min, cos


def test_gram_matches_qr_and_jax():
    """A well-separated spectrum: the Gram iteration finds the QR one's σ and
    directions, and JAX's Gram iteration from the same probes."""
    x, v0 = XS[:1], probes(1, 24, 5, 1)[0]
    kw = dict(pca_rank=5, min_iter=30, max_iter=30, atol=0.0)
    qr = local_pullback(tmlp, torch.from_numpy(x), v_init=torch.from_numpy(v0), **kw)
    gram = local_pullback(tmlp, torch.from_numpy(x), v_init=torch.from_numpy(v0),
                          svd_method="gram", **kw)
    ref = jlocal(jmlp, jnp.asarray(x), jax.random.key(0), v_init=jnp.asarray(v0),
                 svd_method="gram", **kw)
    assert gram.iterations == int(ref.iterations) == 30
    same_subspace(gram.s[:3], gram.vT[:3], qr.s[:3], qr.vT[:3])
    same_subspace(gram.s, gram.vT, ref.s, ref.vT)
    sig = np.arange(5, 0, -1, dtype=np.float32)
    for mine, theirs in zip(_short_fat_svd(torch.from_numpy(sig[:, None] * v0),
                                           method="gram"), (sig, v0)):
        np.testing.assert_allclose(mine.abs().numpy(), np.abs(theirs), atol=1e-5)


def test_gram_guard_keeps_a_rank_deficient_gram_finite():
    """Jacobian rank 2, pca_rank 6: the Gram's tail eigenvalues are roundoff,
    the eps division blows their rows up, and the guard re-unitises them
    (JAX's own check, tests/test_pullback.py)."""
    a = torch.from_numpy(RNG.normal(size=(2, 24)).astype(np.float32))
    f = lambda x: (x @ a.T) ** 3 + x @ a.T
    res = local_pullback(f, torch.zeros(1, 24), pca_rank=6, min_iter=10, max_iter=30,
                         svd_method="gram")
    assert torch.isfinite(res.s).all() and torch.isfinite(res.vT).all()
    np.testing.assert_allclose(torch.linalg.norm(res.vT, dim=1).numpy(), 1.0, atol=1e-5)
    s, vT = _short_fat_svd(torch.zeros(3, 10), method="gram")
    assert torch.isfinite(s).all() and torch.isfinite(vT).all()


def test_unknown_svd_method_raises():
    for run in (lambda: local_pullback(tmlp, torch.from_numpy(XS[:1]), pca_rank=2,
                                       max_iter=1, svd_method="lapack"),
                lambda: jlocal(jmlp, jnp.asarray(XS[:1]), jax.random.key(0), pca_rank=2,
                               max_iter=1, svd_method="lapack")):
        with pytest.raises(ValueError, match="unknown svd method: 'lapack'"):
            run()


@pytest.mark.parametrize("svd_method", ["qr", "gram"])
def test_batched_matches_per_sample_and_jax(svd_method):
    r, iters = 5, 8
    v0 = probes(3, 24, r, 3)
    kw = dict(pca_rank=r, min_iter=iters, max_iter=iters, atol=0.0, svd_method=svd_method)
    fused = batched_local_pullback(tmlp, torch.from_numpy(XS), v_init=torch.from_numpy(v0),
                                   **kw)
    assert (fused.u.shape, fused.s.shape, fused.vT.shape) == ((3, 16, r), (3, r),
                                                              (3, r, 24))
    assert fused.iterations == iters
    for b in range(3):
        single = local_pullback(tmlp, torch.from_numpy(XS[b:b + 1]),
                                v_init=torch.from_numpy(v0[b]), **kw)
        np.testing.assert_allclose(fused.vT[b].numpy(), single.vT.numpy(), atol=2e-5)
        np.testing.assert_allclose(fused.s[b].numpy(), single.s.numpy(), rtol=2e-5)
        np.testing.assert_allclose(fused.u[b].numpy(), single.u.numpy(), atol=2e-5)
    ref = jbatched(jmlp, jnp.asarray(XS), jax.random.key(0), v_init=jnp.asarray(v0), **kw)
    assert int(ref.iterations) == iters
    for b in range(3):
        same_subspace(fused.s[b], fused.vT[b], ref.s[b], ref.vT[b])


def test_batched_chunked_vjp_and_remat_variants():
    kw = dict(pca_rank=4, min_iter=6, max_iter=6, atol=0.0)
    gen = lambda: torch.Generator().manual_seed(5)
    xs = torch.from_numpy(XS)
    base = batched_local_pullback(tmlp, xs, gen(), **kw)
    assert base.vT.shape == (3, 4, 24)
    np.testing.assert_allclose(torch.linalg.norm(base.vT, dim=-1).numpy(), 1.0, atol=1e-5)
    for other in (batched_local_pullback(tmlp, xs, gen(), chunk_size=2, **kw),
                  batched_local_pullback(tmlp, xs, gen(), fn_vjp=tmlp, **kw),
                  batched_local_pullback(tmlp, xs, gen(), remat=True, chunk_size=2, **kw)):
        np.testing.assert_allclose(other.vT.numpy(), base.vT.numpy(), atol=1e-6)
        np.testing.assert_allclose(other.s.numpy(), base.s.numpy(), rtol=1e-6)
        np.testing.assert_allclose(other.u.numpy(), base.u.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match=r"v_init shape \(4, 24\) != \(3, 4, 24\)"):
        batched_local_pullback(tmlp, xs, v_init=torch.zeros(4, 24), **kw)
    with pytest.raises(ValueError, match="divisible by chunk_size 3"):
        batched_local_pullback(tmlp, xs, chunk_size=3, **kw)


@pytest.fixture(scope="module")
def sd_unet():
    """The tiny SD U-Net at 32² latents (its first block self-attends over
    1024 tokens, 2 heads, so 'flash' reaches the pair's plain versions),
    f32 weights from a JAX param tree, and a batch of 2 latents."""
    jm = JUNet(dataclasses.replace(jcfg.sd_tiny_unet(32), attn_impl="xla"))
    rng = np.random.default_rng(12)
    z = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 8, 16)).astype(np.float32)
    params = flax_params(jm, jnp.asarray(z[:1]), jnp.float32(0.0), jnp.asarray(ctx))
    tm = load_flax_params(UNet2DCondition(sd_tiny_unet(32)), params).requires_grad_(False)

    def enc(impl):   # NHWC on both sides; the down-0 tap reaches one attention
        def f(zz):
            with attn_impl_as(tm, impl):
                h = tm.encode(zz.permute(0, 3, 1, 2), torch.tensor(321.0),
                              torch.from_numpy(ctx), TapPoint("down", 0))
            return h.permute(0, 2, 3, 1)
        return f
    return enc, torch.from_numpy(z)


def test_batched_pair_reads_primal_slice_b_mod_bh(sd_unet, plain_shapes):
    """The pair at primal B·H = 2 samples × 2 heads = 4, K3–K5 at r·4: each
    probe's slice must pair with its own sample's primal, so the result
    equals the per-sample pullbacks on the math path."""
    enc, z = sd_unet
    r, iters = 2, 3
    v0 = probes(2, 32 * 32 * 4, r, 13)
    kw = dict(pca_rank=r, min_iter=iters, max_iter=iters, atol=0.0)
    fused = batched_local_pullback(enc("flash_jvp"), z, fn_vjp=enc("flash"),
                                   v_init=torch.from_numpy(v0), **kw)
    k3, k4 = plain_shapes["flash_tangent_plain"], plain_shapes["flash_dq_plain"]
    assert set(k3) == {(4, 4 * r, 1024)} and len(k3) == iters + 1
    assert set(k4) == {(4, 4 * r, 1024)} and len(k4) == iters
    assert set(plain_shapes["flash_forward_lse_plain"]) == {(4, 4, 1024)}
    for b in range(2):
        single = local_pullback(enc("xla"), z[b:b + 1], v_init=torch.from_numpy(v0[b]), **kw)
        same_subspace(fused.s[b], fused.vT[b], single.s, single.vT)


@pytest.mark.parametrize("variant", ["plain", "chunked", "pair"])
def test_remat_changes_no_number(sd_unet, variant):
    """remat=True runs a vjp per cotangent pass; the pullback is the same to
    1e-6 (f32), on the math path, chunked, and on the pair."""
    enc, z = sd_unet
    kw = dict(pca_rank=2, min_iter=3, max_iter=3, atol=0.0,
              chunk_size=1 if variant == "chunked" else None)
    fns = ((enc("flash_jvp"), enc("flash")) if variant == "pair"
           else (enc("xla"), None))
    runs = [local_pullback(fns[0], z[:1], torch.Generator().manual_seed(3), fn_vjp=fns[1],
                           remat=remat, **kw) for remat in (False, True)]
    for field in ("u", "s", "vT"):
        a, b = (getattr(res, field).numpy() for res in runs)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * max(1.0, np.abs(a).max()))
