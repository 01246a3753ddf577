"""``remat_transformer`` (SDXL's) on the port's U-Net on the CPU, f32, weights
carried by load_flax_params from a JAX param tree of sdxl_tiny_unet:

  - with remat the ε, the tapped h's jvp and its vjp equal the U-Net's
    without it (1e-6 of max(1, max |ref|); the recomputed block runs the
    same operations) and the JAX package's remat'd U-Net (1e-5, the port's
    model gate), as tests/test_sd_models.py holds JAX's remat;
  - the remat Function's own forward-mode rule (reached when an input that
    requires grad is jvp'd), also under vmap over the tangents;
  - the remat'd pullback on the fused pair's plain versions (the tiny SDXL
    U-Net at 64² latents: 4 self-attentions at 1024 tokens before the mid
    tap), with ``remat=True`` as build_sdxl sets it: the same basis as
    without remat (1e-6), and the kernel calls chip_smoke.py expects per
    layer — K1 once per cotangent pass (the Function's forward under
    no_grad), K2 once per tangent pass and once per recomputed backward,
    K3 once per tangent pass, K4 and K5 once per cotangent pass at the
    folded B·H."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vjp, vmap
from torch_port_common import flax_params, one_torch_thread, plain_shapes  # noqa: F401

from diffusion_pullback_tpu.models import configs as jcfg
from diffusion_pullback_tpu.models.unet2d import TapPoint as JTap
from diffusion_pullback_tpu.models.unet2d_condition import UNet2DCondition as JUNet
from diffusion_pullback_tpu_torch.geometry import local_pullback
from diffusion_pullback_tpu_torch.models import (
    TapPoint,
    UNet2DCondition,
    load_flax_params,
    sdxl_tiny_unet,
)
from diffusion_pullback_tpu_torch.models.layers import attn_impl_as
from diffusion_pullback_tpu_torch.models.transformer2d import (
    BasicTransformerBlock,
    Transformer2D,
    _RematBlock,
)

T = np.float32(437.0)


def close(out, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _inputs(size, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(1, size, size, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 8, 16)).astype(np.float32)
    pooled = rng.normal(size=(1, 8)).astype(np.float32)
    ids = np.asarray([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]], np.float32)
    return z, ctx, pooled, ids


@pytest.fixture(scope="module")
def unets():
    """(JAX remat'd module, params, port U-Net, port remat'd U-Net, inputs)."""
    z, ctx, pooled, ids = _inputs(8, 61)
    jm = JUNet(dataclasses.replace(jcfg.sdxl_tiny_unet(8), remat_transformer=True))
    params = flax_params(jm, jnp.asarray(z), jnp.float32(0.0), jnp.asarray(ctx),
                         added_cond=(jnp.asarray(pooled), jnp.asarray(ids)))
    build = lambda remat: load_flax_params(UNet2DCondition(dataclasses.replace(
        sdxl_tiny_unet(8), remat_transformer=remat)), params).requires_grad_(False)
    return jm, params, build(False), build(True), (z, ctx, pooled, ids)


def test_remat_config_reaches_every_transformer(unets):
    _, _, plain, remat, _ = unets
    layers = [m for m in remat.modules() if isinstance(m, Transformer2D)]
    assert layers and all(m.remat for m in layers)
    assert not any(m.remat for m in plain.modules() if isinstance(m, Transformer2D))


def test_remat_eps_jvp_vjp_match_plain_and_jax(unets):
    jm, params, plain, remat, (z, ctx, pooled, ids) = unets
    tap = TapPoint("mid", 0)
    added = (torch.from_numpy(pooled), torch.from_numpy(ids))
    jadded = (jnp.asarray(pooled), jnp.asarray(ids))

    def tenc(m):
        return lambda zz: m.encode(zz.permute(0, 3, 1, 2), torch.tensor(T),
                                   torch.from_numpy(ctx), tap, added).permute(0, 2, 3, 1)

    jenc = lambda zz: jm.apply(params, zz, T, jnp.asarray(ctx), JTap("mid", 0),
                               added_cond=jadded, method=JUNet.encode)
    rng = np.random.default_rng(62)
    dz = rng.normal(size=z.shape).astype(np.float32)
    h_ref, dh_ref = jax.jit(lambda a, b: jax.jvp(jenc, (a,), (b,)))(
        jnp.asarray(z), jnp.asarray(dz))
    u = rng.normal(size=h_ref.shape).astype(np.float32)
    (g_ref,) = jax.jit(lambda a, b: jax.vjp(jenc, a)[1](b))(jnp.asarray(z), jnp.asarray(u))
    eps_ref = jax.jit(lambda a: jm.apply(params, a, T, jnp.asarray(ctx), added_cond=jadded))(
        jnp.asarray(z))

    out = {}
    for name, m in (("plain", plain), ("remat", remat)):
        zt = torch.from_numpy(z)
        with torch.no_grad():
            eps = m(zt.permute(0, 3, 1, 2), torch.tensor(T), torch.from_numpy(ctx), added)
        _, dh = jvp(tenc(m), (zt,), (torch.from_numpy(dz),))
        h, vjp_fn = vjp(tenc(m), zt)
        out[name] = (eps.permute(0, 2, 3, 1), h, dh, vjp_fn(torch.from_numpy(u))[0])
    for a, b in zip(out["remat"], out["plain"]):
        close(a.numpy(), b.numpy(), 1e-6)
    for a, b in zip(out["remat"], (eps_ref, h_ref, dh_ref, g_ref)):
        close(a.numpy(), b, 1e-5)
    assert np.abs(np.asarray(g_ref)).max() > 1e-3


def test_remat_function_forward_mode_rule():
    """The Function's jvp (a jvp of an input that requires grad), and under
    vmap over the tangents, against the block's own."""
    torch.manual_seed(63)
    block = BasicTransformerBlock(16, 2, 8, 12).requires_grad_(False)
    x, ctx = torch.randn(2, 10, 16), torch.randn(2, 5, 12)
    dx, dctx = torch.randn(3, *x.shape), torch.randn(3, *ctx.shape)
    f_remat = lambda a, c: _RematBlock.apply(block, "xla", a, c)
    want = vmap(lambda t, tc: jvp(block, (x, ctx), (t, tc))[1])(dx, dctx)
    got = vmap(lambda t, tc: jvp(f_remat, (x, ctx), (t, tc))[1])(dx, dctx)
    close(got.numpy(), want.numpy(), 1e-6)
    xr = x.clone().requires_grad_()
    _, one = jvp(f_remat, (xr, ctx), (dx[0], torch.zeros_like(ctx)))
    _, ref = jvp(block, (x, ctx), (dx[0], torch.zeros_like(ctx)))
    close(one.detach().numpy(), ref.numpy(), 1e-6)
    # plain autograd reaches the recomputing backward too
    (g,) = torch.autograd.grad(f_remat(xr, ctx).square().sum(), xr)
    (g_ref,) = vjp(lambda a: block(a, ctx).square().sum(), x)[1](torch.tensor(1.0))
    close(g.numpy(), g_ref.numpy(), 1e-6)


def test_remat_pullback_on_the_pair(plain_shapes):
    z, ctx, pooled, ids = _inputs(64, 64)
    jm = JUNet(jcfg.sdxl_tiny_unet(64))
    params = flax_params(jm, jnp.asarray(z), jnp.float32(0.0), jnp.asarray(ctx),
                         added_cond=(jnp.asarray(pooled), jnp.asarray(ids)))
    added = (torch.from_numpy(pooled), torch.from_numpy(ids))
    iters, rank = 2, 2
    res = {}
    for remat in (False, True):
        m = load_flax_params(UNet2DCondition(dataclasses.replace(
            sdxl_tiny_unet(64), remat_transformer=remat)), params).requires_grad_(False)

        def enc(impl, m=m):
            def f(zz):
                with attn_impl_as(m, impl):
                    h = m.encode(zz.permute(0, 3, 1, 2), torch.tensor(T),
                                 torch.from_numpy(ctx), TapPoint("mid", 0), added)
                return h.permute(0, 2, 3, 1)
            return f

        for calls in plain_shapes.values():
            calls.clear()
        res[remat] = local_pullback(
            enc("flash_jvp"), torch.from_numpy(z), torch.Generator().manual_seed(1),
            pca_rank=rank, min_iter=iters, max_iter=iters, atol=0.0,
            fn_vjp=enc("flash"), remat=remat)
        counts = {k: sorted(set(v)) + [len(v)] for k, v in plain_shapes.items()}
        layers, passes = 4, iters + 1
        primal, folded = (2, 2, 1024), (2, 2 * rank, 1024)
        want = {"flash_forward_plain": [primal, layers * iters if remat else 0],
                "flash_forward_lse_plain": [
                    primal, layers * (passes + (iters if remat else 1))],
                "flash_tangent_plain": [folded, layers * passes],
                "flash_dq_plain": [folded, layers * iters],
                "flash_dkv_plain": [folded, layers * iters]}
        got = {k: v if v[-1] else [0] for k, v in counts.items()}
        assert got == {k: v if v[-1] else [0] for k, v in want.items()}, (remat, got)
    for field in ("u", "s", "vT"):
        a, b = (getattr(res[r], field).numpy() for r in (False, True))
        close(b, a, 1e-6)
