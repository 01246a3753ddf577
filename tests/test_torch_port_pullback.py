"""Port local_pullback: against an explicit Jacobian SVD, and against the
JAX package's local_pullback on the tiny SD U-Net encoder with the same
v_init and a fixed number of iterations (σ rtol 1e-3, |cos| ≥ 0.99 per
direction)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_port_common import flax_params, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu.geometry import local_pullback as jlocal_pullback
from diffusion_pullback_tpu.models import configs as jcfg
from diffusion_pullback_tpu.models.unet2d import TapPoint as JTap
from diffusion_pullback_tpu.models.unet2d_condition import UNet2DCondition as JUNet
from diffusion_pullback_tpu_torch.geometry import local_pullback
from diffusion_pullback_tpu_torch.models import (
    TapPoint,
    UNet2DCondition,
    load_flax_params,
    sd_tiny_unet,
)


def test_matches_explicit_jacobian_svd():
    rng = np.random.default_rng(7)
    w1 = torch.from_numpy(rng.normal(size=(24, 32)).astype(np.float32) / 5)
    w2 = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32) / 5)
    f = lambda x: torch.tanh(torch.tanh(x @ w1) @ w2)   # (1, 24) → (1, 16)
    x = torch.from_numpy(rng.normal(size=(1, 24)).astype(np.float32))
    J = torch.func.jacfwd(lambda z: f(z).reshape(-1))(x).reshape(16, 24)
    _, s_true, vT_true = torch.linalg.svd(J, full_matrices=False)

    res = local_pullback(f, x, torch.Generator().manual_seed(0), pca_rank=6,
                         min_iter=10, max_iter=100, atol=1e-6)
    np.testing.assert_allclose(res.s.numpy(), s_true[:6].numpy(), rtol=1e-3)
    for i in range(3):
        assert abs(float(res.vT[i] @ vT_true[i])) > 0.999, i
    np.testing.assert_allclose(res.u.numpy(), (J @ res.vT.T).numpy(), atol=1e-4)
    assert res.u.shape == (16, 6) and res.vT.shape == (6, 24)


def test_matches_jax_pullback_on_unet_encoder():
    jm = JUNet(dataclasses.replace(jcfg.sd_tiny_unet(8), attn_impl="xla"))
    rng = np.random.default_rng(3)
    z = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 8, 16)).astype(np.float32)
    t = np.float32(555.0)
    params = flax_params(jm, jnp.asarray(z), jnp.float32(0.0), jnp.asarray(ctx))
    tm = load_flax_params(UNet2DCondition(sd_tiny_unet(8)), params)
    tm.requires_grad_(False)

    rank, dim_x = 4, z.size
    v_init = np.linalg.qr(rng.normal(size=(dim_x, rank)))[0].T.astype(np.float32)
    kw = dict(pca_rank=rank, min_iter=5, max_iter=5, atol=0.0)

    jenc = lambda zz: jm.apply(params, zz, t, jnp.asarray(ctx), JTap("mid"),
                               method=JUNet.encode)
    ref = jax.jit(lambda zz, v0: jlocal_pullback(
        jenc, zz, jax.random.key(0), v_init=v0, **kw))(jnp.asarray(z),
                                                      jnp.asarray(v_init))

    def tenc(zz):  # NHWC on both sides, as the driver flattens
        h = tm.encode(zz.permute(0, 3, 1, 2), torch.tensor(t),
                      torch.from_numpy(ctx), TapPoint("mid"))
        return h.permute(0, 2, 3, 1)

    res = local_pullback(tenc, torch.from_numpy(z),
                         v_init=torch.from_numpy(v_init), **kw)
    assert res.iterations == int(ref.iterations) == 5
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s), rtol=1e-3)
    cos = np.abs(np.sum(res.vT.numpy() * np.asarray(ref.vT), axis=1))
    assert cos.min() >= 0.99, cos
    ucos = np.abs(np.sum(res.u.numpy() * np.asarray(ref.u), axis=0)) / (
        np.linalg.norm(res.u.numpy(), axis=0) * np.linalg.norm(np.asarray(ref.u), axis=0))
    assert ucos.min() >= 0.99, ucos
