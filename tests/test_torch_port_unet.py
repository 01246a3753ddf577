"""Port U-Net against the JAX package at tiny widths, f32, with weights
carried by load_flax_params. At sd_tiny_unet(32) the first block's
1024-token self-attention takes the flash route in both packages
(interpret-mode Pallas in JAX, the plain version in the port).

Besides atol 1e-5 the comparisons allow rtol 1e-5: float32 roundoff grows
with |value|, and the tapped features here reach |h| ≈ 11, where 1e-5 is
about ten ulps (the JAX package's own SD encoder oracle test allows rtol
1e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import flax_params, nchw, nhwc, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu.models import configs as jcfg
from diffusion_pullback_tpu.models.unet2d import TapPoint as JTap
from diffusion_pullback_tpu.models.unet2d_condition import UNet2DCondition as JUNet
from diffusion_pullback_tpu_torch.models import (
    TapPoint,
    UNet2DCondition,
    load_flax_params,
    sd_tiny_unet,
)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", params=[(8, "xla"), (32, "flash")],
                ids=["s8-xla", "s32-flash"])
def unet_pair(request):
    size, impl = request.param
    jm = JUNet(dataclasses.replace(jcfg.sd_tiny_unet(size), attn_impl=impl))
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 8, 16)).astype(np.float32)
    params = flax_params(jm, jnp.asarray(x), jnp.float32(0.0), jnp.asarray(ctx))
    tm = load_flax_params(
        UNet2DCondition(dataclasses.replace(sd_tiny_unet(size), attn_impl=impl)),
        params)
    return jm, params, tm, x, ctx


def test_unet_eps_matches(unet_pair):
    jm, params, tm, x, ctx = unet_pair
    t = np.float32(437.0)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), t, jnp.asarray(ctx)))
    out = nhwc(tm(nchw(x), torch.tensor(t), torch.from_numpy(ctx)))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("tap", [("down", 0), ("mid", 0), ("up", 0)])
def test_unet_encode_matches(unet_pair, tap):
    jm, params, tm, x, ctx = unet_pair
    t = np.float32(600.5)
    enc = jax.jit(lambda p, x, c: jm.apply(p, x, t, c, JTap(*tap),
                                           method=JUNet.encode))
    ref = np.asarray(enc(params, jnp.asarray(x), jnp.asarray(ctx)))
    out = nhwc(tm.encode(nchw(x), torch.tensor(t), torch.from_numpy(ctx),
                         TapPoint(*tap)))
    np.testing.assert_allclose(out, ref, **TOL)
