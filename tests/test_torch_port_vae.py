"""Port VAE against the JAX package at vae_tiny(64), f32, with weights
carried by load_flax_params. The 1024-token mid-block attention takes the
flash route in both packages (interpret-mode Pallas in JAX, the plain
version in the port). Tolerance: atol 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from torch_port_common import flax_params, nchw, nhwc, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu.models import configs as jcfg
from diffusion_pullback_tpu.models.vae import AutoencoderKL as JVAE
from diffusion_pullback_tpu_torch.models import (
    AutoencoderKL,
    load_flax_params,
    vae_tiny,
)

def test_vae_encode_decode_match():
    cfg = dataclasses.replace(jcfg.vae_tiny(64), attn_impl="flash")
    jm = JVAE(cfg)
    rng = np.random.default_rng(5)
    x = np.tanh(rng.normal(size=(1, 64, 64, 3))).astype(np.float32)
    z = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    params = flax_params(jm, jnp.asarray(x), seed=1)
    tm = load_flax_params(
        AutoencoderKL(dataclasses.replace(vae_tiny(64), attn_impl="flash")), params)
    ref_e = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, method=JVAE.encode))(
        params, jnp.asarray(x)))
    ref_d = np.asarray(jax.jit(lambda p, z: jm.apply(p, z, method=JVAE.decode))(
        params, jnp.asarray(z)))
    np.testing.assert_allclose(nhwc(tm.encode(nchw(x))), ref_e, atol=1e-5)
    np.testing.assert_allclose(nhwc(tm.decode(nchw(z))), ref_d, atol=1e-5)
