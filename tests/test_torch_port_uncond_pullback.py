"""The uncond pullback in the port against the JAX package on the CPU in
float32: local_pullback of UNet2D.encode at the mid tap from the same
v_init, with and without probe chunking, and the config-1 smoke pipeline
(chip_smoke.config1_smoke, the port's counterpart of
scripts/make_goldens.py::compute_config1_smoke_artifacts) held to the
stored goldens through tests/test_golden_config1.py's gates."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_golden_config1 import GOLDEN_DIR, _assert_golden_match, _sigma_groups
from test_golden_config1 import principal_cosines
from torch_port_common import one_torch_thread  # noqa: F401

from chip_smoke import config1_smoke
from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.geometry import local_pullback as jpullback
from diffusion_pullback_tpu.geometry.pullback import _orthonormal_probes
from diffusion_pullback_tpu.ops import ddim_timestep_grid as jgrid
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.geometry import local_pullback
from scripts.make_goldens import synth_params

RANK, T = 4, 571.0


@pytest.fixture(scope="module")
def setup():
    jm = jmodels.UNet2D(jmodels.ddpm_tiny(32))
    x = jax.random.normal(jax.random.key(1), (1, 32, 32, 3), jnp.float32)
    params = synth_params(lambda: jm.init(jax.random.key(0), x, jnp.float32(T)))
    tm = tmodels.load_flax_params(tmodels.UNet2D(tmodels.ddpm_tiny(32)), params)
    v0 = _orthonormal_probes(jax.random.key(2), x.size, RANK)
    tap = jmodels.TapPoint("mid", 0)
    ref = jax.jit(lambda p, z: jpullback(
        lambda zz: jm.apply(p, zz, T, tap, method=jmodels.UNet2D.encode), z,
        jax.random.key(2), pca_rank=RANK, min_iter=3, max_iter=3, atol=0.0,
        v_init=v0))(params, x)
    enc = lambda z: tm.encode(z.permute(0, 3, 1, 2), T, tmodels.TapPoint("mid", 0)
                              ).permute(0, 2, 3, 1)
    return enc, torch.tensor(np.asarray(x)), torch.tensor(np.asarray(v0)), ref


@pytest.mark.parametrize("chunk", [1, 2, None])
def test_mid_tap_pullback_matches_jax(setup, chunk):
    enc, x, v0, ref = setup
    res = local_pullback(enc, x, pca_rank=RANK, min_iter=3, max_iter=3, atol=0.0,
                         v_init=v0, chunk_size=chunk)
    ref_s, ref_vT = np.asarray(ref.s), np.asarray(ref.vT)
    assert res.iterations == int(ref.iterations) == 3
    np.testing.assert_allclose(res.s.detach().numpy(), ref_s, rtol=1e-3)
    for g in _sigma_groups(ref_s):
        assert principal_cosines(res.vT.detach().numpy()[g], ref_vT[g]).min() > 0.99, g
    np.testing.assert_allclose(np.linalg.norm(res.u.detach().numpy(), axis=0),
                               np.linalg.norm(np.asarray(ref.u), axis=0), rtol=1e-3)


def test_chunk_size_must_divide_the_rank(setup):
    enc, x, _, _ = setup
    with pytest.raises(ValueError, match="divisible"):
        local_pullback(enc, x, pca_rank=RANK, chunk_size=3)


def test_config1_smoke_golden_through_the_port():
    """The JAX golden's weights (synth_params), x0 (key 1) and probes
    (_orthonormal_probes at key 2), moved into the port."""
    jm = jmodels.UNet2D(jmodels.ddpm_tiny(32))
    x0 = jax.random.normal(jax.random.key(1), (1, 32, 32, 3), jnp.float32)
    params = synth_params(lambda: jm.init(jax.random.key(0), x0, jgrid(8).timesteps[2]))
    tm = tmodels.load_flax_params(tmodels.UNet2D(tmodels.ddpm_tiny(32)), params)
    v0 = _orthonormal_probes(jax.random.key(2), x0.size, 4)
    art = config1_smoke(tm.requires_grad_(False), torch.tensor(np.asarray(x0)), torch.tensor(np.asarray(v0)))
    _assert_golden_match(art, os.path.join(GOLDEN_DIR, "config1_smoke_basis.npz"),
                         os.path.join(GOLDEN_DIR, "config1_smoke_edit.npy"))
