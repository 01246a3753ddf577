"""The probe-sharded pullback and the dp sweep of the port
(parallel/sharded_pullback.py, local_pullback's probe_group) against the
JAX package's on the 8-device CPU mesh of tests/conftest.py.

One launch of 4 gloo ranks (tests/torch_port_dist.py) computes every port
result: ddpm_tiny(16)'s mid-tap pullback with its 8 probes over a 4-rank
'probe' axis from the same injected probes as the JAX sharded pullback
(σ rtol 1e-4, vT atol 1e-4), with and without fn_vjp; the dp sweep of
four MLP pullbacks (JAX dp_vmap) over a 4-rank 'dp' axis; the same on a
2×2 dp×probe mesh; and the errors (pca_rank not divisible, chunk_size with
probe sharding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_common import flax_params, one_torch_thread  # noqa: F401
from torch_port_dist import launch, pullback_body

from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.geometry import local_pullback as jpullback
from diffusion_pullback_tpu.geometry.pullback import _orthonormal_probes
from diffusion_pullback_tpu.parallel import make_mesh as jmesh
from diffusion_pullback_tpu.parallel import make_sharded_pullback as jmake
from diffusion_pullback_tpu.parallel import sharded_local_pullback as jsharded
from diffusion_pullback_tpu.parallel.sharded_pullback import dp_vmap as jdp_vmap
from diffusion_pullback_tpu_torch import models as tmodels

T = 400.0


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jm = jmodels.UNet2D(jmodels.ddpm_tiny(16))
    x = np.random.default_rng(0).normal(size=(1, 16, 16, 3)).astype(np.float32)
    params = flax_params(jm, jnp.asarray(x), jnp.float32(T))
    state = {k: v.numpy() for k, v in tmodels.load_flax_params(
        tmodels.UNet2D(tmodels.ddpm_tiny(16)), params).state_dict().items()}
    rng = np.random.default_rng(1)
    data = dict(
        unet=state, t=T, x=x, v0=np.asarray(_orthonormal_probes(jax.random.key(2), x.size, 8)),
        w1=(rng.normal(size=(24, 32)) / 5).astype(np.float32),
        w2=(rng.normal(size=(32, 16)) / 5).astype(np.float32),
        xs=rng.normal(size=(4, 24)).astype(np.float32),
        vs=np.stack([np.asarray(_orthonormal_probes(jax.random.key(10 + i), 24, 4))
                     for i in range(4)]))
    enc = lambda z: jm.apply(params, z, jnp.float32(T), jmodels.TapPoint("mid", 0),
                             method=jmodels.UNet2D.encode)
    ranks = launch(pullback_body, 4, tmp_path_factory.mktemp("pullback"), data)
    return ranks, data, enc


def _same(res, ref, s_rtol=1e-4, v_atol=1e-4):
    np.testing.assert_allclose(res.s, np.asarray(ref.s), rtol=s_rtol)
    np.testing.assert_allclose(res.vT, np.asarray(ref.vT), atol=v_atol)
    np.testing.assert_allclose(res.u, np.asarray(ref.u), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["probe", "probe_vjp"])
def test_probe_sharded_pullback_matches_jax(setup, name):
    ranks, data, enc = setup
    kw = dict(pca_rank=8, min_iter=3, max_iter=3, atol=0.0,
              v_init=jnp.asarray(data["v0"]))
    mesh = jmesh(("probe",), shape={"probe": 4})
    x = jnp.asarray(data["x"])
    if name == "probe":
        ref = jsharded(enc, x, jax.random.key(0), mesh, **kw)
    else:
        ref = jmake(lambda z, s: enc(z) * s, mesh, fn_vjp=lambda z, s: enc(z) * s,
                    **kw)(x, jax.random.key(0), 1.0)
    for res in ranks:  # whole on every rank, vT included
        assert res[name].iterations == int(ref.iterations) == 3
        _same(res[name], ref)


def test_dp_sweep_matches_jax_dp_vmap(setup):
    ranks, data, _ = setup
    w1, w2 = jnp.asarray(data["w1"]), jnp.asarray(data["w2"])
    f = lambda z: jnp.tanh(jnp.tanh(z @ w1) @ w2)
    pull = lambda xi, vi: jpullback(f, xi[None], jax.random.key(0), pca_rank=4,
                                    min_iter=3, max_iter=5, atol=0.0, v_init=vi)
    ref = jdp_vmap(pull, jmesh(("dp",), shape={"dp": 4}))(
        jnp.asarray(data["xs"]), jnp.asarray(data["vs"]))
    for res in ranks:
        for name in ("dp", "dp_probe"):
            np.testing.assert_allclose(res[name].s, np.asarray(ref.s), rtol=1e-4)
            np.testing.assert_allclose(res[name].vT, np.asarray(ref.vT), atol=1e-4)
            assert list(res[name].iterations) == [5] * 4


def test_errors(setup):
    errors = setup[0][0]["errors"]
    assert "pca_rank 6 not divisible by probe axis size 4" in errors["rank"]
    assert "mutually exclusive" in errors["chunk"]
