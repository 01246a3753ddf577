"""The port's PCA, mean-basis and basis-comparison modules against the JAX
package's on the CPU at f32, on seeded numpy inputs: compare_bases field by
field; global_pca components up to sign |cos| ≥ 0.9999 and variances rtol
1e-5; local_pca given the exact δ and Ω the JAX one draws (its
jax.random.fold_in draws, injected) components |cos| ≥ 0.9999, variances
rtol 1e-4, mean within 1e-5, with and without unit_delta; local_pca on its
own draws exact on a linear map of rank ≤ rank + oversample (both passes
must see the same samples); pca_to_x_direction within 1e-5; the Fréchet
mean's span (principal-angle cosines ≥ 0.9999) and the Hungarian mean
within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401

from diffusion_pullback_tpu.geometry import mean as jmean
from diffusion_pullback_tpu.geometry import metrics as jmetrics
from diffusion_pullback_tpu.geometry import pca as jpca
from diffusion_pullback_tpu_torch import geometry
from diffusion_pullback_tpu_torch.geometry import pca as tpca

X_SHAPE = (1, 4, 4, 2)          # dim_x 32
DIM_H = 24


def _maps(seed=0):
    """fn(x) = tanh(x·W) with a decaying spectrum (well-separated PCA
    directions), in both packages on the same W."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.normal(size=(32, 32)))[0]
    v = np.linalg.qr(rng.normal(size=(DIM_H, DIM_H)))[0]
    w = (u[:, :DIM_H] * (2.0 * 0.7 ** np.arange(DIM_H))) @ v
    w = w.astype(np.float32)
    jfn = lambda x: jnp.tanh(x.reshape(1, -1) @ jnp.asarray(w))
    tfn = lambda x: torch.tanh(x.reshape(1, -1) @ torch.from_numpy(w))
    return jfn, tfn


def _rows_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(np.sum(a * b, axis=1) / np.linalg.norm(a, axis=1)
                  / np.linalg.norm(b, axis=1))


def test_compare_bases_matches_jax():
    rng = np.random.default_rng(1)
    vT_b = np.linalg.qr(rng.normal(size=(20, 5)))[0].T
    vT_a = vT_b + 0.05 * rng.normal(size=vT_b.shape)
    vT_a[[1, 2]] = vT_a[[2, 1]]                 # a swap inside a σ cluster
    s_b = np.array([5.0, 3.0, 2.95, 1.0, 0.5])
    s_a = s_b * (1 + 0.01 * rng.normal(size=5))
    mine = geometry.compare_bases(vT_a, s_a, vT_b, s_b)
    theirs = jmetrics.compare_bases(vT_a, s_a, vT_b, s_b)
    for field in ("per_direction_cos", "subspace_cos", "sigma_rel_err"):
        np.testing.assert_allclose(getattr(mine, field), getattr(theirs, field),
                                   rtol=1e-12, atol=1e-12)
    assert [list(g) for g in mine.gap_groups] == [list(g) for g in theirs.gap_groups] \
        == [[0], [1, 2], [3], [4]]
    for cos_min, rtol in ((0.9, 0.05), (0.999, 0.05), (0.9, 0.001)):
        assert geometry.passes_acceptance(mine, cos_min, rtol) == \
            jmetrics.passes_acceptance(theirs, cos_min, rtol)


def test_global_pca_matches_jax():
    hs = np.random.default_rng(2).normal(size=(8, 4, 4, 6)).astype(np.float32)
    hs[:, 0] *= 4.0                             # a leading direction
    mine = geometry.global_pca(torch.from_numpy(hs), rank=5)
    theirs = jpca.global_pca(jnp.asarray(hs), rank=5)
    assert mine.components.shape == (5, 96)
    assert _rows_cos(mine.components, theirs.components).min() >= 0.9999
    np.testing.assert_allclose(mine.variances, theirs.variances, rtol=1e-5)
    np.testing.assert_allclose(mine.mean, theirs.mean, atol=1e-6)
    assert geometry.global_pca(torch.from_numpy(hs[:3]), rank=5).components.shape[0] == 3


@pytest.mark.parametrize("unit_delta", [False, True])
def test_local_pca_matches_jax_on_its_draws(unit_delta):
    """The same samples through both sketches: the port is handed the JAX
    function's own fold_in draws of δ and Ω for every chunk."""
    jfn, tfn = _maps()
    rank, oversample, num, chunk = 4, 8, 64, 16
    x = np.random.default_rng(3).normal(size=X_SHAPE).astype(np.float32)
    key = jax.random.key(7)
    theirs = jax.jit(lambda xx: jpca.local_pca(
        jfn, xx, key, rank=rank, num_samples=num, chunk=chunk, sigma=0.3,
        oversample=oversample, unit_delta=unit_delta))(jnp.asarray(x))

    def draw(i):
        delta = jax.random.normal(jax.random.fold_in(key, i), (chunk,) + X_SHAPE[1:],
                                  jnp.float32)
        omega = jax.random.normal(jax.random.fold_in(jax.random.fold_in(key, 0x0FF5E7), i),
                                  (chunk, rank + oversample), jnp.float32)
        return torch.from_numpy(np.array(delta)), torch.from_numpy(np.array(omega))

    mine = geometry.local_pca(tfn, torch.from_numpy(x), rank=rank, num_samples=num,
                              chunk=chunk, sigma=0.3, oversample=oversample,
                              unit_delta=unit_delta, draw=draw)
    assert mine.components.shape == (rank, DIM_H)
    assert _rows_cos(mine.components, theirs.components).min() >= 0.9999
    np.testing.assert_allclose(mine.variances, theirs.variances, rtol=1e-4)
    np.testing.assert_allclose(mine.mean, theirs.mean, atol=1e-5)


def test_local_pca_on_its_own_draws_is_exact_on_a_linear_map():
    """f(x) = x·A with rank(A) = 6 ≤ rank + oversample: the sketch holds the
    samples' whole span, so the components and variances equal the sample
    covariance's eigenpairs, which need the samples of pass 2 to be those
    of pass 1 (each chunk's draws regenerated from its own seed)."""
    rng = np.random.default_rng(4)
    a = (rng.normal(size=(32, 6)) * [3.0, 2.0, 1.5, 1.0, 0.6, 0.3]) @ rng.normal(size=(6, DIM_H))
    a = torch.from_numpy(a.astype(np.float32))
    fn = lambda x: x.reshape(1, -1) @ a
    x = torch.from_numpy(rng.normal(size=X_SHAPE).astype(np.float32))
    rank, num, chunk, sigma, seed = 4, 96, 32, 0.5, 11
    res = geometry.local_pca(fn, x, seed, rank=rank, num_samples=num, chunk=chunk,
                             sigma=sigma, oversample=4)
    deltas = torch.cat([torch.randn((chunk,) + X_SHAPE[1:],
                                    generator=tpca._chunk_generator(seed, i, 0))
                        for i in range(num // chunk)])
    hs = ((x + sigma * deltas).reshape(num, -1) @ a).double()
    mean = hs.mean(0)
    w, v = torch.linalg.eigh((hs - mean).T @ (hs - mean) / num)
    np.testing.assert_allclose(res.mean, mean, atol=1e-5)
    np.testing.assert_allclose(res.variances, w.flip(0)[:rank], rtol=1e-4)
    assert _rows_cos(res.components, v.flip(1)[:, :rank].T).min() >= 0.9999


def test_pca_to_x_direction_matches_jax():
    jfn, tfn = _maps(5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=X_SHAPE).astype(np.float32)
    comp = rng.normal(size=DIM_H).astype(np.float32)
    theirs = jpca.pca_to_x_direction(jfn, jnp.asarray(x), jnp.asarray(comp))
    mine = geometry.pca_to_x_direction(tfn, torch.from_numpy(x), torch.from_numpy(comp))
    assert mine.shape == X_SHAPE
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-5)


def _bases(seed, n=3, dim=40, r=5):
    rng = np.random.default_rng(seed)
    base = np.linalg.qr(rng.normal(size=(dim, r)))[0]
    return [np.linalg.qr(base + 0.2 * rng.normal(size=(dim, r)))[0].astype(np.float32)
            for _ in range(n)]


def test_frechet_mean_matches_jax():
    bases = _bases(7)
    mine = geometry.frechet_mean_basis([torch.from_numpy(b) for b in bases], rank=3)
    theirs = np.asarray(jmean.frechet_mean_basis([jnp.asarray(b) for b in bases], rank=3))
    assert mine.shape == (40, 3)
    cos = np.linalg.svd(mine.numpy().T.astype(np.float64) @ theirs, compute_uv=False)
    assert cos.min() >= 0.9999, cos


def test_hungarian_mean_matches_jax():
    bases = _bases(8)
    bases[1] = -bases[1][:, [2, 0, 1, 4, 3]]   # permuted, sign-flipped columns
    mine = geometry.hungarian_mean_basis([torch.from_numpy(b) for b in bases], rank=4)
    theirs = jmean.hungarian_mean_basis([jnp.asarray(b) for b in bases], rank=4)
    assert mine.shape == (40, 4) and mine.dtype == torch.float32
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-6)
