"""The SD driver's t-grid and single-point harvests of the port against the
JAX package's on the CPU at f32, on weights carried by load_flax_params
(torch_port_common's sd_driver_pair at 8×8 latents). Both drivers are
handed the same z_T and the same probes (sd_same_start), and run a fixed
number of power iterations.

Gates: the latent of each t-grid point equals JAX DDIMforwardsteps(z_T, 0,
t index) within 1e-5 of its scale; the bases σ rtol 1e-3 and cosine ≥
0.99 per σ-gap group (geometry.compare_bases); the basis names equal the
JAX driver's (a JAX run over the port's files finds every one in its
cache)."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_common import (  # noqa: F401
    basis_ext,
    basis_stem,
    one_torch_thread,
    same_basis_files,
    sd_driver_pair,
    sd_same_start,
)

from diffusion_pullback_tpu_torch.experiments import sd_harvest as tsd_harvest

RANK = 2
CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6,
           edit_prompt="a test prompt", pca_rank=RANK, pullback_min_iter=3,
           pullback_max_iter=3, pullback_atol=0.0, vis_num=2, vis_num_pc=1)
T_GRID = (1.0, 0.5, 0.25)


def _names(folder):
    return sorted(os.path.splitext(f)[0] for f in os.listdir(folder))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jdrv, tdrv = sd_driver_pair(tmp_path_factory.mktemp("harvest"), CFG, size=8)
    zT = np.random.default_rng(40).normal(size=(1, 8, 8, 4)).astype(np.float32)
    return jdrv, tdrv, zT


@pytest.fixture
def fresh(pair, monkeypatch):
    """The pair with empty basis folders, z_T and probes injected."""
    jdrv, tdrv, zT = pair
    for drv in (jdrv, tdrv):
        shutil.rmtree(drv.cache.root)
        os.makedirs(drv.cache.root)
    sd_same_start(monkeypatch, jdrv, tdrv, zT, RANK)
    return jdrv, tdrv, zT


def test_t_grid_harvest_matches_jax(fresh, monkeypatch):
    """Three points of the grid: one walk down the trajectory, the latent
    of grid index i the input of forward step i, each basis the JAX fused
    sweep's."""
    jdrv, tdrv, zT = fresh
    seen = []
    real = tdrv.compute_local_basis
    monkeypatch.setattr(tdrv, "compute_local_basis", lambda z, t, tap, r, **kw: (
        seen.append((z.clone(), float(t))), real(z, t, tap, r, **kw))[1])
    mine = tdrv.run_sample_encoder_local_tangent_space_zt_batched(0, pca_rank=RANK,
                                                                  t_grid=T_GRID)
    theirs = jdrv.run_sample_encoder_local_tangent_space_zt_batched(0, pca_rank=RANK,
                                                                    t_grid=T_GRID)
    assert list(mine) == list(T_GRID) and _names(tdrv.cache.root) == _names(jdrv.cache.root)
    for et in T_GRID:
        assert basis_stem(mine[et]) == basis_stem(theirs[et])
        same_basis_files(mine[et], theirs[et])
    # walked in t-index order: 1.0 (z_T), then 0.5, then 0.25
    order = sorted(T_GRID, key=tdrv._t_index)
    assert [t for _, t in seen] == [float(jdrv.fwd_grid.timesteps[tdrv._t_index(et)])
                                    for et in order]
    for (z, _), et in zip(seen, order):
        ti = tdrv._t_index(et)
        ref = np.asarray(jdrv.DDIMforwardsteps(jnp.asarray(zT), 0, ti)) if ti else zT
        np.testing.assert_allclose(z.numpy(), ref, atol=1e-5 * np.abs(ref).max())
    # a second call reads the cache and computes nothing
    monkeypatch.setattr(tdrv, "compute_local_basis", None)
    assert tdrv.run_sample_encoder_local_tangent_space_zt_batched(
        0, pca_rank=RANK, t_grid=T_GRID) == mine


@pytest.mark.parametrize("variant", [dict(op="down", after_res=True),
                                     dict(after_sa=True, op="down"), dict(cfg=2.5)])
def test_t_grid_names_match_jax(fresh, monkeypatch, variant):
    """The after_res / after_sa taps and CFG inside the JVP name their
    bases as the JAX driver does: a JAX run over the port's files finds
    each in its cache and computes nothing."""
    jdrv, tdrv, _ = fresh
    variant = dict(variant)
    scale = variant.pop("cfg", 0.0)
    for drv in (jdrv, tdrv):
        monkeypatch.setattr(drv.cfg, "pullback_guidance_scale", scale)
    mine = tdrv.run_sample_encoder_local_tangent_space_zt_batched(
        0, pca_rank=RANK, t_grid=T_GRID[:2], **variant)
    suffix = "-cfg2.5" if scale else f"-after_{'res' if 'after_res' in variant else 'attn'}0"
    assert all(os.path.basename(p).endswith(suffix + basis_ext()) for p in mine.values())
    for p in mine.values():
        shutil.copy(p, jdrv.cache.root)
    monkeypatch.setattr(jdrv, "_jitted", None)   # a cache miss would compile
    theirs = jdrv.run_sample_encoder_local_tangent_space_zt_batched(
        0, pca_rank=RANK, t_grid=T_GRID[:2], **variant)
    assert {et: basis_stem(p) for et, p in mine.items()} == \
        {et: basis_stem(p) for et, p in theirs.items()}


def test_single_point_harvest_matches_jax(fresh):
    jdrv, tdrv, _ = fresh
    mine = tdrv.run_sample_encoder_local_tangent_space_zt(0, pca_rank=RANK, h_t=0.5,
                                                          edit_prompt="a test prompt")
    theirs = jdrv.run_sample_encoder_local_tangent_space_zt(0, pca_rank=RANK, h_t=0.5,
                                                            edit_prompt="a test prompt")
    assert basis_stem(mine) == basis_stem(theirs)
    same_basis_files(mine, theirs)


def test_a_mesh_is_refused(pair, tmp_path):
    """No longer refused: the driver takes a mesh (one rank here), whose 'dp'
    axis of size 1 splits no sweep."""
    import dataclasses

    from torch_port_dist import mesh, one_rank

    _, tdrv, _ = pair
    with one_rank(tmp_path):
        drv = type(tdrv)(tdrv.unet, tdrv.vae, tdrv.text_model, tdrv.schedule,
                         tdrv.dataset, dataclasses.replace(tdrv.cfg, mesh=mesh(("dp",))),
                         tokenizer=tdrv.tokenizer, logger=tdrv.log, device="cpu")
        assert drv._harvest_dp(4, "skip") == 0
    assert tsd_harvest.SDHarvestMixin in type(tdrv).__mro__
