"""The uncond driver's harvests of the port against the JAX package's on the
CPU at f32: the sample harvest behind the Fréchet and Hungarian mean-basis
edits, and the t-grid harvests with fix_xt / fix_t, on ddpm_tiny(16) with
weights carried by load_flax_params (torch_port_common's
ddpm_driver_pair). Both drivers are handed the same x_T per sample and the
same probes (uncond_same_start), and the edit tail is replaced by a
recorder of the directions it is given.

Gates: bases σ rtol 1e-3 and cosine ≥ 0.99 per σ-gap group; edit
directions |cos| ≥ 0.999 with the JAX driver's names; each t-grid image
the JAX DDIM forward's within 1e-5 of its scale; the basis names equal the
JAX driver's (a JAX run over the port's files finds each in its cache)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (  # noqa: F401
    basis_stem,
    ddpm_driver_pair,
    one_torch_thread,
    record_edits,
    same_basis_files,
    same_directions,
    uncond_same_start,
)

from diffusion_pullback_tpu.experiments import edit_uncond as jedit_uncond
from diffusion_pullback_tpu_torch.geometry import compare_bases, passes_acceptance

RANK = 2
CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6, pca_rank=RANK,
           pullback_min_iter=3, pullback_max_iter=3, pullback_atol=0.0, vis_num=2,
           vis_num_pc=2, use_performance_boosting=False)
GRID = (1.0, 0.5, 0.25)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return ddpm_driver_pair(tmp_path_factory.mktemp("uncond_harvest"), CFG)


@pytest.fixture
def fresh(pair, monkeypatch):
    """The pair with empty basis folders, x_T and probes injected."""
    jdrv, tdrv = pair
    for drv in (jdrv, tdrv):
        for f in os.listdir(drv.cache.root):
            os.unlink(os.path.join(drv.cache.root, f))
    return jdrv, tdrv, uncond_same_start(monkeypatch, jdrv, tdrv, RANK)


def test_harvest_bases_match_jax(fresh):
    jdrv, tdrv, _ = fresh
    mine = tdrv._harvest_bases([0, 2], "mid", 0, RANK)
    theirs = jdrv._harvest_bases([0, 2], "mid", 0, RANK)
    assert sorted(mine) == sorted(theirs) == [0, 2]
    assert sorted(map(basis_stem, os.listdir(tdrv.cache.root))) == \
        sorted(map(basis_stem, os.listdir(jdrv.cache.root)))
    for idx in (0, 2):
        assert all(a.dtype == torch.float32 for a in mine[idx])
        cmp = compare_bases(mine[idx][2].numpy(), mine[idx][1].numpy(),
                            np.asarray(theirs[idx][2]), np.asarray(theirs[idx][1]))
        assert passes_acceptance(cmp, cos_min=0.99, sigma_rtol=1e-3), cmp
    # a second harvest reads the cache
    again = tdrv._harvest_bases([0, 2], "mid", 0, RANK)
    assert all(torch.equal(a, b) for i in (0, 2) for a, b in zip(again[i], mine[i]))


@pytest.mark.parametrize("run,tag", [("run_edit_global_frechet_mean_xt", "global_frechet"),
                                     ("run_edit_global_hungarian_mean_xt",
                                      "global_hungarian")])
def test_mean_basis_edits_match_jax(fresh, monkeypatch, run, tag):
    """The mean of three samples' bases (columns normalised first), mapped
    to x at a fourth sample through Jᵀ."""
    jdrv, tdrv, _ = fresh
    got = record_edits(monkeypatch, jdrv, tdrv)
    kw = dict(basis_indices=[0, 1, 3], pca_rank=RANK, vis_num=2, vis_num_pc=RANK)
    getattr(jdrv, run)(2, **kw)
    getattr(tdrv, run)(2, **kw)
    same_directions(got)
    assert got["port"][1][0] == f"Edit_{tag}-noise_2-edit_0.6T-mid-block_0-pc_000_pos"


def test_t_grid_harvest_matches_jax(fresh, monkeypatch):
    """The plain grid walks the trajectory in t-index order, the image of
    grid index i the input of forward step i, each basis the JAX fused
    sweep's; with fix_xt and fix_t every basis is taken at the first grid
    point's image and timestep, under both suffixes."""
    jdrv, tdrv, xT = fresh
    seen = []
    real = tdrv.compute_local_basis
    monkeypatch.setattr(tdrv, "compute_local_basis", lambda x, t, tap, r: (
        seen.append((x.clone(), float(t))), real(x, t, tap, r))[1])
    mine = tdrv.run_sample_encoder_local_tangent_space_xt_batched(0, pca_rank=RANK,
                                                                  t_grid=GRID)
    theirs = jdrv.run_sample_encoder_local_tangent_space_xt_batched(0, pca_rank=RANK,
                                                                    t_grid=GRID)
    for et in GRID:
        assert basis_stem(mine[et]) == basis_stem(theirs[et])
        same_basis_files(mine[et], theirs[et])
    fixed = tdrv.run_sample_encoder_local_tangent_space_xt_batched(
        0, pca_rank=RANK, t_grid=GRID, fix_xt=True, fix_t=True)
    assert all(basis_stem(fixed[et]) == basis_stem(mine[et]) + "-fix_xt-fix_t"
               for et in GRID)

    ts = [float(jdrv.fwd_grid.timesteps[tdrv._t_index(et)]) for et in GRID]
    assert [t for _, t in seen] == ts + [ts[0]] * 3
    forward = lambda end: np.asarray(jax.jit(lambda x: jedit_uncond.ddim_forward(
        jdrv._eps_with(jdrv.params), x, jdrv.schedule, jdrv.fwd_grid, end_idx=end))(
            jnp.asarray(xT(0))))
    images = [xT(0)] + [forward(tdrv._t_index(et)) for et in GRID[1:]]
    for (x, _), ref in zip(seen, images + [images[0]] * 3):
        np.testing.assert_allclose(x.numpy(), ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("fix", ["fix_xt", "fix_t"])
def test_t_grid_names_match_jax(fresh, monkeypatch, fix):
    """Each ablation alone names its bases as the JAX driver does."""
    jdrv, tdrv, _ = fresh
    mine = tdrv.run_sample_encoder_local_tangent_space_xt_batched(
        0, pca_rank=RANK, t_grid=GRID[:2], **{fix: True})
    for p in mine.values():
        assert basis_stem(p).endswith(f"-pca_rank_2-{fix}")
        os.replace(p, os.path.join(jdrv.cache.root, os.path.basename(p)))
    monkeypatch.setattr(jdrv, "_jitted", None)   # a cache miss would compile
    theirs = jdrv.run_sample_encoder_local_tangent_space_xt_batched(
        0, pca_rank=RANK, t_grid=GRID[:2], **{fix: True})
    assert {et: basis_stem(p) for et, p in mine.items()} == \
        {et: basis_stem(p) for et, p in theirs.items()}


def test_serial_t_grid_harvest_matches_jax(fresh):
    """Point by point from x_T; a point already in the cache is skipped."""
    jdrv, tdrv, _ = fresh
    mine = tdrv.run_sample_encoder_local_tangent_space_xt(0, pca_rank=RANK, t_grid=GRID[1:])
    theirs = jdrv.run_sample_encoder_local_tangent_space_xt(0, pca_rank=RANK,
                                                            t_grid=GRID[1:])
    assert sorted(mine) == sorted(theirs) == sorted(GRID[1:])
    for et in mine:
        assert basis_stem(mine[et]) == basis_stem(theirs[et])
        same_basis_files(mine[et], theirs[et])
    assert tdrv.run_sample_encoder_local_tangent_space_xt(0, pca_rank=RANK,
                                                          t_grid=GRID[1:2]) == {}
