"""The SD driver's PCA runs of the port against the JAX package's on the CPU
at f32, on weights carried by load_flax_params (torch_port_common's
sd_driver_pair at 8×8 latents), both drivers handed the same z_t, the
same random draws (the JAX run's own: local PCA's per-chunk fold_in draws
of δ and Ω through local_pca's ``draw``, global PCA's population of z_T)
and an edit tail replaced by a recorder of the directions it is given.

Gates: the latent directions of the local- and global-PCA edits |cos| ≥
0.999 (torch_port_common.same_directions), with the JAX driver's names; text PCA's cached h-space components
and text-space rows |cos| ≥ 0.999, its singular values rtol 1e-3, under
the JAX driver's name; a dual-tower (SDXL) embedding refuses text PCA."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (  # noqa: F401
    basis_stem,
    inject_jax_draws,
    one_torch_thread,
    record_edits,
    same_directions,
    sd_driver_pair,
)

from diffusion_pullback_tpu_torch.experiments import sd_pca as tsd_pca
from diffusion_pullback_tpu_torch.experiments.cache import BasisCache

CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6,
           edit_prompt="a test prompt", pca_rank=2, pullback_min_iter=2,
           pullback_max_iter=2, pullback_atol=0.0, vis_num=2, vis_num_pc=2)


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """(JAX driver, port driver, z_t) with both drivers' inversion and
    partial forward replaced by the same z_t."""
    jdrv, tdrv = sd_driver_pair(tmp_path_factory.mktemp("pca"), CFG, size=8)
    zt = np.random.default_rng(51).normal(size=(1, 8, 8, 4)).astype(np.float32)
    jdrv.run_DDIMinversion = lambda idx: jnp.asarray(zt)
    jdrv.DDIMforwardsteps = lambda z, start, end=None: z
    tdrv._zt = lambda idx: torch.from_numpy(zt)
    return jdrv, tdrv, zt


@pytest.fixture
def recorded(drivers, monkeypatch):
    jdrv, tdrv, _ = drivers
    return record_edits(monkeypatch, jdrv, tdrv)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.dot(a, b) / np.linalg.norm(a) / np.linalg.norm(b))


def test_local_pca_edit_matches_jax(drivers, recorded, monkeypatch):
    jdrv, tdrv, _ = drivers
    inject_jax_draws(monkeypatch, tsd_pca, rank=4)
    kw = dict(pca_rank=4, num_samples=32, sigma=0.1, vis_num=2, vis_num_pc=2)
    jdrv.run_edit_local_pca_zt(0, **kw)
    tdrv.run_edit_local_pca_zt(0, **kw)
    same_directions(recorded)
    assert recorded["port"][1][0].startswith("Edit_local_pca-noise_0-edit_0.6T-mid-block_0-pc_000_pos")


def test_text_pca_matches_jax(drivers, monkeypatch):
    jdrv, tdrv, _ = drivers
    inject_jax_draws(monkeypatch, tsd_pca, rank=3)
    theirs = jdrv.run_local_pca_text(0, pca_rank=3, num_samples=32)
    mine = tdrv.run_local_pca_text(0, pca_rank=3, num_samples=32)
    assert basis_stem(mine) == basis_stem(theirs)
    (ju, js, jv), (tu, ts, tv) = (BasisCache(os.path.dirname(p)).load(basis_stem(p))
                                  for p in (theirs, mine))
    assert tu.shape == ju.shape and tv.shape == jv.shape == (3, 8 * 16)
    np.testing.assert_allclose(ts, js, rtol=1e-3)
    for a, b in ((tu.T, ju.T), (tv, jv)):
        assert min(abs(_cos(x, y)) for x, y in zip(a, b)) >= 0.999


def test_global_pca_edit_matches_jax(drivers, recorded, monkeypatch):
    """16 latents drawn as the JAX driver draws them (key(seed)), forwarded
    to the edit t, tapped under the edit prompt and PCA'd."""
    jdrv, tdrv, _ = drivers
    zT = np.array(jax.random.normal(jax.random.key(0), (16, 8, 8, 4), jnp.float32))
    monkeypatch.setattr(tdrv, "_draw_latents", lambda n, generator=None: torch.from_numpy(zT))
    jdrv.run_edit_global_pca_zt(0, num_samples=16, pca_rank=2, vis_num=2, vis_num_pc=2)
    tdrv.run_edit_global_pca_zt(0, num_samples=16, pca_rank=2, vis_num=2, vis_num_pc=2)
    same_directions(recorded)


def test_text_pca_refuses_a_dual_tower_embedding(drivers, monkeypatch):
    _, tdrv, _ = drivers
    monkeypatch.setattr(tdrv, "edit_prompt_emb", (tdrv.edit_prompt_emb,) * 2)
    with pytest.raises(NotImplementedError, match="single-tower"):
        tdrv.run_local_pca_text(0, pca_rank=2, num_samples=16)
