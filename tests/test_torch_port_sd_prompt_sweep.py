"""The SD and SDXL drivers' prompt sweep of the port against the JAX
package's on the CPU at f32, on weights carried by load_flax_params
(torch_port_common's sd_driver_pair at 8×8 latents, sdxl_driver_pair at
16×16): one inversion and partial forward, one basis per prompt with the
same probes (sd_same_start hands both drivers the same z_T and v_init).
Gates: σ rtol 1e-3 and cosine ≥ 0.99 per σ-gap group; the names equal the
JAX sweep's and the per-prompt edit path's, so the edit loop afterwards
reads every basis from the cache and runs no pullback."""

import numpy as np
import pytest
from torch_port_common import (  # noqa: F401
    basis_stem,
    one_torch_thread,
    same_basis_files,
    sd_driver_pair,
    sd_same_start,
    sdxl_driver_pair,
)

RANK = 2
CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6,
           edit_prompt="a test prompt", pca_rank=RANK, pullback_min_iter=3,
           pullback_max_iter=3, pullback_atol=0.0, vis_num=2, vis_num_pc=1)
PROMPTS = ["a photo of a dog", "a red car on the street"]


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    jdrv, tdrv = sd_driver_pair(tmp_path, CFG, size=8)
    zT = np.random.default_rng(40).normal(size=(1, 8, 8, 4)).astype(np.float32)
    sd_same_start(monkeypatch, jdrv, tdrv, zT, RANK)
    return jdrv, tdrv, zT


def test_prompt_sweep_matches_jax_and_feeds_the_edit_loop(fresh, monkeypatch):
    """One inversion and partial forward, one basis per prompt under the
    per-prompt edit path's name, from the same probes as that path: the
    JAX sweep's bases, and the edit loop afterwards reads them."""
    jdrv, tdrv, zT = fresh
    forwards = []
    real_fwd = tdrv.DDIMforwardsteps
    monkeypatch.setattr(tdrv, "DDIMforwardsteps", lambda *a, **kw: (
        forwards.append(a[1:]), real_fwd(*a, **kw))[1])
    mine = tdrv.run_sample_encoder_local_tangent_space_zt_various_prompt(PROMPTS, idx=0)
    assert forwards == [(0, tdrv.edit_t_idx)]
    theirs = jdrv.run_sample_encoder_local_tangent_space_zt_various_prompt(PROMPTS, idx=0)
    for p in PROMPTS:
        assert basis_stem(mine[p]) == basis_stem(theirs[p])
        same_basis_files(mine[p], theirs[p])

    monkeypatch.setattr(tdrv, "compute_local_basis", None)   # no pullback
    monkeypatch.setattr(tdrv, "_edit_along_directions", lambda zt, vks, names, vis: names)
    hits = []
    monkeypatch.setattr(tdrv.log, "log", lambda ev, **kw: hits.append(kw.get("name"))
                        if ev == "basis_cache_hit" else None)
    for p in PROMPTS:
        tdrv.run_edit_local_encoder_pullback_zt(idx=0, edit_prompt=p)
    assert hits == [basis_stem(mine[p]) for p in PROMPTS]


def test_prompt_sweep_on_sdxl(tmp_path, monkeypatch):
    """The SDXL driver sweeps through its (context, pooled) conditioning:
    the JAX SDXL sweep's bases and names."""
    jdrv, tdrv = sdxl_driver_pair(tmp_path, CFG, size=16)
    zT = np.random.default_rng(42).normal(size=(1, 16, 16, 4)).astype(np.float32)
    sd_same_start(monkeypatch, jdrv, tdrv, zT, RANK)
    mine = tdrv.run_sample_encoder_local_tangent_space_zt_various_prompt(PROMPTS, idx=0)
    theirs = jdrv.run_sample_encoder_local_tangent_space_zt_various_prompt(PROMPTS, idx=0)
    for p in PROMPTS:
        assert basis_stem(mine[p]) == basis_stem(theirs[p])
        same_basis_files(mine[p], theirs[p])
