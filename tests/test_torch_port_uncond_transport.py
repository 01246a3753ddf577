"""Parallel transport of the port's uncond driver against the JAX
package's on the CPU at f32: sample 2's directions moved to sample 3 and
walked there, on ddpm_tiny(16) (both drivers compute both samples' bases
from the same x_T and probes, uncond_same_start) and on the 64 px UNetADM
of torch_port_common.ADM_TINY_1024 (the port reads the JAX bases; its
sampling runs K1's plain version at 1024 tokens), shared weights carried
by load_flax_params, η = 0. Gate: the same PNG and basis names, each PNG
within one uint8 level of the JAX one; transport_all itself is held in
tests/test_torch_port_vis.py."""

import os

import pytest
from torch_port_common import (  # noqa: F401
    adm_driver_pair,
    basis_stem,
    copy_bases,
    ddpm_driver_pair,
    one_torch_thread,
    plain_shapes,
    same_pngs,
    uncond_same_start,
)

CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6,
           pullback_min_iter=0, pullback_max_iter=1, pullback_atol=0.0,
           x_space_guidance_num_step=2, x_space_guidance_scale=0.5,
           use_performance_boosting=False)


@pytest.mark.parametrize("kind,size", [("ddpm", 16), ("adm", 64)])
def test_parallel_transport_matches_jax(tmp_path, monkeypatch, plain_shapes, kind, size):
    """Sample 2's directions transported to sample 3 at pca_rank 4."""
    pair = ddpm_driver_pair if kind == "ddpm" else adm_driver_pair
    jdrv, tdrv = pair(tmp_path, CFG)
    uncond_same_start(monkeypatch, jdrv, tdrv, rank=4)
    kw = dict(sample_idx_0=2, sample_idx_1=3, pca_rank=4, vis_num=2, vis_num_pc=2)
    jnames = jdrv.run_edit_parallel_transport(**kw)
    if kind == "adm":
        copy_bases(jdrv, tdrv)
    tnames = tdrv.run_edit_parallel_transport(**kw)
    assert tnames == jnames and len(tnames) == 4
    assert tnames[0] == "Edit_transport-noise_2to3-edit_0.6T-mid-block_0-pc_000_pos"
    stems = lambda d: sorted(basis_stem(f) for f in os.listdir(d.cfg.basis_folder))
    assert stems(tdrv) == stems(jdrv) and len(stems(tdrv)) == 2
    same_pngs(jdrv, tdrv, tnames, size)
    # the ADM net samples on K1's plain version at 1024 tokens: the walk's
    # (null, edit) pairs of 4 directions and the finish of 4 × 3 frames
    k1 = set(plain_shapes["flash_forward_plain"])
    assert k1 == ({(1, 1, 1024), (8, 8, 1024), (12, 12, 1024)} if kind == "adm" else set())
