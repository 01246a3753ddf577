"""The post-edit regularizers in the port's SD driver against the JAX
package's on the CPU, f32, weights carried by load_flax_params
(torch_port_common.sd_driver_pair, tiny SD at 8² latents): the edit with
dynamic thresholding, preserve_contrast and preserve_norm all on. The JAX
driver computes the basis and the PNGs, the port edits from a copy of the
basis file; every PNG within one uint8 level of the JAX one
(torch_port_common.same_pngs), and the frames the port hands its finish
carry the walk start's norm. The uncond driver's, SEGA and the CLI:
tests/test_torch_port_regularizer_cli.py."""

import numpy as np
from torch_port_common import (  # noqa: F401
    REGULARIZERS,
    copy_bases,
    norms_kept,
    one_torch_thread,
    same_pngs,
    sd_driver_pair,
    sd_same_start,
    spy_regularize,
)


def test_sd_regularized_edit_matches_jax(tmp_path, monkeypatch):
    cfg = dict(dataset_name="noise", for_steps=6, inv_steps=6, edit_t=0.6,
               edit_prompt="a test prompt", pca_rank=2, pullback_min_iter=1,
               pullback_max_iter=1, pullback_atol=0.0, x_space_guidance_num_step=3,
               vis_num=2, vis_num_pc=1, **REGULARIZERS)
    jdrv, tdrv = sd_driver_pair(tmp_path, cfg, size=8)
    zT = np.random.default_rng(70).normal(size=(1, 8, 8, 4)).astype(np.float32)
    sd_same_start(monkeypatch, jdrv, tdrv, zT, rank=2)
    jnames = jdrv.run_edit_local_encoder_pullback_zt(idx=0)
    copy_bases(jdrv, tdrv)
    seen = spy_regularize(monkeypatch, tdrv)
    tnames = tdrv.run_edit_local_encoder_pullback_zt(idx=0)
    assert tnames == jnames and len(tnames) == 2
    same_pngs(jdrv, tdrv, tnames, 16, frames=2)
    norms_kept(seen)
