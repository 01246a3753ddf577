"""The uncond driver's PCA edits of the port against the JAX package's on
the CPU at f32: global PCA on ddpm_tiny(16), local PCA on a 16 px UNetADM
that samples with 'flash' in the port (so the Jᵀ of each component runs
the pair's cotangent encoder), weights carried by load_flax_params. Both drivers are handed the same x_T and probes
(uncond_same_start), the same random draws (the JAX run's own: global
PCA's population, local PCA's per-chunk δ and Ω), and an edit tail
replaced by a recorder of the directions it is given. Gate: the
directions |cos| ≥ 0.999, with the JAX driver's names."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_port_common import (  # noqa: F401
    adm_driver_pair,
    ddpm_driver_pair,
    inject_jax_draws,
    one_torch_thread,
    record_edits,
    same_directions,
    uncond_same_start,
)

from diffusion_pullback_tpu_torch.experiments import edit_uncond as tedit_uncond

CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6, pca_rank=2,
           pullback_min_iter=3, pullback_max_iter=3, pullback_atol=0.0, vis_num=2,
           vis_num_pc=2, use_performance_boosting=False)
ADM_16 = dict(image_size=16, model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(2,), num_head_channels=64, norm_num_groups=8)


def test_global_pca_edit_matches_jax(tmp_path, monkeypatch):
    """16 images drawn as the JAX driver draws them (key(seed)), forwarded
    to the edit t as one batch, tapped and PCA'd; called by the reference
    name with a prompt, which an uncond model ignores."""
    jdrv, tdrv = ddpm_driver_pair(tmp_path, CFG)
    uncond_same_start(monkeypatch, jdrv, tdrv, rank=2)
    got = record_edits(monkeypatch, jdrv, tdrv)
    xT = np.array(jax.random.normal(jax.random.key(0), (16, 16, 16, 3), jnp.float32))
    monkeypatch.setattr(tdrv, "_draw_latents", lambda n, generator=None: torch.from_numpy(xT))
    kw = dict(num_samples=16, pca_rank=2, vis_num=2, vis_num_pc=2, edit_prompt="ignored")
    jdrv.run_edit_global_pca_zt(1, **kw)
    tdrv.run_edit_global_pca_zt(1, **kw)
    same_directions(got)
    assert got["port"][1][0] == "Edit_global_pca-noise_1-edit_0.6T-mid-block_0-pc_000_pos"


def test_local_pca_edit_matches_jax_on_adm(tmp_path, monkeypatch):
    jdrv, tdrv = adm_driver_pair(tmp_path, CFG, net=ADM_16)
    uncond_same_start(monkeypatch, jdrv, tdrv, rank=2)
    got = record_edits(monkeypatch, jdrv, tdrv)
    inject_jax_draws(monkeypatch, tedit_uncond, rank=3)
    kw = dict(pca_rank=3, num_samples=64, sigma=0.1, vis_num=2, vis_num_pc=2)
    jdrv.run_edit_local_pca_zt(0, **kw)
    tdrv.run_edit_local_pca_zt(0, **kw)
    same_directions(got)
    assert got["port"][1][0] == "Edit_local_pca-noise_0-edit_0.6T-mid-block_0-pc_000_pos"
