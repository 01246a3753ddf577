"""The uncond editing driver of the port against the JAX package's on the
CPU in float32: ddpm_tiny(32) on the bundled CelebA-HQ images, 8-step
grids, weights moved by load_flax_params. The JAX driver computes the basis
and writes it (as .dpb where the native library is built); the port's basis
folder is seeded with the same file, so both edit from one basis, and the
edited PNGs agree within one uint8 level. With boosting on, the finish is
compared at the ddim_forward level on the JAX draws of the η = 1 noise."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_common import flax_params, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu import experiments as jexp
from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.ops import DiffusionSchedule as JSchedule
from diffusion_pullback_tpu.samplers import ddim_loop as jloop
from diffusion_pullback_tpu.utils.datasets import get_dataset as jget_dataset
from diffusion_pullback_tpu.utils.logging import JSONLLogger as JLogger
from diffusion_pullback_tpu_torch import experiments as texp
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
from diffusion_pullback_tpu_torch.samplers import ddim_loop as tloop
from diffusion_pullback_tpu_torch.utils.datasets import get_dataset
from diffusion_pullback_tpu_torch.utils.logging import JSONLLogger

CFG = dict(dataset_name="CelebA_HQ", for_steps=8, inv_steps=8, edit_t=0.6,
           pca_rank=2, pullback_min_iter=2, pullback_max_iter=3,
           x_space_guidance_num_step=3, x_space_guidance_scale=0.5, vis_num=2,
           vis_num_pc=1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("uncond")
    jm = jmodels.UNet2D(jmodels.ddpm_tiny(32))
    params = flax_params(jm, jnp.zeros((1, 32, 32, 3)), jnp.float32(0.0), seed=6)
    tm = tmodels.load_flax_params(tmodels.UNet2D(tmodels.ddpm_tiny(32)), params)

    def jax_driver(**over):
        cfg = {**CFG, "use_performance_boosting": False, **over}
        return jexp.EditUncondDiffusion(
            jm, params, JSchedule.linear(), jget_dataset("CelebA_HQ", 32),
            jexp.UncondExperimentConfig(
                **cfg, result_folder=str(root / "jax" / "runs"),
                obs_folder=str(root / "jax" / "obs"),
                basis_folder=str(root / "jax" / "inputs")),
            logger=JLogger(path=None, echo=False))

    def port_driver(name, **over):
        cfg = {**CFG, "use_performance_boosting": False, **over}
        return texp.EditUncondDiffusion(
            tm, DiffusionSchedule.linear(), get_dataset("CelebA_HQ", 32),
            texp.UncondExperimentConfig(
                **cfg, result_folder=str(root / name / "runs"),
                basis_folder=str(root / name / "inputs")),
            logger=JSONLLogger(path=None, echo=False), device="cpu")

    return jax_driver, port_driver


def test_edit_pngs_match_jax_within_one_level(setup):
    jax_driver, port_driver = setup
    jdrv = jax_driver()
    jnames = jdrv.run_edit_local_encoder_pullback_xt(idx=1)
    basis = [f for f in os.listdir(jdrv.cfg.basis_folder)]
    assert len(basis) == 1
    tdrv = port_driver("port")
    shutil.copy(os.path.join(jdrv.cfg.basis_folder, basis[0]), tdrv.cfg.basis_folder)
    assert (tdrv.edit_t_idx, tdrv.boost_start_idx) == (jdrv.edit_t_idx,
                                                        jdrv.boost_start_idx)
    tnames = tdrv.run_edit_local_encoder_pullback_zt(idx=1, edit_prompt="ignored")
    assert tnames == jnames and len(tnames) == 2
    for n in tnames:
        a, b = (np.asarray(Image.open(os.path.join(d.cfg.result_folder, n + ".png")),
                           np.int16) for d in (tdrv, jdrv))
        assert a.shape == b.shape == (32, 2 * 32, 3)
        assert np.abs(a - b).max() <= 1, n
    # idempotent: every PNG exists, nothing runs
    assert tdrv.run_edit_local_encoder_pullback_xt(idx=1) == tnames


def test_boosted_finish_matches_jax_on_injected_noise(setup):
    """performance_boosting_t 0.3 on the 8-step grid: η = 1 on the last two
    steps of the finish (0.2 would put the boost index on the last step,
    where boosting is off)."""
    jax_driver, port_driver = setup
    jdrv = jax_driver(use_performance_boosting=True, performance_boosting_t=0.3)
    tdrv = port_driver("port_boost", use_performance_boosting=True,
                       performance_boosting_t=0.3)
    assert tdrv.boost_start_idx == jdrv.boost_start_idx == 5
    start = jdrv.edit_t_idx
    x = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(11)
    jout = jloop.ddim_forward(jdrv.eps_fn, jnp.asarray(x), jdrv.schedule, jdrv.fwd_grid,
                              start_idx=start, boost_start_idx=5, key=key)
    noise = []
    for _ in range(jdrv.fwd_grid.num_steps - start):
        key, sub = jax.random.split(key)
        noise.append(torch.tensor(np.asarray(jax.random.normal(sub, x.shape))))
    with torch.no_grad():
        tout = tloop.ddim_forward(tdrv.eps_fn, torch.from_numpy(x), tdrv.schedule,
                                  tdrv.fwd_grid, start_idx=start, boost_start_idx=5,
                                  noise=noise)
        det = tloop.ddim_forward(tdrv.eps_fn, torch.from_numpy(x), tdrv.schedule,
                                 tdrv.fwd_grid, start_idx=start)
    jout = np.asarray(jout)
    np.testing.assert_allclose(tout.numpy(), jout, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(jout).max()))
    assert np.abs(det.numpy() - jout).max() > 1e-2  # the noise reached the output
