"""The whole slice on the CPU: the SD editing driver of the port against the
JAX package's, on the tiny set-up of tests/test_edit_sd_e2e.py (sd_driver)
with attn_impl='flash' and pullback_attn_impl='xla' in both packages and
the JAX weights carried across by load_flax_params.

Gates: zT and zt to atol 1e-4; the basis the JAX driver wrote loads through
the port's BasisCache, and the port's edit from it matches the JAX driver's
decoded images at PSNR ≥ 35 dB (tests/test_golden_config1.py's gate)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image
from torch_port_common import flax_params, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu import experiments as jexp
from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.ops import DiffusionSchedule as JSchedule
from diffusion_pullback_tpu.utils.datasets import NoiseDataset as JNoise
from diffusion_pullback_tpu.utils.logging import JSONLLogger as JLogger
from diffusion_pullback_tpu_torch import experiments as texp
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
from diffusion_pullback_tpu_torch.utils.datasets import NoiseDataset
from diffusion_pullback_tpu_torch.utils.logging import JSONLLogger

CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6,
           edit_prompt="a test prompt", pca_rank=4, pullback_min_iter=2,
           pullback_max_iter=3, x_space_guidance_num_step=3, vis_num=2,
           vis_num_pc=1, pullback_attn_impl="xla")


def _folders(root):
    return dict(result_folder=str(root / "runs"), basis_folder=str(root / "inputs"))


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    ucfg = dict(cross_attention_dim=16, attn_impl="flash")
    vcfg = dict(attn_impl="flash")
    unet = jmodels.UNet2DCondition(dataclasses.replace(jmodels.sd_tiny_unet(8), **ucfg))
    vae = jmodels.AutoencoderKL(dataclasses.replace(jmodels.vae_tiny(16), **vcfg))
    tcfg = dataclasses.replace(jmodels.clip_text_tiny(), hidden_size=16)
    text = jmodels.CLIPTextModel(tcfg)
    up = flax_params(unet, jnp.zeros((1, 8, 8, 4)), jnp.float32(0.0),
                     jnp.zeros((1, tcfg.max_length, 16)), seed=0)
    vp = flax_params(vae, jnp.zeros((1, 16, 16, 3)), seed=1)
    tp = flax_params(text, jnp.zeros((1, tcfg.max_length), jnp.int32), seed=2)
    jdrv = jexp.EditStableDiffusion(
        unet, up, vae, vp, text, tp, JSchedule.scaled_linear(), JNoise(16, n=2),
        jexp.SDExperimentConfig(**CFG, **_folders(root / "jax"),
                                obs_folder=str(root / "jax" / "obs")),
        logger=JLogger(path=None, echo=False))

    load = tmodels.load_flax_params
    tunet = load(tmodels.UNet2DCondition(
        dataclasses.replace(tmodels.sd_tiny_unet(8), **ucfg)), up)
    tvae = load(tmodels.AutoencoderKL(
        dataclasses.replace(tmodels.vae_tiny(16), **vcfg)), vp)
    ttext = load(tmodels.CLIPTextModel(
        dataclasses.replace(tmodels.clip_text_tiny(), hidden_size=16)), tp)

    def port_driver(folders):
        return texp.EditStableDiffusion(
            tunet, tvae, ttext, DiffusionSchedule.scaled_linear(),
            NoiseDataset(16, n=2), texp.SDExperimentConfig(**CFG, **folders),
            logger=JSONLLogger(path=None, echo=False), device="cpu")

    return jdrv, port_driver, root


def test_inversion_and_forward_match(drivers):
    jdrv, port_driver, root = drivers
    tdrv = port_driver(_folders(root / "port_inv"))
    assert tdrv.edit_t_idx == jdrv.edit_t_idx
    np.testing.assert_allclose(tdrv.edit_prompt_emb.numpy(),
                               np.asarray(jdrv.edit_prompt_emb), atol=1e-5)
    jzT = jdrv.run_DDIMinversion(0)
    tzT = tdrv.run_DDIMinversion(0)
    np.testing.assert_allclose(tzT.numpy(), np.asarray(jzT), atol=1e-4)
    jzt = jdrv.DDIMforwardsteps(jzT, 0, jdrv.edit_t_idx)
    tzt = tdrv.DDIMforwardsteps(tzT, 0, tdrv.edit_t_idx)
    np.testing.assert_allclose(tzt.numpy(), np.asarray(jzt), atol=1e-4)


def _psnr(a_path, b_path):
    a, b = (np.asarray(Image.open(p), np.float32) / 255.0 for p in (a_path, b_path))
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def test_edit_from_jax_basis_matches_jax_images(drivers):
    jdrv, port_driver, root = drivers
    jnames = jdrv.run_edit_local_encoder_pullback_zt(idx=0)
    # the port reads the basis the JAX driver cached and edits from it
    folders = _folders(root / "port_edit")
    folders["basis_folder"] = jdrv.cfg.basis_folder
    tdrv = port_driver(folders)
    name = jexp.basis_name("noise", 0, 0.6, "mid", 0, 0, edit_prompt="a test prompt",
                           pca_rank=4)
    for mine, theirs in zip(tdrv.cache.load(name), jdrv.cache.load(name)):
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(theirs))
    tnames = tdrv.run_edit_local_encoder_pullback_zt(idx=0)
    assert tnames == jnames and len(tnames) == 2
    for n in tnames:
        psnr = _psnr(os.path.join(tdrv.cfg.result_folder, n + ".png"),
                     os.path.join(jdrv.cfg.result_folder, n + ".png"))
        assert psnr >= 35.0, (n, psnr)


def test_port_edit_runs_end_to_end_and_caches(drivers):
    """The port computing its own basis: PNGs written, idempotent rerun, and
    the basis it wrote loads in the JAX package's BasisCache."""
    _, port_driver, root = drivers
    tdrv = port_driver(_folders(root / "port_own"))
    names = tdrv.run_edit_local_encoder_pullback_zt(idx=1)
    for n in names:
        assert os.path.exists(os.path.join(tdrv.cfg.result_folder, n + ".png"))
    assert tdrv.run_edit_local_encoder_pullback_zt(idx=1) == names
    name = texp.basis_name("noise", 1, 0.6, "mid", 0, 0, edit_prompt="a test prompt",
                           pca_rank=4)
    u, s, vT = jexp.BasisCache(tdrv.cfg.basis_folder).load(name)
    assert u.shape == (4 * 4 * 16, 4) and s.shape == (4,) and vT.shape == (4, 8 * 8 * 4)
    assert np.all(np.isfinite(vT)) and np.all(s > 0)
