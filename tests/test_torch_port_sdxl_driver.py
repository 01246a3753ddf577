"""The port's SDXL driver against the JAX package's EditStableDiffusionXL on
the CPU, f32, on shared weights (torch_port_common.sdxl_driver_pair at 8²
latents and 16 px images): the prompt conditioning (context, pooled), ε
with and without classifier-free guidance, the encoder-pullback edit from
the JAX driver's basis, run_DDIMforward, and the CLI: its folders and
defaults against the JAX CLI's for the SDXL flags, and build_sdxl needing
a card unless --device cpu. The decoder-pullback edit and DeepCache are in
tests/test_torch_port_sdxl_decoder.py, the encoder pullback from injected
probes in tests/test_torch_port_sdxl_pullback.py.

Gates: embeddings and ε within 1e-5 (a CFG ε within (1 + 2s)·1e-5, the
bound its extrapolation propagates, as in
tests/test_torch_port_sd_cfg_pullback.py); latents along a sampling
trajectory atol 1e-4 of max(1, max |ref|) and decoded images atol 1e-4;
edited images PSNR ≥ 35 dB."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_common import one_torch_thread, sdxl_driver_pair  # noqa: F401

from diffusion_pullback_tpu import experiments as jexp
from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.utils.config import parse_args as jparse_args
from diffusion_pullback_tpu.utils.config import preset as jpreset
from diffusion_pullback_tpu_torch import experiments as texp
from diffusion_pullback_tpu_torch import main as tmain
from diffusion_pullback_tpu_torch import models as tmodels

SDXL = "stabilityai/stable-diffusion-xl-base-1.0"
GUIDANCE = 7.5
CFG = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6,
           edit_prompt="a test prompt", neg_prompt="ugly", for_prompt="a photo",
           pca_rank=2, pullback_min_iter=2, pullback_max_iter=3,
           x_space_guidance_num_step=3, vis_num=2, vis_num_pc=1,
           pullback_attn_impl="xla")


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    return sdxl_driver_pair(tmp_path_factory.mktemp("xl"), CFG, size=8)


def test_prompt_embeddings_match_jax(drivers):
    jdrv, tdrv = drivers
    for what in ("edit", "for", "neg", "null", "inv"):
        (jctx, jpooled) = getattr(jdrv, f"{what}_prompt_emb")
        ctx, pooled = getattr(tdrv, f"{what}_prompt_emb")
        assert ctx.shape == (1, 8, 16) and pooled.shape == (1, 8)
        np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=1e-5)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=1e-5)
    ctx2, _ = tdrv._get_emb("another prompt entirely")
    assert not np.allclose(ctx2.numpy(), tdrv.edit_prompt_emb[0].numpy())
    np.testing.assert_array_equal(tdrv._time_ids.numpy(), np.asarray(jdrv._time_ids))


@pytest.mark.parametrize("scale", [0.0, GUIDANCE], ids=["plain", "cfg"])
def test_eps_with_matches_jax(drivers, monkeypatch, scale):
    """ε at a batch of 2 for the for-prompt, with the negative prompt's rows
    fused in under CFG."""
    jdrv, tdrv = drivers
    for drv in (jdrv, tdrv):
        monkeypatch.setattr(drv.cfg, "guidance_scale", scale)
    z = np.random.default_rng(61).normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.float32(437.0)
    ref = jax.jit(jdrv.eps_with(jdrv.unet_params, jdrv.for_prompt_emb,
                                jdrv.neg_prompt_emb))(jnp.asarray(z), t)
    with torch.no_grad():
        out = tdrv.eps_with(tdrv.for_prompt_emb, tdrv.neg_prompt_emb)(
            torch.from_numpy(z), torch.tensor(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=(1 + 2 * scale) * 1e-5)


def _psnr(a_path, b_path):
    a, b = (np.asarray(Image.open(p), np.float32) / 255.0 for p in (a_path, b_path))
    return 10.0 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


def test_edit_matches_jax_images(drivers, monkeypatch):
    """The whole encoder-pullback edit: inversion and forward to the edit t
    within 1e-4 of max(1, max |ref|) of the JAX driver's (the tiny random
    U-Net amplifies an input difference 40–80× over these few steps, so the
    ε roundoff of ~1.5e-6 reaches 1.2e-5 at zT and 2.4e-4 at z_t, where
    |z_t| reaches 7), then the port edits from the basis the JAX driver
    cached (the basis itself is held to the JAX one from the same probes in
    tests/test_torch_port_sdxl_pullback.py) and its PNGs match the JAX
    driver's at PSNR ≥ 35 dB."""
    jdrv, tdrv = drivers
    close = lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), atol=1e-4 * max(1.0, float(np.abs(b).max())))
    jzT, tzT = jdrv.run_DDIMinversion(0), tdrv.run_DDIMinversion(0)
    close(tzT, jzT)
    close(tdrv.DDIMforwardsteps(tzT, 0, tdrv.edit_t_idx),
          jdrv.DDIMforwardsteps(jzT, 0, jdrv.edit_t_idx))
    jnames = jdrv.run_edit_local_encoder_pullback_zt(idx=0)
    monkeypatch.setattr(tdrv, "cache", texp.BasisCache(jdrv.cfg.basis_folder))
    tnames = tdrv.run_edit_local_encoder_pullback_zt(idx=0)
    assert tnames == jnames and len(tnames) == 2
    for n in tnames:
        psnr = _psnr(os.path.join(tdrv.cfg.result_folder, n + ".png"),
                     os.path.join(jdrv.cfg.result_folder, n + ".png"))
        assert psnr >= 35.0, (n, psnr)


def test_run_ddim_forward_matches_jax(drivers, tmp_path):
    jdrv, tdrv = drivers
    imgs = tdrv.run_DDIMforward(num_samples=2, save_as=str(tmp_path / "f.png"),
                                generator=torch.Generator().manual_seed(5))
    zT = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(5)).numpy()
    ref = jdrv.decode_latents(jdrv.DDIMforwardsteps(jnp.asarray(zT), 0))
    assert imgs.shape == (2, 16, 16, 3) and os.path.exists(tmp_path / "f.png")
    np.testing.assert_allclose(imgs, np.asarray(ref), atol=1e-4)


class _Shape:
    """A JAX model that only has a config: its init gives no parameters."""

    def __init__(self, config=None):
        self.config = config

    def init(self, *args, **kwargs):
        return {}


def _capture(*args, **kwargs):
    """A driver's (config, dataset, log path, its models), in place of it."""
    i = next(i for i, a in enumerate(args) if hasattr(a, "basis_folder"))
    return args[i], args[i - 1], kwargs["logger"].path, args[:i - 2]


def _stub_models(monkeypatch):
    """Both CLIs' builders run: the JAX models are shapes without parameters
    and the port's are tiny, so no 2.6 B-parameter U-Net is built."""
    for name in ("UNet2DCondition", "AutoencoderKL", "CLIPTextModel"):
        monkeypatch.setattr(jmodels, name, _Shape)
    tower = lambda: dataclasses.replace(tmodels.clip_text_tiny(), hidden_size=8)
    monkeypatch.setattr(tmodels, "sdxl_base_unet", lambda **over: dataclasses.replace(
        tmodels.sdxl_tiny_unet(2), **over))
    monkeypatch.setattr(tmodels, "sd_vae", lambda **over: dataclasses.replace(
        tmodels.vae_tiny(16), **over))
    monkeypatch.setattr(tmodels, "sdxl_text_encoder_1", tower)
    monkeypatch.setattr(tmodels, "sdxl_text_encoder_2", tower)
    for mod in (jexp, texp):
        monkeypatch.setattr(mod, "EditStableDiffusionXL", _capture)


@pytest.mark.parametrize("flags", [
    [], ["--pca_rank", "8", "--dataset_name", "noise", "--use_x_space_guidance", "True",
         "--h_t", "0.6"],
    ["--pca_rank", "4", "--pullback_chunk_size", "2", "--dataset_name", "CelebA_HQ"]],
    ids=["default", "rank8-noise-h_t", "rank4-chunk2"])
def test_cli_folders_and_defaults_match_jax(tmp_path, monkeypatch, flags):
    import main as jmain

    monkeypatch.chdir(tmp_path)
    _stub_models(monkeypatch)
    argv = ["--note", "n", "--model_name", SDXL, "--result_folder",
            str(tmp_path / "runs"), "--device", "cpu"] + flags
    jargs = jpreset(jparse_args(argv))
    assert jargs.is_sdxl and tmain.is_sdxl(tmain.parse_args(argv))
    jcfg, jdata, jlog, _ = jmain.build_sdxl(jargs)
    tcfg, tdata, tlog, models = tmain.build_sdxl(tmain.parse_args(argv))
    exp_folder, basis_folder = tmain.experiment_folders(tmain.parse_args(argv))
    assert exp_folder == jargs.exp_folder
    assert os.path.basename(exp_folder).startswith("Stable_Diffusion_XL-")
    assert basis_folder == tcfg.basis_folder == jcfg.basis_folder
    assert tcfg.result_folder == jcfg.result_folder == jargs.result_folder
    assert tlog == jlog
    for f in ("dataset_name", "x_space_guidance_scale", "x_space_guidance_num_step",
              "pca_rank", "for_steps", "edit_t", "pullback_chunk_size", "decode_chunk",
              "seed", "pullback_guidance_scale"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert type(tdata).__name__ == type(jdata).__name__
    assert jargs.image_size == 128 and jcfg.decode_chunk == 1
    unet, vae, text1, text2 = models
    assert vae.config.scaling_factor == 0.13025
    assert not hasattr(text1, "text_projection") and hasattr(text2, "text_projection")
    assert next(unet.parameters()).dtype == torch.float32   # fp32 on the CPU


def test_build_sdxl_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _stub_models(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--note", "n", "--model_name", SDXL]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.build_sdxl(tmain.parse_args(argv))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(argv)
    monkeypatch.setattr(texp, "EditStableDiffusionXL", texp.edit_sdxl.EditStableDiffusionXL)
    edit = tmain.build_sdxl(tmain.parse_args(argv + ["--device", "cpu"]))
    assert edit.device.type == "cpu" and edit.cfg.pullback_attn_impl == "xla"
    assert edit.unet.config.attn_impl == "xla"
