"""The port CLI's SD flags of this slice on the CPU: their names and
defaults equal the JAX CLI's, each reaches the driver's config, and each
dispatches as the JAX main.py does, run end to end with the SD 2.1-base
presets swapped for tiny ones; the uncond family refuses the text-driven
edit and runs the decoder pullbacks. And the SD driver's run_DDIMforward from a seeded zT against the JAX
driver's DDIMforwardsteps and decode on the same zT (atol 1e-4)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import basis_ext, one_torch_thread, sd_driver_pair  # noqa: F401

from diffusion_pullback_tpu.utils.config import parse_args as jparse_args
from diffusion_pullback_tpu_torch import main as tmain
from diffusion_pullback_tpu_torch import models as tmodels

NEW_FLAGS = {
    "pullback_guidance_scale": "2.5", "edit_deepcache_interval": "2",
    "guidance_deepcache_interval": "2", "text_driven_num_pc": "2",
    "run_edit_local_decoder_pullback_zt": "True",
    "run_edit_local_x0_decoder_pullback_zt": "True",
    "run_edit_text_driven_direction": "True"}
BASE = ["--note", "x", "--device", "cpu", "--for_steps", "4", "--inv_steps", "4",
        "--edit_t", "0.5", "--x_space_guidance_num_step", "2"]


@pytest.fixture
def tiny_sd(monkeypatch, tmp_path):
    """The SD 2.1-base presets swapped for tiny ones (16 px images, 2×2
    latents), run from a fresh directory."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmodels, "sd21_base_unet", lambda **over: dataclasses.replace(
        tmodels.sd_tiny_unet(2), **over))
    monkeypatch.setattr(tmodels, "sd_vae", lambda **over: dataclasses.replace(
        tmodels.vae_tiny(16), **over))
    monkeypatch.setattr(tmodels, "sd21_text_encoder", tmodels.clip_text_tiny)


def test_new_flags_have_the_jax_names_and_defaults():
    mine, theirs = tmain.parse_args(["--note", "x"]), jparse_args(["--note", "x"])
    for flag in NEW_FLAGS:
        assert getattr(mine, flag) == getattr(theirs, flag), flag
    argv = ["--note", "x"] + [a for f, v in NEW_FLAGS.items() for a in (f"--{f}", v)]
    mine, theirs = tmain.parse_args(argv), jparse_args(argv)
    for flag in NEW_FLAGS:
        assert getattr(mine, flag) == getattr(theirs, flag), flag


def test_flags_reach_the_sd_config(monkeypatch, tiny_sd):
    from diffusion_pullback_tpu_torch import experiments

    monkeypatch.setattr(experiments, "EditStableDiffusion", lambda *a, **kw: a[5])
    argv = ["--note", "x", "--device", "cpu"] + [
        a for f in ("pullback_guidance_scale", "edit_deepcache_interval",
                    "guidance_deepcache_interval", "text_driven_num_pc")
        for a in (f"--{f}", NEW_FLAGS[f])]
    cfg = tmain.build_sd(tmain.parse_args(argv))
    assert (cfg.pullback_guidance_scale, cfg.edit_deepcache_interval,
            cfg.guidance_deepcache_interval, cfg.text_driven_num_pc) == (2.5, 2, 2, 2)


def _run(flags):
    edit = tmain.main(BASE + flags)
    with open(edit.log.path) as f:
        events = [json.loads(line) for line in f]
    return edit, events, sorted(os.listdir(edit.cfg.result_folder))


def test_cfg_intra_block_tap_and_deepcache_dispatch(tiny_sd):
    """Config 4 with an intra-block tap, and DeepCache on walk and finish:
    the pullback's encoder is the CFG pair's math path, its basis is named
    apart from plain ones, and the walk and the finish ran cached."""
    edit, events, pngs = _run([
        "--run_edit_local_encoder_pullback_zt", "True", "--neg_prompt", "ugly",
        "--pullback_guidance_scale", "2.5", "--op", "down", "--after_res", "True",
        "--edit_deepcache_interval", "2", "--guidance_deepcache_interval", "2"])
    assert [e["encoder"] for e in events if e["event"] == "sd_local_pullback"] == [
        "xla_cfg2.5"]
    basis = os.listdir(edit.cfg.basis_folder)
    assert len(basis) == 1 and basis[0].endswith("-after_res0-cfg2.5" + basis_ext())
    stages = {e["event"]: e for e in events}
    assert stages["sd_x_space_guidance_walk"]["deepcache"] == 2
    assert stages["sd_finish_forward"]["deepcache"] == 2
    assert stages["sd_decode_and_save"]["finite"]
    assert len(pngs) == 4 and all(n.startswith("Edit_zt-noise_0-edit_0.5T-down-block_0")
                                  for n in pngs)


@pytest.mark.parametrize("flag,x0,tag", [
    ("--run_edit_local_decoder_pullback_zt", False, "local_dec"),
    ("--run_edit_local_x0_decoder_pullback_zt", True, "local_dec_x0")])
def test_decoder_pullback_dispatch(tiny_sd, flag, x0, tag):
    _, events, pngs = _run([flag, "True"])
    assert [e["x0_pullback"] for e in events if e["event"] == "sd_decoder_pullback"
            ] == [x0]
    assert len(pngs) == 4 and all(n.startswith(f"Edit_{tag}-noise_0") for n in pngs)


@pytest.mark.parametrize("num_pc", [0, 2])
def test_text_driven_dispatch(tiny_sd, num_pc):
    _, events, pngs = _run(["--run_edit_text_driven_direction", "True",
                            "--edit_prompt", "a dog", "--text_driven_num_pc", str(num_pc)])
    decomposed = [e for e in events if e["event"] == "text_driven_pc_decomposition"]
    assert len(decomposed) == (num_pc > 0)
    assert len(pngs) == (num_pc or 2)
    assert all(n.startswith("Edit_text_driven-noise_0-edit_0.5T-mid-block_0-prompt_a_dog")
               for n in pngs)


def test_ddim_forward_dispatch(tiny_sd):
    _, events, pngs = _run(["--run_ddim_forward", "True"])
    assert pngs == ["DDIMforward.png"]
    assert [e["num_samples"] for e in events if e["event"] == "sd_ddim_forward"] == [5]


@pytest.mark.parametrize("flag", ["--run_edit_local_decoder_pullback_zt",
                                  "--run_edit_local_x0_decoder_pullback_zt",
                                  "--run_edit_text_driven_direction"])
def test_uncond_refuses_the_sd_runs(monkeypatch, tmp_path, flag):
    """The text-driven edit needs a prompt and the uncond family refuses it,
    as the JAX CLI does; the decoder and x̂₀ pullbacks run there (the
    DDPM-family UNet2D has no learned σ, so its x̂₀ map is defined)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmodels, "model_for_name",
                        lambda name, dtype="float32", **kw: tmodels.UNet2D(tmodels.ddpm_tiny(8)))
    argv = ["--note", "x", "--device", "cpu", "--model_name", "CelebA_HQ_HF",
            "--performance_boosting_t", "0.2", "--x_space_guidance_num_step", "2",
            flag, "True"]
    if "text_driven" in flag:
        with pytest.raises(SystemExit, match="text-conditioned"):
            tmain.main(argv)
        return
    edit = tmain.main(argv)
    tag = "local_dec_x0" if "x0" in flag else "local_dec"
    with open(edit.log.path) as f:
        events = [json.loads(line) for line in f]
    assert [e["x0_pullback"] for e in events if e["event"] == "local_decoder_pullback"
            ] == ["x0" in flag]
    pngs = os.listdir(edit.cfg.result_folder)
    assert len(pngs) == 4 and all(n.startswith(f"Edit_{tag}-noise_0") for n in pngs)


def test_run_ddim_forward_matches_jax(tmp_path):
    """zT drawn from a seeded torch.Generator, denoised over the whole grid
    and decoded, against the JAX driver's DDIMforwardsteps and decode of
    the same zT."""
    cfg = dict(dataset_name="noise", for_steps=6, inv_steps=6, for_prompt="a photo")
    jdrv, tdrv = sd_driver_pair(tmp_path, cfg, size=8)
    imgs = tdrv.run_DDIMforward(num_samples=2, save_as=str(tmp_path / "f.png"),
                                generator=torch.Generator().manual_seed(5))
    zT = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(5)).numpy()
    ref = jdrv.decode_latents(jdrv.DDIMforwardsteps(jnp.asarray(zT), 0))
    assert imgs.shape == (2, 16, 16, 3) and os.path.exists(tmp_path / "f.png")
    np.testing.assert_allclose(imgs, np.asarray(ref), atol=1e-4)
