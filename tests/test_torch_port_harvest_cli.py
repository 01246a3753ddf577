"""The port CLI's harvest, PCA and mean-basis flags on the CPU: their names
and defaults equal the JAX CLI's; for each family the port's dispatch makes
the same driver calls, with the same arguments, as the JAX main.py's on
the same flags (both run against a recorder with the port driver's
methods); and the runs end to end at tiny widths: the prompt sweep and its
edit loop, local and global PCA on a tiny SD 2.1-base, the Fréchet and
Hungarian edits on ddpm_tiny, and the SD-only refusal of the mean-basis
runs."""

import dataclasses
import json
import os

import pytest
from torch_port_common import basis_ext, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu.utils.config import parse_args as jparse_args
from diffusion_pullback_tpu.utils.config import preset as jpreset
from diffusion_pullback_tpu_torch import experiments as texp
from diffusion_pullback_tpu_torch import main as tmain
from diffusion_pullback_tpu_torch import models as tmodels

NEW_FLAGS = {
    "run_edit_local_encoder_pullback_zt_with_various_prompt": "True",
    "various_prompt_sample_idx": "2", "num_local_basis": "3",
    "run_edit_global_pca_zt": "True", "run_edit_local_pca_zt": "True",
    "run_sample_encoder_local_tangent_space_zt": "True", "fix_xt": "True",
    "fix_t": "True", "run_edit_global_frechet_mean_zt": "True",
    "run_edit_global_hungarian_mean_zt": "True"}
BOOST = ["--performance_boosting_t", "0.2"]
SD = "stabilityai/stable-diffusion-2-1-base"
SDXL = "stabilityai/stable-diffusion-xl-base-1.0"


def _argv(flags):
    return ["--note", "x"] + [a for f, v in flags.items() for a in (f"--{f}", v)]


def test_new_flags_have_the_jax_names_and_defaults():
    mine, theirs = tmain.parse_args(["--note", "x"]), jparse_args(["--note", "x"])
    for flag in NEW_FLAGS:
        assert getattr(mine, flag) == getattr(theirs, flag), flag
    mine, theirs = tmain.parse_args(_argv(NEW_FLAGS)), jparse_args(_argv(NEW_FLAGS))
    for flag in NEW_FLAGS:
        assert getattr(mine, flag) == getattr(theirs, flag), flag


class Recorder:
    """A driver stand-in with the methods of ``cls``: each call is recorded
    as (name, positional args, keyword args); other attributes are
    missing, as on the driver."""

    def __init__(self, cls):
        self.cls, self.calls = cls, []

    def __getattr__(self, name):
        if not hasattr(self.cls, name):
            raise AttributeError(name)
        return lambda *a, **kw: self.calls.append((name, a, kw))


@pytest.mark.parametrize("model,cls", [(SD, texp.EditStableDiffusion),
                                       (SDXL, texp.EditStableDiffusionXL),
                                       ("CelebA_HQ_HF", texp.EditUncondDiffusion)])
@pytest.mark.parametrize("flags", [
    {k: v for k, v in NEW_FLAGS.items() if "mean" not in k},
    {"run_edit_global_frechet_mean_zt": "True", "num_local_basis": "9"},
    {"run_edit_global_hungarian_mean_zt": "True", "op": "down", "block_idx": "1"}],
    ids=["harvests-and-pca", "frechet", "hungarian"])
def test_dispatch_makes_the_jax_clis_calls(monkeypatch, model, cls, flags):
    import main as jmain

    argv = _argv(flags) + ["--model_name", model] + (
        [] if "stable-diffusion" in model else BOOST)
    jargs, targs = jpreset(jparse_args(argv)), tmain.parse_args(argv)
    theirs, mine = Recorder(cls), Recorder(cls)
    for build in ("build_sd", "build_sdxl", "build_uncond"):
        monkeypatch.setattr(jmain, build, lambda *a, **kw: theirs)
    sd = "stable-diffusion" in model
    if "mean" in str(flags) and sd:
        with pytest.raises(SystemExit, match="unconditional family"):
            jmain._dispatch(jargs)
        with pytest.raises(SystemExit, match="unconditional family"):
            tmain.dispatch(mine, targs)
        return
    jmain._dispatch(jargs)
    tmain.dispatch(mine, targs)
    assert mine.calls == theirs.calls and mine.calls
    names = [c[0] for c in mine.calls]
    if "various_prompt_sample_idx" in flags:
        assert names.count("run_edit_local_encoder_pullback_zt") == 3
        assert ("run_sample_encoder_local_tangent_space_zt_various_prompt" in names) == sd


@pytest.fixture
def tiny_sd(monkeypatch, tmp_path):
    """The SD 2.1-base presets swapped for tiny ones (32 px images, a VAE
    with four levels so that they encode to the U-Net's 4×4 latents, as
    global PCA's drawn latents are), run from a fresh directory."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmodels, "sd21_base_unet", lambda **over: dataclasses.replace(
        tmodels.sd_tiny_unet(4), **over))
    monkeypatch.setattr(tmodels, "sd_vae", lambda **over: dataclasses.replace(
        tmodels.vae_tiny(32), block_out_channels=(8, 16, 16, 16), **over))
    monkeypatch.setattr(tmodels, "sd21_text_encoder", tmodels.clip_text_tiny)


def _run(flags):
    edit = tmain.main(["--note", "x", "--device", "cpu", "--for_steps", "4",
                       "--inv_steps", "4", "--edit_t", "0.5",
                       "--x_space_guidance_num_step", "2"] + flags)
    with open(edit.log.path) as f:
        events = [json.loads(line) for line in f]
    return edit, events, sorted(os.listdir(edit.cfg.result_folder))


def test_prompt_sweep_then_edits_from_the_cache(tiny_sd):
    """Two bundled captions: the sweep runs one pullback per prompt, the
    edit loop none, and writes each prompt's four PNGs."""
    edit, events, pngs = _run(["--run_edit_local_encoder_pullback_zt_with_various_prompt",
                               "True", "--num_local_basis", "2"])
    stages = [e["event"] for e in events if "seconds" in e]
    assert stages.count("sd_local_pullback") == 2
    assert stages.index("sd_prompt_sweep") < stages.index("sd_x_space_guidance_walk")
    hits = [e["name"] for e in events if e["event"] == "basis_cache_hit"]
    assert len(hits) == 2 and sorted(os.path.splitext(f)[0] for f in os.listdir(
        edit.cfg.basis_folder)) == sorted(hits)
    with open(os.path.join(tmain.__file__.rsplit("/", 2)[0], "inputs",
                           "prompts_coco50.txt")) as f:
        first = [next(f).strip() for _ in range(2)]
    assert [p for p in first if any(f'"{p}"' in h for h in hits)] == first
    assert len(pngs) == 8


def test_pca_edits_run(tiny_sd):
    _, events, pngs = _run(["--run_edit_local_pca_zt", "True", "--run_edit_global_pca_zt",
                            "True", "--num_local_basis", "4"])
    stages = {e["event"]: e for e in events if "seconds" in e}
    assert stages["sd_local_pca"]["num_samples"] == 1024
    assert stages["sd_global_pca_harvest"]["num_samples"] == 4
    assert sum(n.startswith("Edit_local_pca-noise_0-edit_0.5T-mid") for n in pngs) == 4
    assert sum(n.startswith("Edit_global_pca-noise_0-edit_0.5T-mid") for n in pngs) == 4


@pytest.mark.parametrize("flag,tag", [("--run_edit_global_frechet_mean_zt", "global_frechet"),
                                      ("--run_edit_global_hungarian_mean_zt",
                                       "global_hungarian")])
def test_mean_basis_edits_run_on_uncond(monkeypatch, tmp_path, flag, tag):
    """min(num_local_basis, 5) = 2 samples' pca_rank-10 bases, then the
    edit of --sample_idx, with ddpm_tiny(8) in place of the 256 px U-Net."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmodels, "model_for_name",
                        lambda name, dtype="float32", **kw: tmodels.UNet2D(tmodels.ddpm_tiny(8)))
    edit = tmain.main(["--note", "x", "--device", "cpu", "--model_name", "CelebA_HQ_HF",
                       "--edit_t", "0.5", "--x_space_guidance_num_step", "2",
                       "--num_local_basis", "2", flag, "True"] + BOOST)
    assert sorted(os.listdir(edit.cfg.basis_folder)) == [
        f"local_basis-noise_{i}-0.5T-mid-block_0-seed_0-pca_rank_10{basis_ext()}"
        for i in (0, 1)]
    pngs = os.listdir(edit.cfg.result_folder)
    assert len(pngs) == 4 and all(n.startswith(f"Edit_{tag}-noise_0-edit_0.5T-mid")
                                  for n in pngs)
