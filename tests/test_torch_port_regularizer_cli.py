"""The post-edit regularizers in the port's uncond driver and CLI against
the JAX package on the CPU, f32, weights carried by load_flax_params:

  - the uncond driver's edit (ddpm_tiny(16)) with dynamic thresholding,
    preserve_contrast and preserve_norm all on: the JAX driver computes the
    basis and the PNGs, the port edits from a copy of the basis file;
    every PNG within one uint8 level of the JAX one, and the frames the
    port hands its finish carry the walk start's norm;
  - the SEGA-sparsified Fréchet-mean edit on ddpm_tiny(16): the directions
    handed to the edit tail within |cos| ≥ 0.999 of the JAX driver's (the
    repo's direction gate), sparse where JAX's are;
  - the CLI: the six flags with the JAX CLI's names and defaults, and the
    configs both CLIs' builders make from them (SD, SDXL, uncond; SDXL in
    bf16 also with remat_transformer and pullback_remat), against the
    JAX builders run on models without parameters;
  - the uncond driver no longer refuses them (the mesh still raises).
The SD driver's: tests/test_torch_port_regularized_edits.py."""

import dataclasses

import pytest
from torch_port_common import (  # noqa: F401
    REGULARIZERS,
    copy_bases,
    ddpm_driver_pair,
    norms_kept,
    one_torch_thread,
    record_edits,
    same_directions,
    same_pngs,
    spy_regularize,
    uncond_same_start,
)

from diffusion_pullback_tpu import experiments as jexp
from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.utils.config import parse_args as jparse_args
from diffusion_pullback_tpu.utils.config import preset as jpreset
from diffusion_pullback_tpu_torch import experiments as texp
from diffusion_pullback_tpu_torch import main as tmain
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule

FLAGS = {"use_dynamic_thresholding": "True", "dynamic_thresholding_q": "0.7",
         "use_preserve_contrast": "True", "use_preserve_norm": "True",
         "use_sega_reg": "True", "sega_reg_sigma": "0.5"}
SD = "stabilityai/stable-diffusion-2-1-base"
SDXL = "stabilityai/stable-diffusion-xl-base-1.0"


def test_uncond_regularized_edit_matches_jax(tmp_path, monkeypatch):
    cfg = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6, pca_rank=2,
               pullback_min_iter=1, pullback_max_iter=1, pullback_atol=0.0,
               x_space_guidance_num_step=3, x_space_guidance_scale=0.5, vis_num=2,
               vis_num_pc=1, use_performance_boosting=False, **REGULARIZERS)
    jdrv, tdrv = ddpm_driver_pair(tmp_path, cfg)
    uncond_same_start(monkeypatch, jdrv, tdrv, rank=2)
    jnames = jdrv.run_edit_local_encoder_pullback_xt(idx=1)
    copy_bases(jdrv, tdrv)
    seen = spy_regularize(monkeypatch, tdrv)
    tnames = tdrv.run_edit_local_encoder_pullback_zt(idx=1)
    assert tnames == jnames and len(tnames) == 2
    same_pngs(jdrv, tdrv, tnames, 16, frames=2)
    norms_kept(seen)


def test_sega_frechet_mean_edit_matches_jax(tmp_path, monkeypatch):
    cfg = dict(dataset_name="noise", for_steps=8, inv_steps=8, edit_t=0.6, pca_rank=2,
               pullback_min_iter=2, pullback_max_iter=2, pullback_atol=0.0,
               vis_num=2, vis_num_pc=2, use_performance_boosting=False,
               use_sega_reg=True, sega_reg_sigma=0.5)
    jdrv, tdrv = ddpm_driver_pair(tmp_path, cfg)
    uncond_same_start(monkeypatch, jdrv, tdrv, rank=2)
    got = record_edits(monkeypatch, jdrv, tdrv)
    kw = dict(basis_indices=[0, 3], pca_rank=2, vis_num=2, vis_num_pc=2)
    jdrv.run_edit_global_frechet_mean_xt(1, **kw)
    tdrv.run_edit_global_frechet_mean_xt(1, **kw)
    same_directions(got)
    for a, b in zip(got["port"][0], got["jax"][0]):
        zeros = b == 0
        assert 0.1 < zeros.mean() < 0.9
        assert ((a == 0) == zeros).mean() > 0.99


def test_flags_have_the_jax_names_and_defaults():
    mine, theirs = tmain.parse_args(["--note", "x"]), jparse_args(["--note", "x"])
    argv = ["--note", "x"] + [a for f, v in FLAGS.items() for a in (f"--{f}", v)]
    for a, b in ((mine, theirs), (tmain.parse_args(argv), jparse_args(argv))):
        for flag in FLAGS:
            assert getattr(a, flag) == getattr(b, flag), flag
    assert (mine.dynamic_thresholding_q, mine.sega_reg_sigma) == (0.8, 1.0)


class _Shape:
    """A JAX model that only has a config: its init gives no parameters."""

    def __init__(self, config=None):
        self.config = config

    def init(self, *args, **kwargs):
        return {}


def _capture(*args, **kwargs):
    """(config, the models before it) of a driver, in place of the driver."""
    i = next(i for i, a in enumerate(args) if hasattr(a, "basis_folder"))
    return args[i], args[:i]


@pytest.mark.parametrize("model,flags", [
    (SD, []), (SD, ["--dtype", "bf16"]), (SDXL, ["--dtype", "bf16"]), (SDXL, []),
    ("CelebA_HQ_HF", ["--performance_boosting_t", "0.2"])],
    ids=["sd", "sd-bf16", "sdxl-bf16", "sdxl-fp32", "celeba"])
def test_builders_pass_the_flags_as_the_jax_cli(tmp_path, monkeypatch, model, flags):
    """Both CLIs' builders on the same argv (every regularizer flag set):
    the configs carry the same values; SDXL's also the same
    pullback_remat, and its U-Net remat_transformer where it runs bf16."""
    import main as jmain

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jmodels, "model_for_name", lambda *a, **kw: _Shape())
    for name in ("UNet2DCondition", "AutoencoderKL", "CLIPTextModel"):
        monkeypatch.setattr(jmodels, name, _Shape)
    tower = lambda: dataclasses.replace(tmodels.clip_text_tiny(), hidden_size=8)
    monkeypatch.setattr(tmodels, "model_for_name",
                        lambda name, dtype="float32", **kw: tmodels.UNet2D(tmodels.ddpm_tiny(8)))
    for name, tiny in (("sd21_base_unet", tmodels.sd_tiny_unet(2)),
                       ("sdxl_base_unet", tmodels.sdxl_tiny_unet(2))):
        monkeypatch.setattr(tmodels, name, lambda _t=tiny, **over: dataclasses.replace(
            _t, **over))
    monkeypatch.setattr(tmodels, "sd_vae", lambda **over: dataclasses.replace(
        tmodels.vae_tiny(16), **over))
    for name in ("sd21_text_encoder", "sdxl_text_encoder_1", "sdxl_text_encoder_2"):
        monkeypatch.setattr(tmodels, name, tower)
    for mod in (jexp, texp):
        for cls in ("EditUncondDiffusion", "EditStableDiffusion", "EditStableDiffusionXL"):
            monkeypatch.setattr(mod, cls, _capture)
    argv = (["--note", "n", "--model_name", model, "--device", "cpu"] + flags
            + [a for f, v in FLAGS.items() for a in (f"--{f}", v)])
    jargs, targs = jpreset(jparse_args(argv)), tmain.parse_args(argv)
    build = ("build_sdxl" if jargs.is_sdxl else "build_sd" if jargs.is_stable_diffusion
             else "build_uncond")
    (jcfg, jmods), (tcfg, tmods) = (getattr(jmain, build)(jargs)[:2],
                                    getattr(tmain, build)(targs))
    fields = ["use_dynamic_thresholding", "dynamic_thresholding_q",
              "use_preserve_contrast", "use_preserve_norm"]
    if build == "build_uncond":
        fields += ["use_sega_reg", "sega_reg_sigma"]
    else:
        fields += ["pullback_remat"]
    for f in fields:
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert (tcfg.dynamic_thresholding_q, tcfg.use_preserve_norm) == (0.7, True)
    if build == "build_sdxl":
        assert tcfg.pullback_remat
        remat = [m.config.remat_transformer for m in (tmods[0], jmods[0])]
        assert remat == [flags == ["--dtype", "bf16"]] * 2


def test_uncond_driver_accepts_the_regularizers(tmp_path):
    edit = texp.EditUncondDiffusion(
        tmodels.UNet2D(tmodels.ddpm_tiny(8)), DiffusionSchedule.linear(), None,
        texp.UncondExperimentConfig(use_sega_reg=True, use_dynamic_thresholding=True,
                                    basis_folder=str(tmp_path)), device="cpu")
    assert edit.cfg.use_sega_reg and edit.cfg.sega_reg_sigma == 1.0
    # with a mesh too (one rank here): the regularizers do not depend on it
    from torch_port_dist import mesh, one_rank

    with one_rank(tmp_path):
        edit = texp.EditUncondDiffusion(
            tmodels.UNet2D(tmodels.ddpm_tiny(8)), DiffusionSchedule.linear(), None,
            texp.UncondExperimentConfig(use_sega_reg=True, mesh=mesh(("dp",)),
                                        basis_folder=str(tmp_path)), device="cpu")
        assert edit.cfg.use_sega_reg and edit.cfg.mesh is not None
