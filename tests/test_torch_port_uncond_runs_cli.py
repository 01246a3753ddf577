"""The port CLI's flags of the uncond edit runs (h-space guidance, parallel
transport, the decoder pullback, --vis_psd, --run_ddim_inversion) on the
CPU: their names and defaults equal the JAX CLI's; for both families the
port's dispatch makes the same driver calls as the JAX main.py's on the
same flags (both against a recorder with the driver's methods); the runs
end to end with ddpm_tiny(8) in place of the 256 px U-Net. And the image
size of an uncond build: the port edits at the net's own size and guides
with adm_classifier at that size, where the JAX CLI's preset takes 256 px
(32 for CIFAR10); for ImageNet64Uncond, ImageNet64Cond and ImageNet128Cond
the two differ, and the port's build_uncond says so."""

import dataclasses
import os
import types

import pytest
import torch
from torch_port_common import basis_ext, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu import experiments as jexp
from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.models import configs as jconfigs
from diffusion_pullback_tpu.utils.config import parse_args as jparse_args
from diffusion_pullback_tpu.utils.config import preset as jpreset
from diffusion_pullback_tpu_torch import experiments as texp
from diffusion_pullback_tpu_torch import main as tmain
from diffusion_pullback_tpu_torch import models as tmodels

NEW_FLAGS = {
    "run_edit_h_space_guidance": "True", "edit_ht": "h_space_guidance",
    "h_space_guidance_scale": "0.3", "run_edit_parallel_transport": "True",
    "sample_idx_0": "2", "sample_idx_1": "3", "run_ddim_inversion": "True",
    "vis_psd": "True", "checkpoint_path": "w.pt", "classifier_path": "c.pt"}
BOOST = ["--performance_boosting_t", "0.2"]
SD = "stabilityai/stable-diffusion-2-1-base"


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
    as (name, positional args, keyword args); other attributes are missing,
    as on the driver, but ``cfg.result_folder``."""

    def __init__(self, cls, result_folder):
        self.cls, self.calls = cls, []
        self.cfg = types.SimpleNamespace(result_folder=result_folder)

    def __getattr__(self, name):
        if not hasattr(self.cls, name):
            raise AttributeError(name)

        def call(*a, **kw):
            self.calls.append((name, a, kw))
        call.__name__ = name
        return call


@pytest.mark.parametrize("model,cls", [(SD, texp.EditStableDiffusion),
                                       ("CelebA_HQ_HF", texp.EditUncondDiffusion)])
@pytest.mark.parametrize("flags", [
    {"run_edit_h_space_guidance": "True", "h_space_guidance_scale": "0.3"},
    {"edit_ht": "h_space_guidance", "pca_rank": "3", "op": "up", "block_idx": "1"},
    {"run_edit_parallel_transport": "True", "sample_idx_0": "2", "sample_idx_1": "3"},
    {"run_edit_local_decoder_pullback_zt": "True", "pca_rank": "4"},
    {"run_edit_local_x0_decoder_pullback_zt": "True"},
    {"run_ddim_forward": "True", "vis_psd": "True", "run_ddim_inversion": "True",
     "sample_idx": "2"},
    {"run_ddim_forward": "True"}],
    ids=["h_space", "edit_ht", "transport", "decoder", "x0_decoder", "psd-inversion",
         "forward"])
def test_dispatch_makes_the_jax_clis_calls(tmp_path, monkeypatch, model, cls, flags):
    import main as jmain

    monkeypatch.chdir(tmp_path)
    argv = _argv(flags) + ["--model_name", model] + (
        [] if "stable-diffusion" in model else BOOST)
    jargs, targs = jpreset(jparse_args(argv)), tmain.parse_args(argv)
    theirs, mine = Recorder(cls, jargs.result_folder), Recorder(cls, jargs.result_folder)
    for build in ("build_sd", "build_sdxl", "build_uncond"):
        monkeypatch.setattr(jmain, build, lambda *a, **kw: theirs)
    sd = "stable-diffusion" in model
    if sd and ("h_space" in str(flags) or "transport" in str(flags)):
        with pytest.raises(SystemExit, match="unconditional family"):
            jmain._dispatch(jargs)
        with pytest.raises(SystemExit, match="unconditional family"):
            tmain.dispatch(mine, targs)
        return
    jmain._dispatch(jargs)
    tmain.dispatch(mine, targs)
    assert mine.calls == theirs.calls and mine.calls


def _tiny_ddpm(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmodels, "model_for_name", lambda name, dtype="float32", **kw:
                        tmodels.UNet2D(tmodels.ddpm_tiny(8)))


def test_uncond_runs_end_to_end(tmp_path, monkeypatch):
    """h-space guidance, the transport of sample 1's pca_rank-50 directions
    to sample 2, the decoder-pullback edit, the forward with its power
    spectra and the inversion, through the CLI with ddpm_tiny(8)."""
    _tiny_ddpm(monkeypatch, tmp_path)
    inverted = []
    monkeypatch.setattr(texp.EditUncondDiffusion, "run_ddim_inversion",
                        lambda self, idx, _r=texp.EditUncondDiffusion.run_ddim_inversion:
                        inverted.append(idx) or _r(self, idx))
    edit = tmain.main(["--note", "x", "--device", "cpu", "--model_name", "CelebA_HQ_HF",
                       "--edit_t", "0.5", "--x_space_guidance_num_step", "2",
                       "--sample_idx", "3", "--sample_idx_0", "1", "--sample_idx_1", "2",
                       "--run_edit_h_space_guidance", "True", "--h_space_guidance_scale",
                       "0.25", "--run_edit_parallel_transport", "True",
                       "--run_edit_local_decoder_pullback_zt", "True",
                       "--run_ddim_forward", "True", "--vis_psd", "True",
                       "--run_ddim_inversion", "True"] + BOOST)
    pngs = sorted(os.listdir(edit.cfg.result_folder))
    assert sum(n.startswith("Edit_transport-noise_1to2-edit_0.5T-mid-block_0-pc_")
               for n in pngs) == 4
    assert sum(n.startswith("Edit_h_space-noise_3-edit_0.5T-mid-block_0-scale_0.25-pc_")
               for n in pngs) == 4
    assert sum(n.startswith("Edit_local_dec-noise_3-edit_0.5T-mid-block_0-pc_")
               for n in pngs) == 4
    assert "DDIMforward.png" in pngs
    assert {"xt_psd.png", "et_psd.png"} <= set(os.listdir(edit.cfg.obs_folder))
    assert edit.cfg.obs_folder == os.path.join(os.path.dirname(edit.cfg.result_folder),
                                               "obs")
    assert sorted(os.listdir(edit.cfg.basis_folder)) == [
        f"local_basis-noise_{i}-0.5T-mid-block_0-seed_0-pca_rank_{r}{basis_ext()}"
        for i, r in ((1, 50), (2, 50), (3, 2))]
    # transport 1 and 2, h-space 3, decoder 3, then --run_ddim_inversion 3
    assert inverted == [1, 2, 3, 3, 3]


# the ADM names where the net's size is not the JAX CLI's preset size
DEPARTURES = {"ImageNet64Uncond": 64, "ImageNet64Cond": 64, "ImageNet128Cond": 128}


@pytest.mark.parametrize("name,size", list(DEPARTURES.items()) + [
    ("ImageNet256Uncond", 256), ("CIFAR10", 32)])
def test_uncond_image_size_is_the_nets_and_the_departure_is_said(
        tmp_path, monkeypatch, capsys, name, size):
    """build_uncond's images and guidance classifier are at the net's size
    (stubbed with a tiny ADM of that size); the JAX CLI's preset and
    build_uncond take 256 px (32 for CIFAR10) for both, and where the two
    differ the port's build_uncond prints the departure."""
    import main as jmain

    monkeypatch.chdir(tmp_path)
    with torch.device("meta"):
        assert tmodels.model_for_name(name).config.image_size == size
    made = {}

    class _Shape:
        def __init__(self, config=None):
            self.config = config

        def init(self, *a, **kw):
            return {}

    def record(tag):
        def classifier(s):
            made[tag] = s
            return tmodels.adm_encoder_tiny(8)
        return classifier

    monkeypatch.setattr(jmodels, "model_for_name", lambda n, **kw: _Shape())
    monkeypatch.setattr(jmodels, "EncoderUNetADM", _Shape)
    monkeypatch.setattr(jconfigs, "adm_classifier", record("jax"))
    monkeypatch.setattr(tmodels, "model_for_name", lambda n, dtype="float32", attn_impl="":
                        tmodels.UNetADM(dataclasses.replace(tmodels.adm_tiny(8),
                                                            image_size=size)))
    monkeypatch.setattr(tmodels, "adm_classifier", record("port"))
    built = lambda *a, **kw: types.SimpleNamespace(dataset=a[3] if len(a) > 4 else a[2],
                                                   cond_fn=None)
    monkeypatch.setattr(jexp, "EditUncondDiffusion", built)
    monkeypatch.setattr(texp, "EditUncondDiffusion", built)
    argv = ["--note", "n", "--model_name", name, "--device", "cpu",
            "--classifier_scale", "1"] + BOOST
    jdrv = jmain.build_uncond(jpreset(jparse_args(argv)))
    capsys.readouterr()
    tdrv = tmain.build_uncond(tmain.parse_args(argv))
    out = capsys.readouterr().out
    jax_size = 32 if "CIFAR10" in name else 256
    assert jdrv.dataset[0].shape == (1, jax_size, jax_size, 3) and made["jax"] == jax_size
    assert tdrv.dataset[0].shape == (1, size, size, 3) and made["port"] == size
    notice = (f"[main] {name}: images and the guidance classifier at the model's {size} "
              f"px; the JAX CLI's preset takes {jax_size} px (a deliberate departure)")
    assert (notice in out) == (name in DEPARTURES)
