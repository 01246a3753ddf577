"""The port's uncond CLI, data and basis cache against the JAX package on
the CPU: experiment and basis folders equal to the JAX CLI's for the same
flags (SD and CelebA_HQ_HF), the bundled CelebA-HQ images within one uint8
level of the JAX loader's, a basis cache that reads what the JAX one reads,
the preset's checks, the unported options refusing, and a CPU run of the
uncond CLI with ddpm_tiny(32) standing in for the 256 px U-Net."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_common import basis_ext, one_torch_thread  # noqa: F401

from diffusion_pullback_tpu import experiments as jexp
from diffusion_pullback_tpu import models as jmodels
from diffusion_pullback_tpu.utils.config import parse_args as jparse_args
from diffusion_pullback_tpu.utils.config import preset as jpreset
from diffusion_pullback_tpu.utils.datasets import ImgDataset as JImgDataset
from diffusion_pullback_tpu_torch import experiments as texp
from diffusion_pullback_tpu_torch import main as tmain
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.experiments.cache import BasisCache
from diffusion_pullback_tpu_torch.ops.schedule import DiffusionSchedule
from diffusion_pullback_tpu_torch.utils.datasets import (
    ImgDataset, NoiseDataset, get_dataset)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELEBA = os.path.join(ROOT, "datasets", "celeba_hq")
SD = "stabilityai/stable-diffusion-2-1-base"


@pytest.mark.parametrize("idx", range(5))
def test_bundled_celeba_image_matches_jax_loader(idx):
    mine, theirs = ImgDataset(CELEBA, 256)[idx], JImgDataset(CELEBA, 256)[idx]
    assert mine.shape == theirs.shape == (1, 256, 256, 3)
    assert np.abs(mine - theirs).max() <= 2 / 255


def test_get_dataset_searches_and_raises(tmp_path):
    assert isinstance(get_dataset("noise", 8), NoiseDataset)
    assert get_dataset("CelebA_HQ", 8).files[0].endswith(os.path.join("celeba_hq", "0.jpg"))
    (tmp_path / "faces").mkdir()
    for n in ("img10.png", "img2.png"):   # 4×6 black images, cropped to 4×4
        Image.fromarray(np.zeros((4, 6, 3), np.uint8)).save(tmp_path / "faces" / n)
    ds = get_dataset("Faces", 4, data_root=str(tmp_path))
    assert [os.path.basename(f) for f in ds.files] == ["img2.png", "img10.png"]
    assert ds[0].shape == (1, 4, 4, 3) and np.all(ds[0] == -1.0)
    with pytest.raises(FileNotFoundError):
        get_dataset("NoSuchSet", 8)


class _Shape:
    """A JAX model that only has a config: its init gives no parameters."""

    def __init__(self, config=None):
        self.config = config

    def init(self, *args, **kwargs):
        return {}


def _capture(*args, **kwargs):
    """A driver's (config, dataset, log path), in place of the driver."""
    i = next(i for i, a in enumerate(args) if hasattr(a, "basis_folder"))
    logger = kwargs.get("logger") or args[i + 1]
    return args[i], args[i - 1], logger.path


def _stub_models(monkeypatch):
    """The builders of both CLIs run; the JAX models are shapes without
    parameters and the port's are tiny, so no 113.7 M or 865.9 M parameter
    model is built."""
    monkeypatch.setattr(jmodels, "model_for_name", lambda *a, **kw: _Shape())
    for name in ("UNet2DCondition", "AutoencoderKL", "CLIPTextModel"):
        monkeypatch.setattr(jmodels, name, _Shape)
    monkeypatch.setattr(tmodels, "model_for_name",
                        lambda name, dtype="float32", **kw: tmodels.UNet2D(tmodels.ddpm_tiny(8)))
    monkeypatch.setattr(tmodels, "sd21_base_unet", lambda **over: dataclasses.replace(
        tmodels.sd_tiny_unet(2), **over))
    monkeypatch.setattr(tmodels, "sd_vae", lambda **over: dataclasses.replace(
        tmodels.vae_tiny(16), **over))
    monkeypatch.setattr(tmodels, "sd21_text_encoder", tmodels.clip_text_tiny)
    for mod in (jexp, texp):
        monkeypatch.setattr(mod, "EditUncondDiffusion", _capture)
        monkeypatch.setattr(mod, "EditStableDiffusion", _capture)


@pytest.mark.parametrize("model,flags", [
    (SD, []), (SD, ["--dataset_name", "noise", "--use_x_space_guidance", "True",
                    "--h_t", "0.0"]),
    ("CelebA_HQ_HF", ["--performance_boosting_t", "0.2"]),
    ("CelebA_HQ_HF", ["--performance_boosting_t", "0.2", "--dataset_name",
                      "CelebA_HQ", "--use_x_space_guidance", "True", "--h_t", "0.6"]),
], ids=["sd-default", "sd-noise-h_t", "celeba-default", "celeba-dataset-h_t"])
def test_cli_folders_match_jax(tmp_path, monkeypatch, model, flags):
    import main as jmain

    monkeypatch.chdir(tmp_path)
    _stub_models(monkeypatch)
    argv = ["--note", "n", "--model_name", model, "--result_folder",
            str(tmp_path / "runs"), "--pca_rank", "3", "--device", "cpu"] + flags
    jargs = jpreset(jparse_args(argv))
    if jargs.is_stable_diffusion:
        jcfg, jdata, jlog = jmain.build_sd(jargs)
        tcfg, tdata, tlog = tmain.build_sd(tmain.parse_args(argv))
    else:
        jcfg, jdata, jlog = jmain.build_uncond(jargs)
        tcfg, tdata, tlog = tmain.build_uncond(tmain.parse_args(argv))
    exp_folder, basis_folder = tmain.experiment_folders(tmain.parse_args(argv))
    assert exp_folder == jargs.exp_folder
    assert basis_folder == tcfg.basis_folder == jcfg.basis_folder
    assert tcfg.result_folder == jcfg.result_folder == jargs.result_folder
    assert tlog == jlog
    for f in ("dataset_name", "x_space_guidance_scale", "x_space_guidance_num_step",
              "pca_rank", "for_steps", "edit_t"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert type(tdata).__name__ == type(jdata).__name__
    if not jargs.is_stable_diffusion:
        assert (tcfg.performance_boosting_t, tcfg.use_performance_boosting) == (
            jcfg.performance_boosting_t, jcfg.use_performance_boosting)


def test_basis_cache_reads_past_a_corrupt_dpb(tmp_path):
    u, s, vT = (np.arange(n, dtype=np.float32).reshape(shape) + 1 for n, shape in
                ((6, (3, 2)), (2, (2,)), (8, (2, 4))))
    np.savez(tmp_path / "b.npz", u=u, s=s, vT=vT)
    (tmp_path / "b.dpb").write_bytes(b"\x00" * 40)   # unreadable, tried first
    for mine, want in zip(BasisCache(str(tmp_path)).load("b"), (u, s, vT)):
        np.testing.assert_array_equal(mine, want)
    (tmp_path / "b.npz").write_bytes(b"not a zip")
    assert BasisCache(str(tmp_path)).load("b") is None


def test_basis_cache_widens_bfloat16_npz(tmp_path):
    """A legacy .npz of raw bfloat16 bytes (2-byte void arrays), as the JAX
    package's bf16 arrays once saved; the JAX cache widens it too."""
    vals = np.array([1.0, -2.5, 3.140625, 1e-3], np.float32)
    bf16 = (vals.view(np.uint32) >> 16).astype(np.uint16).view("V2")
    np.savez(tmp_path / "b.npz", u=bf16.reshape(2, 2), s=bf16[:2], vT=bf16.reshape(2, 2))
    mine = BasisCache(str(tmp_path)).load("b")
    theirs = jexp.BasisCache(str(tmp_path)).load("b")
    for a, b in zip(mine, theirs):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine[1], [1.0, -2.5])
    assert torch.as_tensor(mine[2]).shape == (2, 2)


def test_preset_checks():
    for argv in (["--model_name", "CelebA_HQ_HF", "--performance_boosting_t", "0.2",
                  "--for_steps", "50"],
                 ["--model_name", "CelebA_HQ_HF"],
                 ["--performance_boosting_t", "0.2"]):
        with pytest.raises(ValueError):
            tmain.check_preset(tmain.parse_args(["--note", "n"] + argv))
    with pytest.raises(ValueError, match="build_sdxl"):
        tmain.build_sd(tmain.parse_args(
            ["--note", "n", "--model_name", "stabilityai/stable-diffusion-xl-base-1.0"]))


@pytest.mark.parametrize("field,value,item", [
    ("use_dynamic_thresholding", True, 12), ("use_preserve_norm", True, 12),
    ("mesh", object(), 16)])
def test_unported_options_raise(tmp_path, field, value, item):
    """Options once refused naming their ROADMAP queue 1 item: the
    regularizers (item 12) and the mesh (16, a one-rank mesh here) are
    ported and build."""
    from torch_port_dist import mesh, one_rank

    build = lambda cfg: texp.EditUncondDiffusion(
        tmodels.UNet2D(tmodels.ddpm_tiny(8)), DiffusionSchedule.linear(), None, cfg,
        device="cpu")
    if item == 12:
        cfg = texp.UncondExperimentConfig(**{field: value}, basis_folder=str(tmp_path))
        assert getattr(build(cfg).cfg, field) is value
        return
    with one_rank(tmp_path):
        m = mesh(("probe",))
        cfg = texp.UncondExperimentConfig(**{field: m}, basis_folder=str(tmp_path))
        assert build(cfg).cfg.mesh is m


def test_uncond_cli_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["--note", "x", "--model_name", "CelebA_HQ_HF",
                    "--performance_boosting_t", "0.2"])


def test_uncond_cli_runs_on_cpu(tmp_path, monkeypatch):
    """The CLI end to end at the preset's 100 steps, on the bundled images,
    with ddpm_tiny(32) in place of the 256 px U-Net."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmodels, "model_for_name", lambda name, dtype="float32", **kw:
                        tmodels.UNet2D(dataclasses.replace(tmodels.ddpm_tiny(32),
                                                           dtype=dtype)))
    edit = tmain.main([
        "--note", "x", "--device", "cpu", "--model_name", "CelebA_HQ_HF",
        "--dataset_name", "CelebA_HQ", "--performance_boosting_t", "0.2",
        "--edit_t", "0.5", "--x_space_guidance_num_step", "2",
        "--run_edit_local_encoder_pullback_zt", "True", "--run_ddim_forward", "True"])
    assert isinstance(edit.dataset, ImgDataset) and edit.boost_start_idx == 80
    results = os.listdir(edit.cfg.result_folder)
    assert len([n for n in results if n.startswith("Edit_xt-CelebA_HQ_0")]) == 4
    assert "DDIMforward.png" in results
    assert os.listdir(os.path.join(
        "inputs", "local_encoder_pullback_uncond-dataset_CelebA_HQ-num_steps_100"
                  "-pca_rank_2")) == [
        "local_basis-CelebA_HQ_0-0.5T-mid-block_0-seed_0-pca_rank_2" + basis_ext()]
    with open(edit.log.path) as f:
        events = [json.loads(line) for line in f]
    stages = [e["event"] for e in events if "seconds" in e]
    assert stages == ["ddim_inversion", "ddim_forward_to_edit", "local_pullback",
                      "x_space_guidance_walk", "finish_and_save", "ddim_forward"]
    assert [e["finite"] for e in events if e["event"] == "finish_and_save"] == [True]
