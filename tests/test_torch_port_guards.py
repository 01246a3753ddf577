"""Guards of the port: it imports neither JAX (nor flax, optax or orbax) nor
the JAX package, its entry points refuse to run without CUDA unless given
the CPU, the CLI's pullback defaults to the fused kernel pair on CUDA and to
the math path on the CPU, and chip_smoke.py fails without a card."""

import ast
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401

from diffusion_pullback_tpu_torch import main as tmain
from diffusion_pullback_tpu_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "diffusion_pullback_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "diffusion_pullback_tpu"}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not FORBIDDEN & set(roots), f"{path.name}:{node.lineno} imports {roots}"


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["--note", "x"])
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.fixture
def tiny_models(monkeypatch):
    """The CLI's SD 2.1-base presets swapped for tiny ones (16 px images,
    8×8 latents), so the CLI runs on the CPU in seconds."""
    from diffusion_pullback_tpu_torch import models

    monkeypatch.setattr(models, "sd21_base_unet", lambda **over: dataclasses.replace(
        models.sd_tiny_unet(2), **over))
    monkeypatch.setattr(models, "sd_vae", lambda **over: dataclasses.replace(
        models.vae_tiny(16), **over))
    monkeypatch.setattr(models, "sd21_text_encoder", models.clip_text_tiny)


def test_pullback_flash_raises_naming_slice_2(tmp_path, monkeypatch, tiny_models):
    """``--pullback_attn_impl flash --device cpu`` runs the edit path with
    the fused pair as the pullback's encoder (the kernels' plain versions
    on the CPU)."""
    monkeypatch.chdir(tmp_path)
    edit = tmain.main([
        "--note", "x", "--device", "cpu", "--pullback_attn_impl", "flash",
        "--result_folder", str(tmp_path / "runs"), "--for_steps", "4",
        "--inv_steps", "4", "--edit_t", "0.5", "--x_space_guidance_num_step",
        "2", "--run_edit_local_encoder_pullback_zt", "True"])
    with open(edit.log.path) as f:
        events = [json.loads(line) for line in f]
    assert [e["encoder"] for e in events if e["event"] == "sd_local_pullback"
            ] == ["flashpair"]
    assert [e["finite"] for e in events if e["event"] == "sd_decode_and_save"
            ] == [True]


@pytest.mark.parametrize("device,impl", [("cuda", "flash"), ("cpu", "xla")])
def test_flash_cuda_path_is_primal_only(monkeypatch, tiny_models, device, impl):
    """``--pullback_attn_impl ''`` (the default) takes the fused pair on
    CUDA and the math path on the CPU, as the JAX CLI does on an
    accelerator and on the CPU (checked up to the experiment's config; the
    experiment itself needs the card for CUDA)."""
    from diffusion_pullback_tpu_torch import experiments
    from diffusion_pullback_tpu_torch.utils import device as device_mod

    monkeypatch.setattr(device_mod, "resolve_device",
                        lambda d=None: torch.device(d or "cuda"))
    monkeypatch.setattr(experiments, "EditStableDiffusion",
                        lambda *a, **kw: a[5])  # the SDExperimentConfig
    args = ["--note", "x"] + (["--device", "cpu"] if device == "cpu" else [])
    assert tmain.build_sd(tmain.parse_args(args)).pullback_attn_impl == impl


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
