"""Guards of the port: it imports neither JAX nor the JAX package, its entry
points refuse to run without CUDA unless given the CPU, the fused-pair
pullback (ROADMAP slice 2) raises, and chip_smoke.py fails without a card."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from diffusion_pullback_tpu_torch import main as tmain
from diffusion_pullback_tpu_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "diffusion_pullback_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "diffusion_pullback_tpu"}


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


def test_pullback_flash_raises_naming_slice_2():
    with pytest.raises(NotImplementedError, match="slice 2"):
        tmain.main(["--note", "x", "--device", "cpu", "--pullback_attn_impl",
                    "flash", "--run_edit_local_encoder_pullback_zt", "True"])


def test_flash_cuda_path_is_primal_only():
    """The kernel's autograd node raises on every derivative (checked here
    through its rules; the launch itself needs the card)."""
    from diffusion_pullback_tpu_torch.ops.flash_attention import _FlashForwardCUDA

    for rule in (lambda: _FlashForwardCUDA.backward(None, None),
                 lambda: _FlashForwardCUDA.jvp(None, None, None, None),
                 lambda: _FlashForwardCUDA.vmap(None, None)):
        with pytest.raises(NotImplementedError, match="slice 2"):
            rule()


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
