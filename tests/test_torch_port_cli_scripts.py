"""The port's CLI takes every command line of the JAX CLI. Its parser has
the JAX parser's dests with their defaults, apart from the documented
departures (no --loop_impl, --loop_chunk or --weights_dtype; --model_name
defaults to SD 2.1-base); every command line of the three edit scripts in
scripts/, its loop variables filled in by bash, parses in both packages;
the port's preset copies --sh_file_name's script where the JAX preset
copies it, refuses --use_yh_custom_scheduler False as the JAX preset's
assert does, maps --xsg_pair_impl auto as it does, takes the mesh flags
(--mesh_axes, --attn_impl ring) and takes the tooling flags
--profile_dir and --aot_export into the run. Runs on the CPU; nothing is
built."""

import os
import shutil
import subprocess

import pytest
from torch_port_common import one_torch_thread  # noqa: F401

from diffusion_pullback_tpu.utils.config import build_parser as jbuild_parser
from diffusion_pullback_tpu.utils.config import parse_args as jparse_args
from diffusion_pullback_tpu.utils.config import preset as jpreset
from diffusion_pullback_tpu_torch import main as tmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("main_celeba_hf_local_encoder_pullback.sh",
           "main_various_local_encoder_pullback_with_edit_prompt.sh",
           "main_various_local_encoder_pullback_without_edit_prompt.sh")
DEPARTURES = {"loop_impl", "loop_chunk", "weights_dtype"}


def script_argvs(name):
    """The argument lists each ``python main.py …`` of scripts/<name> runs,
    its loops expanded by bash with ``python`` a function that prints its
    arguments."""
    out = subprocess.run(
        ["bash", "-c", 'python() { shift; printf "%s\\0" "$@"; printf "\\n\\0"; }; '
                       f'source "scripts/{name}"'],
        cwd=REPO, capture_output=True, text=True, check=True).stdout
    argvs, argv = [], []
    for arg in out.split("\0")[:-1]:
        if arg == "\n":
            argvs.append(argv)
            argv = []
        else:
            argv.append(arg)
    return argvs


def test_parsers_have_the_same_dests_and_defaults():
    theirs = {a.dest: a for a in jbuild_parser()._actions}
    mine = {a.dest: a for a in tmain.build_parser()._actions}
    assert set(mine) == set(theirs) - DEPARTURES
    differ = {d for d in mine if mine[d].default != theirs[d].default}
    assert differ == {"model_name"}
    assert mine["model_name"].default == tmain.SD_MODEL
    for d in mine:
        assert getattr(mine[d].type, "__name__", None) == getattr(
            theirs[d].type, "__name__", None), d


@pytest.mark.parametrize("name", SCRIPTS)
def test_every_command_line_of_the_scripts_parses_in_both(name):
    argvs = script_argvs(name)
    assert len(argvs) == {SCRIPTS[0]: 15, SCRIPTS[1]: 4, SCRIPTS[2]: 8}[name]
    for argv in argvs:
        mine, theirs = tmain.parse_args(argv), jparse_args(argv)
        assert mine.sh_file_name == name
        for dest, value in vars(mine).items():
            assert value == getattr(theirs, dest), (argv, dest)


def _presets_copy(argv, folder, preset, parse):
    """Run ``preset`` on argv in ``folder`` (which holds scripts/ and
    nothing else) and return the files under it that hold the script."""
    os.makedirs(folder / "scripts")
    for name in SCRIPTS:
        shutil.copy(os.path.join(REPO, "scripts", name), folder / "scripts")
    os.chdir(folder)
    preset(parse(argv))
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, files in os.walk(folder / "runs") for f in files
                  if f.endswith(".sh"))


@pytest.mark.parametrize("name", [SCRIPTS[0], SCRIPTS[2]])
def test_sh_file_name_is_copied_where_the_jax_preset_copies_it(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = script_argvs(name)[0]
    mine = _presets_copy(argv, tmp_path / "port", tmain.check_preset, tmain.parse_args)
    theirs = _presets_copy(argv, tmp_path / "jax", jpreset, jparse_args)
    assert mine == theirs == [os.path.join(
        "runs", os.path.basename(tmain.experiment_folders(tmain.parse_args(argv))[0]),
        name)]
    with open(tmp_path / "port" / mine[0]) as f, open(os.path.join(REPO, "scripts", name)) as g:
        assert f.read() == g.read()


def test_custom_scheduler_off_fails_in_both(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = script_argvs(SCRIPTS[0])[0] + ["--use_yh_custom_scheduler", "False"]
    with pytest.raises(ValueError, match="use_yh_custom_scheduler"):
        tmain.check_preset(tmain.parse_args(argv))
    with pytest.raises(AssertionError):
        jpreset(jparse_args(argv))


@pytest.mark.parametrize("model", [tmain.SD_MODEL, tmain.SDXL_MODEL, "CelebA_HQ_HF",
                                   "ImageNet256Uncond"])
def test_xsg_pair_impl_auto_maps_as_the_jax_preset(model, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    boost = [] if "stable-diffusion" in model else ["--performance_boosting_t", "0.2"]
    argv = ["--note", "x", "--model_name", model] + boost
    assert tmain.xsg_pair_impl(tmain.parse_args(argv)) == jpreset(
        jparse_args(argv)).xsg_pair_impl
    for impl in ("batch", "split"):
        assert tmain.xsg_pair_impl(tmain.parse_args(argv + ["--xsg_pair_impl", impl])) == impl


@pytest.mark.parametrize("flag, value, item", [
    ("mesh_axes", "dp:2,probe:4", 16), ("attn_impl", "ring", 16)])
def test_flags_of_open_items_raise_naming_the_item(flag, value, item, tmp_path, monkeypatch,
                                                   capsys):
    """The flags once refused naming item 16 are ported: the preset takes
    them, and at one rank --mesh_axes prints the JAX CLI's single-chip line
    and builds no mesh."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = tmain.parse_args(["--note", "x", f"--{flag}", value])
    tmain.check_preset(args)
    assert getattr(args, flag) == value
    assert tmain.build_mesh(args) is None
    if flag == "mesh_axes":
        assert tmain.mesh_spec(value) == (("dp", "probe"), {"dp": 2, "probe": 4})
        assert ("--mesh_axes given but only 1 device visible; running single-chip"
                in capsys.readouterr().out)
    assert not os.path.exists(tmp_path / "runs")


@pytest.mark.parametrize("flag, value", [
    ("profile_dir", "trace"), ("aot_export", "on"), ("aot_export", "off")])
def test_tooling_flags_are_accepted_and_reach_the_run(flag, value, tmp_path, monkeypatch):
    """--profile_dir and --aot_export (ROADMAP queue 1, item 17) on a tiny
    CLI run (adm_tiny(16) in place of ImageNet256Uncond, run_ddim_forward):
    the profiler's trace of the run lands in the folder; the driver takes
    the export mode, and 'on' stores the per-step ε program (in a folder
    of the test's), 'off' runs it eagerly."""
    import json

    from diffusion_pullback_tpu_torch import models as tmodels
    from diffusion_pullback_tpu_torch.utils import aot

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmodels, "model_for_name", lambda name, dtype="float32",
                        attn_impl="": tmodels.UNetADM(tmodels.adm_tiny(16)))
    monkeypatch.setattr(aot, "default_export_dir", lambda: str(tmp_path / "exports"))
    argv = ["--note", "x", "--device", "cpu", "--model_name", "ImageNet256Uncond",
            "--performance_boosting_t", "0.2", "--run_ddim_forward", "True",
            f"--{flag}", value]
    edit = tmain.main(argv)
    assert "DDIMforward.png" in os.listdir(edit.cfg.result_folder)
    with open(edit.log.path) as f:
        programs = [(e["name"], e["status"]) for e in map(json.loads, f)
                    if e["event"] == "aot_program"]
    if flag == "profile_dir":
        (trace,) = os.listdir(tmp_path / "trace")
        with open(tmp_path / "trace" / trace) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "aten::convolution" in names
        assert programs == [("eps", "eager")]   # --aot_export auto: eager
        return
    assert edit.cfg.aot_export == value
    assert programs == [("eps", "exported" if value == "on" else "eager")]
    assert os.path.isdir(tmp_path / "exports") == (value == "on")


def test_debug_nans_runs_build_and_dispatch_under_anomaly_detection(monkeypatch):
    """--debug_nans True wraps the run in torch.autograd.detect_anomaly with
    its NaN check (the backward ops raise at the first NaN they make)."""
    import torch

    seen = []
    monkeypatch.setattr(tmain, "build_sd", lambda args: torch.is_anomaly_enabled())
    monkeypatch.setattr(tmain, "dispatch", lambda edit, args: seen.append(
        (edit, torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())))
    for flag in ("False", "True"):
        tmain.main(["--note", "x", "--debug_nans", flag])
    assert seen == [(False, False, True), (True, True, True)]
    assert not torch.is_anomaly_enabled()
