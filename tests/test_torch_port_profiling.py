"""The port's profiling helpers (diffusion_pullback_tpu_torch/utils/
profiling.py) against the JAX package's (diffusion_pullback_tpu/utils/
profiling.py): StageTimer keeps the same keys, sums and 'stage' events over
the same stages; compile_and_run_split returns the same fields; trace()
around a tiny SD U-Net's ε writes a Chrome trace that names the U-Net's
convolutions and the K1 custom op, and trace('') records nothing. Runs on
the CPU."""

import dataclasses
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401

from diffusion_pullback_tpu.utils import profiling as jprofiling
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.utils import profiling


class Recorder:
    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))


STAGES = ("encode", "pullback", "encode", "decode")


@pytest.mark.parametrize("sync", [False, True], ids=["no sync", "sync"])
def test_stage_timer_keys_sums_and_events_equal_jax(sync):
    timers = {}
    for name, module, value in (("port", profiling, torch.ones(3)),
                                ("jax", jprofiling, jnp.ones(3))):
        logger = Recorder()
        timer = module.StageTimer(logger)
        for stage in STAGES:
            with timer.stage(stage, sync=value if sync else None):
                time.sleep(0.002)
        timers[name] = (timer, logger)
    (mine, mlog), (theirs, jlog) = timers["port"], timers["jax"]
    assert list(mine.times) == list(theirs.times) == ["encode", "pullback", "decode"]
    assert [(e, sorted(f)) for e, f in mlog.events] == [
        (e, sorted(f)) for e, f in jlog.events] == [("stage", ["name", "seconds"])] * 4
    assert [f["name"] for _, f in mlog.events] == list(STAGES)
    for timer, logger in timers.values():
        secs = [f["seconds"] for _, f in logger.events]
        assert all(s == round(s, 4) and s >= 0.002 for s in secs)
        assert timer.times["encode"] == pytest.approx(secs[0] + secs[2], abs=1e-3)
    assert profiling.StageTimer().times == {}


def test_compile_and_run_split_has_the_jax_fields():
    mine = profiling.compile_and_run_split(lambda x: x @ x, torch.ones(8, 8))
    theirs = jprofiling.compile_and_run_split(lambda x: x @ x, jnp.ones((8, 8)))
    assert set(mine) == set(theirs) == {"compile_plus_run_s", "run_s", "compile_s"}
    assert mine["compile_s"] == max(mine["compile_plus_run_s"] - mine["run_s"], 0.0)


def _tiny_eps():
    """ε of a tiny SD U-Net with 'flash' attention over 32² latents: its
    first block self-attends over 1024 tokens through K1."""
    cfg = dataclasses.replace(tmodels.sd_tiny_unet(32), attn_impl="flash")
    unet = tmodels.random_init_(tmodels.UNet2DCondition(cfg), 0).eval().requires_grad_(False)
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.standard_normal((1, 4, 32, 32), np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 5, 16), np.float32))
    return lambda: unet(z, torch.tensor(500.0), ctx)


def test_trace_names_the_convolutions_and_the_k1_op(tmp_path):
    eps = _tiny_eps()
    with torch.no_grad(), profiling.trace(str(tmp_path / "trace")):
        out = eps()
    assert torch.isfinite(out).all()
    (path,) = (tmp_path / "trace").iterdir()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names
    assert "dpx::flash_fwd" in names


def test_empty_trace_dir_records_nothing(tmp_path, monkeypatch):
    import torch.profiler

    def refuse(*a, **k):
        raise AssertionError("a profiler was started")
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.chdir(tmp_path)
    for empty in ("", None):
        with profiling.trace(empty):
            torch.ones(2) @ torch.ones(2)
    assert list(tmp_path.iterdir()) == []
