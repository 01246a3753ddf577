"""A cell end to end on the CPU at tiny widths: the result line the
contract asks for, units that each compute a pullback, the output check
failing where the timed path is broken, and the entry point refusing to
run without a card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from port_bench.harness import run_cell, system

from conftest import ROOT


def _run(cell, tmp_path, traced=False, seconds=0.0, seed=2 ** 31 + 99):
    return run_cell.run(cell, seed, seconds, traced, "cpu", str(tmp_path), time.perf_counter())


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(tiny_cell, tmp_path, traced):
    r = _run(tiny_cell, tmp_path, traced)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"sigma", "v_subspace", "u_subspace"}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    names = {m["name"]: m["unit"] for m in tiny_cell.per_layer if traced} or \
        {m["name"]: m["unit"] for m in tiny_cell.end_to_end}
    for name, m in r["metrics"].items():
        assert names[name] == m["unit"] and m["value"] >= 0
    if traced:   # no device: the trace's readers find nothing to read
        assert {"pullback_s.harvest", "save_s.harvest"} <= set(r["metrics"])
        assert "idle_share.harvest" not in r["metrics"]
        assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r
    else:
        assert set(r["metrics"]) == {"basis_s", "peak_mem_gb", "setup_s"}
    json.dumps(r)


def test_each_unit_computes_a_pullback(tiny_cell, tmp_path):
    sys_ = system.System(tiny_cell.config, tiny_cell.traffic, 3, "cpu", str(tmp_path))
    files = [sys_.unit(0), sys_.unit(1)]
    events = sys_.stage_events()
    pulls = [e for e in events if e["event"] == "sd_local_pullback"]
    assert len(pulls) == 2 and all(e["iterations"] == 12 for e in pulls)
    assert not [e for e in events if "cache" in e["event"]]
    assert files[0] != files[1] and all(os.path.exists(f) for f in files)
    a, b = (system.read_basis(f) for f in files)
    assert not (a[1] == b[1]).all()
    assert system.unit_t(tiny_cell.traffic, 3, 0) != system.unit_t(tiny_cell.traffic, 3, 1)


def test_another_entry_is_refused(tiny_cell, tmp_path):
    """A traffic file naming an entry that System.unit does not run is
    refused, not timed as a harvest."""
    with pytest.raises(ValueError, match="entry"):
        system.System(tiny_cell.config, dict(tiny_cell.traffic, entry="edit"), 3, "cpu",
                      str(tmp_path))


def _unchanged(monkeypatch):
    """The power iteration returns its state unchanged (no iteration)."""
    from diffusion_pullback_tpu_torch.geometry import pullback

    orig = pullback._power_iteration
    monkeypatch.setattr(pullback, "_power_iteration",
                        lambda fwd, bwd, v, mn, mx, *a, **k: orig(fwd, bwd, v, mn, 0, *a, **k))


def _half_batch(monkeypatch):
    """Each pass computes half of the probes and repeats them for the rest."""
    from diffusion_pullback_tpu_torch.geometry import pullback

    orig = pullback._batched

    def half(fn, chunk, rank, axis=0):
        f = orig(fn, chunk, rank, axis)

        def g(batch):
            n = batch.shape[axis]
            out = f(batch.narrow(axis, 0, (n + 1) // 2))
            return torch.cat([out, out], dim=axis).narrow(axis, 0, n)
        return g

    monkeypatch.setattr(pullback, "_batched", half)


def _altered_answer(monkeypatch):
    """The basis is altered where it is written: σ one percent high."""
    from diffusion_pullback_tpu_torch.experiments._common import DriverCommonMixin

    orig = DriverCommonMixin._save_basis

    def save(self, name, res):
        return orig(self, name, res._replace(s=res.s * 1.01))

    monkeypatch.setattr(DriverCommonMixin, "_save_basis", save)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_answer])
def test_broken_timed_path_is_not_correct(tiny_cell, tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(tiny_cell, tmp_path)
    assert r["correct"] is False, r["checks"]


def test_entry_point_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "sd21-base.harvest-r50", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
