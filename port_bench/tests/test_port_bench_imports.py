"""What the benchmark's process loads: no module whose top-level name is
jax, jaxlib, flax or the JAX package (names compared whole: the port's
name begins with the JAX package's), and the reference alone loads
nothing of the port."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, TINY_CONFIG

_HARNESS = """
import json, sys, time, tempfile
sys.path.insert(0, {root!r})
import torch
from port_bench.harness import run_cell, spec
real = spec.load_cell("sd21-base.harvest-r50", {root!r})
cfg = json.loads({cfg!r})
cell = spec.Cell(real.workload, cfg, dict(real.traffic, pca_rank=2, probe_chunk=2),
                 real.end_to_end, real.per_layer, real.limits)
run_cell.run(cell, 1, 0.0, True, "cpu", tempfile.mkdtemp(), time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from port_bench.harness import check
from port_bench.reference import arith, pullback, unet
cfg = json.loads({cfg!r})
traffic = dict(pca_rank=2, pullback_min_iter=1, pullback_max_iter=2, pullback_atol=0.0,
               probe_chunk=2, t_grid=[0.5], for_steps=10)
check.reference_basis(cfg, traffic, 1, 0, "cpu", "fp8")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(script):
    code = script.format(root=ROOT, cfg=json.dumps(TINY_CONFIG))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_level(_HARNESS)
    assert "diffusion_pullback_tpu_torch" in names   # the port did run
    assert not names & {"jax", "jaxlib", "flax", "diffusion_pullback_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    names = _top_level(_REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "diffusion_pullback_tpu",
                        "diffusion_pullback_tpu_torch"}


_REPORT = """
import json, sys, time, tempfile
sys.path.insert(0, {root!r})
import torch
from port_bench import run as entry
from port_bench.harness import run_cell, spec
real = spec.load_cell("sd21-base.harvest-r50", {copy!r})
cfg = json.loads({cfg!r})
cell = spec.Cell(real.workload, cfg, dict(real.traffic, pca_rank=2, probe_chunk=2),
                 real.end_to_end, real.per_layer, real.limits, root={copy!r})
result = run_cell.run(cell, 1, 0.0, True, "cpu", tempfile.mkdtemp(), time.perf_counter())
sys.exit(entry.report(result))
"""


@pytest.mark.parametrize("reader_imports", [None, "diffusion_pullback_tpu"])
def test_result_is_withheld_when_a_late_step_loads_jax(tmp_path, reader_imports):
    """The look at sys.modules comes after the reference and the metric
    readers: a reader that loads the JAX package leaves no result line."""
    shutil.copytree(os.path.join(ROOT, "port_bench"), tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    if reader_imports:
        reader = tmp_path / "port_bench/metrics/mfu.harvest.py"
        reader.write_text(f"import {reader_imports}\n" + reader.read_text())
    code = _REPORT.format(root=ROOT, copy=str(tmp_path), cfg=json.dumps(TINY_CONFIG))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    if reader_imports:
        assert p.returncode != 0 and p.stdout.strip() == "", p.stderr[-3000:]
        assert reader_imports in p.stderr
    else:
        assert p.returncode == 0, p.stderr[-3000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
