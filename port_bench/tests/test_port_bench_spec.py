"""Cells, configurations, traffic mixes and per-layer metrics are found by
name, so a later change adds them as files and entries alone; and the
benchmark's definition keeps to its contract's shape."""

import json
import os
import re
import shutil

import pytest

from port_bench.harness import spec

from conftest import ROOT, TINY_CONFIG, bench_json


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "port_bench"), tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench_json()
    b["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                         "file": "port_bench/configs/tiny.json", "reduced": [],
                         "why": "a configuration added as a file"})
    b["workloads"].append({"name": "tiny.burst", "config": "tiny", "traffic": "burst",
                           "chips": 1, "why": "a cell added as an entry"})
    b["per_layer"].append({"name": "units.burst", "unit": "1", "better": "higher",
                           "source": "program_counter", "layer": "Driver", "moves": "basis_s",
                           "workloads": ["tiny.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "port_bench/configs/tiny.json").write_text(json.dumps(TINY_CONFIG))
    (tmp_path / "port_bench/traffic/burst.json").write_text(json.dumps({"pca_rank": 3}))
    (tmp_path / "port_bench/limits/tiny.burst.json").write_text(
        json.dumps({"sigma": {"limit": 1.0}}))
    (tmp_path / "port_bench/metrics/units.burst.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    cell = spec.load_cell("tiny.burst", str(tmp_path))
    assert cell.config["name"] == "tiny" and cell.traffic == {"pca_rank": 3}
    assert cell.limits == {"sigma": {"limit": 1.0}}
    assert [m["name"] for m in cell.per_layer] == ["units.burst"]
    assert {m["name"] for m in cell.end_to_end} == {"peak_mem_gb", "setup_s"}

    class Run:
        units = 4
    assert spec.metric_reader("units.burst", str(tmp_path))(Run()) == 4.0


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_definition_shape():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    cells = {w["name"]: w for w in b["workloads"]}
    assert all(w["chips"] == 1 for w in cells.values())
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for w in cells:
        cell = spec.load_cell(w, ROOT)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
        assert cell.per_layer and cell.limits
        for m in cell.per_layer:
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
            assert os.path.exists(os.path.join(ROOT, "port_bench/metrics", m["name"] + ".py"))
    for c in b["configs"]:
        f = json.load(open(os.path.join(ROOT, c["file"])))
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"] == []


@pytest.mark.cuda
def test_cell_on_the_card(card):
    """One short run of each cell on the card: a result line that is
    correct."""
    import subprocess
    import sys

    for w in (x["name"] for x in bench_json()["workloads"]):
        p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", w,
                            "--seed", "2147483911", "--seconds", "1"],
                           cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert p.returncode == 0, p.stderr[-3000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
