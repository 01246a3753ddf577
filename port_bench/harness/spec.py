"""What a cell is made of, found by name: the workload's entry in
BENCHMARK.json, its configuration file, its traffic file
(``traffic/<name>.json``), the limits of its output check
(``limits/<workload>.json``) and the readers of its per-layer metrics
(``metrics/<metric>.py``). A new cell, configuration, traffic mix or metric
is a new file and a new entry; no code here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = "port_bench"


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict
    root: str = ROOT


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    applies = lambda m: name in m.get("workloads", [name])
    here = os.path.join(root, BENCH)
    limits_path = os.path.join(here, "limits", name + ".json")
    return Cell(
        workload=w,
        config=_load_json(os.path.join(root, conf["file"])),
        traffic=_load_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        limits=_load_json(limits_path) if os.path.exists(limits_path) else {},
        root=root,
    )


def metric_reader(name: str, root: str = ROOT):
    """``read(run)`` of metrics/<name>.py."""
    path = os.path.join(root, BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("port_bench_metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
