"""One run of one cell: set-up (weights drawn on the device, the driver
built, every shape warmed up), the measured window, then the output check
and the metrics.

The window opens after warm-up and closes at the end of the first unit
that ends once ``seconds`` have passed, so no unit is cut; a rate is the
units over the window's seconds. With ``trace`` the window runs under
torch.profiler and the per-layer metrics are read from it; without, the
end-to-end metrics. The check runs after the window, once the peak
memory has been read and the program's state freed: one unit drawn from
the seed among those the window finished, recomputed by the reference.
Set-up is timed in its parts as well (``setup_parts_s`` in the result, and
a line on standard error)."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import check, spec, system, trace as trace_mod

BANNED = ("jax", "jaxlib", "flax", "diffusion_pullback_tpu")


def loaded_banned() -> list:
    """Top-level names in sys.modules that the benchmark's process must
    not hold, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


class Run:
    """What a metric reader reads (metrics/<name>.py ``read(run)``)."""

    def __init__(self, cell, device_name, units, window_s, stages, spans, traced,
                 flops_per_unit):
        self.cell, self.device_name, self.units = cell, device_name, units
        self.window_s, self.stages, self.spans = window_s, stages, spans
        self.trace = traced
        self._flops = flops_per_unit

    def flops_per_unit(self) -> float:
        return self._flops()


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str,
        workdir: str, t_start: float) -> dict:
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    parts = {"interpreter": time.perf_counter() - t_start}
    sys_ = system.System(cell.config, cell.traffic, seed, dev, workdir, parts)
    t = time.perf_counter()
    sys_.unit(-1, warm=True)
    sync()
    parts["warm_unit"] = time.perf_counter() - t
    for name, _, _, sec in sys_.spans:
        parts[f"warm_unit.{name}"] = sec
    setup_s = time.perf_counter() - t_start
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()), file=sys.stderr)
    n_warm_stages = len(sys_.stage_events())
    sys_.spans.clear()

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prof = rec = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        rec = trace_mod.FlashRecorder().__enter__()
        prof = profile(activities=[ProfilerActivity.CUDA] if dev.type == "cuda"
                       else [ProfilerActivity.CPU])
        prof.__enter__()
    files, ends, t0 = [], [0.0], time.perf_counter()
    while True:
        files.append(sys_.unit(len(files)))
        sync()
        if time.perf_counter() - t0 >= seconds:
            break
        ends.append(time.perf_counter() - t0)
    window_s = time.perf_counter() - t0
    ends.append(window_s)
    if prof is not None:
        t_stop = time.perf_counter()
        prof.__exit__(None, None, None)
        rec.__exit__(None, None, None)
        print(f"trace: profiler stopped in {time.perf_counter() - t_stop:.1f} s",
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stages = sys_.stage_events()[n_warm_stages:]
    spans = list(sys_.spans)
    sys_.close()
    del sys_

    reduced = None
    if prof is not None:
        t_read = time.perf_counter()
        events = trace_mod.device_events(prof)
        t_red = time.perf_counter()
        reduced = trace_mod.reduce(events, rec.calls, spans, t0)
        print(f"trace: {len(events)} device events read in {t_red - t_read:.1f} s, reduced in "
              f"{time.perf_counter() - t_red:.1f} s", file=sys.stderr)
        for (kernel, shape, dtype), (n, sec) in trace_mod.by_shape(reduced["flash_calls"]):
            print(f"trace: {kernel} {shape} {dtype}: {n} calls, {sec * 1e3:.3f} ms",
                  file=sys.stderr)
        for k, wall, busy in reduced["units"]:
            print(f"trace: unit {k}: {wall:.4f} s, device busy {busy:.4f} s, idle "
                  f"{wall - busy:.4f} s", file=sys.stderr)
        del events
    del prof, rec

    # the output check: one unit drawn from the seed among those finished
    k = int(np.random.default_rng(seed + 1).integers(len(files)))
    got = system.read_basis(files[k])
    ref = check.reference_basis(cell.config, cell.traffic, seed, k, dev)
    numbers = check.basis_numbers(got, ref)
    correct, rows = check.verdict(numbers, cell.limits)

    units = len(files)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out_metrics = {}
    if not traced:
        for m in cell.end_to_end:
            value = {"setup_s": setup_s, "peak_mem_gb": peak / 1e9,
                     "basis_s": window_s / units}.get(m["name"])
            if value is not None:
                out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        from .flops import pullback_flops

        flops = lambda: pullback_flops(cell.config, cell.traffic["pca_rank"],
                                       cell.traffic["pullback_max_iter"])
        r = Run(cell, name, units, window_s, stages, spans, reduced, flops)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], cell.root)(r)
            if value is not None:
                out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct, "attempted": units, "failed": 0, "metrics": out_metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": name,
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if traced:
        result["device"].update(busy_s=reduced["busy_s"], window_s=window_s)
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["unit_s"] = [b - a for a, b in zip(ends, ends[1:])]
    result["setup_parts_s"] = parts
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result
