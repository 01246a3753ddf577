"""The traced window: a torch.profiler trace of the device alone (CUDA
activity; recording the host's ops too slowed a unit about fivefold and
recording their shapes held their tensors until the card ran out of
memory), the flash kernel calls recorded where the program calls its ops,
and the benchmark's own spans.

The reduction gives the seconds in which an operation ran on the device,
the device operations that took most time, the idle gaps by what the host
was doing (the benchmark's span, and the device operation the gap waited
for), and each flash kernel call (K1–K5) with its shapes, dtype and device
time: the op calls, in order, paired with the flash kernel launches, in
order, each call's kernel taken from the op it called."""

from __future__ import annotations

import collections
import re

import numpy as np
import torch

from .flops import BATCHED_ARG as BATCHED, FLASH_OPS


def is_flash_launch(name: str) -> bool:
    """Whether a device kernel is one of the program's flash kernels
    (K1–K5, any design): its function name starts with ``flash_`` and it
    is not one of PyTorch's own attention kernels."""
    return "pytorch" not in name and short_name(name).startswith("flash_")


def short_name(name: str) -> str:
    """A kernel's function name without namespaces, template arguments or
    parameters."""
    base = name.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    return re.sub(r"<.*", "", base).split("(")[0].split("::")[-1][:80]


class FlashRecorder:
    """While entered, records every call of the flash ops (kernel, argument
    shapes, dtype) at the op boundary the program calls (torch.ops.dpx)."""

    def __init__(self):
        self.calls = []
        self._orig = {}

    def __enter__(self):
        ns = torch.ops.dpx
        for op, (kernel, _) in FLASH_OPS.items():
            sym = op.split("::")[1]
            self._orig[sym] = getattr(ns, sym)
            setattr(ns, sym, self._wrap(kernel, self._orig[sym]))
        return self

    def _wrap(self, kernel, orig):
        calls = self.calls

        def call(*args):
            calls.append((kernel, [list(a.shape) if isinstance(a, torch.Tensor) else []
                                   for a in args], str(args[0].dtype).split(".")[-1]))
            return orig(*args)

        return call

    def __exit__(self, *exc):
        for sym, orig in self._orig.items():
            setattr(torch.ops.dpx, sym, orig)


def device_events(prof) -> list:
    """(start µs, end µs, name) of every device operation of a stopped
    profiler, from the trace's start, read from its raw events (building
    the profiler's event tree costs minutes at a window's size)."""
    res = prof.profiler.kineto_results
    base = res.trace_start_ns()
    return sorted(((e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3, e.name())
                  for e in res.events() if e.device_type().name == "CUDA")


def reduce(dev, calls, spans, t0) -> dict:
    """``dev``: ``device_events``; ``calls``: a FlashRecorder's; ``spans``:
    (name, unit, start, seconds) on the host's perf_counter, ``t0`` the
    profiler's start on it."""
    merged = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t, _])
    busy = sum(t - s for s, t, _ in merged) * 1e-6
    by_op = collections.Counter()
    for s, t, name in dev:
        by_op[short_name(name)] += (t - s) * 1e-6
    # a gap is labelled by the benchmark's span around it and the device
    # operation that ended it
    marks = sorted(((st - t0) * 1e6, (st + sec - t0) * 1e6, name) for name, _, st, sec in spans)
    by_host = collections.Counter()
    for a, b in zip(merged, merged[1:]):
        mid = (a[1] + b[0]) / 2
        span = next((n for s, e, n in marks if s <= mid <= e), "between spans")
        by_host[f"{span}, before {short_name(b[2])}"] += (b[0] - a[1]) * 1e-6
    # each call of a flash op launches one kernel, in order on one stream;
    # without a device trace (a run on the CPU) there is nothing to pair
    flash = None
    if dev:
        launches = [(t - s) * 1e-6 for s, t, name in dev if is_flash_launch(name)]
        if len(launches) != len(calls):
            raise RuntimeError(f"{len(calls)} flash op calls but {len(launches)} flash "
                               "kernel launches in the trace")
        flash = [(k, shapes, dtype, sec) for (k, shapes, dtype), sec in zip(calls, launches)]
    return {"busy_s": busy, "device_ops": by_op.most_common(10),
            "idle_gaps": by_host.most_common(10), "flash_calls": flash,
            "units": unit_busy(merged, spans, t0)}


def unit_busy(merged, spans, t0) -> list:
    """(unit, wall seconds, device-busy seconds) of each unit of the window,
    a unit running from its first span's start to its last span's end."""
    bounds = {}
    for _, k, st, sec in spans:
        a, b = bounds.get(k, (st, st + sec))
        bounds[k] = (min(a, st), max(b, st + sec))
    starts = np.array([m[0] for m in merged], dtype=np.float64)
    ends = np.array([m[1] for m in merged], dtype=np.float64)
    out = []
    for k, (a, b) in sorted(bounds.items()):
        lo, hi = (a - t0) * 1e6, (b - t0) * 1e6
        busy = np.clip(np.minimum(ends, hi) - np.maximum(starts, lo), 0.0, None).sum()
        out.append((k, b - a, float(busy) * 1e-6))
    return out


def by_shape(flash) -> list:
    """((kernel, (B·H of the tangents or cotangent, Sq, D), dtype), (calls,
    device seconds)) of paired flash calls, most time first."""
    out = collections.defaultdict(lambda: [0, 0.0])
    for kernel, shapes, dtype, sec in flash or []:
        key = (kernel, (shapes[BATCHED[kernel]][0], shapes[0][1], shapes[0][2]), dtype)
        out[key][0] += 1
        out[key][1] += sec
    return sorted(out.items(), key=lambda kv: -kv[1][1])
