"""Profiling: stage timers, the first call against a warm one, and
profiler traces (counterpart of diffusion_pullback_tpu/utils/profiling.py).

A trace records the host's torch ops and, on the card, every device kernel
(CUPTI): the flash kernels K1–K5 appear as their custom ops (dpx::flash_fwd,
…) on the host and as their CUDA kernels on the device. It is written as a
Chrome / Perfetto JSON file that chrome://tracing or ui.perfetto.dev opens.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Optional

import torch


def _sync(x: Any) -> None:
    """Wait for the card when ``x`` (a tensor or a pytree of them) holds a
    CUDA tensor: its launches return before the device is done."""
    leaves = torch.utils._pytree.tree_leaves(x)
    devices = {t.device for t in leaves
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


class StageTimer:
    """Named wall-clock stages, summed by name; each logs a ``stage`` event
    with its name and seconds (4 places) when a logger is given."""

    def __init__(self, logger=None):
        self.times: Dict[str, float] = {}
        self.logger = logger

    @contextlib.contextmanager
    def stage(self, name: str, sync: Any = None):
        """Time the block; with ``sync`` (a CUDA tensor, or a pytree with
        one) the time includes the device's work on its card."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            if self.logger is not None:
                self.logger.log("stage", name=name, seconds=round(dt, 4))


def compile_and_run_split(fn: Callable, *args) -> Dict[str, float]:
    """The seconds of a first and a second call of ``fn(*args)``. The port
    runs eagerly, so the first call's extra time is what a process pays
    once: the kernel library's build and load, cuDNN's first-call
    algorithm search, the caching allocator's first blocks."""
    t0 = time.perf_counter()
    _sync(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    _sync(fn(*args))
    run = time.perf_counter() - t0
    return {"compile_plus_run_s": first, "run_s": run,
            "compile_s": max(first - run, 0.0)}


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler over the block, the CPU's ops and, where a card is
    present, its kernels; the trace is written into ``log_dir`` as
    trace-<pid>-<ns>.json. With '' or None nothing is recorded."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
