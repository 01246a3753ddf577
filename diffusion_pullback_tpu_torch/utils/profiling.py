"""Profiling: the program's spans and counters, and profiler traces
(counterpart of diffusion_pullback_tpu/utils/profiling.py).

A trace records the host's torch ops and, on the card, every device kernel
(CUPTI): the flash kernels K1–K5 appear as their custom ops (dpx::flash_fwd,
…) on the host and as their CUDA kernels on the device, and each span of the
program (below) as a user annotation of its name. It is written as a
Chrome / Perfetto JSON file that chrome://tracing or ui.perfetto.dev opens.

Spans mark the program's own phases: a driver's stage, a pass of the power
iteration, a basis write. ``span(name, **fields)`` records only while a
torch.profiler session is active; with none it costs one check of a flag.
A recorded span holds its name, its id, the id of the span it opened in
(``parent``) and of the outermost one (``root``: every span of one driver
stage, so of one basis, shares it), its start and end, its fields, and the
growth over it of each registered counter (``counter``). Its stamps are
``time.time_ns()``, the clock the profiler stamps its events on (Unix ns),
so a span and a device operation's launch compare without an offset. Spans
time the host and never wait for the device: a span around launches ends
when they are queued. ``take_spans()`` hands over the finished spans of the
calling process and forgets them; spans are meant for one thread, the one
that runs the driver.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class Span(NamedTuple):
    """One recorded span; ``start_ns`` and ``end_ns`` in Unix ns."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: int
    fields: dict
    counters: dict   # counter name → its growth from the span's start to its end


_finished: List[Span] = []
_open: List[tuple] = []       # (id, root) of the open recorded spans, innermost last
_ids = itertools.count(1)
_counters: Dict[str, Callable[[], int]] = {}
_OFF = contextlib.nullcontext()


def span(name: str, **fields):
    """Context manager marking a phase of the program as span ``name`` with
    ``fields``, recorded while a profiler session is active (torch's own
    flag, set while any torch.profiler or autograd profiler runs)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recorded(name, fields)


class _Recorded:
    __slots__ = ("name", "fields", "id", "parent", "root", "marks", "start", "annotation")

    def __init__(self, name, fields):
        self.name, self.fields = name, fields

    def __enter__(self):
        self.id = next(_ids)
        self.parent, self.root = _open[-1] if _open else (None, self.id)
        _open.append((self.id, self.root))
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        self.marks = {n: read() for n, read in _counters.items()}
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        grown = {n: read() - self.marks[n] for n, read in _counters.items()}
        self.annotation.__exit__(*exc)
        _open.pop()
        _finished.append(Span(self.name, self.id, self.parent, self.root, self.start,
                              end, self.fields, grown))
        return False


def take_spans() -> List[Span]:
    """The spans finished since the last call, in the order they ended."""
    out = list(_finished)
    _finished.clear()
    return out


def counter(name: str, read: Callable[[], int]) -> None:
    """Register ``read``, the running total of a counter the program keeps
    (it only grows), so each recorded span holds its growth under
    ``name``."""
    _counters[name] = read


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
