"""The program's spans (``diffusion_pullback_tpu_torch/utils/profiling.py``)
joined with the traced window's device operations.

The program stamps its spans on the clock of the profiler's events (Unix
ns), so the launch record of a device operation (the runtime or driver call
that started it: cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel for
cuBLAS and cuSOLVER, …; found by the correlation id it shares with the
operation) lies among the spans without an offset. An operation belongs to
the innermost span that holds its launch's start, or to none (``OUTSIDE``);
one without a launch record is ``UNPAIRED``. An idle gap of the device
belongs where the operation that ended it belongs. Busy seconds are the
union of the operations' intervals, each instant given to the operation
that started first, so the owners' busy seconds add up to the window's.

A span is named by its path from its root (``sd_local_pullback/tangent``).
"""

from __future__ import annotations

import bisect
import collections

from .trace import short_name

UNPAIRED = "unpaired"
OUTSIDE = "outside program spans"


def window_spans(run):
    """The program's spans of ``run``'s traced window (recorded only while
    the profiler ran), taken from the program once and kept on ``run`` for
    every reader; None where the program records no spans."""
    if not hasattr(run, "program_spans"):
        try:
            from diffusion_pullback_tpu_torch.utils.profiling import take_spans
        except ImportError:
            take_spans = None
        run.program_spans = take_spans() if take_spans else None
    return run.program_spans


def root_growth(spans, counter: str) -> int:
    """Growth of a program counter over the root spans."""
    return sum(s.counters.get(counter, 0) for s in spans if s.parent is None)


def is_api_call(e) -> bool:
    """Whether a host-side trace event is a call of the CUDA runtime or
    driver (cuda*, cu*), the kind that launches device work. The loader's
    events that share a call's correlation id ("Lazy Function Loading")
    and the host's torch ops are not."""
    return e.device_type().name == "CPU" and e.name().startswith("cu")


def trace_records(prof):
    """(ops, launches) of a stopped profiler: ``ops`` (start ns, end ns,
    name, correlation id) of every device operation, ``launches``
    correlation id → start ns of the call that launched it."""
    ops, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA":
            ops.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
        elif is_api_call(e):
            launches.setdefault(e.correlation_id(), e.start_ns())
    return ops, launches


def host_waits(events, owner_at) -> collections.Counter:
    """Host seconds by owner (``owner_at`` of the call's start, as
    ``innermost`` gives it) in the runtime or driver calls that wait for the
    card: the synchronisations (``*Synchronize``) and the calls that launched
    a copy between host and device, which, from or to pageable memory,
    return only once the stream before them has drained (``.item()``,
    ``.cpu()``, cuSOLVER's reads of its results). ``events`` are a stopped
    profiler's ``kineto_results.events()``."""
    host_copies = {e.correlation_id() for e in events if e.device_type().name == "CUDA"
                   and ("DtoH" in e.name() or "HtoD" in e.name())}
    waits, seen = collections.Counter(), set()
    for e in events:
        cid = e.correlation_id()
        if not is_api_call(e):
            continue
        if "Synchronize" in e.name() or (cid in host_copies and cid not in seen):
            seen.add(cid)   # a copy's first call, as in trace_records
            waits[owner_at(e.start_ns())] += (e.end_ns() - e.start_ns()) * 1e-9
    return waits


def paths(spans) -> dict:
    """span id → its path of names from its root."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in sorted(spans, key=lambda s: s.id):   # a parent opens before its children
        out[s.id] = s.name if s.parent not in by_id else f"{out[s.parent]}/{s.name}"
    return out


def innermost(spans):
    """A function of a time (ns) → the path of the innermost span holding it,
    or OUTSIDE. The spans nest (they come from one thread's stack)."""
    names = paths(spans)
    bounds, owners, stack = [], [], []

    def close_before(t):
        while stack and stack[-1].end_ns <= t:
            done = stack.pop()
            bounds.append(done.end_ns)
            owners.append(names[stack[-1].id] if stack else OUTSIDE)

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        close_before(s.start_ns)
        bounds.append(s.start_ns)
        owners.append(names[s.id])
        stack.append(s)
    close_before(float("inf"))

    def owner(t):
        i = bisect.bisect_right(bounds, t) - 1
        return owners[i] if i >= 0 else OUTSIDE
    return owner


def join(ops, launches, spans) -> dict:
    """Device-busy seconds, operations and idle seconds by owner (a span's
    path, OUTSIDE or UNPAIRED), and the idle gaps by owner and the
    operation that ended them. ``ops`` and ``launches`` as
    ``trace_records`` gives them."""
    owner_at = innermost(spans)
    busy, count, idle, gaps = (collections.Counter() for _ in range(4))
    end = None
    for start, stop, name, cid in sorted(ops):
        t = launches.get(cid)
        who = UNPAIRED if t is None else owner_at(t)
        count[who] += 1
        if end is None or start > end:
            if end is not None:
                idle[who] += (start - end) * 1e-9
                gaps[f"{who}, before {short_name(name)}"] += (start - end) * 1e-9
            busy[who] += (stop - start) * 1e-9
            end = stop
        elif stop > end:
            busy[who] += (stop - end) * 1e-9
            end = stop
    return {"busy_s": sum(busy.values()), "busy": busy, "ops": count, "idle": idle,
            "gaps": gaps}


def leaf_sum(by_owner, names) -> float:
    """The sum over owners whose last span is one of ``names``."""
    return sum(v for who, v in by_owner.items() if who.split("/")[-1] in names)
