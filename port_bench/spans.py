"""Where a cell's traced window goes, by the program's spans: each span's
host seconds, the host's seconds in it waiting on the card, the
device-busy seconds, operations and idle seconds it launched, a basis, joined through each operation's launch record
(``harness/join.py``). A tool beside the benchmark, not one of its runs:

    python3 port_bench/spans.py --workload sd21-base.harvest-r50 --seed 7 \\
        --seconds 20

Set-up and the traced window are the benchmark's (``harness/run_cell.py``):
the same System, warm unit and CUDA-only profiler. Prints the table, then,
as the last line, all of it with the checks of the join as one JSON
object.
"""

import argparse
import collections
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PASSES = ("tangent", "final_tangent", "vjp_primal", "cotangent")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffusion_pullback_tpu_torch.utils.profiling import take_spans
    from port_bench.harness import join, spec, system, trace

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = spec.load_cell(args.workload, ROOT)
    dev = torch.device("cuda")
    workdir = tempfile.mkdtemp(prefix="port_bench-")
    try:
        sys_ = system.System(cell.config, cell.traffic, args.seed, dev, workdir)
        sys_.unit(-1, warm=True)
        torch.cuda.synchronize(dev)
        sys_.spans.clear()
        rec = trace.FlashRecorder().__enter__()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        t0, t0_unix = time.perf_counter(), time.time_ns()
        units = 0
        while True:
            sys_.unit(units)
            units += 1
            torch.cuda.synchronize(dev)
            if time.perf_counter() - t0 >= args.seconds:
                break
        window_s = time.perf_counter() - t0
        prof.__exit__(None, None, None)
        rec.__exit__(None, None, None)
        sys_.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    spans = take_spans()
    reduced = trace.reduce(trace.device_events(prof), rec.calls, sys_.spans, t0)
    ops, launches = join.trace_records(prof)
    j = join.join(ops, launches, spans)
    owner_at = join.innermost(spans)
    calls = runtime_calls(prof, owner_at)
    waits = join.host_waits(prof.profiler.kineto_results.events(), owner_at)
    base = prof.profiler.kineto_results.trace_start_ns()
    del prof

    host = collections.Counter()
    names = join.paths(spans)
    for s in spans:
        host[names[s.id]] += (s.end_ns - s.start_ns) * 1e-9
    owners = sorted(set(host) | set(waits) | set(j["busy"]), key=lambda o: -j["busy"].get(o, 0.0))
    rows = [(o, host.get(o, 0.0) / units, waits.get(o, 0.0) / units,
             j["busy"].get(o, 0.0) / units, j["ops"].get(o, 0) / units,
             j["idle"].get(o, 0.0) / units) for o in owners]
    k3 = [(s, cid) for s, _, name, cid in ops if trace.short_name(name).startswith("flash_tangent")]
    k3_in = sum(owner_at(launches[c]).split("/")[-1] in ("tangent", "final_tangent")
                for _, c in k3 if c in launches)
    out = {
        "workload": args.workload, "seed": args.seed, "units": units, "window_s": window_s,
        "device": torch.cuda.get_device_name(dev), "torch": torch.__version__,
        "busy_s": reduced["busy_s"], "join_busy_s": j["busy_s"],
        "unpaired_share": j["busy"].get(join.UNPAIRED, 0.0) / j["busy_s"],
        "ops": len(ops), "launch_records": len(launches),
        "k3_launches": len(k3), "k3_launched_in_tangent": k3_in,
        # where the harness places perf_counter's t0 (at trace µs 0) against
        # where it lies on the trace's clock
        "t0_offset_us": (t0_unix - base) / 1e3,
        "metrics": {
            "tangent_device_s": join.leaf_sum(j["busy"], PASSES[:2]) / units,
            "cotangent_device_s": join.leaf_sum(j["busy"], PASSES[2:]) / units,
            "pass_idle_s": join.leaf_sum(j["idle"], PASSES) / units,
            "host_wait_s": sum(w for o, w in waits.items() if o != join.OUTSIDE) / units,
            "flash_host_us": join.root_growth(spans, "flash_host_ns")
            / max(join.root_growth(spans, "flash_launches"), 1) / 1e3,
            "device_s": sum(b for *_, b in reduced["units"]) / len(reduced["units"]),
        },
        "per_basis": [{"span": o, "host_s": h, "wait_s": w, "busy_s": b, "ops": n,
                       "idle_s": i} for o, h, w, b, n, i in rows],
        "gaps": j["gaps"].most_common(15),
        "benchmark_gaps": reduced["idle_gaps"],
        "runtime_calls": calls,
    }
    print(f"{args.workload} seed {args.seed}: {units} units in {window_s:.2f} s on "
          f"{out['device']}, torch {out['torch']}")
    print(f"{'span':48s} {'host s':>9s} {'wait s':>9s} {'busy s':>9s} {'ops':>8s} "
          f"{'idle s':>9s}  (a basis)")
    for o, h, w, b, n, i in rows:
        print(f"{o[:48]:48s} {h:9.4f} {w:9.4f} {b:9.4f} {n:8.1f} {i:9.4f}")
    for key in ("busy_s", "join_busy_s", "unpaired_share", "ops", "launch_records",
                "k3_launches", "k3_launched_in_tangent", "t0_offset_us", "metrics"):
        print(f"{key}: {out[key]}")
    for gap, sec in out["gaps"]:
        print(f"gap {sec:9.4f} s  {gap}")
    print(json.dumps(out))
    return 0


def runtime_calls(prof, owner_at) -> list:
    """(owner, runtime or driver call, calls, host seconds) of the window's
    launch-side calls, most time first: where the host waits for the card
    (synchronisations, blocking copies) shows here."""
    from port_bench.harness.join import is_api_call

    acc = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.profiler.kineto_results.events():
        if is_api_call(e):
            a = acc[(owner_at(e.start_ns()), e.name())]
            a[0] += 1
            a[1] += (e.end_ns() - e.start_ns()) * 1e-9
    return sorted(([o, n, c, s] for (o, n), (c, s) in acc.items()), key=lambda r: -r[3])[:30]


if __name__ == "__main__":
    sys.exit(main())
