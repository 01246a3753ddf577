"""Run one cell of the port's benchmark once and print its result as the
last line of standard output (one JSON object).

    python3 port_bench/run.py --workload sd21-base.harvest-r50 --seed 7 \\
        --seconds 10 --trace 0

Run it from the root of a checkout on a machine with the NVIDIA cards the
cell asks for; it exits with an error, printing no result, without them.
With --trace 0 the metrics are the cell's end-to-end ones, with --trace 1
its per-layer ones, read from a torch.profiler trace of the window. Every
build and kernel cache stays inside the checkout; the run's basis files and
log go under a folder of TMPDIR, removed at the end. The result is
withheld, and the exit code is not 0, if the process holds JAX, Flax or
the JAX package once everything else has run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a library the port reaches must not load JAX or Flax on its own
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from port_bench.harness import run_cell, spec

    cell = spec.load_cell(args.workload, ROOT)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    workdir = tempfile.mkdtemp(prefix="port_bench-")
    try:
        result = run_cell.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              workdir, T_START)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return report(result)


def report(result: dict) -> int:
    """Print the result line, unless the process holds a module it must
    not: looked at last, after the reference and the metric readers ran."""
    from port_bench.harness.run_cell import loaded_banned

    banned = loaded_banned()
    if banned:
        print(f"the run loaded {banned}: no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
