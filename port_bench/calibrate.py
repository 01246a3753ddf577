"""The readings the output check's limits are set from, on the card, for one
cell: the program's numbers against the reference over many seeds (sound
runs), and the control's, the reference computed in the format below the
configuration's (fp8 for a bfloat16 U-Net), in the program's place.

    python3 port_bench/calibrate.py --workload sd21-base.harvest-r50 \\
        --seeds 12 --control 3 --first-seed 1000 --out calib.jsonl

Each seed builds the cell's driver with that seed's weights and runs the
unit a run with that seed would check, then the reference; one JSON line
per reading.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=1000)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from port_bench.harness import check, spec, system
    from port_bench.reference.arith import LOWER

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i in range(args.seeds):
        seed = args.first_seed + i
        # a unit index drawn from the seed: it sets the unit's z_t, t and
        # probe seed, as in a run
        k = int(np.random.default_rng(seed + 1).integers(3))
        with tempfile.TemporaryDirectory() as wd:
            sys_ = system.System(cell.config, cell.traffic, seed, "cuda", wd)
            t0 = time.perf_counter()
            got = system.read_basis(sys_.unit(k))
            torch.cuda.synchronize()
            t_unit = time.perf_counter() - t0
            sys_.close()
            del sys_
        t0 = time.perf_counter()
        ref = check.reference_basis(cell.config, cell.traffic, seed, k, "cuda")
        t_ref = time.perf_counter() - t0
        emit({"workload": args.workload, "kind": "program", "seed": seed, "unit": k,
              "t": system.unit_t(cell.traffic, seed, k), "unit_s": t_unit, "ref_s": t_ref,
              "numbers": check.basis_numbers(got, ref), "top_s": [float(x) for x in got[1][:3]]})
        if i < args.control:
            fmt = LOWER[cell.config["unet_dtype"]]
            t0 = time.perf_counter()
            low = check.reference_basis(cell.config, cell.traffic, seed, k, "cuda", fmt)
            emit({"workload": args.workload, "kind": "control", "format": fmt, "seed": seed,
                  "unit": k, "ctrl_s": time.perf_counter() - t0,
                  "numbers": check.basis_numbers(low, ref)})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
