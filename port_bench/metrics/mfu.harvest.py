"""Model FLOPs of the window's bases over its seconds, as a share of the
card's dense bf16 peak, in percent. The FLOPs are counted on the plain
reference (harness/flops.py ``pullback_flops``), never from the program."""

from port_bench.harness.flops import peaks


def read(run):
    pk = peaks(run.device_name)
    if pk is None:
        return None
    return 100.0 * run.units * run.flops_per_unit() / (run.window_s * pk[0])
