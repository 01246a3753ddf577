"""The flash kernels' (K1–K5) share of their roofline over the traced
window, in percent: the sum over every call of the least time the card
could take for it (its operations at the peak of its dtype or its bytes
at the HBM rate, from its shapes and dtype) over the sum of the calls'
device time. Nothing without a device trace (the trace's reduction
raises where the calls and the kernel launches do not pair)."""

from port_bench.harness.flops import kernel_bound_s


def read(run):
    if run.trace is None or not run.trace["flash_calls"]:
        return None
    bound = spent = 0.0
    for kernel, shapes, dtype, seconds in run.trace["flash_calls"]:
        b = kernel_bound_s(kernel, shapes, dtype, run.device_name)
        if b is None or seconds <= 0:
            return None
        bound, spent = bound + b, spent + seconds
    return 100.0 * bound / spent if spent > 0 else None
