"""Share of the traced window in which no operation ran on the device, in
percent (the union of the device's kernel, copy and set intervals)."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.window_s)
