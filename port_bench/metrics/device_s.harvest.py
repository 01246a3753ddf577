"""Device-busy seconds of one basis in the traced window: the union of
the intervals in which an operation ran on the device, between a unit's
first span's start and its last span's end, the mean over the window's
units. Steadier than ``basis_s``, which also counts the host's pace."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0 or not run.trace["units"]:
        return None
    busy = [b for _, _, b in run.trace["units"]]
    return sum(busy) / len(busy)
