"""Seconds of writing one basis file (``_save_basis``: the device-to-host
copy and the native write), timed by the benchmark around the call and
synchronised; the mean over the window's units."""


def read(run):
    secs = [sec for name, _, _, sec in run.spans if name == "save"]
    return sum(secs) / len(secs) if secs else None
