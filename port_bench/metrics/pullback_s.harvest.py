"""Seconds of one rank-r pullback (the driver's synchronised
``sd_local_pullback`` stage), the mean over the window's units."""


def read(run):
    secs = [e["seconds"] for e in run.stages if e["event"] == "sd_local_pullback"]
    return sum(secs) / len(secs) if secs else None
