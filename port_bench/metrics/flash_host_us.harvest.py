"""Host microseconds a call of the flash wrappers (K1–K5 in
``ops/flash_attention.py``: checks, op dispatch and the launch), over the
traced window: the growth of the program's ``flash_host_ns`` counter over
its root spans of the window over that of ``flash_launches``. Nothing where
the program records no spans or launched no flash kernel."""

from port_bench.harness.join import root_growth, window_spans


def read(run):
    spans = window_spans(run)
    launches = root_growth(spans, "flash_launches") if spans else 0
    if not launches:
        return None
    return root_growth(spans, "flash_host_ns") / launches / 1e3
