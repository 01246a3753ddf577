"""The benchmark's join of the program's spans with the device trace
(port_bench/harness/join.py) on a synthetic trace with launch records, and
the per-layer metrics read from the program's spans
(port_bench/metrics/flash_host_us.harvest.py)."""

import pytest

from diffusion_pullback_tpu_torch.utils.profiling import Span
from port_bench.harness import join, spec, trace

MS = 1_000_000   # ns


def _span(name, id, parent, start, end, root=1, **counters):
    return Span(name, id, parent, root, start * MS, end * MS, {}, counters)


# one basis: a driver stage around two passes and an SVD, then a basis
# write outside any stage; times in ms
SPANS = [
    _span("tangent", 2, 1, 10, 20), _span("cotangent", 3, 1, 20, 30),
    _span("svd", 4, 1, 30, 40), _span("sync", 5, 1, 40, 45),
    _span("sd_local_pullback", 1, None, 5, 45, flash_host_ns=9_000_000, flash_launches=30),
    _span("basis_d2h", 6, None, 50, 52, root=6), _span("basis_write", 7, None, 52, 60, root=7),
]
# (start, end, name, correlation id) of device ops, and where each was launched
OPS = [(12, 16, "void at::native::elementwise_kernel<128, 4>(int)", 1),
       (16, 25, "flash_tangent_wgmma_kernel", 2),      # launched in tangent, overlaps the next
       (22, 28, "void at::native::reduce_kernel<512, 1>(float)", 3),   # launched in cotangent
       (31, 33, "Memcpy DtoD (Device -> Device)", 4),   # launched in svd
       (36, 38, "gemv", 5),                             # no launch record
       (50, 51, "Memcpy DtoH (Device -> Pinned)", 6),   # launched in basis_d2h
       (70, 71, "distribution_elementwise_grid_stride_kernel", 7)]  # outside every span
LAUNCHED = {1: 11, 2: 15, 3: 21, 4: 30.5, 6: 50, 7: 65}


def _ns(ops, launches):
    return ([(s * MS, e * MS, n, c) for s, e, n, c in ops],
            {c: t * MS for c, t in launches.items()})


def test_each_operation_has_one_owner_and_the_busy_seconds_add_up():
    j = join.join(*_ns(OPS, LAUNCHED), SPANS)
    assert dict(j["ops"]) == {"sd_local_pullback/tangent": 2, "sd_local_pullback/cotangent": 1,
                              "sd_local_pullback/svd": 1, join.UNPAIRED: 1, "basis_d2h": 1,
                              join.OUTSIDE: 1}
    assert sum(j["ops"].values()) == len(OPS)
    # the union of the intervals, each instant given to the earlier start
    assert j["busy"]["sd_local_pullback/tangent"] == pytest.approx(0.013)
    assert j["busy"]["sd_local_pullback/cotangent"] == pytest.approx(0.003)
    assert j["busy"][join.UNPAIRED] == pytest.approx(0.002)
    merged = trace.reduce([(s * 1e3, e * 1e3, n) for s, e, n, _ in OPS],
                          [("K3", [[2, 8, 4]], "bfloat16")], [], 0.0)
    assert j["busy_s"] == pytest.approx(merged["busy_s"]) == pytest.approx(0.022)
    assert sum(j["busy"].values()) == pytest.approx(merged["busy_s"])


def test_idle_gaps_go_where_the_operation_that_ended_them_was_launched():
    j = join.join(*_ns(OPS, LAUNCHED), SPANS)
    assert dict(j["idle"]) == pytest.approx({
        "sd_local_pullback/svd": 0.003, join.UNPAIRED: 0.003, "basis_d2h": 0.012,
        join.OUTSIDE: 0.019})
    assert j["gaps"]["sd_local_pullback/svd, before Memcpy DtoD "] == pytest.approx(0.003)
    assert j["gaps"]["outside program spans, before distribution_elementwise_grid_stride_"
                     "kernel"] == pytest.approx(0.019)


def test_innermost_span_and_its_path():
    owner = join.innermost(SPANS)
    assert [owner(t * MS) for t in (0, 5, 12, 20, 44, 47, 51, 59, 60, 99)] == [
        join.OUTSIDE, "sd_local_pullback", "sd_local_pullback/tangent",
        "sd_local_pullback/cotangent", "sd_local_pullback/sync", join.OUTSIDE, "basis_d2h",
        "basis_write", join.OUTSIDE, join.OUTSIDE]


class _Event:
    def __init__(self, device, name, cid, start, end):
        self._d, self._n, self._c, self._s, self._e = device, name, cid, start, end

    def device_type(self):
        return type("Kind", (), {"name": self._d})

    def name(self):
        return self._n

    def correlation_id(self):
        return self._c

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def test_trace_records_take_the_runtime_or_driver_call_of_each_operation():
    events = [_Event("CPU", "cudaLaunchKernel", 7, 100, 110),
              _Event("CPU", "Lazy Function Loading", 7, 105, 200),   # same id, later
              _Event("CUDA", "elementwise_kernel", 7, 300, 400),
              _Event("CPU", "cuLaunchKernel", 8, 410, 420),
              _Event("CUDA", "gemm", 8, 430, 500),
              _Event("CPU", "aten::mm", 9, 0, 900)]
    results = type("R", (), {"events": lambda self: events})()
    prof = type("P", (), {"profiler": type("A", (), {"kineto_results": results})()})()
    ops, launches = join.trace_records(prof)
    assert ops == [(300, 400, "elementwise_kernel", 7), (430, 500, "gemm", 8)]
    assert launches == {7: 100, 8: 410}


def test_pass_metrics_sum_by_span_name():
    j = join.join(*_ns(OPS, LAUNCHED), SPANS)
    assert join.leaf_sum(j["busy"], ("tangent", "final_tangent")) == pytest.approx(0.013)
    assert join.leaf_sum(j["busy"], ("vjp_primal", "cotangent")) == pytest.approx(0.003)
    assert join.leaf_sum(j["idle"], ("tangent", "cotangent", "svd")) == pytest.approx(0.003)


def test_host_waits_are_the_synchronisations_and_the_host_copies():
    owner = join.innermost(SPANS)
    events = [_Event("CPU", "cudaLaunchKernel", 1, 11 * MS, 11 * MS + 5000),
              _Event("CUDA", "elementwise_kernel", 1, 12 * MS, 16 * MS),
              # a copy to the host from svd, waiting 3 ms for the stream
              _Event("CPU", "cudaMemcpyAsync", 4, 30 * MS, 33 * MS),
              _Event("CPU", "cuMemcpyAsync", 4, 30 * MS + 100, 33 * MS),   # same call
              _Event("CUDA", "Memcpy DtoH (Device -> Pageable)", 4, 32 * MS, 33 * MS),
              # a copy on the device from svd returns at once and does not count
              _Event("CPU", "cudaMemcpyAsync", 8, 34 * MS, 34 * MS + 9000),
              _Event("CUDA", "Memcpy DtoD (Device -> Device)", 8, 35 * MS, 36 * MS),
              _Event("CPU", "cudaStreamSynchronize", 9, 40 * MS, 44 * MS),
              _Event("CPU", "cudaDeviceSynchronize", 9, 46 * MS, 47 * MS),
              _Event("CPU", "Lazy Function Loading", 4, 30 * MS, 39 * MS)]
    waits = join.host_waits(events, owner)
    assert dict(waits) == pytest.approx({"sd_local_pullback/svd": 0.003,
                                         "sd_local_pullback/sync": 0.004,
                                         join.OUTSIDE: 0.001})


class _Run:
    def __init__(self, spans, units=2):
        self.program_spans, self.units = spans, units


@pytest.mark.parametrize("metric, value", [
    # 9 ms of host time over 30 launches
    ("flash_host_us.harvest", 300.0),
])
def test_span_readers_read_a_hand_made_value(metric, value):
    read = spec.metric_reader(metric)
    assert read(_Run(SPANS)) == pytest.approx(value)
    assert read(_Run(None)) is None and read(_Run([])) is None


def test_the_window_spans_are_taken_from_the_program_once(monkeypatch):
    from diffusion_pullback_tpu_torch.utils import profiling

    taken = iter([SPANS, []])
    monkeypatch.setattr(profiling, "take_spans", lambda: next(taken))
    run = type("Run", (), {})()
    assert join.window_spans(run) == SPANS and join.window_spans(run) == SPANS
