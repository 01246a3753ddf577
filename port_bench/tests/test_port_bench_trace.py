"""The traced window's reduction: flash op calls paired in order with the
program's flash kernel launches, whatever a kernel's design or name, and
the window's device time split by unit."""

import pytest

from port_bench.harness import trace

# (start µs, end µs, name) as device_events gives them
LAUNCHES = [
    "void (anonymous namespace)::flash_fwd_wgmma_kernel<64, true>(Params)",
    "void (anonymous namespace)::flash_fwd_tf32_rows_kernel<128>(float const*)",
    "void (anonymous namespace)::flash_fwd_tf32x3_kernel(float const*)",
    "void (anonymous namespace)::flash_fwd_mma_bf16_kernel(bf16 const*)",
    "void (anonymous namespace)::flash_tangent_tf32_rows_kernel<40>(float const*)",
]
CALLS = [("K2", [[5, 4096, 64]], "bfloat16"), ("K2", [[4, 1024, 128]], "float32"),
         ("K1", [[1, 4096, 512]], "float32"), ("K2", [[1, 4096, 512]], "bfloat16"),
         ("K3", [[16, 1024, 40]], "float32")]


def _events(names, others=("void at::native::elementwise_kernel<128, 4>(int)",
                           "void pytorch_flash::flash_fwd_kernel<Traits>(Params)")):
    ev, t = [], 0.0
    for i, n in enumerate(names):
        ev.append((t, t + 10.0 * (i + 1), n))
        t += 10.0 * (i + 1)
        for o in others:
            ev.append((t, t + 1.0, o))
            t += 1.0
    return ev


def test_calls_pair_with_launches_of_every_design():
    r = trace.reduce(_events(LAUNCHES), CALLS, [], 0.0)
    assert [k for k, _, _, _ in r["flash_calls"]] == [c[0] for c in CALLS]
    assert [sec for *_, sec in r["flash_calls"]] == \
        pytest.approx([1e-5 * (i + 1) for i in range(len(CALLS))])


@pytest.mark.parametrize("cut", [slice(1, None), slice(None, -1)])
def test_calls_and_launches_that_do_not_pair_raise(cut):
    with pytest.raises(RuntimeError, match="flash op calls"):
        trace.reduce(_events(LAUNCHES[cut]), CALLS, [], 0.0)


def test_without_a_device_trace_nothing_is_paired():
    r = trace.reduce([], CALLS, [], 0.0)
    assert r["flash_calls"] is None and r["busy_s"] == 0


def test_device_time_by_unit():
    # two units of spans (host seconds from t0 = 1.0), device busy 0.2 s
    # in the first and 0.1 s in the second
    spans = [("pullback", 0, 1.0, 0.5), ("save", 0, 1.5, 0.1),
             ("pullback", 1, 1.6, 0.3), ("save", 1, 1.9, 0.1)]
    dev = [(0.1e6, 0.2e6, "a"), (0.15e6, 0.3e6, "b"), (0.7e6, 0.8e6, "c")]
    units = trace.unit_busy([[0.1e6, 0.3e6, "a"], [0.7e6, 0.8e6, "c"]], spans, 1.0)
    assert [k for k, _, _ in units] == [0, 1]
    assert units[0][1] == pytest.approx(0.6) and units[0][2] == pytest.approx(0.2)
    assert units[1][1] == pytest.approx(0.4) and units[1][2] == pytest.approx(0.1)
    assert trace.reduce(dev, [], spans, 1.0)["units"] == units
