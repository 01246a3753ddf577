"""The port's profiling helpers (diffusion_pullback_tpu_torch/utils/
profiling.py): the spans of the pullback, of a driver stage and of a basis
write, recorded only under a profiler, on the profiler's clock, and leaving
the bases bit for bit as they were; the flash wrappers' host-time counter;
and trace() around a tiny SD U-Net's ε writes a Chrome trace that names the
U-Net's convolutions, the K1 custom op and the spans, and trace('')
records nothing. Runs on the CPU."""

import collections
import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_port_common import one_torch_thread  # noqa: F401

from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.experiments._common import DriverCommonMixin
from diffusion_pullback_tpu_torch.geometry.pullback import local_pullback
from diffusion_pullback_tpu_torch.ops import flash_attention as fa
from diffusion_pullback_tpu_torch.utils import profiling


class Recorder:
    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))


@pytest.fixture(autouse=True)
def no_spans_left():
    """Each test starts and ends with no finished span held."""
    profiling.take_spans()
    yield
    profiling.take_spans()


def _cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


W = torch.from_numpy(np.random.default_rng(0).standard_normal((6, 12), np.float32))
X = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 12), np.float32))
ITERS = 4


def _pullback():
    """A rank-2 pullback of a small tanh layer, 4 iterations."""
    return local_pullback(lambda x: torch.tanh(x.reshape(1, -1) @ W.T), X,
                          torch.Generator().manual_seed(3), pca_rank=2,
                          min_iter=ITERS - 2, max_iter=ITERS)


def test_no_profiler_records_no_span_and_the_same_bits():
    plain = _pullback()
    assert profiling.take_spans() == []
    assert profiling.span("a") is profiling.span("b", it=1)   # one shared no-op
    with _cpu_profiler():
        traced = _pullback()
    assert profiling.take_spans()
    assert plain.iterations == traced.iterations == ITERS
    for a, b in zip((plain.u, plain.s, plain.vT), (traced.u, traced.s, traced.vT)):
        assert torch.equal(a, b)


def test_pullback_spans_names_parents_roots_and_iterations():
    with _cpu_profiler(), profiling.span("basis", t=0.5):
        _pullback()
    spans = profiling.take_spans()
    root = spans[-1]
    assert (root.name, root.parent, root.root, root.fields) == ("basis", None, root.id, {"t": 0.5})
    inner = spans[:-1]
    assert all(s.parent == root.id and s.root == root.id for s in inner)
    assert [s.name for s in inner[:2]] == ["vjp_primal", "probes"]
    assert [s.name for s in inner[2:-1]] == ["tangent", "cotangent", "svd", "delta_wait"] * ITERS
    assert [s.fields["it"] for s in inner[2:-1]] == [i for i in range(ITERS) for _ in range(4)]
    assert inner[-1].name == "final_tangent" and inner[-1].fields == {}
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in inner)
    assert all(a.end_ns <= b.start_ns for a, b in zip(inner, inner[1:]))
    assert len({s.id for s in spans}) == len(spans)


def test_qr_events_lie_inside_svd_or_probes_spans():
    """The spans' stamps and the profiler's events share one clock: every
    QR the pullback runs (the probes' and each short-fat SVD's) lies inside
    its span."""
    with _cpu_profiler() as prof:
        _pullback()
    spans = [s for s in profiling.take_spans() if s.name in ("svd", "probes")]
    qrs = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::linalg_qr"]
    assert len(qrs) == ITERS + 1
    holders = [[s.name for s in spans if s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns]
               for e in qrs]
    assert sorted(holders) == [["probes"]] + [["svd"]] * ITERS


class _Driver(DriverCommonMixin):
    def __init__(self, cache=None):
        self.device, self.log, self.cache = torch.device("cpu"), Recorder(), cache


def test_stage_opens_a_root_span_and_logs_the_same_fields():
    logged = []
    for traced in (False, True):
        driver = _Driver()
        with _cpu_profiler() if traced else contextlib.nullcontext():
            with driver._stage("sd_local_pullback", encoder="flash") as log:
                torch.ones(4) @ torch.ones(4)
                log.update(iterations=3)
        (event, fields), = driver.log.events
        logged.append((event, sorted(fields), fields["encoder"], fields["iterations"]))
        assert fields["seconds"] >= 0
    assert logged[0] == logged[1] == ("sd_local_pullback", ["encoder", "iterations", "seconds"],
                                      "flash", 3)
    sync, stage = profiling.take_spans()
    assert (stage.name, stage.parent, stage.root, stage.fields) == (
        "sd_local_pullback", None, stage.id, {"encoder": "flash"})
    assert (sync.name, sync.parent, sync.root) == ("sync", stage.id, stage.id)


def test_save_basis_records_the_copies_and_the_write():
    class Cache:
        def save(self, name, u, s, vT):
            self.saved = (name, u, s, vT)
            return name + ".dpb"

    res = collections.namedtuple("Res", "u s vT")(
        torch.ones(6, 2, dtype=torch.bfloat16), torch.ones(2), torch.ones(2, 12))
    driver = _Driver(Cache())
    with _cpu_profiler():
        assert driver._save_basis("b0", res) == "b0.dpb"
    assert [s.name for s in profiling.take_spans()] == ["basis_d2h", "basis_write"]
    name, *arrays = driver.cache.saved
    assert name == "b0" and all(isinstance(a, np.ndarray) and a.dtype == np.float32
                                for a in arrays)


def _flash_calls():
    """A CPU call of each flash wrapper on tiny (B·H, S, D) operands."""
    g = torch.Generator().manual_seed(0)
    q, k, v, dq, dk, dv, do = (torch.randn(2, 8, 4, generator=g) for _ in range(7))
    o, lse = fa.flash_forward_lse(q, k, v, 0.5)
    delta = (do * o).sum(-1)
    return {"flash_forward": lambda: fa.flash_forward(q, k, v, 0.5),
            "flash_forward_lse": lambda: fa.flash_forward_lse(q, k, v, 0.5),
            "flash_tangent": lambda: fa.flash_tangent(q, k, v, dq, dk, dv, o, lse, 0.5),
            "flash_dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, 0.5),
            "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta, 0.5)}


@pytest.mark.parametrize("wrapper", ["flash_forward", "flash_forward_lse", "flash_tangent",
                                     "flash_dq", "flash_dkv"])
def test_host_ns_grows_with_each_wrapper_call(wrapper):
    call, w = _flash_calls()[wrapper], getattr(fa, wrapper)
    before = w.host_ns, w.launches
    for _ in range(3):
        n = w.host_ns
        call()
        assert w.host_ns > n
    assert w.launches == before[1]   # the CPU runs the plain version: no launch
    with _cpu_profiler(), profiling.span("calls"):
        call()
    (sp,) = profiling.take_spans()
    assert sp.counters["flash_host_ns"] > 0 and sp.counters["flash_launches"] == 0


def _tiny_eps():
    """ε of a tiny SD U-Net with 'flash' attention over 32² latents: its
    first block self-attends over 1024 tokens through K1."""
    cfg = dataclasses.replace(tmodels.sd_tiny_unet(32), attn_impl="flash")
    unet = tmodels.random_init_(tmodels.UNet2DCondition(cfg), 0).eval().requires_grad_(False)
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.standard_normal((1, 4, 32, 32), np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 5, 16), np.float32))
    return lambda: unet(z, torch.tensor(500.0), ctx)


def test_trace_names_the_convolutions_and_the_k1_op(tmp_path):
    eps = _tiny_eps()
    with torch.no_grad(), profiling.trace(str(tmp_path / "trace")):
        out = eps()
    assert torch.isfinite(out).all()
    (path,) = (tmp_path / "trace").iterdir()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names
    assert "dpx::flash_fwd" in names


def test_trace_names_the_spans(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        _pullback()
    (path,) = (tmp_path / "trace").iterdir()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"vjp_primal", "probes", "tangent", "cotangent", "svd", "delta_wait",
            "final_tangent"} <= names


def test_empty_trace_dir_records_nothing(tmp_path, monkeypatch):
    import torch.profiler

    def refuse(*a, **k):
        raise AssertionError("a profiler was started")
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.chdir(tmp_path)
    for empty in ("", None):
        with profiling.trace(empty):
            torch.ones(2) @ torch.ones(2)
    assert list(tmp_path.iterdir()) == []
