"""The port's FLOP and MFU accounting (diffusion_pullback_tpu_torch/utils/
flops.py) against the JAX package's (diffusion_pullback_tpu/utils/flops.py):
the totals from the same fits and the MFU fields from the same seconds and
peak equal JAX's; on the CPU there is no peak and no mfu field; a function
of products only counts what XLA's cost analysis counts; a linear map's
per-tangent and per-cotangent terms are the analytic products; each flash
kernel's custom op counts the operations chip_smoke.py's bounds count,
called directly and with probes folded in under vmap; and a tiny SD U-Net's
ε counts the same FLOPs with 'flash' attention (K1) as with the math path.
Runs on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vjp, vmap
from torch.utils.flop_counter import FlopCounterMode
from torch_port_common import one_torch_thread  # noqa: F401

import chip_smoke
from diffusion_pullback_tpu.utils import flops as jflops
from diffusion_pullback_tpu_torch import models as tmodels
from diffusion_pullback_tpu_torch.ops import flash_attention as fa
from diffusion_pullback_tpu_torch.utils import flops

FITS = ((3.0e12, 1.25e11), (2.5e12, 2.0e11))


@pytest.mark.parametrize("uses_fn_vjp", [False, True])
@pytest.mark.parametrize("rank, iters", [(2, 3), (50, 1)])
def test_totals_and_mfu_fields_equal_jax(rank, iters, uses_fn_vjp, monkeypatch):
    total = flops.pullback_flops_from_fits(FITS, rank, iters, uses_fn_vjp)
    assert total == jflops.pullback_flops_from_fits(FITS, rank, iters, uses_fn_vjp)
    for peak in (989.4, 197.0):
        monkeypatch.setattr(flops, "peak_bf16_tflops", lambda device=None, p=peak: p)
        monkeypatch.setattr(jflops, "peak_bf16_tflops", lambda device=None, p=peak: p)
        for seconds in (0.731, 12.5):
            mine = flops.mfu_fields(total, seconds)
            assert mine == jflops.mfu_fields(total, seconds)
            assert set(mine) == {"tflops", "tflops_per_sec", "mfu_vs_bf16_peak"}
    assert flops.mfu_fields(None, 1.0) == jflops.mfu_fields(None, 1.0) == {}
    assert flops.mfu_fields(total, 0.0) == jflops.mfu_fields(total, 0.0) == {}


def test_cpu_has_no_peak_and_no_mfu_field():
    assert not torch.cuda.is_available()
    assert flops.peak_bf16_tflops() is None
    assert flops.peak_bf16_tflops("cpu") is None
    fields = flops.mfu_fields(4.2e12, 1.5)
    assert fields == {"tflops": 4.2, "tflops_per_sec": 2.8}


def test_peak_table_reads_the_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989.4), ("NVIDIA H100 PCIe", 756.5),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None, n=name: n)
        assert flops.peak_bf16_tflops() == peak
        assert ("mfu_vs_bf16_peak" in flops.mfu_fields(1e12, 1.0)) == (peak is not None)


PRODUCTS = {
    "matmul chain": (lambda a, b, c: (a @ b) @ c, [(16, 32), (32, 24), (24, 8)]),
    "batched matmul": (lambda a, b, c: torch.einsum("bij,bjk->bik", a, b) @ c,
                       [(3, 16, 32), (3, 32, 24), (24, 8)]),
}


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_compiled_flops_of_products_equal_jax(name):
    fn, shapes = PRODUCTS[name]
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s, np.float32) for s in shapes]
    jfn = {"matmul chain": lambda a, b, c: (a @ b) @ c,
           "batched matmul": lambda a, b, c: jnp.einsum("bij,bjk->bik", a, b) @ c}[name]
    mine = flops.compiled_flops(fn, *map(torch.from_numpy, arrays))
    assert mine == jflops.compiled_flops(jfn, *map(jnp.asarray, arrays))
    assert flops.compiled_flops(lambda a: a * 2.0, torch.ones(3)) is None


def test_linear_map_terms_are_the_analytic_products():
    """fn(W, x) = x·W (m×k · k×n): a tangent costs x's product with W,
    2·m·k·n, and so does a cotangent (u·Wᵀ); JAX's fits agree."""
    m, k, n = 8, 12, 5
    rng = np.random.default_rng(1)
    w, x = rng.standard_normal((k, n), np.float32), rng.standard_normal((m, k), np.float32)
    fn = lambda p, q: q @ p
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    _, tangent = flops.linearized_pass_flops(fn, tw, tx)
    _, cotangent = flops.transpose_pass_flops(fn, tw, tx)
    assert tangent == cotangent == 2 * m * k * n
    _, j_tangent = jflops.linearized_pass_flops(fn, jnp.asarray(w), jnp.asarray(x))
    _, j_cotangent = jflops.transpose_pass_flops(fn, jnp.asarray(w), jnp.asarray(x))
    assert (tangent, cotangent) == (j_tangent, j_cotangent)
    fits = flops.pullback_fits(fn, tw, tx)
    assert flops.pullback_flops(fn, tw, tx, 2, 3) == flops.pullback_flops_from_fits(
        fits, 2, 3, uses_fn_vjp=False)


def _count(fn, *args):
    """{op name: FLOPs} FlopCounterMode counts over fn(*args)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {str(op).split(".")[-1]: n for op, n in counter.get_flop_counts()["Global"].items()}


def _k1_ops(bh, s, d, monkeypatch):
    """chip_smoke.k1_bound_ms's operations at (bh, s, d)."""
    seen = []
    monkeypatch.setattr(chip_smoke, "bound_ms", lambda nbytes, ops, dtype: seen.append(ops))
    chip_smoke.k1_bound_ms((bh, s, d), torch.float32)
    return seen[0]


def _bshd(rng, b, s, h, d, r=None):
    shape = (b, s, h, d) if r is None else (r, b, s, h, d)
    return torch.from_numpy(rng.standard_normal(shape, np.float32))


@pytest.mark.parametrize("label", ["K1", "K2", "K3", "K4", "K5"])
@pytest.mark.parametrize("folded", [False, True], ids=["direct", "vmap"])
def test_custom_op_counts_the_chip_smoke_formula(label, folded, monkeypatch):
    """Direct: the wrapper at B·H 2, 64 tokens, head dim 40 (K3–K5 with
    two probes' slices). vmap: B 1 × H 2 at 128 tokens, head dim 64, 3
    probes folded into B·H by the autograd Functions' vmap rules (K1 and K2
    with the primal batched, K3 over tangents, K4 and K5 over cotangents,
    the primal shared)."""
    rng = np.random.default_rng(2)
    sym = {"K1": "flash_fwd", "K2": "flash_fwd_lse", "K3": "flash_tangent",
           "K4": "flash_dq", "K5": "flash_dkv"}[label]
    if not folded:
        bhp, s, d, r = 2, 64, 40, (1 if label in ("K1", "K2") else 2)
        q, k, v = (_bshd(rng, 1, bhp, s, d)[0] for _ in range(3))
        t = _bshd(rng, 1, r * bhp, s, d)[0]
        o, lse = fa.flash_forward_lse_plain(q, k, v, d ** -0.5)
        delta = torch.ones(r * bhp, s)
        call = {"K1": lambda: fa.flash_forward(q, k, v, d ** -0.5),
                "K2": lambda: fa.flash_forward_lse(q, k, v, d ** -0.5),
                "K3": lambda: fa.flash_tangent(q, k, v, t, t, t, o, lse, d ** -0.5),
                "K4": lambda: fa.flash_dq(q, k, v, t, lse, delta, d ** -0.5),
                "K5": lambda: fa.flash_dkv(q, k, v, t, lse, delta, d ** -0.5)}[label]
        counts = _count(call)
    else:
        bhp, s, d, r = 2, 128, 64, 3
        q, k, v = (_bshd(rng, 1, s, bhp, d) for _ in range(3))
        probes = _bshd(rng, 1, s, bhp, d, r=r)
        if label == "K1":
            counts = _count(vmap(lambda x: fa.flash_attention(x, k, v)), probes)
        elif label == "K2":
            counts = _count(vmap(lambda x: fa.flash_attention_jvp(x, k, v)), probes)
        elif label == "K3":
            counts = _count(vmap(lambda t: jvp(lambda x: fa.flash_attention_jvp(x, k, v),
                                               (q,), (t,))[1]), probes)
        else:
            def pull(cot):
                _, f_vjp = vjp(lambda x, y, z: fa.flash_attention(x, y, z), q, k, v)
                return vmap(f_vjp)(cot)
            counts = _count(pull, probes)
        if label in ("K1", "K2"):
            bhp, r = r * bhp, 1   # the primal itself is batched
    want = (_k1_ops(bhp, s, d, monkeypatch) if label == "K1"
            else chip_smoke.pair_ops(label, bhp, r, s, d))
    assert counts[sym] == want
    assert counts[sym] == fa.flash_ops(label, bhp, r * bhp, s, s, d)


def test_tiny_unet_eps_counts_the_same_with_flash_and_xla():
    """A tiny SD U-Net over 32² latents (its first block self-attends over
    1024 tokens, which 'flash' sends to K1): the same FLOPs either way."""
    cfg = dataclasses.replace(tmodels.sd_tiny_unet(32), attn_impl="flash")
    unet = tmodels.random_init_(tmodels.UNet2DCondition(cfg), 0).eval().requires_grad_(False)
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((1, 4, 32, 32), np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 5, 16), np.float32))
    t = torch.tensor(500.0)
    from diffusion_pullback_tpu_torch.models.layers import attn_impl_as

    counts = {}
    for impl in ("flash", "xla"):
        with torch.no_grad(), attn_impl_as(unet, impl):
            counts[impl] = _count(unet, z, t, ctx)
    assert "flash_fwd" in counts["flash"] and "flash_fwd" not in counts["xla"]
    assert sum(counts["flash"].values()) == sum(counts["xla"].values())
    assert flops.compiled_flops(unet, z, t, ctx) == sum(counts["flash"].values())
