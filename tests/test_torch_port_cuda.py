"""K1–K5 on the card: each CUDA kernel against its plain version, and the
fused pair under torch.func against the math path. Marked ``cuda``: these
skip without a GPU and run on one with

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

(``--noconftest``: tests/conftest.py imports jax, which a machine with
the card need not have; this file imports only the port.)
"""

import math

import pytest
import torch

from diffusion_pullback_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(3, 1000, 64), (2, 700, 512), (10, 1024, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(dtype)
               for _ in range(3))
    n0 = fa.flash_forward.launches
    out = fa.flash_forward(q, k, v, shape[-1] ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_forward.launches == n0 + 1
    ref = fa.flash_forward_plain(q, k, v, shape[-1] ** -0.5)
    assert out.dtype == dtype
    # f32: the two differ only in the order of f32 sums; bf16: both round
    # the same f32 value, so at most an ulp apart — two ulps of max |ref|
    top = ref.float().abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else (
        2 * torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(top)))
    assert (out.float() - ref.float()).abs().max().item() <= tol


def _tol(ref, dtype):
    """f32: 1e-4 of max(1, max |ref|) (the two differ in the order of f32
    sums); bf16: two ulps of max |ref| (both round the same f32 values)."""
    top = ref.float().abs().max().item()
    if dtype == torch.float32:
        return 1e-4 * max(1.0, top)
    return 2 * torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(top))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_raises_on_derivatives_and_bad_shapes(cuda, dtype):
    """K2–K5 against their plain versions, with the tangents and the
    cotangent batched over two probes against one primal (the pullback's
    shapes) and a ragged sequence; the pair under torch.func against the
    math path; the head-dim guard."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    rnd = lambda *shape: torch.randn(shape, device=cuda, generator=gen).to(dtype)
    bh, s, d, r, scale = 3, 1000, 64, 2, 0.125
    q, k, v = rnd(bh, s, d), rnd(bh, s, d), rnd(bh, s, d)
    dq, dk, dv, do = (rnd(r * bh, s, d) for _ in range(4))
    n0 = {f: getattr(fa, f).launches
          for f in ("flash_forward_lse", "flash_tangent", "flash_dq", "flash_dkv")}
    o, lse = fa.flash_forward_lse(q, k, v, scale)
    delta = (do.float() * o.float().repeat(r, 1, 1)).sum(-1)
    got = {"o": o, "lse": lse,
           "tangent": fa.flash_tangent(q, k, v, dq, dk, dv, o, lse, scale),
           "dq": fa.flash_dq(q, k, v, do, lse, delta, scale)}
    got["dk"], got["dv"] = fa.flash_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert {f: getattr(fa, f).launches - n for f, n in n0.items()} == dict.fromkeys(n0, 1)
    cpu = lambda *ts: [t.cpu() for t in ts]
    ref = dict(zip(("o", "lse"), fa.flash_forward_lse_plain(*cpu(q, k, v), scale)))
    ref["tangent"] = fa.flash_tangent_plain(*cpu(q, k, v, dq, dk, dv, o, lse), scale)
    ref["dq"] = fa.flash_dq_plain(*cpu(q, k, v, do, lse, delta), scale)
    ref["dk"], ref["dv"] = fa.flash_dkv_plain(*cpu(q, k, v, do, lse, delta), scale)
    for name, out in got.items():
        tol = 1e-4 if name == "lse" else _tol(ref[name], dtype)
        err = (out.cpu().float() - ref[name].float()).abs().max().item()
        assert out.dtype == ref[name].dtype and err <= tol, (name, err, tol)

    # the pair under torch.func (probes vmapped) against the math path
    from torch.func import jvp, vjp, vmap

    from diffusion_pullback_tpu_torch.ops.attention import attention

    x = rnd(1, 1024, 4, 64)
    f = lambda impl: (lambda y: attention(y, y * 0.5, torch.tanh(y), impl=impl))
    ts = rnd(r, *x.shape)
    tan = {impl: vmap(lambda t: jvp(f(impl), (x,), (t,))[1])(ts)
           for impl in ("flash_jvp", "xla")}
    cot = {impl: vmap(vjp(f(impl), x)[1])(ts)[0] for impl in ("flash", "xla")}
    for mine, math_path in ((tan["flash_jvp"], tan["xla"]), (cot["flash"], cot["xla"])):
        assert (mine.float() - math_path.float()).abs().max().item() <= 4 * _tol(
            math_path, dtype)

    with pytest.raises(ValueError, match="head dims"):
        y = torch.randn(1, 1024, 32, device=cuda)
        fa.flash_forward_lse(y, y, y, 0.125)
