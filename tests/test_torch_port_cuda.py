"""K1 on the card: the CUDA kernel against its plain version, and the
primal-only guard of its autograd node. Marked ``cuda``: these skip without
a GPU and run on one with

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


def test_kernel_raises_on_derivatives_and_bad_shapes(cuda):
    q = torch.randn(2, 1024, 64, device=cuda, requires_grad=True)
    out = fa.flash_forward(q, q.detach(), q.detach(), 0.125)
    with pytest.raises(NotImplementedError, match="slice 2"):
        out.sum().backward()
    with pytest.raises(NotImplementedError, match="slice 2"):
        torch.func.jvp(lambda x: fa.flash_forward(x, x, x, 0.125),
                       (q.detach(),), (torch.ones_like(q),))
    with pytest.raises(ValueError, match="head dims"):
        x = torch.randn(1, 1024, 32, device=cuda)
        fa.flash_forward(x, x, x, 0.125)
