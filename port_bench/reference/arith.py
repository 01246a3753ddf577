"""The arithmetic of the plain reference: every product (convolution,
linear layer, attention's two matmuls) goes through one object, so the same
network runs exactly in float32 or with its operands rounded to a lower
precision.

``Exact`` computes in float32 with TF32 off. ``Rounded`` is the control of
the output check: the reference put in the program's place and computed in
the nearest precision below the one the configuration states (fp8 e4m3 for
a bfloat16 model, bfloat16 for a float32 one). Each product's operands are
rounded to that format before the product, which is summed in float32; fp8
takes one scale per tensor (amax / 448), as fp8 GEMMs do. The rounding
applies to the tangents and cotangents of a pullback too, because a
program computing in that format would hold them in it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def no_tf32() -> None:
    """Full float32 matmuls and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    if fmt == "fp8":
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    raise ValueError(f"unknown rounding format {fmt!r}")


def _rounder(fmt: str):
    class Round(torch.autograd.Function):
        """Round to ``fmt``; tangents and cotangents are rounded alike."""

        generate_vmap_rule = True

        @staticmethod
        def forward(x):
            return _round(x, fmt)

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def backward(ctx, g):
            return _round(g, fmt)

        @staticmethod
        def jvp(ctx, t):
            return _round(t, fmt)

    return Round.apply


class Exact:
    """Products in float32."""

    name = "float32"

    def q(self, x):
        return x

    def conv2d(self, x, w, b, stride=1, padding=1):
        return F.conv2d(self.q(x), self.q(w), b, stride=stride, padding=padding)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


class Rounded(Exact):
    """Products of operands rounded to ``fmt`` ('fp8' or 'bfloat16')."""

    def __init__(self, fmt: str):
        self.name = fmt
        self._r = _rounder(fmt)

    def q(self, x):
        return self._r(x)


# the control's format below each stated dtype
LOWER = {"float32": "bfloat16", "bfloat16": "fp8"}


def arith(name: str):
    """'float32' → Exact; 'fp8' / 'bfloat16' → Rounded."""
    return Exact() if name == "float32" else Rounded(name)
