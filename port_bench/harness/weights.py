"""Seeded weights in the diffusers layout, made on the device in the dtype
they are served in, in one draw per module: LeCun-normal matrices and
convolution kernels (std fan_in^-1/2, fan_in the product of every axis but
the first), embeddings scaled by their width^-1/2, unit norm scales and zero
biases. The same seed and layout give the same values on any run, so the
program and the reference receive the same weights."""

from __future__ import annotations

import math

import torch


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for stream ``stream`` of run ``seed``."""
    return (seed * 1_000_003 + stream * 7_919 + 17) % (2 ** 62)


def fill_(targets: dict, seed: int, stream: int) -> None:
    """Write seeded weights into ``targets`` ({name: tensor}, every tensor
    on one device and of one dtype), drawn in one call."""
    names = sorted(targets)
    first = targets[names[0]]
    drawn = [n for n in names if not n.endswith("bias") and targets[n].ndim > 1]
    total = sum(targets[n].numel() for n in drawn)
    gen = torch.Generator(device=first.device).manual_seed(stream_seed(seed, stream))
    noise = torch.randn(total, generator=gen, device=first.device, dtype=first.dtype)
    offset = 0
    with torch.no_grad():
        for n in names:
            t = targets[n]
            if n in drawn:
                fan = t.shape[1] if "embedding" in n else math.prod(t.shape[1:])
                t.copy_(noise[offset:offset + t.numel()].view(t.shape).mul_(fan ** -0.5))
                offset += t.numel()
            elif n.endswith("bias"):
                t.zero_()
            else:
                t.fill_(1.0)


def draw(layout: dict, seed: int, stream: int, device, dtype) -> dict:
    """{name: tensor} of ``layout`` ({name: shape}) with seeded weights."""
    out = {n: torch.empty(s, device=device, dtype=dtype) for n, s in layout.items()}
    fill_(out, seed, stream)
    return out
