"""Device choice and float32 precision of the port's entry points."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else CUDA.
    Raises when CUDA is asked for (or implied) and absent; there is no
    silent fall-back to the CPU."""
    dev = torch.device(device if device else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    return dev


def strict_f32() -> None:
    """Full float32 on the card: cuDNN convolutions default to TF32, which
    keeps about three decimal digits and breaks float32 parity with the JAX
    package; matmuls are set too, so neither depends on a global default."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
