"""Feature-tap addresses of the U-Nets (counterpart of the `TapPoint` of
diffusion_pullback_tpu/models/unet2d.py, without intra-block taps).

    ('down', i) → output of down block i   ('mid', 0) → mid block output
    ('up', i)   → output of up block i
"""

from __future__ import annotations

from typing import NamedTuple


class TapPoint(NamedTuple):
    op: str            # 'down' | 'mid' | 'up'
    block_idx: int = 0

    def validate(self, num_down: int, num_up: int) -> "TapPoint":
        if self.op == "mid":
            if self.block_idx != 0:
                raise ValueError("mid tap requires block_idx == 0")
        elif self.op == "down":
            if not 0 <= self.block_idx < num_down:
                raise ValueError(f"down tap block_idx out of range: {self.block_idx}")
        elif self.op == "up":
            if not 0 <= self.block_idx < num_up:
                raise ValueError(f"up tap block_idx out of range: {self.block_idx}")
        else:
            raise ValueError(f"invalid tap op: {self.op!r}")
        return self
