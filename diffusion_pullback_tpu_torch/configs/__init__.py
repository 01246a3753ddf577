"""Experiment tables of the port (counterpart of
diffusion_pullback_tpu/configs)."""

from .params import X_SPACE_EDIT_STEP_SIZE_DICT, X_SPACE_GUIDANCE_SCALE_DICT
from .prompts import EDIT_PROMPTS

__all__ = [
    "X_SPACE_GUIDANCE_SCALE_DICT",
    "X_SPACE_EDIT_STEP_SIZE_DICT",
    "EDIT_PROMPTS",
]
