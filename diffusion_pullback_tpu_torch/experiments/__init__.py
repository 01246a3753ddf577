"""Experiment drivers of the port."""

from .cache import BasisCache, basis_name
from .edit_sd import EditStableDiffusion, SDExperimentConfig
from .edit_sdxl import EditStableDiffusionXL
from .edit_uncond import EditUncondDiffusion, UncondExperimentConfig

__all__ = ["BasisCache", "EditStableDiffusion", "EditStableDiffusionXL",
           "EditUncondDiffusion", "SDExperimentConfig", "UncondExperimentConfig",
           "basis_name"]
