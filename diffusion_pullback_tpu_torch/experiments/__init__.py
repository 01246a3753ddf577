"""Experiment drivers of the port."""

from .cache import BasisCache, basis_name
from .edit_sd import EditStableDiffusion, SDExperimentConfig

__all__ = ["BasisCache", "EditStableDiffusion", "SDExperimentConfig",
           "basis_name"]
