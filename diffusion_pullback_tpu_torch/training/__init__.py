"""Diffusion training: the train step with f32 master params, the VB loss
terms, the timestep samplers and step-numbered checkpoints (counterpart of
diffusion_pullback_tpu/training/); the step also runs under a dp×fsdp
mesh."""

from .resample import (
    LossAwareState,
    init_loss_aware,
    loss_aware_sample_t,
    loss_aware_weights,
    uniform_sample_t,
    update_loss_aware,
)
from .train import TrainState, create_train_state, gather_params, make_train_step

__all__ = [
    "TrainState",
    "create_train_state",
    "make_train_step",
    "gather_params",
    "LossAwareState",
    "init_loss_aware",
    "loss_aware_sample_t",
    "loss_aware_weights",
    "uniform_sample_t",
    "update_loss_aware",
]
