"""Pullback-metric geometry."""

from .pullback import (
    PullbackResult,
    local_decoder_pullback,
    local_encoder_pullback,
    local_pullback,
    pullback_covector,
)

__all__ = ["PullbackResult", "local_decoder_pullback", "local_encoder_pullback",
           "local_pullback", "pullback_covector"]
