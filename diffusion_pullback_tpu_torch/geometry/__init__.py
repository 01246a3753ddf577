"""Pullback-metric geometry."""

from .pullback import PullbackResult, local_pullback

__all__ = ["PullbackResult", "local_pullback"]
