"""Schedules, the DDIM step and attention (with the K1 flash kernel)."""
