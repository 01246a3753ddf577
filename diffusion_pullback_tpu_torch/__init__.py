"""PyTorch port of diffusion_pullback_tpu for NVIDIA Hopper.

Imports torch and never jax; the JAX package beside it is the reference.
"""
