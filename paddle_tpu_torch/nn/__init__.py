"""Layers and functional math of the port (≙ `paddle_tpu/nn`), and the
gradient clips the JAX package exports from it."""
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
