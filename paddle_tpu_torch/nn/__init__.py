"""Layers and functional math of the port (≙ `paddle_tpu/nn`)."""
