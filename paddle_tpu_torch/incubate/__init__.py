"""Incubating layers of the port (≙ `paddle_tpu/incubate`)."""
