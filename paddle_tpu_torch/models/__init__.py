"""Models of the port (≙ `paddle_tpu/models`): Llama and its serving
engine."""
