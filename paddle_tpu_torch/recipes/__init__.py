"""Runnable recipes of the port (``python -m paddle_tpu_torch.recipes.<name>``)."""
