"""Framework utilities of the port: `io`, paddle.save / paddle.load of
torch tensors (re-exported as `paddle_tpu_torch.save` / `load`)."""
from .io import load, save  # noqa: F401
