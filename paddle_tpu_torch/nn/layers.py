"""Layers of the serving path.

≙ `paddle_tpu/nn/layer/norm.py` :34-48 (`RMSNorm`). Linear and Embedding
are `torch.nn.Linear` / `torch.nn.Embedding` themselves.
"""
from __future__ import annotations

import torch

from . import functional as F


class RMSNorm(torch.nn.Module):
    """RMSNorm with a learned scale, initialised to ones."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = torch.nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x, use_kernel=None, weight=None):
        """``weight``: the scale to use in place of this module's own
        (a checkpoint swapped in by the serving engine)."""
        return F.rms_norm(x, self.weight if weight is None else weight,
                          self.epsilon, use_kernel)

    def extra_repr(self):
        return f"{self.hidden_size}, eps={self.epsilon}"
