"""Rotary position embedding, plain PyTorch.

≙ `paddle_tpu/ops/rope.py` :39-47 (`rope_rotate_values`). The serving
path never ran the TPU's rope kernel (`apply_rope` passes
``use_pallas=False``), so the rotation stays plain tensor code here.
"""
from __future__ import annotations

import torch


def rope_rotate_values(x: torch.Tensor, c: torch.Tensor,
                       s: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation: the pairs are ``(x[..., 0::2],
    x[..., 1::2])`` (not the half-split ``rotate_half`` convention).
    ``c``/``s`` are f32 trig values already broadcast-shaped against
    those halves. Computed in f32, returned in x's dtype."""
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                       dim=-1).reshape(x.shape).to(x.dtype)
