"""Layers of the serving and training paths.

≙ `paddle_tpu/nn/layer/norm.py` :13-48 (`LayerNorm`, `RMSNorm`) and
`nn/layer/common.py` :64-77 (`Dropout`), and the `GELU` activation layer.
Linear and Embedding are `torch.nn.Linear` / `torch.nn.Embedding`
themselves.
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


class LayerNorm(torch.nn.Module):
    """LayerNorm over the last axis with a learned scale (ones) and bias
    (zeros); the CUDA kernels on the card (`F.layer_norm`).
    ``weight_attr=False`` / ``bias_attr=False`` leave the scale / the bias
    out, as the JAX layer's do (DiT's norms have neither): no parameter,
    no state-dict key; the kernels then take a constant ones / zeros
    vector and spend no dw / db sums on it."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=None, weight_attr=None, bias_attr=None):
        super().__init__()
        self.normalized_shape = normalized_shape
        self.epsilon = epsilon
        kw = dict(device=device, dtype=dtype)
        self.weight = None if weight_attr is False else \
            torch.nn.Parameter(torch.ones(normalized_shape, **kw))
        self.bias = None if bias_attr is False else \
            torch.nn.Parameter(torch.zeros(normalized_shape, **kw))

    def forward(self, x, use_kernel=None):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon, use_kernel)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class Dropout(torch.nn.Module):
    """`F.dropout` in training mode, the identity in eval mode.
    ``generator``, when set, is the `torch.Generator` of its keep masks
    (a model shares one among its dropouts, see `set_generator`)."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class GELU(torch.nn.Module):
    """The exact (erf) GELU."""

    def forward(self, x):
        return F.gelu(x)


def set_generator(module: torch.nn.Module, generator) -> None:
    """Give every submodule that draws random numbers (`Dropout`,
    attention with dropout) the one ``generator``: a model seeded once
    repeats its run."""
    for m in module.modules():
        if hasattr(m, "generator"):
            m.generator = generator
