"""Functional layer math of the serving path.

≙ `paddle_tpu/nn/functional/norm.py` :52-70 (`rms_norm`),
`nn/functional/common.py` :33-74 (`linear`, with its `LoraWeight` and
`QuantizedWeight` dispatch) and the `silu` activation.
"""
from __future__ import annotations

import torch

from ..ops.lora_epilogue import LoraWeight, lora_matmul_values
from ..ops.norm_kernels import rms_norm_values
from ..ops.quant_matmul import QuantizedWeight, dequant_matmul_values


def rms_norm(x, weight, epsilon=1e-6, use_kernel=None):
    """RMSNorm over the last axis. On the TPU `F.rms_norm` routed to the
    Pallas kernel; here CUDA tensors go to the CUDA kernel and CPU
    tensors to the plain version (`ops.norm_kernels.rms_norm_values`)."""
    return rms_norm_values(x, weight, epsilon, use_kernel=use_kernel)


def silu(x):
    return torch.nn.functional.silu(x)


def linear(x, weight, bias=None, use_kernel=None):
    """``x @ weight.T + bias`` with the weight stored the torch way,
    (out, in). The JAX package stores (in, out) and computes ``x @ W``;
    `models.convert` transposes when it carries weights across.

    A `LoraWeight` goes to `lora_matmul_values` (its base matmul, then
    the per-token adapter delta) and a `QuantizedWeight` to
    `dequant_matmul_values` (each its kernel on the card, its plain
    version on the CPU; ``use_kernel`` as there), so the model code
    never forks on adapters or quantization. A full-width weight is one
    `torch.nn.functional.linear` and ignores ``use_kernel``."""
    if isinstance(weight, LoraWeight):
        y = lora_matmul_values(x, weight, use_kernel)
        return y if bias is None else y + bias
    if isinstance(weight, QuantizedWeight):
        y = dequant_matmul_values(x, weight.qw, weight.scale, use_kernel)
        return y if bias is None else y + bias
    return torch.nn.functional.linear(x, weight, bias)
