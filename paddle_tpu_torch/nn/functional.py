"""Functional layer math of the serving and training paths.

≙ `paddle_tpu/nn/functional/norm.py` :52-70 (`rms_norm`),
`nn/functional/common.py` :33-74 (`linear`, with its `LoraWeight` and
`QuantizedWeight` dispatch), the `silu` activation,
`nn/functional/attention.py` :20-101 (`_sdpa_xla`,
`scaled_dot_product_attention` without dropout) and
`nn/functional/loss.py` :23-69 (`cross_entropy` with hard labels).
"""
from __future__ import annotations

import math

import torch

from ..ops.flash_attention import NEG_INF, flash_attention_values
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


def _sdpa(q, k, v, mask=None, causal=False):
    """Attention of (B, S, H, D) queries over (B, L, HK, D) keys and
    values in plain PyTorch: ≙ `_sdpa_xla`. The logits are the product
    in the inputs' dtype cast to f32, times 1/sqrt(D); ``causal`` masks
    the end-aligned upper triangle; a bool ``mask`` (broadcastable to
    (B, H, S, L)) keeps its True entries, any other mask is added to the
    logits; masked logits are -1e30. The softmax runs in f32 and its
    weights are cast to q's dtype for the weighted sum. GQA repeats each
    KV head H / HK times."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    rep = q.shape[1] // k.shape[1]
    if rep != 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() \
        * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        tri = torch.ones(qlen, klen, dtype=torch.bool,
                         device=logits.device).tril(klen - qlen)
        logits = logits.masked_fill(~tri, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, NEG_INF)
        else:
            logits = logits + mask.float()
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 use_kernel=None):
    """Attention in the (B, S, H, D) layout. Without a mask and without
    dropout it is flash attention (`ops.flash_attention`: the CUDA
    kernels for CUDA tensors, forward and backward; the plain versions
    on the CPU), as `F.scaled_dot_product_attention` routed to the
    Pallas kernel on the TPU; with a mask, the plain `_sdpa`. Dropout is
    not ported."""
    if dropout_p:
        raise NotImplementedError(
            "attention dropout is not ported yet (ROADMAP.md queue A, item "
            "15); pass dropout_p=0.0")
    if attn_mask is None:
        return flash_attention_values(query, key, value, causal=is_causal,
                                      use_kernel=use_kernel)
    return _sdpa(query, key, value, attn_mask, is_causal)


def cross_entropy(input, label, ignore_index=-100):
    """Mean softmax cross entropy of logits over the last axis with
    integer labels, computed in f32: ≙ `F.cross_entropy` with hard labels
    and ``reduction="mean"``. Rows whose label is ``ignore_index`` add
    nothing, and the mean divides by the number of the other rows (at
    least 1e-9, as JAX does). Soft labels, class weights, label smoothing
    and the other reductions are not ported."""
    logits = input.float().reshape(-1, input.shape[-1])
    lab = label.reshape(-1).long()
    nll = torch.nn.functional.cross_entropy(
        logits, lab, ignore_index=ignore_index, reduction="none")
    valid = (lab != ignore_index).sum().float()
    return nll.sum() / valid.clamp_min(1e-9)
