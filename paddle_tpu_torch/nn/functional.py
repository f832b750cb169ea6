"""Functional layer math of the serving and training paths.

≙ `paddle_tpu/nn/functional/norm.py` :18-70 (`layer_norm`, `rms_norm`),
`nn/functional/common.py` :33-107 (`linear`, with its `LoraWeight` and
`QuantizedWeight` dispatch, and `dropout`), the `silu` and `gelu`
activations, `nn/functional/attention.py` :20-101 (`_sdpa_xla`,
`scaled_dot_product_attention` with its dropout branch) and
`nn/functional/loss.py` :23-69 (`cross_entropy` with hard labels).

Dropout draws its keep mask from a `torch.Generator` (the caller's, else
torch's default one on the tensor's device): the JAX package draws from
`jax.random` keys, so the two keep the same rate and scaling but not the
same bits.
"""
from __future__ import annotations

import math

import torch

from ..ops.flash_attention import NEG_INF, flash_attention_values
from ..ops.lora_epilogue import LoraWeight, lora_matmul_values
from ..ops.norm_kernels import layer_norm_values, rms_norm_values
from ..ops.quant_matmul import QuantizedWeight, dequant_matmul_values


def rms_norm(x, weight, epsilon=1e-6, use_kernel=None):
    """RMSNorm over the last axis. On the TPU `F.rms_norm` routed to the
    Pallas kernel; here CUDA tensors go to the CUDA kernel and CPU
    tensors to the plain version (`ops.norm_kernels.rms_norm_values`)."""
    return rms_norm_values(x, weight, epsilon, use_kernel=use_kernel)


def layer_norm(x, normalized_shape, weight, bias, epsilon=1e-5,
               use_kernel=None):
    """LayerNorm over the last axis with a weight and a bias:
    `ops.norm_kernels.layer_norm_values` (the CUDA kernels, forward and
    backward, for CUDA tensors; any row count), as `F.layer_norm` routed
    to the Pallas kernel on the TPU. The JAX functional's other cases
    (several normalised axes, no weight or no bias) are not ported
    (ROADMAP.md queue A, item 15)."""
    ns = list(normalized_shape) if isinstance(normalized_shape,
                                              (list, tuple)) \
        else [normalized_shape]
    if len(ns) != 1 or weight is None or bias is None:
        raise NotImplementedError(
            "layer_norm over several axes or without a weight and a bias "
            "is not ported yet (ROADMAP.md queue A, item 15)")
    return layer_norm_values(x, weight, bias, epsilon,
                             use_kernel=use_kernel)


def silu(x):
    return torch.nn.functional.silu(x)


def gelu(x, approximate=False):
    """GELU: the exact erf form, or the tanh approximation with
    ``approximate=True`` (≙ `jax.nn.gelu`)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def _keep_mask(shape, p, like, generator):
    """Bernoulli(1 - p) keep mask of ``shape`` on ``like``'s device."""
    u = torch.rand(shape, device=like.device, generator=generator)
    return u < 1.0 - p


def dropout(x, p=0.5, training=True, generator=None):
    """Dropout in the ``upscale_in_train`` mode (≙ `F.dropout` without
    ``axis``; the ``downscale_in_infer`` mode is not ported): in
    training each element is kept with probability 1 - p and scaled by
    1/(1 - p); at inference, the identity. The keep mask comes from
    ``generator`` (else torch's default generator of x's device)."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    keep = _keep_mask(x.shape, p, x, generator)
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


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


def _sdpa(q, k, v, mask=None, causal=False, dropout_p=0.0, generator=None):
    """Attention of (B, S, H, D) queries over (B, L, HK, D) keys and
    values in plain PyTorch: ≙ `_sdpa_xla`. The logits are the product
    in the inputs' dtype cast to f32, times 1/sqrt(D); ``causal`` masks
    the end-aligned upper triangle; a bool ``mask`` (broadcastable to
    (B, H, S, L)) keeps its True entries, any other mask is added to the
    logits; masked logits are -1e30. The softmax runs in f32 and its
    weights are cast to q's dtype for the weighted sum. GQA repeats each
    KV head H / HK times. ``dropout_p`` > 0 drops softmax weights (keep
    1 - p, kept ones scaled by 1/(1 - p), in f32 before the cast), as the
    dropout branch of `scaled_dot_product_attention` does in JAX."""
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
    p = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = _keep_mask(p.shape, dropout_p, p, generator)
        p = torch.where(keep, p / (1.0 - dropout_p), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, use_kernel=None,
                                 generator=None):
    """Attention in the (B, S, H, D) layout. Without a mask and with
    ``dropout_p`` 0 it is flash attention (`ops.flash_attention`: the
    CUDA kernels for CUDA tensors, forward and backward; the plain
    versions on the CPU), as `F.scaled_dot_product_attention` routed to
    the Pallas kernel on the TPU. Otherwise the plain `_sdpa`, as JAX
    sends it to XLA: with a mask, or with ``dropout_p`` > 0 (dropout on
    the softmax weights when ``training``, from ``generator``; none at
    inference)."""
    if attn_mask is None and dropout_p == 0.0:
        return flash_attention_values(query, key, value, causal=is_causal,
                                      use_kernel=use_kernel)
    return _sdpa(query, key, value, attn_mask, is_causal,
                 dropout_p if training else 0.0, generator)


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
