"""Fused-op functionals (≙ `paddle_tpu/incubate/nn/functional/__init__.py`).

The aliases name the port's kernels under the reference's names:
`flash_attention` is the ops-level flash attention ``(q, k, v, causal,
scale, window_size)`` (not `nn.functional.flash_attention`, which returns
a tuple), `flash_attention_varlen` the packed attention, `paged_attention`
the q = 1 paged decode, `fused_rotary_position_embedding` the rope
kernel, and `fused_rms_norm` / `fused_layer_norm` the norm kernels.

The compositions are plain PyTorch around those kernels, as the JAX
package composes them for XLA to fuse: their LayerNorms go through the
LayerNorm kernel (`nn.functional.layer_norm`) and their attention through
`nn.functional.scaled_dot_product_attention` (the flash kernels without a
mask and without dropout). Dropout masks come from ``generator``; they
match the JAX package's only at rate 0.
"""
from __future__ import annotations

import torch

from ...nn import functional as F
from ...ops.flash_attention import \
    flash_attention_values as flash_attention  # noqa: F401
from ...ops.flash_varlen import flash_attention_varlen  # noqa: F401
from ...ops.norm_kernels import \
    layer_norm_values as fused_layer_norm  # noqa: F401
from ...ops.norm_kernels import rms_norm_values as fused_rms_norm  # noqa: F401
from ...ops.paged_attention import \
    paged_attention_values as paged_attention  # noqa: F401
from ...ops.rope import fused_rotary_position_embedding  # noqa: F401


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", use_kernel=None, generator=None):
    """LayerNorm(residual + dropout(x + bias)); a missing scale or bias of
    the LayerNorm is ones or zeros (`nn.functional.layer_norm`)."""
    if bias is not None:
        x = x + bias
    if dropout_rate:
        x = F.dropout(x, dropout_rate, training, generator, mode)
    y = residual + x
    return F.layer_norm(y, y.shape[-1:], ln_scale, ln_bias, ln_epsilon,
                        use_kernel)


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None,
                               ln_bias=None, pre_ln_epsilon=1e-5,
                               qkv_bias=None, linear_bias=None,
                               cache_kv=None, attn_mask=None,
                               dropout_rate=0.5, attn_dropout_rate=0.5,
                               ln_epsilon=1e-5, training=True,
                               mode="upscale_in_train", ring_id=-1,
                               add_residual=True, num_heads=-1,
                               transpose_qkv_wb=False, use_kernel=None,
                               generator=None):
    """(pre-)LN -> QKV projection -> attention -> out projection ->
    dropout -> residual -> (post-)LN on x (B, S, E).

    ``qkv_weight`` is (3, H, head_dim, E), the reference's fused layout,
    or (E, 3E) with ``transpose_qkv_wb`` (then ``num_heads`` is needed);
    ``qkv_bias`` (3, H, head_dim) or (3E,); ``linear_weight`` (E, E) is
    (in, out), applied as ``out @ linear_weight``. ``cache_kv`` raises,
    as in JAX: decoding uses the model-level KV cache."""
    if cache_kv is not None:
        raise NotImplementedError(
            "fused_multi_head_attention cache_kv: use the model-level KV "
            "cache for decoding")
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, x.shape[-1:], pre_ln_scale, pre_ln_bias,
                         pre_ln_epsilon, use_kernel)
    b, s, e = x.shape[0], x.shape[1], x.shape[-1]
    if transpose_qkv_wb:
        if num_heads <= 0:
            raise ValueError("num_heads required with transpose_qkv_wb")
        h, hd = num_heads, e // num_heads
        qkv = torch.matmul(x, qkv_weight)
        if qkv_bias is not None:
            qkv = qkv + qkv_bias
    else:
        h, hd = qkv_weight.shape[1], qkv_weight.shape[2]
        qkv = torch.nn.functional.linear(x, qkv_weight.reshape(3 * h * hd, e))
        if qkv_bias is not None:
            qkv = qkv + qkv_bias.reshape(-1)
    qkv = qkv.reshape(b, s, 3, h, hd)
    out = F.scaled_dot_product_attention(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0, training=training,
        use_kernel=use_kernel, generator=generator)
    out = torch.matmul(out.reshape(b, s, h * hd), linear_weight)
    if linear_bias is not None:
        out = out + linear_bias
    if dropout_rate and training:
        out = F.dropout(out, dropout_rate, training, generator, mode)
    if add_residual:
        out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1:], ln_scale, ln_bias,
                           ln_epsilon, use_kernel)
    return out


def swiglu(x, y=None):
    """silu(x) * y; with ``y`` None, x's last axis split in half (the
    fused-gate convention)."""
    if y is None:
        half = x.shape[-1] // 2
        x, y = x[..., :half], x[..., half:]
    return F.silu(x) * y


def fused_linear(x, weight, bias=None, transpose_weight=False):
    """``x @ weight (+ bias)``, the weight (in, out), or (out, in) with
    ``transpose_weight``."""
    out = torch.matmul(x, weight.transpose(-1, -2) if transpose_weight
                       else weight)
    return out + bias if bias is not None else out


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation="gelu"):
    """act(x @ y + bias), x and y transposed (last two axes) on request;
    ``activation`` one of "gelu" (exact), "relu" or none."""
    out = torch.matmul(x.transpose(-1, -2) if trans_x else x,
                       y.transpose(-1, -2) if trans_y else y) + bias
    if activation in ("gelu", "relu"):
        return getattr(F, activation)(out)
    if activation in (None, "none", ""):
        return out
    raise ValueError(f"unsupported activation {activation}")
