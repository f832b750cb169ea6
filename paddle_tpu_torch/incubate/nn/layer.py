"""Fused layer classes (≙ `paddle_tpu/incubate/nn/layer.py`).

`FusedLinear`, `FusedDropoutAdd`, `FusedBiasDropoutResidualLayerNorm`,
`FusedMultiHeadAttention`, `FusedFeedForward`,
`FusedTransformerEncoderLayer` and `FusedRMSNorm`, with the reference's
parameter names and layouts: the weights are (in, out) as the JAX layer
stores them, and the attention's QKV weight is the fused (3, H,
head_dim, E) (`models.convert.fused_layer_state_from_numpy` carries them
across unchanged). Each layer is built on an explicit ``device`` (the
card unless the caller names another, `ops.resolve_device`); weights are
drawn from a CPU generator seeded with ``seed`` (XavierNormal, biases 0,
norm scales 1, as the JAX initialisers), and ``generator`` draws the
dropout masks. The math is `incubate.nn.functional`'s.
"""
from __future__ import annotations

import torch

from ...nn import functional as F
from ...ops import resolve_device
from . import functional as IF


def _param(shape, device, dtype, fill=None, gen=None):
    """A parameter of ``shape``: ``fill`` everywhere, or XavierNormal from
    ``gen`` (on the CPU, then moved)."""
    t = torch.empty(shape, dtype=torch.float32)
    if fill is None:
        torch.nn.init.xavier_normal_(t, generator=gen)
    else:
        t.fill_(fill)
    return torch.nn.Parameter(t.to(device=device, dtype=dtype))


class _Fused(torch.nn.Module):
    def __init__(self, device=None, dtype=None, seed=0):
        super().__init__()
        self._kw = dict(device=resolve_device(device),
                        dtype=dtype or torch.float32)
        self._gen = torch.Generator().manual_seed(seed)

    def _weight(self, *shape):
        return _param(shape, gen=self._gen, **self._kw)

    def _const(self, *shape, fill):
        return _param(shape, fill=fill, **self._kw)


class FusedLinear(_Fused):
    """``x @ weight + bias``; ``weight`` (in, out), or (out, in) with
    ``transpose_weight``; no bias with ``bias_attr=False``."""

    def __init__(self, in_features, out_features, bias_attr=None,
                 transpose_weight=False, device=None, dtype=None, seed=0):
        super().__init__(device, dtype, seed)
        shape = ((out_features, in_features) if transpose_weight
                 else (in_features, out_features))
        self.weight = self._weight(*shape)
        self.bias = None if bias_attr is False else \
            self._const(out_features, fill=0.0)
        self._transpose = transpose_weight

    def forward(self, x):
        return IF.fused_linear(x, self.weight, self.bias, self._transpose)


class FusedDropoutAdd(torch.nn.Module):
    """dropout(x) + y."""

    def __init__(self, p=0.5, mode="upscale_in_train", generator=None):
        super().__init__()
        self._p, self._mode = p, mode
        self.generator = generator

    def forward(self, x, y):
        return F.dropout(x, self._p, self.training, self.generator,
                         self._mode) + y


class FusedBiasDropoutResidualLayerNorm(_Fused):
    """LayerNorm(residual + dropout(x + linear_bias))."""

    def __init__(self, embed_dim, dropout_rate=0.5, epsilon=1e-5,
                 device=None, dtype=None, seed=0, generator=None):
        super().__init__(device, dtype, seed)
        self.linear_bias = self._const(embed_dim, fill=0.0)
        self.ln_scale = self._const(embed_dim, fill=1.0)
        self.ln_bias = self._const(embed_dim, fill=0.0)
        self._dropout_rate = dropout_rate
        self._epsilon = epsilon
        self.generator = generator

    def forward(self, x, residual, use_kernel=None):
        return IF.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self._dropout_rate,
            ln_epsilon=self._epsilon, training=self.training,
            use_kernel=use_kernel, generator=self.generator)


class FusedMultiHeadAttention(_Fused):
    """Self-attention with the fused (3, H, head_dim, E) QKV weight, pre-
    or post-LN (`IF.fused_multi_head_attention`)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, normalize_before=False,
                 epsilon=1e-5, device=None, dtype=None, seed=0,
                 generator=None):
        super().__init__(device, dtype, seed)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        hd = embed_dim // num_heads
        self.num_heads = num_heads
        self.normalize_before = normalize_before
        self.qkv_weight = self._weight(3, num_heads, hd, embed_dim)
        self.qkv_bias = self._const(3, num_heads, hd, fill=0.0)
        self.linear_weight = self._weight(embed_dim, embed_dim)
        self.linear_bias = self._const(embed_dim, fill=0.0)
        self.pre_ln_scale = self._const(embed_dim, fill=1.0)
        self.pre_ln_bias = self._const(embed_dim, fill=0.0)
        self.ln_scale = self._const(embed_dim, fill=1.0)
        self.ln_bias = self._const(embed_dim, fill=0.0)
        self._dropout_rate = dropout_rate
        self._attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon
        self.generator = generator

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, use_kernel=None):
        return IF.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self._epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, cache_kv=cache,
            attn_mask=attn_mask, dropout_rate=self._dropout_rate,
            attn_dropout_rate=self._attn_dropout_rate,
            ln_epsilon=self._epsilon, training=self.training,
            num_heads=self.num_heads, use_kernel=use_kernel,
            generator=self.generator)


class FusedFeedForward(_Fused):
    """(pre-)LN -> linear1 -> activation -> dropout -> linear2 -> dropout
    -> residual -> (post-)LN, one LayerNorm (``ln_scale``, ``ln_bias``)
    before or after."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, device=None, dtype=None, seed=0,
                 generator=None):
        super().__init__(device, dtype, seed)
        self.linear1_weight = self._weight(d_model, dim_feedforward)
        self.linear1_bias = self._const(dim_feedforward, fill=0.0)
        self.linear2_weight = self._weight(dim_feedforward, d_model)
        self.linear2_bias = self._const(d_model, fill=0.0)
        self.ln_scale = self._const(d_model, fill=1.0)
        self.ln_bias = self._const(d_model, fill=0.0)
        self._dropout_rate = dropout_rate
        self._act_dropout = (dropout_rate if act_dropout_rate is None
                             else act_dropout_rate)
        self._act = activation
        self._epsilon = epsilon
        self.normalize_before = normalize_before
        self.generator = generator

    def forward(self, src, use_kernel=None):
        residual = src
        if self.normalize_before:
            src = F.layer_norm(src, src.shape[-1], self.ln_scale,
                               self.ln_bias, self._epsilon, use_kernel)
        h = torch.matmul(src, self.linear1_weight) + self.linear1_bias
        h = getattr(F, self._act)(h)
        h = F.dropout(h, self._act_dropout, self.training, self.generator)
        h = torch.matmul(h, self.linear2_weight) + self.linear2_bias
        h = F.dropout(h, self._dropout_rate, self.training, self.generator)
        out = residual + h
        if not self.normalize_before:
            out = F.layer_norm(out, out.shape[-1], self.ln_scale,
                               self.ln_bias, self._epsilon, use_kernel)
        return out


class FusedTransformerEncoderLayer(torch.nn.Module):
    """`FusedMultiHeadAttention` then `FusedFeedForward`, one
    ``generator`` for both."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, device=None,
                 dtype=None, seed=0, generator=None):
        super().__init__()
        ad = dropout_rate if attn_dropout_rate is None else \
            attn_dropout_rate
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=ad, normalize_before=normalize_before,
            device=device, dtype=dtype, seed=seed, generator=generator)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, device=device, dtype=dtype,
            seed=seed + 1, generator=generator)

    def forward(self, src, src_mask=None, cache=None, use_kernel=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask,
                                        cache=cache, use_kernel=use_kernel),
                        use_kernel=use_kernel)


class FusedRMSNorm(_Fused):
    """RMSNorm with a learned scale (ones) through the RMSNorm kernels."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__(device, dtype)
        self.weight = self._const(hidden_size, fill=1.0)
        self._epsilon = epsilon

    def forward(self, x, use_kernel=None):
        return IF.fused_rms_norm(x, self.weight, self._epsilon, use_kernel)
