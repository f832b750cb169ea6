"""Transformer encoder layers.

≙ `paddle_tpu/nn/layer/transformer.py` :15 (`MultiHeadAttention`, self-
and cross-attention without the incremental cache), :79
(`TransformerEncoderLayer`, post-LN) and :118 (`TransformerEncoder`,
whose layers start as copies of the one it is given). Not ported yet
(ROADMAP.md queue A, item 15): the pre-LN layer (``normalize_before``),
a separate ``act_dropout``, different key/value widths, the encoder's
final ``norm``, and the decoder side. Attention goes through `F.scaled_dot_product_attention`:
flash attention (the CUDA kernels on the card) without a mask and
without dropout, the plain masked path otherwise, as in JAX.
"""
from __future__ import annotations

import copy

import torch

from . import functional as F
from .layers import Dropout, LayerNorm


class MultiHeadAttention(torch.nn.Module):
    """Input (B, S, E); q/k/v/out projections with bias. ``generator``
    (set by `layers.set_generator`) draws the attention dropout mask.
    The decoder's incremental ``cache`` is not ported."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, device=None,
                 dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.generator = None
        kw = dict(device=device, dtype=dtype)
        self.q_proj = torch.nn.Linear(embed_dim, embed_dim, **kw)
        self.k_proj = torch.nn.Linear(embed_dim, embed_dim, **kw)
        self.v_proj = torch.nn.Linear(embed_dim, embed_dim, **kw)
        self.out_proj = torch.nn.Linear(embed_dim, embed_dim, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                use_kernel=None):
        key = query if key is None else key
        value = key if value is None else value
        b, sq, sk = query.shape[0], query.shape[1], key.shape[1]
        q = self.q_proj(query).reshape(b, sq, self.num_heads, self.head_dim)
        k = self.k_proj(key).reshape(b, sk, self.num_heads, self.head_dim)
        v = self.v_proj(value).reshape(b, sk, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, use_kernel=use_kernel,
            generator=self.generator)
        return self.out_proj(out.reshape(b, sq, self.embed_dim))


class TransformerEncoderLayer(torch.nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, layer_norm_eps=1e-5,
                 device=None, dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        kw = dict(device=device, dtype=dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = torch.nn.Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(dropout)
        self.linear2 = torch.nn.Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, use_kernel=None):
        src = self.norm1(src + self.dropout1(
            self.self_attn(src, src, src, src_mask, use_kernel)), use_kernel)
        ffn = self.linear2(self.dropout(self.activation(self.linear1(src))))
        return self.norm2(src + self.dropout2(ffn), use_kernel)


class TransformerEncoder(torch.nn.Module):
    """``num_layers`` layers: the one given and deep copies of it, so
    every layer starts with the same weights, as in JAX."""

    def __init__(self, encoder_layer, num_layers):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])

    def forward(self, src, src_mask=None, use_kernel=None):
        for layer in self.layers:
            src = layer(src, src_mask, use_kernel)
        return src
