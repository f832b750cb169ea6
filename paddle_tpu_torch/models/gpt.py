"""GPT-2/3 family causal LM: training and `generate()`.

≙ `paddle_tpu/models/gpt.py`: `GPTConfig` :20-50 (``gpt2``, ``tiny``,
``head_dim``, ``num_key_value_heads``), `GPTAttention` :53-90,
`GPTBlock` :93-117 (pre-LN, tanh GELU), `GPTModel` :119-156 (learned
positions at an int, 0-d or (B,) offset), `GPTForCausalLM` :159-194 (the
head tied to ``wte``, f32 cross entropy with ``ignore_index=-100``) and
`synthetic_lm_batch` :197-202.

Attention has three branches, as in JAX:
- no cache (training, and a forward over a whole sequence): causal flash
  attention (`F.scaled_dot_product_attention`, the CUDA kernels forward
  and backward on the card);
- a (k, v) cache pair and S > 1 (the prefill of `generate()`): the new
  rows written into the caches IN PLACE at ``position_offset``, which
  must be an int, then causal flash attention over ``k_cache[:, :offset
  + S]``;
- a cache pair and S == 1 (a decode step): the row written, then the
  plain `F.masked_multihead_attention` over the cache, as JAX's XLA
  path.

Every LayerNorm runs the port's LayerNorm kernels on the card (2 a block
and ``ln_f``: 25 forward and 25 backward launches a training step at
GPT-2's 12 layers). `generate()` comes from `GenerationMixin`, which
reads the decoder stack as ``self.model`` (here the ``transformer``
module itself, so the state dict keeps the JAX package's
``transformer.*`` names) and the vocab matmul as ``logits(hidden)``.
Weights are random from a seed with the JAX initialisers (Normal(0, 1)
embeddings, Xavier-normal Linears, zero biases, unit LayerNorm scales);
`models.convert.gpt_state_from_numpy` carries a JAX model's weights.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..nn import functional as F
from ..nn.layers import Dropout, LayerNorm, set_generator
from ..ops import resolve_device
from .bert import _init
from .generation import GenerationMixin
from .llama import _update_kv_cache

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "synthetic_lm_batch"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    dropout: float = 0.0
    tie_word_embeddings: bool = True

    @staticmethod
    def gpt2():
        return GPTConfig()

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=512, hidden_size=64,
                         num_hidden_layers=2, num_attention_heads=4,
                         intermediate_size=128,
                         max_position_embeddings=128)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self):
        # MHA: the KV cache is full-width (GenerationMixin contract)
        return self.num_attention_heads

    def num_params(self) -> int:
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        layer = 4 * h + 3 * h * h + 3 * h + h * h + h + 2 * h * i + i + h
        head = 0 if self.tie_word_embeddings else v * h
        return (v + self.max_position_embeddings) * h \
            + self.num_hidden_layers * layer + 2 * h + head


class GPTAttention(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.head_dim
        self.qkv = torch.nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size, **kw)
        self.proj = torch.nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, past_key_value=None, position_offset=0,
                use_kernel=None):
        b, s = x.shape[0], x.shape[1]
        q, k, v = self.qkv(x).reshape(b, s, 3, self.num_heads,
                                      self.head_dim).unbind(2)
        if past_key_value is None:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 use_kernel=use_kernel)
        else:
            k_cache, v_cache = past_key_value
            _update_kv_cache(k_cache, k, position_offset)
            _update_kv_cache(v_cache, v, position_offset)
            if s == 1:
                out = F.masked_multihead_attention(
                    q, k_cache, v_cache, seq_len=position_offset + 1)
            else:
                if not isinstance(position_offset, int):
                    raise ValueError(
                        "prefill (seq>1) needs a static position_offset")
                cur = position_offset + s
                # the cache prefix is a strided view; the kernel reads
                # dense rows
                out = F.scaled_dot_product_attention(
                    q, k_cache[:, :cur].contiguous(),
                    v_cache[:, :cur].contiguous(), is_causal=True,
                    use_kernel=use_kernel)
        return self.dropout(self.proj(out.reshape(b, s, -1)))


class GPTBlock(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.ln_1 = LayerNorm(h, cfg.layer_norm_eps, **kw)
        self.attn = GPTAttention(cfg, **kw)
        self.ln_2 = LayerNorm(h, cfg.layer_norm_eps, **kw)
        self.fc = torch.nn.Linear(h, cfg.intermediate_size, **kw)
        self.proj = torch.nn.Linear(cfg.intermediate_size, h, **kw)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, past_key_value=None, position_offset=0,
                use_kernel=None):
        x = x + self.attn(self.ln_1(x, use_kernel), past_key_value,
                          position_offset, use_kernel)
        h = self.proj(F.gelu(self.fc(self.ln_2(x, use_kernel)),
                             approximate=True))
        return x + self.dropout(h)


class GPTModel(torch.nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = cfg
        self.wte = torch.nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = torch.nn.Embedding(cfg.max_position_embeddings,
                                      cfg.hidden_size, **kw)
        self.drop = Dropout(cfg.dropout)
        self.h = torch.nn.ModuleList([GPTBlock(cfg, **kw)
                                      for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)

    def forward(self, input_ids, past_key_values=None, position_offset=0,
                use_kernel=None):
        """Hidden states (B, S, H). Token i sits at position
        ``position_offset + i``: an int, a 0-d tensor or a (B,) tensor of
        per-sequence offsets. ``past_key_values``: None, or one (k, v)
        cache pair (B, S_max, H, D) per block, written in place."""
        dev = input_ids.device
        pos = torch.arange(input_ids.shape[1], device=dev)
        if isinstance(position_offset, int):
            pos = pos + position_offset
        else:
            off = torch.as_tensor(position_offset, device=dev).long()
            pos = pos + (off[:, None] if off.ndim else off)
        x = self.drop(self.wte(input_ids.long()) + self.wpe(pos))
        if past_key_values is None:
            past_key_values = [None] * len(self.h)
        for blk, kv in zip(self.h, past_key_values, strict=True):
            x = blk(x, kv, position_offset, use_kernel)
        return self.ln_f(x, use_kernel)


class GPTForCausalLM(torch.nn.Module, GenerationMixin):
    """GPT for training and `generate()`. Builds on the CUDA card unless
    ``device`` names another device (without CUDA and without a device
    it raises); ``dtype`` defaults to float32. ``seed`` seeds one
    `torch.Generator` (on the build device) that initialises the weights
    and then draws every dropout mask."""

    def __init__(self, cfg: GPTConfig | None = None, device=None,
                 dtype=None, seed: int = 0):
        super().__init__()
        cfg = cfg or GPTConfig()
        device = resolve_device(device)
        dtype = dtype if dtype is not None else torch.float32
        self.config = cfg
        self.transformer = GPTModel(cfg, device, dtype)
        self.lm_head = None if cfg.tie_word_embeddings else torch.nn.Linear(
            cfg.hidden_size, cfg.vocab_size, bias=False, device=device,
            dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        _init(self, gen)
        set_generator(self, gen)

    @property
    def model(self) -> GPTModel:
        """The decoder stack `GenerationMixin` drives."""
        return self.transformer

    @property
    def device(self) -> torch.device:
        return self.transformer.wte.weight.device

    def logits(self, hidden, use_kernel=None):
        if self.lm_head is None:
            return F.linear(hidden, self.transformer.wte.weight)
        return self.lm_head(hidden)

    def forward(self, input_ids, past_key_values=None, position_offset=0,
                labels=None, use_cache=False, use_kernel=None):
        """Logits (B, S, vocab). With ``labels`` (B, S) (-100 ignored)
        ``(loss, logits)``, the mean cross entropy in f32; with caches and
        ``use_cache`` ``(logits, caches)`` (the same cache tensors,
        written in place). ``use_kernel`` goes to every kernel wrapper
        (None: route by device)."""
        hidden = self.transformer(input_ids, past_key_values,
                                  position_offset, use_kernel)
        logits = self.logits(hidden, use_kernel)
        if labels is not None:
            loss = F.cross_entropy(
                logits.reshape(-1, self.config.vocab_size).float(),
                labels.reshape(-1), ignore_index=-100)
            return loss, logits
        if use_cache and past_key_values is not None:
            return logits, list(past_key_values)
        return logits


def synthetic_lm_batch(batch_size, seq_len, vocab_size, seed=0):
    """(inputs, next-token labels), each (B, S) int32 on the CPU: the JAX
    package's numpy draws, id for id."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab_size, (batch_size, seq_len + 1),
                       dtype=np.int32)
    return (torch.from_numpy(np.ascontiguousarray(ids[:, :-1])),
            torch.from_numpy(np.ascontiguousarray(ids[:, 1:])))
