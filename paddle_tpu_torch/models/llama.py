"""Llama-3 family: the serving paths and the training forward.

≙ `paddle_tpu/models/llama.py` :28-105 (`LlamaConfig`, `precompute_rope`),
:108-146 (`apply_rope`), :166-177 (`_window_band`), :212-286
(`PagedKVCacheView`, `RaggedKVCacheView`), :304-473 (the paged decode
branch, the tuple-cache prefill branch and the no-cache branches of
`LlamaAttention.forward`), :475-652 (the ragged attention path with its
quantized-page branch :507-531, MLP, decoder, model) and :653-694
(`LlamaForCausalLM`, with ``labels=``). The serving engine drives three
paths:
- the ragged paged path: a packed (1, T) token axis of decode steps,
  prefills and chunk continuations, with the KV cache in page pools
  (one `RaggedKVCacheView` per layer);
- the legacy decode path: (B, 1) tokens, one per slot, each at its own
  position, over the page pools (one `PagedKVCacheView` per layer);
- the legacy prefill: one (1, S) prompt at an int ``position_offset``
  into per-layer (k, v) caches with a key-validity ``attention_mask``,
  in plain PyTorch (the JAX package runs it through `_sdpa_xla`, outside
  any Pallas kernel).
Training runs the no-cache forward (``past_key_values=None``): causal
flash attention over the whole (B, S) batch (`ops.flash_attention`, the
CUDA kernels forward and backward on the card), windowed when the config
has a ``sliding_window``, or the plain masked path under an
``attention_mask``; ``labels=`` adds the mean cross entropy. The
dense-cache decode and the context-parallel (``sep_strategy``) branch
raise `NotImplementedError`; activation recompute is not ported.

Linear weights are stored (out, in), the torch way; the JAX package
stores (in, out) (`models.convert` transposes). RoPE pairs are
interleaved, ``(x[..., 0::2], x[..., 1::2])``.

The serving engine hands the model the values its dispatch reads: the
optional ``weights`` mapping of `LlamaForCausalLM.forward`, {parameter
name: value}, which every parameter read consults before the module's
own parameter. A value is a tensor (a whole checkpoint swapped in with
`install_weights`), a `QuantizedWeight` (quantized serving) or a
`LoraWeight` (multi-LoRA serving); the Linear calls route the latter
two through `nn.functional.linear`. The model object is never changed,
so one bf16 model can serve a quantized engine, a multi-LoRA engine and
a full-width engine side by side (the JAX engine gets the same from
binding values per dispatch, `bind_state`). An explicit argument was
chosen over a scoped binding because it leaves no state on the modules
between calls and reads plainly at each call site.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..nn import functional as F
from ..nn.layers import RMSNorm
from ..ops import resolve_device
from ..ops.flash_attention import flash_attention_values
from ..ops.lora_epilogue import LoraWeight
from ..ops.paged_attention import (paged_append_values,
                                   paged_attention_values)
from ..ops.ragged_paged_attention import (NEG_INF,
                                          ragged_paged_attention_values,
                                          ragged_scatter_quantized,
                                          ragged_scatter_values)
from ..ops.rope import rope_rotate_values


@dataclass
class LlamaConfig:
    """The JAX `LlamaConfig` without ``recompute`` / ``recompute_policy``
    (activation recompute is not ported), ``sep_strategy`` (context
    parallelism needs a mesh) and ``dtype``, which no code reads (the
    dtype is the model's build argument)."""

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    sliding_window: Optional[int] = None

    @staticmethod
    def llama3_8b():
        return LlamaConfig()

    @staticmethod
    def tiny():
        return LlamaConfig(vocab_size=512, hidden_size=128,
                           intermediate_size=256, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=256)

    @staticmethod
    def tiny_draft():
        """A draft-sized sibling of `tiny()` sharing its vocabulary and
        rope coverage."""
        return LlamaConfig(vocab_size=512, hidden_size=64,
                           intermediate_size=128, num_hidden_layers=1,
                           num_attention_heads=2, num_key_value_heads=1,
                           max_position_embeddings=256)

    @staticmethod
    def small():
        """~110M parameters."""
        return LlamaConfig(vocab_size=32000, hidden_size=768,
                           intermediate_size=2048, num_hidden_layers=12,
                           num_attention_heads=12, num_key_value_heads=4,
                           max_position_embeddings=2048)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    def num_params(self) -> int:
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        kvh = self.num_key_value_heads * self.head_dim
        per_layer = (h * h + 2 * h * kvh + h * h) + 3 * h * i + 2 * h
        emb = v * h * (1 if self.tie_word_embeddings else 2)
        return self.num_hidden_layers * per_layer + emb + h


def precompute_rope(head_dim: int, max_len: int, theta: float):
    """(cos, sin) tables of shape (max_len, head_dim / 2): computed in
    float64 with numpy, stored as f32 — as the JAX package does."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                           / head_dim))
    t = np.arange(max_len, dtype=np.float64)
    freqs = np.outer(t, inv)
    return (torch.from_numpy(np.cos(freqs).astype(np.float32)),
            torch.from_numpy(np.sin(freqs).astype(np.float32)))


def _unported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A, item 3b: the "
        "dense-cache decode); the port runs the ragged paged path (a "
        "RaggedKVCacheView per layer), the legacy paged decode (a "
        "PagedKVCacheView per layer), the legacy prefill ((k, v) caches "
        "with an int position_offset) and the no-cache forward "
        "(past_key_value None)")


def apply_rope(x, cos, sin, position_offset=0):
    """x: (B, S, H, D) rotated at positions ``position_offset + i`` for
    row i: an int offset, or a (B,) tensor of per-sequence positions
    with S == 1 (a decode step, each slot at its own angle). The
    interleaved-pair rotation in f32 (`rope_rotate_values`), returned in
    x's dtype. ≙ `apply_rope`, whose serving calls take the XLA path
    (``use_pallas=False``)."""
    if isinstance(position_offset, int):
        s = x.shape[1]
        if position_offset + s > cos.shape[0]:
            raise ValueError(
                f"rope: position_offset {position_offset} + seq {s} "
                f"exceeds precomputed table length {cos.shape[0]}")
        rows = slice(position_offset, position_offset + s)
        cv = cos[rows].float()[None, :, None, :]
        sv = sin[rows].float()[None, :, None, :]
    elif position_offset.ndim == 1 and x.shape[1] == 1:
        pos = position_offset.long()
        cv = cos[pos].float()[:, None, None, :]
        sv = sin[pos].float()[:, None, None, :]
    else:
        _unported("rope with (B,) positions over S > 1 rows (the "
                  "speculative verify pass)")
    return rope_rotate_values(x, cv, sv)


def _window_band(s: int, n_keys: int, offset: int, window):
    """(s, n_keys) bool: q row i (global position i + offset) may attend
    key j iff j <= i + offset and, with a sliding window, j > i + offset
    - window. ≙ `_window_band`."""
    rows = np.arange(s)[:, None] + offset
    cols = np.arange(n_keys)[None, :]
    band = cols <= rows
    if window is not None:
        band &= cols > rows - window
    return band


class PagedKVCacheView:
    """`past_key_values` entry of one layer for the legacy decode path:
    the layer's page pools (HK, P, page_size, D) and the shared
    per-sequence block table (B, pps) int32. The new token's write
    position and the context length both come from the (B,)
    ``position_offset`` of the forward call. Decode only (S == 1); the
    attention appends the new K/V rows to the pools in place."""

    def __init__(self, k_pages, v_pages, block_tables):
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.block_tables = block_tables


class RaggedKVCacheView:
    """`past_key_values` entry of one layer for one packed ragged batch:
    the layer's page pools (HK, P, page_size, D), the shared block
    table (N, pps), the per-token ``token_seq`` / ``positions`` (T,)
    (-1 marks padding rows, which scatter to the trash page) and the
    per-sequence ``query_start`` / ``query_len`` / ``context_lens``
    (N,), all int32 tensors on the pools' device. ``block_q`` is the
    q-block size the packer aligned ``query_start`` to (decode passes
    1); ``pages_bound`` caps the plain version's page gather.
    ``k_scale``/``v_scale`` are the (P, page_size) f32 scale pools of
    int8 page pools (quantized serving), None for full-width pools.

    The attention writes the batch's new K/V rows into the pools in
    place (quantized on commit when the view has scales)."""

    def __init__(self, k_pages, v_pages, block_tables, token_seq,
                 positions, query_start, query_len, context_lens,
                 block_q=1, pages_bound=None, k_scale=None, v_scale=None):
        if (k_scale is None) != (v_scale is None):
            raise ValueError("k_scale and v_scale must be passed together")
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.block_tables = block_tables
        self.token_seq = token_seq
        self.positions = positions
        self.query_start = query_start
        self.query_len = query_len
        self.context_lens = context_lens
        self.block_q = int(block_q)
        self.pages_bound = None if pages_bound is None else int(pages_bound)


def _linear(h_in, h_out, device, dtype):
    return torch.nn.Linear(h_in, h_out, bias=False, device=device,
                           dtype=dtype)


def _bound(weights, name, own):
    """The value a dispatch reads for parameter ``name``: the one
    ``weights`` binds to it, else the module's own parameter ``own``."""
    return own if weights is None else weights.get(name, own)


def _proj(module, name, x, weights, use_kernel):
    """``x`` through the Linear ``module.<name>``: by the value that
    ``weights`` binds to its parameter name (a tensor, `QuantizedWeight`
    or `LoraWeight`), else by its own weight."""
    w = _bound(weights, f"{module.prefix}{name}.weight",
               getattr(module, name).weight)
    return F.linear(x, w, use_kernel=use_kernel)


class LlamaAttention(torch.nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None,
                 prefix=""):
        super().__init__()
        h, hd = cfg.hidden_size, cfg.head_dim
        self.prefix = prefix          # this module's parameter-name prefix
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = hd
        self.sliding_window = cfg.sliding_window
        self.q_proj = _linear(h, self.num_heads * hd, device, dtype)
        self.k_proj = _linear(h, self.num_kv_heads * hd, device, dtype)
        self.v_proj = _linear(h, self.num_kv_heads * hd, device, dtype)
        self.o_proj = _linear(self.num_heads * hd, h, device, dtype)

    def forward(self, x, cos, sin, past_key_value=None, use_kernel=None,
                weights=None, attention_mask=None, position_offset=0):
        """x: (B, S, hidden). ``past_key_value`` picks the path:
        - None: the no-cache forward of training (`_forward_full`), rope
          at ``position_offset`` (an int), ``attention_mask`` None or a
          mask broadcastable to (B, H, S, S) (a bool (B, S) key-validity
          mask too, with a sliding window);
        - a `RaggedKVCacheView`: a packed (1, T) batch (`_forward_ragged`);
        - a `PagedKVCacheView`: one decode token per sequence, S == 1,
          at the (B,) positions ``position_offset`` (`_forward_paged`);
        - a (k_cache, v_cache) pair of (B, S_max, HK, D) caches with an
          int ``position_offset`` and S > 1: a prefill
          (`_forward_prefill`), ``attention_mask`` a (B, >= offset + S)
          bool key-validity mask or None.
        ``weights`` as in `LlamaForCausalLM.forward`."""
        view = past_key_value
        if isinstance(view, RaggedKVCacheView):
            return self._forward_ragged(x, cos, sin, view, use_kernel,
                                        weights)
        paged = isinstance(view, PagedKVCacheView)
        prefill = isinstance(view, tuple) and x.shape[1] > 1 \
            and isinstance(position_offset, int)
        full = view is None and isinstance(position_offset, int)
        if not (paged or prefill or full):
            _unported("LlamaAttention without a RaggedKVCacheView, a "
                      "PagedKVCacheView, a prefill into (k, v) caches or "
                      "the no-cache forward")
        b, s = x.shape[0], x.shape[1]
        q = _proj(self, "q_proj", x, weights, use_kernel).reshape(
            b, s, self.num_heads, self.head_dim)
        k = _proj(self, "k_proj", x, weights, use_kernel).reshape(
            b, s, self.num_kv_heads, self.head_dim)
        v = _proj(self, "v_proj", x, weights, use_kernel).reshape(
            b, s, self.num_kv_heads, self.head_dim)
        q = apply_rope(q, cos, sin, position_offset)
        k = apply_rope(k, cos, sin, position_offset)
        if full:
            out = self._forward_full(q, k, v, attention_mask, use_kernel)
        elif paged:
            out = self._forward_paged(q, k, v, view, position_offset,
                                      use_kernel)
        else:
            out = self._forward_prefill(q, k, v, view, position_offset,
                                        attention_mask)
        return _proj(self, "o_proj", out.reshape(b, s, -1), weights,
                     use_kernel)

    def _forward_full(self, q, k, v, attention_mask, use_kernel):
        """≙ the no-cache branches :445-473 (the ``sep_strategy`` ring
        branch :434-444 needs a mesh and is not ported): causal
        attention over the batch's own (B, S) keys. Without a mask it is
        flash attention, windowed with a ``sliding_window``; with one,
        the plain masked path, the window band ANDed into a bool mask
        (a (B, S) one as key validity) or added as -1e30 to any other."""
        if attention_mask is None:
            return flash_attention_values(q, k, v, causal=True,
                                          window_size=self.sliding_window,
                                          use_kernel=use_kernel)
        am = attention_mask
        if self.sliding_window is not None:
            s = q.shape[1]
            band = torch.from_numpy(_window_band(s, s, 0,
                                                 self.sliding_window))
            band = band.to(q.device)[None, None]
            if am.dtype == torch.bool:
                if am.ndim == 2:
                    am = am[:, None, None, :]
                am = am & band
            else:
                am = am + torch.where(band, 0.0, NEG_INF).to(am.dtype)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                              is_causal=True,
                                              use_kernel=use_kernel)

    def _forward_paged(self, q, k, v, view, positions, use_kernel):
        """≙ the paged branch :324-357: append each sequence's new K/V
        row at its position (an inactive slot's all-trash block-table
        row sends it to page 0), then the q = 1 paged attention over
        context ``positions + 1``."""
        if q.shape[1] != 1:
            raise ValueError("paged KV cache is decode-only (seq_len == "
                             "1); a prefill scatters its rows with "
                             "paged_prefill_scatter")
        if not torch.is_tensor(positions) or positions.ndim != 1:
            raise ValueError("paged KV cache needs a (B,) position_offset "
                             "tensor")
        paged_append_values(view.k_pages, view.v_pages, k[:, 0], v[:, 0],
                            view.block_tables, positions)
        return paged_attention_values(
            q[:, 0], view.k_pages, view.v_pages, positions + 1,
            view.block_tables, window=self.sliding_window,
            use_kernel=use_kernel)

    def _forward_prefill(self, q, k, v, caches, offset, attention_mask):
        """≙ the tuple-cache branch :358-433 for S > 1 at an int offset:
        write the new rows into the caches IN PLACE at [offset, offset +
        S), then attend keys [0, offset + S) under the causal (and
        window) band ANDed with the key-validity mask. Plain PyTorch, as
        in JAX (`_sdpa_xla`, no Pallas kernel)."""
        k_cache, v_cache = caches
        s = q.shape[1]
        cur = offset + s
        k_cache[:, offset:cur] = k.to(k_cache.dtype)
        v_cache[:, offset:cur] = v.to(v_cache.dtype)
        mask = torch.from_numpy(_window_band(s, cur, offset,
                                             self.sliding_window))
        mask = mask.to(q.device)[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask[:, :cur].bool()[:, None, None, :]
        return F._sdpa(q, k_cache[:, :cur], v_cache[:, :cur], mask)

    def _forward_ragged(self, x, cos, sin, view, use_kernel, weights):
        """x: (1, T, hidden) packed tokens. Per-token RoPE, ONE scatter
        of every new K/V row into the pages, then ragged paged
        attention. With scale pools on the view the scatter quantizes
        on commit and the attention reads the post-scatter int8 pages
        and scales, so a prefill row attends exactly the values a later
        decode step would."""
        b, t = x.shape[0], x.shape[1]
        if b != 1:
            raise ValueError("ragged KV cache wants a packed (1, T, ...) "
                             "batch")
        x = x[0]
        q = _proj(self, "q_proj", x, weights, use_kernel).reshape(
            t, self.num_heads, self.head_dim)
        k = _proj(self, "k_proj", x, weights, use_kernel).reshape(
            t, self.num_kv_heads, self.head_dim)
        v = _proj(self, "v_proj", x, weights, use_kernel).reshape(
            t, self.num_kv_heads, self.head_dim)
        pos = view.positions.long()
        cv = cos[pos].float()[:, None, :]
        sv = sin[pos].float()[:, None, :]
        q = rope_rotate_values(q, cv, sv)
        k = rope_rotate_values(k, cv, sv)
        if view.k_scale is not None:
            ragged_scatter_quantized(view.k_pages, view.v_pages,
                                     view.k_scale, view.v_scale, k, v,
                                     view.block_tables, view.token_seq,
                                     view.positions)
        else:
            ragged_scatter_values(view.k_pages, view.v_pages, k, v,
                                  view.block_tables, view.token_seq,
                                  view.positions)
        out = ragged_paged_attention_values(
            q, view.k_pages, view.v_pages, view.query_start,
            view.query_len, view.context_lens, view.block_tables,
            window=self.sliding_window, block_q=view.block_q,
            use_kernel=use_kernel, pages_bound=view.pages_bound,
            k_scale=view.k_scale, v_scale=view.v_scale)
        return _proj(self, "o_proj", out.reshape(1, t, -1), weights,
                     use_kernel)


class LlamaMLP(torch.nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None,
                 prefix=""):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.prefix = prefix          # this module's parameter-name prefix
        self.gate_proj = _linear(h, i, device, dtype)
        self.up_proj = _linear(h, i, device, dtype)
        self.down_proj = _linear(i, h, device, dtype)

    def forward(self, x, use_kernel=None, weights=None):
        hmid = F.silu(_proj(self, "gate_proj", x, weights, use_kernel)) \
            * _proj(self, "up_proj", x, weights, use_kernel)
        return _proj(self, "down_proj", hmid, weights, use_kernel)


class LlamaDecoderLayer(torch.nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None,
                 prefix=""):
        super().__init__()
        eps = cfg.rms_norm_eps
        self.prefix = prefix          # this module's parameter-name prefix
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps, device, dtype)
        self.self_attn = LlamaAttention(cfg, device, dtype,
                                        f"{prefix}self_attn.")
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps,
                                                device, dtype)
        self.mlp = LlamaMLP(cfg, device, dtype, f"{prefix}mlp.")

    def forward(self, x, cos, sin, past_key_value=None, use_kernel=None,
                weights=None, attention_mask=None, position_offset=0):
        ln1 = _bound(weights, f"{self.prefix}input_layernorm.weight",
                     self.input_layernorm.weight)
        ln2 = _bound(weights, f"{self.prefix}post_attention_layernorm.weight",
                     self.post_attention_layernorm.weight)
        x = x + self.self_attn(self.input_layernorm(x, use_kernel, ln1),
                               cos, sin, past_key_value, use_kernel,
                               weights, attention_mask, position_offset)
        return x + self.mlp(self.post_attention_layernorm(x, use_kernel,
                                                          ln2),
                            use_kernel, weights)


class LlamaModel(torch.nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        self.embed_tokens = torch.nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        self.layers = torch.nn.ModuleList(
            [LlamaDecoderLayer(cfg, device, dtype, f"model.layers.{i}.")
             for i in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device,
                            dtype)
        cos, sin = precompute_rope(cfg.head_dim,
                                   cfg.max_position_embeddings,
                                   cfg.rope_theta)
        # the tables take the model's dtype, as `Module.to(dtype)` (and
        # the JAX `Layer.to`, which bench_decode.py builds its bf16
        # model with) casts buffers too: a bf16 model rotates with
        # bf16-rounded angles on both sides
        rope_dt = dtype if dtype is not None else torch.float32
        self.register_buffer("rope_cos", cos.to(device, rope_dt),
                             persistent=False)
        self.register_buffer("rope_sin", sin.to(device, rope_dt),
                             persistent=False)

    def forward(self, input_ids, past_key_values=None, use_kernel=None,
                weights=None, attention_mask=None, position_offset=0):
        """``past_key_values`` None runs the no-cache forward of every
        layer (training); the JAX ``recompute`` branch is not ported."""
        emb = _bound(weights, "model.embed_tokens.weight",
                     self.embed_tokens.weight)
        x = torch.nn.functional.embedding(input_ids.long(), emb)
        if past_key_values is None:
            past_key_values = [None] * len(self.layers)
        for layer, kv in zip(self.layers, past_key_values, strict=True):
            x = layer(x, self.rope_cos, self.rope_sin, kv, use_kernel,
                      weights, attention_mask, position_offset)
        return self.norm(x, use_kernel,
                         _bound(weights, "model.norm.weight",
                                self.norm.weight))


class LlamaForCausalLM(torch.nn.Module):
    """Llama for serving and training. Builds on the CUDA card unless ``device``
    names another device (without CUDA and without a device it raises
    RuntimeError). ``dtype`` defaults to float32, as the JAX model's
    parameters do; ``seed`` seeds the `torch.Generator` (on the build
    device) that initialises the weights with the JAX package's
    initialisers: Normal(0, 1) embeddings, Xavier-normal linears, unit
    norm scales."""

    def __init__(self, cfg: LlamaConfig | None = None, device=None,
                 dtype=None, seed: int = 0):
        super().__init__()
        cfg = cfg or LlamaConfig.llama3_8b()
        device = resolve_device(device)
        dtype = dtype if dtype is not None else torch.float32
        self.config = cfg
        self.model = LlamaModel(cfg, device, dtype)
        self.lm_head = None if cfg.tie_word_embeddings \
            else _linear(cfg.hidden_size, cfg.vocab_size, device, dtype)
        self.prefix = ""              # parameter-name prefix (`_proj`)
        self.init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif "embed_tokens" in name:
                p.normal_(0.0, 1.0, generator=generator)
            else:
                out_f, in_f = p.shape
                p.normal_(0.0, math.sqrt(2.0 / (in_f + out_f)),
                          generator=generator)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def logits(self, hidden, use_kernel=None, weights=None):
        """The vocab matmul. A tied head is the embedding, which is
        never quantized or adapted (the embed lookup is a gather, not a
        matmul)."""
        if self.lm_head is None:
            return F.linear(hidden, _bound(weights,
                                           "model.embed_tokens.weight",
                                           self.model.embed_tokens.weight))
        return _proj(self, "lm_head", hidden, weights, use_kernel)

    def forward(self, input_ids, past_key_values=None, rows=None,
                use_kernel=None, weights=None, attention_mask=None,
                position_offset=0, labels=None):
        """input_ids: (B, S) tokens; past_key_values: None for the
        no-cache forward (training), or one entry per layer (pools and
        caches updated in place) — a `RaggedKVCacheView` for
        a packed (1, T) batch, a `PagedKVCacheView` for a (B, 1) decode
        step at the (B,) positions ``position_offset``, or a (k, v)
        cache pair for a prefill at an int ``position_offset`` under the
        key-validity ``attention_mask`` (`LlamaAttention.forward`).
        Returns logits (B, S, vocab), or with ``rows`` (a (n,) index
        tensor into the packed axis of a (1, T) batch) only those rows'
        logits, (n, vocab) — the engine asks for the rows it samples and
        skips the rest of the vocab matmul. ``use_kernel`` goes to every
        kernel wrapper on the path (None: route by device). ``weights``:
        {parameter name, as in `named_parameters()`: value}; every
        parameter read takes the value named there instead of the
        module's own parameter (module docstring). A `LoraWeight` on the
        vocab head carries one adapter row per packed token; with
        ``rows`` it is cut to the sampled rows too.

        With ``labels`` (B, S) integer targets (-100 ignored) it returns
        ``(loss, logits)``: the mean cross entropy of the logits cast to
        f32, as the JAX model does (its labels arrive already shifted)."""
        hidden = self.model(input_ids, past_key_values, use_kernel, weights,
                            attention_mask, position_offset)
        if rows is not None:
            rows = rows.long()
            hidden = hidden[0, rows]
            head = None if weights is None else weights.get("lm_head.weight")
            if isinstance(head, LoraWeight):
                weights = {**weights, "lm_head.weight": head.take(rows)}
        logits = self.logits(hidden, use_kernel, weights)
        if labels is not None:
            loss = F.cross_entropy(
                logits.reshape(-1, self.config.vocab_size).float(),
                labels.reshape(-1), ignore_index=-100)
            return loss, logits
        return logits
