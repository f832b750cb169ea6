"""BERT for masked-LM.

≙ `paddle_tpu/models/bert.py`: `BertConfig` (``base``, ``tiny``),
`BertEmbeddings`, `BertModel` (a post-LN `TransformerEncoder` and a tanh
pooler), `BertLMHead` (transform, GELU, LayerNorm, the decoder tied to
the word embedding) and `BertForMaskedLM(labels=)`. Every LayerNorm runs
the port's LayerNorm kernels on the card (26 forward and 26 backward
launches a training step at BERT-base: the embeddings', two per layer,
the LM head's). Attention is flash attention without dropout and without
a mask, else the plain masked path, as in JAX: BERT's configured
attention dropout (0.1) sends it to the plain path.

The LM head's decoder is the word embedding's own `Parameter`, read
through the embedding module, so both uses add to one gradient and the
state dict holds it once (as the JAX package's does). Weights are random
from a seed with the JAX initialisers (Normal(0, 1) embeddings,
Xavier-normal Linears, zero biases, unit LayerNorm scales); every encoder
layer starts as a copy of the first, as the JAX `TransformerEncoder`
makes them. `models.convert.bert_state_from_numpy` carries a JAX model's
weights.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..nn import functional as F
from ..nn.layers import GELU, Dropout, LayerNorm, set_generator
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer
from ..ops import resolve_device


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=1024, hidden_size=128,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=512, max_position_embeddings=128)

    def num_params(self) -> int:
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        layer = 4 * h * h + 4 * h + 2 * h * i + i + h + 4 * h
        emb = (v + self.max_position_embeddings + self.type_vocab_size) * h \
            + 2 * h
        head = h * h + h + 2 * h + v
        return emb + self.num_hidden_layers * layer + h * h + h + head


@torch.no_grad()
def _init(module: torch.nn.Module, generator: Optional[torch.Generator]):
    """The JAX initialisers over ``module``'s own submodules."""
    for m in module.modules():
        if isinstance(m, torch.nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, torch.nn.Linear):
            out_f, in_f = m.weight.shape
            m.weight.normal_(0.0, math.sqrt(2.0 / (in_f + out_f)),
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            if m.weight is not None:
                m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()


class BertEmbeddings(torch.nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.word_embeddings = torch.nn.Embedding(cfg.vocab_size, h, **kw)
        self.position_embeddings = torch.nn.Embedding(
            cfg.max_position_embeddings, h, **kw)
        self.token_type_embeddings = torch.nn.Embedding(
            cfg.type_vocab_size, h, **kw)
        self.layer_norm = LayerNorm(h, cfg.layer_norm_eps, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, use_kernel=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = self.word_embeddings(input_ids.long()) \
            + self.position_embeddings(pos)[None]
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids.long())
        return self.dropout(self.layer_norm(emb, use_kernel))


class BertModel(torch.nn.Module):
    """``generator`` initialises the weights (the encoder's first layer
    before it is copied)."""

    def __init__(self, cfg: BertConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, **kw)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob,
            layer_norm_eps=cfg.layer_norm_eps, **kw)
        _init(self.embeddings, generator)
        _init(enc_layer, generator)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_hidden_layers)
        self.pooler = torch.nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        _init(self.pooler, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                use_kernel=None):
        """Returns (sequence (B, S, H), pooled (B, H)). A (B, S) 1/0
        ``attention_mask`` becomes an additive -1e4 key mask."""
        x = self.embeddings(input_ids, token_type_ids, use_kernel)
        mask = None
        if attention_mask is not None:
            mask = ((1.0 - attention_mask.float()) * -1e4)[:, None, None, :]
        seq = self.encoder(x, mask, use_kernel)
        pooled = torch.tanh(self.pooler(seq[:, 0]))
        return seq, pooled


class BertLMHead(torch.nn.Module):
    """transform -> GELU -> LayerNorm -> the tied decoder plus its own
    bias. ``embedding`` is the word-embedding module whose weight is the
    decoder; it is held outside this module's parameters, so the weight
    is one parameter of the model, owned by the embeddings."""

    def __init__(self, cfg: BertConfig, embedding: torch.nn.Embedding,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.transform = torch.nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                         **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    **kw)
        self.act = GELU()
        self._embedding = (embedding,)
        self.decoder_bias = torch.nn.Parameter(
            torch.zeros(cfg.vocab_size, **kw))
        _init(self, generator)

    def forward(self, hidden, use_kernel=None):
        h = self.layer_norm(self.act(self.transform(hidden)), use_kernel)
        return torch.nn.functional.linear(h, self._embedding[0].weight,
                                          self.decoder_bias)


class BertForMaskedLM(torch.nn.Module):
    """BERT masked LM. Builds on the CUDA card unless ``device`` names
    another device (without CUDA and without a device it raises);
    ``dtype`` defaults to float32. ``seed`` seeds one `torch.Generator`
    (on the build device) that initialises the weights and then draws
    every dropout mask, so a seed repeats a run."""

    def __init__(self, cfg: BertConfig | None = None, device=None,
                 dtype=None, seed: int = 0):
        super().__init__()
        cfg = cfg or BertConfig.base()
        device = resolve_device(device)
        dtype = dtype if dtype is not None else torch.float32
        self.config = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        self.bert = BertModel(cfg, device, dtype, gen)
        self.cls = BertLMHead(cfg, self.bert.embeddings.word_embeddings,
                              device, dtype, gen)
        set_generator(self, gen)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None, use_kernel=None):
        """Logits (B, S, vocab); with ``labels`` (B, S) (-100 ignored)
        ``(loss, logits)``, the mean cross entropy in f32."""
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask,
                           use_kernel)
        logits = self.cls(seq, use_kernel)
        if labels is not None:
            loss = F.cross_entropy(
                logits.reshape(-1, self.config.vocab_size),
                labels.reshape(-1), ignore_index=-100)
            return loss, logits
        return logits
