"""ERNIE on one device: pretraining (masked LM + sentence order) and
sequence classification.

≙ `paddle_tpu/models/ernie.py`: `ErnieConfig` :21-46, `ErnieEmbeddings`
:49-78 (word + position + token type + ERNIE's task-type tier, task ids
zero by default), `ErnieModel` :81-106 (a post-LN `TransformerEncoder`
and a tanh pooler), `ErnieForPretraining` :109-142 (the decoder tied to
the word embedding plus ``decoder_bias``, and the sentence-order head),
`ErnieForSequenceClassification` :145-165 and `synthetic_ernie_batch`
:204-214 (numpy, id for id). `shard_ernie` (:168-201, the 4D mesh
placements) is not ported (ROADMAP.md queue A, item 9).

The encoder is the port's `nn.transformer` (as JAX's reuses
`nn.TransformerEncoderLayer`) and the weights start as BERT's
(`models.bert._init`: Normal(0, 1) embeddings, Xavier-normal Linears,
zero biases, unit LayerNorm scales; every encoder layer a copy of the
first). Attention routes as in JAX: a (B, S) 1/0 ``attention_mask``
becomes the additive ``(1 - mask) * -1e4`` key mask of the plain
`_sdpa`, and so does attention dropout (ERNIE's configured 0.1); with
neither it is flash attention (the CUDA kernels on the card). Every
LayerNorm runs the port's LayerNorm kernels on the card (26 forward and
26 backward launches a pretraining step at ERNIE-base: the embeddings',
two a layer, the MLM head's). `models.convert.ernie_state_from_numpy`
carries a JAX model's weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..nn import functional as F
from ..nn.layers import Dropout, LayerNorm, set_generator
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer
from ..ops import resolve_device
from .bert import _init


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    task_type_vocab_size: int = 16
    use_task_id: bool = True
    layer_norm_eps: float = 1e-12

    @staticmethod
    def base():
        return ErnieConfig()

    @staticmethod
    def tiny():
        return ErnieConfig(vocab_size=1024, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=2,
                           intermediate_size=256,
                           max_position_embeddings=128)


class ErnieEmbeddings(torch.nn.Module):
    """Word + position + token type (+ task type: the ERNIE delta over
    BERT)."""

    def __init__(self, cfg: ErnieConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.word_embeddings = torch.nn.Embedding(cfg.vocab_size, h, **kw)
        self.position_embeddings = torch.nn.Embedding(
            cfg.max_position_embeddings, h, **kw)
        self.token_type_embeddings = torch.nn.Embedding(
            cfg.type_vocab_size, h, **kw)
        self.use_task_id = cfg.use_task_id
        if cfg.use_task_id:
            self.task_type_embeddings = torch.nn.Embedding(
                cfg.task_type_vocab_size, h, **kw)
        self.layer_norm = LayerNorm(h, cfg.layer_norm_eps, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None,
                use_kernel=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = self.word_embeddings(input_ids.long()) \
            + self.position_embeddings(pos)[None]
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids.long())
        if self.use_task_id:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            emb = emb + self.task_type_embeddings(task_type_ids.long())
        return self.dropout(self.layer_norm(emb, use_kernel))


class ErnieModel(torch.nn.Module):
    """``generator`` initialises the weights (the encoder's first layer
    before it is copied)."""

    def __init__(self, cfg: ErnieConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = cfg
        self.embeddings = ErnieEmbeddings(cfg, **kw)
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

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None,
                attention_mask=None, use_kernel=None):
        """Returns (sequence (B, S, H), pooled (B, H)). A (B, S) 1/0
        ``attention_mask`` becomes an additive -1e4 key mask."""
        x = self.embeddings(input_ids, token_type_ids, task_type_ids,
                            use_kernel)
        mask = None
        if attention_mask is not None:
            mask = ((1.0 - attention_mask.float()) * -1e4)[:, None, None, :]
        seq = self.encoder(x, mask, use_kernel)
        pooled = torch.tanh(self.pooler(seq[:, 0]))
        return seq, pooled


def _build(device, dtype, seed):
    device = resolve_device(device)
    dtype = dtype if dtype is not None else torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)
    return device, dtype, gen


class ErnieForPretraining(torch.nn.Module):
    """MLM head (tied decoder) + sentence-order head: the ERNIE
    pretraining objective pair. Builds on the CUDA card unless ``device``
    names another device (without CUDA and without a device it raises);
    ``dtype`` defaults to float32. ``seed`` seeds one `torch.Generator`
    (on the build device) that initialises the weights and then draws
    every dropout mask."""

    def __init__(self, cfg: ErnieConfig | None = None, device=None,
                 dtype=None, seed: int = 0):
        super().__init__()
        cfg = cfg or ErnieConfig.base()
        device, dtype, gen = _build(device, dtype, seed)
        kw = dict(device=device, dtype=dtype)
        self.config = cfg
        self.ernie = ErnieModel(cfg, device, dtype, gen)
        self.transform = torch.nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                         **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    **kw)
        self.decoder_bias = torch.nn.Parameter(
            torch.zeros(cfg.vocab_size, **kw))
        self.seq_relationship = torch.nn.Linear(cfg.hidden_size, 2, **kw)
        _init(self.transform, gen)
        _init(self.layer_norm, gen)
        _init(self.seq_relationship, gen)
        set_generator(self, gen)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None,
                attention_mask=None, labels=None, sop_labels=None,
                use_kernel=None):
        """``(logits (B, S, vocab), sop_logits (B, 2))``; with ``labels``
        (B, S) (-100 ignored) ``(loss, logits)``: the mean MLM cross
        entropy in f32, plus the sentence-order cross entropy when
        ``sop_labels`` (B,) are given."""
        seq, pooled = self.ernie(input_ids, token_type_ids, task_type_ids,
                                 attention_mask, use_kernel)
        h = self.layer_norm(F.gelu(self.transform(seq)), use_kernel)
        logits = F.linear(h, self.ernie.embeddings.word_embeddings.weight,
                          self.decoder_bias)
        sop_logits = self.seq_relationship(pooled)
        if labels is not None:
            loss = F.cross_entropy(
                logits.reshape(-1, self.config.vocab_size).float(),
                labels.reshape(-1), ignore_index=-100)
            if sop_labels is not None:
                loss = loss + F.cross_entropy(sop_logits.float(),
                                              sop_labels.reshape(-1))
            return loss, logits
        return logits, sop_logits


class ErnieForSequenceClassification(torch.nn.Module):
    """The pooled output, dropout (``dropout``, else the config's hidden
    dropout) and a linear classifier. Builds as `ErnieForPretraining`."""

    def __init__(self, cfg: ErnieConfig | None = None, num_classes: int = 2,
                 dropout=None, device=None, dtype=None, seed: int = 0):
        super().__init__()
        cfg = cfg or ErnieConfig.base()
        device, dtype, gen = _build(device, dtype, seed)
        self.config = cfg
        self.ernie = ErnieModel(cfg, device, dtype, gen)
        self.dropout = Dropout(dropout if dropout is not None
                               else cfg.hidden_dropout_prob)
        self.classifier = torch.nn.Linear(cfg.hidden_size, num_classes,
                                          device=device, dtype=dtype)
        _init(self.classifier, gen)
        set_generator(self, gen)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None,
                attention_mask=None, labels=None, use_kernel=None):
        """Logits (B, num_classes); with ``labels`` (B,) ``(loss,
        logits)``, the mean cross entropy in f32."""
        _, pooled = self.ernie(input_ids, token_type_ids, task_type_ids,
                               attention_mask, use_kernel)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            loss = F.cross_entropy(logits.float(), labels.reshape(-1))
            return loss, logits
        return logits


def shard_ernie(model, mesh):
    """The 4D-hybrid placements of the JAX package (dp x sharding x mp on
    one mesh) are not ported."""
    raise NotImplementedError("shard_ernie is not ported yet (ROADMAP.md "
                              "queue A, item 9)")


def synthetic_ernie_batch(batch_size, seq_len, vocab_size, mask_prob=0.15,
                          seed=0):
    """(ids (B, S), MLM labels (B, S) with -100 off the masked positions,
    sentence-order labels (B,)), int32 on the CPU: the JAX package's
    numpy draws, id for id (masked ids become 3)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab_size, (batch_size, seq_len), dtype=np.int32)
    labels = np.full((batch_size, seq_len), -100, np.int32)
    mask = rng.random((batch_size, seq_len)) < mask_prob
    labels[mask] = ids[mask]
    ids[mask] = 3
    sop = rng.integers(0, 2, (batch_size,), dtype=np.int32)
    return (torch.from_numpy(ids), torch.from_numpy(labels),
            torch.from_numpy(sop))
