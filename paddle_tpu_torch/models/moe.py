"""MoE causal-LM family (Qwen2-MoE / DeepSeekMoE shape).

≙ `paddle_tpu/models/moe.py`: `MoEConfig` (:25, with `qwen2_moe_a14b`,
`small`, `tiny`), `MoEDecoderLayer`, `MoEModel` and `MoEForCausalLM`
(:131, ``labels=`` adds ``router_aux_loss_coef`` times the layers'
summed aux loss to the mean cross entropy). Attention is the port's
`LlamaAttention` no-cache path (causal flash attention: the CUDA kernels
on the card); the MLP is `incubate.moe.MoELayer`, whose dropless path
runs the grouped-matmul kernel. Weights are random from a seed with the
JAX initialisers; `models.convert.moe_state_from_numpy` carries a JAX
model's. ``shard_moe_model`` needs a mesh and is not ported (ROADMAP.md
queue A, items 12 and 15).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..incubate.moe import MoELayer
from ..nn import functional as F
from ..nn.layers import RMSNorm
from ..ops import resolve_device
from .llama import LlamaAttention, LlamaConfig, precompute_rope


@dataclass
class MoEConfig:
    """The JAX `MoEConfig` without ``dtype``, which no code reads (the
    dtype is the model's build argument)."""

    vocab_size: int = 151936
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    num_experts: int = 60
    num_experts_per_tok: int = 4
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632
    capacity_factor: float = 1.25
    dropless: bool = False   # sort-based ragged dispatch (no token drops)
    router_aux_loss_coef: float = 0.001

    @staticmethod
    def qwen2_moe_a14b():
        """Qwen2-57B-A14B shape."""
        return MoEConfig(hidden_size=3584, num_hidden_layers=28,
                         num_attention_heads=28, num_key_value_heads=4,
                         num_experts=64, num_experts_per_tok=8,
                         moe_intermediate_size=2560,
                         shared_expert_intermediate_size=20480)

    @staticmethod
    def small():
        """~8x160M single-host training shape."""
        return MoEConfig(vocab_size=32000, hidden_size=768,
                         num_hidden_layers=8, num_attention_heads=12,
                         num_key_value_heads=4,
                         max_position_embeddings=2048, num_experts=8,
                         num_experts_per_tok=2, moe_intermediate_size=512,
                         shared_expert_intermediate_size=1024)

    @staticmethod
    def tiny():
        return MoEConfig(vocab_size=512, hidden_size=64,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2,
                         max_position_embeddings=128, num_experts=4,
                         num_experts_per_tok=2, moe_intermediate_size=96,
                         shared_expert_intermediate_size=128)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    def _as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.moe_intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta)

    def num_params(self) -> int:
        """Every parameter: embedding, lm_head, and per layer the
        attention, both norms, the router, the routed and shared
        experts."""
        return self._count(self.num_experts, True)

    def active_params(self) -> int:
        """The parameters one token's forward multiplies by: the
        embedding row is a lookup, so the lm_head, and per layer the
        attention, the router, its top-k routed experts and the shared
        expert (what a MoE's MFU is counted over)."""
        return self._count(self.num_experts_per_tok, False)

    def _count(self, experts: int, embedding: bool) -> int:
        h, d = self.hidden_size, self.head_dim
        kv = self.num_key_value_heads * d
        attn = 2 * h * self.num_attention_heads * d + 2 * h * kv
        moe = (h * self.num_experts + experts * 3 * h
               * self.moe_intermediate_size
               + 3 * h * self.shared_expert_intermediate_size)
        per_layer = attn + moe + (2 * h if embedding else 0)
        emb = self.vocab_size * h * (2 if embedding else 1)
        return self.num_hidden_layers * per_layer + emb + (
            h if embedding else 0)


class MoEDecoderLayer(torch.nn.Module):
    def __init__(self, cfg: MoEConfig, device=None, dtype=None, prefix=""):
        super().__init__()
        eps = cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps, device, dtype)
        self.self_attn = LlamaAttention(cfg._as_llama(), device, dtype,
                                        f"{prefix}self_attn.")
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps,
                                                device, dtype)
        self.mlp = MoELayer(
            cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts,
            top_k=cfg.num_experts_per_tok,
            capacity_factor=cfg.capacity_factor, dropless=cfg.dropless,
            shared_intermediate_size=cfg.shared_expert_intermediate_size,
            device=device, dtype=dtype)

    def forward(self, x, cos, sin, attention_mask=None, use_kernel=None):
        x = x + self.self_attn(self.input_layernorm(x, use_kernel), cos, sin,
                               use_kernel=use_kernel,
                               attention_mask=attention_mask)
        mlp_out, aux = self.mlp(self.post_attention_layernorm(x, use_kernel),
                                use_kernel)
        return x + mlp_out, aux


class MoEModel(torch.nn.Module):
    def __init__(self, cfg: MoEConfig, device=None, dtype=None):
        super().__init__()
        self.config = cfg
        self.embed_tokens = torch.nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        self.layers = torch.nn.ModuleList(
            [MoEDecoderLayer(cfg, device, dtype, f"model.layers.{i}.")
             for i in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device,
                            dtype)
        cos, sin = precompute_rope(cfg.head_dim,
                                   cfg.max_position_embeddings,
                                   cfg.rope_theta)
        # the tables take the model's dtype, as `LlamaModel`'s do
        rope_dt = dtype if dtype is not None else torch.float32
        self.register_buffer("rope_cos", cos.to(device, rope_dt),
                             persistent=False)
        self.register_buffer("rope_sin", sin.to(device, rope_dt),
                             persistent=False)

    def forward(self, input_ids, attention_mask=None, use_kernel=None):
        """Returns (final hidden (B, S, H), the layers' summed aux
        loss)."""
        x = self.embed_tokens(input_ids.long())
        aux_total = None
        for layer in self.layers:
            x, aux = layer(x, self.rope_cos, self.rope_sin, attention_mask,
                           use_kernel)
            aux_total = aux if aux_total is None else aux_total + aux
        return self.norm(x, use_kernel), aux_total


class MoEForCausalLM(torch.nn.Module):
    """MoE causal LM. Builds on the CUDA card unless ``device`` names
    another device (without CUDA and without a device it raises);
    ``dtype`` defaults to float32; ``seed`` seeds the `torch.Generator`
    (on the build device) of the JAX initialisers: Normal(0, 1)
    embeddings, Xavier-normal Linears and experts, a Normal(0, 0.02)
    router, unit norm scales."""

    def __init__(self, cfg: MoEConfig | None = None, device=None,
                 dtype=None, seed: int = 0):
        super().__init__()
        cfg = cfg or MoEConfig()
        device = resolve_device(device)
        dtype = dtype if dtype is not None else torch.float32
        self.config = cfg
        self.model = MoEModel(cfg, device, dtype)
        self.lm_head = torch.nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                       bias=False, device=device,
                                       dtype=dtype)
        self.init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for name, mod in self.named_modules():
            if isinstance(mod, MoELayer):
                mod.init_weights(generator)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
            elif isinstance(mod, torch.nn.Embedding):
                mod.weight.normal_(0.0, 1.0, generator=generator)
            elif isinstance(mod, torch.nn.Linear) and ".mlp." not in \
                    f".{name}.":
                out_f, in_f = mod.weight.shape
                mod.weight.normal_(0.0, math.sqrt(2.0 / (in_f + out_f)),
                                   generator=generator)

    def forward(self, input_ids, labels=None, attention_mask=None,
                use_kernel=None):
        """Logits (B, S, vocab); with ``labels`` (B, S) (-100 ignored)
        ``(loss, logits)``: the mean cross entropy of the f32 logits plus
        ``router_aux_loss_coef`` times the summed aux loss."""
        hidden, aux = self.model(input_ids, attention_mask, use_kernel)
        logits = self.lm_head(hidden)
        if labels is not None:
            loss = F.cross_entropy(
                logits.reshape(-1, self.config.vocab_size).float(),
                labels.reshape(-1), ignore_index=-100)
            loss = loss + self.config.router_aux_loss_coef * aux
            return loss, logits
        return logits


def shard_moe_model(model, mesh):
    """≙ `shard_moe_model`: needs a mesh, not ported."""
    from ..incubate.moe import shard_moe
    return shard_moe(model, mesh)
