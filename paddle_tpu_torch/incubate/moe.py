"""Mixture-of-Experts SwiGLU FFN: capacity (dense) and dropless dispatch.

≙ `paddle_tpu/incubate/moe/__init__.py`: `moe_gating_values` (:61),
`moe_ffn_values` (:91, the capacity path: one-hot einsums, static
shapes), `_aux_loss` (:125), `_expert_ffn_rows` (:134) and
`moe_ffn_dropless_values` (:186, the sort-based megablox-style path
whose expert matmuls are grouped matmuls) and `MoELayer` (:391) with
dense shared experts. The casts are JAX's: the router in f32, SiLU in f32
and back to the row dtype, the combine in f32.

Expert weights keep the JAX layout, stacked: ``w_gate`` / ``w_up`` (E,
H, I) and ``w_down`` (E, I, H), and the router ``gate_weight`` (H, E).
The shared experts are `torch.nn.Linear`s ((out, in), as every Linear of
the port). On the dropless path the three expert matmuls go through
`ops.grouped_matmul.grouped_matmul_values`: the CUDA kernel on the card,
its plain version on the CPU. The groups are not padded to a tile: the
kernel takes unpadded groups (the TPU kernel's 128-row padding,
:153-169, is a TPU tiling matter).

Routing ties: `jax.lax.top_k` puts the lower index first among equal
values; `_top_k` sorts by (value descending, index ascending) with a
stable sort, so both pick the same experts in the same order.

Not ported (ROADMAP.md queue A, item 9: no mesh exists in the port):
the expert-parallel paths `moe_ffn_dropless_ep_values` (:228),
`_moe_ep_ragged` and `shard_moe` (:535), which raise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..nn import functional as F
from ..ops.grouped_matmul import grouped_matmul_values


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values, ties
    broken toward the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _aux_loss(probs: torch.Tensor, gate_idx: torch.Tensor) -> torch.Tensor:
    """Switch/GShard load-balance loss over each token's first choice:
    E · Σ_e f_e · p_e (f_e the share of tokens whose first choice is e,
    p_e the mean router probability of e)."""
    e = probs.shape[-1]
    f = torch.nn.functional.one_hot(gate_idx[:, 0], e).float().mean(0)
    return e * (f * probs.mean(0)).sum()


def moe_gating_values(logits: torch.Tensor, top_k: int, capacity: int):
    """GShard-style top-k capacity gating. ``logits`` (T, E) router
    scores. Returns (dispatch (T, E, C) {0, 1}, combine (T, E, C), aux
    loss), all f32. Priority is choice-major: every token's first choice
    takes its place in its expert's queue before any second choice."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)
    oh = torch.nn.functional.one_hot(gate_idx.T, e).float()     # (K, T, E)
    flat = oh.reshape(top_k * t, e)
    pos = torch.cumsum(flat, dim=0) - flat
    pos = (pos * flat).sum(-1).to(torch.int64)                  # (K*T,)
    keep = (pos < capacity) & (flat.sum(-1) > 0)
    # a position past the capacity is not kept: its clamped one-hot is
    # zeroed (jax.nn.one_hot gives zeros there)
    pos_oh = torch.nn.functional.one_hot(
        pos.clamp(max=capacity - 1), capacity).float() * keep[:, None]
    disp = (flat.reshape(top_k, t, e)[..., None]
            * pos_oh.reshape(top_k, t, 1, capacity))            # (K,T,E,C)
    dispatch = disp.sum(0)
    combine = (disp * gate_vals.T[..., None, None]).sum(0)
    return dispatch, combine, _aux_loss(probs, gate_idx)


def moe_ffn_values(x2, gate_w, w_gate, w_up, w_down, top_k: int,
                   capacity_factor: float):
    """Dense-dispatch MoE SwiGLU FFN. ``x2`` (T, H); ``gate_w`` (H, E);
    ``w_gate`` / ``w_up`` (E, H, I); ``w_down`` (E, I, H). Returns (out
    (T, H) in x2's dtype, aux loss, drops): drops is the int32 count of
    routed slots that found no place within an expert's capacity, a
    tensor (read it with ``int()`` only where a host wait is fine)."""
    t = x2.shape[0]
    e = gate_w.shape[1]
    capacity = max(int(math.ceil(top_k * t / e * capacity_factor)), 1)
    logits = x2.float() @ gate_w.float()
    dispatch, combine, aux = moe_gating_values(logits, top_k, capacity)
    drops = (float(t * top_k) - dispatch.sum()).to(torch.int32)
    xe = torch.einsum("tec,th->ech", dispatch.to(x2.dtype), x2)  # (E,C,H)
    hgate = torch.einsum("ech,ehi->eci", xe, w_gate.to(xe.dtype))
    hup = torch.einsum("ech,ehi->eci", xe, w_up.to(xe.dtype))
    ho = F.silu(hgate.float()).to(xe.dtype) * hup
    oe = torch.einsum("eci,eih->ech", ho, w_down.to(xe.dtype))  # (E,C,H)
    out = torch.einsum("tec,ech->th", combine.to(oe.dtype), oe)
    return out.to(x2.dtype), aux, drops


def _expert_ffn_rows(xs_in, eid, w_gate, w_up, w_down, e: int,
                     use_kernel=None):
    """Grouped SwiGLU FFN over rows with per-row expert ids: ``xs_in``
    (N, H), ``eid`` (N,) in [0, e). Sorts the rows by expert (stable),
    runs the three grouped matmuls over the unpadded groups and returns
    the (N, H) outputs in the caller's row order."""
    order = torch.argsort(eid, stable=True)
    counts = torch.bincount(eid, minlength=e)
    xs = xs_in[order]
    hg = grouped_matmul_values(xs, w_gate.to(xs.dtype), counts, use_kernel)
    hu = grouped_matmul_values(xs, w_up.to(xs.dtype), counts, use_kernel)
    act = F.silu(hg.float()).to(xs.dtype) * hu
    rows = grouped_matmul_values(act, w_down.to(xs.dtype), counts,
                                 use_kernel)
    # unsort: row order[i] of the caller is sorted row i
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return rows[inv]


def moe_ffn_dropless_values(x2, gate_w, w_gate, w_up, w_down, top_k: int,
                            use_kernel=None):
    """Dropless sort-based MoE SwiGLU FFN (megablox-style): no capacity,
    no drops. ``x2`` (T, H); weights as `moe_ffn_values`. Returns (out
    (T, H) in x2's dtype, aux loss). Slot f = t·K + k carries token t's
    k-th choice; each slot's row, weighted by its gate value in f32, is
    added into its token: JAX's ``.at[tok].add`` in slot order, here a
    reshape to (T, K, H) and a sum over K (no atomics)."""
    t, h = x2.shape
    e = gate_w.shape[1]
    logits = x2.float() @ gate_w.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)                    # (T, K)
    flat = gate_idx.reshape(-1)
    rows = _expert_ffn_rows(x2.repeat_interleave(top_k, dim=0), flat,
                            w_gate, w_up, w_down, e, use_kernel)
    wv = gate_vals.reshape(-1, 1)
    out = (rows.float() * wv).reshape(t, top_k, h).sum(1)
    return out.to(x2.dtype), _aux_loss(probs, gate_idx)


def _unported_ep(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet: expert parallelism needs a mesh "
        "(ROADMAP.md queue A, item 9: tensor parallelism and the "
        "distributed stack)")


def moe_ffn_dropless_ep_values(*args, **kwargs):
    """≙ the per-shard body of the dropless × expert-parallel path
    (`paddle_tpu/incubate/moe/__init__.py:228`): not ported."""
    _unported_ep("moe_ffn_dropless_ep_values")


def shard_moe(layer, mesh, ep_axis: str = "ep"):
    """≙ `shard_moe` (:535): not ported."""
    _unported_ep("shard_moe")


def _xavier_normal_(p: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator]):
    p.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)


class MoELayer(torch.nn.Module):
    """Sparse SwiGLU MoE block with optional dense shared experts.
    ``forward(x)`` -> (out, aux loss); x (..., H).

    ``dropless`` picks the sort-based grouped-matmul path; otherwise the
    capacity path with ``capacity_factor``. `last_drop_count` reads the
    last forward's dropped-slot count (0 on the dropless path): it is
    kept as a device tensor and read on the host only when asked for.
    The JAX layer's ``ep_axis`` and ``ep_pair_capacity_factor`` select
    expert-parallel dispatch, which is not ported (`shard_moe`)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25,
                 shared_intermediate_size: int = 0, dropless: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dropless = dropless
        self._drops = None
        e, h, i = num_experts, hidden_size, intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.gate_weight = torch.nn.Parameter(torch.empty(h, e, **kw))
        self.w_gate = torch.nn.Parameter(torch.empty(e, h, i, **kw))
        self.w_up = torch.nn.Parameter(torch.empty(e, h, i, **kw))
        self.w_down = torch.nn.Parameter(torch.empty(e, i, h, **kw))
        s = shared_intermediate_size
        if s:
            self.shared_gate = torch.nn.Linear(h, s, bias=False, **kw)
            self.shared_up = torch.nn.Linear(h, s, bias=False, **kw)
            self.shared_down = torch.nn.Linear(s, h, bias=False, **kw)
        else:
            self.shared_gate = None
        self.init_weights(None)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator]):
        """The JAX initialisers: the router Normal(0, 0.02), the experts
        Xavier-normal over (H, I), the shared Linears Xavier-normal."""
        h, i = self.hidden_size, self.intermediate_size
        self.gate_weight.normal_(0.0, 0.02, generator=generator)
        for w in (self.w_gate, self.w_up, self.w_down):
            _xavier_normal_(w, h, i, generator)
        if self.shared_gate is not None:
            for lin in (self.shared_gate, self.shared_up, self.shared_down):
                _xavier_normal_(lin.weight, lin.in_features,
                                lin.out_features, generator)

    @property
    def last_drop_count(self) -> Optional[int]:
        return None if self._drops is None else int(self._drops)

    def forward(self, x, use_kernel=None):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        if self.dropless:
            out, aux = moe_ffn_dropless_values(
                x2, self.gate_weight, self.w_gate, self.w_up, self.w_down,
                self.top_k, use_kernel)
            drops = torch.zeros((), dtype=torch.int32, device=x.device)
        else:
            out, aux, drops = moe_ffn_values(
                x2, self.gate_weight, self.w_gate, self.w_up, self.w_down,
                self.top_k, self.capacity_factor)
        self._drops = drops.detach()
        out = out.reshape(shape)
        if self.shared_gate is not None:
            out = out + self.shared_down(
                F.silu(self.shared_gate(x)) * self.shared_up(x))
        return out, aux
