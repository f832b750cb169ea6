"""Functional layer math of the serving and training paths.

≙ `paddle_tpu/nn/functional/norm.py` :18-70 (`layer_norm`, `rms_norm`),
`nn/functional/common.py` :33-107 (`linear`, with its `LoraWeight` and
`QuantizedWeight` dispatch, and `dropout`), the `silu` and `gelu`
activations, `nn/functional/attention.py` :20-101 (`_sdpa_xla`,
`scaled_dot_product_attention` with its dropout branch), the rest of
`nn/functional/attention.py` (:104-263: `flash_attention`,
`flash_attn_unpadded`, `masked_multihead_attention`, `sequence_mask`,
`flash_attn_qkvpacked`, `flash_attn_varlen_qkvpacked`, `sdp_kernel`) and
`nn/functional/loss.py` :23-69 (`cross_entropy` with hard labels).

Dropout draws its keep mask from a `torch.Generator` (the caller's, else
torch's default one on the tensor's device): the JAX package draws from
`jax.random` keys, so the two keep the same rate and scaling but not the
same bits.
"""
from __future__ import annotations

import contextlib
import math

import torch

from ..ops.flash_attention import NEG_INF, flash_attention_values
from ..ops.flash_varlen import (flash_attention_varlen_values,
                                segments_from_cu_seqlens)
from ..ops.lora_epilogue import LoraWeight, lora_matmul_values
from ..ops.norm_kernels import layer_norm_values, rms_norm_values
from ..ops.quant_matmul import QuantizedWeight, dequant_matmul_values


def rms_norm(x, weight, epsilon=1e-6, use_kernel=None):
    """RMSNorm over the last axis. On the TPU `F.rms_norm` routed to the
    Pallas kernel; here CUDA tensors go to the CUDA kernel and CPU
    tensors to the plain version (`ops.norm_kernels.rms_norm_values`)."""
    return rms_norm_values(x, weight, epsilon, use_kernel=use_kernel)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               use_kernel=None):
    """LayerNorm over the last axis: `ops.norm_kernels.layer_norm_values`
    (the CUDA kernels, forward and backward, for CUDA tensors; any row
    count), as `F.layer_norm` routed to the Pallas kernel on the TPU. A
    missing weight or bias is a constant ones or zeros vector that takes
    no gradient: x̂·1 + 0 is exactly the JAX functional's x̂ without them.
    Several normalised axes are not ported (ROADMAP.md queue A)."""
    ns = list(normalized_shape) if isinstance(normalized_shape,
                                              (list, tuple)) \
        else [normalized_shape]
    if len(ns) != 1:
        raise NotImplementedError(
            "layer_norm over several axes is not ported yet (ROADMAP.md "
            "queue A)")
    h = x.shape[-1]
    if weight is None:
        weight = torch.ones(h, dtype=x.dtype, device=x.device)
    if bias is None:
        bias = torch.zeros(h, dtype=x.dtype, device=x.device)
    return layer_norm_values(x, weight, bias, epsilon,
                             use_kernel=use_kernel)


def silu(x):
    return torch.nn.functional.silu(x)


def relu(x):
    return torch.relu(x)


def gelu(x, approximate=False):
    """GELU: the exact erf form, or the tanh approximation with
    ``approximate=True`` (≙ `jax.nn.gelu`)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def _keep_mask(shape, p, like, generator):
    """Bernoulli(1 - p) keep mask of ``shape`` on ``like``'s device."""
    u = torch.rand(shape, device=like.device, generator=generator)
    return u < 1.0 - p


def dropout(x, p=0.5, training=True, generator=None,
            mode="upscale_in_train"):
    """Dropout (≙ `F.dropout` without ``axis``). ``upscale_in_train``: in
    training each element is kept with probability 1 - p and scaled by
    1/(1 - p); at inference, the identity. ``downscale_in_infer``: in
    training kept elements stay as they are; at inference x is scaled by
    1 - p. The keep mask comes from ``generator`` (else torch's default
    generator of x's device)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unknown dropout mode {mode!r}")
    if not training or p == 0.0:
        if training or p == 0.0 or mode != "downscale_in_infer":
            return x
        return (x * (1.0 - p)).to(x.dtype)
    if p == 1.0:
        return torch.zeros_like(x)
    keep = _keep_mask(x.shape, p, x, generator)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


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


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None, use_kernel=None,
                    generator=None):
    """≙ ``paddle.nn.functional.flash_attention.flash_attention``:
    `scaled_dot_product_attention` (the flash kernels without dropout;
    the plain path with dropout in training, as JAX's SDPA), returned as
    ``(out, None)`` (no softmax is returned)."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training, use_kernel,
                                       generator)
    return out, None


def _unpadded_masked(q, k, v, cq, ck, seg_q, seg_k, scale):
    """Causal packed attention when the q and k packings differ: each row
    sees the keys of its own segment at per-segment positions up to its
    own, ``arange - cu[seg]``. Plain PyTorch, as the reference's branch
    is XLA and not a kernel: f32 logits, masked at -1e30, a softmax in
    f32, rows without a key 0, weights cast to q's dtype. It holds the
    dense (H, total_q, total_k) f32 logits and weights at once, at
    least 8 H total_q total_k bytes (1 GiB at H = 32 and 2048 tokens a
    side, 16 GiB at 8192), where the varlen kernels hold no such matrix."""
    tq, tk = q.shape[0], k.shape[0]
    d = q.shape[-1]
    s = 1.0 / math.sqrt(d) if scale is None else float(scale)
    rep = q.shape[1] // k.shape[1]
    if rep != 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * s
    mask = (seg_q[:, None] == seg_k[None, :]) & (seg_q[:, None] >= 0)
    pos_q = torch.arange(tq, device=q.device) - cq[seg_q.long().clamp_min(0)]
    pos_k = torch.arange(tk, device=q.device) - ck[seg_k.long().clamp_min(0)]
    mask &= pos_q[:, None] >= pos_k[None, :]
    p = torch.softmax(logits.masked_fill(~mask[None], NEG_INF), dim=-1)
    p = torch.where(mask.any(-1)[None, :, None], p, 0.0)
    return torch.einsum("hqk,khd->qhd", p.to(q.dtype), v)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False, name=None,
                        use_kernel=None):
    """Packed (varlen) attention of (total_q, H, D) queries over
    (total_k, HK, D) keys and values, the sequences given by cumulative
    offsets (N + 1,); positions past the last offset are padding (0 out,
    zero gradient). Returns ``(out, None)``.

    The B = 1 packing goes through `ops.flash_varlen` (the varlen kernels
    on the card): with shared q/k offsets global end-aligned causality is
    per-sequence causality. Causal attention with ``total_q != total_k``
    takes `_unpadded_masked`, per-segment positions in plain PyTorch, as
    the reference's branch is XLA; its memory grows with total_q *
    total_k (see there). ``dropout is accepted and ignored,
    as the reference ignores it; the max lengths are not needed."""
    tq, tk = query.shape[0], key.shape[0]
    cq = torch.as_tensor(cu_seqlens_q, device=query.device).long()
    ck = torch.as_tensor(cu_seqlens_k, device=query.device).long()
    seg_q = segments_from_cu_seqlens(cq, tq)
    seg_k = segments_from_cu_seqlens(ck, tk)
    if causal and tq != tk:
        return _unpadded_masked(query, key, value, cq, ck, seg_q, seg_k,
                                scale), None
    out = flash_attention_varlen_values(
        query[None], key[None], value[None], seg_q[None], seg_k[None],
        causal=causal, scale=scale, use_kernel=use_kernel)
    return out[0], None


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, fixed_seed_offset=None,
                         rng_name="", training=True, name=None,
                         use_kernel=None, generator=None):
    """qkv (B, S, 3, H, D) split into q, k, v for `flash_attention`."""
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           training=training, use_kernel=use_kernel,
                           generator=generator)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale=None,
                                dropout=0.0, causal=False,
                                return_softmax=False, name=None,
                                use_kernel=None):
    """qkv (total, 3, H, D) split into q, k, v for
    `flash_attn_unpadded`."""
    return flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                               cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                               max_seqlen_k, scale=scale, dropout=dropout,
                               causal=causal, use_kernel=use_kernel)


def sdp_kernel(*args, **kwargs):
    """≙ paddle's ``sdp_kernel`` context (a kernel-selection hint): the
    choice here is the tensor's device (`ops.kernel_route`), so this is
    a null context, accepted for API parity."""
    return contextlib.nullcontext()


def masked_multihead_attention(query, k_cache, v_cache, seq_len, scale=None,
                               attn_mask=None, window_size=None):
    """Decode attention over a static cache, plain PyTorch as in JAX:
    q (B, S, H, D) over k_cache / v_cache (B, T, HK, D), H a multiple of
    HK. q row i sits at position seq_len - S + i and sees cache position
    t iff t <= that position; ``seq_len`` is a scalar or a (B,) tensor of
    per-sequence lengths. ``attn_mask`` (B, T) bool drops its False
    positions; ``window_size`` w keeps only t > position - w. Logits and
    softmax in f32 (masked at -1e30), weights cast to the cache's dtype;
    returns (B, S, H, D)."""
    b, s, h, d = query.shape
    t, hk = k_cache.shape[1], k_cache.shape[2]
    sc = 1.0 / math.sqrt(d) if scale is None else float(scale)
    qh = query.reshape(b, s, hk, h // hk, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qh.float(),
                          k_cache.float()) * sc
    dev = query.device
    kpos = torch.arange(t, device=dev)
    sl = torch.as_tensor(seq_len, device=dev)
    if sl.ndim == 0:
        qpos = (sl - s + torch.arange(s, device=dev))[None, :]
    else:
        qpos = sl[:, None] - s + torch.arange(s, device=dev)[None, :]
    mask = kpos[None, None, :] <= qpos[:, :, None]
    if window_size is not None:
        mask = mask & (kpos[None, None, :] > qpos[:, :, None] - window_size)
    mask = mask[:, None, None]                          # (B|1, 1, 1, S, T)
    if attn_mask is not None:
        pad = torch.as_tensor(attn_mask, device=dev).bool()
        mask = mask & pad[:, None, None, None, :]
    p = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, s, h, d).to(v_cache.dtype)


def sequence_mask(x, maxlen=None, dtype="int64"):
    """(..., maxlen) mask of ``arange(maxlen) < x`` in ``dtype`` (a name
    or a torch dtype); maxlen defaults to the largest x."""
    x = torch.as_tensor(x)
    ml = int(x.max()) if maxlen is None else int(maxlen)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return (torch.arange(ml, device=x.device) < x[..., None]).to(dt)


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
