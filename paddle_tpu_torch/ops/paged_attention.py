"""Paged attention: the q = 1 decode attention of the
``attention_impl="legacy"`` engine over a block-table paged KV cache.

≙ `paddle_tpu/ops/paged_attention.py`: `paged_attention_values`
(:107-153), `_paged_xla` (:156-172, here `paged_attention_ref`),
`paged_append_values` (:189-200) and `paged_prefill_scatter`
(:203-219). The layout is the JAX package's: ``q`` (B, H, D), one query
row per sequence; page pools (HK, P, page_size, D); ``context_lens``
(B,) and ``block_tables`` (B, pps) int32. Sequence b's query sits at
position ``context_lens[b] - 1`` and attends the keys ``[max(0, ctx -
window), ctx)``.

`paged_attention_values` launches the hand-written CUDA kernel
(`csrc/paged_attention.cu`, which replaces the TPU's `_paged_kernel`)
for CUDA tensors and runs `paged_attention_ref`, the decode case of the
ragged path's masked-attention core, for CPU tensors. The two writes
update the pools in place (the JAX versions return new pools).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import kernel_route, launch_counts
from .ragged_paged_attention import (TRASH_PAGE, gather_pages,
                                     masked_page_attention)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# pdt_paged_attention(q, k_pages, v_pages, context_lens, block_tables, o,
#   B, H, HK, D, P, page_size, pps, scale, window, dtype, stream)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def paged_attention_ref(q, k_pages, v_pages, context_lens, block_tables,
                        scale, window=None):
    """Plain PyTorch version (≙ `_paged_xla`): the page gather bounded
    to the longest context, then `masked_page_attention` for each
    sequence's one query row at position ctx - 1 (a sequence without
    keys outputs zero)."""
    b, h, d = q.shape
    hk = k_pages.shape[0]
    ctx = [int(c) for c in context_lens.tolist()]
    kc, vc = gather_pages(k_pages, v_pages, block_tables, ctx)
    qh = q.reshape(b, hk, h // hk, d)
    out = torch.empty_like(qh)
    for s in range(b):
        pos = torch.tensor([ctx[s] - 1], device=q.device)
        out[s] = masked_page_attention(qh[s:s + 1], kc[s], vc[s], pos,
                                       ctx[s], scale, window)[0].to(q.dtype)
    return out.reshape(b, h, d)


def _paged_cuda(q, k_pages, v_pages, context_lens, block_tables, scale,
                window):
    """Launch `csrc/paged_attention.cu` on the current stream."""
    b, h, d = q.shape
    hk, p, page_size, _ = k_pages.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged attention kernel takes float32, bfloat16 "
                        f"or float16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged attention kernel wants q and the page pools "
                        "in one dtype")
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != d or h % hk:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if context_lens.shape != (b,) or block_tables.ndim != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"context_lens must be ({b},) and block_tables "
                         f"({b}, pps)")
    if context_lens.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise TypeError("context_lens and block_tables must be int32")
    tensors = (q, k_pages, v_pages, context_lens, block_tables)
    if any(not x.is_cuda or x.device != q.device for x in tensors):
        raise ValueError("paged attention kernel wants every input on one "
                         "CUDA device")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError("paged attention kernel wants contiguous inputs")
    from ._build import kernel_fn
    fn = kernel_fn("paged_attention", "pdt_paged_attention", _ARGTYPES)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 context_lens.data_ptr(), block_tables.data_ptr(),
                 o.data_ptr(), b, h, hk, d, p, page_size,
                 block_tables.shape[1], float(scale),
                 int(window) if window else 0, _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["paged_attention"] += 1
    return o


def paged_attention_values(q, k_pages, v_pages, context_lens, block_tables,
                           scale=None, window=None, use_kernel=None):
    """q: (B, H, D); k_pages/v_pages: (HK, P, page_size, D);
    context_lens: (B,) int32; block_tables: (B, pps) int32. ``window``:
    the decode query sees only the keys in [ctx - window, ctx). Returns
    (B, H, D) in q's dtype.

    ``use_kernel`` None launches the CUDA kernel for CUDA tensors and
    runs `paged_attention_ref` for CPU tensors; True demands the kernel;
    False runs the plain version on either device. The kernel takes
    head_dim up to 256 and up to 16 query heads per KV head, and raises
    (the C entry refuses the launch) outside that."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not kernel_route(q, use_kernel):
        return paged_attention_ref(q, k_pages, v_pages, context_lens,
                                   block_tables, sc, window)
    return _paged_cuda(q, k_pages, v_pages, context_lens, block_tables, sc,
                       window)


def paged_append_values(k_pages, v_pages, k, v, block_tables, positions):
    """Write one token per sequence into the page pools IN PLACE.

    k/v: (B, HK, D); positions: (B,) global position of the new token;
    block_tables: (B, pps). An inactive slot's all-trash block-table
    row sends its write to page 0, which is never read. Returns
    (k_pages, v_pages)."""
    page_size = k_pages.shape[2]
    pos = positions.long()
    page_idx = block_tables.gather(1, (pos // page_size)[:, None])[:, 0]
    page_idx = page_idx.long()
    slot = pos % page_size
    k_pages[:, page_idx, slot] = k.transpose(0, 1).to(k_pages.dtype)
    v_pages[:, page_idx, slot] = v.transpose(0, 1).to(v_pages.dtype)
    return k_pages, v_pages


def paged_prefill_scatter(k_pages, v_pages, k_rows, v_rows, block_table,
                          true_len, trash_page=TRASH_PAGE):
    """Scatter ONE sequence's prefilled KV rows into the page pools IN
    PLACE.

    k_rows/v_rows: (T, HK, D) rows for positions 0..T-1; block_table:
    (pps,) page ids of the sequence; rows at positions >= ``true_len``
    (the bucket's padding) go to ``trash_page``, never read. Returns
    (k_pages, v_pages)."""
    t = k_rows.shape[0]
    page_size = k_pages.shape[2]
    pos = torch.arange(t, device=k_rows.device)
    page_idx = torch.where(pos < int(true_len),
                           block_table[pos // page_size].long(), trash_page)
    slot = pos % page_size
    k_pages[:, page_idx, slot] = k_rows.transpose(0, 1).to(k_pages.dtype)
    v_pages[:, page_idx, slot] = v_rows.transpose(0, 1).to(v_pages.dtype)
    return k_pages, v_pages
