"""Ragged paged attention: one call for a packed batch of decode steps,
full prefills and chunk continuations over a block-table paged KV cache.

≙ `paddle_tpu/ops/ragged_paged_attention.py` :73-288 and :525-624. The
layout is the JAX package's, unchanged: ``q`` is (T, H, D) with the
queries of every sequence packed along one token axis, and sequence
``s`` owns rows ``[query_start[s], query_start[s] + query_len[s])``.
Row ``j`` of a sequence sits at global position ``context_len[s] -
query_len[s] + j``. Rows that no sequence owns are padding: their
output is zero and their KV goes to the trash page.

`ragged_paged_attention_values` launches the hand-written CUDA kernel
(`csrc/ragged_paged_attention.cu`, which replaces the TPU's
`_ragged_kernel`) for CUDA tensors and runs `ragged_paged_attention_ref`,
the plain PyTorch version of the same function, for CPU tensors.

Quantized pages (≙ :63, :183-190, :259-265, :582-583 and :627-666): int8
page pools ride with (P, page_size) f32 scale pools, one DEQUANT
multiplier per page row shared by the KV heads.
`ragged_scatter_quantized` quantizes each new row on commit; the
attention takes ``k_scale``/``v_scale`` and dequantizes — the plain
version right after its gather, the kernel per page in flight.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import kernel_route, launch_counts

NEG_INF = -1e30
DEFAULT_BLOCK_Q = 8
TRASH_PAGE = 0
KV_QMAX = 127.0     # int8 absmax lattice of a quantized KV page row

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# pdt_ragged_paged_attention(q, k_pages, v_pages, k_scale, v_scale,
#   query_start, query_len, context_len, block_tables, o, T, H, HK, D, P,
#   page_size, N, pps, block_q, scale, window, dtype, stream)
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])


# ---------------------------------------------------------------------------
# packing helpers (host side; the engine and the tests build batches here)
# ---------------------------------------------------------------------------
def pack_ragged_starts(query_lens, block_q=DEFAULT_BLOCK_Q):
    """Aligned packed layout: each sequence's segment starts on a
    ``block_q`` boundary, so every q block belongs to at most one
    sequence. Returns (query_start (N,) int32, total aligned rows)."""
    starts, cur = [], 0
    for n in query_lens:
        starts.append(cur)
        cur += -(-int(n) // block_q) * block_q
    return np.asarray(starts, np.int32), cur


def pack_ragged_batch(pieces, n_seqs, block_q=DEFAULT_BLOCK_Q,
                      pad_to=None):
    """Pack admission pieces into the arrays one ragged dispatch reads.

    Each piece is ``{"seq": owning sequence, "tokens": [ids...],
    "offset": global position of the first token, "sample": bool}``;
    `n_seqs` sizes the per-sequence arrays. Segment starts are aligned
    to `block_q` and the token axis is padded to a multiple of
    ``pad_to`` (default `block_q`). Returns int32 numpy arrays: per
    token ``ids`` / ``token_seq`` (-1 on padding rows) / ``positions``;
    per sequence ``query_start`` / ``query_len`` / ``context_len`` /
    ``sample_rows`` (the out-of-range row ``t_pad`` for sequences that
    do not sample; callers clamp it and never read that row back); and
    ``t_pad`` and ``tokens``, the block_q-aligned row total before the
    final pad."""
    grid = int(pad_to) if pad_to else int(block_q)
    cur = 0
    row0 = []
    for p in pieces:
        row0.append(cur)
        cur += -(-len(p["tokens"]) // block_q) * block_q
    t_pad = -(-max(cur, 1) // grid) * grid
    ids = np.zeros(t_pad, np.int32)
    token_seq = np.full(t_pad, -1, np.int32)
    positions = np.zeros(t_pad, np.int32)
    query_start = np.zeros(n_seqs, np.int32)
    query_len = np.zeros(n_seqs, np.int32)
    context_len = np.zeros(n_seqs, np.int32)
    sample_rows = np.full(n_seqs, t_pad, np.int32)
    for p, r0 in zip(pieces, row0):
        s, n = int(p["seq"]), len(p["tokens"])
        ids[r0:r0 + n] = p["tokens"]
        token_seq[r0:r0 + n] = s
        positions[r0:r0 + n] = p["offset"] + np.arange(n)
        query_start[s] = r0
        query_len[s] = n
        context_len[s] = p["offset"] + n
        if p.get("sample"):
            sample_rows[s] = r0 + n - 1
    return {"ids": ids, "token_seq": token_seq, "positions": positions,
            "query_start": query_start, "query_len": query_len,
            "context_len": context_len, "sample_rows": sample_rows,
            "t_pad": t_pad, "tokens": cur}


def token_arrays(query_start, query_len, context_len, total_rows):
    """Per-token (token_seq, positions) int32 numpy arrays of a packed
    batch: the owning sequence (-1 on padding rows) and the token's
    global position."""
    seq = np.full(int(total_rows), -1, np.int32)
    pos = np.zeros(int(total_rows), np.int32)
    for s, (st, ql, cl) in enumerate(zip(query_start, query_len,
                                         context_len)):
        st, ql, cl = int(st), int(ql), int(cl)
        seq[st:st + ql] = s
        pos[st:st + ql] = np.arange(cl - ql, cl, dtype=np.int32)
    return seq, pos


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------
def page_gather_bound(block_tables, context_lens, pages_bound,
                      page_size) -> int:
    """Column bound of a block-table gather: ``pages_bound`` when the
    caller gives one, else ``ceil(max(context) / page_size)``, else the
    full table."""
    pps = block_tables.shape[1]
    if pages_bound is not None:
        return max(1, min(int(pages_bound), pps))
    if context_lens is not None and len(context_lens):
        max_ctx = int(max(int(c) for c in context_lens))
        return max(1, min(-(-max_ctx // page_size), pps))
    return pps


def gather_page_scales(scale_pool, block_tables, bound):
    """Gather a (P, page_size) scale pool along the first `bound`
    block-table columns to per-sequence rows (N, bound * page_size): the
    dequant companion of `gather_pages` (same bound, same row order)."""
    bt = block_tables[:, :bound].long()
    return scale_pool[bt].reshape(bt.shape[0], -1)


def gather_pages(k_pages, v_pages, block_tables, context_lens=None,
                 pages_bound=None):
    """Gather block-table pages into per-sequence contiguous caches
    (N, S, HK, D), S = bound * page_size, bounded as
    `page_gather_bound` says."""
    hk, _, page_size, d = k_pages.shape
    bound = page_gather_bound(block_tables, context_lens, pages_bound,
                              page_size)
    bt = block_tables[:, :bound].long()
    n = bt.shape[0]
    kg = k_pages[:, bt].permute(1, 2, 3, 0, 4)     # (N, bound, ps, HK, D)
    vg = v_pages[:, bt].permute(1, 2, 3, 0, 4)
    s_max = bound * page_size
    return (kg.reshape(n, s_max, hk, d), vg.reshape(n, s_max, hk, d))


def masked_page_attention(q, kc, vc, q_positions, context_len, scale,
                          window=None):
    """The masked-attention core for the query rows of ONE sequence.

    q: (t, HK, G, D); kc/vc: (S, HK, D), the sequence's gathered cache;
    q_positions: (t,) global positions. Row i attends keys ``k <=
    q_positions[i]`` (and ``> q_positions[i] - window``) below
    `context_len`; a row with no valid key outputs zero. Logits and
    softmax in f32; the weights are cast to the cache's dtype before
    the weighted sum, as the JAX core does."""
    s_max = kc.shape[0]
    logits = torch.einsum("tkgd,skd->tkgs", q.float(), kc.float()) * scale
    kpos = torch.arange(s_max, device=q.device)
    valid = (kpos[None, :] <= q_positions[:, None]) \
        & (kpos[None, :] < context_len)
    if window is not None:
        valid = valid & (kpos[None, :] > q_positions[:, None] - window)
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(valid.any(-1)[:, None, None, None], p, 0.0)
    return torch.einsum("tkgs,skd->tkgd", p.to(vc.dtype), vc)


def ragged_paged_attention_ref(q, k_pages, v_pages, query_start,
                               query_len, context_len, block_tables,
                               scale, window=None, pages_bound=None,
                               k_scale=None, v_scale=None):
    """Plain PyTorch version (≙ `_ragged_xla`): a bounded page gather,
    then `masked_page_attention` for each sequence's rows. Padding rows
    output zero. The descriptors are read on the host. With
    ``k_scale``/``v_scale`` the gathered int8 rows are dequantized to
    f32 right after the gather, so the core runs in f32 (its
    ``p.to(vc.dtype)`` keeps the weights f32, as in JAX)."""
    t, h, d = q.shape
    hk = k_pages.shape[0]
    g = h // hk
    qs = [int(x) for x in query_start.tolist()]
    ql = [int(x) for x in query_len.tolist()]
    cl = [int(x) for x in context_len.tolist()]
    kc, vc = gather_pages(k_pages, v_pages, block_tables, cl, pages_bound)
    if k_scale is not None:
        bound = page_gather_bound(block_tables, cl, pages_bound,
                                  k_pages.shape[2])
        ks = gather_page_scales(k_scale, block_tables, bound)   # (N, S)
        vs = gather_page_scales(v_scale, block_tables, bound)
        kc = kc.float() * ks[:, :, None, None]
        vc = vc.float() * vs[:, :, None, None]
    out = torch.zeros(t, hk, g, d, dtype=q.dtype, device=q.device)
    qh = q.reshape(t, hk, g, d)
    for s in range(len(ql)):
        if ql[s] <= 0:
            continue
        rows = slice(qs[s], qs[s] + ql[s])
        pos = torch.arange(cl[s] - ql[s], cl[s], device=q.device)
        out[rows] = masked_page_attention(
            qh[rows], kc[s], vc[s], pos, cl[s], scale, window).to(q.dtype)
    return out.reshape(t, h, d)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------
def _ragged_cuda(q, k_pages, v_pages, query_start, query_len, context_len,
                 block_tables, scale, window, block_q, k_scale=None,
                 v_scale=None):
    """Launch `csrc/ragged_paged_attention.cu` on the current stream:
    full-width pages in q's dtype, or int8 pages with their scale
    pools."""
    t, h, d = q.shape
    hk, p, page_size, _ = k_pages.shape
    n, pps = block_tables.shape
    quant = k_scale is not None
    if q.dtype not in _DTYPES:
        raise TypeError(f"ragged attention kernel takes float32, "
                        f"bfloat16 or float16, got {q.dtype}")
    page_dt = torch.int8 if quant else q.dtype
    if k_pages.dtype != page_dt or v_pages.dtype != page_dt:
        raise TypeError(
            "ragged attention kernel wants int8 page pools with scales"
            if quant else "ragged attention kernel wants q and the page "
            "pools in one dtype (int8 pools need k_scale and v_scale)")
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != d \
            or h % hk:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    scales = (k_scale, v_scale) if quant else ()
    if any(x.dtype != torch.float32 or x.shape != (p, page_size)
           for x in scales):
        raise ValueError(f"k_scale / v_scale must be float32 of shape "
                         f"({p}, {page_size}), one per page row")
    desc = (query_start, query_len, context_len)
    if any(x.shape != (n,) for x in desc):
        raise ValueError(f"descriptors must be ({n},), matching the "
                         "block table")
    ints = desc + (block_tables,)
    if any(x.dtype != torch.int32 for x in ints):
        raise TypeError("descriptors and block tables must be int32")
    tensors = (q, k_pages, v_pages) + scales + ints
    if any(not x.is_cuda or x.device != q.device for x in tensors):
        raise ValueError("ragged attention kernel wants every input on "
                         "one CUDA device")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError("ragged attention kernel wants contiguous inputs")
    if t % block_q:
        raise ValueError(f"packed length {t} not a multiple of block_q "
                         f"{block_q}")
    from ._build import kernel_fn
    fn = kernel_fn("ragged_paged_attention", "pdt_ragged_paged_attention",
                   _ARGTYPES)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 k_scale.data_ptr() if quant else None,
                 v_scale.data_ptr() if quant else None,
                 query_start.data_ptr(), query_len.data_ptr(),
                 context_len.data_ptr(), block_tables.data_ptr(),
                 o.data_ptr(), t, h, hk, d, p, page_size, n, pps, block_q,
                 float(scale), int(window) if window else 0,
                 _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"ragged attention kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["ragged_paged_attention_int8kv" if quant
                  else "ragged_paged_attention"] += 1
    return o


def ragged_paged_attention_values(q, k_pages, v_pages, query_start,
                                  query_len, context_len, block_tables,
                                  scale=None, window=None,
                                  block_q=DEFAULT_BLOCK_Q, use_kernel=None,
                                  pages_bound=None, k_scale=None,
                                  v_scale=None):
    """q: (T, H, D) packed queries; k_pages/v_pages: (HK, P, page_size,
    D); query_start/query_len/context_len: (N,) int32 tensors;
    block_tables: (N, pps) int32. Returns (T, H, D) in q's dtype;
    padding rows are zero.

    ``use_kernel`` None launches the CUDA kernel for CUDA tensors and
    runs `ragged_paged_attention_ref` for CPU tensors; True demands the
    kernel; False runs the plain version on either device. The kernel
    needs ``query_start`` aligned to ``block_q`` (`pack_ragged_starts`;
    decode batches pass block_q=1) and ``T % block_q == 0``.
    ``pages_bound`` caps the plain version's gather; the kernel walks
    only each q block's live pages and ignores it.

    ``k_scale``/``v_scale``: (P, page_size) f32 DEQUANT multipliers of
    int8 page pools, written by `ragged_scatter_quantized`; both or
    neither. The kernel counts these launches under
    ``ragged_paged_attention_int8kv``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    d = q.shape[-1]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    if not kernel_route(q, use_kernel):
        return ragged_paged_attention_ref(q, k_pages, v_pages, query_start,
                                          query_len, context_len,
                                          block_tables, sc, window,
                                          pages_bound, k_scale, v_scale)
    return _ragged_cuda(q, k_pages, v_pages, query_start, query_len,
                        context_len, block_tables, sc, window, block_q,
                        k_scale, v_scale)


def ragged_scatter_values(k_pages, v_pages, k_rows, v_rows, block_tables,
                          token_seq, positions):
    """Scatter packed KV rows into the page pools IN PLACE (the JAX
    version returns new pools; here the pools are updated where they
    lie, which saves a copy of every pool per layer).

    k_rows/v_rows: (T, HK, D); block_tables: (N, pps); token_seq: (T,)
    owning sequence (-1 = padding); positions: (T,) global positions.
    Padding rows write to the trash page 0, which is never read: several
    of them may land on one cell, and which one wins is unspecified
    (on CUDA `index_put_` with repeated indices is nondeterministic).
    Live rows never collide. Returns (k_pages, v_pages)."""
    page_idx, slot = _scatter_cells(block_tables, token_seq, positions,
                                    k_pages.shape[2])
    k_pages[:, page_idx, slot] = k_rows.transpose(0, 1).to(k_pages.dtype)
    v_pages[:, page_idx, slot] = v_rows.transpose(0, 1).to(v_pages.dtype)
    return k_pages, v_pages


def _scatter_cells(block_tables, token_seq, positions, page_size):
    """(page, slot) of each packed row: its sequence's block-table page
    and in-page offset, or trash page 0 for a padding row."""
    live = token_seq >= 0
    sc = token_seq.clamp(min=0).long()
    pos = positions.long()
    page_idx = torch.where(live, block_tables[sc, pos // page_size].long(),
                           TRASH_PAGE)
    slot = torch.where(live, pos % page_size, 0)
    return page_idx, slot


def _quantize_rows(rows):
    """Per-row int8 quantization of (T, HK, D) rows: absmax over the
    row's (HK, D) values through the shared round-clip core, and the
    dequant scale absmax / 127 (0 for an all-zero row)."""
    from ..nn.quant import absmax_round_clip_values
    rf = rows.float()
    amax = rf.abs().amax(dim=(1, 2))                         # (T,)
    qr = absmax_round_clip_values(rf, amax[:, None, None], KV_QMAX,
                                  out_dtype=torch.int8)
    return qr, amax / KV_QMAX


def ragged_scatter_quantized(k_pages, v_pages, k_scale, v_scale, k_rows,
                             v_rows, block_tables, token_seq, positions):
    """`ragged_scatter_values` for int8 page pools, IN PLACE: quantize
    on commit. Each packed row quantizes on its own — absmax over its
    (HK, D) values, shared across heads, so the scale pools (P,
    page_size) carry no head axis. Per-row quantization makes the page
    bytes path-invariant: rows written one decode step at a time equal
    the same rows written at once by a re-prefill. The scale pools
    store the dequant multiplier absmax / 127 (0 for an all-zero row).
    Padding rows send values and scales to trash page 0. This is plain
    PyTorch on either device: the JAX package's version is XLA, not a
    kernel. Returns (k_pages, v_pages, k_scale, v_scale)."""
    page_idx, slot = _scatter_cells(block_tables, token_seq, positions,
                                    k_pages.shape[2])
    kq, ks_row = _quantize_rows(k_rows)
    vq, vs_row = _quantize_rows(v_rows)
    k_pages[:, page_idx, slot] = kq.transpose(0, 1)
    v_pages[:, page_idx, slot] = vq.transpose(0, 1)
    k_scale[page_idx, slot] = ks_row
    v_scale[page_idx, slot] = vs_row
    return k_pages, v_pages, k_scale, v_scale
