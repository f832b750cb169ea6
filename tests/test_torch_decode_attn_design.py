"""The split design of the port's decode attention
(`paddle_tpu_torch.ops.ragged_paged_attention`: `split_plan`,
`split_kernel`; the device code in csrc/decode_attention.cuh), on the
CPU.

- `split_plan` at the serving shapes, and its invariants: whole stages a
  split, splits that cover the block table, a grid that grows with the
  SMs and shrinks with the q blocks.
- `live_span`, a mirror of the kernels' `span_of` and `split_runs`: the
  live splits of every q block cover each of its live pages exactly once
  and in order, no live split starts past the causal frontier, none lies
  wholly below the window, and a q block with no live key has exactly
  one block (split 0) that writes its zeros.
- `split_merge_attention`, a plain PyTorch version of the design's
  arithmetic (each split's partial (m, l, acc) in the log2 domain,
  merged in split order as `merge_if_last` does) equals
  `ragged_paged_attention_ref` and the JAX Pallas kernel in interpret
  mode, f32 atol 1e-5 (as tests/test_torch_ragged_attention.py), on
  splits that cut sequences in the middle, empty splits under a window,
  contexts 1 and exactly a split, query_len 0, int8 pages with their
  scales, block_q 1 and 8; and the q = 1 paged case against
  `paged_attention_ref` and the JAX `paged_attention_values`.

The card tests (tests/test_torch_cuda_kernels.py) hold the kernels
against the plain versions, one launch each, tickets left zero."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import ragged_paged_attention as jra
from paddle_tpu_torch.ops import launch_counts
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import ragged_paged_attention as tra

ATOL = 1e-5
NEG = -1e30
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# mirrors of the device code
# ---------------------------------------------------------------------------
def live_span(qs, ql, cl, block_q, qb, pps, ps, window, split_pages):
    """A mirror of `span_of` (csrc/decode_attention.cuh) for q block
    ``qb``: (seq, nrows, first_q, key_lo, key_hi, s_lo, s_hi). ``qs`` None
    is the paged layout (q block b is sequence b, one row)."""
    seq, qlen, off = -1, 1, 0
    if qs is None:
        seq = qb
    else:
        row0 = qb * block_q
        for n in range(len(qs)):
            if qs[n] <= row0 < qs[n] + ql[n]:
                seq = n
                break
        if seq >= 0:
            qlen, off = int(ql[seq]), row0 - int(qs[seq])
    nrows, first_q, key_lo, key_hi = 0, 0, 0, -1
    if seq >= 0:
        first_q = int(cl[seq]) - qlen + off
        nrows = min(block_q, qlen - off)
        key_hi = min(first_q + nrows - 1, pps * ps - 1)
        if window:
            key_lo = max(0, first_q - window + 1)
    s_lo, s_hi = 0, -1
    if key_hi >= key_lo:
        spk = split_pages * ps
        s_lo, s_hi = key_lo // spk, key_hi // spk
    return seq, nrows, first_q, key_lo, key_hi, s_lo, s_hi


def split_runs(span, split):
    """A mirror of `split_runs`: the live splits, and split 0 of a q
    block with none."""
    return span[5] <= split <= max(span[6], span[5])


def split_merge_attention(q, kp, vp, qs, ql, cl, bt, scale, window,
                          block_q, split_pages, k_scale=None, v_scale=None):
    """The split design's arithmetic in plain PyTorch, f32: for every q
    block and KV head, each live split's partial state over its keys
    (logits in the log2 domain: q pre-scaled by scale * log2(e), the
    key-row scale after; m the split's max, l the sum of the unscaled
    weights, acc the weights times the value-row scale times V), then
    the states merged in split order (`merge_if_last`), or the one live
    split's written directly. ``qs`` None: the paged layout."""
    t, h, d = q.shape
    hk, _, ps, _ = kp.shape
    g = h // hk
    pps = bt.shape[1]
    spk = split_pages * ps
    out = torch.zeros(t, h, d, dtype=torch.float32)
    qf = q.float() * (scale * LOG2E)
    for qb in range(t // block_q):
        sp = live_span(qs, ql, cl, block_q, qb, pps, ps, window,
                       split_pages)
        seq, nrows, first_q, key_lo, key_hi, s_lo, s_hi = sp
        if s_hi < s_lo:
            continue
        rows = torch.arange(block_q * g)
        tok, head_in = rows // g, rows % g
        qpos = first_q + tok
        row_ok = tok < nrows
        for kh in range(hk):
            qr = qf[qb * block_q + tok, kh * g + head_in]      # (R, d)
            parts = []
            for s in range(s_lo, s_hi + 1):
                keys = torch.arange(max(s * spk, key_lo),
                                    min((s + 1) * spk, key_hi + 1))
                pages = torch.as_tensor(bt[seq])[keys // ps].long()
                slots = keys % ps
                kk = kp[kh, pages, slots].float()
                vv = vp[kh, pages, slots].float()
                x = qr @ kk.T                                   # (R, n)
                if k_scale is not None:
                    x = x * k_scale[pages, slots][None]
                live = row_ok[:, None] & (keys[None] <= qpos[:, None])
                if window:
                    live &= keys[None] > qpos[:, None] - window
                x = torch.where(live, x, torch.tensor(NEG))
                m = x.max(-1).values
                p = torch.where(live, torch.exp2(x - m[:, None]), 0.0)
                w = p * v_scale[pages, slots][None] \
                    if v_scale is not None else p
                parts.append((m, p.sum(-1), w @ vv))
            mm = torch.stack([m for m, _, _ in parts])          # (S, R)
            big = mm.max(0).values
            f = torch.exp2(mm - big)
            ll = sum(fi * l for fi, (_, l, _) in zip(f, parts))
            acc = sum(fi[:, None] * a for fi, (_, _, a) in zip(f, parts))
            o = torch.where((big > NEG / 2)[:, None],
                            acc / ll.clamp(min=1e-30)[:, None], 0.0)
            out[qb * block_q + tok, kh * g + head_in] = o
    return out


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------
def _case(rng, ql, cl, block_q, hk=2, g=2, d=16, ps=4, tail=0, pps=None,
          int8=False):
    """A ragged batch over shuffled pages; block-table columns past a
    sequence's context point at trash page 0. With ``int8`` the pools are
    quantized by the JAX scatter (every row, per-row scales)."""
    ql = np.asarray(ql, np.int32)
    cl = np.asarray(cl, np.int32)
    qs, total = tra.pack_ragged_starts(ql, block_q)
    t = total + tail
    need = [-(-int(c) // ps) for c in cl]
    pps = pps or max(max(need), 1)
    n_pages = sum(need) + 1
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((len(ql), pps), np.int32)
    k = 0
    for s, n in enumerate(need):
        bt[s, :n] = perm[k:k + n]
        k += n
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, kp, vp = f(t, hk * g, d), f(hk, n_pages, ps, d), f(hk, n_pages, ps, d)
    scales = (None, None)
    if int8:
        rows = lambda a: jnp.asarray(a.transpose(1, 2, 0, 3).reshape(
            n_pages * ps, hk, d))
        z8 = jnp.zeros((hk, n_pages, ps, d), jnp.int8)
        zs = jnp.zeros((n_pages, ps), jnp.float32)
        kp, vp, ks, vs = (np.array(a) for a in jra.ragged_scatter_quantized(
            z8, z8, zs, zs, rows(kp), rows(vp),
            jnp.arange(n_pages, dtype=jnp.int32)[None],
            jnp.zeros(n_pages * ps, jnp.int32),
            jnp.arange(n_pages * ps, dtype=jnp.int32)))
        scales = (ks, vs)
    return q, kp, vp, qs, ql, cl, bt, scales


# (name, query lens, context lens, block_q, tail, window, split_pages, int8)
CASES = [
    # splits of 2 pages (8 keys) cut every long sequence in the middle
    ("cut_mid_decode", [1, 1, 1, 1], [37, 9, 16, 30], 1, 1, None, 2, False),
    ("cut_mid_prefill", [21, 9, 5], [21, 30, 13], 8, 8, None, 2, False),
    ("cut_mid_odd_split", [7, 1, 13], [19, 25, 29], 8, 0, None, 3, False),
    # a window of 6 keys leaves the early splits of long rows empty
    ("window_empty_splits", [1, 4, 1], [40, 33, 7], 1, 0, 6, 1, False),
    ("window_prefill", [20, 3], [31, 36], 8, 8, 5, 2, False),
    # contexts of 1 key and of exactly one split (2 pages x 4)
    ("ctx1_and_exact_split", [1, 1, 8, 1], [1, 8, 8, 16], 8, 0, None, 2,
     False),
    ("ctx1_and_exact_split_bq1", [1, 1, 1], [1, 8, 16], 1, 2, None, 2,
     False),
    ("qlen0", [0, 7, 5, 0], [0, 7, 21, 4], 8, 8, None, 2, False),
    ("one_split", [9, 1, 16], [9, 40, 50], 8, 8, None, 16, False),
    ("int8_decode", [1, 1, 1], [37, 9, 24], 1, 1, None, 2, True),
    ("int8_prefill_window", [21, 9, 5], [21, 30, 13], 8, 0, 7, 2, True),
]


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_merge_matches_plain_and_jax_kernel(case):
    name, ql, cl, bq, tail, window, split_pages, int8 = case
    rng = np.random.default_rng(sum(map(ord, name)))
    q, kp, vp, qs, ql_, cl_, bt, (ks, vs) = _case(rng, ql, cl, bq,
                                                  tail=tail, int8=int8)
    scale = 1.0 / math.sqrt(q.shape[-1])
    tq, tkp, tvp, tks, tvs = _torch(q, kp, vp, ks, vs)
    got = split_merge_attention(tq, tkp, tvp, qs, ql_, cl_, bt, scale,
                                window, bq, split_pages, tks, tvs)
    ref = tra.ragged_paged_attention_ref(
        tq, tkp, tvp, *_torch(qs, ql_, cl_, bt), scale, window,
        k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    jkern = np.asarray(jra.ragged_paged_attention_values(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), qs, ql_, cl_,
        jnp.asarray(bt), window=window, block_q=bq, use_kernel=True,
        **({} if ks is None else dict(k_scale=jnp.asarray(ks),
                                      v_scale=jnp.asarray(vs)))))
    np.testing.assert_allclose(got.numpy(), jkern, atol=ATOL, rtol=0)
    seq, _ = tra.token_arrays(qs, ql_, cl_, q.shape[0])
    assert np.all(got.numpy()[seq < 0] == 0)


@pytest.mark.parametrize("window", [None, 3, 10])
@pytest.mark.parametrize("split_pages", [1, 2, 5])
def test_paged_split_merge_matches_plain_and_jax_kernel(window, split_pages):
    rng = np.random.default_rng(split_pages * 7 + (window or 0))
    ctx = [1, 9, 0, 40, 16, 23]
    q, kp, vp, _, _, cl, bt, _ = _case(rng, [1] * len(ctx), ctx, 1, g=4,
                                       pps=12)
    scale = 1.0 / math.sqrt(q.shape[-1])
    tq, tkp, tvp, tcl, tbt = _torch(q, kp, vp, cl, bt)
    got = split_merge_attention(tq, tkp, tvp, None, None, cl, bt, scale,
                                window, 1, split_pages)
    ref = tpa.paged_attention_ref(tq, tkp, tvp, tcl, tbt, scale, window)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    want = np.asarray(jpa.paged_attention_values(
        *(jnp.asarray(a) for a in (q, kp, vp, cl, bt)), window=window,
        use_kernel=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.all(got.numpy()[2] == 0)         # no key: zeros


@pytest.mark.parametrize("block_q", [1, 8])
@pytest.mark.parametrize("window", [None, 5, 37])
@pytest.mark.parametrize("split_pages", [1, 2, 3, 8])
def test_live_splits_cover_each_live_page_once_in_order(block_q, window,
                                                        split_pages):
    rng = np.random.default_rng(block_q * 100 + (window or 0) + split_pages)
    ps, n = 4, 12
    ql = rng.integers(0, 30, n)
    ql[rng.random(n) < 0.3] = 1
    ql[rng.random(n) < 0.1] = 0
    cl = ql + rng.integers(0, 60, n)
    qs, total = tra.pack_ragged_starts(ql, block_q)
    t = total + 2 * block_q
    pps = int(-(-cl.max() // ps))
    n_splits = -(-pps // split_pages)
    seen_empty = 0
    for qb in range(t // block_q):
        sp = live_span(qs, ql, cl, block_q, qb, pps, ps, window,
                       split_pages)
        seq, nrows, first_q, key_lo, key_hi, s_lo, s_hi = sp
        runs = [s for s in range(n_splits) if split_runs(sp, s)]
        if seq < 0 or key_hi < key_lo:
            assert runs == [0]                 # split 0 writes the zeros
            seen_empty += 1
            continue
        assert 0 <= key_lo <= first_q <= key_hi == first_q + nrows - 1
        # the live pages of the q block's rows: from the window's first
        # page to the last row's causal frontier
        want = list(range(key_lo // ps, key_hi // ps + 1))
        got = []
        for s in runs:
            lo = max(s * split_pages, key_lo // ps)
            hi = min((s + 1) * split_pages - 1, key_hi // ps)
            assert lo <= hi                    # no live split is empty
            assert s * split_pages * ps <= key_hi    # not past the frontier
            assert (s + 1) * split_pages * ps > key_lo   # not below window
            got += list(range(lo, hi + 1))
        assert got == want                     # each page once, in order
    assert seen_empty > 0                      # padding blocks exist


def test_split_plan_at_serving_shapes():
    """The 8B decode step (8 slots, 2048-token tables of 16-token pages,
    8 KV heads, G 4) on 132 SMs: 16-page splits, 8 of them, 512 blocks
    at full contexts; the first admission batch (122 q blocks of 8
    tokens) one split on tensor cores; G 16 two row groups; f32
    admission rows (32) four groups of 8 on CUDA cores."""
    plan = tra.split_plan(8, 8, 4, 128, 16, "cuda_cores", 132)
    assert plan == tra.SplitPlan("cuda_cores", 4, 1, 16, 8)
    adm = tra.split_plan(122, 8, 32, 69, 16, "tensor_cores", 132)
    assert adm.n_splits == 1 and adm.rows_per_block == tra.TC_ROWS
    assert tra.split_plan(8, 2, 16, 128, 16, "cuda_cores",
                          132).row_groups == 2
    f32 = tra.split_plan(122, 8, 32, 69, 16, "cuda_cores", 132)
    assert (f32.rows_per_block, f32.row_groups) == (8, 4)


PLAN_GRID = [(nq, hk, rows, pps, ps, kern, sms)
             for nq in (1, 122)
             for hk, rows in ((8, 4), (2, 16), (4, 64))
             for pps in (1, 128, 513)
             for ps in (16, 48)
             for kern in ("cuda_cores", "tensor_cores")
             for sms in (1, 132)]


@pytest.mark.parametrize("nq,hk,rows,pps,ps,kern,sms", PLAN_GRID)
def test_split_plan_invariants(nq, hk, rows, pps, ps, kern, sms):
    plan = tra.split_plan(nq, hk, rows, pps, ps, kern, sms)
    unit = max(1, tra.STAGE_KEYS // ps)
    assert plan.kernel == kern
    assert plan.split_pages % unit == 0          # whole stages a split
    assert plan.n_splits * plan.split_pages >= pps
    assert (plan.n_splits - 1) * plan.split_pages < pps
    assert plan.row_groups * plan.rows_per_block >= rows
    assert (plan.row_groups - 1) * plan.rows_per_block < rows
    more_sms = tra.split_plan(nq, hk, rows, pps, ps, kern, 2 * sms + 7)
    assert more_sms.n_splits >= plan.n_splits
    more_q = tra.split_plan(2 * nq, hk, rows, pps, ps, kern, sms)
    assert more_q.n_splits <= plan.n_splits


@pytest.mark.parametrize("dtype,block_q,d,aligned,want", [
    (torch.bfloat16, 8, 128, True, "tensor_cores"),
    (torch.float16, 8, 64, True, "tensor_cores"),
    (torch.bfloat16, 2, 256, True, "tensor_cores"),
    (torch.bfloat16, 1, 128, True, "cuda_cores"),
    (torch.float32, 8, 128, True, "cuda_cores"),
    (torch.bfloat16, 8, 96, True, "cuda_cores"),
    (torch.bfloat16, 8, 32, True, "cuda_cores"),
    (torch.bfloat16, 8, 128, False, "cuda_cores")])
def test_split_kernel_routing(dtype, block_q, d, aligned, want):
    assert tra.split_kernel(dtype, block_q, d, aligned) == want


def test_unknown_design_raises_before_any_launch():
    rng = np.random.default_rng(0)
    q, kp, vp, qs, ql, cl, bt, _ = _case(rng, [1, 1], [5, 9], 1)
    args = _torch(q, kp, vp, qs, ql, cl, bt)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="design"):
        tra._ragged_cuda(*args, 0.25, None, 1, _design="walk")
    with pytest.raises(ValueError, match="design"):
        tpa._paged_cuda(args[0], args[1], args[2], args[5], args[6], 0.25,
                        None, _design="walk")
    assert launch_counts == before
