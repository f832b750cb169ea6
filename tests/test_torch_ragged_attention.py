"""Ragged paged attention of the PyTorch port
(`paddle_tpu_torch.ops.ragged_paged_attention`) against the JAX
package: the port's plain version (its CPU path) is held against the
JAX Pallas kernel in interpret mode AND the independent NumPy oracle
`np_ragged_oracle` of tests/test_ragged_attention.py, f32 atol 1e-5.
The packing and scatter helpers must reproduce the JAX ones exactly.
The CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda_kernels.py, which imports no JAX."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops import ragged_paged_attention as jra
from paddle_tpu_torch.ops import launch_counts
from paddle_tpu_torch.ops import ragged_paged_attention as tra
from test_ragged_attention import _case, np_ragged_oracle

ATOL = 1e-5

# (name, _case kwargs, window, block_q): mixed decode / prefill /
# continuation, windows, GQA 1/2/4, padding tail, query_len=0 and
# block_q 1 and 8
CASES = [
    ("mixed", dict(), None, 4),
    ("window", dict(), 3, 4),
    ("window_wide", dict(ql=(1, 7, 5), cl=(9, 7, 13)), 6, 4),
    ("gqa1", dict(g=1), None, 4),
    ("gqa4", dict(g=4), None, 4),
    ("gqa4_window", dict(g=4), 5, 4),
    ("no_tail", dict(tail_pad=0), None, 4),
    ("long_tail", dict(tail_pad=12), None, 4),
    ("qlen0", dict(ql=(0, 7, 5, 0), cl=(0, 7, 13, 4), n_pages=16), None, 4),
    ("decode_bq1", dict(ql=(1, 1, 1), cl=(9, 1, 13), block_q=1,
                        tail_pad=1), None, 1),
    ("decode_bq1_window", dict(ql=(1, 1, 1), cl=(9, 2, 13), block_q=1,
                               tail_pad=0), 4, 1),
    ("bq8", dict(ql=(1, 9, 5), cl=(9, 9, 13), block_q=8, tail_pad=8,
                 n_pages=16), None, 8),
    ("bq8_window", dict(ql=(1, 9, 5), cl=(9, 9, 13), block_q=8,
                        tail_pad=0, n_pages=16), 3, 8),
]


def _torch_args(q, kp, vp, qs, ql, cl, bt):
    return (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            *(torch.from_numpy(np.asarray(a, np.int32))
              for a in (qs, ql, cl, bt)))


@pytest.mark.parametrize("name,kw,window,block_q", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_jax_kernel_and_oracle(name, kw, window, block_q):
    rng = np.random.default_rng(sum(map(ord, name)))
    q, kp, vp, qs, ql, cl, bt = _case(rng, **kw)
    ref = np_ragged_oracle(q, kp, vp, qs, ql, cl, bt, window=window)
    jkern = np.asarray(jra.ragged_paged_attention_values(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), qs, ql, cl, bt,
        window=window, block_q=block_q, use_kernel=True))
    out = tra.ragged_paged_attention_values(
        *_torch_args(q, kp, vp, qs, ql, cl, bt), window=window,
        block_q=block_q).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, jkern, atol=ATOL, rtol=0)
    seq, _ = tra.token_arrays(qs, ql, cl, q.shape[0])
    assert np.all(out[seq < 0] == 0)          # padding rows are zero


def test_pages_bound_trims_without_changing_the_result():
    rng = np.random.default_rng(5)
    q, kp, vp, qs, ql, cl, bt = _case(rng)
    args = _torch_args(q, kp, vp, qs, ql, cl, bt)
    full = tra.ragged_paged_attention_values(*args, block_q=4)
    trimmed = tra.ragged_paged_attention_values(*args, block_q=4,
                                                pages_bound=4)
    assert torch.equal(full, trimmed)


def test_bf16_plain_matches_jax_xla_path():
    """bf16 pools: both plain versions round the softmax weights to
    bf16 before the weighted sum, so they agree to bf16 rounding."""
    rng = np.random.default_rng(6)
    q, kp, vp, qs, ql, cl, bt = _case(rng)
    bf = jnp.bfloat16
    jout = np.asarray(jra.ragged_paged_attention_values(
        jnp.asarray(q, bf), jnp.asarray(kp, bf), jnp.asarray(vp, bf), qs,
        ql, cl, bt, block_q=4, use_kernel=False).astype(jnp.float32))
    args = _torch_args(q, kp, vp, qs, ql, cl, bt)
    out = tra.ragged_paged_attention_values(
        *(a.bfloat16() for a in args[:3]), *args[3:], block_q=4)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), jout, atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("bound", [None, 2])
def test_gather_pages_matches_jax(bound):
    rng = np.random.default_rng(7)
    q, kp, vp, qs, ql, cl, bt = _case(rng)
    jk, jv = jra.gather_pages(jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(bt), context_lens=cl,
                              pages_bound=bound)
    tk, tv = tra.gather_pages(torch.from_numpy(kp), torch.from_numpy(vp),
                              torch.from_numpy(bt), cl, bound)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


PIECE_SETS = [
    [{"seq": 0, "tokens": [5, 6, 7], "offset": 0, "sample": True}],
    [{"seq": 2, "tokens": list(range(11)), "offset": 4, "sample": True},
     {"seq": 0, "tokens": [9], "offset": 20, "sample": False},
     {"seq": 1, "tokens": list(range(16)), "offset": 0, "sample": True}],
]


@pytest.mark.parametrize("block_q,pad_to", [(8, 16), (1, None), (4, 8)])
@pytest.mark.parametrize("pieces", range(len(PIECE_SETS)))
def test_pack_ragged_batch_matches_jax(pieces, block_q, pad_to):
    ps = PIECE_SETS[pieces]
    want = jra.pack_ragged_batch(ps, 4, block_q=block_q, pad_to=pad_to)
    got = tra.pack_ragged_batch(ps, 4, block_q=block_q, pad_to=pad_to)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_pack_starts_and_token_arrays_match_jax():
    ql = [3, 0, 9, 1]
    for bq in (1, 4, 8):
        js, jt = jra.pack_ragged_starts(ql, bq)
        ts, tt = tra.pack_ragged_starts(ql, bq)
        assert np.array_equal(js, ts) and jt == tt
        cl = [5, 0, 9, 30]
        for a, b in zip(jra.token_arrays(js, ql, cl, jt + 3),
                        tra.token_arrays(ts, ql, cl, tt + 3)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("with_padding", [False, True])
def test_scatter_matches_jax(with_padding):
    """Every live row lands where the JAX scatter puts it. Padding rows
    all write trash page 0, where the winner among repeated writes is
    unspecified on both sides, so page 0 is compared only without
    padding."""
    rng = np.random.default_rng(8)
    hk, p, ps, d, t = 2, 10, 4, 8, 12
    kp = rng.standard_normal((hk, p, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hk, p, ps, d)).astype(np.float32)
    kr = rng.standard_normal((t, hk, d)).astype(np.float32)
    vr = rng.standard_normal((t, hk, d)).astype(np.float32)
    bt = np.array([[3, 4, 0], [7, 1, 2]], np.int32)
    seq = np.array([0] * 6 + [1] * 6, np.int32)
    pos = np.array(list(range(2, 8)) + list(range(3, 9)), np.int32)
    if with_padding:
        seq[[4, 5, 11]] = -1
    jk, jv = jra.ragged_scatter_values(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kr),
        jnp.asarray(vr), jnp.asarray(bt), jnp.asarray(seq),
        jnp.asarray(pos))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = tra.ragged_scatter_values(tk, tv, torch.from_numpy(kr),
                                    torch.from_numpy(vr),
                                    torch.from_numpy(bt),
                                    torch.from_numpy(seq),
                                    torch.from_numpy(pos))
    assert out[0] is tk and out[1] is tv         # in place
    lo = 1 if with_padding else 0
    assert np.array_equal(tk.numpy()[:, lo:], np.asarray(jk)[:, lo:])
    assert np.array_equal(tv.numpy()[:, lo:], np.asarray(jv)[:, lo:])


def test_cpu_tensors_never_launch_the_kernel():
    rng = np.random.default_rng(9)
    args = _torch_args(*_case(rng))
    before = launch_counts["ragged_paged_attention"]
    tra.ragged_paged_attention_values(*args, block_q=4)
    assert launch_counts["ragged_paged_attention"] == before
    with pytest.raises(ValueError, match="CUDA"):
        tra.ragged_paged_attention_values(*args, block_q=4,
                                          use_kernel=True)
