"""Quantization core of the PyTorch port against the JAX package, on the
CPU: the absmax round-clip core (`paddle_tpu_torch.nn.quant`), weight
quantization and the dequant matmul's plain version
(`paddle_tpu_torch.ops.quant_matmul`), the quantized KV scatter and the
int8-KV branch of ragged paged attention's plain version
(`paddle_tpu_torch.ops.ragged_paged_attention`).

Tolerances: quantized bytes and scales must be EQUAL (the quantized
engine's bit-identity contracts rest on them); the dequant matmul
rtol 2e-5 / atol 2e-4 and quantized attention atol/rtol 2e-5, the
tolerances of the JAX package's own tests (tests/test_quant_serving.py
:171 and :315): f32 sums taken in another order. The CUDA kernels are
held against these plain versions on the card in
tests/test_torch_cuda_kernels.py."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.nn.quant import absmax_round_clip_values as j_round_clip
from paddle_tpu.ops import quant_matmul as jqm
from paddle_tpu.ops import ragged_paged_attention as jra
from paddle_tpu_torch.models.convert import quantized_weight_from_numpy
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.quant import absmax_round_clip_values
from paddle_tpu_torch.ops import launch_counts
from paddle_tpu_torch.ops import quant_matmul as tqm
from paddle_tpu_torch.ops import ragged_paged_attention as tra
from test_ragged_attention import _case

MM_TOL = dict(rtol=2e-5, atol=2e-4)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


# -- the round-clip core ------------------------------------------------
ROUND_CASES = {
    # (v, absmax, qmax)
    "normal": (np.random.default_rng(0).normal(size=64) * 3, None, 127.0),
    # halves: v / 4 * 4 lands exactly on x.5, which rounds to even
    "half_to_even": (np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]),
                     4.0, 4.0),
    "minus_128": (np.array([-2.0, -1.0, 1.0, 2.0]), 1.0, 127.0),
    "zero_guard": (np.zeros(4), 0.0, 127.0),
    "tiny_absmax": (np.array([1e-12, -1e-12, 0.0]), 1e-12, 127.0),
}


@pytest.mark.parametrize("name", sorted(ROUND_CASES))
def test_round_clip_matches_jax(name):
    v, absmax, qmax = ROUND_CASES[name]
    v = v.astype(np.float32)
    if absmax is None:
        absmax = np.abs(v).max()
    absmax = np.float32(absmax)
    want = np.asarray(j_round_clip(jnp.asarray(v), absmax, qmax,
                                   out_dtype=jnp.int8
                                   if qmax == 127.0 else None))
    got = absmax_round_clip_values(torch.from_numpy(v),
                                   torch.tensor(absmax), qmax,
                                   torch.int8 if qmax == 127.0 else None)
    np.testing.assert_array_equal(got.numpy(), want)


def test_round_clip_reaches_minus_128_and_guards_zero():
    got = absmax_round_clip_values(torch.tensor([-2.0, -1.0, 1.0]), 1.0,
                                   127.0, torch.int8)
    assert got.tolist() == [-128, -127, 127]
    assert absmax_round_clip_values(torch.zeros(4), 0.0, 127.0,
                                    torch.int8).tolist() == [0] * 4
    # the lattice values rounded half to even, before the clip
    got = absmax_round_clip_values(torch.tensor([0.5, 1.5, 2.5, -2.5]),
                                   4.0, 4.0)
    assert got.tolist() == [0.0, 2.0, 2.0, -2.0]


# -- weight quantization --------------------------------------------------
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_storage_equals_jax_after_transpose(mode, dtype):
    """JAX stores (K, N) with per-column scales; the port stores (N, K)
    with per-row scales. The bytes must be the same, transposed."""
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(96, 40)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0                           # an all-zero channel: guard
    w[5, 7] = -4.0                          # an outlier
    jw = jnp.asarray(w, dtype)
    jq, js = jqm.quantize_weight_values(jw, mode)
    tw = torch.from_numpy(np.asarray(jw.astype(jnp.float32)).T.copy()) \
        .to(getattr(torch, dtype))
    tq, ts = tqm.quantize_weight_values(tw, mode)
    assert tq.shape == (40, 96)
    assert tq.dtype == (torch.int8 if mode == "int8"
                        else torch.float8_e4m3fn)
    np.testing.assert_array_equal(_bytes(tq),
                                  np.asarray(jq).view(np.uint8).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the carry gives the same weight
    carried = quantized_weight_from_numpy(np.asarray(jq), np.asarray(js))
    np.testing.assert_array_equal(_bytes(carried.qw), _bytes(tq))
    assert torch.equal(carried.scale, ts)


def test_dequant_error_bounded_by_lattice():
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32))
    qw, sc = tqm.quantize_weight_values(w, "int8")
    deq = qw.float() * sc[:, None]
    # per-channel absmax lattice: error <= scale / 2 per element
    assert bool(((deq - w).abs() <= sc[:, None] * 0.5 + 1e-7).all())


def test_quantized_weight_nbytes_and_validation():
    qw, sc = tqm.quantize_weight_values(torch.ones(8, 8), "int8")
    w = tqm.QuantizedWeight(qw, sc)
    assert w.nbytes == 8 * 8 + 8 * 4 and w.shape == (8, 8)
    with pytest.raises(ValueError, match="int8|fp8"):
        tqm.quantize_weight_values(torch.ones(4, 4), "int4")
    with pytest.raises(ValueError, match="wants"):
        tqm.quantize_weight_values(torch.ones(4), "int8")
    with pytest.raises(ValueError, match="int8 or"):
        quantized_weight_from_numpy(np.ones((4, 4), np.float32),
                                    np.ones(4, np.float32))


# -- the dequant matmul's plain version ------------------------------------
MM_CASES = [("int8", 8, 128, 256), ("int8", 32, 64, 128),
            ("int8", 5, 96, 512), ("int8", 1, 100, 130),
            ("fp8", 4, 64, 128), ("fp8", 9, 48, 72)]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mode,m,k,n", MM_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}"
                              for c in MM_CASES])
def test_dequant_matmul_plain_matches_jax(mode, m, k, n, use_kernel):
    """Against JAX `dequant_matmul_values` with its Pallas kernel in
    interpret mode (``use_kernel=True``; JAX itself sends fp8 and
    off-grid shapes through XLA) and through XLA."""
    rng = np.random.default_rng(m + k + n)
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    jq, js = jqm.quantize_weight_values(jnp.asarray(w), mode)
    want = np.asarray(jqm.dequant_matmul_values(jnp.asarray(x), jq, js,
                                                use_kernel=use_kernel))
    tw = quantized_weight_from_numpy(np.asarray(jq), np.asarray(js))
    got = tqm.dequant_matmul_values(torch.from_numpy(x), tw.qw, tw.scale)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **MM_TOL)


def test_dequant_matmul_keeps_leading_dims_and_dtype():
    rng = np.random.default_rng(1)
    qw, sc = tqm.quantize_weight_values(
        torch.from_numpy(rng.normal(size=(24, 16)).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(2, 3, 16)).astype(np.float32))
    out = tqm.dequant_matmul_values(x, qw, sc)
    assert out.shape == (2, 3, 24)
    # one row against the same row alone: the CPU BLAS may block the
    # f32 sums differently for another row count
    torch.testing.assert_close(out[1, 2], tqm.dequant_matmul_ref(
        x[1, 2:3], qw, sc)[0], rtol=1e-6, atol=1e-6)
    xb = x.bfloat16()
    assert tqm.dequant_matmul_values(xb, qw, sc).dtype == torch.bfloat16


def test_linear_routes_a_quantized_weight():
    rng = np.random.default_rng(2)
    qw, sc = tqm.quantize_weight_values(
        torch.from_numpy(rng.normal(size=(12, 8)).astype(np.float32)),
        "fp8")
    w = tqm.QuantizedWeight(qw, sc)
    x = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    b = torch.arange(12, dtype=torch.float32)
    assert torch.equal(F.linear(x, w), tqm.dequant_matmul_ref(x, qw, sc))
    assert torch.equal(F.linear(x, w, b),
                       tqm.dequant_matmul_ref(x, qw, sc) + b)


# -- quantized KV pages ------------------------------------------------------
def _jax_quantized_pools(kp, vp):
    """Quantize every row of f32 pools (HK, P, ps, D) with the JAX
    scatter: one sequence whose block table lists every page."""
    hk, p, ps, d = kp.shape
    rows = lambda a: jnp.asarray(a.transpose(1, 2, 0, 3).reshape(p * ps,
                                                                 hk, d))
    z8 = jnp.zeros((hk, p, ps, d), jnp.int8)
    zs = jnp.zeros((p, ps), jnp.float32)
    out = jra.ragged_scatter_quantized(
        z8, z8, zs, zs, rows(kp), rows(vp),
        jnp.arange(p, dtype=jnp.int32)[None],
        jnp.zeros(p * ps, jnp.int32), jnp.arange(p * ps, dtype=jnp.int32))
    return [np.array(a) for a in out]


@pytest.mark.parametrize("with_padding", [False, True])
def test_scatter_quantized_matches_jax(with_padding):
    """Values AND scales equal JAX's for every live row. Padding rows
    all land on trash page 0, where the winner among repeated writes is
    unspecified, so page 0 is compared only without padding."""
    rng = np.random.default_rng(8)
    hk, p, ps, d, t = 2, 10, 4, 8, 12
    kr = (rng.standard_normal((t, hk, d)) * 2).astype(np.float32)
    vr = rng.standard_normal((t, hk, d)).astype(np.float32)
    kr[3] = 0.0                               # all-zero row: scale 0
    bt = np.array([[3, 4, 0], [7, 1, 2]], np.int32)
    seq = np.array([0] * 6 + [1] * 6, np.int32)
    pos = np.array(list(range(2, 8)) + list(range(3, 9)), np.int32)
    if with_padding:
        seq[[4, 5, 11]] = -1
    z8 = np.zeros((hk, p, ps, d), np.int8)
    zs = np.zeros((p, ps), np.float32)
    want = jra.ragged_scatter_quantized(
        jnp.asarray(z8), jnp.asarray(z8), jnp.asarray(zs), jnp.asarray(zs),
        jnp.asarray(kr), jnp.asarray(vr), jnp.asarray(bt),
        jnp.asarray(seq), jnp.asarray(pos))
    pools = [torch.from_numpy(a.copy()) for a in (z8, z8, zs, zs)]
    got = tra.ragged_scatter_quantized(
        *pools, torch.from_numpy(kr), torch.from_numpy(vr),
        torch.from_numpy(bt), torch.from_numpy(seq), torch.from_numpy(pos))
    assert all(a is b for a, b in zip(got, pools))          # in place
    lo = 1 if with_padding else 0
    for g, w in zip(got, want):
        w = np.asarray(w)
        if g.ndim == 4:
            np.testing.assert_array_equal(g.numpy()[:, lo:], w[:, lo:])
        else:
            np.testing.assert_array_equal(g.numpy()[lo:], w[lo:])
    # the all-zero row 3 (sequence 0, position 5: page 4, slot 1) keeps
    # an unguarded scale of 0
    assert float(pools[2][4, 1]) == 0.0
    assert pools[0].dtype == torch.int8


def test_scatter_quantized_is_path_invariant():
    """A page written row by row (decode) holds the same bytes and
    scales as the same rows written in one commit (a re-prefill)."""
    rng = np.random.default_rng(5)
    hk, d, ps, pages = 2, 8, 4, 4
    bt = torch.tensor([[1, 2]], dtype=torch.int32)
    rk = torch.from_numpy(rng.normal(size=(6, hk, d)).astype(np.float32))
    rv = torch.from_numpy(rng.normal(size=(6, hk, d)).astype(np.float32))

    def pools():
        return [torch.zeros(hk, pages, ps, d, dtype=torch.int8),
                torch.zeros(hk, pages, ps, d, dtype=torch.int8),
                torch.zeros(pages, ps), torch.zeros(pages, ps)]
    bulk = tra.ragged_scatter_quantized(
        *pools(), rk, rv, bt, torch.zeros(6, dtype=torch.int32),
        torch.arange(6, dtype=torch.int32))
    inc = pools()
    for t in range(6):
        tra.ragged_scatter_quantized(
            *inc, rk[t:t + 1], rv[t:t + 1], bt,
            torch.zeros(1, dtype=torch.int32),
            torch.tensor([t], dtype=torch.int32))
    for a, b in zip(bulk, inc):
        assert torch.equal(a, b)


def test_zero_rows_dequantize_to_exact_zero():
    hk, d, ps, pages = 1, 8, 4, 2
    kp, vp = (torch.zeros(hk, pages, ps, d, dtype=torch.int8)
              for _ in range(2))
    ks, vs = torch.ones(pages, ps), torch.ones(pages, ps)
    tra.ragged_scatter_quantized(
        kp, vp, ks, vs, torch.zeros(1, hk, d), torch.zeros(1, hk, d),
        torch.tensor([[1]], dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    assert float(ks[1, 0]) == 0.0 and int(kp.abs().max()) == 0


def test_gather_page_scales_matches_jax():
    rng = np.random.default_rng(3)
    pool = rng.normal(size=(9, 4)).astype(np.float32)
    bt = np.array([[3, 1, 0], [8, 2, 5]], np.int32)
    want = np.asarray(jra.gather_page_scales(jnp.asarray(pool),
                                             jnp.asarray(bt), 2))
    got = tra.gather_page_scales(torch.from_numpy(pool),
                                 torch.from_numpy(bt), 2)
    np.testing.assert_array_equal(got.numpy(), want)


# (name, _case kwargs, window, block_q), as tests/test_torch_ragged_attention
QCASES = [
    ("mixed", dict(), None, 4),
    ("window", dict(), 3, 4),
    ("gqa4", dict(g=4), None, 4),
    ("qlen0", dict(ql=(0, 7, 5, 0), cl=(0, 7, 13, 4), n_pages=16), None, 4),
    ("decode_bq1", dict(ql=(1, 1, 1), cl=(9, 1, 13), block_q=1,
                        tail_pad=1), None, 1),
    ("bq8_window", dict(ql=(1, 9, 5), cl=(9, 9, 13), block_q=8,
                        tail_pad=0, n_pages=16), 3, 8),
]


@pytest.mark.parametrize("name,kw,window,block_q", QCASES,
                         ids=[c[0] for c in QCASES])
def test_quantized_attention_plain_matches_jax(name, kw, window, block_q):
    """The plain version over int8 pools and scales against the JAX
    Pallas kernel in interpret mode and against JAX's XLA path."""
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    q, kp, vp, qs, ql, cl, bt = _case(rng, **kw)
    kq, vq, ks, vs = _jax_quantized_pools(kp, vp)
    out = tra.ragged_paged_attention_values(
        torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
        *(torch.from_numpy(np.asarray(a, np.int32))
          for a in (qs, ql, cl, bt)),
        window=window, block_q=block_q, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs)).numpy()
    for use_kernel in (True, False):
        want = np.asarray(jra.ragged_paged_attention_values(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), qs, ql, cl,
            jnp.asarray(bt), window=window, block_q=block_q,
            use_kernel=use_kernel, k_scale=jnp.asarray(ks),
            v_scale=jnp.asarray(vs)))
        np.testing.assert_allclose(out, want, **ATTN_TOL)
    seq, _ = tra.token_arrays(qs, ql, cl, q.shape[0])
    assert np.all(out[seq < 0] == 0)


def test_quantized_attention_needs_both_scales():
    rng = np.random.default_rng(0)
    q, kp, vp, qs, ql, cl, bt = _case(rng)
    kq, vq, ks, vs = _jax_quantized_pools(kp, vp)
    args = [torch.from_numpy(np.asarray(a)) for a in
            (q, kq, vq, qs, ql, cl, bt)]
    with pytest.raises(ValueError, match="together"):
        tra.ragged_paged_attention_values(*args, block_q=4,
                                          k_scale=torch.from_numpy(ks))


def test_cpu_tensors_never_launch_the_new_kernels():
    rng = np.random.default_rng(9)
    q, kp, vp, qs, ql, cl, bt = _case(rng)
    kq, vq, ks, vs = _jax_quantized_pools(kp, vp)
    args = [torch.from_numpy(np.asarray(a)) for a in
            (q, kq, vq, qs, ql, cl, bt)]
    scales = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    qw, sc = tqm.quantize_weight_values(torch.ones(8, 16))
    before = dict(launch_counts)
    tra.ragged_paged_attention_values(*args, block_q=4, **scales)
    tqm.dequant_matmul_values(torch.ones(3, 16), qw, sc)
    assert launch_counts == before
    with pytest.raises(ValueError, match="CUDA"):
        tra.ragged_paged_attention_values(*args, block_q=4,
                                          use_kernel=True, **scales)
    with pytest.raises(ValueError, match="CUDA"):
        tqm.dequant_matmul_values(torch.ones(3, 16), qw, sc,
                                  use_kernel=True)
    assert launch_counts == before
