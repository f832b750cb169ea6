"""Packed (varlen) flash attention of the PyTorch port
(`paddle_tpu_torch.ops.flash_varlen`, and `nn.functional.
flash_attn_unpadded` with its packed forms) against the JAX package's
`flash_attention_varlen_values`, which on the CPU runs its three Pallas
kernels in interpret mode (the forward, and through its custom VJP the
dQ and dK/dV kernels) where the lengths tile by 128, and its XLA branch
(`_varlen_xla`) where they do not. The port's CPU path is its plain
version, forward and backward, under `_FlashVarlenFn`; its CUDA kernels
are held against that plain version on the card in
tests/test_torch_cuda_kernels.py.

Inputs are f32, made from a seed with numpy and handed to both; the
packings are those of tests/test_flash_varlen.py (contiguous runs, tail
padding), plus non-monotone ids, Sq != Sk and GQA 4:2. The outputs and
the gradients of ``sum(o * g)`` must agree within atol 2e-5 plus rtol
1e-5: the same f32 math, blocked by tiles on the JAX side and whole rows
on the port's. Padding rows give exact zeros and zero gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import flash_varlen as jfv
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_varlen as tfv
from paddle_tpu_torch.ops import launch_counts

TOL = dict(atol=2e-5, rtol=1e-5)


def _random_packing(rng, b, s, max_segs=4):
    """Random segment ids per batch row: contiguous runs, tail padding
    (≙ tests/test_flash_varlen.py `_random_packing`)."""
    seg = np.full((b, s), -1, np.int32)
    for i in range(b):
        n = rng.integers(1, max_segs + 1)
        cuts = np.sort(rng.choice(np.arange(1, s), n - 1, replace=False)) \
            if n > 1 else np.array([], np.int64)
        bounds = np.sort(np.concatenate([[0], cuts,
                                         [rng.integers(s // 2, s + 1)]]))
        for j in range(len(bounds) - 1):
            seg[i, bounds[j]:bounds[j + 1]] = j
    return seg


def _inputs(b, sq, sk, h, hk, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, sq, h, d), f(b, sk, hk, d), f(b, sk, hk, d), f(b, sq, h, d)


def _jax(q, k, v, g, seg_q, seg_k, causal):
    def loss(qq, kk, vv):
        o = jfv.flash_attention_varlen_values(
            qq, kk, vv, jnp.asarray(seg_q), jnp.asarray(seg_k),
            causal=causal)
        return jnp.sum(o * g), o
    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(x) for x in grads]


def _port(q, k, v, g, seg_q, seg_k, causal):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tfv.flash_attention_varlen_values(*leaves, torch.from_numpy(seg_q),
                                          torch.from_numpy(seg_k),
                                          causal=causal)
    o.backward(torch.from_numpy(g))
    return o.detach().numpy(), [t.grad.numpy() for t in leaves]


def _check(q, k, v, g, seg_q, seg_k, causal):
    jo, jgrads = _jax(q, k, v, g, seg_q, seg_k, causal)
    before = dict(launch_counts)
    to, tgrads = _port(q, k, v, g, seg_q, seg_k, causal)
    assert launch_counts == before      # the CPU runs the plain versions
    np.testing.assert_allclose(to, jo, **TOL)
    for name, a, b_ in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(a, b_, err_msg=f"d{name}", **TOL)
    # padding rows: exact zeros and zero gradient; padding keys: no grad
    pad_q, pad_k = seg_q < 0, seg_k < 0
    assert not to[pad_q].any() and not tgrads[0][pad_q].any()
    assert not tgrads[1][pad_k].any() and not tgrads[2][pad_k].any()
    return to


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_packings_match_jax_pallas(causal, seed):
    """b = 2, s = 256, h = 4, hk = 2, d = 32: both lengths tile, so JAX
    runs its Pallas kernels (interpret mode)."""
    b, s, h, hk, d = 2, 256, 4, 2, 32
    assert s % min(jfv.DEFAULT_BLOCK_Q, s) == 0
    seg = _random_packing(np.random.default_rng(seed), b, s)
    q, k, v, g = _inputs(b, s, s, h, hk, d, seed)
    _check(q, k, v, g, seg, seg, causal)


# (label, B, Sq, Sk, H, HK, D, causal, packing)
CASES = [("sq_lt_sk", 1, 128, 256, 4, 2, 32, True, "random"),
         ("non_monotone", 2, 256, 256, 4, 2, 32, True, "shuffled"),
         ("mha_d64", 1, 128, 128, 2, 2, 64, False, "random"),
         ("xla_s200", 2, 200, 200, 4, 2, 32, True, "random"),
         ("xla_sq72_sk200", 1, 72, 200, 4, 1, 32, False, "random")]


def _segments(packing, b, sq, sk, seed):
    rng = np.random.default_rng(seed)
    if packing == "random":
        return _random_packing(rng, b, sq), _random_packing(rng, b, sk)
    # non-monotone: ids drawn at random per position from 3 segments,
    # some positions padding, the same ids for q and k
    seg = rng.integers(-1, 3, (b, sq)).astype(np.int32)
    return seg, seg


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_edge_cases_match_jax(case):
    """Sq != Sk, non-monotone ids, MHA; lengths that do not tile by 128
    send JAX to `_varlen_xla`, forward and gradients."""
    label, b, sq, sk, h, hk, d, causal, packing = case
    seg_q, seg_k = _segments(packing, b, sq, sk, len(label))
    q, k, v, g = _inputs(b, sq, sk, h, hk, d, len(label) + 1)
    _check(q, k, v, g, seg_q, seg_k, causal)


def test_single_segment_equals_dense_flash():
    """One segment and no padding is dense causal attention."""
    from paddle_tpu_torch.ops import flash_attention as tfa
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 96, 96, 4, 2, 16,
                                                      3))
    seg = torch.zeros(1, 96, dtype=torch.int32)
    o = tfv.flash_attention_varlen_values(q, k, v, seg, seg, causal=True)
    torch.testing.assert_close(
        o, tfa.flash_attention_values(q, k, v, causal=True), rtol=0, atol=0)


@pytest.mark.parametrize("cu,total", [([0, 5, 9, 16], 16),
                                      ([0, 3, 3, 10], 14), ([0, 7], 7)])
def test_segments_from_cu_seqlens_match_jax(cu, total):
    want = np.asarray(jfv.segments_from_cu_seqlens(jnp.asarray(cu), total))
    got = tfv.segments_from_cu_seqlens(np.asarray(cu), total)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_tensor(x):
    return paddle.to_tensor(x, stop_gradient=False)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("branch", ["kernel", "masked"])
def test_flash_attn_unpadded_matches_jax(branch, causal):
    """The B = 1 packing through the varlen path, and (causal with
    total_q != total_k) the masked per-segment-position branch; forward
    and the gradients of ``sum(o * g)``, with a padding tail."""
    rng = np.random.default_rng(11)
    h, hk, d = 4, 2, 16
    cu_k = np.array([0, 40, 97, 150], np.int32)
    cu_q = cu_k if branch == "kernel" else np.array([0, 20, 50, 70],
                                                    np.int32)
    tq, tk = (160, 160) if branch == "kernel" else (80, 160)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, g = f(tq, h, d), f(tk, hk, d), f(tk, hk, d), f(tq, h, d)
    jq, jk, jv = _jax_tensor(q), _jax_tensor(k), _jax_tensor(v)
    jo, none = JF.flash_attn_unpadded(jq, jk, jv, paddle.to_tensor(cu_q),
                                      paddle.to_tensor(cu_k), 60, 60,
                                      causal=causal)
    (jo * paddle.to_tensor(g)).sum().backward()
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to, tnone = TF.flash_attn_unpadded(*leaves, torch.from_numpy(cu_q),
                                       torch.from_numpy(cu_k), 60, 60,
                                       dropout=0.1, causal=causal)
    to.backward(torch.from_numpy(g))
    assert none is None and tnone is None
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo._value),
                               **TOL)
    for name, a, b_ in zip("qkv", leaves, (jq, jk, jv)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b_.grad._value),
                                   err_msg=f"d{name}", **TOL)
    assert not to.detach()[cu_q[-1]:].any()


def test_qkvpacked_forms_match_split_forms():
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((2, 64, 3, 4, 16))
                           .astype(np.float32))
    out, _ = TF.flash_attn_qkvpacked(qkv, causal=True)
    want, _ = TF.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                 causal=True)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    jout, _ = JF.flash_attn_qkvpacked(paddle.to_tensor(qkv.numpy()),
                                      causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout._value), **TOL)

    cu = np.array([0, 30, 64, 100], np.int32)
    packed = torch.from_numpy(rng.standard_normal((112, 3, 4, 16))
                              .astype(np.float32))
    out, _ = TF.flash_attn_varlen_qkvpacked(packed, cu, cu, 36, 36,
                                            causal=True)
    want, _ = TF.flash_attn_unpadded(packed[:, 0], packed[:, 1],
                                     packed[:, 2], cu, cu, 36, 36,
                                     causal=True)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    jout, _ = JF.flash_attn_varlen_qkvpacked(
        paddle.to_tensor(packed.numpy()), paddle.to_tensor(cu),
        paddle.to_tensor(cu), 36, 36, causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout._value), **TOL)
    with TF.sdp_kernel(enable_flash=True):
        pass


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor runs the plain version (no kernel launch counted);
    demanding the kernel for it raises, as there is no CPU build."""
    before = dict(launch_counts)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 2, 200,
                                                      1))
    seg = torch.zeros(1, 8, dtype=torch.int32)
    tfv.flash_attention_varlen_values(q, k, v, seg, seg)
    assert launch_counts == before
    with pytest.raises(ValueError, match="CUDA"):
        tfv.flash_attention_varlen_values(q, k, v, seg, seg,
                                          use_kernel=True)
