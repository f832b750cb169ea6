"""Rotary position embedding of the PyTorch port (`paddle_tpu_torch.ops.
rope`) against the JAX package's `rope_values`: its Pallas kernel in
interpret mode (``paddle_tpu.ops.rope._FORCE_PALLAS`` set through
monkeypatch, as the JAX tests do; the lengths tile by its 256-row block)
and its XLA branch. The port's CPU path is its plain version under
`_RopeFn`; the CUDA kernel is held against that plain version on the
card in tests/test_torch_cuda_kernels.py.

Inputs from a numpy seed; tables from `precompute_rope`-style numpy f32
cos/sin. Tolerances: f32 rtol/atol 1e-6 (the same products and sums in
f32; XLA's CPU code may contract one into an FMA, moving the last bit);
bf16 one bf16 rounding of those f32 values (rtol 2^-7 plus atol 2^-7
of the largest |x|). The gradient is the inverse rotation of the
cotangent, and the tables get none."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops import rope as jrope
from paddle_tpu_torch.ops import launch_counts
from paddle_tpu_torch.ops import rope as trope

F32_TOL = dict(rtol=1e-6, atol=1e-6)


def _tables(max_len, d, theta=10000.0):
    inv = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
    ang = np.arange(max_len)[:, None] * inv[None, :]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _x(b, s, h, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, h, d)).astype(np.float32)


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())


def _jax_rope(x, cos, sin, offset, dtype, g):
    xj = jnp.asarray(x).astype(dtype)

    def f(xx):
        return jrope.rope_values(xx, jnp.asarray(cos), jnp.asarray(sin),
                                 offset)
    y, vjp = jax.vjp(f, xj)
    (dx,) = vjp(jnp.asarray(g).astype(dtype))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(dx.astype(jnp.float32)))


def _port_rope(x, cos, sin, offset, dtype, g):
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    ct = torch.from_numpy(cos).requires_grad_()
    st = torch.from_numpy(sin).requires_grad_()
    y = trope.rope_values(xt, ct, st, offset)
    y.backward(torch.from_numpy(g).to(xt.dtype))
    assert ct.grad is None and st.grad is None   # the tables get none
    return y.detach().float().numpy(), xt.grad.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 37])
@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])
def test_rope_values_and_grad_match_jax(monkeypatch, pallas, offset,
                                        dtype):
    monkeypatch.setattr(jrope, "_FORCE_PALLAS", pallas)
    b, s, h, d = 2, 256, 3, 32
    cos, sin = _tables(512, d)
    x, g = _x(b, s, h, d, 1), _x(b, s, h, d, 2)
    jy, jdx = _jax_rope(x, cos, sin, offset, dtype, g)
    before = dict(launch_counts)
    ty, tdx = _port_rope(x, cos, sin, offset, dtype, g)
    assert launch_counts == before      # the CPU runs the plain version
    _close(ty, jy, dtype)
    _close(tdx, jdx, dtype)


def test_gradient_is_the_inverse_rotation():
    cos, sin = _tables(64, 16)
    x = torch.from_numpy(_x(1, 40, 2, 16, 3)).requires_grad_()
    g = torch.from_numpy(_x(1, 40, 2, 16, 4))
    y = trope.rope_values(x, torch.from_numpy(cos), torch.from_numpy(sin), 5)
    y.backward(g)
    c, s = torch.from_numpy(cos[5:45]), torch.from_numpy(sin[5:45])
    torch.testing.assert_close(x.grad, trope.rope_ref(g, c, s, -1.0),
                               rtol=0, atol=0)
    # a rotation: the inverse undoes it, and norms of each pair are kept
    back = trope.rope_ref(y.detach(), c, s, -1.0)
    torch.testing.assert_close(back, x.detach(), rtol=1e-6, atol=1e-6)


def test_interleaved_pairs_not_half_split():
    """Pair (x[2i], x[2i+1]) turns by angle i: a unit vector in slot 2i
    moves into slots 2i and 2i+1 only."""
    cos, sin = _tables(4, 8)
    x = torch.zeros(1, 4, 1, 8)
    x[..., 2] = 1.0
    y = trope.rope_values(x, torch.from_numpy(cos), torch.from_numpy(sin))
    nz = (y[0, 3, 0] != 0).nonzero().flatten().tolist()
    assert nz == [2, 3]
    np.testing.assert_allclose(y[0, 3, 0, 2:4].numpy(),
                               [cos[3, 1], sin[3, 1]], rtol=1e-6)


def test_position_past_the_table_raises():
    cos, sin = _tables(16, 8)
    x = torch.zeros(1, 10, 1, 8)
    with pytest.raises(ValueError, match="exceeds precomputed table"):
        trope.rope_values(x, torch.from_numpy(cos), torch.from_numpy(sin),
                          position_offset=7)
    with pytest.raises(ValueError, match="exceeds precomputed table"):
        jrope.rope_values(jnp.zeros((1, 10, 1, 8)), jnp.asarray(cos),
                          jnp.asarray(sin), position_offset=7)


def test_fused_rotary_position_embedding_matches_jax():
    cos, sin = _tables(128, 16)
    q, k = _x(2, 64, 4, 16, 5), _x(2, 64, 2, 16, 6)
    jq, jk = jrope.fused_rotary_position_embedding(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(cos),
        paddle.to_tensor(sin), position_offset=3)
    tq, tk = trope.fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(cos),
        torch.from_numpy(sin), position_offset=3)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq._value), **F32_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk._value), **F32_TOL)
