"""Flash attention of the PyTorch port (`paddle_tpu_torch.ops.
flash_attention`) against the JAX package's `flash_attention_values`,
which on the CPU runs the three Pallas kernels in interpret mode (the
forward, and through its custom VJP the dQ and dK/dV kernels) where the
lengths tile, and its XLA fallback (`_attention_xla`) where they do not.
The port's CPU path is its plain version, forward and backward
(`flash_attention_ref`, `flash_attention_bwd_ref` under
`_FlashAttentionFn`); its CUDA kernels are held against that plain
version on the card in tests/test_torch_cuda_kernels.py.

Inputs are f32, made from a seed with numpy and handed to both. The
outputs and the gradients of ``sum(o * g)`` must agree within atol 2e-5
plus rtol 1e-5: the same f32 math, blocked by tiles on the JAX side and
whole rows on the port's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import launch_counts

TOL = dict(atol=2e-5, rtol=1e-5)

# (label, B, Sq, Sk, H, HK, D, causal, window); every Pallas case tiles
# (lengths multiples of 128), GQA 4:2
CASES = [("causal", 1, 256, 256, 4, 2, 32, True, None),
         ("window", 1, 256, 256, 4, 2, 32, True, 48),
         ("sq_lt_sk", 1, 128, 256, 4, 2, 32, True, None),
         ("sq_gt_sk_zero_rows", 1, 256, 128, 4, 2, 32, True, None),
         ("noncausal", 2, 128, 256, 4, 2, 64, False, None),
         ("mha", 1, 128, 128, 2, 2, 32, True, None)]


def _inputs(b, sq, sk, h, hk, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, sq, h, d), f(b, sk, hk, d), f(b, sk, hk, d), f(b, sq, h, d)


def _jax(q, k, v, g, causal, window):
    def loss(qq, kk, vv):
        o = jfa.flash_attention_values(qq, kk, vv, causal=causal,
                                       window_size=window)
        return jnp.sum(o * g), o
    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(x) for x in grads]


def _port(q, k, v, g, causal, window):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention_values(*leaves, causal=causal,
                                   window_size=window)
    o.backward(torch.from_numpy(g))
    return o.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_and_grads_match_jax_pallas(case):
    label, b, sq, sk, h, hk, d, causal, window = case
    bq = jfa._auto_block(sq, d)
    assert jfa._aligned(sq, sk, d, bq, jfa._auto_block(sk, d))
    q, k, v, g = _inputs(b, sq, sk, h, hk, d, len(label))
    jo, jgrads = _jax(q, k, v, g, causal, window)
    before = dict(launch_counts)
    to, tgrads = _port(q, k, v, g, causal, window)
    assert launch_counts == before      # the CPU runs the plain versions
    np.testing.assert_allclose(to, jo, **TOL)
    for name, a, b_ in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(a, b_, err_msg=f"d{name}", **TOL)
    if label == "sq_gt_sk_zero_rows":
        # rows that see no key: 0 and zero gradient, as the Pallas kernel
        dead = sq - sk
        assert not to[:, :dead].any() and not tgrads[0][:, :dead].any()


@pytest.mark.parametrize("window", [None, 16])
def test_unaligned_length_matches_jax_xla_fallback(window):
    """S = 200 does not tile (blocks of 128): JAX takes `_attention_xla`;
    the port has no such fallback and runs the same plain versions as
    for any length."""
    q, k, v, g = _inputs(2, 200, 200, 4, 2, 32, 7)
    assert not jfa._aligned(200, 200, 32, jfa._auto_block(200, 32),
                            jfa._auto_block(200, 32))
    jo, jgrads = _jax(q, k, v, g, True, window)
    to, tgrads = _port(q, k, v, g, True, window)
    np.testing.assert_allclose(to, jo, **TOL)
    for a, b_ in zip(tgrads, jgrads):
        np.testing.assert_allclose(a, b_, **TOL)


def test_lse_matches_the_pallas_forward():
    q, k, v, _ = _inputs(1, 256, 256, 4, 2, 32, 3)
    qb = jnp.swapaxes(jnp.asarray(q), 1, 2).reshape(4, 256, 32)
    kb = jnp.swapaxes(jnp.asarray(k), 1, 2).reshape(2, 256, 32)
    vb = jnp.swapaxes(jnp.asarray(v), 1, 2).reshape(2, 256, 32)
    _, lse = jfa._flash_fwd(qb, kb, vb, 32 ** -0.5, True, 256, 256, 2, 48)
    _, tlse = tfa.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), True, None, 48)
    np.testing.assert_allclose(tlse.numpy().reshape(4, 256),
                               np.asarray(lse)[..., 0], **TOL)


def test_refusals():
    q, k, v, _ = (torch.from_numpy(x) for x in
                  _inputs(1, 8, 8, 4, 2, 32, 0))
    with pytest.raises(ValueError, match="requires causal"):
        tfa.flash_attention_values(q, k, v, window_size=4)
    with pytest.raises(ValueError, match="> 0"):
        tfa.flash_attention_values(q, k, v, causal=True, window_size=0)
    with pytest.raises(ValueError, match="multiple of HK"):
        k3 = torch.zeros(1, 8, 3, 32)
        tfa.flash_attention_values(q, k3, k3)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_values(q, k, v, use_kernel=True)


def test_kernel_errors_are_scale_free_and_catch_a_skipped_tile():
    """`kernel_errors`, by which the card holds the kernels to the plain
    versions: the same for any scale of the outputs, within
    `KERNEL_LIMITS` for one bf16 rounding of the outputs, over them when
    every row skips the 64-key tile of its last key, nan when the output
    is not finite, and 0 for rows that are 0 in both."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 300, 4, 32),
                                                    np.float32))
               for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    o, _ = tfa.flash_attention_ref(q, k, v, causal=True)
    lim = tfa.KERNEL_LIMITS[torch.bfloat16]
    rel, row = tfa.kernel_errors(o.bfloat16(), o)
    assert 0 < rel <= lim["rel"] and rel <= row <= lim["row"]
    assert tfa.kernel_errors(1024 * o.bfloat16(), 1024 * o) == \
        pytest.approx((rel, row), rel=1e-3)
    j = torch.arange(300)
    skip = tfa._live(300, 300, True, None, "cpu") & \
        (j[None, :] // 64 != (j // 64)[:, None])
    live = tfa._live
    tfa._live = lambda *a: skip
    try:
        bad, _ = tfa.flash_attention_ref(q, k, v, causal=True)
    finally:
        tfa._live = live
    rel, row = tfa.kernel_errors(bad, o)
    assert rel > 10 * lim["rel"] and row > 10 * lim["row"]
    nan = o.clone()
    nan[0, 5, 1, 3] = float("nan")
    assert not tfa.kernel_errors(nan, o)[1] <= lim["row"]
    assert tfa.kernel_errors(torch.zeros(1, 3, 2, 8),
                             torch.zeros(1, 3, 2, 8)) == (0.0, 0.0)
