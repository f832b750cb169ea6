"""The flash attention backward's two designs and the head-dim routing of
the PyTorch port (`paddle_tpu_torch.ops.flash_attention`, `.flash_varlen`)
on the CPU.

- `sm90_design` picks the wgmma kernels (`csrc/flash_bwd_sm90.cu`) for
  bf16 and f16 at head dims 64 and 128 and the mma.sync kernels
  (`csrc/flash_attention.cu`) for every other input; the card tests
  (tests/test_torch_cuda_kernels.py) hold both against the plain version.
  `dkv_splits` shares a KV head's query heads over blocks only where the
  wgmma dK/dV kernel would run fewer blocks than the card has SMs.
- A head dim past 256 leaves the kernels exactly where the reference's
  `_aligned` test on d sends it to `_attention_xla` (and its varlen entry
  to `_varlen_xla`): the port's `attention_xla` / `varlen_xla`, forward
  and grads against the JAX package's `flash_attention_values` /
  `flash_attention_varlen_values` on that branch.
- Head dims that are not a multiple of 8 (100, 36, an odd 37) stay on the
  kernels' path; on the CPU their plain versions match the JAX package's
  interpret-mode Pallas kernels.

Inputs are f32, made from a seed with numpy and handed to both sides. The
outputs and the gradients of ``sum(o * g)`` agree within atol 2e-5 plus
rtol 1e-5, as in tests/test_torch_flash_attention.py: the same f32 math
in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu.ops import flash_varlen as jfv
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import flash_varlen as tfv
from paddle_tpu_torch.ops import launch_counts

TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [8, 32, 36, 63, 64, 65, 72, 100, 127, 128,
                               136, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_bwd_design_by_dtype_and_head_dim(dtype, d):
    want = "wgmma" if dtype != torch.float32 and d in (64, 128) \
        else "mma.sync"
    assert tfa.sm90_design(dtype, d) == want
    lib, symbol = tfa._bwd_entry("dq", torch.zeros(1, 1, 1, d, dtype=dtype),
                                 None)
    assert (lib == "flash_bwd_sm90") == (want == "wgmma")
    assert symbol.endswith("_sm90") == (want == "wgmma")


def test_private_design_argument_names_either_design():
    q = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16)
    assert tfa._bwd_entry("dkv", q, "mma.sync") == ("flash_attention",
                                                   "pdt_flash_bwd_dkv")
    assert tfa._bwd_entry("dkv", q, "wgmma") == ("flash_bwd_sm90",
                                                "pdt_flash_bwd_dkv_sm90")
    with pytest.raises(ValueError, match="no flash backward design"):
        tfa._bwd_entry("dq", q, "tiled")


@pytest.mark.parametrize("b,sk,hk,g,want", [
    (2, 2048, 8, 4, 1),     # the 8B slice: 256 blocks fill 132 SMs
    (8, 2048, 8, 2, 1),     # the bench shape: 1024 blocks
    (1, 4096, 4, 7, 3),     # Qwen2-MoE-A14B's attention: 128 blocks
    (1, 4096, 4, 1, 1),     # one query head a KV head: nothing to split
    (1, 100, 1, 8, 8)])     # one block: at most G
def test_dkv_splits_fill_the_card(b, sk, hk, g, want):
    assert tfa.dkv_splits(b, sk, hk, g, 132) == want


def test_head_dim_routing_is_the_references_aligned_test_on_d():
    """With lengths that tile, `_aligned` decides on d alone: the port
    keeps exactly those head dims on its kernels."""
    for d in list(range(1, 520, 7)) + [255, 256, 257, 264, 320]:
        assert tfa.takes_head_dim(d) == jfa._aligned(256, 256, d, 128, 128)


def _inputs(b, sq, sk, h, hk, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, sq, h, d), f(b, sk, hk, d), f(b, sk, hk, d), f(b, sq, h, d)


def _port(fn, q, k, v, g):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = fn(*leaves)
    o.backward(torch.from_numpy(g))
    return o.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax(fn, q, k, v, g):
    def loss(qq, kk, vv):
        o = fn(qq, kk, vv)
        return jnp.sum(o * g), o
    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(x) for x in grads]


def _same(port, ref):
    np.testing.assert_allclose(port[0], ref[0], **TOL)
    for name, a, b in zip("qkv", port[1], ref[1]):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
def test_head_dim_264_matches_jax_attention_xla(causal, window):
    b, s, h, hk, d = 1, 128, 4, 2, 264
    assert not jfa._aligned(s, s, d, 128, 128)   # d alone sends it to XLA
    q, k, v, g = _inputs(b, s, s, h, hk, d, 264 + (window or 0))
    before = dict(launch_counts)
    port = _port(lambda *t: tfa.flash_attention_values(
        *t, causal=causal, window_size=window), q, k, v, g)
    assert launch_counts == before      # the CPU launches nothing
    ref = _jax(lambda *t: jfa.flash_attention_values(
        *t, causal=causal, window_size=window), q, k, v, g)
    _same(port, ref)


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_head_dim_264_matches_jax_varlen_xla(causal):
    b, s, h, hk, d = 2, 128, 4, 2, 264
    q, k, v, g = _inputs(b, s, s, h, hk, d, 7)
    seg = np.full((b, s), -1, np.int32)
    seg[0, :50], seg[0, 50:120] = 0, 1
    seg[1, :128] = np.repeat(np.arange(4), 32)
    port = _port(lambda *t: tfv.flash_attention_varlen_values(
        *t, torch.from_numpy(seg), torch.from_numpy(seg), causal=causal),
        q, k, v, g)
    ref = _jax(lambda *t: jfv.flash_attention_varlen_values(
        *t, jnp.asarray(seg), jnp.asarray(seg), causal=causal), q, k, v, g)
    _same(port, ref)
    pad = seg < 0
    assert not port[0][pad].any() and not port[1][0][pad].any()


@pytest.mark.parametrize("d", [100, 36, 37])
def test_head_dims_off_eight_match_jax_pallas(d):
    """Head dims off 8 stay on the kernels' path: the plain versions
    against the Pallas kernels in interpret mode (lengths tile, so the
    reference takes its kernels too)."""
    b, s, h, hk = 1, 128, 4, 2
    assert jfa._aligned(s, s, d, 128, 128)
    q, k, v, g = _inputs(b, s, s, h, hk, d, d)
    port = _port(lambda *t: tfa.flash_attention_values(*t, causal=True),
                 q, k, v, g)
    ref = _jax(lambda *t: jfa.flash_attention_values(*t, causal=True),
               q, k, v, g)
    _same(port, ref)
