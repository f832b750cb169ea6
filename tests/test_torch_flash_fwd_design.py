"""The flash attention forward's two designs in the PyTorch port
(`paddle_tpu_torch.ops.flash_attention`), on the CPU.

- `sm90_design` picks the wgmma kernel (`csrc/flash_fwd_sm90.cu`) for
  bf16 and f16 at head dims 64 and 128 and the mma.sync kernel
  (`csrc/flash_attention.cu`) for every other input; the card tests
  (tests/test_torch_cuda_kernels.py) hold both against the plain version.
- The private ``_design="wgmma"`` of `_flash_fwd` refuses an input the
  wgmma kernel cannot take with a ValueError before any launch (and
  before the device check, so the refusal shows here).
- The plain forward, which the card holds the new kernel against, still
  matches the JAX package's `_fwd_kernel` run in interpret mode at head
  dims 64 and 128 under causal, window, Sq != Sk and zero-key rows.

Inputs are f32, made from a seed with numpy and handed to both sides. o
and lse agree within atol 2e-5 plus rtol 1e-5 (the same f32 math, tiled
by 128 keys on the JAX side and whole rows on the port's); the lse of a
row with no live key is -1e30 on both (rtol 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import launch_counts

TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [8, 32, 63, 64, 72, 96, 100, 127, 128, 136,
                               192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_fwd_design_by_dtype_and_head_dim(dtype, d):
    want = "wgmma" if dtype != torch.float32 and d in (64, 128) \
        else "mma.sync"
    assert tfa.sm90_design(dtype, d) == want


@pytest.mark.parametrize("d,dtype", [(64, torch.float32),
                                     (128, torch.float32),
                                     (72, torch.bfloat16),
                                     (96, torch.bfloat16),
                                     (256, torch.bfloat16),
                                     (32, torch.float16)])
def test_wgmma_design_refuses_before_launch(d, dtype):
    q = torch.zeros(1, 8, 2, d, dtype=dtype)
    k = torch.zeros(1, 8, 1, d, dtype=dtype)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="wgmma flash forward takes"):
        tfa._flash_fwd(q, k, k, 0.1, True, None, _design="wgmma")
    assert launch_counts == before


def test_other_refusals_before_launch():
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="no flash forward design"):
        tfa._flash_fwd(q, q, q, 0.1, True, None, _design="tiled")
    # a design the input can take gets as far as the device check
    with pytest.raises(ValueError, match="CUDA device"):
        tfa._flash_fwd(q, q, q, 0.1, True, None, _design="wgmma")
    with pytest.raises(ValueError, match="CUDA device"):
        tfa._flash_fwd(q, q, q, 0.1, True, None, _design="mma.sync")
    assert launch_counts == before


# (label, B, Sq, Sk, H, HK, causal, window): lengths multiples of the
# Pallas kernel's 128-row blocks, GQA 4:2
CASES = [("causal", 1, 256, 256, 4, 2, True, None),
         ("window", 1, 256, 256, 4, 2, True, 48),
         ("sq_lt_sk", 1, 128, 256, 4, 2, True, None),
         ("sq_gt_sk_zero_rows", 1, 256, 128, 4, 2, True, None),
         ("noncausal", 2, 128, 256, 4, 4, False, None)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_forward_matches_interpret_fwd_kernel(case, d):
    label, b, sq, sk, h, hk, causal, window = case
    rng = np.random.default_rng(sq * 3 + sk + d)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(b, sq, h, d), f(b, sk, hk, d), f(b, sk, hk, d)
    scale = d ** -0.5
    # the JAX kernel's (B*H, S, D) layout
    fold = lambda x, n: jnp.asarray(
        np.swapaxes(x, 1, 2).reshape(b * n, x.shape[1], d))
    jo, jlse = jfa._flash_fwd(fold(q, h), fold(k, hk), fold(v, hk), scale,
                              causal, 128, 128, h // hk, window)
    jo = np.swapaxes(np.asarray(jo).reshape(b, h, sq, d), 1, 2)
    jlse = np.asarray(jlse)[..., 0].reshape(b, h, sq)
    before = dict(launch_counts)
    to, tlse = tfa.flash_attention_ref(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal, scale,
                                       window)
    assert launch_counts == before
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    live = jlse > -1e29
    np.testing.assert_allclose(tlse.numpy()[live], jlse[live], **TOL)
    np.testing.assert_allclose(tlse.numpy()[~live], jlse[~live], rtol=1e-5)
    if label == "sq_gt_sk_zero_rows":
        dead = sq - sk
        assert not to[:, :dead].any()
        assert bool((tlse[..., :dead] == -1e30).all())
        assert not live[..., :dead].any() and live[..., dead:].all()
