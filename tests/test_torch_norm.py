"""RMSNorm of the PyTorch port (`paddle_tpu_torch.ops.norm_kernels`)
against the JAX package's `rms_norm_values`, which on the CPU runs the
Pallas kernel in interpret mode (row counts that divide the block) or
its XLA fallback (ragged row counts). The port's CPU path is its plain
version; the CUDA kernel is held against that plain version on the card
in tests/test_torch_cuda_kernels.py."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops import norm_kernels as jnk
from paddle_tpu_torch.ops import launch_counts
from paddle_tpu_torch.ops import norm_kernels as tnk

SHAPES = [(8, 128), (16, 256), (300, 64)]     # (300, 64): ragged rows


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_matches_jax(shape):
    x, w = _inputs(shape, 0)
    ref = np.asarray(jnk.rms_norm_values(jnp.asarray(x), jnp.asarray(w),
                                         1e-5))
    out = tnk.rms_norm_values(torch.from_numpy(x), torch.from_numpy(w),
                              1e-5)
    assert out.dtype == torch.float32 and out.shape == shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_within_one_ulp_of_jax(shape):
    """Both sides round the same f32 inputs to bf16 and compute in f32;
    the stored results may differ by one bf16 ulp (2**-7 relative)."""
    x, w = _inputs(shape, 1)
    ref = np.asarray(jnk.rms_norm_values(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        1e-5).astype(jnp.float32))
    out = tnk.rms_norm_values(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(w).bfloat16(), 1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-6)


def test_leading_axes_are_rows():
    x, w = _inputs((2, 3, 64), 2)
    flat = tnk.rms_norm_values(torch.from_numpy(x.reshape(6, 64)),
                               torch.from_numpy(w))
    out = tnk.rms_norm_values(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(out.reshape(6, 64), flat)


def test_cpu_tensor_never_launches_the_kernel():
    x, w = _inputs((8, 64), 3)
    before = launch_counts["rms_norm"]
    tnk.rms_norm_values(torch.from_numpy(x), torch.from_numpy(w))
    assert launch_counts["rms_norm"] == before
    with pytest.raises(ValueError, match="CUDA"):
        tnk.rms_norm_values(torch.from_numpy(x), torch.from_numpy(w),
                            use_kernel=True)
