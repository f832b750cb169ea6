"""RMSNorm gradients of the PyTorch port (`paddle_tpu_torch.ops.
norm_kernels.rms_norm_values`) against the JAX package's: on the CPU JAX
differentiates `rms_norm_values` through its custom VJP, whose backward
is the Pallas `_rms_bwd_kernel` in interpret mode (row counts that
divide the block, including several blocks of ``block_rows=128``
accumulating dw), or through XLA autodiff of its fallback (ragged row
counts). The port's CPU path differentiates its plain version with torch
autograd; the CUDA backward kernel is held against that on the card in
tests/test_torch_cuda_kernels.py.

Tolerances: f32 dx atol 1e-5 plus rtol 1e-5, dw atol/rtol 1e-4 (a sum
over up to 512 rows in another order); bf16 one bf16 ulp (both sides
compute in f32 and round once)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import norm_kernels as jnk
from paddle_tpu_torch.ops import launch_counts
from paddle_tpu_torch.ops import norm_kernels as tnk

# (rows, h, block_rows): one block, four blocks of 128, ragged rows
CASES = [(256, 128, 256), (512, 64, 128), (300, 64, 256), (6, 32, 256)]


def _inputs(n, h, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    g = rng.standard_normal((n, h)).astype(np.float32)
    return x, w, g


def _jax_grads(x, w, g, block_rows, dtype):
    def loss(xx, ww):
        o = jnk.rms_norm_values(xx, ww, 1e-5, block_rows=block_rows)
        return jnp.sum(o.astype(jnp.float32) * g)
    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, dtype),
                                           jnp.asarray(w, dtype))
    return (np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _port_grads(x, w, g, dtype):
    xx = torch.from_numpy(x).to(dtype).requires_grad_()
    ww = torch.from_numpy(w).to(dtype).requires_grad_()
    before = dict(launch_counts)
    o = tnk.rms_norm_values(xx, ww, 1e-5)
    (o.float() * torch.from_numpy(g)).sum().backward()
    assert launch_counts == before      # plain version and autograd
    assert xx.grad.dtype == dtype and ww.grad.dtype == dtype
    return xx.grad.float().numpy(), ww.grad.float().numpy()


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{n}x{h}_br{b}" for n, h, b in CASES])
def test_f32_grads_match_jax(case):
    n, h, br = case
    x, w, g = _inputs(n, h, n + h)
    jdx, jdw = _jax_grads(x, w, g, br, jnp.float32)
    tdx, tdw = _port_grads(x, w, g, torch.float32)
    np.testing.assert_allclose(tdx, jdx, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tdw, jdw, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", CASES[:3],
                         ids=[f"{n}x{h}_br{b}" for n, h, b in CASES[:3]])
def test_bf16_grads_within_one_ulp_of_jax(case):
    n, h, br = case
    x, w, g = _inputs(n, h, 2 * n + h)
    jdx, jdw = _jax_grads(x, w, g, br, jnp.bfloat16)
    tdx, tdw = _port_grads(x, w, g, torch.bfloat16)
    np.testing.assert_allclose(tdx, jdx, rtol=2 ** -7, atol=1e-3)
    np.testing.assert_allclose(tdw, jdw, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(jdw).max())


def test_no_grad_path_builds_no_graph():
    x, w, _ = _inputs(8, 32, 0)
    xx = torch.from_numpy(x).requires_grad_()
    with torch.no_grad():
        out = tnk.rms_norm_values(xx, torch.from_numpy(w))
    assert out.grad_fn is None
