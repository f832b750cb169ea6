"""LayerNorm of the port (`paddle_tpu_torch.ops.norm_kernels.
layer_norm_values`, `nn.functional.layer_norm`) against the JAX
package's, on the CPU: JAX runs `layer_norm_values` through the `_ln`
custom VJP, whose forward and backward are the Pallas `_ln_fwd_kernel` /
`_ln_bwd_kernel` in interpret mode (row counts that divide the block,
several blocks of ``block_rows=128`` included, dw and db accumulating
across them), or through its XLA branch and XLA autodiff (ragged row
counts). The port's CPU path is its plain version under torch autograd;
the CUDA kernels are held against that on the card in
tests/test_torch_cuda_kernels.py and chip_smoke.py.

Tolerances: f32 outputs and dx atol 1e-5 plus rtol 1e-5, dw and db
atol/rtol 1e-4 (sums over up to 512 rows in another order); bf16 one
bf16 ulp (rtol 2^-7, atol 2^-7 of the largest magnitude: both sides
compute in f32 and round once)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import norm_kernels as jnk
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.layers import LayerNorm
from paddle_tpu_torch.ops import kernel_errors, launch_counts
from paddle_tpu_torch.ops import norm_kernels as tnk

# (rows, h, block_rows): one block, four blocks of 128, ragged rows (the
# XLA branch)
CASES = [(256, 128, 256), (512, 64, 128), (300, 96, 256), (6, 32, 256)]
EPS = 1e-5


def _inputs(n, h, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, h)) * 3 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    b = (0.1 * rng.standard_normal(h)).astype(np.float32)
    g = (rng.standard_normal((n, h)) + 0.3).astype(np.float32)
    return x, w, b, g


def _jax(x, w, b, g, block_rows, dtype):
    args = [jnp.asarray(a, dtype) for a in (x, w, b)]
    out = jnk.layer_norm_values(*args, EPS, block_rows=block_rows)

    def loss(xx, ww, bb):
        o = jnk.layer_norm_values(xx, ww, bb, EPS, block_rows=block_rows)
        return jnp.sum(o.astype(jnp.float32) * g)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(a.astype(jnp.float32)) for a in (out, *grads)]


def _port(x, w, b, g, dtype):
    xx, ww, bb = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (x, w, b))
    before = dict(launch_counts)
    o = tnk.layer_norm_values(xx, ww, bb, EPS)
    (o.float() * torch.from_numpy(g)).sum().backward()
    assert launch_counts == before      # plain version and autograd
    assert o.dtype == dtype and xx.grad.dtype == dtype
    assert ww.grad.dtype == dtype and bb.grad.dtype == dtype
    return [a.detach().float().numpy() for a in
            (o, xx.grad, ww.grad, bb.grad)]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{n}x{h}_br{b}" for n, h, b in CASES])
def test_f32_forward_and_grads_match_jax(case):
    n, h, br = case
    x, w, b, g = _inputs(n, h, seed=n + h)
    jo, jdx, jdw, jdb = _jax(x, w, b, g, br, jnp.float32)
    to, tdx, tdw, tdb = _port(x, w, b, g, torch.float32)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tdx, jdx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tdw, jdw, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tdb, jdb, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", CASES[:2] + CASES[3:],
                         ids=["256x128", "512x64_br128", "ragged6"])
def test_bf16_forward_and_grads_match_jax(case):
    n, h, br = case
    x, w, b, g = _inputs(n, h, seed=7 * n + h)
    # bf16-exact inputs on both sides
    x, w, b = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
               for a in (x, w, b))
    want = _jax(x, w, b, g, br, jnp.bfloat16)
    got = _port(x, w, b, g, torch.bfloat16)
    for name, a, r in zip(("out", "dx", "dw", "db"), got, want):
        np.testing.assert_allclose(a, r, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(r).max(),
                                   err_msg=name)


def test_functional_and_layer_route_to_it():
    """`F.layer_norm` over one axis is `layer_norm_values`, a missing
    weight or bias being ones or zeros (several axes raise: not ported);
    the `LayerNorm` layer starts at ones and zeros."""
    x, w, b, _ = _inputs(12, 16, seed=1)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    torch.testing.assert_close(TF.layer_norm(xt, 16, wt, bt, EPS),
                               tnk.layer_norm_ref(xt, wt, bt, EPS),
                               rtol=0, atol=0)
    ones, zeros = torch.ones(16), torch.zeros(16)
    torch.testing.assert_close(TF.layer_norm(xt, [16], None, bt, EPS),
                               tnk.layer_norm_ref(xt, ones, bt, EPS),
                               rtol=0, atol=0)
    torch.testing.assert_close(TF.layer_norm(xt, [16], wt, None, EPS),
                               tnk.layer_norm_ref(xt, wt, zeros, EPS),
                               rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TF.layer_norm(xt.reshape(3, 4, 16), [4, 16], wt, bt)
    layer = LayerNorm(16, EPS, device="cpu")
    assert layer.weight.eq(1).all() and not layer.bias.any()
    want = jax.nn.standardize(jnp.asarray(x), axis=-1, epsilon=EPS)
    np.testing.assert_allclose(layer(xt).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_kernel_errors_catch_the_missing_mean_term():
    """The card check's reading: a backward without the mean(w·g) term
    gives a dx error near 1/sqrt(H) of dx, far above the limits."""
    n, h = 64, 256
    x, w, b, g = _inputs(n, h, seed=2)
    xt, wt, gt = map(torch.from_numpy, (x, w, g))
    xf = xt.float()
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mu).square().mean(-1, keepdim=True) + EPS)
    xhat, wg = (xf - mu) * rstd, gt * wt
    m1 = wg.mean(-1, keepdim=True)
    m2 = (wg * xhat).mean(-1, keepdim=True)
    dx = rstd * (wg - m1 - xhat * m2)
    tdx = _port(x, w, b, g, torch.float32)[1]
    assert kernel_errors(torch.from_numpy(tdx), dx)[0] < 1e-5
    rel, row = kernel_errors(rstd * (wg - xhat * m2), dx)
    assert rel > 20 * tnk.LN_LIMITS[torch.bfloat16]["rel"] and row > rel


def test_kernel_route_refuses_cpu_tensors():
    x, w, b, _ = _inputs(4, 8, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        tnk.layer_norm_values(*map(torch.from_numpy, (x, w, b)),
                              use_kernel=True)
