"""The port's grouped matmul (`paddle_tpu_torch.ops.grouped_matmul`)
against the JAX package's, on the CPU, with inputs from numpy seeds.

- `gmm_plain` against `gmm_pallas(..., interpret=True)` on groups that
  are multiples of the Pallas block (the kernel's precondition), as
  tests/test_moe.py runs it;
- against `_gmm_xla` (`jax.lax.ragged_dot`) on ragged groups: empty
  groups, groups smaller than a tile, rows past the last group (zeros),
  and a sum of sizes larger than M;
- the transposed read (``trans=True``) against the plain product with
  ``swapaxes(rhs, 1, 2)``;
- the gradients of `grouped_matmul_values` against `jax.vjp` of the
  JAX `grouped_matmul_values` (d(lhs) through the transposed read,
  d(rhs) through one matmul per group).

Tolerances: f32 atol 1e-5 plus rtol 1e-5 (sums of up to 96 products in
another order); bf16 one bf16 rounding of the same f32 sums (rtol 2^-7,
atol 2^-7 of the largest |output|: both round an f32 accumulator once)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import grouped_matmul as jgm
from paddle_tpu_torch.ops import grouped_matmul as tgm
from paddle_tpu_torch.ops import kernel_errors, launch_counts

F32 = dict(rtol=1e-5, atol=1e-5)


def _inputs(m, k, n, e, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((e, k, n)).astype(np.float32))


@pytest.mark.parametrize("gs", [[16, 0, 8, 8], [8, 8, 8, 8], [32, 0, 0, 0]],
                         ids=["empty_group", "even", "one_group"])
def test_plain_matches_interpret_pallas_kernel(gs):
    lhs, rhs = _inputs(32, 16, 16, 4, seed=len(gs) + gs[0])
    want = jgm.gmm_pallas(jnp.asarray(lhs), jnp.asarray(rhs),
                          jnp.asarray(gs, jnp.int32), block_m=8, block_n=8,
                          block_k=8, interpret=True)
    got = tgm.gmm_plain(torch.from_numpy(lhs), torch.from_numpy(rhs),
                        torch.tensor(gs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# (M, group sizes): empty groups, groups under a tile, rows past the end,
# a sum past M (the last group cut at M)
RAGGED = [(40, [5, 0, 13, 1, 0, 21]), (37, [0, 0, 3, 0, 0, 0]),
          (64, [9, 17, 2, 0, 30, 6]), (20, [12, 0, 15, 0, 0, 4])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RAGGED, ids=[f"m{m}_{i}" for i, (m, _) in
                                              enumerate(RAGGED)])
def test_plain_matches_ragged_dot(case, dtype):
    m, gs = case
    lhs, rhs = _inputs(m, 24, 40, len(gs), seed=m)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    clipped = np.minimum(np.cumsum(gs), m)
    sizes = np.diff(np.concatenate([[0], clipped]))
    want = np.asarray(jgm._gmm_xla(jnp.asarray(lhs, jdt),
                                   jnp.asarray(rhs, jdt),
                                   jnp.asarray(sizes, jnp.int32))
                      .astype(jnp.float32))
    lt = torch.from_numpy(lhs).to(dtype)
    rt = torch.from_numpy(rhs).to(dtype)
    got = tgm.gmm_plain(lt, rt, torch.tensor(gs))
    assert got.dtype == dtype and got.shape == (m, 40)
    assert not got[int(clipped[-1]):].any()       # rows past the end
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, **F32)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())
    before = dict(launch_counts)
    again = tgm.grouped_matmul_values(lt, rt, torch.tensor(gs))
    assert launch_counts == before                # the CPU runs no kernel
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_transposed_read_is_the_swapped_product():
    lhs, rhs = _inputs(40, 24, 32, 6, seed=3)
    gs = torch.tensor([5, 0, 13, 1, 0, 21])
    dout = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (40, 32)).astype(np.float32))
    rt = torch.from_numpy(rhs)
    got = tgm.gmm_plain(dout, rt, gs, trans=True)
    want = tgm.gmm_plain(dout, rt.transpose(1, 2).contiguous(), gs)
    # the same products; BLAS sums a transposed view in another order
    torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("case", RAGGED[:3], ids=["m40", "m37", "m64"])
def test_grads_match_jax_vjp(case):
    m, gs = case
    lhs, rhs = _inputs(m, 24, 40, len(gs), seed=10 + m)
    g = np.random.default_rng(m).standard_normal((m, 40)).astype(np.float32)
    sizes = jnp.asarray(gs, jnp.int32)
    out, pull = jax.vjp(
        lambda a, b: jgm.grouped_matmul_values(a, b, sizes, False),
        jnp.asarray(lhs), jnp.asarray(rhs))
    jdl, jdr = pull(jnp.asarray(g))
    lt = torch.from_numpy(lhs).requires_grad_()
    rt = torch.from_numpy(rhs).requires_grad_()
    o = tgm.grouped_matmul_values(lt, rt, torch.tensor(gs))
    o.backward(torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), **F32)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jdl), **F32)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(jdr), **F32)
    # an empty group's matrix gets a zero gradient
    for e, s in enumerate(gs):
        if s == 0:
            assert not rt.grad[e].any()


def test_kernel_errors_catch_a_wrong_row():
    """The scale-free reading the card check uses: zero for equal
    outputs, about 1 for a row computed with another group's matrix."""
    lhs, rhs = _inputs(40, 24, 32, 2, seed=5)
    gs = torch.tensor([20, 20])
    a = tgm.gmm_plain(torch.from_numpy(lhs), torch.from_numpy(rhs), gs)
    assert kernel_errors(a, a) == (0.0, 0.0)
    b = a.clone()
    b[20] = torch.from_numpy(lhs[20] @ rhs[0])
    rel, row = kernel_errors(b, a)
    assert row > 0.5 and rel > 0.1
    assert rel > tgm.GMM_LIMITS[torch.float32]["rel"]


def test_kernel_route_refuses_cpu_tensors():
    lhs, rhs = _inputs(8, 8, 8, 2, seed=6)
    with pytest.raises(ValueError, match="CUDA"):
        tgm.grouped_matmul_values(torch.from_numpy(lhs),
                                  torch.from_numpy(rhs), torch.tensor([4, 4]),
                                  use_kernel=True)
