"""The grouped matmul's designs and work list in the PyTorch port
(`paddle_tpu_torch.ops.grouped_matmul`), on the CPU.

- `gmm_design` sends bf16 and f16 with K and N multiples of 8 to the
  wgmma kernel (TMA wants 16-byte strides), the other bf16 / f16 shapes
  to the mma.sync kernel and f32 to the CUDA-core kernel; the private
  ``_design`` of `_gmm_cuda` refuses an input its design cannot take
  before any launch (and before the device check, so it shows here).
- `plan_work`, a Python mirror of `gmm_plan_kernel`'s work list, covers
  every row of [0, M) exactly once, in tiles of 128 rows, for random,
  skewed and empty-group sizes and sums above and below M; tiles that
  straddle a group boundary appear once for each group. The card tests
  hold both kernels' outputs against `gmm_plain`, which the last test
  holds against the JAX package's `_gmm_xla` (`jax.lax.ragged_dot`).

Tolerances: f32 atol 1e-5 plus rtol 1e-5 (sums of up to 136 products in
another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import grouped_matmul as jgm
from paddle_tpu_torch.ops import grouped_matmul as tgm
from paddle_tpu_torch.ops import launch_counts


# the work list's group field for the rows past the last group, and for
# the unused slots at its end (kZeros / kUnused in csrc/grouped_matmul.cu)
ZEROS, UNUSED = -1, -2


def plan_work(group_sizes, m: int, tile_m: int = 128) -> list:
    """A mirror of the work list that `gmm_plan_kernel`
    (csrc/grouped_matmul.cu) builds on the device, as (m tile, group,
    first row, end row) items: every (tile, group) pair that shares rows
    (an empty group has none), the rows past the last group as group
    ZEROS, and UNUSED slots up to ceil(m / tile_m) + E items. The groups'
    row ranges partition [0, m) (sizes cut at m, negative sizes empty),
    so every row lies in exactly one item."""
    sizes = [int(v) for v in torch.as_tensor(group_sizes).tolist()]
    wmax = -(-m // tile_m) + len(sizes)
    work, start = [], 0
    for e in range(len(sizes) + 1):
        end = m
        if e < len(sizes):
            s = sizes[e]
            end = start if s <= 0 else (m if s >= m - start else start + s)
        t = start // tile_m
        while start < end and t * tile_m < end and len(work) < wmax:
            work.append((t, e if e < len(sizes) else ZEROS,
                         max(start, t * tile_m), min(end, (t + 1) * tile_m)))
            t += 1
        start = end
    return work + [(0, UNUSED, 0, 0)] * (wmax - len(work))


@pytest.mark.parametrize("k,n", [(3584, 2560), (2560, 3584), (8, 8),
                                 (64, 136), (100, 36), (96, 100),
                                 (101, 64), (7, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_gmm_design_routing(dtype, k, n):
    if dtype == torch.float32:
        want = "cuda_cores"
    else:
        want = "wgmma" if k % 8 == 0 and n % 8 == 0 else "mma.sync"
    assert tgm.gmm_design(dtype, k, n) == want


@pytest.mark.parametrize("design,dtype,k,n", [
    ("wgmma", torch.bfloat16, 100, 64),
    ("wgmma", torch.float16, 64, 36),
    ("wgmma", torch.float32, 64, 64),
    ("mma.sync", torch.float32, 64, 64),
    ("cuda_cores", torch.bfloat16, 64, 64)])
def test_design_refusals_before_launch(design, dtype, k, n):
    lhs = torch.zeros(16, k, dtype=dtype)
    rhs = torch.zeros(2, k, n, dtype=dtype)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match=f"the {design} grouped matmul "
                       "does not take"):
        tgm._gmm_cuda(lhs, rhs, torch.tensor([8, 8]), False, design)
    with pytest.raises(ValueError, match="no grouped matmul design"):
        tgm._gmm_cuda(lhs, rhs, torch.tensor([8, 8]), False, "tiled")
    assert launch_counts == before


def _covers(work, m, e, tile=128):
    wmax = -(-m // tile) + e
    assert len(work) == wmax
    live = [w for w in work if w[1] != UNUSED]
    # the unused slots only at the end
    assert work[len(live):] == [(0, UNUSED, 0, 0)] * (wmax - len(live))
    seen = np.zeros(m, dtype=int)
    for t, g, r0, r1 in live:
        assert r0 < r1, "an item with no rows"
        assert t * tile <= r0 and r1 <= (t + 1) * tile
        seen[r0:r1] += 1
    assert (seen == 1).all()
    return live


def _owner(sizes, m):
    """group of each row (ZEROS past the last group)"""
    own = np.full(m, ZEROS)
    start = 0
    for e, s in enumerate(sizes):
        end = min(m, start + max(s, 0))
        own[start:end] = e
        start = end
    return own


def _skewed(m, e):
    sizes = [0] * e
    sizes[0] = m // 2 + 37
    for j in range(3, e, 4):
        sizes[j] = (m - sizes[0]) // 16
    sizes[3] += m - sum(sizes)
    return sizes


@pytest.mark.parametrize("seed", range(6))
def test_plan_work_covers_every_row_once_random(seed):
    rng = np.random.default_rng(seed)
    e = int(rng.integers(1, 70))
    sizes = rng.integers(0, 300, e)
    sizes[rng.random(e) < 0.3] = 0           # empty groups
    m = int(sizes.sum() + rng.integers(-200, 300))
    m = max(m, 1)
    work = plan_work(torch.tensor(sizes), m)
    live = _covers(work, m, e)
    own = _owner(sizes.tolist(), m)
    for t, g, r0, r1 in live:
        assert (own[r0:r1] == g).all()
    # groups in order, tiles in order
    assert [w[:2] for w in live] == sorted(
        [w[:2] for w in live], key=lambda x: (x[1] if x[1] >= 0 else e,
                                              x[0]))


def test_plan_work_straddles_and_skew():
    sizes = [130, 0, 7, 300, 1, 0, 250, 200]
    work = plan_work(sizes, 1000)
    live = _covers(work, 1000, len(sizes))
    tiles = [w[0] for w in live]
    # tile 1 holds rows of groups 0, 2 and 3: three items, none for the
    # empty group 1
    assert [w[1] for w in live if w[0] == 1] == [0, 2, 3]
    assert len(set(tiles)) < len(tiles)
    # the rows past the last group (888 of them): zeros, from inside
    # tile 6 on
    assert live[-2:] == [(6, ZEROS, 888, 896), (7, ZEROS, 896, 1000)]
    # the A14B skew: half the rows to one expert, 47 experts empty
    m = 32768
    sk = _skewed(m, 64)
    live = _covers(plan_work(sk, m), m, 64)
    assert {w[1] for w in live} == {e for e, s in enumerate(sk) if s}
    assert len(live) <= m // 128 + 16


@pytest.mark.parametrize("m,sizes", [(500, [200, 250, 100]),
                                     (1, [1, 0]), (128, [128, 0, 0]),
                                     (300, [0, 0, 0]), (256, [-5, 256])])
def test_plan_work_edges(m, sizes):
    live = _covers(plan_work(sizes, m), m, len(sizes))
    own = _owner(sizes, m)
    for t, g, r0, r1 in live:
        assert (own[r0:r1] == g).all()


# (M, K, N, group sizes): tiles that straddle, empty groups, rows past
# the end, K and N on and off the multiples of 8
RAGGED = [(300, 64, 136, [130, 0, 7, 100, 1, 0]),
          (150, 40, 24, [0, 149, 0]),
          (97, 36, 20, [5, 3, 0, 17, 1, 60]),
          (64, 16, 16, [64])]


@pytest.mark.parametrize("case", RAGGED, ids=[f"m{c[0]}" for c in RAGGED])
@pytest.mark.parametrize("trans", [False, True], ids=["kn", "nk"])
def test_plain_matches_ragged_dot(case, trans):
    m, k, n, sizes = case
    rng = np.random.default_rng(m + k + n)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    want = np.asarray(jgm._gmm_xla(jnp.asarray(lhs), jnp.asarray(rhs),
                                   jnp.asarray(sizes, jnp.int32)))
    arg = np.ascontiguousarray(np.swapaxes(rhs, 1, 2)) if trans else rhs
    before = dict(launch_counts)
    got = tgm.gmm(torch.from_numpy(lhs), torch.from_numpy(arg),
                  torch.tensor(sizes), trans)
    assert launch_counts == before
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
