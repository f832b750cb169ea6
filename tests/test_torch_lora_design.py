"""The LoRA epilogue's SGMV design on the CPU: what `csrc/lora_epilogue.cu`
(`lora_sgmv_kernel`) does, mirrored in Python where no card is needed.

- `lora_design`'s routing by dtype and rank;
- the tile plan (ranks up to 16): a cluster a 64-token tile, its distinct
  live ids in
  order of first appearance, one shrink pass per (id, 16-row group that
  holds it): every live token is computed once, under its own id, row-0
  (and out-of-range) tokens never; interleaved, segmented, single-token,
  all-base and ragged batches;
- the splits: K into 256 slices of a fixed multiple of 16 (covering K
  once, set by K alone, whichever block takes them), N into column groups
  x the cluster's blocks (covering N
  once at decode and admission batch sizes);
- an emulation of the kernel's per-token sum order in float32 (the
  shrink's k steps in order inside a warp's slice, the 16 warps' partials
  added in warp order, the 16 blocks' in block order, then the expand's
  sum over the rank in order, times the scale): a token's delta is
  bitwise the same alone, in a batch of 8, in a batch of 300 at another
  position and under zero rank padding;
- every case against `lora_epilogue_ref` and, through NumPy inputs,
  against the JAX package's `_lora_epilogue_xla` and its kernel in
  interpret mode (`lora_epilogue_values(use_kernel=True)`): f32 sums in
  another order, rtol 1e-5 plus atol 1e-5 of the largest |delta|.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.lora_epilogue import _lora_epilogue_xla
from paddle_tpu.ops.lora_epilogue import lora_epilogue_values as jax_lora
from paddle_tpu_torch.ops import lora_epilogue as le

TILE, CLUSTER, WARPS, COLS, SMS = 64, 16, 16, 128, 132


@pytest.mark.parametrize("dtype,rank,want", [
    (torch.bfloat16, 16, "sgmv"), (torch.float16, 1, "sgmv"),
    (torch.bfloat16, 64, "sgmv"), (torch.bfloat16, 65, "bgmv"),
    (torch.float16, 256, "bgmv"), (torch.float32, 16, "bgmv"),
    (torch.float32, 1, "bgmv")])
def test_lora_design_routing(dtype, rank, want):
    assert le.lora_design(dtype, rank) == want


def tile_plan(ids, stacks):
    """The kernel's plan: per tile (t0, rows, tids, distinct live ids),
    and the shrink passes (tile, id, 16-row group) with the rows each
    pass keeps."""
    ids = np.asarray(ids)
    tiles, passes = [], []
    for t0 in range(0, len(ids), TILE):
        rows = min(TILE, len(ids) - t0)
        tids = [int(i) if 0 < i < stacks else 0 for i in ids[t0:t0 + rows]]
        tids += [0] * (TILE - rows)
        firsts = [r for r in range(TILE)
                  if tids[r] != 0 and tids[r] not in tids[:r]]
        order = [tids[r] for r in firsts]
        tiles.append((t0, rows, tids, order))
        for id_ in order:
            for mt in range(-(-rows // 16)):
                kept = [r for r in range(16 * mt, min(16 * mt + 16, rows))
                        if tids[r] == id_]
                if kept:
                    passes.append((t0, id_, mt, kept))
    return tiles, passes


def _ids(kind, t, stacks=4, rng=None):
    if kind == "interleaved":           # the smoke's admission case
        return (np.arange(t) * 3) % stacks
    if kind == "segmented":             # one adapter a sequence
        lens = [t // 5, t // 3, 1, t // 4]
        lens.append(t - sum(lens))
        return np.concatenate([np.full(n, i % stacks)
                               for i, n in enumerate(lens)])
    if kind == "random":
        return rng.integers(-1, stacks + 1, t)
    return np.zeros(t, np.int64)        # all base


@pytest.mark.parametrize("kind", ["interleaved", "segmented", "random",
                                  "base"])
@pytest.mark.parametrize("t", [1, 8, 63, 64, 65, 300, 6432])
def test_every_live_token_is_computed_once(kind, t):
    ids = _ids(kind, t, rng=np.random.default_rng(t))
    _, passes = tile_plan(ids, 4)
    seen = np.zeros(t, np.int64)
    for t0, id_, _, kept in passes:
        for r in kept:
            assert ids[t0 + r] == id_
            seen[t0 + r] += 1
    live = (ids > 0) & (ids < 4)
    assert (seen[live] == 1).all() and (seen[~live] == 0).all()


def test_segmented_tiles_hold_one_adapter_mostly():
    """Admission packs a sequence's rows together: a tile reads an
    adapter's A and B once for all its rows of that adapter."""
    ids = _ids("segmented", 6432)
    tiles, _ = tile_plan(ids, 4)
    per_tile = [len(order) for _, _, _, order in tiles]
    assert max(per_tile) <= 3 and sum(per_tile) <= len(tiles) + 5
    tiles, _ = tile_plan(_ids("interleaved", 6432), 4)
    assert all(order == [3, 2, 1] for _, _, _, order in tiles)


def k_slices(k):
    kq = 16 * -(-k // (16 * CLUSTER * WARPS))
    return kq, [(s * kq, min(k, s * kq + kq)) for s in range(CLUSTER * WARPS)]


@pytest.mark.parametrize("k", [1, 16, 32, 70, 1000, 1024, 4096, 14336])
def test_k_slices_cover_k_once(k):
    kq, sl = k_slices(k)
    assert kq % 16 == 0
    cover = np.zeros(k, np.int64)
    for lo, hi in sl:
        cover[lo:max(lo, hi)] += 1
    assert (cover == 1).all()


def column_blocks(t, n):
    """The launch: clusters of 16 blocks for one tile, of 8 (two parts of
    K a block) for more; column groups; an even column count a block."""
    tiles = -(-t // TILE)
    cs = CLUSTER if tiles == 1 else CLUSTER // 2
    by_cols = -(-n // (cs * COLS))
    by_sms = -(-SMS // (cs * tiles))
    groups = max(1, min(by_cols, by_sms))
    ncols = 2 * -(-n // (2 * cs * groups))   # even: pairs
    return groups, ncols, [(bx * ncols, min(n, bx * ncols + ncols))
                           for bx in range(cs * groups)]


@pytest.mark.parametrize("t,n", [(8, 14336), (8, 4096), (8, 1024),
                                 (6432, 14336), (1170, 4096), (1, 33),
                                 (300, 130)])
def test_columns_cover_n_once(t, n):
    groups, ncols, spans = column_blocks(t, n)
    cover = np.zeros(n, np.int64)
    for lo, hi in spans:
        cover[lo:max(lo, hi)] += 1
    assert (cover == 1).all()
    if t == 8 and n == 14336:     # decode gate/up: 7 groups, 112 blocks
        assert (groups, ncols) == (7, 128)
    if t == 6432:                 # admission: one group
        assert groups == 1


def sgmv_emulate(x, a, b, scale, ids):
    """The kernel's arithmetic in float32, in its order: per pass, each of
    the 256 k slices summed k step by k step (a step's 16 products as one
    float32 sum, standing in for the tensor core's), the warps' partials
    added in warp order, the blocks' in block order; then per output the
    sum over the rank in order, times the scale, rounded to x's dtype."""
    x = np.asarray(x, np.float32)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    t, k = x.shape
    stacks, _, r = a.shape
    kq, slices = k_slices(k)
    _, passes = tile_plan(ids, stacks)
    d = np.zeros((t, b.shape[2]), np.float32)
    for t0, id_, _, kept in passes:
        for row in kept:
            xr = x[t0 + row]
            parts = []
            for lo, hi in slices:
                acc = np.zeros(r, np.float32)
                for k0 in range(lo, hi, 16):
                    k1 = min(hi, k0 + 16)
                    acc = acc + (xr[k0:k1, None] * a[id_, k0:k1]).sum(
                        0, dtype=np.float32)
                parts.append(acc)
            blocks = []
            for q in range(CLUSTER):
                s = parts[q * WARPS]
                for w in range(1, WARPS):
                    s = s + parts[q * WARPS + w]
                blocks.append(s)
            h = blocks[0]
            for q in range(1, CLUSTER):
                h = h + blocks[q]
            acc = np.zeros(b.shape[2], np.float32)
            for j in range(r):
                acc = acc + h[j] * b[id_, j]
            d[t0 + row] = acc * np.float32(scale[id_])
    return d


def _operands(t, k, n, r, seed, stacks=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, k)).astype(np.float32)
    a = (rng.standard_normal((stacks, k, r)) / np.sqrt(k)).astype(np.float32)
    b = (0.5 * rng.standard_normal((stacks, r, n))).astype(np.float32)
    a[0] = 0
    b[0] = 0
    scale = np.linspace(0, 1.5, stacks).astype(np.float32)
    return x, a, b, scale


@pytest.mark.parametrize("kind", ["interleaved", "segmented", "random"])
def test_emulated_delta_is_batch_and_padding_invariant(kind):
    t, k, n, r = 300, 1040, 40, 4
    x, a, b, scale = _operands(t, k, n, r, 5)
    ids = _ids(kind, t, rng=np.random.default_rng(6))
    full = sgmv_emulate(x, a, b, scale, ids)
    assert (full[(ids <= 0) | (ids >= 4)] == 0).all()
    eight = sgmv_emulate(x[:8], a, b, scale, ids[:8])
    assert np.array_equal(eight, full[:8])
    for i in (0, 5, 70, 299):
        alone = sgmv_emulate(x[i:i + 1], a, b, scale, ids[i:i + 1])
        assert np.array_equal(alone, full[i:i + 1])
        # the same token at another position of another batch
        perm = np.roll(np.arange(t), 37)
        moved = sgmv_emulate(x[perm], a, b, scale, ids[perm])
        assert np.array_equal(moved[list(perm).index(i)], full[i])
    pad_a = np.concatenate([a, np.zeros_like(a)], 2)
    pad_b = np.concatenate([b, np.zeros_like(b)], 1)
    assert np.array_equal(sgmv_emulate(x, pad_a, pad_b, scale, ids), full)


@pytest.mark.parametrize("kind", ["interleaved", "segmented", "single"])
@pytest.mark.parametrize("t,k,n,r", [(70, 128, 256, 8), (9, 256, 128, 16),
                                     (1, 384, 128, 8)])
def test_emulation_matches_plain_and_jax(kind, t, k, n, r):
    x, a, b, scale = _operands(t, k, n, r, t + k)
    ids = np.full(t, 2) if kind == "single" else _ids(kind, t)
    ids = ids.astype(np.int32)
    got = sgmv_emulate(x, a, b, scale, ids)
    ref = le.lora_epilogue_ref(torch.from_numpy(x), torch.from_numpy(a),
                               torch.from_numpy(b), torch.from_numpy(scale),
                               torch.from_numpy(ids)).numpy()
    jx = [jnp.asarray(v) for v in (x, a, b, scale, ids)]
    xla = np.asarray(_lora_epilogue_xla(*jx))
    pallas = np.asarray(jax_lora(*jx, use_kernel=True))
    top = np.abs(ref).max()
    for want in (ref, xla, pallas):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * top)
