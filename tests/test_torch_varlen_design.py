"""The packed (varlen) attention's two designs and the segment tile plan
that the sm90 design walks, on the CPU (no card, no JAX):

- `varlen_design` sends bf16 and f16 at head dims 64 and 128 to the
  wgmma / TMA kernels ("sm90", `csrc/flash_varlen_sm90.cu`) and every
  other input to the mma.sync kernels;
- `varlen_tile_plan` (the plain version of the device plan) against
  brute force over every packing the card tests and `chip_smoke.py` use:
  documents with a padding tail, q the suffix of k's packing (Sq < Sk),
  Sq > Sk, one-token segments, random non-monotone ids, a padding tail
  past a tile, one segment, unsorted runs, all padding, negative ids
  other than -1; causal and not. The tile ranges, the uniform and sorted
  flags, the blocks' walks and their launch order are exact; no live pair
  lies in a tile the plan skips; under sorted ids each q tile's visited
  key tiles are exactly the meeting ones and one range;
- a mirror of the plan kernel's two binary searches (sorted ids) gives
  the plain plan's walks, and `unpack_plan` reads back a plan written in
  the device layout;
- a mirror of the three kernels' walks over the plan (forward: stages of
  two key tiles, each warpgroup skipping a stage its own tile does not
  meet; dQ: stages of one key tile; dK/dV: the q tiles of each head)
  computes every live pair exactly once.

The kernels themselves run only on the card (tests/test_torch_cuda_kernels
.py); their plain versions stay held to the JAX kernels in interpret mode
by tests/test_torch_flash_varlen.py. Every check here is exact (integer
ranges and masks), so no tolerance is stated.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_varlen as fv

T = fv.PLAN_TILE


def _docs(rng, b, s, lo, hi, tail):
    seg = np.full((b, s), -1, np.int32)
    for i in range(b):
        p, n = 0, 0
        while p < s - tail:
            ln = int(rng.integers(lo, hi + 1))
            seg[i, p:min(p + ln, s - tail)] = n
            p += ln
            n += 1
    return seg


def _packing(name):
    """(seg_q, seg_k) int32 tensors of one named packing."""
    rng = np.random.default_rng(len(name))
    if name == "docs":
        sq = sk = _docs(rng, 2, 1000, 30, 300, 37)
    elif name == "suffix":           # q the last Sq positions: Sq < Sk
        sk = _docs(rng, 1, 900, 40, 200, 13)
        sq = np.ascontiguousarray(sk[:, 600:])
    elif name == "q_longer":         # Sq > Sk
        sq, sk = _docs(rng, 1, 400, 20, 150, 5), _docs(rng, 1, 130, 20, 150,
                                                        5)
    elif name == "singles":          # one-token segments among two-token
        sq = np.repeat(np.arange(300), 2)[None, :500].astype(np.int32)
        sq[:, :40] = np.arange(40)
        sq[:, 40:] += 20
        sk = sq
    elif name == "random":           # ids in [-1, 3], not monotone
        sq = sk = rng.integers(-1, 4, (2, 333)).astype(np.int32)
    elif name == "tail":             # a padding tail past a whole tile
        sq = np.zeros((1, 260), np.int32)
        sq[:, 100:] = -1
        sk = sq
    elif name == "one":
        sq, sk = np.zeros((1, 200), np.int32), np.zeros((1, 2048), np.int32)
    elif name == "runs_unsorted":
        sq = sk = np.repeat(rng.permutation(10), 30)[None].astype(np.int32)
    elif name == "all_padding":
        sq = sk = np.full((1, 70), -1, np.int32)
    else:                            # "negative_ids": padding as -5
        ids = np.repeat(np.arange(10), 30)[None]
        sq = sk = np.where(rng.random((1, 300)) < 0.1, -5, ids).astype(
            np.int32)
    return torch.from_numpy(sq), torch.from_numpy(np.ascontiguousarray(sk))


PACKINGS = ["docs", "suffix", "q_longer", "singles", "random", "tail", "one",
            "runs_unsorted", "all_padding", "negative_ids"]


@pytest.fixture(params=[(p, c) for p in PACKINGS for c in (False, True)],
                ids=[f"{p}-{'causal' if c else 'full'}" for p in PACKINGS
                     for c in (False, True)])
def case(request):
    name, causal = request.param
    sq, sk = _packing(name)
    return sq, sk, causal, fv.varlen_tile_plan(sq, sk, causal)


def _tiles(seg):
    """Brute force, tile by tile: (lo, hi, uniform) lists per batch row."""
    out = []
    for row in seg.tolist():
        n = -(-len(row) // T)
        tiles = []
        for t in range(n):
            ids = row[t * T:(t + 1) * T]
            ids += [-1] * (T - len(ids))
            good = [x for x in ids if x >= 0]
            lo, hi = (min(good), max(good)) if good else (fv.EMPTY_LO, -1)
            tiles.append((lo, hi, len(good) == T and lo == hi))
        out.append(tiles)
    return out


def _sorted(row):
    """Non-decreasing over a prefix, negative ids only as its tail."""
    pad = [x < 0 for x in row]
    first_pad = pad.index(True) if True in pad else len(row)
    head = row[:first_pad]
    return all(pad[first_pad:]) and all(a <= b for a, b in
                                         zip(head, head[1:]))


def _live_tiles(seg_q, seg_k, causal):
    """(B, nqt, nkt) bool: the tile pair holds a live pair."""
    live = fv._live(seg_q, seg_k, causal)[:, 0]
    b, sq, sk = live.shape
    nqt, nkt = -(-sq // T), -(-sk // T)
    pad = torch.zeros(b, nqt * T, nkt * T, dtype=torch.bool)
    pad[:, :sq, :sk] = live
    return pad.reshape(b, nqt, T, nkt, T).any(4).any(2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("d", [16, 32, 64, 72, 96, 128, 256])
def test_varlen_design_routes(dtype, d):
    want = "sm90" if dtype in (torch.bfloat16, torch.float16) and \
        d in (64, 128) else "mma.sync"
    assert fv.varlen_design(dtype, d) == want


def test_plan_tiles_and_flags(case):
    sq, sk, causal, plan = case
    for side, seg in (("q", sq), ("k", sk)):
        tiles = _tiles(seg)
        assert plan[f"{side}_lo"].tolist() == [[t[0] for t in r]
                                               for r in tiles]
        assert plan[f"{side}_hi"].tolist() == [[t[1] for t in r]
                                               for r in tiles]
        assert plan[f"{side}_uniform"].tolist() == [[t[2] for t in r]
                                                    for r in tiles]
    assert plan["sorted"].tolist() == [[_sorted(a), _sorted(b)] for a, b in
                                       zip(sq.tolist(), sk.tolist())]
    for side, j in (("q", 0), ("k", 1)):
        hi = plan[f"{side}_hi"]
        want = [max([t + 1 for t, x in enumerate(r) if x >= 0], default=0)
                for r in hi.tolist()]
        assert plan["nonempty"][:, j].tolist() == want


def test_plan_skips_no_live_pair(case):
    sq, sk, causal, plan = case
    live = _live_tiles(sq, sk, causal)
    assert not (live & ~plan["visit"]).any()
    # every visited pair's ranges meet and it lies in the band
    qlo, qhi = plan["q_lo"][:, :, None], plan["q_hi"][:, :, None]
    klo, khi = plan["k_lo"][:, None, :], plan["k_hi"][:, None, :]
    meets = (qlo <= khi) & (klo <= qhi)
    assert not (plan["visit"] & ~meets).any()


def test_plan_sorted_visits_one_range(case):
    sq, sk, causal, plan = case
    qlo, qhi = plan["q_lo"][:, :, None], plan["q_hi"][:, :, None]
    klo, khi = plan["k_lo"][:, None, :], plan["k_hi"][:, None, :]
    meets = (qlo <= khi) & (klo <= qhi)
    for b in range(sq.shape[0]):
        if not plan["sorted"][b, 1]:
            continue
        for row in plan["visit"][b].tolist():
            on = [i for i, x in enumerate(row) if x]
            if on:
                assert on == list(range(on[0], on[-1] + 1))
        # the visited tiles are exactly the meeting ones in the band: a key
        # tile whose first key some row of the q tile may see (causal,
        # end-aligned)
        nqt, nkt = meets[b].shape
        band = torch.ones(nqt, nkt, dtype=torch.bool)
        if causal:
            s_q, s_k = sq.shape[1], sk.shape[1]
            for t in range(nqt):
                last_row = min(t * T + T, s_q) - 1
                band[t] = torch.arange(nkt) * T <= last_row + s_k - s_q
        assert torch.equal(plan["visit"][b], meets[b] & band)


def test_plan_block_walks(case):
    """A block of two tiles walks [first, last]: every live pair of its
    rows (keys) lies in a tile of that range whose ids meet the block's;
    under sorted ids every tile of the range meets and the count is its
    length; the launch orders rank the blocks by count."""
    sq, sk, causal, plan = case
    live = _live_tiles(sq, sk, causal)
    for side, other, lt in (("q", "k", live), ("k", "q",
                                               live.transpose(1, 2))):
        walk, count = plan[f"{side}_walk"], plan[f"{side}_count"]
        b, nb = count.shape
        for bi in range(b):
            srt = bool(plan["sorted"][bi, 1 if side == "q" else 0])
            for blk in range(nb):
                first, last = walk[bi, blk].tolist()
                own = slice(2 * blk, 2 * blk + 2)
                blo = int(plan[f"{side}_lo"][bi, own].min())
                bhi = int(plan[f"{side}_hi"][bi, own].max())
                olo = plan[f"{other}_lo"][bi].tolist()
                ohi = plan[f"{other}_hi"][bi].tolist()
                met = [olo[t] <= bhi and blo <= ohi[t]
                       for t in range(len(olo))]
                used = [t for t in range(first, last + 1) if met[t]]
                assert len(used) == count[bi, blk]
                need = lt[bi, own].any(0).nonzero().flatten().tolist()
                assert set(need) <= set(used)
                if srt:
                    assert len(used) == last - first + 1
        order = plan[f"{side}_order"].tolist()
        flat = count.flatten().tolist()
        assert sorted(order) == list(range(len(flat)))
        keys = [(-flat[i], i) for i in order]
        assert keys == sorted(keys)


def _searched(plan, side, b, blo, bhi, tmin, tmax):
    """The plan kernel's walk under sorted ids (`block_walk`): two binary
    searches over the other side's non-empty tiles."""
    lo = plan[f"{side}_lo"][b].tolist()
    hi = plan[f"{side}_hi"][b].tolist()
    ne = int(plan["nonempty"][b, 0 if side == "q" else 1])
    a, z = 0, ne
    while a < z:
        m = (a + z) // 2
        a, z = (a, m) if hi[m] >= blo else (m + 1, z)
    f = max(a, tmin)
    a, z = 0, ne
    while a < z:
        m = (a + z) // 2
        a, z = (a, m) if lo[m] > bhi else (m + 1, z)
    last = min(a - 1, tmax)
    return (f, last, last - f + 1) if f <= last else (0, -1, 0)


def test_plan_binary_searches_match_walks(case):
    sq, sk, causal, plan = case
    off = sk.shape[1] - sq.shape[1]
    nqt, nkt = plan["q_lo"].shape[1], plan["k_lo"].shape[1]
    for side, other in (("q", "k"), ("k", "q")):
        count = plan[f"{side}_count"]
        for b in range(count.shape[0]):
            if not plan["sorted"][b, 1 if side == "q" else 0]:
                continue
            for blk in range(count.shape[1]):
                own = slice(2 * blk, 2 * blk + 2)
                blo = int(plan[f"{side}_lo"][b, own].min())
                bhi = int(plan[f"{side}_hi"][b, own].max())
                if side == "q":
                    tmin, tmax = 0, nkt - 1
                    if causal:
                        kmax = min(blk * 2 * T + 2 * T, sq.shape[1]) - 1 + off
                        tmax = -1 if kmax < 0 else min(tmax, kmax // T)
                else:
                    tmin, tmax = 0, nqt - 1
                    if causal:
                        tmin = max(0, blk * 2 * T - off) // T
                got = (0, -1, 0) if bhi < 0 or tmin > tmax else _searched(
                    plan, other, b, blo, bhi, tmin, tmax)
                want = (*plan[f"{side}_walk"][b, blk].tolist(),
                        int(count[b, blk]))
                assert got == want


def test_unpack_plan_reads_the_device_layout(case):
    sq, sk, causal, plan = case
    b, s_q, s_k = sq.shape[0], sq.shape[1], sk.shape[1]
    lay = fv._plan_layout(b, s_q, s_k)
    words = torch.full((lay["words"],), -7, dtype=torch.int32)

    def put(name, x):
        x = x.to(torch.int32).flatten()
        words[lay[name]:lay[name] + x.numel()] = x
    put("qt", torch.stack([plan["q_lo"], plan["q_hi"]], -1))
    put("kt", torch.stack([plan["k_lo"], plan["k_hi"]], -1))
    put("qb", plan["q_walk"])
    put("kb", plan["k_walk"])
    put("qu", plan["q_uniform"])
    put("ku", plan["k_uniform"])
    put("qn", plan["q_count"])
    put("kn", plan["k_count"])
    put("qo", plan["q_order"])
    put("ko", plan["k_order"])
    put("sorted", plan["sorted"])
    put("ne", plan["nonempty"])
    assert not (words == -7).any()
    got = fv.unpack_plan(words, b, s_q, s_k)
    assert set(got) == set(plan) - {"visit"}
    for k, x in got.items():
        assert torch.equal(x.to(torch.int64), plan[k].to(torch.int64)), k


def _computed_pairs(plan, sq, sk, causal):
    """(q row, key) pairs each kernel computes, by a mirror of its walk
    over the plan: a count per pair (B, Sq, Sk) for the forward, dQ and
    dK/dV. A warpgroup (64 rows or keys) computes a stage's pairs unless
    its own tile misses the stage's ids or its band; the kernels' masks
    then keep the live ones."""
    live = fv._live(sq, sk, causal)[:, 0]
    b, s_q, s_k = live.shape
    off = s_k - s_q
    qlo, qhi = plan["q_lo"].tolist(), plan["q_hi"].tolist()
    klo, khi = plan["k_lo"].tolist(), plan["k_hi"].tolist()
    nqt, nkt = len(qlo[0]), len(klo[0])

    def meet(alo, ahi, blo, bhi):
        return alo <= bhi and blo <= ahi

    fwd = torch.zeros(b, s_q, s_k, dtype=torch.int32)
    dq, dkv = fwd.clone(), fwd.clone()
    for bi in range(b):
        for qb, (first, last) in enumerate(plan["q_walk"][bi].tolist()):
            blo = min(qlo[bi][2 * qb:2 * qb + 2])
            bhi = max(qhi[bi][2 * qb:2 * qb + 2])
            wanted = [first <= t <= last and meet(klo[bi][t], khi[bi][t],
                                                  blo, bhi)
                      for t in range(nkt)]
            for wg in range(2):
                my = 2 * qb + wg
                if my >= nqt:
                    continue
                r0, r1 = my * T, min(my * T + T, s_q)
                whi = min(r1 - 1 + off, s_k - 1) if causal else s_k - 1
                hit = [meet(klo[bi][t], khi[bi][t], qlo[bi][my],
                            qhi[bi][my]) for t in range(nkt)]
                # forward: stages of two key tiles
                for p in range(first // 2, last // 2 + 1 if last >= first
                               else first // 2):
                    tiles = [t for t in (2 * p, 2 * p + 1) if t < nkt]
                    if not any(wanted[t] for t in tiles):
                        continue
                    k0 = 2 * p * T
                    if k0 <= whi and any(hit[t] for t in tiles):
                        fwd[bi, r0:r1, k0:min(k0 + 2 * T, s_k)] += 1
                # dQ: stages of one key tile
                for t in range(first, last + 1):
                    if wanted[t] and t * T <= whi and hit[t]:
                        dq[bi, r0:r1, t * T:min(t * T + T, s_k)] += 1
        for kb, (first, last) in enumerate(plan["k_walk"][bi].tolist()):
            blo = min(klo[bi][2 * kb:2 * kb + 2])
            bhi = max(khi[bi][2 * kb:2 * kb + 2])
            for wg in range(2):
                my = 2 * kb + wg
                if my >= nkt:
                    continue
                j0, j1 = my * T, min(my * T + T, s_k)
                wlo = max(0, j0 - off) if causal else 0
                for t in range(first, last + 1):
                    if not meet(qlo[bi][t], qhi[bi][t], blo, bhi):
                        continue
                    if t * T + T - 1 >= wlo and meet(
                            qlo[bi][t], qhi[bi][t], klo[bi][my],
                            khi[bi][my]):
                        dkv[bi, t * T:min(t * T + T, s_q), j0:j1] += 1
    return live, fwd, dq, dkv


def test_kernel_walks_compute_every_live_pair_once(case):
    sq, sk, causal, plan = case
    live, fwd, dq, dkv = _computed_pairs(plan, sq, sk, causal)
    for got in (fwd, dq, dkv):
        assert (got[live] == 1).all()
        assert got.max() <= 1
