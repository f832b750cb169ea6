"""The dequant matmul's designs on the CPU: what `csrc/dequant_matmul.cu`
computes, mirrored in Python where no card is needed.

- `dequant_design`'s routing over dtype x M x K x N;
- the bit tricks that widen int8 and e4m3 weights (``widen4``), mirrored
  word for word (the same byte permutations, f32 / f16 arithmetic in
  NumPy) on every one of the 256 codes in every byte position, into bf16
  and into f16: bitwise equal to a plain conversion (e4m3's two NaN codes
  excepted: quantization never stores them);
- the wgmma design's tile walk: the block order covers every (channel
  tile, token tile) once; the register A fragments a lane assembles from a
  stage's raw weight tile under TMA's 64-byte swizzle hold exactly the
  m64k16 fragment's k indices; the other way's widened tile under the
  128-byte swizzle holds each row's k in wgmma's K-major order; the
  epilogue's transposed tile writes every output once, edges masked, at
  odd M, K and N;
- the plain version against the JAX package's `_dequant_matmul_xla` on
  f16 x (f32 sums of exact products in another order: rtol 1e-3 of f16's
  rounding, atol 1e-3 of the largest |output|).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.quant_matmul import _dequant_matmul_xla
from paddle_tpu_torch.ops import quant_matmul as qm

BF, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("dtype,m,k,n,want", [
    (BF, 1, 4096, 14336, "decode"), (BF, 8, 4096, 14336, "decode"),
    (F16, 8, 14336, 4096, "decode"), (BF, 8, 4100, 130, "cuda_cores"),
    (F16, 3, 70, 33, "cuda_cores"), (BF, 9, 4096, 14336, "wgmma"),
    (BF, 6432, 4096, 14336, "wgmma"), (F16, 6432, 4096, 14336, "wgmma"),
    (F16, 300, 14336, 4096, "wgmma"), (BF, 1170, 4096, 130, "wgmma"),
    (BF, 300, 4100, 130, "mma.sync"), (F16, 70, 33, 70, "mma.sync"),
    (F32, 6432, 4096, 14336, "cuda_cores"), (F32, 8, 4096, 14336,
                                             "cuda_cores")])
def test_dequant_design_routing(dtype, m, k, n, want):
    assert qm.dequant_design(dtype, m, k, n) == want


def test_dequant_design_tensor_cores_past_decode():
    """bf16 and f16 take tensor cores at every M above the decode rows,
    whatever K and N; f32 never does (no TF32, as the reference)."""
    for dtype in (BF, F16):
        for m in (9, 16, 17, 255, 256, 257, 6432):
            for k in (16, 33, 4096, 4100, 14336):
                for n in (1, 130, 14336):
                    assert qm.dequant_design(dtype, m, k, n) in (
                        "wgmma", "mma.sync")
    assert qm.dequant_design(F32, 6432, 4096, 14336) == "cuda_cores"


# -- widen4, mirrored ---------------------------------------------------------

def byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the eight bytes of (y << 32) | x."""
    both = (int(y) << 32) | int(x)
    return sum(((both >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _f32(bits):
    return np.array([bits], np.uint32).view(np.float32)[0]


def _bits32(f):
    return int(np.array([f], np.float32).view(np.uint32)[0])


def _f16(bits):
    return np.array([bits], np.uint16).view(np.float16)[0]


def _bits16(h):
    return int(np.array([h], np.float16).view(np.uint16)[0])


def _half2(word, op, other):
    lo = op(_f16(word & 0xFFFF), other)
    hi = op(_f16(word >> 16), other)
    return _bits16(np.float16(lo)) | (_bits16(np.float16(hi)) << 16)


def widen4(q, xt, wt):
    """The kernel's widen4 on one 32-bit word of weight bytes: (lo, hi),
    each two 16-bit values of xt, the first in the low half."""
    if xt == "bf16":
        f = []
        for b in range(4):
            if wt == "int8":
                v = q ^ 0x80808080
                f.append(np.float32(_f32(byte_perm(v, 0x4B000000,
                                                   0x7440 + b)))
                         - np.float32(8388736.0))
            else:
                t = byte_perm(q, 0, 0x0444 | (b << 12))
                f.append(np.float32(_f32((t & 0x80000000)
                                         | ((t >> 4) & 0x07F00000)))
                         * np.float32(2.0 ** 120))
        return (byte_perm(_bits32(f[0]), _bits32(f[1]), 0x7632),
                byte_perm(_bits32(f[2]), _bits32(f[3]), 0x7632))
    if wt == "int8":
        v = q ^ 0x80808080
        sub = lambda a, b: np.float16(a) - np.float16(b)
        return (_half2(byte_perm(v, 0x64646464, 0x4140), sub, 1152.0),
                _half2(byte_perm(v, 0x64646464, 0x4342), sub, 1152.0))
    mul = lambda a, b: np.float16(a) * np.float16(b)
    out = []
    for sel in (0x1404, 0x3424):
        w = byte_perm(q, 0, sel)
        t = ((w >> 1) & 0x3F803F80) | (w & 0x80008000)
        out.append(_half2(t, mul, 256.0))
    return tuple(out)


def _plain16(code, xt, wt):
    """The 16 bits of weight byte ``code`` converted plainly."""
    raw = torch.tensor([code], dtype=torch.uint8)
    v = raw.view(torch.int8) if wt == "int8" else \
        raw.view(torch.float8_e4m3fn)
    out = v.float().to(torch.bfloat16 if xt == "bf16" else torch.float16)
    return int(out.view(torch.int16).item()) & 0xFFFF


@pytest.mark.parametrize("xt", ["bf16", "f16"])
@pytest.mark.parametrize("wt", ["int8", "e4m3"])
def test_widen4_equals_plain_conversion_on_every_code(xt, wt):
    nan = {0x7F, 0xFF} if wt == "e4m3" else set()
    codes = [c for c in range(256) if c not in nan]
    rng = np.random.default_rng(1)
    for pos in range(4):
        for c in codes:
            others = rng.choice(codes, 4)
            q = 0
            for i in range(4):
                q |= int(c if i == pos else others[i]) << (8 * i)
            lo, hi = widen4(q, xt, wt)
            got = [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16]
            want = [_plain16((q >> (8 * i)) & 0xFF, xt, wt)
                    for i in range(4)]
            assert got == want, (hex(q), xt, wt)


# -- the wgmma design's tile walk, mirrored -----------------------------------
QBM, QBN, QBK, GROUP, PITCH = 128, 256, 64, 16, 2 * 128 + 16


def block_tiles(m, n):
    """The kernel's block order: (n0, m0) of every block, in launch
    order (groups of GROUP channel tiles, their token tiles after each
    other, the channel tiles fastest)."""
    nwt, ntt = -(-n // QBM), -(-m // QBN)
    out = []
    for b in range(nwt * ntt):
        span = GROUP * ntt
        grp, idx = divmod(b, span)
        gw = min(GROUP, nwt - grp * GROUP)
        out.append(((grp * GROUP + idx % gw) * QBM, (idx // gw) * QBN))
    return out


@pytest.mark.parametrize("m,n", [(6432, 14336), (1170, 14336), (9, 136),
                                 (257, 4096), (300, 1000), (6432, 128256)])
def test_block_order_covers_every_tile_once(m, n):
    tiles = block_tiles(m, n)
    want = {(i * QBM, j * QBN) for i in range(-(-n // QBM))
            for j in range(-(-m // QBN))}
    assert len(tiles) == len(want) and set(tiles) == want


def w_chunk(row, kk):
    return row * 64 + ((kk ^ ((row >> 1) & 3)) << 4)


def _swizzle64(tile):
    """A stage's raw weight tile (128 rows x 64 bytes) as TMA's 64-byte
    swizzle lays it: 16-byte chunk c of row r at r*64 + (c ^ (r/2 % 4))*16
    (address bits 4-5 XOR bits 7-8)."""
    smem = np.zeros(QBM * 64, np.uint8)
    for r in range(QBM):
        for c in range(4):
            smem[w_chunk(r, c):w_chunk(r, c) + 16] = tile[r, 16 * c:16 * c + 16]
    return smem


def test_register_a_fragments_hold_the_m64k16_layout():
    """Every lane of both consumer warpgroups reads words t/2 and 2 + t/2
    of its rows' chunks and keeps one half of each: the four bytes are
    k (2t, 2t + 1, 2t + 8, 2t + 9) of k step kk, the order of the
    fragment's (a0 | a2) and (a1 | a3) pairs."""
    rng = np.random.default_rng(2)
    tile = rng.integers(0, 256, (QBM, 64), dtype=np.uint8)
    smem = _swizzle64(tile)
    word = lambda p: int(smem[p:p + 4].view(np.uint32)[0])
    for wg in range(2):
        for warp in range(4):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                sel = 0x7632 if t & 1 else 0x5410
                for h in range(2):
                    row = 64 * wg + 16 * warp + g + 8 * h
                    for kk in range(4):
                        p = w_chunk(row, kk) + 4 * (t >> 1)
                        q = byte_perm(word(p), word(p + 8), sel)
                        got = [(q >> (8 * i)) & 0xFF for i in range(4)]
                        ks = [16 * kk + 2 * t + d for d in (0, 1, 8, 9)]
                        assert got == [int(tile[row, k]) for k in ks]


def test_widened_tile_is_kmajor_under_the_128_byte_swizzle():
    """The other way's widening: lane pair (row, half) writes 16-bit
    chunks 2c and 2c + 1 of its row at (chunk ^ row % 8) * 16, which is
    where TMA's 128-byte swizzle (and so wgmma's K-major descriptor)
    keeps k 8 chunk.. of that row."""
    rng = np.random.default_rng(3)
    tile = rng.integers(0, 256, (QBM, 64), dtype=np.uint8)
    smem = _swizzle64(tile)
    for wg in range(2):
        wide = np.zeros(64 * 64, np.int32)     # 16-bit slots
        for tid in range(128):
            rl, half = tid >> 1, tid & 1
            row = 64 * wg + rl
            for j in range(2):
                c = 2 * half + j
                raw = smem[w_chunk(row, c):w_chunk(row, c) + 16]
                for part in range(2):
                    slot = rl * 64 + (((2 * c + part) ^ (rl & 7)) * 8)
                    wide[slot:slot + 8] = raw[8 * part:8 * part + 8]
        for rl in range(64):
            for k in range(64):
                chunk, pos = divmod(k, 8)
                slot = rl * 64 + ((chunk ^ (rl & 7)) * 8) + pos
                assert wide[slot] == tile[64 * wg + rl, k]


@pytest.mark.parametrize("m,n", [(300, 136), (37, 1000), (256, 130),
                                 (9, 7)])
def test_epilogue_writes_every_output_once(m, n):
    """The accumulator layout (element i of a lane: channel g + 8 ((i >>
    1) & 1) of its warp's 16, token 8 (i >> 2) + 2t + (i & 1)) through
    the transposed tile and the 16-byte stores gives y[token][channel]
    for every output of every block once, nothing past M or N."""
    y = np.full((m, n), -1.0)
    writes = np.zeros((m, n), np.int32)
    for n0, m0 in block_tiles(m, n):
        truth = np.arange(QBM * QBN, dtype=np.float64).reshape(QBM, QBN) \
            + 1e6 * (n0 * 7 + m0)
        tile = np.zeros(QBN * PITCH // 2)
        for wg in range(2):
            for warp in range(4):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    nl = 64 * wg + 16 * warp + g
                    for i in range(QBN // 2):
                        ch = 16 * warp + 64 * wg + g + 8 * ((i >> 1) & 1)
                        tok = 8 * (i >> 2) + 2 * t + (i & 1)
                        acc = truth[ch, tok]
                        c, e, hh = i >> 2, i & 1, (i >> 1) & 1
                        assert tok == 8 * c + 2 * t + e
                        tile[tok * (PITCH // 2) + nl + 8 * hh] = acc
        for i in range(QBN * (QBM // 8)):
            tok, ch = divmod(i, QBM // 8)
            mm, nn = m0 + tok, n0 + 8 * ch
            if mm >= m or nn >= n:
                continue
            for j in range(8):
                if nn + j < n:
                    y[mm, nn + j] = tile[tok * (PITCH // 2) + 8 * ch + j]
                    writes[mm, nn + j] += 1
                    assert y[mm, nn + j] == truth[8 * ch + j, tok]
    assert (writes == 1).all()


def test_k_walk_zero_fills_past_k():
    """The ring walks ceil(K / 64) stages; TMA's zero fill past K on
    both operands makes the last stage's extra products zeros: a plain
    sum over the padded stages equals the sum over K."""
    rng = np.random.default_rng(4)
    for k in (16, 48, 80, 4096 + 16):
        x = rng.standard_normal(k).astype(np.float32)
        w = rng.integers(-127, 128, k).astype(np.float32)
        nk = -(-k // QBK)
        xp = np.zeros(nk * QBK, np.float32)
        wp = np.zeros(nk * QBK, np.float32)
        xp[:k], wp[:k] = x, w
        assert np.float64(xp @ wp) == pytest.approx(np.float64(x @ w),
                                                    rel=1e-6)


# -- the plain version against JAX on f16 x ------------------------------------

@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n", [(9, 64, 128), (40, 160, 136)])
def test_plain_f16_matches_jax(mode, m, k, n):
    rng = np.random.default_rng(m + k + n)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)
                         * 0.05)
    qw, sc = qm.quantize_weight_values(w, mode)
    x = rng.standard_normal((m, k)).astype(np.float16)
    got = qm.dequant_matmul_values(torch.from_numpy(x), qw, sc).float()
    jw = jnp.asarray(qw.float().numpy().T).astype(
        jnp.int8 if mode == "int8" else jnp.float8_e4m3fn)
    want = np.asarray(_dequant_matmul_xla(jnp.asarray(x), jw,
                                          jnp.asarray(sc.numpy())),
                      np.float32)
    top = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                               atol=1e-3 * top)
