"""The port's CUDA kernels on the card, each against its plain PyTorch
version (which tests/test_torch_norm.py and
tests/test_torch_ragged_attention.py hold against the JAX package on the
CPU). This file imports no JAX, so it runs where the card is (without
tests/conftest.py, which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Every test here is marked `requires_cuda` and skips without a card.
Tolerances: f32 atol 1e-5 plus rtol 1e-5 (sums of up to 4096 terms in
another order: a 2048-key row measured 1.4e-5 off at |o| = 1.14, H100);
bf16 RMSNorm one bf16 ulp;
bf16 attention 2e-2 (the kernel keeps softmax weights in f32, the plain
version rounds them to bf16 before the weighted sum, as the JAX core
does); int8-KV attention the same (both keep f32 weights there, so the
bf16 outputs differ by the final rounding);
dequant matmul (`_kernel_tol`): f32 rtol 1e-5 plus atol 1e-5 of the
largest |output| (f32 sums of up to 14336 exact products in another
order), bf16 rtol 2^-7 plus atol 2^-8 of the largest |output| (one bf16
rounding of sums that differ only in order: the widened weights and
their products with bf16 x are exact in f32), f16 the same 8x tighter,
rtol 2^-10 plus atol 2^-11 (f16 keeps 3 more significant bits), which
an output rounded through bf16 breaks;
the dequant matmul's designs (`qm.dequant_design`: decode, wgmma,
mma.sync) each at those limits at admission, long-K, K-off-the-k-step
and odd shapes, bf16 and f16, bitwise on repeat; HGMMA in every wgmma
instance's SASS; a design refusing an input raises before any launch;
LoRA epilogue (both designs, `le.lora_design`: SGMV, BGMV): the same two
tolerances as the dequant matmul (f32 sums over K and over the rank in
another order, then one rounding to x's dtype), and BITWISE where the
kernel promises it: a token's delta alone equals its delta in any batch
(decode 8, admission 6432, at any position), row-0 tokens give exact
zeros, zero rank columns change nothing;
paged attention: as ragged attention (f32 1e-5, bf16 2e-2);
RMSNorm backward: dx as the forward (f32 1e-5, bf16 one ulp), dw f32
rtol/atol 1e-4 (a sum over up to 6432 rows in another order), bf16 one
ulp plus 1e-3 of the largest |dw|; bitwise equal across runs;
flash attention: f32 1e-4 (the same f32 math in another order, exp of
the same logits), bf16 2e-2 of max(1, largest |reference|) for o, dq,
dk and dv (both round P, and dS for dq, to bf16 but at other places:
the kernel at each tile's running max, the plain version at the row
max), lse 1e-4 in both; rows with no live key exact zeros; dK/dV
bitwise equal across runs (no atomics);
grouped matmul: `gmm.GMM_LIMITS` on the scale-free `kernel_errors` (bf16:
one rounding of f32 sums that differ only in order, the bf16 products
being exact in f32; f32 sums in another order), rows past the last
group exact zeros, and f32 also elementwise rtol/atol 1e-5 of the
largest |output|; its gradients as the outputs they are (d(lhs) through
the kernel's transposed read, d(rhs) one matmul per group); the wgmma
design beside the mma.sync one (K off the 64-wide k step too), bitwise
across runs, and K or N off 8 on the mma.sync route;
LayerNorm: `nk.LN_LIMITS` on `kernel_errors` for y, dx, dw and db (both
sides in f32, one rounding), dw and db bitwise equal across runs;
the norm forwards' two designs (`nk.norm_design`: the row in registers,
a block a row) each at those limits and bitwise on repeat, their
statistics within 2^-18 of each other (f32 sums of the same terms in
another order: a few dozen roundings), the backward kernels fed either
design's statistics within their limits of autograd, and a planted fault
(rstd without eps on rows where eps matters; the mean left out) outside
them; every register-row class the C entries build, at its widest and
narrowest row; rows off 16 bytes take the strided design;
the norm backwards' two designs (`nk.norm_bwd_design`: the register-row
backward, a block per 16 rows) at the main paths' shapes and at rows 1,
300 and 3001, every register-row class, at those limits and bitwise on
repeat, rows off 16 bytes on the rowblock route, and partial rows of
exactly 48 KB of shared memory on both routes;
two ragged decode attentions racing on two streams, bitwise equal to the
same calls one after the other (the split tickets are per stream);
the tiny engine's program cache (CUDA graphs) bitwise equal to the eager
engine at k = 1 and k = 4, full width, int8, LoRA and legacy, and on the
dense layout, the legacy prefix cache and the legacy chunked prefill,
with equal launch counts, and rebuilt after `install_weights`;
the tiny `generate()` (greedy with and without processors, beam search)
on the card against the CPU: equal ids, scores within 1e-4 (flash
attention's f32 limit), exact flash and RMSNorm launches; seeded
sampling one stream a seed, with no synchronizing call, and top_k = 1
greedy;
the dense flash backward's wgmma kernels at the 8B slice, the bench
shape and the A14B shape against the plain backward;
the tiny MoE (dropless through the grouped-matmul kernel) and tiny BERT
(LayerNorm kernels) train steps as the tiny Llama's: losses within
1e-4, parameters within 1e-4 of their norm;
float16 through every kernel above at bf16's limits (f16 rounds at the
same places with 3 more significant bits), the dequant matmul and the
LoRA epilogue at f16's own;
flash attention at every tile width's head dims, 8 to 256 (72 and 136
zero-padded to 80 and 160), at `fa.KERNEL_LIMITS`; bf16/f16 head dims
that are not multiples of 8 (100, 36) through the kernels at those
limits, head dims past 256 through `attention_xla` (counted), float64
raises; the two backward designs (wgmma for bf16/f16 at D 64 and 128,
mma.sync) each against the plain version and against each other at
`fa.KERNEL_LIMITS`, bitwise equal across runs, and an input the wgmma
entries refuse raising; the two forward designs likewise (lse within
1e-3), and the wgmma forward with
the wgmma backward through autograd;
varlen flash attention: as flash attention (`fa.KERNEL_LIMITS`, f32
also elementwise 1e-4), padding rows exact zeros with zero dQ and
padding keys zero dK/dV, dK/dV bitwise equal across runs, one segment
without padding equal to the dense kernels of the same design bitwise,
head dims past 256 through `varlen_xla` (counted); both designs
(`fv.varlen_design`: sm90 for bf16/f16 at D 64 and 128, mma.sync) on
every case there, the device plan equal to `fv.varlen_tile_plan`, the
sm90 design bitwise across runs and block orders, and inputs a design
refuses raising before any launch;
rope: bitwise equal to its plain version in every dtype (the kernel
rounds each product and the sum once, as the plain version's separate
ops do), forward and backward; both designs (`rp.rope_design`: rope_vec
for heads of whole 16-byte vectors on 16 bytes, q and k in one launch;
the pair design for the rest, a view off 16 bytes too) bitwise, the
fused op one launch each way under autograd, and no ptxas spills;
checkpoints: a group of card tensors through the pinned staging buffers
(digests equal the CPU copies', read back bitwise) and a tiny bf16 run
resumed by `ElasticManager` bitwise equal to an uninterrupted one."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import grouped_matmul as gmm
from paddle_tpu_torch.ops import flash_varlen as fv
from paddle_tpu_torch.ops import kernel_errors, launch_counts
from paddle_tpu_torch.ops import rope as rp
from paddle_tpu_torch.ops import lora_epilogue as le
from paddle_tpu_torch.ops import norm_kernels as nk
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import quant_matmul as qm
from paddle_tpu_torch.ops import ragged_paged_attention as ra

pytestmark = pytest.mark.requires_cuda

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 8, 300, 6432])
@pytest.mark.parametrize("h", [64, 4096, 4100])
def test_rms_norm_kernel_matches_plain(cuda, rows, h, dtype):
    g = torch.Generator(device=cuda).manual_seed(rows + h)
    x = (3 * torch.randn(rows, h, device=cuda, generator=g)).to(dtype)
    w = (1 + 0.1 * torch.randn(h, device=cuda, generator=g)).to(dtype)
    before = launch_counts["rms_norm"]
    out = nk.rms_norm_values(x, w, 1e-5)
    assert launch_counts["rms_norm"] == before + 1
    ref = nk.rms_norm_ref(x, w, 1e-5)
    tol = dict(rtol=2 ** -7, atol=1e-3) if dtype != torch.float32 \
        else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    _, rstd = nk._rms_fwd(x, w, 1e-5)
    want = torch.rsqrt(x.float().square().mean(-1) + 1e-5)
    torch.testing.assert_close(rstd, want, rtol=1e-5, atol=0)


def _case(rng, hk, g, ql, cl, block_q, tail_pad, d=128, ps=16,
          trash_rows=()):
    """A ragged batch with per-sequence (query_len, context_len) and
    shuffled pages; sequences in `trash_rows` keep an all-zero block
    table (an inactive decode slot reading the trash page)."""
    ql = np.asarray(ql, np.int32)
    cl = np.asarray(cl, np.int32)
    qs, total = ra.pack_ragged_starts(ql, block_q)
    t = total + tail_pad
    need = [0 if s in trash_rows else -(-int(c) // ps)
            for s, c in enumerate(cl)]
    pps = max(max(need), -(-int(cl.max()) // ps), 1)
    n_pages = sum(need) + 1
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((len(ql), pps), np.int32)
    k = 0
    for s, n in enumerate(need):
        bt[s, :n] = perm[k:k + n]
        k += n
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return (f(t, hk * g, d), f(hk, n_pages, ps, d), f(hk, n_pages, ps, d),
            qs, ql, cl, bt)


ATTN_CASES = [
    # (name, hk, g, query lens, context lens, block_q, tail, window, trash)
    ("decode_g4", 8, 4, [1] * 8, [1, 17, 300, 517, 1024, 1500, 2000, 2048],
     1, 0, None, ()),
    ("decode_inactive", 8, 4, [1] * 4, [5, 900, 33, 2048], 1, 0, None,
     (1, 3)),
    ("mixed_g4", 8, 4, [600, 300, 1, 0, 37], [600, 1100, 900, 0, 37], 8,
     16, None, ()),
    ("mixed_window", 8, 4, [600, 300, 1, 37], [600, 1100, 900, 37], 8, 8,
     256, ()),
    ("decode_window", 8, 4, [1] * 3, [5, 400, 1300], 1, 0, 100, ()),
    ("g1", 4, 1, [9, 1, 16], [9, 40, 50], 8, 8, None, ()),
    ("g2", 4, 2, [9, 1, 16], [9, 40, 50], 8, 0, 7, ()),
    ("g8", 2, 8, [9, 1, 16], [9, 40, 50], 8, 8, None, ()),
    ("bq1_continuation", 2, 4, [3, 1], [20, 7], 1, 2, None, ()),
    ("d64", 4, 2, [5, 1], [5, 30], 8, 0, None, ()),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_ragged_attention_kernel_matches_plain(cuda, case, dtype):
    name, hk, g, ql, cl, bq, tail, window, trash = case
    rng = np.random.default_rng(sum(map(ord, name)))
    d = 64 if name == "d64" else 128
    arrays = _case(rng, hk, g, ql, cl, bq, tail, d=d, trash_rows=trash)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    args[:3] = [a.to(dtype) for a in args[:3]]
    before = launch_counts["ragged_paged_attention"]
    out = ra.ragged_paged_attention_values(*args, window=window,
                                           block_q=bq)
    assert launch_counts["ragged_paged_attention"] == before + 1
    ref = ra.ragged_paged_attention_values(*args, window=window,
                                           block_q=bq, use_kernel=False)
    tol = dict(atol=2e-2, rtol=0) if dtype != torch.float32 \
        else dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    seq, _ = ra.token_arrays(arrays[3], arrays[4], arrays[5],
                             arrays[0].shape[0])
    assert bool((out[torch.from_numpy(seq < 0).to(cuda)] == 0).all())


def test_ragged_attention_wrapper_checks(cuda):
    rng = np.random.default_rng(0)
    arrays = _case(rng, 2, 2, [3], [3], 4, 1)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    with pytest.raises(ValueError, match="block_q"):
        ra.ragged_paged_attention_values(*args, block_q=4)
    args64 = list(args)
    args64[4] = args[4].long()
    with pytest.raises(TypeError, match="int32"):
        ra.ragged_paged_attention_values(*args64, block_q=1)


# The split design (csrc/decode_attention.cuh), every instance: q dtype x
# full-width / int8 pages x decode (block_q 1, CUDA cores) / admission
# (block_q 8: tensor cores for bf16 / f16 at these head dims, CUDA cores
# for f32) x G x D, over contexts that straddle page and split boundaries
# (the split from the card's own plan), the longest context at the block
# table's width, with and without a window.
SPLIT_PATHS = [("decode", 1, None), ("decode_window", 1, 100),
               ("admission", 8, None), ("admission_window", 8, 37)]


def _split_case(rng, path, g, d, split_keys, hk=2, ps=16, pps=40,
                tail=None):
    """A batch for `test_split_design_instances`: decode rows at
    contexts 1, a page +- 1, a split +- 1, two splits and a half, and the
    table's width; or admission pieces (prefills, continuations and a
    decode row) ending at such contexts; then ``tail`` padding rows
    (default one q block)."""
    s = split_keys
    full = pps * ps
    ctx = [1, ps - 1, ps + 1, s - 1, s, s + 1, 2 * s + s // 2, full]
    ctx = [min(max(c, 1), full) for c in ctx]
    ql = [1] * len(ctx) if path.startswith("decode") \
        else [1, ps - 1, 3, 33, s, 5, 40, 17]
    ql = [min(q, c) for q, c in zip(ql, ctx)]
    bq = 1 if path.startswith("decode") else 8
    arrays = _case(rng, hk, g, ql, ctx, bq, bq if tail is None else tail,
                   d=d, ps=ps)
    return arrays[:6] + (np.pad(arrays[6], ((0, 0), (0, pps - arrays[6]
                                                     .shape[1]))),)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 4, 8, 16])
@pytest.mark.parametrize("path", SPLIT_PATHS, ids=[p[0] for p in SPLIT_PATHS])
@pytest.mark.parametrize("kv", ["full", "int8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_design_instances(cuda, dtype, kv, path, g, d):
    """Each instance against the plain version (f32 1e-5, bf16 / f16
    2e-2), padding rows exact zeros, bitwise on repeat, one launch, and
    the split tickets left zero (where the plan splits these contexts,
    the last split block of each q block merges)."""
    label, bq, window = path
    hk, ps, pps = 2, 16, 40
    rng = np.random.default_rng(d * 100 + g * 10 + bq)
    kern = ra.split_kernel(dtype, bq, d)
    probe = ra.split_plan(1, hk, bq * g, pps, ps, kern, ra.sm_count(cuda))
    arrays = _split_case(rng, label, g, d, probe.split_pages * ps, hk, ps,
                         pps)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    kw = {}
    if kv == "int8":
        kq, vq, ks, vs = _quantized(args)
        args[1:3] = [kq, vq]
        kw = dict(k_scale=ks, v_scale=vs)
    args[0] = args[0].to(dtype)
    if kv == "full":
        args[1:3] = [a.to(dtype) for a in args[1:3]]
    t = args[0].shape[0]
    plan = ra.split_plan(t // bq, hk, bq * g, pps, ps, kern,
                         ra.sm_count(cuda))
    count = "ragged_paged_attention_int8kv" if kv == "int8" \
        else "ragged_paged_attention"
    before = dict(launch_counts)
    out = ra.ragged_paged_attention_values(*args, window=window,
                                           block_q=bq, **kw)
    assert launch_counts[count] == before[count] + 1
    torch.cuda.synchronize()
    assert bool((ra.split_tickets(cuda, 1) == 0).all())
    again = ra.ragged_paged_attention_values(*args, window=window,
                                             block_q=bq, **kw)
    assert torch.equal(out, again)
    ref = ra.ragged_paged_attention_values(*args, window=window,
                                           block_q=bq, use_kernel=False,
                                           **kw)
    tol = dict(atol=2e-2, rtol=0) if dtype != torch.float32 \
        else dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    seq, _ = ra.token_arrays(arrays[3], arrays[4], arrays[5], t)
    assert bool((out[torch.from_numpy(seq < 0).to(cuda)] == 0).all())


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 4, 8, 16])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_split_design_instances(cuda, dtype, window, g, d):
    """The q = 1 paged attention's split design at every G and D, as
    above (its contexts split too); and equal, bitwise, to the ragged
    split design at block_q 1 on the same pages (one device code)."""
    hk, ps, pps = 2, 16, 40
    rng = np.random.default_rng(d * 10 + g)
    probe = ra.split_plan(1, hk, g, pps, ps, "cuda_cores", ra.sm_count(cuda))
    arrays = _split_case(rng, "decode", g, d, probe.split_pages * ps, hk,
                         ps, pps, tail=0)
    q, kp, vp, qs, ql, cl, bt = [torch.from_numpy(a).to(cuda)
                                 for a in arrays]
    q, kp, vp = (z.to(dtype) for z in (q, kp, vp))
    plan = ra.split_plan(q.shape[0], hk, g, pps, ps, "cuda_cores",
                         ra.sm_count(cuda))
    before = dict(launch_counts)
    out = pa.paged_attention_values(q, kp, vp, cl, bt, window=window)
    assert launch_counts["paged_attention"] == before["paged_attention"] + 1
    assert plan.n_splits > 1
    torch.cuda.synchronize()
    assert bool((ra.split_tickets(cuda, 1) == 0).all())
    assert torch.equal(out, pa.paged_attention_values(q, kp, vp, cl, bt,
                                                      window=window))
    ref = pa.paged_attention_values(q, kp, vp, cl, bt, window=window,
                                    use_kernel=False)
    tol = dict(atol=2e-2, rtol=0) if dtype != torch.float32 \
        else dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    ragged = ra.ragged_paged_attention_values(q, kp, vp, qs, ql, cl, bt,
                                              window=window, block_q=1)
    assert torch.equal(out, ragged)


@pytest.mark.parametrize("dtype", DTYPES)
def test_serial_design_matches_plain(cuda, dtype):
    """The serial design (kept for timing the two in turns): ragged full
    width and int8 pages, and paged attention, against the plain
    versions and against the split design."""
    rng = np.random.default_rng(11)
    arrays = _case(rng, 8, 4, [1] * 8, [1, 17, 300, 517, 1024, 1500, 2000,
                                        2048], 1, 0)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    q, kp, vp = (z.to(dtype) for z in args[:3])
    rest = args[3:]
    tol = dict(atol=2e-2, rtol=0) if dtype != torch.float32 \
        else dict(atol=1e-5, rtol=1e-5)
    scale = 1 / 128 ** 0.5
    serial = ra._ragged_cuda(q, kp, vp, *rest, scale, None, 1,
                             _design="serial")
    ref = ra.ragged_paged_attention_ref(q, kp, vp, *rest, scale)
    torch.testing.assert_close(serial.float(), ref.float(), **tol)
    split = ra._ragged_cuda(q, kp, vp, *rest, scale, None, 1)
    torch.testing.assert_close(serial.float(), split.float(), **tol)
    kq, vq, ks, vs = _quantized(args)
    s8 = ra._ragged_cuda(q, kq, vq, *rest, scale, None, 1, ks, vs,
                         _design="serial")
    r8 = ra.ragged_paged_attention_ref(q, kq, vq, *rest, scale, None, None,
                                       ks, vs)
    torch.testing.assert_close(s8.float(), r8.float(), **tol)
    cl, bt = rest[2], rest[3]
    ps_ = pa._paged_cuda(q, kp, vp, cl, bt, scale, 256, _design="serial")
    pr = pa.paged_attention_ref(q, kp, vp, cl, bt, scale, 256)
    torch.testing.assert_close(ps_.float(), pr.float(), **tol)


def _quantized(args):
    """int8 pools and scales of a case's f32 pools, written by
    `ragged_scatter_quantized` (every row of every page)."""
    kp, vp = args[1], args[2]
    hk, p, ps, d = kp.shape
    pools = [torch.zeros_like(kp, dtype=torch.int8),
             torch.zeros_like(vp, dtype=torch.int8),
             torch.zeros(p, ps, device=kp.device),
             torch.zeros(p, ps, device=kp.device)]
    rows = lambda a: a.permute(1, 2, 0, 3).reshape(p * ps, hk, d)
    n = p * ps
    ra.ragged_scatter_quantized(
        *pools, rows(kp), rows(vp),
        torch.arange(p, dtype=torch.int32, device=kp.device)[None],
        torch.zeros(n, dtype=torch.int32, device=kp.device),
        torch.arange(n, dtype=torch.int32, device=kp.device))
    return pools


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_int8kv_attention_kernel_matches_plain(cuda, case, dtype):
    name, hk, g, ql, cl, bq, tail, window, trash = case
    rng = np.random.default_rng(sum(map(ord, name)) + 7)
    d = 64 if name == "d64" else 128
    arrays = _case(rng, hk, g, ql, cl, bq, tail, d=d, trash_rows=trash)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    kq, vq, ks, vs = _quantized(args)
    args[:3] = [args[0].to(dtype), kq, vq]
    before = dict(launch_counts)
    out = ra.ragged_paged_attention_values(*args, window=window,
                                           block_q=bq, k_scale=ks,
                                           v_scale=vs)
    assert launch_counts["ragged_paged_attention_int8kv"] \
        == before["ragged_paged_attention_int8kv"] + 1
    assert launch_counts["ragged_paged_attention"] \
        == before["ragged_paged_attention"]
    ref = ra.ragged_paged_attention_values(*args, window=window,
                                           block_q=bq, use_kernel=False,
                                           k_scale=ks, v_scale=vs)
    assert out.dtype == dtype
    tol = dict(atol=2e-2, rtol=0) if dtype != torch.float32 \
        else dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    seq, _ = ra.token_arrays(arrays[3], arrays[4], arrays[5],
                             arrays[0].shape[0])
    assert bool((out[torch.from_numpy(seq < 0).to(cuda)] == 0).all())


def test_int8kv_attention_wrapper_checks(cuda):
    rng = np.random.default_rng(1)
    arrays = _case(rng, 2, 2, [3], [3], 1, 0)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    kq, vq, ks, vs = _quantized(args)
    qargs = [args[0], kq, vq] + args[3:]
    with pytest.raises(ValueError, match="together"):
        ra.ragged_paged_attention_values(*qargs, block_q=1, k_scale=ks)
    with pytest.raises(TypeError, match="scale"):
        ra.ragged_paged_attention_values(*qargs, block_q=1)
    with pytest.raises(TypeError, match="int8"):
        ra.ragged_paged_attention_values(*args, block_q=1, k_scale=ks,
                                         v_scale=vs)
    with pytest.raises(ValueError, match="scale"):
        ra.ragged_paged_attention_values(*qargs, block_q=1,
                                         k_scale=ks[:, :2].contiguous(),
                                         v_scale=vs)
    with pytest.raises(ValueError, match="CUDA device"):
        ra.ragged_paged_attention_values(*qargs, block_q=1,
                                         k_scale=ks.cpu(), v_scale=vs)


def _kernel_tol(ref, dtype):
    """The dequant matmul's and LoRA epilogue's limits: one rounding to
    x's dtype of f32 sums that differ only in order (one ulp of x's dtype
    relative plus half an ulp of the largest |output|); f32 sums in
    another order."""
    top = ref.float().abs().max().item()
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-5 * top)
    ulp = 2 ** -7 if dtype == torch.bfloat16 else 2 ** -10
    return dict(rtol=ulp, atol=ulp / 2 * top)


DQ_SHAPES = [(4096, 1024), (256, 384), (4100, 130), (70, 33)]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 8, 300, 6432])
@pytest.mark.parametrize("kn", DQ_SHAPES, ids=[f"{k}x{n}" for k, n in
                                               DQ_SHAPES])
def test_dequant_matmul_kernel_matches_plain(cuda, kn, m, dtype, mode):
    k, n = kn
    g = torch.Generator(device=cuda).manual_seed(m * 7 + k + n)
    w = torch.randn(n, k, device=cuda, generator=g) * 0.02
    qw, sc = qm.quantize_weight_values(w, mode)
    x = torch.randn(m, k, device=cuda, generator=g).to(dtype)
    before = launch_counts["dequant_matmul"]
    out = qm.dequant_matmul_values(x, qw, sc)
    assert launch_counts["dequant_matmul"] == before + 1
    ref = qm.dequant_matmul_ref(x, qw, sc)
    assert out.dtype == dtype and out.shape == (m, n)
    torch.testing.assert_close(out.float(), ref.float(),
                               **_kernel_tol(ref, dtype))


def test_dequant_matmul_leading_dims(cuda):
    qw, sc = qm.quantize_weight_values(
        torch.randn(40, 64, device=cuda), "int8")
    x = torch.randn(2, 3, 64, device=cuda, dtype=torch.bfloat16)
    out = qm.dequant_matmul_values(x, qw, sc)
    assert out.shape == (2, 3, 40)
    torch.testing.assert_close(out.float(),
                               qm.dequant_matmul_ref(x, qw, sc).float(),
                               rtol=2 ** -7, atol=1e-2)


def test_dequant_matmul_wrapper_checks(cuda):
    qw, sc = qm.quantize_weight_values(torch.randn(16, 32, device=cuda))
    x = torch.randn(4, 32, device=cuda)
    with pytest.raises(TypeError, match="activations"):
        qm.dequant_matmul_values(x.double(), qw, sc)
    with pytest.raises(TypeError, match="weights"):
        qm.dequant_matmul_values(x, qw.float(), sc)
    with pytest.raises(TypeError, match="scale"):
        qm.dequant_matmul_values(x, qw, sc.double())
    with pytest.raises(ValueError, match="shape"):
        qm.dequant_matmul_values(x[:, :16], qw, sc)
    with pytest.raises(ValueError, match="shape"):
        qm.dequant_matmul_values(x, qw, sc[:8])
    with pytest.raises(ValueError, match="CUDA device"):
        qm.dequant_matmul_values(x, qw.cpu(), sc)


# the designs of `qm.dequant_design` at shapes each takes: admission
# gate/up, the down projection's long K, K off the 64-wide k step (a
# multiple of 16, as TMA wants), odd M and N
DQ_DESIGN_CASES = [(6432, 4096, 14336), (1170, 4096, 14336),
                   (300, 14336, 4096), (257, 4112, 130), (9, 48, 33),
                   (40, 14336, 1000)]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("design", ["wgmma", "mma.sync"])
@pytest.mark.parametrize("mkn", DQ_DESIGN_CASES,
                         ids=["m{}_k{}_n{}".format(*c) for c in
                              DQ_DESIGN_CASES])
def test_dequant_designs_match_plain(cuda, mkn, design, dtype, mode):
    """Every tensor-core design within the tolerance of the plain version,
    bitwise equal from run to run (the sum order is fixed by the
    tiling)."""
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    w = torch.randn(n, k, device=cuda, generator=g) * 0.02
    qw, sc = qm.quantize_weight_values(w, mode)
    x = torch.randn(m, k, device=cuda, generator=g).to(dtype)
    out = qm.dequant_matmul_values(x, qw, sc, _design=design)
    ref = qm.dequant_matmul_ref(x, qw, sc)
    torch.testing.assert_close(out.float(), ref.float(),
                               **_kernel_tol(ref, dtype))
    assert torch.equal(out, qm.dequant_matmul_values(x, qw, sc,
                                                     _design=design))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_dequant_decode_design_in_f16_and_bf16(cuda, dtype, mode):
    """The decode kernel at the serving decode shapes, bf16 and f16."""
    for m, k, n in ((8, 4096, 14336), (8, 14336, 4096), (3, 4096, 1024)):
        assert qm.dequant_design(dtype, m, k, n) == "decode"
        g = torch.Generator(device=cuda).manual_seed(m + k)
        qw, sc = qm.quantize_weight_values(
            torch.randn(n, k, device=cuda, generator=g) * 0.02, mode)
        x = torch.randn(m, k, device=cuda, generator=g).to(dtype)
        out = qm.dequant_matmul_values(x, qw, sc)
        ref = qm.dequant_matmul_ref(x, qw, sc)
        torch.testing.assert_close(out.float(), ref.float(),
                                   **_kernel_tol(ref, dtype))


def test_f16_limits_reject_an_output_rounded_through_bf16(cuda):
    """f16's limits are f16's own: the dequant matmul's and the LoRA
    epilogue's f16 outputs meet them, the same outputs rounded through
    bf16 do not (bf16's limits would pass both)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(300, 4096, device=cuda, generator=g).half()
    qw, sc = qm.quantize_weight_values(
        torch.randn(1024, 4096, device=cuda, generator=g) * 0.02, "int8")
    xl, a, b, scale, ids = _lora_operands(cuda, 300, 4096, 1024, 16,
                                          torch.float16)
    for out, ref in ((qm.dequant_matmul_values(x, qw, sc),
                      qm.dequant_matmul_ref(x, qw, sc)),
                     (le.lora_epilogue_values(xl, a, b, scale, ids),
                      le.lora_epilogue_ref(xl, a, b, scale, ids))):
        tol = _kernel_tol(ref, torch.float16)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
        rounded = out.to(torch.bfloat16).float()
        assert not torch.allclose(rounded, ref.float(), **tol)
        assert torch.allclose(rounded, ref.float(),
                              **_kernel_tol(ref, torch.bfloat16))


def test_dequant_design_refusals_raise_before_launch(cuda):
    qw, sc = qm.quantize_weight_values(torch.randn(64, 72, device=cuda))
    x = torch.randn(9, 72, device=cuda, dtype=torch.bfloat16)
    before = launch_counts["dequant_matmul"]
    with pytest.raises(ValueError, match="does not take"):
        qm.dequant_matmul_values(x, qw, sc, _design="wgmma")   # K % 16
    with pytest.raises(ValueError, match="does not take"):
        qm.dequant_matmul_values(x, qw, sc, _design="decode")  # M 9
    with pytest.raises(ValueError, match="does not take"):
        qm.dequant_matmul_values(x.float(), qw, sc, _design="mma.sync")
    with pytest.raises(ValueError, match="no dequant matmul design"):
        qm.dequant_matmul_values(x, qw, sc, _design="tiles")
    assert launch_counts["dequant_matmul"] == before


def test_dequant_wgmma_sass_holds_hgmma(cuda):
    """Every instance of the wgmma kernel issues HGMMA (cuobjdump -sass
    of the built library)."""
    import os
    import shutil
    import subprocess
    from paddle_tpu_torch.ops import _build
    lib = _build.build(["dequant_matmul"])["dequant_matmul"]
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    wg = {f: c for f, c in counts.items() if "dequant_wgmma_kernel" in f}
    assert len(wg) == 4 and all(wg.values()), wg


def test_tiny_engine_on_card_matches_cpu(cuda):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n) for n in (5, 20, 47, 3)]
    streams = []
    for dev in ("cuda", "cpu"):
        model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                                 seed=3).to(dev)
        eng = ContinuousBatchingEngine(model, max_batch_size=2,
                                       max_seq_len=64, prefill_chunk=16,
                                       device=dev)
        for p in prompts:
            eng.add_request(p, max_new_tokens=8)
        streams.append(eng.run())
        eng.check_invariants()
    assert streams[0] == streams[1]


def test_tiny_engine_pipelined_matches_k1(cuda):
    """harvest_every=4 on the card: the device-resident token feeds the
    next dispatch, and the streams equal the synchronous loop's."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    rng = np.random.default_rng(4)
    jobs = [(rng.integers(0, 512, n), new)
            for n, new in ((5, 9), (20, 7), (47, 12), (3, 5), (30, 8))]
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             seed=4).to("cuda")
    streams = []
    for k in (1, 4):
        eng = ContinuousBatchingEngine(model, max_batch_size=3,
                                       max_seq_len=64, harvest_every=k)
        rids = [eng.add_request(p, max_new_tokens=n) for p, n in jobs]
        out = eng.run()
        eng.check_invariants()
        assert eng._pending == [] and len(eng._free) == eng.num_pages - 1
        streams.append([out[r] for r in rids])
    assert streams[0] == streams[1]
    assert [len(s) for s in streams[1]] == [n for _, n in jobs]


def _tiny_deltas(model, names=("a1", "a2")):
    """Seeded rank-8 deltas (A (K, r), B (r, N)) on three matmuls of the
    tiny Llama, the vocab head among them: {name: deltas}."""
    params = dict(model.named_parameters())
    out = {}
    for i, name in enumerate(names):
        g = np.random.default_rng(i + 1)
        deltas = {}
        for nm in ("model.layers.0.self_attn.q_proj.weight",
                   "model.layers.1.mlp.down_proj.weight", "lm_head.weight"):
            n, k = params[nm].shape
            deltas[nm] = (g.normal(size=(k, 8)).astype(np.float32) * 0.3,
                          g.normal(size=(8, n)).astype(np.float32) * 0.3)
        out[name] = deltas
    return out


@pytest.mark.parametrize("mode", ["full", "quant", "lora", "legacy"])
def test_tiny_engine_graphs_match_eager(cuda, mode):
    """The program cache on the card: each dispatch family captured once
    a key (after its warm-up on the engine's capture stream) and
    replayed gives streams bitwise equal to the eager engine's
    (``_graphs=False``) at k = 1 and k = 4, with launch counts equal to
    eager's (each replay adds what its capture recorded); after
    `install_weights` the programs are rebuilt and the replays read the
    new weights (streams equal eager's under them, and not the old
    streams)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                                 QuantServingConfig)
    from paddle_tpu_torch.ops import reset_launch_counts
    rng = np.random.default_rng(5)
    jobs = [(rng.integers(0, 512, n), new)
            for n, new in ((5, 9), (20, 7), (47, 12), (3, 5), (30, 8))]
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             seed=5).to(cuda)
    other = {n: p.detach().to(cuda) for n, p in LlamaForCausalLM(
        LlamaConfig.tiny(), device="cpu", seed=6).named_parameters()}
    kw = {"quant": dict(quant=QuantServingConfig("int8", "int8")),
          "legacy": dict(attention_impl="legacy")}.get(mode, {})
    names = (None, "a1", "a2") if mode == "lora" else (None,)
    deltas = _tiny_deltas(model)

    def serve(eng):
        for name in names[1:]:
            eng.install_adapter(name, deltas[name])
        rids = [eng.add_request(p, max_new_tokens=n,
                                adapter=names[i % len(names)])
                for i, (p, n) in enumerate(jobs)]
        out = eng.run()
        eng.check_invariants()
        assert len(eng._free) == eng.num_pages - 1
        return [out[r] for r in rids]

    for k in (1,) if mode == "legacy" else (1, 4):
        runs = {}
        for graphs in (True, False):
            eng = ContinuousBatchingEngine(model, max_batch_size=3,
                                           max_seq_len=64, harvest_every=k,
                                           _graphs=graphs, **kw)
            reset_launch_counts()
            first = serve(eng)
            counts = dict(launch_counts)
            captured = eng.num_graph_captures
            eng.install_weights(other, "other")
            second = serve(eng)
            torch.cuda.synchronize()
            runs[graphs] = (first, second, counts, captured,
                            eng.num_graph_captures)
        (g1, g2, gc, gcap, gcap2), (e1, e2, ec, ecap, _) = \
            runs[True], runs[False]
        assert g1 == e1 and g2 == e2
        assert g2 != g1                 # the second checkpoint decodes
        assert gc == ec
        # the decode program was captured, and captured again after the
        # weights changed; the eager engine captures nothing
        assert gcap >= 1 and gcap2 > gcap and ecap == 0


def _tiny_legacy_jobs(mode):
    """Seeded jobs for `test_tiny_legacy_engines_graphs_match_eager`: for
    the prefix cache prompts sharing a 24-token prefix (hits of 1 and 2
    pages of 8; the suffix key (16, 8) used twice, so that its program
    is captured), for the chunked prefill prompts below, at and past a
    16-token chunk."""
    rng = np.random.default_rng(7)
    if mode == "legacy_prefix":
        base = list(rng.integers(1, 512, 24))
        return [(base + [3], 6), (base[:16] + [9, 8], 7),
                (base + list(rng.integers(1, 512, 5)), 5),
                (base[:8] + [4], 6), (list(rng.integers(1, 512, 11)), 4),
                (base[:16] + [2, 5, 7], 5)]
    return [(rng.integers(0, 512, n), new)
            for n, new in ((5, 9), (16, 7), (47, 12), (3, 5), (33, 8))]


@pytest.mark.parametrize("mode", ["dense", "legacy_prefix",
                                  "legacy_chunked"])
def test_tiny_legacy_engines_graphs_match_eager(cuda, mode):
    """The program cache of the dense layout (its decode one program),
    the legacy prefix cache (the suffix programs) and the legacy chunked
    prefill (the chunk program): streams bitwise equal to the eager
    engine's, equal launch counts, every page back; the dense and chunk
    programs rebuilt after `install_weights` (the prefix cache refuses
    a weight change). Each mode's own program is captured: the dense
    decode, a suffix program (its key's second use), the chunk
    program."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import reset_launch_counts
    jobs = _tiny_legacy_jobs(mode)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             seed=5).to(cuda)
    other = {n: p.detach().to(cuda) for n, p in LlamaForCausalLM(
        LlamaConfig.tiny(), device="cpu", seed=6).named_parameters()}
    kw = {"dense": dict(kv_layout="dense"),
          "legacy_prefix": dict(attention_impl="legacy", page_size=8,
                                prompt_pad=8, enable_prefix_caching=True),
          "legacy_chunked": dict(attention_impl="legacy",
                                 prefill_chunk=16)}[mode]
    batch = 1 if mode == "legacy_prefix" else 3

    def serve(eng):
        rids = [eng.add_request(p, max_new_tokens=n) for p, n in jobs]
        out = eng.run()
        eng.check_invariants()
        if mode != "dense":
            while eng._prefix_enabled and eng._evict_one():
                pass
            assert len(eng._free) == eng.num_pages - 1
        return [out[r] for r in rids]

    runs = {}
    for graphs in (True, False):
        eng = ContinuousBatchingEngine(model, max_batch_size=batch,
                                       max_seq_len=64, _graphs=graphs, **kw)
        reset_launch_counts()
        first = serve(eng)
        counts = dict(launch_counts)
        captured = eng.num_graph_captures
        own = {"dense": [eng._decode_program],
               "legacy_prefix": list(eng._suffix_programs.values()),
               "legacy_chunked": [eng._chunk_program]}[mode]
        assert any(p is not None and p.graph is not None
                   for p in own) == graphs
        second = None
        if mode != "legacy_prefix":
            eng.install_weights(other, "other")
            second = serve(eng)
        torch.cuda.synchronize()
        runs[graphs] = (first, second, counts, captured,
                        eng.num_graph_captures, eng.prefix_hits)
    (g1, g2, gc, gcap, gcap2, ghits), (e1, e2, ec, ecap, _, ehits) = \
        runs[True], runs[False]
    assert g1 == e1 and g2 == e2 and gc == ec and ghits == ehits
    assert gcap >= 1 and ecap == 0
    if mode == "legacy_prefix":
        assert ghits == 4
    else:
        assert g2 != g1 and gcap2 > gcap


def test_tiny_migration_graphs_match_eager(cuda):
    """KV page transfer on the card: three requests move mid-decode from
    one engine to another (`serving.transfer.migrate_request`), on
    graphed and on eager engines. The streams are bitwise equal to the
    eager run's and to one engine's unmigrated run; the launches of the
    graphed pair equal the eager pair's; the install program of the
    migrations' page count (three of them) is warmed up, captured and
    replayed."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import reset_launch_counts
    from paddle_tpu_torch.serving import transfer
    rng = np.random.default_rng(8)
    jobs = [(rng.integers(0, 512, 20), 9), (rng.integers(0, 512, 5), 7),
            (rng.integers(0, 512, 20), 8), (rng.integers(0, 512, 40), 6),
            (rng.integers(0, 512, 20), 10)]
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             seed=8).to(cuda)
    ref = ContinuousBatchingEngine(model, max_batch_size=5, max_seq_len=64)
    rids = [ref.add_request(p, max_new_tokens=n) for p, n in jobs]
    out = ref.run()
    want = [out[r] for r in rids]
    runs = {}
    for graphs in (True, False):
        src, dst = [ContinuousBatchingEngine(model, max_batch_size=5,
                                             max_seq_len=64, _graphs=graphs)
                    for _ in range(2)]
        reset_launch_counts()
        rids = [src.add_request(p, max_new_tokens=n) for p, n in jobs]
        src.step()
        src.step()
        moved = {}
        for rid in rids[::2]:
            req, payload = transfer.migrate_request(src, dst, rid)
            assert payload["n_pages"] == 2
            moved[rid] = req
        done = {}
        while any(r is not None for e in (src, dst) for r in e._slot_req):
            for eng in (src, dst):
                for r in eng.step():
                    done[r.request_id] = r.output
        src.check_invariants()
        dst.check_invariants()
        torch.cuda.synchronize()
        prog = dst._install_programs.get(2)
        runs[graphs] = ([done[str(r)] for r in rids], dict(launch_counts),
                        None if prog is None else (prog.runs,
                                                   prog.graph is not None))
    (gs, gc, gprog), (es, ec, eprog) = runs[True], runs[False]
    assert gs == es == want
    assert gc == ec
    assert gprog == (3, True) and eprog is None


def test_tiny_legacy_scatter_program_graphs_match_eager(cuda):
    """The legacy page scatter as a program on the card: prompts of one
    bucket admitted one after another reuse its scatter program, which
    is captured at its second use; the streams are bitwise equal to the
    eager engine's, and the launches too."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import reset_launch_counts
    rng = np.random.default_rng(9)
    jobs = [(rng.integers(0, 512, n), new)
            for n, new in ((17, 6), (20, 5), (30, 7), (5, 4), (25, 6))]
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             seed=9).to(cuda)
    runs = {}
    for graphs in (True, False):
        eng = ContinuousBatchingEngine(model, max_batch_size=2,
                                       max_seq_len=64, prompt_pad=32,
                                       attention_impl="legacy",
                                       _graphs=graphs)
        reset_launch_counts()
        rids = [eng.add_request(p, max_new_tokens=n) for p, n in jobs]
        out = eng.run()
        eng.check_invariants()
        torch.cuda.synchronize()
        prog = eng._scatter_programs.get(32)
        runs[graphs] = ([out[r] for r in rids], dict(launch_counts),
                        None if prog is None else (prog.runs,
                                                   prog.graph is not None),
                        eng._pool_writes)
    (gs, gc, gprog, gw), (es, ec, eprog, ew) = runs[True], runs[False]
    assert gs == es and gc == ec
    assert gprog == (5, True) and eprog is None and gw == ew == 5


@pytest.mark.parametrize("kw", [
    dict(),
    dict(eos_token_id=7, repetition_penalty=1.3, no_repeat_ngram_size=2),
    dict(decode_strategy="beam_search", num_beams=4),
    dict(decode_strategy="beam_search", num_beams=2, eos_token_id=7,
         length_penalty=0.6),
], ids=["greedy", "greedy_processors", "beam4", "beam2_eos"])
def test_tiny_generate_on_card_matches_cpu(cuda, kw):
    """`generate()` of the tiny f32 Llama on the card (flash attention
    kernel in the prefill, RMSNorm kernels in every forward) against the
    CPU's plain versions: equal ids, scores within flash attention's f32
    limit 1e-4, and exactly L flash launches and (2L + 1) RMSNorm
    launches a forward."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import reset_launch_counts
    cfg = LlamaConfig.tiny()
    ids = np.random.default_rng(8).integers(0, 512, (2, 19)) \
        .astype(np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        model = LlamaForCausalLM(cfg, device="cpu", seed=8).to(dev)
        reset_launch_counts()
        toks, scores = model.generate(torch.from_numpy(ids).to(dev),
                                      max_new_tokens=9, **kw)
        out[dev] = (toks.cpu(), scores.cpu(), dict(launch_counts))
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=1e-4,
                               rtol=1e-4)
    L = cfg.num_hidden_layers
    counts = out["cuda"][2]
    assert counts["flash_attention_fwd"] == L
    assert counts["rms_norm"] == (2 * L + 1) * 9
    assert counts["paged_attention"] == 0
    assert sum(out["cpu"][2].values()) == 0


def test_tiny_generate_sampling_on_card(cuda):
    """Seeded sampling on the card: one generator seed, one stream;
    ``top_k=1`` is greedy; the loop reads nothing back from the card
    (under ``set_sync_debug_mode("error")``)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             seed=9).to(cuda)
    ids = torch.from_numpy(np.random.default_rng(9).integers(
        0, 512, (2, 12)).astype(np.int32)).to(cuda)
    kw = dict(max_new_tokens=8, decode_strategy="sampling", top_p=0.9,
              temperature=0.8)
    a, sa = model.generate(ids, generator=torch.Generator(cuda)
                           .manual_seed(4), **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b, sb = model.generate(ids, generator=torch.Generator(cuda)
                               .manual_seed(4), **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(a, b) and torch.equal(sa, sb)
    greedy, _ = model.generate(ids, max_new_tokens=8)
    top1, _ = model.generate(ids, max_new_tokens=8,
                             decode_strategy="sampling", top_k=1,
                             generator=torch.Generator(cuda).manual_seed(5))
    assert torch.equal(top1, greedy)


def _lora_operands(dev, t, k, n, r, dtype, stacks=4, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + t + k + n + r)
    x = torch.randn(t, k, device=dev, generator=g).to(dtype)
    a = (0.2 * torch.randn(stacks, k, r, device=dev, generator=g)).to(dtype)
    b = (0.2 * torch.randn(stacks, r, n, device=dev, generator=g)).to(dtype)
    a[0] = 0
    b[0] = 0
    scale = torch.linspace(0.0, 1.5, stacks, device=dev)
    ids = torch.randint(0, stacks, (t,), device=dev, generator=g,
                        dtype=torch.int32)
    return x, a, b, scale, ids


LORA_SHAPES = [(8, 4096, 14336, 16), (8, 14336, 4096, 16),
               (300, 4096, 1024, 16), (9, 32, 64, 8), (5, 128, 130, 1),
               (1, 70, 33, 3), (40, 256, 512, 64), (3, 1000, 300, 5)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LORA_SHAPES,
                         ids=["t{}_k{}_n{}_r{}".format(*s) for s in
                              LORA_SHAPES])
def test_lora_epilogue_kernel_matches_plain(cuda, shape, dtype):
    t, k, n, r = shape
    x, a, b, scale, ids = _lora_operands(cuda, t, k, n, r, dtype)
    before = launch_counts["lora_epilogue"]
    out = le.lora_epilogue_values(x, a, b, scale, ids)
    assert launch_counts["lora_epilogue"] == before + 1
    ref = le.lora_epilogue_ref(x, a, b, scale, ids)
    assert out.dtype == dtype and out.shape == (t, n)
    torch.testing.assert_close(out.float(), ref.float(),
                               **_kernel_tol(ref, dtype))
    # the fused add: y + delta, the delta rounded first
    y = torch.randn(t, n, device=cuda).to(dtype)
    want = y + out
    got = le.lora_epilogue_values(x, a, b, scale, ids, y=y.clone())
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lora_epilogue_bitwise_batch_invariance(cuda, dtype):
    """A token's delta alone equals its delta inside batches of 8 and of
    300, bitwise; row-0 tokens give exact zeros; zero rank columns
    padded onto the stacks change no bit."""
    x, a, b, scale, ids = _lora_operands(cuda, 300, 4096, 1024, 8, dtype)
    full = le.lora_epilogue_values(x, a, b, scale, ids)
    eight = le.lora_epilogue_values(x[:8], a, b, scale, ids[:8])
    assert torch.equal(eight, full[:8])
    for i in (0, 5, 299):
        alone = le.lora_epilogue_values(x[i:i + 1], a, b, scale,
                                        ids[i:i + 1])
        assert torch.equal(alone, full[i:i + 1])
    assert bool((full[ids == 0] == 0).all())
    zeros = le.lora_epilogue_values(x, a, b, scale, torch.zeros_like(ids))
    assert bool((zeros == 0).all())
    pad_a = torch.cat([a, torch.zeros_like(a)], 2)
    pad_b = torch.cat([b, torch.zeros_like(b)], 1)
    assert torch.equal(le.lora_epilogue_values(x, pad_a, pad_b, scale, ids),
                       full)


# (T, K, N, r, ids): decode, the admission gate/up with segmented ids (a
# sequence's rows together) and interleaved ids, a ragged last tile, rank
# 64, K and N off every tile
LORA_DESIGN_CASES = [(8, 4096, 14336, 16, "interleaved"),
                     (8, 14336, 4096, 16, "interleaved"),
                     (6432, 4096, 14336, 16, "segmented"),
                     (6432, 4096, 14336, 16, "interleaved"),
                     (1170, 4096, 1024, 16, "segmented"),
                     (65, 1000, 300, 64, "random"),
                     (3, 70, 33, 5, "random")]


def _lora_ids(cuda, kind, t, stacks=4, seed=0):
    if kind == "interleaved":
        return (torch.arange(t, device=cuda, dtype=torch.int32) * 3) % stacks
    if kind == "segmented":
        return (torch.arange(t, device=cuda) * stacks // t).to(torch.int32)
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randint(0, stacks, (t,), device=cuda, generator=g,
                         dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("design", ["sgmv", "bgmv"])
@pytest.mark.parametrize("case", LORA_DESIGN_CASES,
                         ids=["t{}_k{}_n{}_r{}_{}".format(*c) for c in
                              LORA_DESIGN_CASES])
def test_lora_designs_match_plain(cuda, case, design, dtype):
    """Both designs within the tolerance of the plain version, the fused
    add as `y + delta`, bitwise on repeat."""
    t, k, n, r, kind = case
    x, a, b, scale, _ = _lora_operands(cuda, t, k, n, r, dtype)
    ids = _lora_ids(cuda, kind, t)
    out = le.lora_epilogue_values(x, a, b, scale, ids, _design=design)
    ref = le.lora_epilogue_ref(x, a, b, scale, ids)
    torch.testing.assert_close(out.float(), ref.float(),
                               **_kernel_tol(ref, dtype))
    assert torch.equal(out, le.lora_epilogue_values(x, a, b, scale, ids,
                                                    _design=design))
    y = torch.randn(t, n, device=cuda).to(dtype)
    got = le.lora_epilogue_values(x, a, b, scale, ids, y=y.clone(),
                                  _design=design)
    assert torch.equal(got, y + out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kind", ["segmented", "interleaved"])
def test_sgmv_bitwise_across_decode_and_admission(cuda, dtype, kind):
    """A token's SGMV delta alone (T = 1), in a decode batch of 8 and in
    an admission batch of 6432 is the same bitwise, at any position; row-0
    tokens are exact zeros; zero rank columns change no bit."""
    t, k, n, r = 6432, 4096, 1024, 16
    x, a, b, scale, _ = _lora_operands(cuda, t, k, n, r, dtype)
    ids = _lora_ids(cuda, kind, t)
    full = le.lora_epilogue_values(x, a, b, scale, ids)
    for lo in (0, 3000, t - 8):
        eight = le.lora_epilogue_values(x[lo:lo + 8], a, b, scale,
                                        ids[lo:lo + 8])
        assert torch.equal(eight, full[lo:lo + 8])
    for i in (0, 1, 63, 64, 4999, t - 1):
        alone = le.lora_epilogue_values(x[i:i + 1], a, b, scale,
                                        ids[i:i + 1])
        assert torch.equal(alone, full[i:i + 1])
    perm = torch.roll(torch.arange(t, device=cuda), 37)
    moved = le.lora_epilogue_values(x[perm], a, b, scale, ids[perm])
    assert torch.equal(moved, full[perm])
    assert bool((full[ids == 0] == 0).all())
    pad_a = torch.cat([a, torch.zeros_like(a)], 2)
    pad_b = torch.cat([b, torch.zeros_like(b)], 1)
    assert torch.equal(le.lora_epilogue_values(x, pad_a, pad_b, scale, ids),
                       full)


def test_lora_design_refusals_raise_before_launch(cuda):
    x, a, b, scale, ids = _lora_operands(cuda, 4, 64, 32, 4, torch.float32)
    before = launch_counts["lora_epilogue"]
    with pytest.raises(ValueError, match="does not take"):
        le.lora_epilogue_values(x, a, b, scale, ids, _design="sgmv")
    xb, ab, bb, sb, ib = _lora_operands(cuda, 4, 64, 32, 65, torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        le.lora_epilogue_values(xb, ab, bb, sb, ib, _design="sgmv")
    with pytest.raises(ValueError, match="no lora epilogue design"):
        le.lora_epilogue_values(x, a, b, scale, ids, _design="tiles")
    assert launch_counts["lora_epilogue"] == before


def test_lora_epilogue_wrapper_checks(cuda):
    x, a, b, scale, ids = _lora_operands(cuda, 4, 64, 32, 4, torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        le.lora_epilogue_values(x, a.to(torch.bfloat16), b, scale, ids)
    with pytest.raises(TypeError, match="int32"):
        le.lora_epilogue_values(x, a, b, scale, ids.long())
    with pytest.raises(ValueError, match="shape"):
        le.lora_epilogue_values(x, a, b, scale[:2], ids)
    with pytest.raises(ValueError, match="CUDA device"):
        le.lora_epilogue_values(x, a.cpu(), b, scale, ids)
    # refused by the C entry (rank above 256): the wrapper raises
    big = _lora_operands(cuda, 2, 16, 16, 300, torch.float32)
    with pytest.raises(RuntimeError, match="launch failed"):
        le.lora_epilogue_values(*big)


PAGED_CASES = [
    # (name, hk, g, contexts, window, d)
    ("g4_long", 8, 4, [1, 17, 300, 517, 1024, 1500, 2000, 2048], None, 128),
    ("g4_window256", 8, 4, [1, 17, 300, 517, 1024, 1500, 2000, 2048], 256,
     128),
    ("g1", 4, 1, [1, 40, 600, 2048], None, 128),
    ("g8_window100", 2, 8, [5, 400, 1300], 100, 128),
    ("g8_d64", 2, 8, [3, 64, 65, 700], None, 64),
    ("g2_d32_window7", 4, 2, [1, 7, 8, 33], 7, 32),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=[c[0] for c in PAGED_CASES])
def test_paged_attention_kernel_matches_plain(cuda, case, dtype):
    name, hk, g, ctx, window, d = case
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = _case(rng, hk, g, [1] * len(ctx), ctx, 1, 0, d=d)
    q, kp, vp, _, _, cl, bt = [torch.from_numpy(a).to(cuda) for a in arrays]
    q, kp, vp = (z.to(dtype) for z in (q, kp, vp))
    before = launch_counts["paged_attention"]
    out = pa.paged_attention_values(q, kp, vp, cl, bt, window=window)
    assert launch_counts["paged_attention"] == before + 1
    ref = pa.paged_attention_values(q, kp, vp, cl, bt, window=window,
                                    use_kernel=False)
    tol = dict(atol=2e-2, rtol=0) if dtype != torch.float32 \
        else dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


def test_paged_attention_inactive_slot_and_refusals(cuda):
    """An inactive slot (ctx 1 on an all-trash block-table row) reads
    page 0 only; shapes the C entry refuses raise."""
    rng = np.random.default_rng(3)
    arrays = _case(rng, 2, 4, [1, 1], [1, 300], 1, 0, trash_rows=(0,))
    q, kp, vp, _, _, cl, bt = [torch.from_numpy(a).to(cuda) for a in arrays]
    out = pa.paged_attention_values(q, kp, vp, cl, bt)
    ref = pa.paged_attention_values(q, kp, vp, cl, bt, use_kernel=False)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention_values(q, kp, vp, cl.long(), bt)
    with pytest.raises(ValueError, match="shape"):
        pa.paged_attention_values(q[:, :, :64].contiguous(), kp, vp, cl, bt)
    # refused by the C entry (32 query heads per KV head): raises
    q32 = torch.randn(2, 2 * 32, 128, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        pa.paged_attention_values(q32, kp, vp, cl, bt)


def _tiny_streams(dev, **engine_kw):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n) for n in (5, 20, 47, 3)]
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             seed=3).to(dev)
    adapters = engine_kw.pop("adapters", ())
    eng = ContinuousBatchingEngine(model, max_batch_size=2, max_seq_len=64,
                                   device=dev, **engine_kw)
    deltas = _tiny_deltas(model, adapters)
    for name in adapters:
        eng.install_adapter(name, deltas[name])
    names = [None] + list(adapters)
    for i, p in enumerate(prompts):
        eng.add_request(p, max_new_tokens=8,
                        adapter=names[i % len(names)])
    out = eng.run()
    eng.check_invariants()
    return out


@pytest.mark.parametrize("kw", [dict(adapters=("a1", "a2")),
                                dict(attention_impl="legacy")],
                         ids=["lora", "legacy"])
def test_tiny_lora_and_legacy_engines_on_card_match_cpu(cuda, kw):
    assert _tiny_streams("cuda", **dict(kw)) == _tiny_streams("cpu",
                                                              **dict(kw))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 300, 6432])
@pytest.mark.parametrize("h", [64, 4096, 4100])
def test_rms_norm_backward_kernel_matches_plain(cuda, rows, h, dtype):
    g = torch.Generator(device=cuda).manual_seed(rows * h)
    x = (3 * torch.randn(rows, h, device=cuda, generator=g)).to(dtype)
    w = (1 + 0.1 * torch.randn(h, device=cuda, generator=g)).to(dtype)
    dy = torch.randn(rows, h, device=cuda, generator=g).to(dtype)
    grads = []
    for use_kernel in (True, False):
        xx = x.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        before = dict(launch_counts)
        out = nk.rms_norm_values(xx, ww, 1e-5, use_kernel=use_kernel)
        out.backward(dy)
        n = int(use_kernel)
        assert launch_counts["rms_norm"] == before["rms_norm"] + n
        assert launch_counts["rms_norm_bwd"] == before["rms_norm_bwd"] + n
        grads.append((xx.grad, ww.grad))
    (dx, dw), (rdx, rdw) = grads
    assert dx.dtype == dtype and dw.dtype == dtype
    if dtype != torch.float32:
        torch.testing.assert_close(dx.float(), rdx.float(), rtol=2 ** -7,
                                   atol=1e-3)
        top = rdw.float().abs().max().item()
        torch.testing.assert_close(dw.float(), rdw.float(), rtol=2 ** -7,
                                   atol=1e-3 * top)
    else:
        torch.testing.assert_close(dx, rdx, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dw, rdw, rtol=1e-4, atol=1e-4)
    # deterministic: the dw partials are added in block order
    x2, w2 = x.reshape(-1, h), w
    _, rstd = nk._rms_fwd(x2, w2, 1e-5)
    a = nk._rms_bwd(x2, w2, rstd, dy)
    b = nk._rms_bwd(x2, w2, rstd, dy)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# (label, B, Sq, Sk, H, HK, causal, window)
FLASH_CASES = [("causal", 2, 300, 300, 4, 2, True, None),
               ("gqa4", 1, 130, 130, 8, 2, True, None),
               ("sq_lt_sk", 1, 100, 333, 4, 1, True, None),
               ("sq_gt_sk", 1, 200, 70, 4, 2, True, None),
               ("window", 1, 500, 500, 4, 2, True, 64),
               ("noncausal", 2, 130, 190, 4, 4, False, None),
               ("gqa7", 1, 300, 300, 28, 4, True, None),
               # many unmasked key tiles in a row at both head dims: where
               # a register A operand of wgmma lives across the key loop,
               # ptxas has given its registers to other values in the
               # loop with no warning (the forward with a key tile as
               # wide as the head dim read P in place of Q from the
               # second tile on); the wgmma kernels hold no such operand,
               # and this case would show one
               ("noncausal_long", 1, 200, 2048, 4, 2, False, None)]


def _flash_inputs(cuda, case, d, dtype):
    _, b, sq, sk, h, hk, _, _ = case
    g = torch.Generator(device=cuda).manual_seed(sq * 7 + sk + d)
    f = lambda *s: torch.randn(*s, device=cuda, generator=g).to(dtype)
    return f(b, sq, h, d), f(b, sk, hk, d), f(b, sk, hk, d), f(b, sq, h, d)


def _flash_close(out, ref, dtype):
    """Scale-free: the whole tensor's relative error and the worst
    row's, within `fa.KERNEL_LIMITS` (chip_smoke.py shows those limits
    catch a skipped K tile and a wrong GQA head); f32 also elementwise."""
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    rel, row = fa.kernel_errors(out, ref)
    lim = fa.KERNEL_LIMITS[dtype]
    assert rel <= lim["rel"] and row <= lim["row"], (rel, row)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 16, 32, 40, 64, 72, 80, 96, 112, 128, 136,
                               160, 192, 256])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_kernels_match_plain(cuda, case, d, dtype):
    label, _, sq, sk, _, _, causal, window = case
    q, k, v, do = _flash_inputs(cuda, case, d, dtype)
    before = dict(launch_counts)
    o, lse = fa._flash_fwd(q, k, v, d ** -0.5, causal, window)
    ro, rlse = fa.flash_attention_ref(q, k, v, causal, None, window)
    _flash_close(o, ro, dtype)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    got = fa._flash_bwd(q, k, v, o, lse, do, d ** -0.5, causal, window)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, None,
                                      window)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _flash_close(a, b, dtype)
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        key = f"flash_attention_{name}"
        assert launch_counts[key] == before[key] + 1
    if label == "sq_gt_sk":
        # rows 0..Sq-Sk-1 see no key: exact zeros, zero gradient
        dead = sq - sk
        assert torch.equal(o[:, :dead], torch.zeros_like(o[:, :dead]))
        assert torch.equal(got[0][:, :dead],
                           torch.zeros_like(got[0][:, :dead]))
        assert bool((lse[..., :dead] == -1e30).all())
    # dK/dV deterministic
    again = fa._flash_bwd(q, k, v, o, lse, do, d ** -0.5, causal, window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_attention_autograd_and_refusals(cuda):
    q, k, v, do = _flash_inputs(cuda, FLASH_CASES[1], 64, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(launch_counts)
    out = fa.flash_attention_values(*leaves, causal=True)
    out.backward(do)
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        key = f"flash_attention_{name}"
        assert launch_counts[key] == before[key] + 1
    want = fa.flash_attention_bwd_ref(q, k, v, out.detach(),
                                      fa.flash_attention_ref(
                                          q, k, v, True)[1], do, True)
    for leaf, w in zip(leaves, want):
        _flash_close(leaf.grad, w, torch.bfloat16)
    # head dims off 8 run the kernels; past 256, `attention_xla`, as the
    # reference's `_aligned` sends them to `_attention_xla`
    for d, dt in ((264, torch.float32), (100, torch.bfloat16),
                  (36, torch.float16)):
        q, k, v, do = _flash_inputs(cuda, FLASH_CASES[1], d, dt)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = dict(launch_counts)
        out = fa.flash_attention_values(*leaves, causal=True)
        out.backward(do)
        counted = {key: launch_counts[key] - before[key] for key in before
                   if launch_counts[key] != before[key]}
        if d > fa.MAX_HEAD_DIM:
            assert counted == {"flash_attention_xla": 1}
            ref = [t.clone().requires_grad_() for t in (q, k, v)]
            ro = fa.attention_xla(*ref, d ** -0.5, True)
            ro.backward(do)
            ro = ro.detach()
            want = [t.grad for t in ref]
        else:
            assert counted == {f"flash_attention_{n}": 1
                               for n in ("fwd", "bwd_dq", "bwd_dkv")}
            ro, lse = fa.flash_attention_ref(q, k, v, True)
            want = fa.flash_attention_bwd_ref(q, k, v, out.detach(), lse,
                                              do, True)
        _flash_close(out.detach(), ro, dt)
        for leaf, w in zip(leaves, want):
            _flash_close(leaf.grad, w, dt)
    # float64 raises before launch
    before = dict(launch_counts)
    bad = torch.zeros(1, 8, 2, 32, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        fa.flash_attention_values(bad, bad, bad, causal=True)
    assert launch_counts == before
    with pytest.raises(ValueError, match="requires causal"):
        fa.flash_attention_values(q, k, v, window_size=8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_bwd_designs_match_plain_and_each_other(cuda, case, d, dtype):
    """The wgmma backward (`csrc/flash_bwd_sm90.cu`, the default at these
    dtypes and head dims) and the mma.sync one it replaced, each against
    the plain version at `fa.KERNEL_LIMITS`, against each other at the
    same limits, and bitwise equal across runs."""
    _, _, sq, sk, _, _, causal, window = case
    assert fa.sm90_design(dtype, d) == "wgmma"
    q, k, v, do = _flash_inputs(cuda, case, d, dtype)
    scale = d ** -0.5
    o, lse = fa._flash_fwd(q, k, v, scale, causal, window)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, None,
                                      window)
    got = {}
    for design in ("wgmma", "mma.sync"):
        before = dict(launch_counts)
        got[design] = fa._flash_bwd(q, k, v, o, lse, do, scale, causal,
                                    window, _design=design)
        for name in ("bwd_dq", "bwd_dkv"):
            key = f"flash_attention_{name}"
            assert launch_counts[key] == before[key] + 1
        for a, b in zip(got[design], want):
            assert a.dtype == dtype and a.shape == b.shape
            _flash_close(a, b, dtype)
    for a, b in zip(got["wgmma"], got["mma.sync"]):
        _flash_close(a, b, dtype)
    again = fa._flash_bwd(q, k, v, o, lse, do, scale, causal, window,
                          _design="wgmma")
    assert all(torch.equal(a, b) for a, b in zip(got["wgmma"], again))
    if sq > sk and causal:
        dead = sq - sk   # rows with no key: zero gradient
        assert not got["wgmma"][0][:, :dead].any()


def test_flash_bwd_wgmma_entry_refusals_raise(cuda):
    """An input the wgmma entries do not take (f32, a head dim other than
    64 or 128) comes back as a CUDA error from the entry, and the
    launcher raises: no quiet fall back to the other design."""
    for d, dt in ((64, torch.float32), (72, torch.bfloat16)):
        q, k, v, do = _flash_inputs(cuda, FLASH_CASES[1], d, dt)
        o, lse = fa._flash_fwd(q, k, v, d ** -0.5, True, None)
        delta = fa._delta(o, do)
        before = dict(launch_counts)
        with pytest.raises(RuntimeError, match="launch failed"):
            fa._flash_bwd_dq(q, k, v, do, lse, delta, d ** -0.5, True, None,
                             _design="wgmma")
        with pytest.raises(RuntimeError, match="launch failed"):
            fa._flash_bwd_dkv(q, k, v, do, lse, delta, d ** -0.5, True,
                              None, _design="wgmma")
        assert launch_counts == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_fwd_designs_match_plain(cuda, case, d, dtype):
    """The wgmma forward (`csrc/flash_fwd_sm90.cu`, the default at these
    dtypes and head dims) and the mma.sync forward it replaced, each
    against the plain version: o at `fa.KERNEL_LIMITS`, lse within 1e-3,
    rows with no live key exact zeros with lse -1e30, the wgmma one
    bitwise equal across runs."""
    _, _, sq, sk, _, _, causal, window = case
    assert fa.sm90_design(dtype, d) == "wgmma"
    q, k, v, _ = _flash_inputs(cuda, case, d, dtype)
    scale = d ** -0.5
    ro, rlse = fa.flash_attention_ref(q, k, v, causal, None, window)
    for design in ("wgmma", "mma.sync"):
        before = launch_counts["flash_attention_fwd"]
        o, lse = fa._flash_fwd(q, k, v, scale, causal, window,
                               _design=design)
        assert launch_counts["flash_attention_fwd"] == before + 1
        assert o.dtype == dtype and lse.dtype == torch.float32
        _flash_close(o, ro, dtype)
        assert (lse - rlse).abs().max().item() <= 1e-3
        if sq > sk and causal:
            dead = sq - sk
            assert not o[:, :dead].any()
            assert bool((lse[..., :dead] == -1e30).all())
    again = fa._flash_fwd(q, k, v, scale, causal, window, _design="wgmma")
    o, lse = fa._flash_fwd(q, k, v, scale, causal, window, _design="wgmma")
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_wgmma_forward_and_backward_under_autograd(cuda, d, dtype):
    """`flash_attention_values` with autograd: the wgmma forward, then the
    wgmma backward on its lse, one launch of each kernel, outputs and
    grads against the plain versions; a negative scale too."""
    for case, scale in ((FLASH_CASES[0], None), (FLASH_CASES[4], None),
                        (FLASH_CASES[6], -0.05)):
        _, _, _, _, _, _, causal, window = case
        q, k, v, do = _flash_inputs(cuda, case, d, dtype)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = dict(launch_counts)
        out = fa.flash_attention_values(*leaves, causal=causal, scale=scale,
                                        window_size=window)
        out.backward(do)
        counted = {key: launch_counts[key] - before[key] for key in before
                   if launch_counts[key] != before[key]}
        assert counted == {f"flash_attention_{n}": 1
                           for n in ("fwd", "bwd_dq", "bwd_dkv")}
        ro, rlse = fa.flash_attention_ref(q, k, v, causal, scale, window)
        want = fa.flash_attention_bwd_ref(q, k, v, ro, rlse, do, causal,
                                          scale, window)
        _flash_close(out.detach(), ro, dtype)
        for leaf, w in zip(leaves, want):
            _flash_close(leaf.grad, w, dtype)


# (label, M, K, N, group sizes): a tile straddling three groups, empty
# groups, an M tail with rows past the last group, a 1-row group on a
# tile boundary, K off the 64-wide k step (the last step reads TMA's zero
# fill past K on both sides)
GMM_WGMMA_CASES = [
    ("straddle", 700, 256, 384, [130, 0, 7, 300, 0, 0, 250]),
    ("m_tail", 1000, 192, 200, [127, 1, 0, 600, 1, 200]),
    ("single_row", 1, 64, 64, [1, 0]),
    ("wide", 513, 512, 1024, [256, 256, 1]),
    ("k_tail_72", 400, 72, 200, [100, 0, 250, 30]),
    ("k_tail_96", 333, 96, 136, [64, 200, 0, 69])]


@pytest.mark.parametrize("trans", [False, True], ids=["kn", "nk"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", GMM_WGMMA_CASES,
                         ids=[c[0] for c in GMM_WGMMA_CASES])
def test_grouped_matmul_wgmma_matches_plain(cuda, case, dtype, trans):
    """The wgmma grouped matmul against `gmm_plain`
    and beside the mma.sync design, at `gmm.GMM_LIMITS`; rows past the
    last group exact zeros; bitwise equal across runs."""
    label, m, k, n, sizes = case
    assert gmm.gmm_design(dtype, k, n) == "wgmma"
    lhs, rhs, gs = _gmm_inputs(cuda, m, k, n, sizes, dtype, trans,
                               seed=m + k + n)
    ref = gmm.gmm_plain(lhs, rhs, gs, trans)
    lim = gmm.GMM_LIMITS[dtype]
    end = min(m, sum(sizes))
    before = launch_counts["grouped_matmul"]
    out = gmm._gmm_cuda(lhs, rhs, gs, trans, "wgmma")
    old = gmm._gmm_cuda(lhs, rhs, gs, trans, "mma.sync")
    assert launch_counts["grouped_matmul"] == before + 2
    for got in (out, old):
        assert got.dtype == dtype and got.shape == (m, n)
        assert not got[end:].any()
        rel, row = kernel_errors(got, ref)
        assert rel <= lim["rel"] and row <= lim["row"], (rel, row)
    assert torch.equal(out, gmm._gmm_cuda(lhs, rhs, gs, trans, "wgmma"))


def test_grouped_matmul_off_8_takes_mma_sync(cuda):
    """K or N off the multiples of 8 routes to the mma.sync kernel, and
    the wgmma design named for it raises before any launch."""
    for k, n in ((100, 64), (64, 36)):
        assert gmm.gmm_design(torch.bfloat16, k, n) == "mma.sync"
        lhs, rhs, gs = _gmm_inputs(cuda, 300, k, n, [100, 0, 150, 50],
                                   torch.bfloat16, False, seed=k + n)
        before = launch_counts["grouped_matmul"]
        out = gmm.gmm(lhs, rhs, gs)
        assert launch_counts["grouped_matmul"] == before + 1
        rel, row = kernel_errors(out, gmm.gmm_plain(lhs, rhs, gs))
        lim = gmm.GMM_LIMITS[torch.bfloat16]
        assert rel <= lim["rel"] and row <= lim["row"]
        with pytest.raises(ValueError, match="wgmma grouped matmul does "
                           "not take"):
            gmm.gmm(lhs, rhs, gs, _design="wgmma")
        assert launch_counts["grouped_matmul"] == before + 1


def _tiny_train_on(dev, build, ids, steps=3):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    model = build().to(dev)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = TrainStep(model, opt, loss_fn=lambda m, x, y: m(x, labels=y)[0])
    x, y = ids[0].to(dev), ids[1].to(dev)
    losses = [float(step(x, y)) for _ in range(steps)]
    return losses, {n: p.detach().cpu() for n, p in model.named_parameters()}


def _same_training(card, cpu):
    np.testing.assert_allclose(card[0], cpu[0], atol=1e-4)
    for name, p in cpu[1].items():
        if name.endswith("k_proj.bias"):
            # its true gradient is zero (softmax ignores q.b_k, the same
            # for every key): Adam's normalised step follows rounding
            # noise, of either sign on either device
            continue
        diff = (card[1][name] - p).norm() / p.norm().clamp_min(1e-12)
        assert diff <= 1e-4, (name, diff.item())


def test_tiny_train_steps_on_card_match_cpu(cuda):
    """Three AdamW TrainSteps of the tiny f32 Llama (D = 32, GQA 4:2):
    the card's losses equal the CPU's within 1e-4 and each parameter
    within 1e-4 of its norm (f32 sums in another order through every
    kernel and matmul; Adam's normalised step moves a weight whose
    gradient is near zero by a visibly different amount, one element
    of 32768 measured 1.4e-4 off with lr 1e-3, so the budget is on the
    norm of the difference)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 512, (2, 65)).astype(np.int64))
    out = {}
    for dev in ("cuda", "cpu"):
        model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                                 seed=3).to(dev)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        step = TrainStep(model, opt,
                         loss_fn=lambda m, x, y: m(x, labels=y)[0])
        x, y = ids[:, :-1].to(dev), ids[:, 1:].to(dev)
        losses = [float(step(x, y)) for _ in range(3)]
        out[dev] = losses, {n: p.detach().cpu() for n, p in
                            model.named_parameters()}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-4)
    for name, p in out["cpu"][1].items():
        diff = (out["cuda"][1][name] - p).norm() / p.norm()
        assert diff <= 1e-4, (name, diff.item())


def test_tiny_recompute_on_card_matches_plain(cuda):
    """The tiny f32 Llama with ``recompute`` on the card: the loss and
    every gradient bitwise equal to the card's run without it (the same
    kernels on the same inputs), each flash forward launched twice and
    each RMSNorm forward of a layer twice (2L and 4L + 1 a step), and
    within the budgets of `test_tiny_train_steps_on_card_match_cpu` of
    the plain path on the CPU."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 65)).astype(np.int64))
    out = {}
    for dev, rc in (("cuda", False), ("cuda", True), ("cpu", True)):
        cfg = LlamaConfig.tiny()
        cfg.recompute = rc
        model = LlamaForCausalLM(cfg, device="cpu", seed=3).to(dev)
        reset_launch_counts()
        loss, _ = model(ids[:, :-1].to(dev), labels=ids[:, 1:].to(dev))
        loss.backward()
        counts = dict(launch_counts)
        out[dev, rc] = loss.detach().cpu(), {
            n: p.grad.cpu() for n, p in model.named_parameters()}, counts
    L = LlamaConfig.tiny().num_hidden_layers
    (l0, g0, c0), (l1, g1, c1) = out["cuda", False], out["cuda", True]
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert (c0["flash_attention_fwd"], c1["flash_attention_fwd"]) == \
        (L, 2 * L)
    assert (c0["rms_norm"], c1["rms_norm"]) == (2 * L + 1, 4 * L + 1)
    assert c1["flash_attention_bwd_dq"] == c1["flash_attention_bwd_dkv"] \
        == L and c1["rms_norm_bwd"] == 2 * L + 1
    lc, gc, _ = out["cpu", True]
    np.testing.assert_allclose(float(l1), float(lc), atol=1e-4)
    for n, g in gc.items():
        assert (g1[n] - g).norm() <= 1e-4 * g.norm() + 1e-6, n


def test_shm_loader_forks_from_a_cuda_process(cuda):
    """The shared-memory `io.DataLoader` forks its workers from this
    process, which holds a CUDA context: the workers touch no CUDA, and
    their batches equal the inline loader's (a shuffle seeded alike)."""
    from paddle_tpu_torch.io import BatchSampler, DataLoader, RandomSampler
    from paddle_tpu_torch.text import LMBlockDataset, SyntheticTokens
    torch.zeros(1, device=cuda).sum().item()
    ds = LMBlockDataset(SyntheticTokens(1000, 40000, seed=2), 128)

    def batches(workers):
        bs = BatchSampler(sampler=RandomSampler(
            ds, generator=np.random.default_rng(5)), batch_size=16,
            drop_last=True)
        return list(DataLoader(ds, batch_sampler=bs, num_workers=workers))
    inline, shm = batches(0), batches(3)
    assert len(inline) == len(shm) == len(ds) // 16
    for a, b in zip(inline, shm):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert shm[0][0].device.type == "cpu"

def _gmm_inputs(cuda, m, k, n, sizes, dtype, trans, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    lhs = torch.randn(m, k, device=cuda, generator=g).to(dtype)
    shape = (len(sizes), n, k) if trans else (len(sizes), k, n)
    rhs = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    return lhs, rhs, torch.tensor(sizes, device=cuda, dtype=torch.int32)


# (label, M, K, N, group sizes): ragged groups with empty ones and rows
# past the end, a skewed routing (half the rows to one expert, most
# experts empty), groups under one tile, a sum past M, and edges that no
# 16-byte chunk covers (K, N not multiples of 8)
GMM_CASES = [
    ("ragged", 1000, 256, 384, [130, 0, 7, 300, 1, 0, 250, 200]),
    ("skewed", 2048, 512, 256, [1024, 0, 0, 500, 0, 0, 24, 0, 300, 0, 0, 0,
                                 200, 0, 0, 0]),
    ("tiny_groups", 300, 64, 128, [5, 3, 0, 17, 1, 90, 2, 100]),
    ("sum_past_m", 500, 128, 136, [200, 250, 100]),
    ("odd_edges", 333, 100, 36, [100, 0, 150, 50]),
    ("single_row", 1, 64, 64, [1, 0])]


@pytest.mark.parametrize("trans", [False, True], ids=["kn", "nk"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", GMM_CASES, ids=[c[0] for c in GMM_CASES])
def test_grouped_matmul_kernel_matches_plain(cuda, case, dtype, trans):
    label, m, k, n, sizes = case
    lhs, rhs, gs = _gmm_inputs(cuda, m, k, n, sizes, dtype, trans,
                               seed=m + k + n)
    before = launch_counts["grouped_matmul"]
    out = gmm.gmm(lhs, rhs, gs, trans)
    assert launch_counts["grouped_matmul"] == before + 1
    ref = gmm.gmm_plain(lhs, rhs, gs, trans)
    assert out.dtype == dtype and out.shape == (m, n)
    end = min(m, sum(sizes))
    assert torch.equal(out[end:], torch.zeros_like(out[end:]))
    rel, row = kernel_errors(out, ref)
    lim = gmm.GMM_LIMITS[dtype]
    assert rel <= lim["rel"] and row <= lim["row"], (rel, row)
    if dtype == torch.float32:
        top = ref.abs().max().item()
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * top)
    # deterministic: no atomics
    assert torch.equal(out, gmm.gmm(lhs, rhs, gs, trans))


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_matmul_autograd_matches_plain(cuda, dtype):
    lhs, rhs, gs = _gmm_inputs(cuda, 700, 192, 320, [100, 0, 250, 3, 300],
                               dtype, False, seed=1)
    dout = torch.randn(700, 320, device=cuda).to(dtype)
    grads = []
    for use_kernel in (True, False):
        a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
        before = launch_counts["grouped_matmul"]
        gmm.grouped_matmul_values(a, b, gs, use_kernel).backward(dout)
        # forward and d(lhs)
        assert launch_counts["grouped_matmul"] == before + 2 * use_kernel
        grads.append((a.grad, b.grad))
    lim = gmm.GMM_LIMITS[dtype]
    for got, want in zip(grads[0], grads[1]):
        assert got.dtype == dtype
        rel, row = kernel_errors(got.reshape(-1, got.shape[-1]),
                                  want.reshape(-1, want.shape[-1]))
        assert rel <= lim["rel"] and row <= lim["row"], (rel, row)


def test_grouped_matmul_wrapper_checks(cuda):
    lhs, rhs, gs = _gmm_inputs(cuda, 64, 32, 32, [32, 32],
                               torch.bfloat16, False, seed=2)
    with pytest.raises(TypeError, match="one dtype"):
        gmm.gmm(lhs, rhs.float(), gs)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        gmm.gmm(lhs.double(), rhs.double(), gs)
    with pytest.raises(ValueError, match="contraction"):
        gmm.gmm(lhs[:, :16].contiguous(), rhs, gs)
    with pytest.raises(ValueError, match="group_sizes"):
        gmm.gmm(lhs, rhs, gs[:1])
    with pytest.raises(ValueError, match="contiguous"):
        gmm.gmm(lhs.T.contiguous().T, rhs, gs)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 300, 16384])
@pytest.mark.parametrize("h", [100, 768, 3584])
def test_layer_norm_kernels_match_plain(cuda, rows, h, dtype):
    g = torch.Generator(device=cuda).manual_seed(rows * h)
    x = (3 * torch.randn(rows, h, device=cuda, generator=g) + 1).to(dtype)
    w = (1 + 0.1 * torch.randn(h, device=cuda, generator=g)).to(dtype)
    b = (0.1 * torch.randn(h, device=cuda, generator=g)).to(dtype)
    dy = torch.randn(rows, h, device=cuda, generator=g).to(dtype)
    outs = []
    for use_kernel in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        before = dict(launch_counts)
        y = nk.layer_norm_values(*leaves, 1e-12, use_kernel=use_kernel)
        y.backward(dy)
        n = int(use_kernel)
        assert launch_counts["layer_norm"] == before["layer_norm"] + n
        assert launch_counts["layer_norm_bwd"] == \
            before["layer_norm_bwd"] + n
        outs.append([y.detach()] + [t.grad for t in leaves])
    lim = nk.LN_LIMITS[dtype]
    for name, got, want in zip(("y", "dx", "dw", "db"), *outs):
        assert got.dtype == dtype, name
        rel, row = kernel_errors(got.reshape(-1, h), want.reshape(-1, h))
        assert rel <= lim["rel"] and row <= lim["row"], (name, rel, row)
    # the statistics, and dw/db deterministic (partials in block order)
    _, mean, rstd = nk._ln_fwd(x, w, b, 1e-12)
    xf = x.float()
    torch.testing.assert_close(mean, xf.mean(-1), rtol=1e-5, atol=1e-5)
    a = nk._ln_bwd(x, w, mean, rstd, dy)
    c = nk._ln_bwd(x, w, mean, rstd, dy)
    assert all(torch.equal(p, q) for p, q in zip(a, c))


def test_tiny_moe_train_steps_on_card_match_cpu(cuda):
    """The tiny f32 MoE (head dim 16), dropless (its expert matmuls
    through the grouped-matmul kernel on the card) and capacity, three
    AdamW steps: card against CPU as the tiny Llama's."""
    from paddle_tpu_torch.models.moe import MoEConfig, MoEForCausalLM
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 65)).astype(np.int64))
    for dropless in (True, False):
        cfg = MoEConfig.tiny()
        cfg.dropless = dropless
        before = launch_counts["grouped_matmul"]
        runs = {dev: _tiny_train_on(
            dev, lambda: MoEForCausalLM(cfg, device="cpu", seed=4),
            (ids[:, :-1], ids[:, 1:])) for dev in ("cuda", "cpu")}
        # 2 layers x 3 steps x (3 forward + 3 d(lhs))
        assert launch_counts["grouped_matmul"] - before == 36 * dropless
        _same_training(runs["cuda"], runs["cpu"])


def test_tiny_bert_train_steps_on_card_match_cpu(cuda):
    """The tiny f32 BERT at dropout 0 (LayerNorm kernels forward and
    backward on the card), three AdamW steps: card against CPU."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    cfg = BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 261, (2, 64)).astype(np.int64))
    y = torch.where(torch.from_numpy(rng.random((2, 64)) < 0.15), x, -100)
    before = dict(launch_counts)
    runs = {dev: _tiny_train_on(
        dev, lambda: BertForMaskedLM(cfg, device="cpu", seed=5), (x, y))
        for dev in ("cuda", "cpu")}
    # embeddings 1, 2 a layer x 2, LM head 1: 6 a step
    for key in ("layer_norm", "layer_norm_bwd"):
        assert launch_counts[key] - before[key] == 18
    _same_training(runs["cuda"], runs["cpu"])


def test_flash_head_dim_256_through_the_kernels(cuda):
    """D = 256, the reference's largest, through `flash_attention_values`:
    the kernels forward and backward, once each, at `fa.KERNEL_LIMITS`."""
    q, k, v, do = _flash_inputs(cuda, FLASH_CASES[1], 256, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(launch_counts)
    out = fa.flash_attention_values(*leaves, causal=True)
    out.backward(do)
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        key = f"flash_attention_{name}"
        assert launch_counts[key] == before[key] + 1
    ro, lse = fa.flash_attention_ref(q, k, v, True)
    _flash_close(out.detach(), ro, torch.bfloat16)
    want = fa.flash_attention_bwd_ref(q, k, v, out.detach(), lse, do, True)
    for leaf, w in zip(leaves, want):
        _flash_close(leaf.grad, w, torch.bfloat16)


# (label, B, Sq, Sk, H, HK, causal, packing)
VARLEN_CASES = [
    ("packed_causal", 2, 300, 300, 4, 2, True, "runs"),
    ("packed_noncausal", 2, 300, 300, 4, 2, False, "runs"),
    ("sq_lt_sk", 1, 130, 333, 4, 1, True, "runs"),
    ("sq_gt_sk", 1, 200, 70, 4, 2, True, "runs"),
    ("single_tokens", 1, 190, 190, 4, 2, True, "singles"),
    ("non_monotone", 2, 257, 257, 8, 2, True, "random"),
    ("all_padding_tail", 1, 260, 260, 2, 2, True, "tail"),
    ("gqa7", 1, 300, 300, 28, 4, True, "runs"),
    # one segment, non-causal, 32 unmasked key tiles in a row: where a
    # register A operand of wgmma lives across the key loop, ptxas has
    # given its registers to other values in the loop (FLASH_CASES
    # "noncausal_long"); the sm90 varlen kernels hold none, and this case
    # would show it
    ("noncausal_long", 1, 200, 2048, 4, 2, False, "one")]


def _varlen_segments(packing, b, sq, sk, rng):
    def runs(n):
        seg = np.full((b, n), -1, np.int32)
        for i in range(b):
            cuts = np.sort(rng.choice(np.arange(1, n), 5, replace=False))
            bounds = np.concatenate([[0], cuts, [n - rng.integers(0, 40)]])
            for j in range(len(bounds) - 1):
                seg[i, bounds[j]:bounds[j + 1]] = j
        return seg
    if packing == "runs":
        return runs(sq), runs(sk)
    if packing == "singles":     # one-token segments among longer ones
        seg = np.repeat(np.arange(sq // 2), 2)[None, :sq].astype(np.int32)
        seg[:, :40] = np.arange(40)
        return seg, seg.copy()
    if packing == "tail":        # a long padding tail past a tile
        seg = np.zeros((b, sq), np.int32)
        seg[:, 100:] = -1
        return seg, seg.copy()
    if packing == "one":         # one segment, no padding
        return np.zeros((b, sq), np.int32), np.zeros((b, sk), np.int32)
    seg = rng.integers(-1, 4, (b, sq)).astype(np.int32)
    return seg, seg.copy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [16, 64, 72, 128, 256])
@pytest.mark.parametrize("case", VARLEN_CASES,
                         ids=[c[0] for c in VARLEN_CASES])
def test_varlen_kernels_match_plain(cuda, case, d, dtype):
    label, b, sq, sk, h, hk, causal, packing = case
    rng = np.random.default_rng(sq + sk + d)
    sgq, sgk = (torch.from_numpy(z).to(cuda) for z in
                _varlen_segments(packing, b, sq, sk, rng))
    q, k, v, do = _flash_inputs(cuda, (label, b, sq, sk, h, hk, causal,
                                       None), d, dtype)
    scale = d ** -0.5
    before = dict(launch_counts)
    o, lse = fv._varlen_fwd(q, k, v, sgq, sgk, scale, causal)
    ro, rlse = fv.flash_attention_varlen_ref(q, k, v, sgq, sgk, causal)
    _flash_close(o, ro, dtype)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    got = fv._varlen_bwd(q, k, v, o, lse, do, sgq, sgk, scale, causal)
    want = fv.flash_attention_varlen_bwd_ref(q, k, v, o, lse, do, sgq, sgk,
                                             causal)
    for a, b_ in zip(got, want):
        assert a.dtype == dtype and a.shape == b_.shape
        _flash_close(a, b_, dtype)
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        key = f"flash_varlen_{name}"
        assert launch_counts[key] == before[key] + 1
    pad_q, pad_k = sgq < 0, sgk < 0
    assert not o[pad_q].any() and not got[0][pad_q].any()
    assert bool((lse.transpose(1, 2)[pad_q] == -1e30).all())
    assert not got[1][pad_k].any() and not got[2][pad_k].any()
    again = fv._varlen_bwd(q, k, v, o, lse, do, sgq, sgk, scale, causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("design", ["sm90", "mma.sync"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", VARLEN_CASES,
                         ids=[c[0] for c in VARLEN_CASES])
def test_varlen_designs_match_plain(cuda, case, d, dtype, design):
    """Both designs at the sm90 design's dtypes and head dims, against the
    plain versions at `fa.KERNEL_LIMITS`; the device plan equal to
    `varlen_tile_plan`; the sm90 design bitwise equal across runs and
    across its two block orders."""
    label, b, sq, sk, h, hk, causal, packing = case
    rng = np.random.default_rng(sq + sk + d)
    sgq, sgk = (torch.from_numpy(z).to(cuda) for z in
                _varlen_segments(packing, b, sq, sk, rng))
    q, k, v, do = _flash_inputs(cuda, (label, b, sq, sk, h, hk, causal,
                                       None), d, dtype)
    scale = d ** -0.5
    plan = None
    if design == "sm90":
        before = launch_counts["flash_varlen_plan"]
        plan = fv._varlen_plan(sgq, sgk, causal)
        assert launch_counts["flash_varlen_plan"] == before + 1
        got = fv.unpack_plan(plan, b, sq, sk)
        want = fv.varlen_tile_plan(sgq, sgk, causal)
        for key, x in got.items():
            assert torch.equal(x.to(torch.int64), want[key].to(torch.int64)), \
                key
    o, lse = fv._varlen_fwd(q, k, v, sgq, sgk, scale, causal, design, plan)
    ro, rlse = fv.flash_attention_varlen_ref(q, k, v, sgq, sgk, causal)
    _flash_close(o, ro, dtype)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    got = fv._varlen_bwd(q, k, v, o, lse, do, sgq, sgk, scale, causal,
                         design, plan)
    want = fv.flash_attention_varlen_bwd_ref(q, k, v, o, lse, do, sgq, sgk,
                                             causal)
    for a, b_ in zip(got, want):
        _flash_close(a, b_, dtype)
    pad_q, pad_k = sgq < 0, sgk < 0
    assert not o[pad_q].any() and not got[0][pad_q].any()
    assert not got[1][pad_k].any() and not got[2][pad_k].any()
    if design == "sm90":
        # the dQ kernel forms delta from o (as `_varlen_bwd`), or reads it
        delta = torch.empty_like(lse)
        dq = fv._varlen_bwd_dq(q, k, v, do, lse, delta, sgq, sgk, scale,
                               causal, design, plan, o=o)
        torch.testing.assert_close(delta, fa._delta(o, do), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(dq, fv._varlen_bwd_dq(
            q, k, v, do, lse, delta, sgq, sgk, scale, causal, design, plan))
        runs = [(*fv._varlen_fwd(q, k, v, sgq, sgk, scale, causal, design,
                                 plan, _order=order),
                 fv._varlen_bwd_dq(q, k, v, do, lse, delta, sgq, sgk, scale,
                                   causal, design, plan, _order=order),
                 *fv._varlen_bwd_dkv(q, k, v, do, lse, delta, sgq, sgk,
                                     scale, causal, design, plan,
                                     _order=order))
                for order in ("plan", "plan", "dense")]
        want_bits = (o, lse, *got)
        assert all(torch.equal(x, y) for r in runs
                   for x, y in zip(r, want_bits))


@pytest.mark.parametrize("dtype", DTYPES)
def test_varlen_one_segment_equals_dense_kernels(cuda, dtype):
    """One segment without padding: each varlen design bitwise equal to
    the dense kernels of the same design (mma.sync: the same header;
    sm90: the same tiles, masks and products, both dQ kernels forming
    delta the same way)."""
    q, k, v, do = _flash_inputs(cuda, FLASH_CASES[0], 64, dtype)
    seg = torch.zeros(q.shape[:2], dtype=torch.int32, device=cuda)
    designs = [("mma.sync", "mma.sync")]
    if dtype != torch.float32:
        designs.append(("sm90", "wgmma"))
    for vdes, ddes in designs:
        o, lse = fv._varlen_fwd(q, k, v, seg, seg, 0.125, True, vdes)
        do_, dlse = fa._flash_fwd(q, k, v, 0.125, True, None, _design=ddes)
        assert torch.equal(o, do_) and torch.equal(lse, dlse)
        got = fv._varlen_bwd(q, k, v, o, lse, do, seg, seg, 0.125, True, vdes)
        want = fa._flash_bwd(q, k, v, o, lse, do, 0.125, True, None,
                             _design=ddes)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), vdes


def test_varlen_autograd_and_refusals(cuda):
    q, k, v, do = _flash_inputs(cuda, FLASH_CASES[1], 64, torch.bfloat16)
    seg = torch.zeros(q.shape[:2], dtype=torch.int32, device=cuda)
    seg[:, 60:] = 1
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(launch_counts)
    out = fv.flash_attention_varlen_values(*leaves, seg, seg, causal=True)
    out.backward(do)
    # the sm90 design: one plan, shared by the forward and the backward
    for name in ("fwd", "bwd_dq", "bwd_dkv", "plan"):
        key = f"flash_varlen_{name}"
        assert launch_counts[key] == before[key] + 1
    ro, lse = fv.flash_attention_varlen_ref(q, k, v, seg, seg, True)
    want = fv.flash_attention_varlen_bwd_ref(q, k, v, out.detach(), lse, do,
                                             seg, seg, True)
    for leaf, w in zip(leaves, want):
        _flash_close(leaf.grad, w, torch.bfloat16)
    with pytest.raises(ValueError, match="segment ids"):
        fv._varlen_fwd(q, k, v, seg.long(), seg, 0.125, True)
    # a design that does not take the input raises before any launch
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="sm90"):
        fv._varlen_fwd(q.float(), k.float(), v.float(), seg, seg, 0.125,
                       True, "sm90")
    q72 = torch.zeros(*q.shape[:3], 72, dtype=q.dtype, device=cuda)
    k72 = torch.zeros(*k.shape[:3], 72, dtype=q.dtype, device=cuda)
    with pytest.raises(ValueError, match="sm90"):
        fv._varlen_bwd_dkv(q72, k72, k72, q72, None, None, seg, seg, 0.125,
                           True, "sm90")
    with pytest.raises(ValueError, match="no plan"):
        fv._varlen_fwd(q, k, v, seg, seg, 0.125, True, "mma.sync",
                       fv._varlen_plan(seg, seg, True))
    with pytest.raises(ValueError, match="no varlen flash design"):
        fv._varlen_fwd(q, k, v, seg, seg, 0.125, True, "wgmma")
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1], device=cuda)
    with pytest.raises(ValueError, match="reads delta"):
        fv._varlen_bwd_dq(q, k, v, q, lse, lse, seg, seg, 0.125, True,
                          "mma.sync", o=q)
    assert launch_counts == {**before, "flash_varlen_plan":
                             before["flash_varlen_plan"] + 1}
    # past head dim 256, `varlen_xla`, as the reference's `_varlen_xla`
    q, k, v, do = _flash_inputs(cuda, FLASH_CASES[1], 264, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(launch_counts)
    out = fv.flash_attention_varlen_values(*leaves, seg, seg, causal=True)
    out.backward(do)
    assert {key: launch_counts[key] - before[key] for key in before
            if launch_counts[key] != before[key]} == {"flash_varlen_xla": 1}
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    ro = fv.varlen_xla(*ref, seg, seg, 264 ** -0.5, True)
    ro.backward(do)
    assert torch.equal(out, ro)
    for leaf, r in zip(leaves, ref):
        assert torch.equal(leaf.grad, r.grad)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 300, 4, 128), (1, 7, 3, 72),
                                   (3, 1, 2, 2)])
def test_rope_kernel_matches_plain_bitwise(cuda, shape, dtype):
    b, s, h, d = shape
    g = torch.Generator(device=cuda).manual_seed(s * d)
    x = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    inv = 1.0 / 500000.0 ** (torch.arange(0, d, 2, device=cuda) / d)
    ang = torch.arange(s + 5, device=cuda)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    before = launch_counts["rope"]
    for sign in (1, -1):
        c, sn = cos[5:].contiguous(), sin[5:].contiguous()
        out = rp._rope_cuda(x, c, sn, sign)
        assert torch.equal(out, rp.rope_ref(x, c, sn, float(sign)))
    assert launch_counts["rope"] == before + 2
    leaf = x.clone().requires_grad_()
    y = rp.rope_values(leaf, cos, sin, position_offset=5)
    y.backward(x)
    assert launch_counts["rope"] == before + 4
    c, sn = cos[5:], sin[5:]
    assert torch.equal(y.detach(), rp.rope_ref(x, c, sn))
    assert torch.equal(leaf.grad, rp.rope_ref(x, c, sn, -1.0))


def _rope_tables(cuda, s, d, extra=0):
    inv = 1.0 / 500000.0 ** (torch.arange(0, d, 2, device=cuda) / d)
    ang = torch.arange(s + extra, device=cuda)[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


# (B, S, H, HK, D): the rope_vec design's cases; the packed pretraining
# shapes cut to S 512
ROPE_VEC_SHAPES = [(2, 300, 4, 2, 128), (1, 7, 3, 1, 72),
                   (2, 512, 32, 8, 128), (1, 999, 8, 2, 64)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ROPE_VEC_SHAPES,
                         ids=["x".join(map(str, s)) for s in ROPE_VEC_SHAPES])
@pytest.mark.parametrize("which", ["q", "k", "qk"])
@pytest.mark.parametrize("sign", [1, -1])
def test_rope_vec_matches_plain_bitwise(cuda, shape, dtype, which, sign):
    """rope_vec on q alone, k alone and q + k in one launch, both signs,
    bitwise equal to the plain version."""
    b, s, h, hk, d = shape
    g = torch.Generator(device=cuda).manual_seed(s * d + h)
    q = torch.randn(b, s, h, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, s, hk, d, device=cuda, generator=g).to(dtype)
    cos, sin = _rope_tables(cuda, s, d, 3)
    c, sn = cos[3:].contiguous(), sin[3:].contiguous()
    assert rp.rope_design(dtype, d, q.data_ptr(), k.data_ptr(),
                          c.data_ptr(), sn.data_ptr()) == "vec"
    before = launch_counts["rope"]
    if which == "qk":
        yq, yk = rp._launch(q, k, c, sn, sign)
        assert torch.equal(yq, rp.rope_ref(q, c, sn, float(sign)))
        assert torch.equal(yk, rp.rope_ref(k, c, sn, float(sign)))
    else:
        x = q if which == "q" else k
        y = rp._rope_cuda(x, c, sn, sign)
        assert torch.equal(y, rp.rope_ref(x, c, sn, float(sign)))
    assert launch_counts["rope"] == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_view_off_16_bytes_takes_the_pair_design(cuda, dtype):
    """An input 8 bytes off 16 goes to the pair design (no copy), bitwise
    equal; naming the vector design for it raises before any launch; a
    view off its element pairs raises."""
    b, s, h, hk, d = 2, 33, 4, 2, 64
    cos, sin = _rope_tables(cuda, s, d)
    c, sn = cos.contiguous(), sin.contiguous()
    off = 8 // torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device=cuda).manual_seed(5)
    buf = torch.randn(b * s * h * d + off, device=cuda, generator=g).to(dtype)
    x = buf[off:].view(b, s, h, d)
    k = torch.randn(b, s, hk, d, device=cuda, generator=g).to(dtype)
    assert x.data_ptr() % 16 == 8
    assert rp.rope_design(dtype, d, x.data_ptr()) == "pair"
    before = launch_counts["rope"]
    for sign in (1, -1):
        assert torch.equal(rp._rope_cuda(x, c, sn, sign),
                           rp.rope_ref(x, c, sn, float(sign)))
    # q off 16 and k on 16: both on the pair design, a launch each
    yq, yk = rp._launch(x, k, c, sn, 1)
    assert torch.equal(yq, rp.rope_ref(x, c, sn))
    assert torch.equal(yk, rp.rope_ref(k, c, sn))
    assert launch_counts["rope"] == before + 4
    with pytest.raises(ValueError, match="rope_vec takes"):
        rp._rope_cuda(x, c, sn, 1, _design="vec")
    odd = buf[1:1 + b * s * h * d].view(b, s, h, d)
    with pytest.raises(ValueError, match="no rope kernel takes"):
        rp._rope_cuda(odd, c, sn, 1)
    assert launch_counts["rope"] == before + 4


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_pair_design_named_on_vector_inputs(cuda, dtype):
    """The pair design, named on inputs rope_vec takes (the yardstick the
    smoke times in turns): a launch a tensor, bitwise equal."""
    b, s, h, hk, d = 2, 300, 4, 2, 128
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(b, s, h, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, s, hk, d, device=cuda, generator=g).to(dtype)
    c, sn = _rope_tables(cuda, s, d)
    before = launch_counts["rope"]
    yq, yk = rp._launch(q, k, c, sn, -1, _design="pair")
    assert launch_counts["rope"] == before + 2
    assert torch.equal(yq, rp.rope_ref(q, c, sn, -1.0))
    assert torch.equal(yk, rp.rope_ref(k, c, sn, -1.0))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reaches", ["both", "q", "k"])
def test_fused_rope_under_autograd_one_launch_each_way(cuda, dtype,
                                                       reaches):
    """`fused_rotary_position_embedding`: 1 launch forward and 1 backward
    (on the one cotangent when only q' or k' reaches the loss), outputs
    and gradients bitwise equal to the plain version."""
    b, s, h, hk, d = 2, 256, 8, 2, 128
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(b, s, h, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, s, hk, d, device=cuda, generator=g).to(dtype)
    gq = torch.randn(b, s, h, d, device=cuda, generator=g).to(dtype)
    gk = torch.randn(b, s, hk, d, device=cuda, generator=g).to(dtype)
    cos, sin = _rope_tables(cuda, s, d, 9)
    lq, lk = q.clone().requires_grad_(), k.clone().requires_grad_()
    before = launch_counts["rope"]
    yq, yk = rp.fused_rotary_position_embedding(lq, lk, cos, sin, 9)
    assert launch_counts["rope"] == before + 1
    outs = {"both": ([yq, yk], [gq, gk]), "q": ([yq], [gq]),
            "k": ([yk], [gk])}[reaches]
    torch.autograd.backward(*outs)
    assert launch_counts["rope"] == before + 2
    c, sn = cos[9:], sin[9:]
    assert torch.equal(yq.detach(), rp.rope_ref(q, c, sn))
    assert torch.equal(yk.detach(), rp.rope_ref(k, c, sn))
    if reaches != "k":
        assert torch.equal(lq.grad, rp.rope_ref(gq, c, sn, -1.0))
    else:
        assert lq.grad is None
    if reaches != "q":
        assert torch.equal(lk.grad, rp.rope_ref(gk, c, sn, -1.0))
    else:
        assert lk.grad is None


def test_fused_rope_mixed_dtypes_two_launches_each_way(cuda):
    b, s, h, hk, d = 1, 64, 4, 2, 64
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(b, s, h, d, device=cuda, generator=g)
    k = torch.randn(b, s, hk, d, device=cuda, generator=g).bfloat16()
    cos, sin = _rope_tables(cuda, s, d)
    lq, lk = q.clone().requires_grad_(), k.clone().requires_grad_()
    before = launch_counts["rope"]
    yq, yk = rp.fused_rotary_position_embedding(lq, lk, cos, sin)
    assert launch_counts["rope"] == before + 2
    torch.autograd.backward([yq, yk], [q, k])
    assert launch_counts["rope"] == before + 4
    assert torch.equal(yq.detach(), rp.rope_values(q, cos, sin))
    assert torch.equal(yk.detach(), rp.rope_values(k, cos, sin))
    assert torch.equal(lk.grad, rp.rope_ref(k, cos, sin, -1.0))


def test_rope_kernels_do_not_spill(cuda):
    from paddle_tpu_torch.ops import _build
    _build.build(["rope"])
    lines = [ln for ln in _build.build_log("rope").splitlines()
             if "spill" in ln]
    assert lines, "ptxas printed no spill lines for csrc/rope.cu"
    for ln in lines:
        assert "0 bytes spill stores, 0 bytes spill loads" in ln, ln


# the norm forwards' two designs (`nk.norm_design`): the main paths' widths
# and two off-class ones (100 and 4100: whole 16-byte vectors in f32 only)
NORM_ROWS = [1, 8, 300, 16384]
NORM_H = [768, 1024, 3584, 4096, 100, 4100]
# two designs' statistics: f32 sums of the same terms in another order,
# a few dozen f32 roundings apart at most
STATS_RTOL = 2 ** -18


def _norm_designs(dtype, h):
    if nk.norm_design(dtype, h) == "registers":
        return ("registers", "strided")
    return ("strided",)


def _refuses_registers(fwd, *args):
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="registers norm design"):
        fwd(*args, _design="registers")
    assert launch_counts == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", NORM_H)
@pytest.mark.parametrize("rows", NORM_ROWS)
def test_rms_norm_forward_designs(cuda, rows, h, dtype):
    """Each design against the plain version (o at the forward's
    tolerances, rstd rtol 1e-5 of its formula), bitwise on repeat, the
    two designs' rstd within f32 rounding of each other, the backward
    kernel fed each design's rstd within the backward's tolerances of
    autograd of the plain version, and a planted fault (rstd without
    eps, on rows small enough that eps matters) outside the forward's
    tolerances."""
    g = torch.Generator(device=cuda).manual_seed(7 * rows + h)
    x = (3 * torch.randn(rows, h, device=cuda, generator=g)).to(dtype)
    w = (1 + 0.1 * torch.randn(h, device=cuda, generator=g)).to(dtype)
    dy = torch.randn(rows, h, device=cuda, generator=g).to(dtype)
    small = (x.float() * 1e-3).to(dtype)
    tol = dict(rtol=2 ** -7, atol=1e-3) if dtype != torch.float32 \
        else dict(rtol=1e-5, atol=1e-5)
    ref = nk.rms_norm_ref(x, w, 1e-5)
    want = torch.rsqrt(x.float().square().mean(-1) + 1e-5)
    leaves = [t.clone().requires_grad_() for t in (x, w)]
    rdx, rdw = torch.autograd.grad(nk.rms_norm_ref(*leaves, 1e-5), leaves,
                                   dy)
    fault = (small.float() * torch.rsqrt(small.float().square().mean(
        -1, keepdim=True)) * w.float()).to(dtype)
    designs = _norm_designs(dtype, h)
    rstds = {}
    for design in designs:
        before = launch_counts["rms_norm"]
        o, rstd = nk._rms_fwd(x, w, 1e-5, _design=design)
        assert launch_counts["rms_norm"] == before + 1
        assert o.dtype == dtype and rstd.shape == (rows,)
        torch.testing.assert_close(o.float(), ref.float(), **tol)
        torch.testing.assert_close(rstd, want, rtol=1e-5, atol=0)
        o2, rstd2 = nk._rms_fwd(x, w, 1e-5, _design=design)
        assert torch.equal(o, o2) and torch.equal(rstd, rstd2), design
        rstds[design] = rstd
        dx, dw = nk._rms_bwd(x, w, rstd, dy)
        if dtype != torch.float32:
            torch.testing.assert_close(dx.float(), rdx.float(),
                                       rtol=2 ** -7, atol=1e-3)
            top = rdw.float().abs().max().item()
            torch.testing.assert_close(dw.float(), rdw.float(),
                                       rtol=2 ** -7, atol=1e-3 * top)
        else:
            torch.testing.assert_close(dx, rdx, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(dw, rdw, rtol=1e-4, atol=1e-4)
        os_, _ = nk._rms_fwd(small, w, 1e-5, _design=design)
        torch.testing.assert_close(os_.float(), nk.rms_norm_ref(
            small, w, 1e-5).float(), **tol)
        assert not torch.allclose(os_.float(), fault.float(), **tol), design
    if len(designs) == 2:
        torch.testing.assert_close(rstds["registers"], rstds["strided"],
                                   rtol=STATS_RTOL, atol=0)
    else:
        _refuses_registers(nk._rms_fwd, x, w, 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", NORM_H)
@pytest.mark.parametrize("rows", NORM_ROWS)
def test_layer_norm_forward_designs(cuda, rows, h, dtype):
    """Each design against the plain version at `nk.LN_LIMITS`, bitwise on
    repeat, mean and rstd against their formulas and the two designs'
    within f32 rounding of each other, the backward kernel fed each
    design's statistics within `nk.LN_LIMITS` of autograd of the plain
    version, and a planted fault (the mean left out) outside them."""
    g = torch.Generator(device=cuda).manual_seed(11 * rows + h)
    x = (3 * torch.randn(rows, h, device=cuda, generator=g) + 1).to(dtype)
    w = (1 + 0.1 * torch.randn(h, device=cuda, generator=g)).to(dtype)
    b = (0.1 * torch.randn(h, device=cuda, generator=g)).to(dtype)
    dy = torch.randn(rows, h, device=cuda, generator=g).to(dtype)
    lim = nk.LN_LIMITS[dtype]
    ref = nk.layer_norm_ref(x, w, b, 1e-12)
    xf = x.float()
    mu = xf.mean(-1)
    scale = xf.abs().mean(-1)
    want_rstd = torch.rsqrt((xf - mu[:, None]).square().mean(-1) + 1e-12)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    rgrads = torch.autograd.grad(nk.layer_norm_ref(*leaves, 1e-12), leaves,
                                 dy)
    fault = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-12)
             * w.float() + b.float()).to(dtype)

    def within(got, want):
        rel, row = kernel_errors(got.reshape(-1, h), want.reshape(-1, h))
        return rel <= lim["rel"] and row <= lim["row"]

    designs = _norm_designs(dtype, h)
    stats = {}
    for design in designs:
        before = launch_counts["layer_norm"]
        y, mean, rstd = nk._ln_fwd(x, w, b, 1e-12, _design=design)
        assert launch_counts["layer_norm"] == before + 1
        assert y.dtype == dtype and mean.shape == rstd.shape == (rows,)
        assert within(y, ref), design
        torch.testing.assert_close(mean, mu, rtol=0,
                                   atol=float(STATS_RTOL * scale.max()))
        torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=0)
        y2, mean2, rstd2 = nk._ln_fwd(x, w, b, 1e-12, _design=design)
        assert torch.equal(y, y2) and torch.equal(mean, mean2) \
            and torch.equal(rstd, rstd2), design
        stats[design] = mean, rstd
        for name, got, want in zip(("dx", "dw", "db"),
                                   nk._ln_bwd(x, w, mean, rstd, dy), rgrads):
            assert got.dtype == dtype and within(got, want), (design, name)
        assert not within(y, fault), design
    if len(designs) == 2:
        (m1, r1), (m2, r2) = stats["registers"], stats["strided"]
        assert ((m1 - m2).abs() <= STATS_RTOL * scale).all()
        torch.testing.assert_close(r1, r2, rtol=STATS_RTOL, atol=0)
    else:
        _refuses_registers(nk._ln_fwd, x, w, b, 1e-12)


# every instance of the register-row kernels (`nk.row_class`'s classes: NV
# 1-8 vectors a lane at one warp a row, 5-8 at two and four), at the widest
# row of each class and at the narrowest (its last slot live in one lane)
ROW_CLASSES = [(wpr, nv, widest) for wpr in nk.ROW_WARPS
               for nv in range(1 if wpr == 1 else nk.ROW_VECS // 2 + 1,
                               nk.ROW_VECS + 1)
               for widest in (True, False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wpr,nv,widest", ROW_CLASSES)
def test_norm_forwards_every_row_class(cuda, wpr, nv, widest, dtype):
    """Both forwards on the default route at each class the C entries
    build, over 8 rows (a row a block) and 1001 (rows sharing blocks, a
    last block part empty): the register-row kernel launched once, o
    against the plain version (RMSNorm at the forward's tolerances,
    LayerNorm at `nk.LN_LIMITS`), the statistics against their formulas,
    bitwise on repeat."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    h = v * 32 * wpr * (nv if widest else nv - 1) + (0 if widest else v)
    assert nk.row_class(dtype, h) == (wpr, nv)
    assert nk.norm_design(dtype, h) == "registers"
    tol = dict(rtol=2 ** -7, atol=1e-3) if dtype != torch.float32 \
        else dict(rtol=1e-5, atol=1e-5)
    lim = nk.LN_LIMITS[dtype]
    for rows in (8, 1001):
        g = torch.Generator(device=cuda).manual_seed(rows + h)
        x = (3 * torch.randn(rows, h, device=cuda, generator=g) + 1).to(dtype)
        w = (1 + 0.1 * torch.randn(h, device=cuda, generator=g)).to(dtype)
        b = (0.1 * torch.randn(h, device=cuda, generator=g)).to(dtype)
        xf = x.float()
        mu = xf.mean(-1)
        before = dict(launch_counts)
        o, rstd = nk._rms_fwd(x, w, 1e-5)
        y, mean, lrstd = nk._ln_fwd(x, w, b, 1e-12)
        assert launch_counts["rms_norm"] == before["rms_norm"] + 1
        assert launch_counts["layer_norm"] == before["layer_norm"] + 1
        torch.testing.assert_close(
            o.float(), nk.rms_norm_ref(x, w, 1e-5).float(), **tol)
        torch.testing.assert_close(
            rstd, torch.rsqrt(xf.square().mean(-1) + 1e-5), rtol=1e-5,
            atol=0)
        rel, row = kernel_errors(y, nk.layer_norm_ref(x, w, b, 1e-12))
        assert rel <= lim["rel"] and row <= lim["row"], (rows, rel, row)
        torch.testing.assert_close(
            mean, mu, rtol=0,
            atol=float(STATS_RTOL * xf.abs().mean(-1).max()))
        torch.testing.assert_close(
            lrstd, torch.rsqrt((xf - mu[:, None]).square().mean(-1)
                               + 1e-12), rtol=1e-5, atol=0)
        o2, rstd2 = nk._rms_fwd(x, w, 1e-5)
        y2, mean2, lrstd2 = nk._ln_fwd(x, w, b, 1e-12)
        assert torch.equal(o, o2) and torch.equal(rstd, rstd2)
        assert torch.equal(y, y2) and torch.equal(mean, mean2) \
            and torch.equal(lrstd, lrstd2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_forwards_off_16_bytes_take_the_strided_design(cuda, dtype):
    """A row that starts off 16 bytes: the default route launches the
    strided kernel (right, counted once), the registers design
    refuses it before any launch."""
    rows, h = 8, 4096
    g = torch.Generator(device=cuda).manual_seed(3)
    buf = torch.randn(rows * h + 1, device=cuda, generator=g).to(dtype)
    x = buf[1:].view(rows, h)
    w = torch.ones(h, device=cuda, dtype=dtype)
    b = torch.zeros(h, device=cuda, dtype=dtype)
    assert x.data_ptr() % 16 != 0
    tol = dict(rtol=2 ** -7, atol=1e-3) if dtype != torch.float32 \
        else dict(rtol=1e-5, atol=1e-5)
    before = dict(launch_counts)
    o, _ = nk._rms_fwd(x, w, 1e-5)
    y, _, _ = nk._ln_fwd(x, w, b, 1e-5)
    assert launch_counts["rms_norm"] == before["rms_norm"] + 1
    assert launch_counts["layer_norm"] == before["layer_norm"] + 1
    torch.testing.assert_close(o.float(), nk.rms_norm_ref(x, w, 1e-5).float(),
                               **tol)
    assert kernel_errors(y, nk.layer_norm_ref(x, w, b, 1e-5))[0] <= \
        nk.LN_LIMITS[dtype]["rel"]
    _refuses_registers(nk._rms_fwd, x, w, 1e-5)
    _refuses_registers(nk._ln_fwd, x, w, b, 1e-5)


def test_norm_values_take_rows_in_any_rank(cuda):
    """The no-grad entries hand x to the kernel without a reshape: a
    (2, 4, h) input gives the (8, h) result bitwise, in its own shape."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 4, 4096, device=cuda, generator=g).bfloat16()
    w = (1 + 0.1 * torch.randn(4096, device=cuda, generator=g)).bfloat16()
    b = (0.1 * torch.randn(4096, device=cuda, generator=g)).bfloat16()
    with torch.no_grad():
        o = nk.rms_norm_values(x, w, 1e-5)
        y = nk.layer_norm_values(x, w, b, 1e-5)
    assert o.shape == y.shape == x.shape
    assert torch.equal(o.reshape(8, 4096), nk._rms_fwd(
        x.reshape(8, 4096), w, 1e-5)[0])
    assert torch.equal(y.reshape(8, 4096), nk._ln_fwd(
        x.reshape(8, 4096), w, b, 1e-5)[0])


# the norm backwards' two designs (`nk.norm_bwd_design`): the main paths'
# shapes (the RMSNorm backward of train_8b_width, train_recipe and the
# A14B-width cut; the LayerNorm backward of BERT-base and at the A14B
# width), then rows 1, 300 and a ragged 3001 at two widths in every dtype
NORM_BWD_MAIN = [("rms", 4096, 4096, torch.bfloat16),
                 ("rms", 16384, 1024, torch.bfloat16),
                 ("rms", 4096, 3584, torch.bfloat16),
                 ("ln", 16384, 768, torch.float32),
                 ("ln", 4096, 3584, torch.bfloat16)]
NORM_BWD_CASES = NORM_BWD_MAIN + [
    (kind, rows, h, dtype) for kind in ("rms", "ln")
    for rows in (1, 300, 3001) for h in (768, 4096) for dtype in DTYPES]


def _norm_bwd_inputs(cuda, kind, rows, h, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (3 * torch.randn(rows, h, device=cuda, generator=g) + 1).to(dtype)
    w = (1 + 0.1 * torch.randn(h, device=cuda, generator=g)).to(dtype)
    b = (0.1 * torch.randn(h, device=cuda, generator=g)).to(dtype)
    dy = torch.randn(rows, h, device=cuda, generator=g).to(dtype)
    if kind == "rms":
        stats = (nk._rms_fwd(x, w, 1e-5)[1],)
        leaves = [t.clone().requires_grad_() for t in (x, w)]
        ref = nk.rms_norm_ref(*leaves, 1e-5)
    else:
        stats = nk._ln_fwd(x, w, b, 1e-12)[1:]
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        ref = nk.layer_norm_ref(*leaves, 1e-12)
    want = torch.autograd.grad(ref, leaves, dy)
    return x, w, dy, stats, want


def _norm_bwd_close(kind, got, want, dtype, h):
    """RMSNorm: dx at the forward's tolerances, dw at rtol 2^-7 and 1e-3
    of the largest |dw| (f32: 1e-5 / 1e-4), as the backward's test above;
    LayerNorm: dx, dw, db within `nk.LN_LIMITS`."""
    if kind == "ln":
        lim = nk.LN_LIMITS[dtype]
        for name, a, r in zip(("dx", "dw", "db"), got, want):
            assert a.dtype == dtype, name
            rel, row = kernel_errors(a.reshape(-1, h), r.reshape(-1, h))
            assert rel <= lim["rel"] and row <= lim["row"], (name, rel, row)
        return
    (dx, dw), (rdx, rdw) = got, want
    assert dx.dtype == dtype and dw.dtype == dtype
    if dtype != torch.float32:
        torch.testing.assert_close(dx.float(), rdx.float(), rtol=2 ** -7,
                                   atol=1e-3)
        top = rdw.float().abs().max().item()
        torch.testing.assert_close(dw.float(), rdw.float(), rtol=2 ** -7,
                                   atol=1e-3 * top)
    else:
        torch.testing.assert_close(dx, rdx, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dw, rdw, rtol=1e-4, atol=1e-4)


def _norm_bwd_call(kind, x, w, dy, stats, **kw):
    if kind == "rms":
        return nk._rms_bwd(x, w, stats[0], dy, **kw)
    return nk._ln_bwd(x, w, *stats, dy, **kw)


@pytest.mark.parametrize("kind,rows,h,dtype", NORM_BWD_CASES,
                         ids=[f"{k}-{r}x{h}-{str(d)[6:]}"
                              for k, r, h, d in NORM_BWD_CASES])
def test_norm_bwd_designs_match_plain(cuda, kind, rows, h, dtype):
    """Each design (the register-row one, the rowblock one) against
    autograd of the plain version, one launch counted a call, dx and dw /
    db bitwise on a repeat; the default route takes the register-row
    design here."""
    x, w, dy, stats, want = _norm_bwd_inputs(cuda, kind, rows, h, dtype,
                                             rows + h)
    assert nk.norm_bwd_design(dtype, h) == "registers"
    key = "rms_norm_bwd" if kind == "rms" else "layer_norm_bwd"
    for kw in (dict(_design="registers"), dict(_design="rowblock"), {}):
        before = launch_counts[key]
        got = _norm_bwd_call(kind, x, w, dy, stats, **kw)
        assert launch_counts[key] == before + 1, kw
        _norm_bwd_close(kind, got, want, dtype, h)
        again = _norm_bwd_call(kind, x, w, dy, stats, **kw)
        assert all(torch.equal(a, c) for a, c in zip(got, again)), kw
    # the default route is the registers design, bitwise
    default = _norm_bwd_call(kind, x, w, dy, stats)
    chosen = _norm_bwd_call(kind, x, w, dy, stats, _design="registers")
    assert all(torch.equal(a, c) for a, c in zip(default, chosen))


# every instance of the register-row backward (`nk.bwd_row_class`'s
# classes: 1-4 vectors a lane at one warp a row, 3-4 at 2, 4 and 8), at
# the widest row of each class and at the narrowest (its last slot live in
# one lane)
BWD_ROW_CLASSES = [(wpr, nv, widest) for wpr in nk.BWD_ROW_WARPS
                   for nv in range(1 if wpr == 1 else 3, nk.BWD_ROW_VECS + 1)
                   for widest in (True, False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wpr,nv,widest", BWD_ROW_CLASSES)
def test_norm_bwd_every_row_class(cuda, wpr, nv, widest, dtype):
    """Both backwards on the default route at each class the C entries
    build, over 8 rows (a row group a block) and 1001 (groups sharing
    blocks, runs of several rows): against autograd of the plain version,
    bitwise on a repeat."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    h = v * 32 * wpr * (nv if widest else nv - 1) + (0 if widest else v)
    assert nk.bwd_row_class(dtype, h) == (wpr, nv)
    for rows in (8, 1001):
        for kind in ("rms", "ln"):
            x, w, dy, stats, want = _norm_bwd_inputs(cuda, kind, rows, h,
                                                     dtype, rows + h)
            got = _norm_bwd_call(kind, x, w, dy, stats)
            _norm_bwd_close(kind, got, want, dtype, h)
            again = _norm_bwd_call(kind, x, w, dy, stats)
            assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_bwd_off_16_bytes_takes_the_rowblock_design(cuda, dtype):
    """Rows that start off 16 bytes: the default route launches the
    rowblock kernels (right, counted once), the registers design refuses
    them before any launch."""
    rows, h = 300, 768
    g = torch.Generator(device=cuda).manual_seed(4)
    buf = (3 * torch.randn(rows * h + 1, device=cuda, generator=g)).to(dtype)
    x = buf[1:].view(rows, h)
    assert x.data_ptr() % 16 != 0
    w = (1 + 0.1 * torch.randn(h, device=cuda, generator=g)).to(dtype)
    b = torch.zeros(h, device=cuda, dtype=dtype)
    dy = torch.randn(rows, h, device=cuda, generator=g).to(dtype)
    for kind in ("rms", "ln"):
        if kind == "rms":
            stats = (nk._rms_fwd(x, w, 1e-5)[1],)
            leaves = [t.clone().requires_grad_() for t in (x, w)]
            want = torch.autograd.grad(nk.rms_norm_ref(*leaves, 1e-5),
                                       leaves, dy)
        else:
            stats = nk._ln_fwd(x, w, b, 1e-12)[1:]
            leaves = [t.clone().requires_grad_() for t in (x, w, b)]
            want = torch.autograd.grad(nk.layer_norm_ref(*leaves, 1e-12),
                                       leaves, dy)
        key = "rms_norm_bwd" if kind == "rms" else "layer_norm_bwd"
        before = dict(launch_counts)
        got = _norm_bwd_call(kind, x, w, dy, stats)
        assert launch_counts[key] == before[key] + 1
        _norm_bwd_close(kind, got, want, dtype, h)
        rowblock = _norm_bwd_call(kind, x, w, dy, stats, _design="rowblock")
        assert all(torch.equal(a, c) for a, c in zip(got, rowblock))
        before = dict(launch_counts)
        with pytest.raises(ValueError, match="registers norm backward"):
            _norm_bwd_call(kind, x, w, dy, stats, _design="registers")
        assert launch_counts == before


@pytest.mark.parametrize("kind,h,dtype,design", [
    ("ln", 6144, torch.bfloat16, "registers"),
    ("ln", 6144, torch.float32, "rowblock"),
    ("rms", 12288, torch.float32, "rowblock")])
def test_norm_bwd_at_48_kb_of_shared_memory(cuda, kind, h, dtype, design):
    """Widths whose partial rows fill exactly 48 KB of shared memory: with
    the static row-sum scratch the kernel needs the opt-in past 48 KB
    (without it the launch is refused), on the route the width takes."""
    assert nk.norm_bwd_design(dtype, h) == design
    x, w, dy, stats, want = _norm_bwd_inputs(cuda, kind, 300, h, dtype, h)
    got = _norm_bwd_call(kind, x, w, dy, stats)
    _norm_bwd_close(kind, got, want, dtype, h)


def test_split_tickets_per_stream_two_launches_at_once(cuda):
    """Two ragged decode attentions over different pages, launched at
    once on two streams (both streams wait on one event recorded after a
    spin on the default stream, so both launches are queued before
    either starts): each stream takes its own ticket buffer, and both
    outputs are bitwise those of the same calls one after the other."""
    cases = []
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        arrays = _case(rng, 8, 4, [1] * 8,
                       [2048, 1500, 2000, 1024, 517, 300, 2048, 1777], 1, 0)
        args = [torch.from_numpy(a).to(cuda) for a in arrays]
        args[:3] = [a.bfloat16() for a in args[:3]]
        cases.append(args)
    pps = cases[0][6].shape[1]
    plan = ra.split_plan(8, 8, 4, pps, 16,
                         ra.split_kernel(torch.bfloat16, 1, 128),
                         ra.sm_count(cuda))
    assert plan.n_splits > 1      # the launches merge on tickets
    call = lambda a: ra._ragged_cuda(*a, 128 ** -0.5, None, 1)
    want = [call(a) for a in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:       # each stream's tickets made before the race
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            call(cases[0])
    torch.cuda.synchronize()
    bufs = [ra._TICKETS[(cuda.index or 0, s.cuda_stream)] for s in streams]
    assert bufs[0].data_ptr() != bufs[1].data_ptr()
    go = torch.cuda.Event()
    for _ in range(5):
        torch.cuda._sleep(20_000_000)
        go.record()
        outs = []
        for s, args in zip(streams, cases):
            s.wait_event(go)
            with torch.cuda.stream(s):
                outs.append(call(args))
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, want))
    assert all(bool((t == 0).all()) for t in ra._TICKETS.values())


# the dense flash backward's main shapes (the Llama-3-8B training slice,
# the bench recipe's D 64, Qwen2-MoE-A14B's 7 query heads a KV head): the
# wgmma kernels, every operand that outlives a product read from shared
# memory, against the plain backward
FLASH_BWD_MAIN = [("slice_8b", 2, 2048, 32, 8, 128),
                  ("bench", 8, 2048, 16, 8, 64),
                  ("gqa7_a14b", 1, 4096, 28, 4, 128)]


@pytest.mark.parametrize("shape", FLASH_BWD_MAIN,
                         ids=[s[0] for s in FLASH_BWD_MAIN])
def test_flash_bwd_wgmma_at_the_main_shapes(cuda, shape):
    _, b, s, h, hk, d = shape
    assert fa.sm90_design(torch.bfloat16, d) == "wgmma"
    g = torch.Generator(device=cuda).manual_seed(s + h + d)
    f = lambda *sh: torch.randn(*sh, device=cuda, generator=g).bfloat16()
    q, k, v, do = f(b, s, h, d), f(b, s, hk, d), f(b, s, hk, d), \
        f(b, s, h, d)
    o, lse = fa._flash_fwd(q, k, v, d ** -0.5, True, None)
    got = fa._flash_bwd(q, k, v, o, lse, do, d ** -0.5, True, None)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, True)
    for a, r in zip(got, want):
        _flash_close(a, r, torch.bfloat16)
    again = fa._flash_bwd(q, k, v, o, lse, do, d ** -0.5, True, None)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


# -- speculative decoding and engine sampling ------------------------------
# the ragged kernel at the spec engine's shapes: a verify dispatch (8
# slots of k + 1 = 5 live rows, and ragged budgets, in 8-row q blocks) and
# a draft-scan step (one row a slot at block_q 1, dead rows with query_len
# 0 over live contexts), at the 8B target's and the 1B draft's widths
SPEC_ATTN_CASES = [
    # (name, hk, g, d, query lens, context lens, block_q)
    ("verify_8x5", 8, 4, 128, [5] * 8,
     [5, 37, 300, 517, 1024, 1500, 2000, 2048], 8),
    ("verify_ragged", 8, 4, 128, [5, 1, 3, 5, 2],
     [40, 1200, 19, 2048, 700], 8),
    ("draft_scan_d64", 8, 4, 64, [1, 0, 1, 1, 0, 1, 1, 1],
     [1, 300, 517, 1024, 2000, 1500, 33, 2048], 1),
    ("tiny_verify_d32", 2, 2, 32, [5, 3, 1], [9, 40, 57], 5),
    ("tiny_scan_d32", 1, 2, 32, [1, 0, 1], [10, 41, 57], 1),
]


@pytest.mark.parametrize("pools", ["full", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPEC_ATTN_CASES,
                         ids=[c[0] for c in SPEC_ATTN_CASES])
def test_ragged_attention_at_spec_shapes(cuda, case, dtype, pools):
    """The kernel against its plain version on the card at the verify and
    draft-scan shapes: within the attention tolerances (f32 1e-5, bf16
    2e-2), rows of no sequence (padding, dead scan rows) exact zeros and
    every row finite."""
    name, hk, g, d, ql, cl, bq = case
    rng = np.random.default_rng(sum(map(ord, name)) + 19)
    arrays = _case(rng, hk, g, ql, cl, bq, 0, d=d)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    kw = {}
    if pools == "int8":
        kq, vq, ks, vs = _quantized(args)
        args[1:3] = [kq, vq]
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        args[1:3] = [a.to(dtype) for a in args[1:3]]
    args[0] = args[0].to(dtype)
    out = ra.ragged_paged_attention_values(*args, block_q=bq, **kw)
    ref = ra.ragged_paged_attention_values(*args, block_q=bq,
                                           use_kernel=False, **kw)
    tol = dict(atol=2e-2, rtol=0) if dtype != torch.float32 \
        else dict(atol=1e-5, rtol=1e-5)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    seq, _ = ra.token_arrays(arrays[3], arrays[4], arrays[5],
                             arrays[0].shape[0])
    assert bool((out[torch.from_numpy(seq < 0).to(cuda)] == 0).all())


SPEC_JOBS = [(5, 9), (20, 14), (47, 12), (3, 2), (30, 20), (11, 1),
             (16, 17)]


def _spec_jobs(seed=21):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, n), new) for n, new in SPEC_JOBS]


def _spec_pair(dev, dtype):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    target = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                              seed=21).to(dev, dtype)
    draft = LlamaForCausalLM(LlamaConfig.tiny_draft(), device="cpu",
                             seed=22).to(dev, dtype)
    return target, draft


def _spec_engine(model, draft=None, k=4, num_pages=None, **kw):
    from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                                 SpecConfig)
    if draft is not None:
        kw["spec_decode"] = SpecConfig(draft, k=k, num_pages=num_pages)
    return ContinuousBatchingEngine(model, max_batch_size=3, max_seq_len=128,
                                    **kw)


def _spec_serve(eng, jobs):
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in jobs]
    out = eng.run()
    eng.check_invariants()
    assert len(eng._free) == eng.num_pages - 1
    if eng.spec_enabled:
        assert len(eng._d_free) == eng._d_num_pages - 1
    return [out[r] for r in rids]


def _first_divergences(model, jobs, want, got):
    """For each request whose stream ``got`` leaves ``want``: (the index
    of the first differing token, the top-2 gap of ``model``'s logits
    there over the row's max |logit|), the logits of one causal forward
    over the prompt and ``want``'s tokens before it."""
    out = []
    for (prompt, _), a, b in zip(jobs, want, got):
        if a == b:
            continue
        d = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        ids = torch.tensor([list(prompt) + a[:d]], dtype=torch.int32,
                           device=model.device)
        with torch.no_grad():
            row = model(ids)[0, -1].float()
        top = torch.topk(row, 2).values
        out.append((d, float((top[0] - top[1]) / row.abs().max())))
    return out


def _spec_launches(eng, model, draft):
    """The launches a spec engine's run makes: every target dispatch
    (admission, verify) runs each layer's attention once and every RMSNorm
    once, and so does every draft forward (a backfill prefill is one, a
    draft scan K + 1)."""
    L, Ld = model.config.num_hidden_layers, draft.config.num_hidden_layers
    nt = eng.num_admission_dispatches + eng.num_decode_dispatches
    nd = eng.num_draft_prefills + (eng._spec_k + 1) * eng.num_draft_scans
    attn = "ragged_paged_attention_int8kv" if eng._qkv \
        else "ragged_paged_attention"
    return {"rms_norm": (2 * L + 1) * nt + (2 * Ld + 1) * nd,
            attn: L * nt + Ld * nd}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_spec_engine_on_card(cuda, dtype):
    """The tiny spec engine (tiny() with tiny_draft(), k = 4) on the card:
    graphed streams bitwise equal to the eager engine's with equal
    launches, exact by `_spec_launches`; the draft scan one graph replay
    a round; the streams equal the plain engine's (f32: exactly; bf16:
    each first divergence at a near-tie, a top-2 gap below 0.01 of the
    row's max |logit|, since the verify rows take other attention and
    matmul row batches than decode rows); the target as its own draft
    accepts every proposal."""
    from paddle_tpu_torch.ops import reset_launch_counts
    model, draft = _spec_pair(cuda, dtype)
    jobs = _spec_jobs()
    plain = _spec_serve(_spec_engine(model), jobs)
    runs = {}
    for graphs in (True, False):
        eng = _spec_engine(model, draft, _graphs=graphs)
        reset_launch_counts()
        streams = _spec_serve(eng, jobs)
        torch.cuda.synchronize()
        counts = {k: n for k, n in launch_counts.items() if n}
        assert counts == _spec_launches(eng, model, draft)
        runs[graphs] = (streams, counts, eng.spec_info())
        if graphs:
            scan = eng._draft_scan_program
            assert scan.graph is not None
            assert scan.runs == eng.num_draft_scans
            assert eng.num_spec_rounds >= eng.num_draft_scans > 0
    assert runs[True] == runs[False]
    streams = runs[True][0]
    if dtype == torch.float32:
        assert streams == plain
    else:
        assert all(gap < 0.01 for _, gap in
                   _first_divergences(model, jobs, plain, streams))
    if dtype == torch.float32:
        own = _spec_engine(model, model)
        assert _spec_serve(own, jobs) == plain
        assert own.spec_info()["acceptance_rate"] == 1.0


@pytest.mark.parametrize("mode", ["int8", "draft_pool", "preemption"])
def test_tiny_spec_engine_modes_on_card(cuda, mode):
    """f32 on the card: int8 weights and KV (the draft pools int8 too),
    an undersized draft pool (slots ride rounds as plain rows) and a
    forced preemption (the draft cache dropped and backfilled): spec
    streams equal the plain engine's under the same options, graphed
    equal to eager."""
    from paddle_tpu_torch.models.serving import (PoolExhausted,
                                                 QuantServingConfig)
    model, draft = _spec_pair(cuda, torch.float32)
    jobs = _spec_jobs(23)
    kw = dict(quant=QuantServingConfig("int8", "int8")) \
        if mode == "int8" else {}
    plain = _spec_serve(_spec_engine(model, **kw), jobs)
    for graphs in (True, False):
        eng = _spec_engine(model, draft, _graphs=graphs,
                           num_pages=3 if mode == "draft_pool" else None,
                           **kw)
        if mode == "preemption":
            alloc, visits = eng._alloc_page, [0]

            def faulty(slot):
                visits[0] += 1
                if visits[0] == 6:
                    raise PoolExhausted("forced")
                return alloc(slot)
            eng._alloc_page = faulty
        assert _spec_serve(eng, jobs) == plain
        if mode == "preemption":
            assert eng.num_preemptions >= 1
        if mode == "int8":
            assert eng._d_kv[0][0].dtype == torch.int8


def _wrong_accept(monkeypatch):
    """A planted fault: one more proposal accepted than matched, where a
    row has one to accept."""
    from paddle_tpu_torch.models import serving
    right = serving.spec_accept_greedy

    def wrong(greedy, props):
        j, bonus = right(greedy, props)
        return np.minimum(j + 1, (props >= 0).sum(1)).astype(np.int32), bonus
    monkeypatch.setattr(serving, "spec_accept_greedy", wrong)


def test_tiny_spec_checks_catch_planted_faults(cuda, monkeypatch):
    """The checks above catch their planted faults on the card: a wrong
    accepted count breaks the streams' equality with the plain engine's,
    and a draft scan without its catch-up step breaks self-draft
    acceptance 1.0."""
    model, draft = _spec_pair(cuda, torch.float32)
    # long streams: holes in the draft cache to attend
    jobs = [(p, 40) for p, _ in _spec_jobs()[:5]]
    plain = _spec_serve(_spec_engine(model), jobs)
    own = _spec_engine(model, model)
    own._build_draft_scan = lambda: type(own)._build_draft_scan(
        own, catch_up=False)
    assert _spec_serve(own, jobs) == plain
    assert own.spec_info()["acceptance_rate"] < 1.0
    _wrong_accept(monkeypatch)
    assert _spec_serve(_spec_engine(model, draft), jobs) != plain


def test_tiny_spec_round_makes_two_host_reads(cuda):
    """Spec rounds under ``torch.cuda.set_sync_debug_mode("warn")`` with
    `_harvest_sync` let through and counted: a round whose programs all
    replay (no warm-up, no capture in it) reads from the card exactly
    twice, the proposals and the verify picks, and nothing else
    synchronizes (no warning)."""
    import warnings
    model, draft = _spec_pair(cuda, torch.float32)
    eng = _spec_engine(model, draft)
    for p, n in _spec_jobs()[:3]:
        eng.add_request(p, max_new_tokens=40)
    reads, read = [0], eng._harvest_sync

    def counted(t):
        reads[0] += 1
        torch.cuda.set_sync_debug_mode("default")
        try:
            return read(t)
        finally:
            torch.cuda.set_sync_debug_mode("warn")
    checked = 0
    for _ in range(30):
        captures, rounds = eng.num_graph_captures, eng.num_spec_rounds
        n_progs = len(eng._programs())
        torch.cuda.synchronize()
        eng._harvest_sync = counted
        reads[0] = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
                eng._harvest_sync = read
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        if eng.num_spec_rounds == rounds + 1 \
                and eng.num_graph_captures == captures \
                and n_progs == len(eng._programs()):
            assert reads[0] == 2 and not syncs, (reads, syncs)
            checked += 1
    assert checked >= 3


def test_tiny_sampling_engine_on_card(cuda):
    """Sampling on the card: one seed gives one stream, graphed and eager
    bitwise equal (the draw's key rides in the program's input), another
    seed another; ``top_k=1`` equals the greedy engine; the legacy path
    likewise; exact launches."""
    from paddle_tpu_torch.ops import reset_launch_counts
    model, _ = _spec_pair(cuda, torch.bfloat16)
    jobs = _spec_jobs(25)
    kw = dict(do_sample=True, temperature=0.8, top_p=0.9)
    for impl in ("ragged", "legacy"):
        runs = {}
        for seed, graphs in ((0, True), (0, False), (0, True), (1, True)):
            eng = _spec_engine(model, attention_impl=impl, seed=seed,
                               _graphs=graphs, **kw)
            reset_launch_counts()
            runs.setdefault((seed, graphs), []).append(
                (_spec_serve(eng, jobs), dict(launch_counts)))
        a, b, c, d = runs[0, True][0], runs[0, False][0], \
            runs[0, True][1], runs[1, True][0]
        assert a == b == c and d[0] != a[0]
        greedy = _spec_serve(_spec_engine(model, attention_impl=impl), jobs)
        assert _spec_serve(_spec_engine(model, attention_impl=impl,
                                        top_k=1, **kw), jobs) == greedy


def test_checkpoint_group_of_card_tensors(cuda, tmp_path):
    """A state dict of card tensors through the pinned staging buffers:
    an array of several 64 MiB chunks, bf16 and small ones, written,
    re-hashed and read back bitwise onto the card; the digests equal the
    CPU copies' (the bytes that left the card are the bytes hashed)."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed.checkpoint import storage
    gen = torch.Generator(device="cuda").manual_seed(0)
    sd = {"big": torch.randn(3 * storage.CHUNK // 2 + 7, device=cuda,
                             generator=gen).to(torch.bfloat16),
          "w": torch.randn(33, 65, device=cuda, generator=gen),
          "i": torch.arange(17, device=cuda), "n": 4}
    path = str(tmp_path / "g")
    ckpt.save_state_dict(sd, path)
    cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in sd.items()}
    assert storage.checksums(sd) == storage.checksums(cpu)
    assert storage.stored_checksums(path, storage.read_metadata(path)) \
        == storage.checksums(cpu)
    target = {k: torch.zeros_like(v) for k, v in sd.items()
              if torch.is_tensor(v)}
    ckpt.load_state_dict(target, path)
    raw = ckpt.load_state_dict_raw(path)
    for k, v in target.items():
        assert v.is_cuda and v.equal(sd[k]) and raw[k].equal(sd[k]), k
    assert raw["n"].is_cuda and raw["n"].item() == 4


def test_elastic_resume_on_card_is_bitwise(cuda, tmp_path):
    """A tiny bf16 Llama with f32 masters on the card: 4 AdamW steps
    straight through equal 2, `ElasticManager.save`, fresh objects,
    `resume` and 2 more, bitwise (losses and parameters)."""
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 65))).to(cuda)

    def build(seed):
        m = LlamaForCausalLM(LlamaConfig.tiny(), device=cuda,
                             dtype=torch.bfloat16, seed=seed)
        o = AdamW(learning_rate=1e-3, parameters=m.parameters(),
                  multi_precision=True)
        return m, o, TrainStep(m, o, loss_fn=lambda mm, a, b: mm(
            a, labels=b)[0])

    def run(resume):
        m, o, step = build(0)
        losses = []
        for i in range(4):
            if resume and i == 2:
                em = ElasticManager(str(tmp_path), save_interval_steps=1)
                em.save(1, m, o)
                m, o, step = build(5)
                assert em.resume(m, o) == 2
            losses.append(float(step(ids[:, :-1], ids[:, 1:])))
        return losses, [p.detach().clone() for p in m.parameters()]

    (la, pa), (lb, pb) = run(False), run(True)
    assert la == lb
    assert all(a.equal(b) for a, b in zip(pa, pb))
