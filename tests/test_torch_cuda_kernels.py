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
dequant matmul: f32 rtol 1e-5 plus atol 1e-5 of the largest |output|
(f32 sums of up to 14336 exact products in another order), bf16 rtol
2^-7 plus atol 2^-8 of the largest |output| (one bf16 rounding of sums
that differ only in order: the widened weights and their products with
bf16 x are exact in f32)."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import launch_counts
from paddle_tpu_torch.ops import norm_kernels as nk
from paddle_tpu_torch.ops import quant_matmul as qm
from paddle_tpu_torch.ops import ragged_paged_attention as ra

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    tol = dict(rtol=2 ** -7, atol=1e-3) if dtype == torch.bfloat16 \
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    tol = dict(atol=2e-2, rtol=0) if dtype == torch.bfloat16 \
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    tol = dict(atol=2e-2, rtol=0) if dtype == torch.bfloat16 \
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


DQ_SHAPES = [(4096, 1024), (256, 384), (4100, 130), (70, 33)]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    top = ref.float().abs().max().item()
    tol = dict(rtol=2 ** -7, atol=2 ** -8 * top) \
        if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5 * top)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


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
        qm.dequant_matmul_values(x.half(), qw, sc)
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
