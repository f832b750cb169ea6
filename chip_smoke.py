#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`paddle_tpu_torch`) on one card.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` (``$CUDA_HOME`` or /usr/local/cuda) and the
repository beside this file; it exits non-zero without them and prints
no result. Phases, in order (any failure raises):

1. the card's ``nvidia-smi`` name and power limit;
2. build every kernel of `paddle_tpu_torch/csrc/` (one ``nvcc`` per
   source, in parallel, into ``build/paddle_tpu_torch/``);
3. hold each kernel against its plain PyTorch version on the card, in
   bf16 and f32, at the serving path's shapes (RMSNorm rows of a decode
   step and of an admission batch; ragged attention over a decode batch
   of 8 slots with contexts 1..2048, a mixed admission batch, and a
   windowed batch), with each one's time (CUDA events), its bound, and
   for RMSNorm the time of ``torch.nn.functional.rms_norm``;
4. a tiny Llama served on the card and on the CPU gives equal greedy
   streams;
5. serve 16 seeded requests on `LlamaConfig.llama3_8b()` at full width
   and depth in bf16 through `ContinuousBatchingEngine`, with the
   kernels' launch counts set to 0 before the run and read after it;
6. one admission dispatch of the 8B model through the kernels and
   through the plain versions (``use_kernel=True`` / ``False``).

It prints a ``{"kernels": [...]}`` line, the card line, and last
``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# operations/s by input type
HBM_BPS = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
# one bf16 ulp relative (8 significant bits); f32 sums in another order
TOL = {"bfloat16": dict(rtol=2 ** -7, atol=1e-3),
       "float32": dict(rtol=1e-5, atol=1e-5)}
# attention: the kernel keeps softmax weights in f32, the plain version
# rounds them to the cache dtype before the weighted sum (as the JAX
# core does), so bf16 outputs differ by a few bf16 ulps
ATTN_ATOL = {"bfloat16": 2e-2, "float32": 1e-4}
N_REQUESTS = 16
LLAMA_VOCAB = 128256      # LlamaConfig.llama3_8b().vocab_size


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Median device time of one call, by CUDA events around each."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rms_phase(rows_list, results):
    import torch
    from paddle_tpu_torch.ops import norm_kernels as nk
    lib = getattr(torch.nn.functional, "rms_norm", None)
    gen = torch.Generator(device="cuda").manual_seed(1)
    h, eps = 4096, 1e-5
    for n in rows_list:
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[1]
            x = torch.randn(n, h, device="cuda", generator=gen).to(dt)
            w = (1 + 0.1 * torch.randn(h, device="cuda",
                                       generator=gen)).to(dt)
            out = nk.rms_norm_values(x, w, eps, use_kernel=True)
            ref = nk.rms_norm_ref(x, w, eps)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), **TOL[name])
            ms = time_ms(lambda: nk.rms_norm_values(x, w, eps,
                                                    use_kernel=True))
            plain = time_ms(lambda: nk.rms_norm_ref(x, w, eps))
            lib_ms = None if lib is None else time_ms(
                lambda: lib(x, (h,), w, eps))
            isz = x.element_size()
            nbytes = 2 * n * h * isz + h * isz + 4 * n
            b_ms, b_by = bound(nbytes, 4 * n * h, name)
            rec = dict(kernel="rms_norm", case=f"rows={n}", dtype=name,
                       max_abs_err=err, tol=TOL[name], ms=ms,
                       plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms)
            log("kernel " + json.dumps(rec))
            if not ok:
                raise AssertionError(f"rms_norm kernel disagrees: {rec}")
            results.append(rec)


def attn_case(seqs, block_q, tail_pad, dtype, window, gen):
    """One ragged batch: `seqs` is [(query_len, context_len), ...]."""
    import torch
    from paddle_tpu_torch.ops.ragged_paged_attention import \
        pack_ragged_starts
    H, HK, D, ps = 32, 8, 128, 16
    ql = np.array([s[0] for s in seqs], np.int32)
    cl = np.array([s[1] for s in seqs], np.int32)
    qs, total = pack_ragged_starts(ql, block_q)
    t = total + tail_pad
    need = [-(-int(c) // ps) for c in cl]
    pps = max(need)
    P = sum(need) + 1
    perm = np.random.default_rng(int(t)).permutation(np.arange(1, P))
    bt = np.zeros((len(seqs), pps), np.int32)
    k = 0
    for s, n in enumerate(need):
        bt[s, :n] = perm[k:k + n]
        k += n
    q = torch.randn(t, H, D, device="cuda", generator=gen).to(dtype)
    kp = torch.randn(HK, P, ps, D, device="cuda", generator=gen).to(dtype)
    vp = torch.randn(HK, P, ps, D, device="cuda", generator=gen).to(dtype)
    dev = [torch.from_numpy(a).cuda() for a in (qs, ql, cl, bt)]
    # bytes: q, o, each live K/V page once, descriptors; operations:
    # 2*D for q.k and 2*D for p.v per valid (query head, key) pair
    pages = pairs = 0
    for qlen, ctx in zip(ql, cl):
        if qlen == 0:
            continue
        first = int(ctx) - int(qlen)
        lo = 0 if window is None else max(0, first - window + 1)
        pages += (int(ctx) - 1) // ps - lo // ps + 1
        for p in range(first, int(ctx)):
            pairs += p + 1 if window is None else min(p + 1, window)
    isz = q.element_size()
    nbytes = (2 * t * H * D * isz + pages * 2 * HK * ps * D * isz
              + 4 * (3 * len(seqs) + bt.size))
    ops = pairs * H * 4 * D
    return (q, kp, vp, *dev), nbytes, ops


def attn_phase(results):
    import torch
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention_ref, ragged_paged_attention_values)
    gen = torch.Generator(device="cuda").manual_seed(2)
    decode = [(1, c) for c in (1, 33, 300, 517, 1024, 1500, 2000, 2048)]
    mixed = [(600, 600), (300, 1100), (1, 900), (0, 0), (37, 37),
             (1, 1), (0, 0), (0, 0)]
    cases = [("decode", decode, 1, 0, None),
             ("admission", mixed, 8, 16, None),
             ("windowed", mixed, 8, 16, 256),
             ("decode_windowed", decode, 1, 0, 256)]
    for label, seqs, bq, tail, win in cases:
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[1]
            args, nbytes, ops = attn_case(seqs, bq, tail, dt, win, gen)
            scale = 1.0 / math.sqrt(128)
            run = lambda: ragged_paged_attention_values(
                *args, window=win, block_q=bq, use_kernel=True)
            out = run()
            ref = ragged_paged_attention_ref(*args, scale, win)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ms = time_ms(run)
            plain = time_ms(lambda: ragged_paged_attention_ref(
                *args, scale, win), iters=5, warmup=1)
            b_ms, b_by = bound(nbytes, ops, name)
            rec = dict(kernel="ragged_paged_attention", case=label,
                       dtype=name, block_q=bq, window=win,
                       max_abs_err=err, tol=ATTN_ATOL[name], ms=ms,
                       plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None)
            log("kernel " + json.dumps(rec))
            if not (err <= ATTN_ATOL[name] and torch.isfinite(out).all()):
                raise AssertionError(f"ragged attention kernel disagrees: "
                                     f"{rec}")
            results.append(rec)


def tiny_parity():
    """A tiny f32 Llama served on the card (kernels) and on the CPU
    (plain versions) must give equal greedy streams."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    cfg = LlamaConfig.tiny()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 20, 47, 3)]
    streams = []
    for dev in ("cuda", "cpu"):
        model = LlamaForCausalLM(cfg, device="cpu", seed=3).to(dev)
        eng = ContinuousBatchingEngine(model, max_batch_size=2,
                                       max_seq_len=64, prefill_chunk=16,
                                       device=dev)
        for p in prompts:
            eng.add_request(p, max_new_tokens=8)
        streams.append(eng.run())
    log(f"tiny parity: card {streams[0]} cpu {streams[1]}")
    if streams[0] != streams[1]:
        raise AssertionError("tiny Llama greedy streams differ between "
                             "the card and the CPU")


def make_requests(vocab):
    """The served requests: seeded prompts of 32..1024 tokens, each
    asking for 32..64 new tokens."""
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(N_REQUESTS):
        n = int(rng.integers(32, 1025))
        new = int(rng.integers(32, 65))
        reqs.append((rng.integers(0, vocab, n), new))
    return reqs


def serve_8b():
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    torch.cuda.synchronize()
    log(f"built llama3_8b bf16 on the card in "
        f"{time.perf_counter() - t0:.1f}s "
        f"({cfg.num_params() / 1e9:.2f}B parameters)")
    eng = ContinuousBatchingEngine(model, max_batch_size=8,
                                   max_seq_len=2048)
    if cfg.vocab_size != LLAMA_VOCAB:
        raise AssertionError("llama3_8b vocab changed")
    reqs = make_requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    for p, new in reqs:
        eng.add_request(p, max_new_tokens=new)
    done = []
    while len(done) < N_REQUESTS:
        done += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    L = cfg.num_hidden_layers
    nd = eng.num_dispatches
    by_rid = {r.rid: r for r in done}
    for rid, (_, new) in enumerate(reqs):
        r = by_rid[rid]
        if r.status != "finished" or len(r.output) != new:
            raise AssertionError(f"request {rid}: {r.status} with "
                                 f"{len(r.output)} of {new} tokens")
    eng.check_invariants()
    if len(eng._free) != eng.num_pages - 1:
        raise AssertionError("pages still held after the run")
    want = {"ragged_paged_attention": L * nd, "rms_norm": (2 * L + 1) * nd}
    log(f"launches {counts} expected {want} over {nd} dispatches "
        f"({eng.num_admission_dispatches} admission, "
        f"{eng.num_decode_dispatches} decode)")
    if counts != want:
        raise AssertionError("launch counts do not match the dispatches")
    ttft = sorted(r.first_token_time - r.arrival_time for r in done)
    stats = dict(requests=N_REQUESTS, wall_s=wall,
                 ttft_p50_s=statistics.median(ttft),
                 decode_tokens=eng.decode_tokens,
                 decode_tokens_per_s=eng.decode_tokens / eng.decode_seconds,
                 decode_step_ms=1e3 * eng.decode_seconds
                 / eng.num_decode_dispatches,
                 dispatches=nd,
                 admission_dispatches=eng.num_admission_dispatches,
                 decode_dispatches=eng.num_decode_dispatches,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log("serving " + json.dumps(stats))
    return model, counts, reqs


def path_check(model, reqs):
    """One admission dispatch of the 8B model through the kernels and
    through the plain versions, on fresh pools each."""
    import torch
    from paddle_tpu_torch.models.llama import RaggedKVCacheView
    from paddle_tpu_torch.ops.ragged_paged_attention import \
        pack_ragged_batch
    cfg = model.config
    ps, n_seq = 16, 3
    pieces = [{"seq": s, "tokens": list(reqs[s][0]), "offset": 0,
               "sample": True} for s in range(n_seq)]
    pk = pack_ragged_batch(pieces, n_seq, block_q=8, pad_to=16)
    need = [-(-len(p["tokens"]) // ps) for p in pieces]
    pps = max(need)
    bt = np.zeros((n_seq, pps), np.int32)
    nxt = 1
    for s, n in enumerate(need):
        bt[s, :n] = np.arange(nxt, nxt + n)
        nxt += n
    dev = {k: torch.from_numpy(np.asarray(pk[k])).cuda()
           for k in ("ids", "token_seq", "positions", "query_start",
                     "query_len", "context_len", "sample_rows")}
    bt_d = torch.from_numpy(bt).cuda()
    logits = {}
    for use_kernel in (True, False):
        pools = [tuple(torch.zeros(cfg.num_key_value_heads, nxt, ps,
                                   cfg.head_dim, dtype=torch.bfloat16,
                                   device="cuda") for _ in range(2))
                 for _ in range(cfg.num_hidden_layers)]
        views = [RaggedKVCacheView(k, v, bt_d, dev["token_seq"],
                                   dev["positions"], dev["query_start"],
                                   dev["query_len"], dev["context_len"], 8)
                 for k, v in pools]
        with torch.no_grad():
            logits[use_kernel] = model(dev["ids"][None], views,
                                       rows=dev["sample_rows"],
                                       use_kernel=use_kernel).float()
        del pools, views
    a, b = logits[True], logits[False]
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).tolist()
    log(f"path check: max |logit diff| {diff:.4g} (max |logit| "
        f"{scale:.4g}), argmax agrees per row {agree}, shape "
        f"{tuple(a.shape)}")
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite logits")
    if a.shape != (n_seq, cfg.vocab_size) or diff > 0.1 * scale:
        raise AssertionError("kernel and plain paths disagree")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only "
              "on an NVIDIA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        print("chip_smoke: the paddle_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    results = []
    from paddle_tpu_torch.ops.ragged_paged_attention import \
        pack_ragged_batch
    # the first admission batch of the serving phase: its 8 prompts
    first = [{"seq": s, "tokens": p, "offset": 0}
             for s, (p, _) in enumerate(make_requests(LLAMA_VOCAB)[:8])]
    t_adm = pack_ragged_batch(first, 8, block_q=8, pad_to=16)["t_pad"]
    rms_phase([8, t_adm], results)
    attn_phase(results)
    tiny_parity()
    model, counts, reqs = serve_8b()
    path_check(model, reqs)

    main_case = {"rms_norm": ("rows=8", "bfloat16"),
                 "ragged_paged_attention": ("decode", "bfloat16")}
    meta = {"rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                         "paddle_tpu/ops/norm_kernels.py:45"),
            "ragged_paged_attention": (
                "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                "paddle_tpu/ops/ragged_paged_attention.py:293")}
    kernels = []
    for name, (case, dt) in main_case.items():
        rec = next(r for r in results if r["kernel"] == name
                   and r["case"] == case and r["dtype"] == dt)
        kernels.append(dict(
            name=name, route="cuda", source=meta[name][0],
            replaces=meta[name][1], launches=counts[name],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
