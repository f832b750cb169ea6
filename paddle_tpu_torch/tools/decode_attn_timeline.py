"""Where a launch of the split decode attention spends its time, on one card.

    python3 -m paddle_tpu_torch.tools.decode_attn_timeline

Builds two copies of `csrc/ragged_paged_attention.cu` against edited copies
of `csrc/decode_attention.cuh` into ``build/paddle_tpu_torch/decode_attn/``
(the package's kernels are not touched): ``no_loads`` (no stage is copied
in: the CUDA-core kernel computes on whatever its ring holds) and
``no_compute`` (the stages are copied in and never computed). It times them
beside the package's kernel at the Llama-3-8B decode batch (8 slots,
contexts 1..2048, H 32, HK 8, D 128, 16-token pages, bf16) and at one
sequence of 2048 keys in one split, where one block a KV head walks 64
stages alone (the time of a stage). Then the package's kernels: the decode
batch at the plan's split and at 4, 8 and 32 pages a split, the tensor-core
kernel forced onto the same decode rows, and the mixed admission batch of
`chip_smoke.py` (976 rows, block_q 8) at the plan's split and at 16 and 32
pages. Times are `torch.profiler` device time of the split kernel, the
mean of 20 launches on warm caches. One ``decode_attn {...}`` line a
reading, then the card's name and power limit. Needs one CUDA card and
nvcc; without a card it exits non-zero.
"""
from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys

import numpy as np

H, HK, D, PS = 32, 8, 128, 16
DECODE = [(1, c) for c in (1, 33, 300, 517, 1024, 1500, 2000, 2048)]
ADMISSION = [(600, 600), (300, 1100), (1, 900), (0, 0), (37, 37), (1, 1),
             (0, 0), (0, 0)]
# (edited line, its replacement) of csrc/decode_attention.cuh
VARIANTS = {
    "no_loads": [
        ("    if (i < nst)\n      cc_stage<KV>",
         "    if (false)\n      cc_stage<KV>"),
        ("      if (ni < nst)\n        cc_stage<KV>",
         "      if (false)\n        cc_stage<KV>"),
        ("    mbar_wait(smem_addr(bars + i % n_stages), (i / n_stages) & 1);\n",
         "")],
    "no_compute": [("for (int s0 = 0; s0 < steps; s0 += GS) {",
                    "for (int s0 = 0; s0 < 0; s0 += GS) {")],
}


def _entries() -> dict:
    """{variant: the C entry of the split design}: the package's library
    and the edited copies, built side by side."""
    from ..ops import _build
    from ..ops import ragged_paged_attention as ra
    head = (_build.CSRC / "decode_attention.cuh").read_text()
    src = (_build.CSRC / "ragged_paged_attention.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = head
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"decode_attn_timeline: {old!r} not found "
                                   f"in csrc/decode_attention.cuh")
            text = text.replace(old, new)
        out = _build.BUILD_DIR / "decode_attn" / name
        out.mkdir(parents=True, exist_ok=True)
        # the edited header beside the copy is the one its include finds
        (out / "decode_attention.cuh").write_text(text)
        (out / "ragged_paged_attention.cu").write_text(src)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / "lib.so"), str(out / "ragged_paged_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out / "lib.so")
    fns = {"kernel": _build.kernel_fn("ragged_paged_attention",
                                      "pdt_ragged_attention_split",
                                      ra._SPLIT_ARGTYPES)}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"decode_attn_timeline: nvcc failed on "
                               f"{name}:\n{log.decode()[-4000:]}")
        fn = ctypes.CDLL(str(lib)).pdt_ragged_attention_split
        fn.argtypes, fn.restype = ra._SPLIT_ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


def _case(seqs, block_q, tail, seed):
    """A ragged batch over shuffled pages, as `chip_smoke.attn_case`."""
    import torch
    from ..ops import ragged_paged_attention as ra
    ql = np.array([s[0] for s in seqs], np.int32)
    cl = np.array([s[1] for s in seqs], np.int32)
    qs, total = ra.pack_ragged_starts(ql, block_q)
    t = total + tail
    need = [-(-int(c) // PS) for c in cl]
    n_pages = sum(need) + 1
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    bt = np.zeros((len(seqs), max(need)), np.int32)
    k = 0
    for s, n in enumerate(need):
        bt[s, :n] = perm[k:k + n]
        k += n
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = lambda *sh: torch.randn(*sh, device="cuda", generator=gen).to(
        torch.bfloat16)
    return [f(t, H, D), f(HK, n_pages, PS, D), f(HK, n_pages, PS, D)] + [
        torch.from_numpy(a).cuda() for a in (qs, ql, cl, bt)]


def _launch(fn, args, block_q, plan, tensor_cores):
    import torch
    from ..ops import ragged_paged_attention as ra
    q, kp, vp, qs, ql, cl, bt = args
    t = q.shape[0]
    o = torch.empty_like(q)
    part = tickets = None
    if plan.n_splits > 1:
        part = torch.empty(t * H * plan.n_splits * (D + 2), device="cuda")
        tickets = ra.split_tickets(q.device, (t // block_q) * HK)
    err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None,
             qs.data_ptr(), ql.data_ptr(), cl.data_ptr(), bt.data_ptr(),
             o.data_ptr(), part.data_ptr() if part is not None else None,
             tickets.data_ptr() if tickets is not None else None, t, H, HK,
             D, kp.shape[1], PS, bt.shape[0], bt.shape[1], block_q,
             ra.TC_ROWS if tensor_cores else plan.rows_per_block,
             plan.split_pages, plan.n_splits, int(tensor_cores),
             1 / math.sqrt(D), 0, 1,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decode_attn_timeline: launch failed: CUDA "
                           f"error {err}")
    return o


def _device_us(call, n=20) -> float:
    """Mean device us of the split kernel over n launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if re.search(r"split_(cc|tc)_kernel", e.key):
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            return t / max(e.count, 1)
    raise RuntimeError("decode_attn_timeline: the profiler saw no kernel")


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_attn_timeline: needs a CUDA card", file=sys.stderr)
        return 2
    from ..ops import ragged_paged_attention as ra
    fns = _entries()
    sms = ra.sm_count("cuda")
    scale = 1 / math.sqrt(D)

    def reading(label, args, block_q, plan, tensor_cores, variants):
        out = _launch(fns["kernel"], args, block_q, plan, tensor_cores)
        ref = ra.ragged_paged_attention_ref(*args, scale)
        rec = dict(case=label, block_q=block_q,
                   kernel="tensor_cores" if tensor_cores else "cuda_cores",
                   split_pages=plan.split_pages, n_splits=plan.n_splits,
                   plan_split=plan.split_pages == ra.split_plan(
                       args[0].shape[0] // block_q, HK, block_q * H // HK,
                       args[6].shape[1], PS, plan.kernel, sms).split_pages,
                   max_abs_err=(out.float() - ref.float()).abs().max().item())
        for name in variants:
            rec[f"{name}_us"] = _device_us(lambda: _launch(
                fns[name], args, block_q, plan, tensor_cores))
        print("decode_attn " + json.dumps(rec), flush=True)

    decode = _case(DECODE, 1, 0, 1)
    lone = _case([(1, 2048)], 1, 0, 2)
    pps = decode[6].shape[1]
    plan = ra.split_plan(len(DECODE), HK, H // HK, pps, PS, "cuda_cores",
                         sms)
    every = ("kernel", "no_loads", "no_compute")
    reading("lone_2048_one_split", lone, 1,
            plan._replace(split_pages=pps, n_splits=1), False, every)
    reading("decode", decode, 1, plan, False, every)
    for sp in (4, 8, 32):
        reading("decode", decode, 1,
                plan._replace(split_pages=sp, n_splits=-(-pps // sp)),
                False, ("kernel",))
    reading("decode", decode, 1, plan, True, ("kernel",))
    adm = _case(ADMISSION, 8, 16, 3)
    pps = adm[6].shape[1]
    plan = ra.split_plan(adm[0].shape[0] // 8, HK, 8 * H // HK, pps, PS,
                         "tensor_cores", sms)
    for sp in sorted({plan.split_pages, 16, 32}):
        reading("admission", adm, 8,
                plan._replace(split_pages=sp, n_splits=-(-pps // sp)),
                True, ("kernel",))
    print(subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
