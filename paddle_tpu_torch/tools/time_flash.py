"""Device time of the three flash attention kernels at several head dims,
on one card.

    python3 -m paddle_tpu_torch.tools.time_flash [--dims 72,80,96,128]

For each head dim, seeded bf16 inputs at the Llama-3-8B training slice
(B=2, S=2048, H=32, HK=8, causal; D=72 at DiT-XL/2's B=32, S=256, H=16,
non-causal) go through the forward, dQ and dK/dV kernels (the launchers
of `ops.flash_attention`), each timed as the median of 20 launches by
CUDA events, and ``delta`` (rowsum(o dO) in PyTorch) beside them. A
head dim whose backward runs the wgmma kernels (`ops.flash_attention.
sm90_design`) also times the mma.sync ones, in turns (mma.sync, wgmma,
wgmma, mma.sync): ``dq_ms`` / ``dkv_ms`` are the path's design,
``previous`` the other. One ``time_flash {...}`` line a head dim. To
hold two trees against each other on one card, run each tree's own copy
of this tool in one call, in turns. Needs one CUDA card; without one it
exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys


def _time_ms(fn, iters=20, warmup=3):
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


def time_dim(d: int) -> dict:
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    if d == 72:
        b, s, h, hk, causal = 32, 256, 16, 16, False
    else:
        b, s, h, hk, causal = 2, 2048, 32, 8, True
    gen = torch.Generator(device="cuda").manual_seed(d)
    f = lambda *shape: torch.randn(*shape, device="cuda",
                                   generator=gen).bfloat16()
    q, k, v, do = f(b, s, h, d), f(b, s, hk, d), f(b, s, hk, d), \
        f(b, s, h, d)
    scale = d ** -0.5
    o, lse = fa._flash_fwd(q, k, v, scale, causal, None)
    delta = fa._delta(o, do)

    def bwd(design):
        return (_time_ms(lambda: fa._flash_bwd_dq(q, k, v, do, lse, delta,
                                                  scale, causal, None,
                                                  _design=design)),
                _time_ms(lambda: fa._flash_bwd_dkv(q, k, v, do, lse, delta,
                                                   scale, causal, None,
                                                   _design=design)))
    out = dict(D=d, B=b, S=s, H=h, HK=hk, causal=causal,
               fwd_ms=_time_ms(lambda: fa._flash_fwd(q, k, v, scale,
                                                     causal, None)),
               delta_ms=_time_ms(lambda: fa._delta(o, do)))
    path = fa.sm90_design(q.dtype, d)
    if path != "wgmma":
        out["dq_ms"], out["dkv_ms"] = bwd(path)
        return out
    runs = {"mma.sync": [], "wgmma": []}
    for design in ("mma.sync", "wgmma", "wgmma", "mma.sync"):
        runs[design].append(bwd(design))
    med = {k: [statistics.median(r[i] for r in v) for i in (0, 1)]
           for k, v in runs.items()}
    out.update(design="wgmma", dq_ms=med["wgmma"][0],
               dkv_ms=med["wgmma"][1],
               previous=dict(design="mma.sync", dq_ms=med["mma.sync"][0],
                             dkv_ms=med["mma.sync"][1]),
               runs=runs)
    return out


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dims", default="72,80,96,128",
                   help="comma-separated head dims")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_flash: needs a CUDA card", file=sys.stderr)
        return 2
    for d in (int(x) for x in args.dims.split(",")):
        print("time_flash " + json.dumps(time_dim(d)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
