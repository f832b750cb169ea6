"""The dense flash backward's wgmma kernels against an earlier checkout's,
in turns on one card.

    python3 -m paddle_tpu_torch.tools.flash_bwd_before --before DIR

``DIR`` holds an unpacked earlier checkout (for example ``git archive
<commit> | tar -x -C build/before``); its `ops` package loads beside this
one under another name and builds its own ``csrc/``. At the Llama-3-8B
training slice (B=2, S=2048, H=32, HK=8, D=128), the bench recipe's shape
(B=8, H=16, HK=8, D=64) and Qwen2-MoE-A14B's attention (B=1, S=4096,
H=28, HK=4, D=128), causal bf16 from a seed, the two checkouts'
`_flash_bwd_dq` (forming delta from o, as the main path runs it),
`_flash_bwd_dkv` and `_flash_bwd` (the whole backward) run on the same
inputs: each output first held against the other checkout's (bitwise,
or within `ops.flash_attention.KERNEL_LIMITS`), then each timed as the
median of 20 launches by CUDA events (one call between two events, host
time included, as the smoke's ``ms``), in turns (before, now, now,
before: medians of the turns), beside SDPA's backward on the same
inputs. One ``flash_bwd_before {...}`` line a shape, then the card's
name and power limit. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

from .norm_host_path import before_ops
from .time_flash import _time_ms

# (label, B, S, H, HK, D)
SHAPES = (("slice_8b", 2, 2048, 32, 8, 128), ("bench", 8, 2048, 16, 8, 64),
          ("gqa7_a14b", 1, 4096, 28, 4, 128))


def _calls(fa, q, k, v, do, o, lse, scale):
    import torch
    b, s, h, _ = q.shape

    def dq():
        delta = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
        return fa._flash_bwd_dq(q, k, v, do, lse, delta, scale, True, None,
                                "wgmma", o=o), delta

    def dkv(delta):
        return fa._flash_bwd_dkv(q, k, v, do, lse, delta, scale, True, None,
                                 "wgmma")
    return dq, dkv, lambda: fa._flash_bwd(q, k, v, o, lse, do, scale, True,
                                          None, "wgmma")


def _sdpa_bwd_ms(q, k, v, do):
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    return _time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), dot,
                                                retain_graph=True))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", required=True, type=Path,
                    help="an unpacked earlier checkout of the repository")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_before: needs a CUDA card", file=sys.stderr)
        return 2
    from ..ops import flash_attention as now
    from ..ops import kernel_errors
    before = before_ops(args.before.resolve(), "flash_attention")
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    lim = now.KERNEL_LIMITS[torch.bfloat16]
    for label, b, s, h, hk, d in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(s + h + d)
        f = lambda *shape: torch.randn(*shape, device="cuda",
                                       generator=gen).bfloat16()
        q, k, v, do = f(b, s, h, d), f(b, s, hk, d), f(b, s, hk, d), \
            f(b, s, h, d)
        scale = d ** -0.5
        o, lse = now._flash_fwd(q, k, v, scale, True, None)
        sides = {"before": _calls(before, q, k, v, do, o, lse, scale),
                 "now": _calls(now, q, k, v, do, o, lse, scale)}
        got = {name: c[2]() for name, c in sides.items()}
        torch.cuda.synchronize()
        bitwise = all(torch.equal(x, y) for x, y in zip(got["before"],
                                                        got["now"]))
        errs = [kernel_errors(x, y) for x, y in zip(got["now"],
                                                    got["before"])]
        if not all(e[0] <= lim["rel"] and e[1] <= lim["row"] for e in errs):
            raise AssertionError(f"flash_bwd_before: {label}: the two "
                                 f"checkouts disagree: {errs}")
        runs = {name: {"dq": [], "dkv": [], "bwd": []} for name in sides}
        for name in ("before", "now", "now", "before"):
            dq, dkv, whole = sides[name]
            _, delta = dq()
            runs[name]["dq"].append(_time_ms(dq))
            runs[name]["dkv"].append(_time_ms(lambda: dkv(delta)))
            runs[name]["bwd"].append(_time_ms(whole))
        rec = dict(shape=label, B=b, S=s, H=h, HK=hk, D=d, dtype="bfloat16",
                   causal=True, bitwise_equal=bitwise,
                   rel_row_errors=dict(zip(("dq", "dk", "dv"), errs)),
                   sdpa_bwd_ms=_sdpa_bwd_ms(q, k, v, do), runs=runs)
        for name, r in runs.items():
            rec[name] = dict(dq_ms=statistics.median(r["dq"]),
                             dkv_ms=statistics.median(r["dkv"]),
                             whole_bwd_ms=statistics.median(r["bwd"]))
        print("flash_bwd_before " + json.dumps(rec), flush=True)
        del q, k, v, do, o, lse, got, sides
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
