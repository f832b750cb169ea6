"""The sm90 varlen forward at 128 and 64 keys a stage, timed in turns on one
card.

    python3 -m paddle_tpu_torch.tools.varlen_key_tile

`csrc/flash_varlen_sm90.cu` takes ``kVfKeys`` = 128 keys a forward stage
(two tiles of the segment tile plan). This builds a copy of the source with
64 (one tile) into ``build/paddle_tpu_torch/`` (the package's kernels are
not touched), holds each width against the plain forward at a packed
4096-token case (o at `KERNEL_LIMITS`, lse within 1e-3), and times the two
in turns (128, 64, 64, 128; CUDA-event median of 20 launches each, on one
plan computed before) there and at the packed pretraining shape (B=2,
S=8192, H=32, HK=8, D=128), both causal bf16 over seeded documents of
64-2048 tokens. One ``key_tile {...}`` line a shape, then the card's name
and power limit. Needs one CUDA card and nvcc; without a card it exits
non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np

_KEYS = "constexpr int kVfKeys = 128;"
# (label, B, S, H, HK, D, held to the plain forward)
SHAPES = (("packed_4096", 1, 4096, 32, 8, 128, True),
          ("pretrain_8b", 2, 8192, 32, 8, 128, False))


def _entries() -> dict:
    """{keys a stage: the forward's C entry built with it}: the package's
    library (128) and the copy with 64, built side by side."""
    from ..ops import _build
    from ..ops import flash_varlen as fv
    src = (_build.CSRC / "flash_varlen_sm90.cu").read_text()
    if _KEYS not in src:
        raise RuntimeError(f"varlen_key_tile: {_KEYS!r} not found in "
                           f"csrc/flash_varlen_sm90.cu")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "flash_varlen_keys64.cu"
    lib = _build.BUILD_DIR / "libflash_varlen_keys64.so"
    cu.write_text(src.replace(_KEYS, "constexpr int kVfKeys = 64;"))
    # the copy includes the package's headers (csrc/*.cuh)
    copy = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                             str(_build.CSRC), "-o", str(lib), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {128: _build.kernel_fn("flash_varlen_sm90", "pdt_varlen_fwd_sm90",
                                 fv._FWD_SM90_ARGTYPES)}
    log = copy.communicate()[0]
    if copy.returncode:
        raise RuntimeError(f"varlen_key_tile: nvcc failed:\n"
                           f"{log.decode()[-4000:]}")
    fns[64] = ctypes.CDLL(str(lib)).pdt_varlen_fwd_sm90
    fns[64].argtypes, fns[64].restype = fv._FWD_SM90_ARGTYPES, ctypes.c_int
    return fns


def _segments(b, s, seed):
    """(B, S) int32 ids of seeded documents of 64-2048 tokens filling each
    row (the last one cut to fit)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(b):
        lens = []
        while sum(lens) < s:
            lens.append(int(rng.integers(64, 2049)))
        lens[-1] -= sum(lens) - s
        rows.append(np.repeat(np.arange(len(lens)), lens))
    return np.stack(rows).astype(np.int32)


def key_tile(fns, label, b, s, h, hk, d, check) -> dict:
    import torch
    from ..ops import flash_attention as fa
    from ..ops import flash_varlen as fv
    from ..ops import kernel_errors
    from .time_flash import _time_ms
    gen = torch.Generator(device="cuda").manual_seed(s)
    f = lambda *sh: torch.randn(*sh, device="cuda",
                                generator=gen).bfloat16()
    q, k, v = f(b, s, h, d), f(b, s, hk, d), f(b, s, hk, d)
    seg = torch.from_numpy(_segments(b, s, s)).cuda()
    plan = fv._varlen_plan(seg, seg, True)

    def fwd(keys):
        o = torch.empty_like(q)
        lse = torch.empty(b, h, s, dtype=torch.float32, device="cuda")
        err = fns[keys](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        seg.data_ptr(), seg.data_ptr(), plan.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), 1,
                        *fv._dims(q, k, d ** -0.5, True))
        if err:
            raise RuntimeError(f"varlen_key_tile: launch failed: CUDA "
                               f"error {err}")
        return o, lse

    lim = fa.KERNEL_LIMITS[torch.bfloat16]
    rec = dict(case=label, B=b, S=s, H=h, HK=hk, D=d,
               documents=[int(r.max()) + 1 for r in seg])
    outs = {keys: fwd(keys) for keys in fns}
    ref = fv.flash_attention_varlen_ref(q, k, v, seg, seg, True) if check \
        else outs[128]
    for keys, (o, lse) in outs.items():
        rel, row = kernel_errors(o, ref[0])
        lse_err = (lse - ref[1]).abs().max().item()
        if rel > lim["rel"] or row > lim["row"] or lse_err > 1e-3:
            raise AssertionError(f"varlen_key_tile: {keys} keys a stage "
                                 f"disagree at {label}: rel {rel}, row "
                                 f"{row}, lse {lse_err}")
        rec[f"rel_row_errors_{keys}"] = [rel, row]
    rec["held_to"] = "plain forward" if check else "the 128-key forward"
    runs = {128: [], 64: []}
    for keys in (128, 64, 64, 128):
        runs[keys].append(_time_ms(lambda: fwd(keys)))
    for keys, r in runs.items():
        rec[f"ms_{keys}"] = statistics.median(r)
        rec[f"ms_runs_{keys}"] = r
    return rec


def main(argv=None) -> int:
    import torch
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("varlen_key_tile: needs a CUDA card", file=sys.stderr)
        return 2
    fns = _entries()
    for shape in SHAPES:
        print("key_tile " + json.dumps(key_tile(fns, *shape)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
