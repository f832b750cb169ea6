"""Where a tile's time goes in the wgmma flash backward, on one card.

    python3 -m paddle_tpu_torch.tools.flash_bwd_timeline

Builds a copy of `csrc/flash_bwd_sm90.cu` with ``clock64`` stamps into
``build/paddle_tpu_torch/`` (the stamps are text inserted into the copy;
the package's kernels are not touched) and runs its dQ and dK/dV kernels,
bf16, at the Llama-3-8B training slice (B=2, S=2048, H=32, HK=8, D=128,
causal) and the bench recipe's shape (B=8, H=16, HK=8, D=64). Lane 0 of
each consumer warpgroup of block 0 stamps four points of every tile:
before and after the wait for the tile's data, after the S and dP
products, after the dQ (or dK/dV) products. One ``timeline {...}`` line a
kernel and warpgroup gives the median cycles a tile of ``wait`` (the
data), ``sdp`` (the S and dP products), ``rest`` (the element work and
the second products) and ``tile`` (from one tile to the next).

Then ``split {...}``: the dK/dV kernel at G = 7, S = 4096 (B=1, H=28,
HK=4, D=128: Qwen2-MoE-A14B's attention), CUDA-event median of 20
launches with the head split that `ops.flash_attention.dkv_splits`
picks and with none. Needs one CUDA card and nvcc; without a card it
exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from unittest import mock

# (marker in the source, stamp inserted after it); each must occur once a
# kernel, or the source has moved on and the tool says so
_STAMPS = [
    ("      mbar_wait(full + 8 * st, (it / NS) & 1);\n",
     "      stamp(wg, it, 1);\n"),
    ("        reg_fence(sc);\n        reg_fence(dp);\n",
     "        stamp(wg, it, 2);\n"),
    ("        reg_fence(acc);\n", "        stamp(wg, it, 3);\n"),
    ("        reg_fence(dka);\n", "        stamp(wg, it, 3);\n"),
]
_HEAD = """namespace pdt_sm90 {
__device__ long long* g_stamps = nullptr;
__device__ __forceinline__ void stamp(int wg, int it, int k) {
  if (g_stamps && blockIdx.x == 0 && threadIdx.x % 128 == 0 && it < 64)
    g_stamps[(wg * 64 + it) * 4 + k] = clock64();
}"""
_TAIL = """
extern "C" int pdt_stamps_set(void* p) {
  long long* q = static_cast<long long*>(p);
  return cudaMemcpyToSymbol(pdt_sm90::g_stamps, &q, sizeof(q));
}
"""


def _instrumented_source(src: str) -> str:
    src = src.replace("namespace pdt_sm90 {", _HEAD, 1)
    for marker, stamp in _STAMPS:
        if marker not in src:
            raise RuntimeError(f"flash_bwd_timeline: marker not found in "
                               f"csrc/flash_bwd_sm90.cu: {marker!r}")
        src = src.replace(marker, marker + stamp)
    # the tile's first stamp: before the wait for its data
    src = src.replace("      mbar_wait(full + 8 * st, (it / NS) & 1);\n",
                      "      stamp(wg, it, 0);\n"
                      "      mbar_wait(full + 8 * st, (it / NS) & 1);\n")
    return src + _TAIL


def _build_library():
    from ..ops import _build
    src = _instrumented_source(
        (_build.CSRC / "flash_bwd_sm90.cu").read_text())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "flash_bwd_timeline.cu"
    lib = _build.BUILD_DIR / "libflash_bwd_timeline.so"
    cu.write_text(src)
    # the copy includes the package's headers (csrc/*.cuh)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib), str(cu)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def _phases(t):
    """Median cycles a tile of each phase, from one warpgroup's stamps."""
    rows = [x for x in t if x[0] and x[3]]
    med = lambda a, b: statistics.median(x[b] - x[a] for x in rows)
    step = [b[0] - a[0] for a, b in zip(rows, rows[1:])]
    return dict(tiles=len(rows), wait=med(0, 1), sdp=med(1, 2),
                rest=med(2, 3), tile=statistics.median(step))


def timeline(lib, label, b, s, h, hk, d) -> list:
    import torch
    from ..ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    f = lambda *sh: torch.randn(*sh, device="cuda", generator=gen).bfloat16()
    q, k, v, do = f(b, s, h, d), f(b, s, hk, d), f(b, s, hk, d), \
        f(b, s, h, d)
    scale = d ** -0.5
    o, lse = fa._flash_fwd(q, k, v, scale, True, None)
    delta = fa._delta(o, do)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dims = fa._dims(q, k, scale, True, None)
    fq, fkv = lib.pdt_flash_bwd_dq_sm90, lib.pdt_flash_bwd_dkv_sm90
    fq.argtypes, fkv.argtypes = fa._DQ_SM90_ARGTYPES, fa._DKV_SM90_ARGTYPES
    fq.restype = fkv.restype = ctypes.c_int
    base = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    calls = {"dq": lambda: fq(*base, None, dq.data_ptr(), *dims),
             "dkv": lambda: fkv(*base, dk.data_ptr(), dv.data_ptr(), None, 1,
                                *dims)}
    buf = torch.zeros(2 * 64 * 4, dtype=torch.int64, device="cuda")
    lib.pdt_stamps_set(ctypes.c_void_p(buf.data_ptr()))
    out = []
    for name, call in calls.items():
        for _ in range(3):   # the last run's stamps
            buf.zero_()
            if call():
                raise RuntimeError(f"{name} launch failed")
            torch.cuda.synchronize()
        stamps = buf.view(2, 64, 4).tolist()
        for wg in range(2):
            out.append(dict(case=label, kernel=name, warpgroup=wg,
                            **_phases(stamps[wg])))
    lib.pdt_stamps_set(None)
    return out


def split_check() -> dict:
    import torch
    from ..ops import flash_attention as fa
    from .time_flash import _time_ms
    b, s, h, hk, d = 1, 4096, 28, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(7)
    f = lambda *sh: torch.randn(*sh, device="cuda", generator=gen).bfloat16()
    q, k, v, do = f(b, s, h, d), f(b, s, hk, d), f(b, s, hk, d), \
        f(b, s, h, d)
    scale = d ** -0.5
    o, lse = fa._flash_fwd(q, k, v, scale, True, None)
    delta = fa._delta(o, do)
    run = lambda: fa._flash_bwd_dkv(q, k, v, do, lse, delta, scale, True,
                                    None)
    props = torch.cuda.get_device_properties(q.device)
    splits = fa.dkv_splits(b, s, hk, h // hk, props.multi_processor_count)
    split_ms = _time_ms(run)
    with mock.patch.object(fa, "dkv_splits", lambda *a: 1):
        unsplit_ms = _time_ms(run)
    return dict(B=b, S=s, H=h, HK=hk, D=d, splits=splits,
                split_ms=split_ms, unsplit_ms=unsplit_ms)


def main(argv=None) -> int:
    import torch
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("flash_bwd_timeline: needs a CUDA card", file=sys.stderr)
        return 2
    lib = _build_library()
    for shape in (("slice_8b", 2, 2048, 32, 8, 128),
                  ("bench", 8, 2048, 16, 8, 64)):
        for rec in timeline(lib, *shape):
            print("timeline " + json.dumps(rec), flush=True)
    print("split " + json.dumps(split_check()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
