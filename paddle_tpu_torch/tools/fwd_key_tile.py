"""The wgmma flash forward at 128 and 64 keys a tile, timed in turns on one
card.

    python3 -m paddle_tpu_torch.tools.fwd_key_tile

`csrc/flash_fwd_sm90.cu` takes ``kFwdKeys`` = 128 keys a tile at both head
dims. This builds a copy of the source with 64 in its place into
``build/paddle_tpu_torch/`` (the package's kernels are not touched), holds
each width against the plain forward (o at `KERNEL_LIMITS`, lse within
1e-3) and times the two in turns (128, 64, 64, 128; CUDA-event median of 20
launches each) at the shapes `chip_smoke.py` times, causal: the Llama-3-8B
training slice (B=2, S=2048, H=32, HK=8, D=128) in bf16 and f16, the bench
recipe's shape (B=8, H=16, HK=8, D=64) and Qwen2-MoE-A14B's attention
(B=1, S=4096, H=28, HK=4, D=128). One ``key_tile {...}`` line a shape, then
the card's name and power limit. Needs one CUDA card and nvcc; without a
card it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

_KEYS = "constexpr int kFwdKeys = 128;"
SHAPES = (("slice_8b", 2, 2048, 32, 8, 128, "bfloat16"),
          ("bench", 8, 2048, 16, 8, 64, "bfloat16"),
          ("slice_8b_f16", 2, 2048, 32, 8, 128, "float16"),
          ("gqa7_a14b", 1, 4096, 28, 4, 128, "bfloat16"))


def _entries() -> dict:
    """{keys a tile: the C entry of the forward built with it}: the
    package's library (128) and the copy with 64, built side by side."""
    from ..ops import _build
    from ..ops import flash_attention as fa
    src = (_build.CSRC / "flash_fwd_sm90.cu").read_text()
    if _KEYS not in src:
        raise RuntimeError(f"fwd_key_tile: {_KEYS!r} not found in "
                           f"csrc/flash_fwd_sm90.cu")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "flash_fwd_keys64.cu"
    lib = _build.BUILD_DIR / "libflash_fwd_keys64.so"
    cu.write_text(src.replace(_KEYS, "constexpr int kFwdKeys = 64;"))
    # the copy includes the package's headers (csrc/*.cuh)
    copy = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                             str(_build.CSRC), "-o", str(lib), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {128: _build.kernel_fn("flash_fwd_sm90", "pdt_flash_fwd_sm90",
                                 fa._FWD_ARGTYPES)}
    log = copy.communicate()[0]
    if copy.returncode:
        raise RuntimeError(f"fwd_key_tile: nvcc failed:\n"
                           f"{log.decode()[-4000:]}")
    fns[64] = ctypes.CDLL(str(lib)).pdt_flash_fwd_sm90
    fns[64].argtypes, fns[64].restype = fa._FWD_ARGTYPES, ctypes.c_int
    return fns


def key_tile(fns, label, b, s, h, hk, d, dtype) -> dict:
    import torch
    from ..ops import flash_attention as fa
    from ..ops import kernel_errors
    from .time_flash import _time_ms
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    f = lambda *sh: torch.randn(*sh, device="cuda", generator=gen).to(dt)
    q, k, v = f(b, s, h, d), f(b, s, hk, d), f(b, s, hk, d)

    def fwd(keys):
        o = torch.empty_like(q)
        lse = torch.empty(b, h, s, dtype=torch.float32, device="cuda")
        err = fns[keys](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr(),
                        *fa._dims(q, k, d ** -0.5, True, None))
        if err:
            raise RuntimeError(f"fwd_key_tile: launch failed: CUDA error "
                               f"{err}")
        return o, lse

    ro, rlse = fa.flash_attention_ref(q, k, v, True)
    lim = fa.KERNEL_LIMITS[dt]
    rec = dict(case=label, B=b, S=s, H=h, HK=hk, D=d, dtype=dtype)
    for keys in fns:
        o, lse = fwd(keys)
        rel, row = kernel_errors(o, ro)
        lse_err = (lse - rlse).abs().max().item()
        if rel > lim["rel"] or row > lim["row"] or lse_err > 1e-3:
            raise AssertionError(f"fwd_key_tile: {keys} keys a tile "
                                 f"disagree at {label}: rel {rel}, row "
                                 f"{row}, lse {lse_err}")
        rec[f"rel_row_errors_{keys}"] = [rel, row]
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
        print("fwd_key_tile: needs a CUDA card", file=sys.stderr)
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
