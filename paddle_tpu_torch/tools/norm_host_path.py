"""Host time of the norm forwards' launch path: this checkout's wrappers
against an earlier checkout's, in turns on one card.

    python3 -m paddle_tpu_torch.tools.norm_host_path --before DIR

``DIR`` holds an unpacked earlier checkout (for example ``git archive
<commit> | tar -x -C build/before``). Its `ops` package is loaded beside
this one under another name, so its `_build` builds its own ``csrc/``
into ``DIR/build/``, and both sets of wrappers run in one process. At
small shapes, where a call is host time almost entirely (RMSNorm at a
decode step's (8, 4096) bf16, LayerNorm at (8, 768) f32), it times the
entry points (`rms_norm_values`, `layer_norm_values`, no autograd) of
both checkouts and ``torch.nn.functional.rms_norm`` / ``layer_norm``:
``host_us``, the host clock over 200 calls back to back, and ``ms``, one
call between two CUDA events, the callables interleaved rep by rep
(medians of 7 reps). Then the launch path's parts one at a time, host us
a call: the C entry's lookup (`_build.kernel_fn`), the current stream as
a `torch.cuda.Stream` or raw, x reshaped to rows and back, entering and
leaving `torch.cuda.device`, each checkout's input checks, and one
`torch.empty` (a statistics tensor). Each output is first held against
the plain version. One ``host_path {...}`` line a shape, then the card's
name and power limit. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CALLS = 200
REPS = 7


def before_ops(root: Path, module: str):
    """The earlier checkout's `ops.<module>`, its package loaded once as
    ``_before_ops`` (its relative imports, `_build` included, resolve
    inside the earlier checkout, which builds its own ``csrc/``)."""
    if "_before_ops" not in sys.modules:
        ops = root / "paddle_tpu_torch" / "ops"
        spec = importlib.util.spec_from_file_location(
            "_before_ops", ops / "__init__.py",
            submodule_search_locations=[str(ops)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules["_before_ops"] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"_before_ops.{module}")


def _host_us(call) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        call()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / CALLS * 1e6


def _event_ms(call) -> float:
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _in_turns(named: dict, with_ms: bool) -> dict:
    for call in named.values():
        for _ in range(5):
            call()
    got = {k: {"host_us": [], "ms": []} for k in named}
    names = list(named)
    for rep in range(REPS):
        for k in (names if rep % 2 == 0 else names[::-1]):
            got[k]["host_us"].append(_host_us(named[k]))
            if with_ms:
                got[k]["ms"].extend(_event_ms(named[k]) for _ in range(3))
    return {k: {m: statistics.median(v) for m, v in r.items() if v}
            for k, r in got.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", required=True, type=Path,
                    help="an unpacked earlier checkout of the repository")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("norm_host_path: needs a CUDA card", file=sys.stderr)
        return 2
    from ..ops import _build
    from ..ops import norm_kernels as now
    before = before_ops(args.before.resolve(), "norm_kernels")
    F = torch.nn.functional
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for kind, n, h, dt in (("rms_norm", 8, 4096, torch.bfloat16),
                           ("layer_norm", 8, 768, torch.float32)):
        x = torch.randn(n, h, device="cuda", generator=gen).to(dt)
        w = (1 + 0.1 * torch.randn(h, device="cuda", generator=gen)).to(dt)
        b = (0.1 * torch.randn(h, device="cuda", generator=gen)).to(dt)
        if kind == "rms_norm":
            eps = 1e-5
            named = {"before": lambda: before.rms_norm_values(x, w, eps),
                     "now": lambda: now.rms_norm_values(x, w, eps),
                     "library": lambda: F.rms_norm(x, (h,), w, eps)}
            plain = now.rms_norm_ref(x, w, eps)
        else:
            eps = 1e-12
            named = {"before": lambda: before.layer_norm_values(x, w, b,
                                                                eps),
                     "now": lambda: now.layer_norm_values(x, w, b, eps),
                     "library": lambda: F.layer_norm(x, (h,), w, b, eps)}
            plain = now.layer_norm_ref(x, w, b, eps)
        rtol = 1e-5 if dt == torch.float32 else 2 ** -7
        with torch.no_grad():
            for k, call in named.items():
                got = call().float()
                if not torch.allclose(got, plain.float(), rtol=rtol,
                                      atol=rtol):
                    raise AssertionError(f"norm_host_path: {kind} {k} "
                                         f"disagrees with the plain version")
            entries = _in_turns(named, with_ms=True)
        dev = x.get_device()
        sym = "pdt_rms_norm_fwd" if kind == "rms_norm" else \
            "pdt_layer_norm_fwd"
        argtypes = now._ARGTYPES if kind == "rms_norm" else now._LN_ARGTYPES

        def enter_device():
            with torch.cuda.device(dev):
                pass
        parts = _in_turns({
            "kernel_fn_lookup": lambda: _build.kernel_fn(kind, sym,
                                                         argtypes),
            "current_stream": lambda: torch.cuda.current_stream(
                dev).cuda_stream,
            "raw_stream": lambda: now.current_stream(dev),
            "reshape_to_rows_and_back": lambda: x.reshape(-1, h).reshape(
                x.shape),
            "cuda_device_enter_leave": enter_device,
            "checks_before": lambda: before._check(x, w),
            "checks_now": lambda: now._check(x, w),
            "stats_empty": lambda: torch.empty(n, dtype=torch.float32,
                                               device=x.device)},
            with_ms=False)
        rec = dict(kernel=kind, N=n, H=h, dtype=str(dt).split(".")[1],
                   calls=CALLS, reps=REPS, entries=entries,
                   parts_host_us={k: v["host_us"] for k, v in parts.items()})
        print("host_path " + json.dumps(rec), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
