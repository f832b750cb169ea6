"""Where a decode call of the LoRA epilogue spends its device time, on one card.

    python3 -m paddle_tpu_torch.tools.lora_timeline
    python3 -m paddle_tpu_torch.tools.lora_timeline --serving [--steps 10]

At the Llama-3-8B decode shapes of the multi-LoRA engine (8 tokens, rank
16, a stack of the base row and three adapters, ids mixing rows 0..3; the
q/o, k/v, gate/up and down products) it records 20 calls of each design of
`csrc/lora_epilogue.cu` into a CUDA graph and replays it under
`torch.profiler`, so the host's wrapper does not pace the device. From the
trace's kernel spans it reads, per call: for the BGMV design its shrink
kernel's time, the gap from the shrink's end to the expand's start, and the
expand's time; for the SGMV design its one kernel's time; and for both the
span from a call's first kernel start to its last kernel end, and the gap
to the next call's first kernel. Medians over the calls, in microseconds,
one ``lora_timeline {...}`` line a shape and design; then the same calls
run eagerly (the host launching each) as ``eager_span_us``, and the card's
name and power limit. Then, for copies of the source with `clock64()`
stamps added (built into ``build/paddle_tpu_torch/lora_stamps/``; the
package's kernel is not touched), each as it is and with one part dropped
(VARIANTS: no shrink, no stores into the other blocks, no expand, no loads
of B, no staging copies, no shrink products; wrong outputs, for timing
only): a graph-timed call and the SM cycles of block
(0, 0)'s first thread at each phase's end, converted at the card's SM clock
(``lora_stamps {...}``). Needs one CUDA card and nvcc; without a card it
exits non-zero.

``--serving`` measures the real decode step instead: `LlamaConfig.llama3_8b()`
in bf16 from seed 0 under `tools.profile_decode.profile_engine`'s multi-LoRA
engine (three seeded rank-16 adapters, 8 requests), profiled over ``--steps``
decode steps once a design, the designs in turns SGMV, BGMV, BGMV, SGMV
(every epilogue of the step routed to the one design). Prints the
``decode_profile`` lines and one ``lora_serving {...}`` line a turn: the
LoRA epilogue's launches and device ms a step, the step's device ms and
wall.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
from unittest import mock

CALLS = 20
SHAPES = (("q_o", 4096, 4096), ("k_v", 4096, 1024),
          ("gate_up", 4096, 14336), ("down", 14336, 4096))
RANK, ROWS, TOKENS = 16, 4, 8


def _kernel_spans(prof):
    """[(name, start us, end us)] of the device kernels in a trace, in
    start order (the chrome trace's "kernel" events)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events
             if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return sorted(spans, key=lambda s: s[1])


def _per_call(spans, per_call):
    """Split the kernel spans into calls of ``per_call`` launches and read
    each call's parts."""
    calls = [spans[i:i + per_call]
             for i in range(0, len(spans) - per_call + 1, per_call)]
    rec = {"span_us": [c[-1][2] - c[0][1] for c in calls],
           "to_next_us": [calls[i + 1][0][1] - calls[i][-1][2]
                          for i in range(len(calls) - 1)]}
    if per_call == 2:
        rec["shrink_us"] = [c[0][2] - c[0][1] for c in calls]
        rec["gap_us"] = [c[1][1] - c[0][2] for c in calls]
        rec["expand_us"] = [c[1][2] - c[1][1] for c in calls]
    return {k: statistics.median(v) for k, v in rec.items() if v}


def timeline(label, k, n, design, gen):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops.lora_epilogue import lora_epilogue_values
    x = torch.randn(TOKENS, k, device="cuda", generator=gen).to(torch.bfloat16)
    a = (torch.randn(ROWS, k, RANK, device="cuda", generator=gen)
         / math.sqrt(k)).to(torch.bfloat16)
    b = (0.1 * torch.randn(ROWS, RANK, n, device="cuda",
                           generator=gen)).to(torch.bfloat16)
    a[0] = 0
    b[0] = 0
    scale = torch.tensor([0.0, 1.0, 0.5, 2.0], device="cuda")
    ids = (torch.arange(TOKENS, device="cuda", dtype=torch.int32) * 3) % ROWS
    y = torch.randn(TOKENS, n, device="cuda").to(torch.bfloat16)

    def call():
        return lora_epilogue_values(x, a, b, scale, ids, use_kernel=True,
                                    y=y, _design=design)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            call()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    per_call = 2 if design == "bgmv" else 1
    rec = dict(shape=label, design=design, T=TOKENS, K=k, N=n, rank=RANK,
               **_per_call(_kernel_spans(prof), per_call))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            call()
        torch.cuda.synchronize()
    rec["eager_span_us"] = _per_call(_kernel_spans(prof),
                                     per_call).get("span_us")
    del graph
    return rec


# (text of the SGMV kernel, the stamp inserted after it): the phases'
# ends in order
STAMPS = (
    ("  cg::cluster_group cluster = cg::this_cluster();\n", "start"),
    ('  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n',
     "ids_and_list"),
    ("      // 2. the part's sum in warp order, stored into slot qv of every "
     "block\n", "shrink"),
    ("            cluster.map_shared_rank(recv, qq)[qv * tm * rp + e] = acc;\n"
     "      }\n", "block_sum"),
    ('        "barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");\n',
     "cluster_barrier"),
    ("  // 3. this block's columns: a thread holds the B column pairs of IB "
     "ids\n", "h_sum"),
    ("        if (tids[row] == 0) put(row, n, 0.f, 0.f, two);\n  }\n",
     "expand"))


# copies of the source that drop one part of the SGMV kernel (wrong
# outputs, for timing only): (edited text, its replacement)
VARIANTS = {
    "kernel": [],
    "no_shrink": [("      nch = kend > kbeg ? (kend - kbeg + CH - 1) / CH : 0;",
                   "      nch = 0;")],
    "no_remote": [("          if (qq < cs)\n",
                   "          if (qq == q)\n")],
    "no_expand": [("  for (int n = cbeg + 2 * cl; expands && n < cend; "
                   "n += 2 * ncb) {",
                   "  for (int n = cend; n < cend; n += 2 * ncb) {")],
    "no_b_loads": [("          bp[i][j] = ld_issue32(p);",
                    "          bp[i][j] = 0x3F803F80u;")],
    "no_copies": [("          copy(mt, wl[pl], pc, j);",
                   "          (void)pl;")],
    "no_products": [("          for (int st = 0; st < CH / 16; ++st) {",
                     "          for (int st = 0; st < 0; ++st) {")],
}


def _stamped_entries():
    """{variant: (SGMV entry, stamp reader)} of copies of the source with a
    `clock64()` stamp after each text of STAMPS and the variant's edits,
    built side by side."""
    import ctypes
    from ..ops import _build
    from ..ops import lora_epilogue as le
    base = (_build.CSRC / "lora_epilogue.cu").read_text()
    for i, (text, _) in enumerate(STAMPS):
        if text not in base:
            raise RuntimeError(f"lora_timeline: {text!r} not in "
                               "csrc/lora_epilogue.cu")
        base = base.replace(text, text + f"  PDT_STAMP({i});\n", 1)
    head = ("#include <cuda_runtime.h>\n"
            f"__device__ long long pdt_stamps[{len(STAMPS)}];\n"
            "#define PDT_STAMP(i) do { if (blockIdx.x == 0 && "
            "blockIdx.y == 0 && threadIdx.x == 0) pdt_stamps[i] = "
            "clock64(); } while (0)\n")
    tail = ("\nextern \"C\" int pdt_lora_stamps(long long* out) {\n"
            "  return static_cast<int>(cudaMemcpyFromSymbol(out, pdt_stamps,"
            " sizeof(pdt_stamps)));\n}\n")
    procs = {}
    for name, edits in VARIANTS.items():
        src = base
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"lora_timeline: {old!r} not in "
                                   "csrc/lora_epilogue.cu")
            src = src.replace(old, new)
        out = _build.BUILD_DIR / "lora_stamps" / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "lora_epilogue.cu").write_text(head + src + tail)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out / "lib.so"), str(out / "lora_epilogue.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out / "lib.so")
    entries = {}
    for name, (proc, lib_path) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"lora_timeline: the {name} copy did not "
                               f"build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.pdt_lora_sgmv
        fn.argtypes, fn.restype = le._SGMV_ARGTYPES, ctypes.c_int
        lib.pdt_lora_stamps.argtypes = [ctypes.c_void_p]
        entries[name] = (fn, lib.pdt_lora_stamps)
    return entries


def stamps(fn, read, label, k, n, ids_kind, gen):
    """One variant at one shape: its device microseconds a call (a CUDA
    graph of CALLS launches, replayed between two events; the median of 5
    replays) and its stamps (the median of 9 single calls, each phase's
    end from the block's start, in SM cycles and in microseconds at the
    card's SM clock)."""
    import ctypes
    import torch
    x = torch.randn(TOKENS, k, device="cuda", generator=gen).to(torch.bfloat16)
    a = (torch.randn(ROWS, k, RANK, device="cuda", generator=gen)
         / math.sqrt(k)).to(torch.bfloat16)
    b = (0.1 * torch.randn(ROWS, RANK, n, device="cuda",
                           generator=gen)).to(torch.bfloat16)
    scale = torch.tensor([0.0, 1.0, 0.5, 2.0], device="cuda")
    ids = ((torch.arange(TOKENS, device="cuda") * 3) % ROWS
           if ids_kind == "three" else torch.ones(TOKENS, device="cuda")
           ).to(torch.int32)
    y = torch.empty(TOKENS, n, device="cuda", dtype=torch.bfloat16)
    props = torch.cuda.get_device_properties(0)
    ghz = props.clock_rate / 1e6 if hasattr(props, "clock_rate") else None

    def call():
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), scale.data_ptr(),
                 ids.data_ptr(), y.data_ptr(), TOKENS, k, n, ROWS, RANK, 1,
                 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"lora_timeline: launch failed ({err})")
    runs = []
    for _ in range(9):
        call()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * len(STAMPS))()
        if read(ctypes.addressof(buf)):
            raise RuntimeError("lora_timeline: the stamps did not copy")
        runs.append([v - buf[0] for v in buf])
    cyc = [statistics.median(r[i] for r in runs) for i in range(len(STAMPS))]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            call()
    graph.replay()
    times = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) * 1e3 / CALLS)
    rec = dict(shape=label, ids=ids_kind, T=TOKENS, K=k, N=n,
               graph_us=statistics.median(times),
               cycles={name: c for (_, name), c in zip(STAMPS, cyc)},
               sm_ghz=ghz)
    if ghz:
        rec["us"] = {name: c / (ghz * 1e3)
                     for (_, name), c in zip(STAMPS, cyc)}
    return rec


def calls(gen):
    """The decode calls' timelines, then the stamped copies'."""
    for label, k, n in SHAPES:
        for design in ("bgmv", "sgmv"):
            print("lora_timeline " + json.dumps(timeline(label, k, n, design,
                                                         gen)), flush=True)
    for variant, (fn, read) in _stamped_entries().items():
        for label, k, n in SHAPES:
            for ids_kind in ("one", "three"):
                rec = stamps(fn, read, label, k, n, ids_kind, gen)
                print("lora_stamps " + json.dumps(dict(variant=variant,
                                                       **rec)), flush=True)


def serving(steps):
    """The multi-LoRA decode step's LoRA device time under each design,
    in turns."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import lora_epilogue as le
    from .profile_decode import profile_engine
    model = LlamaForCausalLM(LlamaConfig.llama3_8b(), device="cuda",
                             dtype=torch.bfloat16, seed=0)
    for design in ("sgmv", "bgmv", "bgmv", "sgmv"):
        with mock.patch.object(le, "lora_design",
                               lambda dtype, rank, d=design: d):
            rec = profile_engine(model, "lora", steps)
        fam = rec["by_family"].get("lora_epilogue", {})
        print("lora_serving " + json.dumps(dict(
            design=design, steps=steps,
            lora_launches_per_step=fam.get("launches_per_step"),
            lora_device_ms_per_step=fam.get("device_ms_per_step"),
            device_ms_per_step=rec["device_ms_per_step"],
            step_ms=rec["step_ms"], idle_share=rec["idle_share"])),
            flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serving", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("lora_timeline: needs a CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import _build
    _build.build(["lora_epilogue"])
    if args.serving:
        serving(args.steps)
    else:
        calls(torch.Generator(device="cuda").manual_seed(11))
    print(subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
