"""Where a decode step's time goes, per engine mode, on one card.

    python3 -m paddle_tpu_torch.tools.profile_decode [--steps 10]

Builds `LlamaConfig.llama3_8b()` in bf16 from seed 0, and for each
engine mode — full width, ``QuantServingConfig("int8", "int8")``,
``QuantServingConfig("fp8", "int8")``, multi-LoRA (three seeded rank-16
adapters on the seven matmuls of every layer, two of the 8 requests
under each and two on the base) and ``attention_impl="legacy"`` — admits
8 seeded requests, warms up, and traces ``--steps`` decode steps with
`torch.profiler`. Prints one ``decode_profile {...}`` JSON line per
mode: host wall per step, device time per step summed over kernels, the
device's idle share of the wall, and device time per step by kernel
family (the port's CUDA kernels by name, PyTorch's matmuls, everything
else).

Then, for each matmul shape of a decode step, the device time of one
dequant matmul (int8 and fp8) and of the full-width ``F.linear`` from the
same trace, and the host time of one call of each (the wall of 200
back-to-back calls over 200): ``decode_matmul {...}`` lines. Needs one
CUDA card; without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

FAMILIES = (("dequant_matmul", ("dequant",)),
            # the split design's kernels (csrc/decode_attention.cuh), ragged
            # or paged by the engine's mode
            ("split_attention", ("split_cc_kernel", "split_tc_kernel")),
            ("ragged_paged_attention", ("ragged_paged_attention",)),
            ("paged_attention", ("paged_attention",)),
            ("lora_epilogue", ("lora_",)),
            ("rms_norm", ("rms_norm",)),
            ("torch_matmul", ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "nvjet", "cublas")))


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _kernel_times(prof):
    """{kernel name: (count, device microseconds)} from a trace. User
    annotations (`record_function` ranges such as the
    ``Optimizer.step#...`` that `torch.optim` wraps around a step) show
    on the device timeline too; they are spans, not kernels, and are
    left out."""
    out = {}
    for e in prof.key_averages():
        us = _device_us(e)
        if us > 0 and getattr(e, "device_type", None) is not None \
                and "CUDA" in str(e.device_type) \
                and not getattr(e, "is_user_annotation", False):
            out[e.key] = (e.count, us)
    if not out:       # older layouts: device time on the CPU-side rows
        out = {e.key: (e.count, _device_us(e)) for e in prof.key_averages()
               if _device_us(e) > 0}
    return out


LORA_MATMULS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
                "mlp.down_proj")


def seeded_lora_deltas(model, seed, rank=16):
    """Rank-``rank`` deltas (A (K, r), B (r, N), f32 numpy) on the seven
    matmuls of every layer, from ``seed``: A ~ N(0, 1/K), B ~ N(0,
    0.25/r), so a delta is about half a base output's size."""
    params = dict(model.named_parameters())
    rng = np.random.default_rng(seed)
    deltas = {}
    for layer in range(model.config.num_hidden_layers):
        for mm in LORA_MATMULS:
            nm = f"model.layers.{layer}.{mm}.weight"
            n, k = params[nm].shape
            a = rng.standard_normal((k, rank), np.float32) \
                / np.float32(np.sqrt(k))
            b = rng.standard_normal((rank, n), np.float32) \
                * np.float32(0.5 / np.sqrt(rank))
            deltas[nm] = (a, b)
    return deltas


def profile_engine(model, mode, steps, seed=0):
    """``mode``: a `QuantServingConfig`, None (full width), ``"lora"`` or
    ``"legacy"``. Prints and returns the ``decode_profile`` record."""
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    quant = mode if not isinstance(mode, str) else None
    eng = ContinuousBatchingEngine(
        model, max_batch_size=8, max_seq_len=2048, quant=quant,
        attention_impl="legacy" if mode == "legacy" else "ragged")
    adapters = (None,)
    if mode == "lora":
        adapters += ("a1", "a2", "a3")
        for i, name in enumerate(adapters[1:]):
            eng.install_adapter(name, seeded_lora_deltas(model, 100 + i))
    rng = np.random.default_rng(seed)
    for i in range(8):
        eng.add_request(rng.integers(0, model.config.vocab_size,
                                     int(rng.integers(32, 1025))),
                        max_new_tokens=steps + 8,
                        adapter=adapters[i % len(adapters)])
    for _ in range(3):                   # admission, then warm decode
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernel_times(prof)
    fam = {}
    for name, (count, us) in kernels.items():
        f = fam.setdefault(_family(name), [0, 0.0])
        f[0] += count
        f[1] += us
    dev_ms = sum(us for _, us in kernels.values()) / 1e3 / steps
    step_ms = 1e3 * wall / steps
    label = mode if isinstance(mode, str) else "full width" \
        if quant is None else f"{quant.weights} weights, {quant.kv} KV"
    rec = dict(mode=label,
               steps=steps, step_ms=step_ms, device_ms_per_step=dev_ms,
               idle_share=max(0.0, 1 - dev_ms / step_ms),
               by_family={k: dict(launches_per_step=v[0] / steps,
                                  device_ms_per_step=v[1] / 1e3 / steps)
                          for k, v in sorted(fam.items())})
    print("decode_profile " + json.dumps(rec), flush=True)
    del eng
    return rec


def matmul_shapes(cfg):
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    return [("q_proj/o_proj", h, h), ("k_proj/v_proj", h, kv),
            ("gate_proj/up_proj", h, i), ("down_proj", i, h),
            ("lm_head", h, v)]


def profile_matmuls(cfg, calls=200):
    from paddle_tpu_torch.ops.quant_matmul import (dequant_matmul_values,
                                                   quantize_weight_values)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, k, n in matmul_shapes(cfg):
        w = (0.02 * torch.randn(n, k, device="cuda", generator=gen)).bfloat16()
        x = torch.randn(8, k, device="cuda", generator=gen).bfloat16()
        fns = {"bf16_linear": lambda: torch.nn.functional.linear(x, w)}
        for mode in ("int8", "fp8"):
            qw, sc = quantize_weight_values(w, mode)
            fns[mode] = (lambda qw=qw, sc=sc:
                         dequant_matmul_values(x, qw, sc))
        rec = dict(shape=label, M=8, K=k, N=n,
                   weight_bytes_bf16=2 * n * k, weight_bytes_q=n * k + 4 * n)
        for name, fn in fns.items():
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            host_us = 1e6 * (time.perf_counter() - t0) / calls
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            dev_us = sum(us for _, us in _kernel_times(prof).values()) / 20
            rec[name] = dict(device_us=dev_us, wall_us_per_call=host_us)
        print("decode_matmul " + json.dumps(rec), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: needs an NVIDIA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import QuantServingConfig
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    cfg = LlamaConfig.llama3_8b()
    profile_matmuls(cfg)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    for mode in (None, QuantServingConfig("int8", "int8"),
                 QuantServingConfig("fp8", "int8"), "lora", "legacy"):
        profile_engine(model, mode, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
