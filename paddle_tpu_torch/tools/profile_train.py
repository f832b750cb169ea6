"""Where a training step's time goes, on one card.

    python3 -m paddle_tpu_torch.tools.profile_train [--steps 3]

Four configurations, each trained with ``AdamW(lr=3e-4,
weight_decay=0.01, multi_precision=True)`` on one seeded batch, the step
being what `TrainStep` runs (forward with ``labels=``, backward,
``optimizer.step()``, gradients cleared):
- ``8b_width``: `recipes.llama_pretrain.train_8b_config()`, Llama-3-8B
  at full width cut to 4 decoder layers (full-depth AdamW state does not
  fit one card), bf16, B=2, S=2048;
- ``bench``: the recipe's ``--size bench`` model (16 layers), bf16, B=8,
  S=2048;
- ``moe_a14b``: `recipes.moe_train.train_a14b_config()`, Qwen2-MoE-A14B
  at full width cut to 1 decoder layer, dropless, bf16, B=1, S=4096;
- ``bert_base``: `BertConfig.base()` with its dropout, f32, B=32,
  S=512, masked-LM labels on 15% of the positions.
After two warm-up steps it prints, per configuration:
- ``train_phases {...}``: device milliseconds of the forward (to the
  loss), the backward and the optimizer step, by CUDA events that the
  step's loss function and optimizer hooks record (`PhaseEvents`),
  median over ``--steps`` steps;
- ``train_profile {...}``: `torch.profiler` over ``--steps`` steps: host
  wall per step, device time per step summed over kernels, the device's
  idle share of the wall, and device time and launches per step by
  kernel family (the port's kernels by name, cuBLAS matmuls, the
  softmax / cross-entropy kernels, everything else), and the ten
  kernels that took the most device time.
Needs one CUDA card; without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .profile_decode import _kernel_times

FAMILIES = (("flash_attention_fwd", ("flash_fwd",)),
            ("flash_attention_bwd_dq", ("flash_dq",)),
            ("flash_attention_bwd_dkv", ("flash_dkv",)),
            ("rms_norm_bwd", ("rms_norm_bwd", "rms_norm_dw")),
            ("rms_norm", ("rms_norm_fwd",)),
            ("grouped_matmul", ("gmm_mma", "gmm_wgmma", "gmm_f32", "gmm_plan")),
            ("layer_norm_bwd", ("layer_norm_bwd", "layer_norm_dwdb")),
            ("layer_norm", ("layer_norm_fwd",)),
            ("torch_matmul", ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "nvjet", "cublas")),
            ("softmax_cross_entropy", ("softmax", "nll_loss",
                                       "cross_entropy")))


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def configs():
    """{label: (config, model class, dtype, batch, seq)}."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.models.moe import MoEForCausalLM
    from paddle_tpu_torch.recipes.llama_pretrain import (
        TRAIN_8B_SHAPE, bench_config, train_8b_config)
    from paddle_tpu_torch.recipes.moe_train import (TRAIN_A14B_SHAPE,
                                                    train_a14b_config)
    bf16 = torch.bfloat16
    return {"8b_width": (train_8b_config(), LlamaForCausalLM, bf16,
                         *TRAIN_8B_SHAPE),
            "bench": (bench_config(), LlamaForCausalLM, bf16, 8, 2048),
            "moe_a14b": (train_a14b_config(), MoEForCausalLM, bf16,
                         *TRAIN_A14B_SHAPE),
            "bert_base": (BertConfig.base(), BertForMaskedLM, torch.float32,
                          32, 512)}


def _batch(cls, vocab, batch, seq):
    """One seeded batch: next-token ids and labels, or for BERT masked-LM
    labels (-100 but at 15% of the positions)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (batch, seq + 1))
    x, y = ids[:, :-1], ids[:, 1:]
    if cls.__name__ == "BertForMaskedLM":
        y = np.where(rng.random((batch, seq)) < 0.15, x, -100)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


class PhaseEvents:
    """CUDA events at the edges of a `TrainStep`'s phases, from inside
    it: the loss function's start and end (`loss_fn`) and the optimizer
    step's (its pre and post hooks). While ``armed``, each step adds
    four events: forward, backward and optimizer lie between them."""

    def __init__(self, optimizer):
        self.armed = False
        self.events = []
        optimizer.register_step_pre_hook(lambda *_: self._mark())
        optimizer.register_step_post_hook(lambda *_: self._mark())

    def _mark(self):
        if self.armed:
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()

    def loss_fn(self, model, x, y):
        self._mark()
        loss = model(x, labels=y)[0]
        self._mark()
        return loss

    def phases_ms(self):
        """[[forward, backward, optimizer] ms] per recorded step."""
        ev = self.events
        return [[ev[i + j].elapsed_time(ev[i + j + 1]) for j in range(3)]
                for i in range(0, len(ev), 4)]


def profile_config(label, cfg, cls, dtype, batch, seq, steps):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    model = cls(cfg, device="cuda", dtype=dtype, seed=0)
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    timer = PhaseEvents(opt)
    step = TrainStep(model, opt, loss_fn=timer.loss_fn)
    x, y = _batch(cls, cfg.vocab_size, batch, seq)
    for _ in range(2):
        float(step(x, y))
    timer.armed = True
    for _ in range(steps):
        step(x, y)
    torch.cuda.synchronize()
    timer.armed = False
    phases = timer.phases_ms()
    med = [statistics.median(p[i] for p in phases) for i in range(3)]
    print("train_phases " + json.dumps(dict(
        config=label, layers=cfg.num_hidden_layers, batch=batch, seq=seq,
        forward_ms=med[0], backward_ms=med[1], optimizer_ms=med[2])),
        flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(x, y)
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
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    print("train_profile " + json.dumps(dict(
        config=label, steps=steps, step_ms=step_ms,
        device_ms_per_step=dev_ms,
        idle_share=max(0.0, 1 - dev_ms / step_ms),
        by_family={k: dict(launches_per_step=v[0] / steps,
                           device_ms_per_step=v[1] / 1e3 / steps)
                   for k, v in sorted(fam.items())},
        top_kernels=[dict(name=name[:120], launches_per_step=c / steps,
                          device_ms_per_step=us / 1e3 / steps)
                     for name, (c, us) in top])), flush=True)
    del step, model, opt
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    for label, spec in configs().items():
        profile_config(label, *spec, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
