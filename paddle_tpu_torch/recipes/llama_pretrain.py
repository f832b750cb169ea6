"""Llama causal-LM pretraining on synthetic tokens.

≙ `recipes/llama_pretrain.py` with the parts of `recipes/common.py` it
uses (`std_parser`, `token_source`, `run_train`, `RecipeResult`): the
same ``--size tiny|small|bench`` configurations and the same flags and
defaults, over `LlamaForCausalLM(labels=)`, `TrainStep` and `AdamW`
(``multi_precision`` with ``--bf16``). ``--device`` picks where it runs,
the CUDA card by default:

    python -m paddle_tpu_torch.recipes.llama_pretrain --steps 20
    python -m paddle_tpu_torch.recipes.llama_pretrain --size bench --bf16 \\
        --batch-size 8 --seq-len 2048 --steps 5
    python -m paddle_tpu_torch.recipes.llama_pretrain --size tiny \\
        --steps 2 --device cpu

Not ported yet, and refused with `NotImplementedError`: ``--mesh``
(ROADMAP.md queue A, item 15: the distributed stack), ``--save`` and
``--resume-drill`` (item 15: checkpoints), ``--recompute`` (item 15) and
``--data`` (item 16: file token sources).
"""
from __future__ import annotations

import argparse
import itertools
import time
from dataclasses import dataclass, field

import torch

from ..jit import TrainStep
from ..models.llama import LlamaConfig, LlamaForCausalLM
from ..ops import resolve_device
from ..optimizer import AdamW
from ..text import LMBlockDataset, SyntheticTokens


def std_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--data", type=str, default=None,
                   help=".txt or .bin token file; default = synthetic")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument("--accumulate-steps", type=int, default=1)
    p.add_argument("--save", type=str, default=None,
                   help="checkpoint path to save at the end")
    return p


@dataclass
class RecipeResult:
    final_loss: float
    steps: int
    # host seconds of each step, each ending in the loss's copy to the
    # host (which waits for the device)
    step_seconds: list = field(default_factory=list)


def bench_config() -> LlamaConfig:
    """The ``--size bench`` model: ≙ `bench.py` `run_bench`'s chip shape."""
    return LlamaConfig(vocab_size=32000, hidden_size=1024,
                       intermediate_size=2816, num_hidden_layers=16,
                       num_attention_heads=16, num_key_value_heads=8,
                       max_position_embeddings=2048)


# the 8B-width training run of chip_smoke.py and tools/profile_train.py:
# Llama-3-8B at its published width, cut to 4 decoder layers (AdamW with
# f32 master weights holds 16 bytes a parameter: ~128 GB at full depth
# against one H100's 80 GB), batch 2 of 2048 tokens
TRAIN_8B_LAYERS = 4
TRAIN_8B_SHAPE = (2, 2048)


def train_8b_config() -> LlamaConfig:
    """`LlamaConfig.llama3_8b()` cut to `TRAIN_8B_LAYERS` layers."""
    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = TRAIN_8B_LAYERS
    return cfg


def run_train(step_fn, loader, steps: int, log_every: int):
    """Drive ``steps`` train steps from an (endlessly cycled) loader;
    returns (final loss, each step's host seconds)."""
    it = itertools.cycle(loader)
    loss = float("nan")
    times = []
    t0 = time.perf_counter()
    for i in range(steps):
        ts = time.perf_counter()
        loss = float(step_fn(*next(it)))
        times.append(time.perf_counter() - ts)
        if log_every and (i % log_every == 0 or i == steps - 1):
            dt = time.perf_counter() - t0
            print(f"step {i:4d}  loss {loss:.4f}  "
                  f"({dt / (i + 1):.3f}s/step)", flush=True)
    return loss, times


def _unported(flag: str, item: str):
    raise NotImplementedError(f"{flag} is not ported yet (ROADMAP.md queue "
                              f"A, item {item})")


def main(argv=None) -> RecipeResult:
    p = std_parser("Llama causal-LM pretraining")
    p.add_argument("--size", choices=["tiny", "small", "bench"],
                   default="small")
    p.add_argument("--recompute", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--mesh", type=str, default=None,
                   help="e.g. dp=2,sharding=2,mp=2")
    p.add_argument("--resume-drill", action="store_true",
                   help="after training, run the save->corrupt->resume "
                        "durability drill and print its telemetry")
    p.add_argument("--device", type=str, default=None,
                   help="torch device to train on (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.mesh:
        _unported("--mesh", "15: the distributed stack")
    if args.save or args.resume_drill:
        _unported("--save / --resume-drill", "15: checkpoints")
    if args.recompute:
        _unported("--recompute", "15: activation recompute")
    if args.data:
        _unported("--data", "16: file token sources")

    if args.size == "bench":
        cfg = bench_config()
    elif args.size == "small":
        cfg = LlamaConfig.small()
    else:
        cfg = LlamaConfig.tiny()
    device = resolve_device(args.device)
    model = LlamaForCausalLM(cfg, device=device,
                             dtype=torch.bfloat16 if args.bf16 else None,
                             seed=args.seed)

    need = args.batch_size * (args.seq_len + 1) * max(args.steps, 4)
    ds = LMBlockDataset(SyntheticTokens(cfg.vocab_size, need,
                                        seed=args.seed), args.seq_len)
    loader = torch.utils.data.DataLoader(
        ds, batch_size=args.batch_size, shuffle=True, drop_last=True,
        generator=torch.Generator().manual_seed(args.seed))

    opt = AdamW(learning_rate=args.lr, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=args.bf16)
    step = TrainStep(model, opt, loss_fn=lambda m, x, y: m(x, labels=y)[0],
                     accumulate_steps=args.accumulate_steps)

    def step_fn(x, y):
        return step(x.to(device), y.to(device))
    final, times = run_train(step_fn, loader, args.steps, args.log_every)
    return RecipeResult(final, args.steps, times)


if __name__ == "__main__":
    r = main()
    print(f"final loss {r.final_loss:.4f}")
