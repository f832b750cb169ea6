"""Llama causal-LM pretraining on synthetic tokens or a token file.

≙ `recipes/llama_pretrain.py` (its shared plumbing in `common.py`): the
same ``--size tiny|small|bench`` configurations and the same flags and
defaults, over `LlamaForCausalLM(labels=)`, `TrainStep` and `AdamW`
(``multi_precision`` with ``--bf16``). ``--device`` picks where it runs,
the CUDA card by default:

    python -m paddle_tpu_torch.recipes.llama_pretrain --steps 20
    python -m paddle_tpu_torch.recipes.llama_pretrain --size bench --bf16 \\
        --batch-size 8 --seq-len 2048 --steps 5
    python -m paddle_tpu_torch.recipes.llama_pretrain --size tiny \\
        --steps 2 --device cpu --resume-drill
    python -m paddle_tpu_torch.recipes.llama_pretrain --size bench --bf16 \\
        --recompute --data tokens.bin --batch-size 8 --seq-len 2048

``--data FILE`` trains on a ``.bin`` of ids (`text.encode_file`) or a
text file (byte-tokenized), batched by `io.DataLoader` in a seeded
shuffle (`common.shuffled_loader`); ``--recompute`` recomputes each
decoder layer's activations in the backward (`LlamaConfig.recompute`,
policy "full"). ``--save PATH`` writes the trained model's state dict
(`save_model`); ``--resume-drill`` runs the durable-checkpoint drill of
``docs/checkpointing.md`` after training (`run_resume_drill`). Not ported
yet, and refused with `NotImplementedError`: ``--mesh`` (ROADMAP.md queue
A, item 9: the distributed stack).
"""
from __future__ import annotations

import os
import tempfile

import torch

from ..jit import TrainStep
from ..models.llama import LlamaConfig, LlamaForCausalLM
from ..ops import resolve_device
from ..optimizer import AdamW
from ..text import LMBlockDataset
from .common import (RecipeResult, run_train, save_model,
                     shuffled_loader, std_parser, token_source, unported)


def run_resume_drill(model, optimizer, ckpt_dir):
    """Save -> corrupt -> resume drill (``docs/checkpointing.md``; ≙
    `recipes/llama_pretrain.py` :26-65): commit two checkpoints through
    the atomic protocol, verify both, flip bytes in the newest one's data
    files, and prove `ElasticManager.resume` quarantines it and falls
    back — then print the telemetry a real incident would leave behind."""
    from .. import observability as telemetry
    from ..distributed.checkpoint import verify_checkpoint
    from ..distributed.fleet.elastic import ElasticManager
    from ..utils.faults import flip_checkpoint_shards

    telemetry.enable()
    print("--- durable-checkpoint resume drill ---")
    em = ElasticManager(ckpt_dir, save_interval_steps=1,
                        sleep=lambda _: None)
    em.save(0, model, optimizer)
    em.save(1, model, optimizer)
    for step in (0, 1):
        res = verify_checkpoint(os.path.join(ckpt_dir, f"step_{step}"),
                                rehash=True)
        print(f"verify step_{step}: ok={res.ok} "
              f"({res.arrays_checked} arrays re-hashed)")
    # flip one byte in every data file of the newest checkpoint's model
    # group — a silent disk corruption, .done marker still valid
    n = flip_checkpoint_shards(os.path.join(ckpt_dir, "step_1"))
    print(f"corrupted step_1 (flipped bytes in {n} model shards)")
    start = em.resume(model, optimizer)
    quarantined = sorted(n for n in os.listdir(ckpt_dir)
                         if n.endswith(".corrupt"))
    print(f"resume fell back to start step {start} "
          f"(quarantined: {quarantined})")
    if not (start == 1 and quarantined == ["step_1.corrupt"]):
        raise AssertionError((start, quarantined))
    print("--- checkpoint telemetry (Prometheus text exposition) ---")
    for line in telemetry.to_prometheus().splitlines():
        if "pdt_checkpoint" in line:
            print(line)
    print("--- end drill ---")


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
    args = p.parse_args(argv)
    if args.mesh:
        unported("--mesh", "9: the distributed stack")

    if args.size == "bench":
        cfg = bench_config()
    elif args.size == "small":
        cfg = LlamaConfig.small()
    else:
        cfg = LlamaConfig.tiny()
    cfg.recompute = args.recompute
    device = resolve_device(args.device)
    model = LlamaForCausalLM(cfg, device=device,
                             dtype=torch.bfloat16 if args.bf16 else None,
                             seed=args.seed)

    ds = LMBlockDataset(token_source(args, cfg.vocab_size), args.seq_len)
    loader = shuffled_loader(args, ds)

    opt = AdamW(learning_rate=args.lr, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=args.bf16)
    step = TrainStep(model, opt, loss_fn=lambda m, x, y: m(x, labels=y)[0],
                     accumulate_steps=args.accumulate_steps)

    def step_fn(x, y):
        return step(x.to(device), y.to(device))
    result = run_train(step_fn, loader, args.steps, args.log_every)
    save_model(args, model)
    if args.resume_drill:
        opt = AdamW(learning_rate=args.lr, parameters=model.parameters(),
                    weight_decay=0.01)
        with tempfile.TemporaryDirectory(prefix="pdt_ckpt_drill_") as d:
            run_resume_drill(model, opt, d)
    return result


if __name__ == "__main__":
    r = main()
    print(f"final loss {r.final_loss:.4f}")
