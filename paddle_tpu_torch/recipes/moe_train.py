"""MoE causal-LM training on synthetic tokens or a token file.

≙ `recipes/moe_train.py`: the same ``--size tiny|small`` configurations,
``--dropless`` and the standard flags and defaults (`common.py`), over
`MoEForCausalLM(labels=)`, `TrainStep` and `AdamW`. As in
`llama_pretrain`, ``--bf16`` builds the model in bf16 with f32 master
weights (``multi_precision``), and ``--device`` picks where it runs, the
CUDA card by default:

    python -m paddle_tpu_torch.recipes.moe_train --steps 10
    python -m paddle_tpu_torch.recipes.moe_train --size small --bf16 \\
        --dropless --steps 5
    python -m paddle_tpu_torch.recipes.moe_train --size tiny --steps 2 \\
        --device cpu

``--dropless`` routes through the grouped-matmul kernel; the default is
the capacity path (einsums, no kernel), as `MoEConfig` defaults.
``--data FILE`` trains on a ``.bin`` of ids or a byte-tokenized text
file, batched by `io.DataLoader` in a seeded shuffle. Not ported yet,
and refused with `NotImplementedError`: ``--mesh`` (expert parallelism;
ROADMAP.md queue A, item 9).
``--save PATH`` writes the trained model's state dict (`save_model`).
"""
from __future__ import annotations

import torch

from ..jit import TrainStep
from ..models.moe import MoEConfig, MoEForCausalLM
from ..ops import resolve_device
from ..optimizer import AdamW
from ..text import LMBlockDataset
from .common import (RecipeResult, run_train, save_model,
                     shuffled_loader, std_parser, token_source, unported)

# the A14B-width training run of chip_smoke.py: `qwen2_moe_a14b()` at its
# published width cut to 1 of 28 decoder layers (one layer holds ~2.0B
# parameters, and AdamW with f32 masters 16 bytes a parameter: ~0.9 TB at
# full depth against one H100's 80 GB), dropless, batch 1 of 4096 tokens
TRAIN_A14B_LAYERS = 1
TRAIN_A14B_SHAPE = (1, 4096)


def train_a14b_config() -> MoEConfig:
    """`MoEConfig.qwen2_moe_a14b()`, dropless, cut to
    `TRAIN_A14B_LAYERS` decoder layers."""
    cfg = MoEConfig.qwen2_moe_a14b()
    cfg.num_hidden_layers = TRAIN_A14B_LAYERS
    cfg.dropless = True
    return cfg


def main(argv=None) -> RecipeResult:
    p = std_parser("MoE causal-LM training (expert parallel)")
    p.add_argument("--size", choices=["tiny", "small"], default="tiny")
    p.add_argument("--dropless", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--mesh", type=str, default=None,
                   help="e.g. dp=2,ep=4")
    args = p.parse_args(argv)
    if args.mesh:
        unported("--mesh", "9: expert parallelism needs a mesh")

    cfg = MoEConfig.tiny() if args.size == "tiny" else MoEConfig.small()
    cfg.dropless = args.dropless
    device = resolve_device(args.device)
    model = MoEForCausalLM(cfg, device=device,
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
    return result


if __name__ == "__main__":
    r = main()
    print(f"final loss {r.final_loss:.4f}")
