"""DiT diffusion training, with an optional DDIM sample at the end.

≙ `recipes/dit_train.py` without its mesh: ``--size tiny|s`` (default
tiny; ``s``: 32x32 latents, patch 4, width 384, 12 layers, 6 heads,
1000 classes) and the standard flags and defaults (`common.py`), over
`synthetic_dit_batch` (batch i seeded ``--seed + i``), `DiT`,
`GaussianDiffusion.training_loss` (its noise stream seeded ``--seed``),
`TrainStep` and `AdamW` (no weight decay). The model trains in f32.
``--sample-after`` runs a 10-step DDIM sample (eta 0) of classes 0 and 1
at the end. ``--device`` picks where it runs, the CUDA card by default:

    python -m paddle_tpu_torch.recipes.dit_train --steps 10
    python -m paddle_tpu_torch.recipes.dit_train --size s --steps 3 \\
        --sample-after
    python -m paddle_tpu_torch.recipes.dit_train --size tiny --steps 2 \\
        --sample-after --device cpu

``--save PATH`` writes the trained model's state dict (`save_model`).
``--data`` is parsed and not read: the latents are always synthetic, as
in the JAX recipe. Not ported yet, and refused with
`NotImplementedError`: ``--mesh`` (ROADMAP.md queue A, item 9).
"""
from __future__ import annotations

import torch

from ..jit import TrainStep
from ..models.dit import DiT, DiTConfig, GaussianDiffusion, \
    synthetic_dit_batch
from ..ops import resolve_device
from ..optimizer import AdamW
from .common import (RecipeResult, run_train, save_model,
                     std_parser, unported)


def s_config() -> DiTConfig:
    """The ``--size s`` model of the JAX recipe."""
    return DiTConfig(input_size=32, patch_size=4, hidden_size=384,
                     num_hidden_layers=12, num_attention_heads=6,
                     num_classes=1000)


def main(argv=None) -> RecipeResult:
    p = std_parser("DiT diffusion training")
    p.add_argument("--size", choices=["tiny", "s"], default="tiny")
    p.add_argument("--mesh", type=str, default=None, help="e.g. dp=4,mp=2")
    p.add_argument("--sample-after", action="store_true",
                   help="run a 10-step DDIM sample at the end")
    args = p.parse_args(argv)
    if args.mesh:
        unported("--mesh", "9: the distributed stack")

    cfg = DiTConfig.tiny() if args.size == "tiny" else s_config()
    device = resolve_device(args.device)
    model = DiT(cfg, device=device, seed=args.seed)
    diffusion = GaussianDiffusion(seed=args.seed)
    opt = AdamW(learning_rate=args.lr, parameters=model.parameters(),
                weight_decay=0.0)
    step = TrainStep(
        model, opt,
        loss_fn=lambda m, x, t, y: diffusion.training_loss(m, x, t, y),
        accumulate_steps=args.accumulate_steps)
    batches = (synthetic_dit_batch(args.batch_size, cfg, seed=args.seed + i)
               for i in range(args.steps))
    result = run_train(lambda *b: step(*(t.to(device) for t in b)),
                       batches, args.steps, args.log_every)
    if args.sample_after:
        y = torch.arange(min(2, cfg.num_classes), dtype=torch.int32)
        img = diffusion.ddim_sample(model, batch_size=y.shape[0], y=y,
                                    num_steps=10, seed=args.seed)
        print(f"sampled {tuple(img.shape)}", flush=True)
        result.sample = img
    save_model(args, model)
    return result


if __name__ == "__main__":
    r = main()
    print(f"final loss {r.final_loss:.4f}")
