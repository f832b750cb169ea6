"""ERNIE pretraining (masked LM + sentence order) on one device.

≙ `recipes/ernie_4d.py` without its mesh: ``--size tiny|base`` (default
tiny) and the standard flags and defaults (`common.py`), over
`synthetic_ernie_batch` (batch i seeded ``--seed + i``, as the JAX
recipe draws it), `ErnieForPretraining(labels=, sop_labels=)`,
`TrainStep` and `AdamW` (weight decay 0.01). The model trains in f32
with its configured dropout. ``--device`` picks where it runs, the CUDA
card by default:

    python -m paddle_tpu_torch.recipes.ernie_4d --steps 10
    python -m paddle_tpu_torch.recipes.ernie_4d --size base \\
        --batch-size 8 --seq-len 512 --steps 5
    python -m paddle_tpu_torch.recipes.ernie_4d --size tiny --steps 2 \\
        --device cpu

``--save PATH`` writes the trained model's state dict (`save_model`).
``--data`` is parsed and not read: the batches are always synthetic, as
in the JAX recipe. Not ported yet, and refused with
`NotImplementedError`: ``--mesh`` (the 4D hybrid mesh, ROADMAP.md queue
A, item 9).
"""
from __future__ import annotations

from ..jit import TrainStep
from ..models.ernie import (ErnieConfig, ErnieForPretraining,
                            synthetic_ernie_batch)
from ..ops import resolve_device
from ..optimizer import AdamW
from .common import (RecipeResult, run_train, save_model,
                     std_parser, unported)


def main(argv=None) -> RecipeResult:
    p = std_parser("ERNIE pretraining (MLM + SOP) on one device")
    p.add_argument("--size", choices=["tiny", "base"], default="tiny")
    p.add_argument("--mesh", type=str, default=None,
                   help="e.g. dp=2,mp=2,sharding=2")
    args = p.parse_args(argv)
    if args.mesh:
        unported("--mesh", "9: the distributed stack")

    cfg = ErnieConfig.tiny() if args.size == "tiny" else ErnieConfig.base()
    device = resolve_device(args.device)
    model = ErnieForPretraining(cfg, device=device, seed=args.seed)
    opt = AdamW(learning_rate=args.lr, parameters=model.parameters(),
                weight_decay=0.01)
    step = TrainStep(
        model, opt,
        loss_fn=lambda m, ids, lbl, sop: m(ids, labels=lbl,
                                           sop_labels=sop)[0],
        accumulate_steps=args.accumulate_steps)
    batches = (synthetic_ernie_batch(args.batch_size, args.seq_len,
                                     cfg.vocab_size, seed=args.seed + i)
               for i in range(args.steps))
    result = run_train(lambda *b: step(*(t.to(device) for t in b)),
                       batches, args.steps, args.log_every)
    save_model(args, model)
    return result


if __name__ == "__main__":
    r = main()
    print(f"final loss {r.final_loss:.4f}")
