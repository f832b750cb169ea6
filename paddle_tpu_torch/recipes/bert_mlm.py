"""BERT masked-LM training on synthetic tokens or a token file.

≙ `recipes/bert_mlm.py`: ``--size tiny|base`` (default base) and the
standard flags and defaults (`common.py`), over `ByteTokenizer`,
`MLMBlockDataset`, `BertForMaskedLM(labels=)`, `TrainStep` and `AdamW`
under `LinearWarmup` (0 to ``--lr`` over min(10, steps) steps, the
scheduler stepped after each train step). The model trains in f32 with
its configured dropout. ``--device`` picks where it runs, the CUDA card
by default:

    python -m paddle_tpu_torch.recipes.bert_mlm --steps 50
    python -m paddle_tpu_torch.recipes.bert_mlm --size base \\
        --batch-size 32 --seq-len 512 --steps 5
    python -m paddle_tpu_torch.recipes.bert_mlm --size tiny --steps 2 \\
        --device cpu

``--data FILE`` masks blocks of a ``.bin`` of ids or a byte-tokenized
text file (ids past the byte tokenizer's 261 raise, as in JAX), batched
by `io.DataLoader` in a seeded shuffle. ``--save PATH`` writes the
trained model's state dict (`save_model`).
"""
from __future__ import annotations

from ..jit import TrainStep
from ..models.bert import BertConfig, BertForMaskedLM
from ..ops import resolve_device
from ..optimizer import AdamW
from ..optimizer.lr import LinearWarmup
from ..text import ByteTokenizer, MLMBlockDataset
from .common import (RecipeResult, run_train, save_model,
                     shuffled_loader, std_parser, token_source)


def main(argv=None) -> RecipeResult:
    p = std_parser("BERT MLM fine-tune (single chip)")
    p.add_argument("--size", choices=["tiny", "base"], default="base")
    args = p.parse_args(argv)

    cfg = BertConfig.base() if args.size == "base" else BertConfig.tiny()
    device = resolve_device(args.device)
    model = BertForMaskedLM(cfg, device=device, seed=args.seed)

    tok = ByteTokenizer()
    vocab = min(cfg.vocab_size, tok.vocab_size)
    ds = MLMBlockDataset(token_source(args, vocab), args.seq_len,
                         mask_id=tok.mask_id, vocab_size=vocab,
                         seed=args.seed)
    loader = shuffled_loader(args, ds)

    sched = LinearWarmup(args.lr, warmup_steps=min(10, args.steps),
                         start_lr=0.0, end_lr=args.lr)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                weight_decay=0.01)
    step = TrainStep(model, opt, loss_fn=lambda m, x, y: m(x, labels=y)[0],
                     accumulate_steps=args.accumulate_steps)

    def step_and_sched(x, y):
        loss = step(x.to(device), y.to(device))
        sched.step()
        return loss
    result = run_train(step_and_sched, loader, args.steps, args.log_every)
    save_model(args, model)
    return result


if __name__ == "__main__":
    r = main()
    print(f"final loss {r.final_loss:.4f}")
