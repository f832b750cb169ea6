"""Plumbing shared by the ported recipes: argument parsing, the
synthetic token source, the train loop and its result.

≙ `recipes/common.py` (`std_parser`, `token_source`, `run_train`,
`RecipeResult`). ``--save`` writes the trained model's state dict with
`paddle_tpu_torch.save` (`save_model`), as the JAX recipes write theirs;
``--data`` (file token sources) is refused by every recipe
(`refuse_unported`). `RecipeResult` also carries each step's host seconds
and loss.
"""
from __future__ import annotations

import argparse
import itertools
import time
from dataclasses import dataclass, field

from ..framework.io import save
from ..text import SyntheticTokens


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
    p.add_argument("--device", type=str, default=None,
                   help="torch device to train on (default: the CUDA card)")
    return p


@dataclass
class RecipeResult:
    final_loss: float
    steps: int
    # host seconds of each step, each ending in the loss's copy to the
    # host (which waits for the device)
    step_seconds: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    # the image of a recipe's sample after training (DiT's
    # ``--sample-after``), else None
    sample: object = None


def unported(flag: str, item: str):
    raise NotImplementedError(f"{flag} is not ported yet (ROADMAP.md queue "
                              f"A, item {item})")


def refuse_unported(args) -> None:
    """Raise for the standard flags the port does not run yet."""
    if args.data:
        unported("--data", "6: file token sources")


def save_model(args, model) -> None:
    """``--save PATH``: the model's state dict to PATH (≙ the JAX
    recipes' ``paddle.save(model.state_dict(), args.save)``)."""
    if args.save:
        save(model.state_dict(), args.save)
        print(f"saved {args.save}")


def token_source(args, vocab_size: int) -> SyntheticTokens:
    """The synthetic stream of `recipes/common.py` `token_source`: enough
    ids for ``max(steps, 4)`` batches, seeded with ``--seed``."""
    need = args.batch_size * (args.seq_len + 1) * max(args.steps, 4)
    return SyntheticTokens(vocab_size, need, seed=args.seed)


def run_train(step_fn, loader, steps: int, log_every: int) -> RecipeResult:
    """Drive ``steps`` train steps from an (endlessly cycled) loader."""
    it = itertools.cycle(loader)
    loss = float("nan")
    times, losses = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        ts = time.perf_counter()
        loss = float(step_fn(*next(it)))
        times.append(time.perf_counter() - ts)
        losses.append(loss)
        if log_every and (i % log_every == 0 or i == steps - 1):
            dt = time.perf_counter() - t0
            print(f"step {i:4d}  loss {loss:.4f}  "
                  f"({dt / (i + 1):.3f}s/step)", flush=True)
    return RecipeResult(loss, steps, times, losses)
