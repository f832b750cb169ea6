"""Learning-rate schedulers.

≙ `paddle_tpu/optimizer/lr.py` :7-36 (`LRScheduler`) and :163
(`LinearWarmup`). A scheduler is called for the current rate and
stepped once per training step by the caller; `AdamW` reads it at each
of its steps. The other schedulers, ``verbose``, a scheduler inside
`LinearWarmup` and a scheduler's state dict are not ported yet
(ROADMAP.md queue A, item 15).
"""
from __future__ import annotations


class LRScheduler:
    """Base: ``sched()`` is the current rate, ``sched.step()`` advances
    ``last_epoch`` and recomputes it by `get_lr`."""

    def __init__(self, learning_rate=0.1, last_epoch=-1):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def get_lr(self):
        raise NotImplementedError


class LinearWarmup(LRScheduler):
    """From ``start_lr`` to ``end_lr`` linearly over ``warmup_steps``
    steps, then the float ``learning_rate``."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1):
        self.lr = float(learning_rate)
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / max(self.warmup_steps, 1)) + self.start_lr
        return self.lr
