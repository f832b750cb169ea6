"""`TrainStep`: one optimizer step over a batch, eagerly.

≙ `paddle_tpu/jit/__init__.py` :210-445 (`TrainStep`). The JAX package
traces the forward, backward and update into one compiled XLA program
with its state donated; PyTorch runs them eagerly, so this step is the
same sequence of calls without the compile: gradients cleared, the
micro-batches' losses (each scaled by 1/k) back-propagated into the
parameters' ``.grad``, one ``optimizer.step()``, gradients cleared again.
Capturing the step in a CUDA graph is later work (ROADMAP.md queue A,
item 6).
"""
from __future__ import annotations

import torch


class TrainStep:
    """``step = TrainStep(model, opt, loss_fn=lambda m, x, y: m(x,
    labels=y)[0])``; ``loss = step(x, y)`` updates the model's
    parameters in place and returns the loss, detached.

    ``loss_fn(model, *args)`` returns the loss, or a tuple whose first
    element is the loss and whose others are auxiliary outputs (logits,
    ...), which the step returns after the loss. ``accumulate_steps=k``
    splits every argument's leading (batch) axis into k equal
    micro-batches, scales each micro-loss by 1/k before its backward,
    steps the optimizer once and returns the mean micro-loss, with each
    auxiliary output concatenated over the micro-batches along axis 0
    (≙ the JAX `TrainStep`'s gradient merge)."""

    def __init__(self, model, optimizer, loss_fn, accumulate_steps=1):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.accumulate_steps = int(accumulate_steps)
        if self.accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got "
                             f"{accumulate_steps}")

    def _micro(self, args):
        out = self.loss_fn(self.model, *args)
        aux = None
        if isinstance(out, (tuple, list)):
            out, aux = out[0], tuple(out[1:])
        k = self.accumulate_steps
        (out / k if k > 1 else out).backward()
        return out.detach(), aux

    def _clear_grads(self):
        for p in self.model.parameters():
            p.grad = None

    def __call__(self, *args):
        k = self.accumulate_steps
        self._clear_grads()
        if k == 1:
            loss, aux = self._micro(args)
        else:
            for t in args:
                if t.shape[0] % k:
                    raise ValueError(f"accumulate_steps={k} does not divide "
                                     f"batch dim {t.shape[0]}")
            losses, auxes = [], []
            for j in range(k):
                margs = tuple(t[j * (t.shape[0] // k):
                                (j + 1) * (t.shape[0] // k)] for t in args)
                mloss, maux = self._micro(margs)
                losses.append(mloss)
                auxes.append(maux)
            loss = torch.stack(losses).mean()
            aux = None if auxes[0] is None else tuple(
                torch.cat([a[i].detach() for a in auxes], dim=0)
                for i in range(len(auxes[0])))
        self.optimizer.step()
        self._clear_grads()
        if aux:
            return (loss,) + tuple(a.detach() for a in aux)
        return loss
