"""Adam and AdamW with f32 master weights, as `torch.optim.Optimizer`s.

≙ `paddle_tpu/optimizer/__init__.py` :23-239 (`Optimizer`: master
weights, the step count, state dicts, `ClipGradByGlobalNorm`) and
:298-372 (`Adam`, `AdamW`). The update is the JAX package's, in its
order, on f32 values (`_adam_core`):

    t += 1                                  (once per step, before)
    g  = f32(grad)            [+ wd * w     Adam's coupled decay]
    m  = b1 * m + (1 - b1) * g
    v  = b2 * v + (1 - b2) * g^2
    w' = w - lr * (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps)
                   [+ wd * w                AdamW's decoupled decay])

where w is the f32 master weight when ``multi_precision`` is set and the
parameter is bf16 or f16, else the parameter itself read as f32; the
result is cast back to the parameter's dtype. The moments are always
f32. `torch.optim.AdamW` applies its decay in another order and keeps
no master weights, so it is not used. Every entry point takes the
parameters where they lie (the card, or the CPU in the tests).

Not ported (ROADMAP.md queue A, item 15): LR schedulers (the learning
rate is a float), ``apply_decay_param_fun``, ``lr_ratio``, ``amsgrad``,
``lazy_mode``, the other clip classes and the other optimizers.
"""
from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm taken in f32 over all of them (≙ the JAX
    `ClipGradByGlobalNorm` branch of `Optimizer._clip_grads`)."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads):
        if not grads:
            return grads
        sq = torch.stack([g.float().square().sum() for g in grads])
        gn = sq.sum().sqrt()
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        return [(g.float() * scale).to(g.dtype) for g in grads]


class Adam(torch.optim.Optimizer):
    """Adam with the JAX package's arguments and update. ``weight_decay``
    is coupled (added to the gradient); `AdamW` decouples it."""

    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        defaults = dict(lr=float(learning_rate), beta1=float(beta1),
                        beta2=float(beta2), epsilon=float(epsilon),
                        weight_decay=float(weight_decay or 0.0))
        super().__init__(parameters, defaults)
        if grad_clip is not None and not isinstance(grad_clip,
                                                    ClipGradByGlobalNorm):
            raise NotImplementedError(
                "only ClipGradByGlobalNorm is ported (ROADMAP.md queue A, "
                "item 15)")
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        # the JAX optimizer's `_step_count`: one count for every
        # parameter, bumped before the update; kept in the state dict
        self.state["@step"] = 0

    def _use_master(self, p) -> bool:
        return self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16)

    def _param_state(self, p):
        st = self.state[p]
        if not st:
            st["moment1"] = torch.zeros_like(p, dtype=torch.float32)
            st["moment2"] = torch.zeros_like(p, dtype=torch.float32)
            if self._use_master(p):
                st["master"] = p.detach().float()
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        pairs = [(p, p.grad) for group in self.param_groups
                 for p in group["params"] if p.grad is not None]
        if self._grad_clip is not None:
            clipped = self._grad_clip([g for _, g in pairs])
            pairs = [(p, g) for (p, _), g in zip(pairs, clipped)]
        self.state["@step"] += 1
        t = self.state["@step"]
        group_of = {p: group for group in self.param_groups
                    for p in group["params"]}
        for p, grad in pairs:
            self._update(p, grad, group_of[p], t)
        return loss

    def _update(self, p, grad, group, t):
        lr, b1, b2 = group["lr"], group["beta1"], group["beta2"]
        wd = group["weight_decay"]
        st = self._param_state(p)
        w = st["master"] if "master" in st else p.detach().float()
        g = grad.float()
        if wd and not self._decoupled:
            g = g + wd * w
        m, v = st["moment1"], st["moment2"]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g.square(), alpha=1 - b2)
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        upd = mhat / (vhat.sqrt_() + group["epsilon"])
        if wd and self._decoupled:
            upd.add_(w, alpha=wd)
        new = w - lr * upd
        if "master" in st:
            st["master"] = new
        p.copy_(new)

    def load_state_dict(self, state_dict):
        """As `torch.optim.Optimizer.load_state_dict`, but the f32 moments
        and master weights stay f32 (torch's would cast them to each
        parameter's dtype, which loses a bf16 model's master weights)."""
        saved = {k: v for k, v in state_dict["state"].items()}
        super().load_state_dict(state_dict)
        params = [p for group in self.param_groups for p in group["params"]]
        for idx, st in saved.items():
            if idx == "@step":
                self.state["@step"] = int(st)
                continue
            p = params[idx]
            self.state[p] = {k: v.to(p.device, copy=True)
                             for k, v in st.items()}


class AdamW(Adam):
    """AdamW: the decay ``wd * w`` is added to the normalised update (on
    the master weight), not to the gradient (≙ the JAX `AdamW`)."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision)
