"""Optimizers with f32 master weights, as `torch.optim.Optimizer`s
(≙ `paddle_tpu/optimizer/__init__.py` whole).

`Optimizer` is the JAX base: the step count (one for every parameter,
bumped before the updates), the rate (a float or an `lr.LRScheduler`,
read at every step; `set_lr`, `set_lr_scheduler`), the clip
(`nn.ClipGradByGlobalNorm`, `ClipGradByNorm`, `ClipGradByValue`, applied
to the gradients before the update), ``weight_decay`` and master
weights. Each subclass updates one parameter as the JAX one does, in
its order, on f32 values: the f32 master weight when
``multi_precision`` is set and the parameter is bf16 or f16, else the
parameter read as f32 (SGD and Momentum without master weights update
in the parameter's dtype, as JAX's), the result cast back to the
parameter's dtype. Adam, for instance (`_adam_core`):

    g  = f32(grad)            [+ wd * w     Adam's coupled decay]
    m  = b1 * m + (1 - b1) * g
    v  = b2 * v + (1 - b2) * g^2            [vmax = max(vmax, v): amsgrad]
    w' = w - lr * (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps)
                   [+ wd * w                AdamW's decoupled decay])

The optimizers: `SGD`, `Momentum`, `Adam` (``amsgrad``; ``lazy_mode`` is
accepted and changes nothing, as in JAX, where every gradient is dense),
`AdamW` (``apply_decay_param_fun``, ``lr_ratio``), `Adamax`, `Adagrad`,
`Adadelta`, `RMSProp`, `Lamb`, `NAdam`, `RAdam`, `Rprop`, `ASGD` and
`LBFGS` (``step(closure)``). ``parameters`` is a list of tensors, of
``(name, tensor)`` pairs (``named_parameters()``: the names are what
``apply_decay_param_fun`` is asked about; a tensor's own ``name``
attribute is asked otherwise) or of param-group dicts, whose parameters
all take the optimizer's options (the JAX optimizer reads no option of a
group). `AdamW`'s ``lr_ratio(p)`` scales a parameter's rate as the
reference's does; the JAX `AdamW` stores it and never reads it.

State comes in two forms. torch's own `state_dict()` / `load_state_dict`
(per-parameter index, f32 kept f32); and the JAX optimizer's,
`paddle_state_dict()` / `set_state_dict`, which
`distributed.fleet.elastic.ElasticManager` writes as a checkpoint's
``opt`` group: ``<accumulator>_<k>`` under each optimizer's JAX
accumulator names (``moment1``, ``velocity``, ``inf_norm``, ...),
``master_<k>``, the scheduler's state under ``LR_Scheduler`` and the
step count under ``@step``, where ``<k>`` is a parameter's Paddle name
or, as a torch parameter has none, its index.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from . import lr as lr  # noqa: F401
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "NAdam", "RAdam",
           "Rprop", "ASGD", "LBFGS", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "lr"]


def _split_names(parameters):
    """(torch params or groups, {id(param): name}) of the constructor's
    ``parameters``."""
    items = list(parameters)
    names = {}
    if items and isinstance(items[0], tuple):
        names = {id(p): n for n, p in items}
        items = [p for _, p in items]
    return items, names


class Optimizer(torch.optim.Optimizer):
    """The JAX base optimizer (module docstring). A subclass names its
    accumulators in `_accumulators` and updates one parameter in
    `_update`."""

    _ACCUMULATORS: tuple = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        params, self._names = _split_names(parameters)
        self._learning_rate = learning_rate
        super().__init__(params, dict(lr=self.get_lr()))
        if grad_clip is not None and not callable(grad_clip):
            raise TypeError(f"grad_clip must be a clip (nn.ClipGradBy*), "
                            f"got {grad_clip!r}")
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._weight_decay = weight_decay
        # the JAX optimizer's `_step_count`, kept in the state dict
        self.state["@step"] = 0

    # -- rate ------------------------------------------------------------------
    def get_lr(self) -> float:
        """The rate of the next step: the scheduler's current value, or
        the float given."""
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when learning rate is a scheduler")
        self._learning_rate = float(value)
        for group in self.param_groups:
            group["lr"] = self._learning_rate

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # -- per-parameter state ---------------------------------------------------
    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def _accumulators(self) -> tuple:
        return self._ACCUMULATORS

    def _use_master(self, p) -> bool:
        return self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16)

    def _weight(self, p):
        """The value JAX updates: the f32 master weight (made from the
        parameter at first use), else the parameter."""
        if self._use_master(p):
            st = self.state[p]
            if "master" not in st:
                st["master"] = p.detach().float()
            return st["master"]
        return p.detach()

    def _acc(self, p, name, init=None):
        """Accumulator ``name`` of ``p``: f32 zeros (or ``init``) at
        first use."""
        st = self.state[p]
        if name not in st:
            st[name] = torch.zeros_like(p, dtype=torch.float32) \
                if init is None else init
        return st[name]

    def _write(self, p, new):
        """``new`` as ``p``'s master weight (when it has one) and, cast
        to the parameter's dtype, as its value."""
        if self._use_master(p):
            self.state[p]["master"] = new
        p.copy_(new)

    def _wd(self) -> float:
        wd = self._weight_decay
        if isinstance(wd, (int, float)) or callable(
                getattr(wd, "__float__", None)):
            return float(wd)
        return 0.0

    def _name(self, p):
        return self._names.get(id(p)) or getattr(p, "name", None)

    # -- step ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        pairs = [(p, p.grad) for p in self._params()
                 if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None and pairs:
            clipped = self._grad_clip([g for _, g in pairs])
            pairs = [(p, g) for (p, _), g in zip(pairs, clipped)]
        self.state["@step"] += 1
        lr = self.get_lr()
        for p, g in pairs:
            self._update(p, g, lr)
        return loss

    def _update(self, p, g, lr):
        raise TypeError(f"{type(self).__name__} has no update rule")

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._params():
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    # -- the JAX state dict ------------------------------------------------
    @staticmethod
    def _key(p, i) -> str:
        return str(getattr(p, "name", None) or i)

    def paddle_state_dict(self) -> dict:
        """The JAX optimizer's state dict (module docstring): the
        accumulators by name then parameter, the master weights, the
        scheduler's state and ``@step``; the tensors are the live state,
        not copies."""
        sd = {}
        params = self._params()
        for name in self._accumulators() + ("master",):
            for i, p in enumerate(params):
                st = self.state.get(p)
                if st and name in st:
                    sd[f"{name}_{self._key(p, i)}"] = st[name]
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        sd["@step"] = self.state["@step"]
        return sd

    def set_state_dict(self, state_dict):
        """Take the JAX optimizer's form back (`paddle_state_dict`'s, or
        a checkpoint's flat ``{dotted key: array}`` form of it, the
        scheduler's values under ``LR_Scheduler.<name>``); each
        accumulator and master weight lands on its parameter's device as
        f32. A tensor already there in f32 is taken over, not copied (a
        checkpoint's optimizer state may be most of the card)."""
        self.state["@step"] = int(state_dict.get("@step", 0))
        sched = state_dict.get("LR_Scheduler")
        if not isinstance(sched, dict):
            pre = "LR_Scheduler."
            sched = {k[len(pre):]: v for k, v in state_dict.items()
                     if k.startswith(pre)}
        if sched and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(sched)
        for i, p in enumerate(self._params()):
            for name in self._accumulators() + ("master",):
                v = state_dict.get(f"{name}_{self._key(p, i)}")
                if v is None:
                    continue
                if not isinstance(v, torch.Tensor):
                    v = torch.from_numpy(np.array(v, np.float32))
                self.state[p][name] = v.to(p.device, torch.float32)

    def load_state_dict(self, state_dict):
        """As `torch.optim.Optimizer.load_state_dict`, but the f32
        accumulators and master weights stay f32 (torch's would cast
        them to each parameter's dtype, which loses a bf16 model's
        master weights)."""
        saved = dict(state_dict["state"])
        super().load_state_dict(state_dict)
        params = self._params()
        for idx, st in saved.items():
            if idx == "@step":
                self.state["@step"] = int(st)
                continue
            p = params[idx]
            self.state[p] = {k: v.to(p.device, copy=True)
                             for k, v in st.items()}


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _update(self, p, g, lr):
        wd = self._wd()
        if self._use_master(p):
            m = self._weight(p)
            g32 = g.float()
            if wd:
                g32 = g32 + wd * m
            self._write(p, m - lr * g32)
        else:
            w = p.detach()
            if wd:
                g = g + wd * w
            p.copy_(w - lr * g)


class Momentum(Optimizer):
    _ACCUMULATORS = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, p, g, lr):
        wd = self._wd()
        mw = self._weight(p)
        g = g.to(mw.dtype)
        if wd:
            g = g + wd * mw
        vel = self._acc(p, "velocity", torch.zeros_like(mw))
        vel = self._momentum * vel + g
        self.state[p]["velocity"] = vel
        upd = g + self._momentum * vel if self._nesterov else vel
        self._write(p, mw - lr * upd)


class Adam(Optimizer):
    """Adam with the JAX package's arguments and update. ``weight_decay``
    is coupled (added to the gradient); `AdamW` decouples it."""

    _ACCUMULATORS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._amsgrad = amsgrad

    def _accumulators(self):
        return self._ACCUMULATORS + (("moment2_max",) if self._amsgrad
                                     else ())

    def _adam_core(self, p, g, lr, decoupled_wd=0.0, coupled_wd=0.0):
        w = self._weight(p).float()
        g = g.float()
        if coupled_wd:
            g = g + coupled_wd * w
        b1, b2 = self._beta1, self._beta2
        t = self.state["@step"]
        m = self._acc(p, "moment1")
        v = self._acc(p, "moment2")
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g.square(), alpha=1 - b2)
        mhat = m / (1 - b1 ** t)
        if self._amsgrad:
            vmax = self._acc(p, "moment2_max")
            torch.maximum(vmax, v, out=vmax)
            vhat = vmax / (1 - b2 ** t)
        else:
            vhat = v / (1 - b2 ** t)
        upd = mhat / (vhat.sqrt_() + self._epsilon)
        if decoupled_wd:
            upd.add_(w, alpha=decoupled_wd)
        self._write(p, w - lr * upd)

    def _update(self, p, g, lr):
        self._adam_core(p, g, lr, coupled_wd=self._wd())


class AdamW(Adam):
    """AdamW: the decay ``wd * w`` is added to the normalised update (on
    the master weight), not to the gradient. ``apply_decay_param_fun
    (name)`` False exempts a parameter from the decay; ``lr_ratio(p)``
    scales its rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad, name)
        self._weight_decay = weight_decay
        self._apply_decay_fn = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _update(self, p, g, lr):
        wd = float(self._weight_decay) if self._weight_decay else 0.0
        if self._apply_decay_fn is not None and not self._apply_decay_fn(
                self._name(p)):
            wd = 0.0
        if self._lr_ratio is not None:
            lr = lr * float(self._lr_ratio(p))
        self._adam_core(p, g, lr, decoupled_wd=wd)


class Adamax(Optimizer):
    _ACCUMULATORS = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, p, g, lr):
        w = p.detach().float()
        g = g.float()
        if self._wd():
            g = g + self._wd() * w
        m = self._beta1 * self._acc(p, "moment") + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * self._acc(p, "inf_norm"), g.abs())
        self.state[p].update(moment=m, inf_norm=u)
        t = self.state["@step"]
        p.copy_(w - lr / (1 - self._beta1 ** t) * m / (u + self._epsilon))


class Adagrad(Optimizer):
    _ACCUMULATORS = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update(self, p, g, lr):
        w = p.detach().float()
        g = g.float()
        if self._wd():
            g = g + self._wd() * w
        acc = self._acc(p, "moment", torch.full_like(
            p, self._init_acc, dtype=torch.float32)) + g.square()
        self.state[p]["moment"] = acc
        p.copy_(w - lr * g / (acc.sqrt() + self._epsilon))


class Adadelta(Optimizer):
    _ACCUMULATORS = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._epsilon, self._rho = epsilon, rho

    def _update(self, p, g, lr):
        w = p.detach().float()
        g = g.float()
        if self._wd():
            g = g + self._wd() * w
        rho, eps = self._rho, self._epsilon
        avg_sq = rho * self._acc(p, "avg_squared_grad") \
            + (1 - rho) * g.square()
        avg_up = self._acc(p, "avg_squared_update")
        upd = ((avg_up + eps).sqrt() / (avg_sq + eps).sqrt()) * g
        avg_up = rho * avg_up + (1 - rho) * upd.square()
        self.state[p].update(avg_squared_grad=avg_sq,
                             avg_squared_update=avg_up)
        p.copy_(w - lr * upd)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _accumulators(self):
        return ("mean_square",) + (("mean_grad",) if self._centered
                                   else ()) + ("momentum",)

    def _update(self, p, g, lr):
        w = p.detach().float()
        g = g.float()
        if self._wd():
            g = g + self._wd() * w
        rho, eps = self._rho, self._epsilon
        ms = rho * self._acc(p, "mean_square") + (1 - rho) * g.square()
        self.state[p]["mean_square"] = ms
        if self._centered:
            mg = rho * self._acc(p, "mean_grad") + (1 - rho) * g
            self.state[p]["mean_grad"] = mg
            denom = (ms - mg.square() + eps).sqrt()
        else:
            denom = (ms + eps).sqrt()
        mom = self._momentum * self._acc(p, "momentum") + lr * g / denom
        self.state[p]["momentum"] = mom
        p.copy_(w - mom)


class Lamb(Optimizer):
    """Layer-wise adaptive moments: the Adam direction plus decay,
    scaled by ``||w|| / ||r||`` (1 where either is 0).
    ``exclude_from_weight_decay_fn(p)`` True drops a parameter's
    decay."""

    _ACCUMULATORS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._wd_value = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update(self, p, g, lr):
        w = self._weight(p).float()
        g = g.float()
        b1, b2 = self._beta1, self._beta2
        t = self.state["@step"]
        m = b1 * self._acc(p, "moment1") + (1 - b1) * g
        v = b2 * self._acc(p, "moment2") + (1 - b2) * g.square()
        self.state[p].update(moment1=m, moment2=v)
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        wd = self._wd_value
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        r = mhat / (vhat.sqrt() + self._epsilon) + wd * w
        w_norm = w.square().sum().sqrt()
        r_norm = r.square().sum().sqrt()
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        self._write(p, w - lr * trust * r)


class NAdam(Optimizer):
    """Nesterov Adam, with the momentum schedule ``mu_t = b1 (1 - 0.5 *
    0.96^(t * momentum_decay))`` and its running product (a 0-d
    accumulator)."""

    _ACCUMULATORS = ("mu_product", "moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2 = beta1, beta2
        self._epsilon = epsilon
        self._md = momentum_decay

    def _update(self, p, g, lr):
        w = self._weight(p).float()
        g = g.float()
        if self._wd():
            g = g + self._wd() * w
        b1, b2 = self._beta1, self._beta2
        t = self.state["@step"]
        mu_t = b1 * (1.0 - 0.5 * 0.96 ** (t * self._md))
        mu_t1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * self._md))
        mu_prod = self._acc(p, "mu_product", torch.zeros(
            (), dtype=torch.float32, device=p.device))
        # the accumulator starts at 0, read as the empty product 1
        mu_prod = torch.where(mu_prod == 0, 1.0, mu_prod) * mu_t
        m = b1 * self._acc(p, "moment1") + (1 - b1) * g
        v = b2 * self._acc(p, "moment2") + (1 - b2) * g.square()
        self.state[p].update(mu_product=mu_prod, moment1=m, moment2=v)
        ghat = g * (1 - mu_t) / (1 - mu_prod)
        mhat = m * mu_t1 / (1 - mu_prod * mu_t1)
        vhat = v / (1 - b2 ** t)
        self._write(p, w - lr * (ghat + mhat) / (vhat.sqrt()
                                                 + self._epsilon))


class RAdam(Optimizer):
    """Rectified Adam: the adaptive step once the variance's estimate
    ``rho_t`` passes 5, the momentum step before."""

    _ACCUMULATORS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2 = beta1, beta2
        self._epsilon = epsilon

    def _update(self, p, g, lr):
        w = self._weight(p).float()
        g = g.float()
        if self._wd():
            g = g + self._wd() * w
        b1, b2 = self._beta1, self._beta2
        t = self.state["@step"]
        m = b1 * self._acc(p, "moment1") + (1 - b1) * g
        v = b2 * self._acc(p, "moment2") + (1 - b2) * g.square()
        self.state[p].update(moment1=m, moment2=v)
        mhat = m / (1 - b1 ** t)
        rho_inf = 2.0 / (1 - b2) - 1.0
        rho_t = rho_inf - 2.0 * t * (b2 ** t) / (1 - b2 ** t)
        if rho_t > 5.0:
            vhat = (v / (1 - b2 ** t)).sqrt()
            r = math.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf)
                          / ((rho_inf - 4) * (rho_inf - 2) * rho_t))
            new = w - lr * r * mhat / (vhat + self._epsilon)
        else:
            new = w - lr * mhat
        self._write(p, new)


class Rprop(Optimizer):
    """Resilient backprop: a per-element step size grown by ``etas[1]``
    while the gradient keeps its sign and shrunk by ``etas[0]`` when it
    flips (that element then skips its move), within
    ``learning_rate_range``."""

    _ACCUMULATORS = ("prev_grad", "step_size")

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas
        self._init_lr = learning_rate

    def _update(self, p, g, lr):
        w = self._weight(p).float()
        g = g.float()
        prev = self._acc(p, "prev_grad")
        step = self._acc(p, "step_size", torch.full_like(
            p, float(self._init_lr), dtype=torch.float32))
        sign = torch.sign(g * prev)
        step = torch.where(sign > 0, step * self._eta_pos,
                           torch.where(sign < 0, step * self._eta_neg, step)
                           ).clamp(self._lr_min, self._lr_max)
        g_eff = torch.where(sign < 0, 0.0, g)
        self.state[p].update(prev_grad=g_eff, step_size=step)
        self._write(p, w - torch.sign(g_eff) * step)


class ASGD(Optimizer):
    """Averaged SGD in JAX's streaming form: ``d`` and ``ys`` drop their
    mean over ``batch_num`` and take the new gradient; the step is ``lr /
    batch_num * d``."""

    _ACCUMULATORS = ("d", "ys")

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._batch_num = batch_num

    def _update(self, p, g, lr):
        w = self._weight(p).float()
        g = g.float()
        if self._wd():
            g = g + self._wd() * w
        ys = self._acc(p, "ys")
        oldest = ys / self._batch_num
        d = self._acc(p, "d") - oldest + g
        ys = ys - oldest + g
        self.state[p].update(d=d, ys=ys)
        self._write(p, w - lr / self._batch_num * d)


class LBFGS(Optimizer):
    """Limited-memory BFGS (≙ the JAX `LBFGS`): ``step(closure)``, where
    the closure clears nothing, computes the loss, calls its
    ``backward()`` and returns it. Each inner iteration takes the
    two-loop direction; without ``line_search_fn`` a fixed step of the
    rate (the first ever damped by ``min(1, 1 / sum |g|)``), with
    ``"strong_wolfe"`` a backtracking search for the Armijo and
    curvature conditions. Eager by nature: the closure runs a
    data-dependent number of times."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-07, tolerance_change=1e-09,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._max_iter = max_iter
        self._max_eval = max_eval or max_iter * 5 // 4
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history = history_size
        self._line_search = line_search_fn
        self._s_hist: list = []
        self._y_hist: list = []
        self._n_inner = 0           # inner iterations over all steps

    def _flat_params(self):
        return torch.cat([p.detach().float().reshape(-1)
                          for p in self._params()])

    def _set_flat_params(self, flat):
        off = 0
        for p in self._params():
            n = p.numel()
            p.copy_(flat[off:off + n].view_as(p))
            off += n

    def _flat_grad(self):
        return torch.cat([
            torch.zeros(p.numel(), dtype=torch.float32, device=p.device)
            if p.grad is None else p.grad.float().reshape(-1)
            for p in self._params()])

    def _eval(self, closure):
        for p in self._params():
            p.grad = None
        with torch.enable_grad():
            loss = closure()
        return float(loss), self._flat_grad()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step needs a closure returning the "
                             "loss (it re-evaluates the model)")
        loss, g = self._eval(closure)
        evals = 1
        for _ in range(self._max_iter):
            if float(g.abs().max()) <= self._tol_grad:
                break
            q = -g
            alphas = []
            for s, y in reversed(list(zip(self._s_hist, self._y_hist))):
                rho = 1.0 / float(torch.dot(y, s))
                a = rho * float(torch.dot(s, q))
                alphas.append((a, rho, s, y))
                q = q - a * y
            if self._y_hist:
                y_last, s_last = self._y_hist[-1], self._s_hist[-1]
                gamma = float(torch.dot(s_last, y_last) / torch.clamp(
                    torch.dot(y_last, y_last), min=1e-10))
                q = q * gamma
            for a, rho, s, y in reversed(alphas):
                b = rho * float(torch.dot(y, q))
                q = q + (a - b) * s
            d = q
            x0, g0, f0 = self._flat_params(), g, loss
            gtd = float(torch.dot(g, d))
            if gtd > -1e-15:
                break
            t = self.get_lr()
            self._n_inner += 1
            if self._line_search is None:
                if self._n_inner == 1:
                    t = min(1.0, 1.0 / float(g.abs().sum())) * t
                self._set_flat_params(x0 + t * d)
                loss, g = self._eval(closure)
                evals += 1
            else:
                ok = False
                for _ls in range(25):
                    self._set_flat_params(x0 + t * d)
                    loss, g = self._eval(closure)
                    evals += 1
                    if loss <= f0 + 1e-4 * t * gtd and \
                            abs(float(torch.dot(g, d))) <= 0.9 * abs(gtd):
                        ok = True
                        break
                    t *= 0.5
                    if evals >= self._max_eval:
                        break
                if not ok:
                    self._set_flat_params(x0)
                    loss, g = self._eval(closure)
                    break
            s = self._flat_params() - x0
            y = g - g0
            if float(torch.dot(s, y)) > 1e-10:
                self._s_hist.append(s)
                self._y_hist.append(y)
                if len(self._s_hist) > self._history:
                    self._s_hist.pop(0)
                    self._y_hist.pop(0)
            if abs(f0 - loss) < self._tol_change:
                break
            if evals >= self._max_eval:
                break
        self.state["@step"] += 1
        return torch.tensor(loss, dtype=torch.float32)
