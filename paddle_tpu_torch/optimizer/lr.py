"""Learning-rate schedulers (≙ `paddle_tpu/optimizer/lr.py` whole).

A scheduler is called for the current rate and stepped by the caller,
once a step (or an epoch); an optimizer given one reads it at each of
its steps and keeps its `state_dict` under ``LR_Scheduler`` in its own.
The 19 schedulers compute JAX's rates in Python floats, with JAX's
state-dict keys (every plain attribute). ``verbose`` prints each new
rate. `LinearWarmup` takes a float or a scheduler, which it steps to
``last_epoch - warmup_steps`` after the warmup. `ReduceOnPlateau` is
stepped with the metric (a float, or anything with ``.item()``), and
lowers the rate by ``factor`` after ``patience`` steps without a
``threshold`` improvement, then waits ``cooldown`` steps.
"""
from __future__ import annotations

import math


class LRScheduler:
    """Base: ``sched()`` is the current rate, ``sched.step()`` advances
    ``last_epoch`` (or sets it to ``epoch``) and recomputes the rate by
    `get_lr`."""

    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
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
        if self.verbose:
            print(f"Epoch {self.last_epoch}: lr set to {self.last_lr}")

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        """Every plain attribute (``last_epoch``, ``last_lr``, the
        schedule's constants), as the JAX scheduler's."""
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state_dict):
        """Take a `state_dict` back; 0-d arrays (a checkpoint's form of
        a scalar) become Python scalars."""
        self.__dict__.update(
            {k: v.item() if getattr(v, "ndim", None) == 0 else v
             for k, v in state_dict.items()})

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5 *
                min(step ** -0.5, step * self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        ds = self.decay_steps
        if self.cycle:
            div = math.ceil(step / ds) if step > 0 else 1
            ds = ds * div
        else:
            step = min(step, ds)
        return ((self.base_lr - self.end_lr) *
                (1 - step / ds) ** self.power + self.end_lr)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        d = super().state_dict()
        d.pop("lr_lambda", None)
        return d


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        self._cur = float(learning_rate)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._cur = self._cur * self.lr_lambda(self.last_epoch)
        return self._cur


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(
            learning_rate if isinstance(learning_rate, float) else end_lr,
            last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / max(self.warmup_steps, 1)) + self.start_lr
        if isinstance(self.lr, LRScheduler):
            self.lr.step(self.last_epoch - self.warmup_steps)
            return self.lr()
        return float(self.lr)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min) *
                (1 + math.cos(math.pi * min(self.last_epoch, self.T_max)
                              / self.T_max)) / 2)


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = self.last_epoch
        t_i = self.T_0
        while t >= t_i:
            t -= t_i
            t_i *= self.T_mult
        return (self.eta_min + (self.base_lr - self.eta_min) *
                (1 + math.cos(math.pi * t / t_i)) / 2)


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        cur = float(metrics.item() if hasattr(metrics, "item") else metrics)
        self.last_epoch += 1
        if self.best is None:
            self.best = cur
            return
        if self.threshold_mode == "rel":
            better = cur < self.best * (1 - self.threshold) if \
                self.mode == "min" else cur > self.best * (1 + self.threshold)
        else:
            better = cur < self.best - self.threshold if self.mode == "min" \
                else cur > self.best + self.threshold
        if better:
            self.best = cur
            self.num_bad = 0
        else:
            if self.cooldown_counter > 0:
                self.cooldown_counter -= 1
            else:
                self.num_bad += 1
                if self.num_bad > self.patience:
                    new_lr = max(self.last_lr * self.factor, self.min_lr)
                    if self.last_lr - new_lr > self.epsilon:
                        self.last_lr = new_lr
                        if self.verbose:
                            print(f"ReduceOnPlateau: lr -> {new_lr}")
                    self.cooldown_counter = self.cooldown
                    self.num_bad = 0


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        self.three_phase = three_phase
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, a, b, pct):
        if self.anneal == "cos":
            return b + (a - b) * (1 + math.cos(math.pi * pct)) / 2
        return a + (b - a) * pct

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        up = int(self.phase_pct * self.total_steps)
        if step <= up and up > 0:
            return self._interp(self.initial_lr, self.max_lr, step / up)
        down = self.total_steps - up
        pct = (step - up) / max(down, 1)
        return self._interp(self.max_lr, self.end_lr, pct)


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.up + self.down
        cycle = self.last_epoch // total
        pos = self.last_epoch % total
        if pos < self.up:
            pct = pos / self.up
        else:
            pct = 1 - (pos - self.up) / self.down
        amp = (self.max_lr - self.base_lr) * pct
        if self.scale_fn is not None:
            x = cycle if self.scale_mode == "cycle" else self.last_epoch
            amp *= self.scale_fn(x)
        elif self.mode == "triangular2":
            amp /= 2 ** cycle
        elif self.mode == "exp_range":
            amp *= self.exp_gamma ** self.last_epoch
        return self.base_lr + amp


class LinearLR(LRScheduler):
    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        pct = min(self.last_epoch / self.total_steps, 1.0)
        f = self.start_factor + (self.end_factor - self.start_factor) * pct
        return self.base_lr * f


class CosineAnnealingWithWarmupDecay(LRScheduler):
    """Warmup + cosine decay to min_lr (the LLM pretraining schedule used by
    the reference's fleet recipes [U?])."""

    def __init__(self, max_lr, min_lr, warmup_step, decay_step, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_lr
        self.min_lr = min_lr
        self.warmup_step = warmup_step
        self.decay_step = decay_step
        super().__init__(max_lr, last_epoch, verbose)

    def get_lr(self):
        s = self.last_epoch
        if s < self.warmup_step:
            return self.max_lr * s / max(self.warmup_step, 1)
        if s >= self.decay_step:
            return self.min_lr
        pct = (s - self.warmup_step) / max(
            self.decay_step - self.warmup_step, 1)
        return (self.min_lr + (self.max_lr - self.min_lr) *
                (1 + math.cos(math.pi * pct)) / 2)
