"""Learning-rate schedulers.

Counterpart of paddle_tpu/optimizer/lr.py (the reference's
python/paddle/optimizer/lr.py): an `LRScheduler` holds the rate as a
host-side float, `step()` advances it (`step(metrics)` for
`ReduceOnPlateau`) and `get_lr()` reads it. The arithmetic is the JAX
package's, operation for operation, so the two give the same floats. An
optimizer given a scheduler as its ``learning_rate`` reads `get_lr()`
once per `step()`; stepping the scheduler is the caller's, as in JAX.
"""

from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
        self.step()

    def get_lr(self) -> float:
        return self.last_lr

    def _compute_lr(self) -> float:
        raise NotImplementedError

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self._compute_lr()

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma**n


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute_lr(self):
        return self.base_lr * self.gamma ** max(self.last_epoch, 0)


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute_lr(self):
        return self.base_lr * math.exp(-self.gamma * max(self.last_epoch, 0))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute_lr(self):
        return self.base_lr / (1 + self.gamma * max(self.last_epoch, 0))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute_lr(self):
        e = max(self.last_epoch, 0)
        if self.cycle:
            div = max(math.ceil(e / self.decay_steps), 1)
            steps = self.decay_steps * div
        else:
            steps = self.decay_steps
            e = min(e, steps)
        return ((self.base_lr - self.end_lr) * (1 - e / steps) ** self.power
                + self.end_lr)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute_lr(self):
        e = max(self.last_epoch, 0)
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * e / self.T_max)) / 2)


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1,
                 verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute_lr(self):
        e = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model**-0.5
                * min(e**-0.5, e * self.warmup_steps**-1.5))


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        nested = isinstance(learning_rate, LRScheduler)
        self.lr_sched = learning_rate if nested else None
        self.after_lr = None if nested else learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def _compute_lr(self):
        e = max(self.last_epoch, 0)
        if e < self.warmup_steps:
            return ((self.end_lr - self.start_lr) * e / self.warmup_steps
                    + self.start_lr)
        if self.lr_sched is not None:
            self.lr_sched.step(e - self.warmup_steps)
            return self.lr_sched.get_lr()
        return self.after_lr


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def _compute_lr(self):
        return self.base_lr * self.lr_lambda(max(self.last_epoch, 0))


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, cooldown=0, min_lr=0, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        super().__init__(learning_rate, -1, verbose)

    def _compute_lr(self):
        return self.last_lr if hasattr(self, "last_lr") else self.base_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            if not hasattr(self, "last_lr"):
                self.last_lr = self.base_lr
            self.last_epoch += 1
            return
        value = float(metrics.item() if hasattr(metrics, "item") else metrics)
        better = (
            self.best is None
            or (self.mode == "min" and value < self.best - self.threshold)
            or (self.mode == "max" and value > self.best + self.threshold)
        )
        if better:
            self.best = value
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.last_lr = max(self.last_lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        self.last_epoch += 1
