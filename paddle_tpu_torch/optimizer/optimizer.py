"""Adam and AdamW with Paddle's constructor and the JAX package's update.

Counterpart of paddle_tpu/optimizer/optimizer.py (Adam, AdamW) as
torch.optim.Optimizer subclasses. `step()` does what the JAX eager step
and the compiled TrainStep do: the optimizer's grad_clip over every
gradient, then the update of `_adam_core` and `AdamW._update` in the same
order of operations, in fp32:

    m = b1 m + (1 - b1) g          v = b2 v + (1 - b2) g g
    bc1 = 1 - b1^step              bc2 = 1 - b2^step     (fp32)
    p' = p - lr (m / bc1) / (sqrt(v / bc2) + eps)
    AdamW: p' = p' - lr wd p       (decoupled, from the old p)
    Adam:  g = g + wd p before the moments (coupled)

with g the gradient in fp32 and p the parameter's fp32 master copy where
it has one. Master weights (multi_precision, on by default): a parameter
that is not fp32 (bf16 after `amp.decorate(level="O2")`) keeps an fp32
copy under ``"master"`` in its state, as the JAX `Adam._init_state` does;
the update reads and writes the master copy and then writes
``master.to(p.dtype)`` into the parameter. Without multi_precision such a
parameter is updated from its own value in fp32 and rounded back.

`step()` runs the update as multi-tensor (`torch._foreach_*`) operations
over the parameters grouped by (weight decay, fp32 or not); `_update`
is that one body, over a list of parameters (one, in the tests that hold
it against the JAX `_update`). A group goes through in chunks of at most
FOREACH_ELEMENTS elements, so the update's temporaries (about five fp32
copies of what it updates at once) stay near 2.5 GiB whatever the
model's size. Parameters, gradients, moments and master copies are
updated in place. The state is named as in
the JAX package ("moment1", "moment2", "master"), so its optimizer state
moves across (`weights.optimizer_state_from_numpy`).

`parameters` may be `model.named_parameters()`; AdamW's
`apply_decay_param_fun` receives each parameter's flat name, as the JAX
functional path passes it. ``learning_rate`` is a number or an
`optimizer.lr.LRScheduler`, whose `get_lr()` is read once per `step()` on
the host and passed as the ``lr`` of `_update`; the caller steps the
scheduler, as in JAX. `state_dict` carries the scheduler's state under
``"lr_scheduler"`` and the step count under ``"step"``, as the JAX
optimizer's does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.optimizer.lr import LRScheduler

# the elements one multi-tensor pass of `step()` updates at most
FOREACH_ELEMENTS = 1 << 27


def _chunks(params):
    """Consecutive runs of ``params`` of at most FOREACH_ELEMENTS elements
    (a larger parameter alone)."""
    run, size = [], 0
    for p in params:
        if run and size + p.numel() > FOREACH_ELEMENTS:
            yield run
            run, size = [], 0
        run.append(p)
        size += p.numel()
    if run:
        yield run


class Optimizer(torch.optim.Optimizer):
    """Paddle's optimizer constructor (learning_rate, parameters,
    weight_decay, grad_clip, name), the JAX base's signature, over
    torch.optim. torch.optim needs the parameters up front, so
    ``parameters=None`` raises here (the JAX optimizer raises at its
    first step instead)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, *,
                 multi_precision=False):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float, LRScheduler)):
            raise TypeError(
                f"learning_rate={type(learning_rate).__name__}: expected a "
                "number or a paddle_tpu_torch.optimizer.lr.LRScheduler")
        if parameters is None:
            raise ValueError("the optimizer needs its parameters")
        params, self._names = [], {}
        for item in parameters:
            pname, p = item if isinstance(item, tuple) else (None, item)
            if not p.is_floating_point():
                raise TypeError(f"parameter {pname or tuple(p.shape)} is "
                                f"{p.dtype}, not a floating type")
            params.append(p)
            if pname is not None:
                self._names[p] = pname
        self._lr_scheduler = learning_rate \
            if isinstance(learning_rate, LRScheduler) else None
        self._lr = learning_rate if self._lr_scheduler is not None \
            else float(learning_rate)
        super().__init__(params, {"lr": self.get_lr()})
        self._weight_decay = 0.0 if weight_decay is None \
            else float(weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._step_i = 0

    def get_lr(self) -> float:
        """The rate the next step uses: the scheduler's, or the number."""
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler.get_lr())
        return float(self._lr)

    def set_lr(self, value) -> None:
        if self._lr_scheduler is not None:
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def state_dict(self):
        """torch.optim's state (the moments, the master copies) plus the
        JAX optimizer's ``"step"`` and, under a scheduler,
        ``"lr_scheduler"``."""
        out = super().state_dict()
        out["step"] = self._step_i
        if self._lr_scheduler is not None:
            out["lr_scheduler"] = self._lr_scheduler.state_dict()
        return out

    def set_state_dict(self, state) -> None:
        """The inverse of `state_dict`."""
        state = dict(state)
        self._step_i = int(state.pop("step", 0))
        sched = state.pop("lr_scheduler", None)
        if self._lr_scheduler is not None and sched is not None:
            self._lr_scheduler.set_state_dict(sched)
        self.load_state_dict(state)

    def adopt_names(self, model) -> None:
        """Name the parameters that came without a name after `model`'s
        flat parameter names."""
        for name, p in model.named_parameters():
            self._names.setdefault(p, name)

    def _state(self, p) -> Dict[str, torch.Tensor]:
        st = self.state[p]
        if not st:
            st["moment1"] = torch.zeros_like(p, dtype=torch.float32)
            st["moment2"] = torch.zeros_like(p, dtype=torch.float32)
            if self._multi_precision and p.dtype != torch.float32:
                st["master"] = p.detach().float()
        return st

    def _decay_for(self, p) -> float:
        return self._weight_decay

    @staticmethod
    def _fp32_of(p, st):
        """The fp32 value the update works on: the master copy, the
        parameter itself (fp32), or an fp32 copy of it (written back)."""
        if "master" in st:
            return st["master"]
        return p if p.dtype == torch.float32 else p.detach().float()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("step(closure) is not supported")
        params = [p for group in self.param_groups for p in group["params"]
                  if p.grad is not None]
        if self._grad_clip is not None:
            self._grad_clip.clip_([p.grad for p in params])
        self._step_i += 1
        lr = self.get_lr()
        for group in self.param_groups:
            group["lr"] = lr
        groups = {}
        for p in params:
            key = (self._decay_for(p), p.dtype == torch.float32)
            groups.setdefault(key, []).append(p)
        for (wd, _), group in groups.items():
            for ps in _chunks(group):
                self._update(ps, [p.grad for p in ps], lr, wd,
                             self._step_i)

    def _update(self, ps, gs, lr, wd, step):
        """The update of parameters ``ps`` of one decay by gradients
        ``gs``: multi-tensor operations on their fp32 values (masters or
        the parameters), written back into the parameters that are not
        fp32."""
        sts = [self._state(p) for p in ps]
        p32s = [self._fp32_of(p, st) for p, st in zip(ps, sts)]
        self._update_fp32(p32s, [g.float() for g in gs], sts, lr, wd, step)
        if any(p32 is not p for p, p32 in zip(ps, p32s)):
            torch._foreach_copy_(ps, p32s)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        if lazy_mode:
            raise NotImplementedError(f"lazy_mode: ROADMAP.md 'Still to "
                                      f"port' item 12 (the framework)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _bias_corrections(self, step: int):
        """1 - beta^step for both betas, in fp32 as the JAX update has it."""
        one, st = np.float32(1.0), np.float32(step)
        return (float(one - np.float32(self._beta1) ** st),
                float(one - np.float32(self._beta2) ** st))

    def _adam_update(self, gs, sts, lr, step):
        """The Adam step of `_adam_core` over lists: updates the moments
        in place and returns lr * update."""
        b1, b2 = self._beta1, self._beta2
        ms = [st["moment1"] for st in sts]
        vs = [st["moment2"] for st in sts]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
        torch._foreach_mul_(vs, b2)
        gg = torch._foreach_mul(gs, 1 - b2)
        torch._foreach_mul_(gg, gs)
        torch._foreach_add_(vs, gg)
        bc1, bc2 = self._bias_corrections(step)
        upd = torch._foreach_div(ms, bc1)
        den = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._eps)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, lr)
        return upd

    def _update_fp32(self, p32s, gs, sts, lr, wd, step):
        if wd:
            gs = torch._foreach_add(gs, torch._foreach_mul(p32s, wd))
        torch._foreach_sub_(p32s, self._adam_update(gs, sts, lr, step))


class AdamW(Adam):
    """Decoupled weight decay (reference adamw.py:49)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, apply_decay_param_fun=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision=multi_precision,
                         name=name)
        self._weight_decay = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_for(self, p) -> float:
        if self._apply_decay_param_fun is None:
            return self._weight_decay
        name: Optional[str] = self._names.get(p)
        if name is None:
            raise ValueError(
                "apply_decay_param_fun needs parameter names: pass "
                "parameters=model.named_parameters()")
        return self._weight_decay if self._apply_decay_param_fun(name) \
            else 0.0

    @staticmethod
    def _decay_factor(lr, wd) -> float:
        """lr * wd in fp32, as the JAX update forms it before the product
        with the old p."""
        return float(np.float32(lr) * np.float32(wd))

    def _update_fp32(self, p32s, gs, sts, lr, wd, step):
        upd = self._adam_update(gs, sts, lr, step)
        decay = (torch._foreach_mul(p32s, self._decay_factor(lr, wd))
                 if wd else None)
        torch._foreach_sub_(p32s, upd)
        if decay is not None:
            torch._foreach_sub_(p32s, decay)
