"""Adam and AdamW with Paddle's constructor and the JAX package's update.

Counterpart of paddle_tpu/optimizer/optimizer.py (Adam, AdamW) as
torch.optim.Optimizer subclasses. `step()` does what the JAX eager step
and the compiled TrainStep do: the optimizer's grad_clip over every
gradient, then, for each parameter, the update of `_adam_core` and
`AdamW._update` in the same order of operations:

    m = b1 m + (1 - b1) g          v = b2 v + (1 - b2) g g
    bc1 = 1 - b1^step              bc2 = 1 - b2^step     (fp32)
    p' = p - lr (m / bc1) / (sqrt(v / bc2) + eps)
    AdamW: p' = p' - lr wd p       (decoupled, from the old p)
    Adam:  g = g + wd p before the moments (coupled)

Parameters, gradients and moments are updated in place. The moments are
named as in the JAX package ("moment1", "moment2"), so its optimizer
state moves across (`weights.optimizer_state_from_numpy`).

`parameters` may be `model.named_parameters()`; AdamW's
`apply_decay_param_fun` receives each parameter's flat name, as the JAX
functional path passes it. Only fp32 parameters are taken: master
weights (multi_precision) exist only for lower-precision ones, and those
wait for bf16 AMP training.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

AMP_ITEM = "ROADMAP.md 'Still to port' item 16 (bf16 AMP training)"
LR_ITEM = "ROADMAP.md 'Still to port' item 17 (LR schedulers)"


class Optimizer(torch.optim.Optimizer):
    """Paddle's optimizer constructor (learning_rate, parameters,
    weight_decay, grad_clip) over torch.optim."""

    def __init__(self, learning_rate, parameters, weight_decay, grad_clip):
        if isinstance(learning_rate, bool) or \
                not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                f"learning_rate={type(learning_rate).__name__}: only a "
                f"constant learning rate is ported; {LR_ITEM}")
        if parameters is None:
            raise ValueError("the optimizer needs its parameters")
        params, self._names = [], {}
        for item in parameters:
            name, p = item if isinstance(item, tuple) else (None, item)
            if p.dtype != torch.float32:
                raise NotImplementedError(
                    f"parameter {name or tuple(p.shape)} is {p.dtype}: only "
                    f"fp32 parameters are trained (master weights wait for "
                    f"{AMP_ITEM})")
            params.append(p)
            if name is not None:
                self._names[p] = name
        super().__init__(params, {"lr": float(learning_rate)})
        self._lr = float(learning_rate)
        self._weight_decay = 0.0 if weight_decay is None \
            else float(weight_decay)
        self._grad_clip = grad_clip
        self._step_i = 0

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
        return st

    def _decay_for(self, p) -> float:
        return self._weight_decay

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("step(closure) is not supported")
        params = [p for group in self.param_groups for p in group["params"]
                  if p.grad is not None]
        if self._grad_clip is not None:
            self._grad_clip.clip_([p.grad for p in params])
        self._step_i += 1
        for p in params:
            self._update(p, p.grad, self._state(p), self._lr,
                         self._decay_for(p), self._step_i)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        if lazy_mode:
            raise NotImplementedError(f"lazy_mode: ROADMAP.md 'Still to "
                                      f"port' item 12 (the framework)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _bias_corrections(self, step: int):
        """1 - beta^step for both betas, in fp32 as the JAX update has it."""
        one, st = np.float32(1.0), np.float32(step)
        return (float(one - np.float32(self._beta1) ** st),
                float(one - np.float32(self._beta2) ** st))

    def _adam_update(self, g, st, lr, step):
        """The Adam step of `_adam_core`: updates the moments in place and
        returns lr * update."""
        b1, b2 = self._beta1, self._beta2
        m, v = st["moment1"], st["moment2"]
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        bc1, bc2 = self._bias_corrections(step)
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(self._eps))
        return upd.mul_(lr)

    def _update(self, p, g, st, lr, wd, step):
        if wd:
            g = g + wd * p
        p.sub_(self._adam_update(g, st, lr, step))


class AdamW(Adam):
    """Decoupled weight decay (reference adamw.py:49)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, apply_decay_param_fun=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision=multi_precision)
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

    def _update(self, p, g, st, lr, wd, step):
        upd = self._adam_update(g, st, lr, step)
        # the decoupled decay uses the old p: lr * wd * p is taken first
        decay = p * float(np.float32(lr) * np.float32(wd)) if wd else None
        p.sub_(upd)
        if decay is not None:
            p.sub_(decay)
