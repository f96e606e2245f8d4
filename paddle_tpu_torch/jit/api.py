"""TrainStep: one training step of a model, its loss and its optimizer.

Counterpart of paddle_tpu/jit/api.py::TrainStep for fp32 training on one
device. The JAX step is one compiled program over donated copies of the
parameters; PyTorch runs eagerly, so here the step works on the model's
own parameters in place and `sync()` has nothing to write back.

    step = TrainStep(model, llama_loss_fn, AdamW(parameters=...))
    loss = step(input_ids, labels)      # a 0-d tensor on the device

Each call runs, in order: the forward, `loss_fn(outputs, *labels)`, the
backward, the optimizer's grad_clip and update (`optimizer.step()`), and
`zero_grad(set_to_none=True)`. Nothing in it waits for the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.optimizer.optimizer import AMP_ITEM


class TrainStep:
    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 n_inputs: int = 1, amp_level: Optional[str] = None,
                 amp_dtype: str = "bfloat16", in_shardings=None, mesh=None):
        if amp_level is not None:
            raise NotImplementedError(
                f"amp_level={amp_level!r}: only fp32 training is ported; "
                f"{AMP_ITEM}, with bf16 operands for the flash kernels")
        if mesh is not None or in_shardings is not None:
            raise NotImplementedError(
                "mesh / in_shardings: sharded training is not ported yet: "
                "ROADMAP.md 'Still to port' item 13 (distributed training)")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.n_inputs = n_inputs
        self.device = next(model.parameters()).device
        optimizer.adopt_names(model)

    def _as_tensor(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def __call__(self, *batch):
        batch = [self._as_tensor(b) for b in batch]
        inputs, labels = batch[:self.n_inputs], batch[self.n_inputs:]
        loss = self.loss_fn(self.model(*inputs), *labels)
        loss.backward()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    def sync(self) -> torch.nn.Module:
        """The model, whose parameters are the trained ones."""
        return self.model
