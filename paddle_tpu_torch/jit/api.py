"""TrainStep: one training step of a model, its loss and its optimizer.

Counterpart of paddle_tpu/jit/api.py::TrainStep for training on one
device, in fp32 or in bf16 AMP. The JAX step is one compiled program over
donated copies of the parameters; PyTorch runs eagerly, so here the step
works on the model's own parameters in place and `sync()` has nothing to
write back.

    step = TrainStep(model, llama_loss_fn, AdamW(parameters=...))
    loss = step(input_ids, labels)      # a 0-d tensor on the device

Each call runs, in order: the forward (under `amp.auto_cast(amp_level,
amp_dtype)` when an AMP level is given), `loss_fn(outputs, *labels)`
outside it, the backward, the optimizer's grad_clip and update
(`optimizer.step()`), and `zero_grad(set_to_none=True)`. Nothing in it
waits for the host. The loss has the dtype the loss function gives it on
the model's outputs, as in the JAX step: under O1 a Llama loss is bf16
(its logits come out of a bf16 linear), an ERNIE loss fp32 (the MLM
scores add an fp32 bias).

AMP: amp_level "O1" (white-listed ops in bf16, fp32 parameters) or "O2"
(after `amp.decorate(level="O2")`: bf16 parameters with fp32 master
copies in Adam / AdamW) with amp_dtype "bfloat16". fp16 has no flash
kernel instantiation yet and raises.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch import amp

FP16_ITEM = ("ROADMAP.md 'Still to port' item 21 (the fp16 instantiation "
             "of the flash kernels)")
AMP_LEVELS = ("O1", "O2")


class TrainStep:
    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 n_inputs: int = 1, amp_level: Optional[str] = None,
                 amp_dtype: str = "bfloat16", in_shardings=None, mesh=None):
        if amp_level is not None:
            if amp_level not in AMP_LEVELS:
                raise ValueError(f"amp_level={amp_level!r}: expected one of "
                                 f"{AMP_LEVELS} or None")
            dtype = amp.to_torch_dtype(amp_dtype)
            if dtype == torch.float16:
                raise NotImplementedError(
                    f"amp_dtype={amp_dtype!r}: bf16 AMP is ported, fp16 "
                    f"waits for {FP16_ITEM}")
            if dtype != torch.bfloat16:
                raise ValueError(f"amp_dtype={amp_dtype!r}: AMP trains in "
                                 "bfloat16")
        if mesh is not None or in_shardings is not None:
            raise NotImplementedError(
                "mesh / in_shardings: sharded training is not ported yet: "
                "ROADMAP.md 'Still to port' item 13 (distributed training)")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.n_inputs = n_inputs
        self.amp_level = amp_level
        self.amp_dtype = amp_dtype
        self.device = next(model.parameters()).device
        optimizer.adopt_names(model)

    def _as_tensor(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def _autocast(self):
        if self.amp_level is None:
            return contextlib.nullcontext()
        return amp.auto_cast(level=self.amp_level, dtype=self.amp_dtype)

    def __call__(self, *batch):
        batch = [self._as_tensor(b) for b in batch]
        inputs, labels = batch[:self.n_inputs], batch[self.n_inputs:]
        with self._autocast():
            outputs = self.model(*inputs)
        loss = self.loss_fn(outputs, *labels)
        loss.backward()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    def sync(self) -> torch.nn.Module:
        """The model, whose parameters are the trained ones."""
        return self.model
