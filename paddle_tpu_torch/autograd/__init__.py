"""paddle_tpu_torch.autograd: the grad-mode names, `backward` and `grad`
over torch.autograd (counterpart of paddle_tpu/autograd/). `PyLayer`,
`jacobian` and `hessian` are ROADMAP.md 'Still to port' item 12 part
(b)."""

from paddle_tpu_torch.autograd.engine import (
    backward, enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled,
)

__all__ = ["backward", "enable_grad", "grad", "is_grad_enabled", "no_grad",
           "set_grad_enabled"]
