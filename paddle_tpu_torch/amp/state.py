"""AMP auto-cast state and the per-op lists.

Counterpart of paddle_tpu/amp/state.py (a copy of its lists, not an
import: the port never imports the JAX package). An op whose name is on
BLACK_LIST computes in fp32; under O2 every other op computes in the AMP
dtype; under O1 only the ops on WHITE_LIST do, and the rest are left
alone (PyTorch's type promotion, which matches jnp's for the tensors the
models mix: an fp32 residual plus a bf16 branch is fp32).

`cast_inputs` is the cast of paddle_tpu/ops/registry.py's dispatch: each
floating tensor an op is given is cast to `current_cast_dtype(op)`. As
there, "floating" is numpy's notion: fp16, fp32 and fp64. bfloat16 is not
a numpy floating type, so a bf16 input is never cast, not even to fp32
for a black-listed op (under O2 a bf16 rms_norm input stays bf16).
"""

from __future__ import annotations

from typing import Optional

import torch

# Ops that are numerically safe and profitable in low precision.
WHITE_LIST = {
    "matmul", "bmm", "mv", "addmm", "linear", "conv2d", "conv1d",
    "conv2d_transpose", "einsum", "scaled_dot_product_attention",
    "flash_attn_unpadded", "flashmask_attention",
}

# Ops that must run in fp32 (reductions, the exp family, losses, norms).
BLACK_LIST = {
    "exp", "expm1", "log", "log2", "log10", "log1p", "pow", "square",
    "softmax", "log_softmax", "softmax_with_cross_entropy", "cross_entropy",
    "nll_loss", "mse_loss", "l1_loss", "smooth_l1_loss", "kl_div",
    "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "mean", "sum", "norm", "logsumexp", "cumsum", "cumprod", "std", "var",
    "layer_norm", "batch_norm", "group_norm", "instance_norm", "rms_norm",
}

# the dtypes the registry's cast touches (numpy's floating kinds)
_CAST_FROM = (torch.float16, torch.float32, torch.float64)


class _AmpState:
    enabled: bool = False
    dtype: Optional[torch.dtype] = None   # the low-precision dtype
    level: str = "O1"
    custom_white = frozenset()
    custom_black = frozenset()


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


def current_cast_dtype(op_name: str) -> Optional[torch.dtype]:
    """The dtype this op's floating inputs are cast to, or None (no
    cast)."""
    if not _state.enabled:
        return None
    if op_name in _state.custom_black or op_name in BLACK_LIST:
        return torch.float32
    if _state.level == "O2":
        return _state.dtype
    if op_name in _state.custom_white or op_name in WHITE_LIST:
        return _state.dtype
    return None


def cast_inputs(op_name: str, *tensors):
    """``tensors`` as op ``op_name`` receives them under the current AMP
    state: each fp16 / fp32 / fp64 tensor cast to its
    `current_cast_dtype`, everything else (bf16, integer tensors, None)
    as it is. Returns a tuple, one entry per argument."""
    dt = current_cast_dtype(op_name)
    if dt is None:
        return tensors
    return tuple(t.to(dt) if isinstance(t, torch.Tensor)
                 and t.dtype in _CAST_FROM else t for t in tensors)
