"""The weight bridge: flat numpy parameter dicts into the port.

The JAX runners take ``jit.functionalize(model).param_values()``, a flat
``{name: array}`` dict in the JAX package's names and ``[in, out]``
layout. The port takes the same dict as numpy arrays, so it never sees a
jax type: a caller (or a test) converts with ``np.asarray`` on the JAX
side and hands the arrays over.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.device import resolve_device


def _writable(a) -> np.ndarray:
    """A C-contiguous, writable array of ``a`` (a copy only when needed:
    arrays exported from JAX are read-only, and torch refuses to wrap
    those without a warning)."""
    return np.require(a, requirements=["C", "W"])


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      device="cuda") -> Dict[str, torch.Tensor]:
    """``{name: np.ndarray}`` -> ``{name: Tensor}`` on ``device``,
    keeping each array's dtype and shape."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(_writable(a)).to(dev)
            for name, a in arrays.items()}


def load_params(model: nn.Module, arrays: Mapping[str, np.ndarray]) -> None:
    """Copy a flat numpy parameter dict into ``model`` in place. The
    names must match the model's parameters exactly, and every shape and
    dtype must agree: a dict from another configuration raises."""
    own = dict(model.named_parameters())
    missing, extra = sorted(set(own) - set(arrays)), \
        sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing={missing[:8]} "
                       f"unexpected={extra[:8]}")
    for name, a in arrays.items():
        p = own[name]
        t = torch.from_numpy(_writable(a))
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, the "
                             f"model holds {tuple(p.shape)} {p.dtype}")
        with torch.no_grad():
            p.copy_(t)
