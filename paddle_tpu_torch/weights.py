"""The state bridge: flat numpy parameter and optimizer-state dicts into
the port, and back.

The JAX runners take ``jit.functionalize(model).param_values()``, a flat
``{name: array}`` dict in the JAX package's names and ``[in, out]``
layout. The port takes the same dict as numpy arrays, so it never sees a
jax type: a caller (or a test) converts with ``np.asarray`` on the JAX
side and hands the arrays over. A JAX training run moves across the same
way: its TrainStep's ``params`` through `load_params`, its AdamW moments
(``opt_state``) and step count through `optimizer_state_from_numpy`;
`params_to_numpy` and `optimizer_state_to_numpy` go the other way.
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


def params_to_numpy(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters as a flat ``{name: np.ndarray}`` dict, the
    JAX package's names and layout (host copies)."""
    return {name: p.detach().cpu().numpy()
            for name, p in model.named_parameters()}


def optimizer_state_from_numpy(optimizer, model: nn.Module,
                               opt_state: Mapping[str, Mapping[str,
                                                               np.ndarray]],
                               step: int) -> None:
    """Adopt an Adam/AdamW state exported from the JAX package:
    ``{name: {"moment1", "moment2"}}`` per parameter of ``model`` and the
    number of steps taken (the JAX TrainStep's ``opt_state`` and
    ``_step_i``). The next ``optimizer.step()`` is step ``step + 1``."""
    own = dict(model.named_parameters())
    missing, extra = sorted(set(own) - set(opt_state)), \
        sorted(set(opt_state) - set(own))
    if missing or extra:
        raise KeyError(f"optimizer state names differ: missing="
                       f"{missing[:8]} unexpected={extra[:8]}")
    for name, st in opt_state.items():
        if set(st) != {"moment1", "moment2"}:
            raise ValueError(f"{name}: expected moment1 and moment2, got "
                             f"{sorted(st)} (master weights are not "
                             "carried: only fp32 parameters train)")
        p = own[name]
        moments = {}
        for key in ("moment1", "moment2"):
            t = torch.from_numpy(_writable(st[key]))
            if tuple(t.shape) != tuple(p.shape) or t.dtype != torch.float32:
                raise ValueError(f"{name}.{key}: got {tuple(t.shape)} "
                                 f"{t.dtype}, the parameter is "
                                 f"{tuple(p.shape)} (fp32 moments)")
            moments[key] = t.to(p.device)
        optimizer.state[p] = moments
    optimizer._step_i = int(step)


def optimizer_state_to_numpy(optimizer, model: nn.Module):
    """``({name: {"moment1", "moment2"}}, step)`` of the optimizer, the
    inverse of `optimizer_state_from_numpy` (parameters not stepped yet
    are left out)."""
    state = {name: {k: t.detach().cpu().numpy()
                    for k, t in optimizer.state[p].items()}
             for name, p in model.named_parameters() if optimizer.state[p]}
    return state, optimizer._step_i
