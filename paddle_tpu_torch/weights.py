"""The state bridge: flat numpy parameter and optimizer-state dicts into
the port, and back.

The JAX runners take ``jit.functionalize(model).param_values()``, a flat
``{name: array}`` dict in the JAX package's names and ``[in, out]``
layout. The port takes the same dict as numpy arrays, so it never sees a
jax type: a caller (or a test) converts with ``np.asarray`` on the JAX
side and hands the arrays over. A JAX training run moves across the same
way: its TrainStep's ``params`` through `load_params`, its AdamW moments
(``opt_state``, with the fp32 ``"master"`` copies of a bf16 model) and
step count through `optimizer_state_from_numpy`; `params_to_numpy` and
`optimizer_state_to_numpy` go the other way.

bf16 arrays (a model after `amp.decorate(level="O2")`) cross as numpy
arrays of the ``bfloat16`` dtype that ml_dtypes registers with numpy, as
the JAX side exports them. The port does not import ml_dtypes: it reads
such an array through its 16-bit pattern, and exports bf16 tensors in
that dtype, which numpy knows once the caller has loaded ml_dtypes.
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


def _from_numpy(a) -> torch.Tensor:
    """``a`` as a CPU tensor of its dtype; a bfloat16 array through its
    bit pattern."""
    a = _writable(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bf16 as numpy's bfloat16 (registered by
    ml_dtypes, which the JAX side loads)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      device="cuda") -> Dict[str, torch.Tensor]:
    """``{name: np.ndarray}`` -> ``{name: Tensor}`` on ``device``,
    keeping each array's dtype and shape."""
    dev = resolve_device(device)
    return {name: _from_numpy(a).to(dev) for name, a in arrays.items()}


def load_params(model: nn.Module, arrays: Mapping[str, np.ndarray]) -> None:
    """Copy a flat numpy parameter dict into ``model`` in place. The
    names must match the model's parameters exactly, and every shape and
    dtype must agree: a dict from another configuration raises (a
    decorated model takes bf16 arrays)."""
    own = dict(model.named_parameters())
    missing, extra = sorted(set(own) - set(arrays)), \
        sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing={missing[:8]} "
                       f"unexpected={extra[:8]}")
    for name, a in arrays.items():
        p = own[name]
        t = _from_numpy(a)
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, the "
                             f"model holds {tuple(p.shape)} {p.dtype}")
        with torch.no_grad():
            p.copy_(t)


def params_to_numpy(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters as a flat ``{name: np.ndarray}`` dict, the
    JAX package's names and layout (host copies)."""
    return {name: _to_numpy(p) for name, p in model.named_parameters()}


def optimizer_state_from_numpy(optimizer, model: nn.Module,
                               opt_state: Mapping[str, Mapping[str,
                                                               np.ndarray]],
                               step: int) -> None:
    """Adopt an Adam/AdamW state exported from the JAX package:
    ``{name: {"moment1", "moment2"[, "master"]}}`` per parameter of
    ``model`` (fp32 each; the master copy of a parameter that is not fp32)
    and the number of steps taken (the JAX TrainStep's ``opt_state`` and
    ``_step_i``). The next ``optimizer.step()`` is step ``step + 1``."""
    own = dict(model.named_parameters())
    missing, extra = sorted(set(own) - set(opt_state)), \
        sorted(set(opt_state) - set(own))
    if missing or extra:
        raise KeyError(f"optimizer state names differ: missing="
                       f"{missing[:8]} unexpected={extra[:8]}")
    for name, st in opt_state.items():
        p = own[name]
        keys = {"moment1", "moment2"}
        if p.dtype != torch.float32 and "master" in st:
            keys.add("master")
        if set(st) != keys:
            raise ValueError(f"{name}: expected {sorted(keys)}, got "
                             f"{sorted(st)} (a master copy belongs to a "
                             "parameter that is not fp32)")
        moments = {}
        for key in sorted(keys):
            t = _from_numpy(st[key])
            if tuple(t.shape) != tuple(p.shape) or t.dtype != torch.float32:
                raise ValueError(f"{name}.{key}: got {tuple(t.shape)} "
                                 f"{t.dtype}, the parameter is "
                                 f"{tuple(p.shape)} (fp32 state)")
            moments[key] = t.to(p.device)
        optimizer.state[p] = moments
    optimizer._step_i = int(step)


def optimizer_state_to_numpy(optimizer, model: nn.Module):
    """``({name: {"moment1", "moment2"[, "master"]}}, step)`` of the
    optimizer, the inverse of `optimizer_state_from_numpy` (parameters
    not stepped yet are left out)."""
    state = {name: {k: _to_numpy(t)
                    for k, t in optimizer.state[p].items()}
             for name, p in model.named_parameters() if optimizer.state[p]}
    return state, optimizer._step_i
