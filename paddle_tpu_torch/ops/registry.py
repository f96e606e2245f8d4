"""Op registry and the eager dispatcher.

Counterpart of paddle_tpu/ops/registry.py: one table of ops (`ops.yaml`,
the JAX table's copy, read by `parse_table`: no PyYAML), one generic
dispatcher and the `_C_ops` namespace (`C_OPS`) over it. `dispatch` does,
in order, what the JAX one does for an eager op:

  1. runs TRACE_HOOK and STATS_HOOK on (name, args, kwargs);
  2. for an `rng` op, injects the generator state as the second
     positional argument: a torch.Generator on the device of the op's
     tensors (the expected place's when it has none), seeded from the
     default Generator's next key (`core/random.py`);
  3. takes each Tensor's torch value (detached where the Tensor's
     stop_gradient is set) and casts its fp16 / fp32 / fp64 values to
     the AMP dtype of the op (`amp.state.current_cast_dtype`, as JAX's
     dispatch casts; numpy arrays become tensors, lists tuples);
  4. calls the impl on the values under torch's grad mode: on when the op
     is differentiable, grad is enabled and an input Tensor needs grad,
     off otherwise (so a non-differentiable op's outputs never carry
     grad, and torch.autograd records the graph: there is no tape);
  5. canonicalises the outputs' dtypes (x64 off: int64 -> int32, ...);
  6. raises FloatingPointError on a NaN or inf output under
     FLAGS_check_nan_inf, then runs CHECK_HOOK on (name, outputs);
  7. wraps the outputs as Tensors; a floating output of an op that
     recorded grad has stop_gradient False, every other output True.

The per-op jit cache, static-graph recording and tape segments of the JAX
dispatcher have no counterpart: the port runs eager torch ops, and static
graphs are ROADMAP.md 'Still to port' item 12 part (d).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from paddle_tpu_torch.amp.state import _CAST_FROM, current_cast_dtype
from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.ops import impl as impl_mod
from paddle_tpu_torch.utils import flags


class OpDef:
    __slots__ = ("name", "impl", "diff", "dynamic", "rng", "method",
                 "inplace")

    def __init__(self, name, impl, diff=True, dynamic=False, rng=False,
                 method=True, inplace=None):
        self.name = name
        self.impl = impl
        self.diff = diff
        self.dynamic = dynamic
        self.rng = rng
        self.method = method
        self.inplace = inplace


OPS: Dict[str, OpDef] = {}

# api_tracer hook: hook(name, args, kwargs) before every dispatch
TRACE_HOOK = [None]
# operator-stats hook: hook(name, args, kwargs), separate from TRACE_HOOK
STATS_HOOK = [None]
# post-execution hook: hook(name, outs) with every op's torch outputs
CHECK_HOOK = [None]


def host_only_impl(name: str, api_hint: str):
    """Registry impl for host-side ops whose outputs are data-dependent-
    shaped and computed by a python API: generic dispatch must never pass
    inputs through, so the impl raises, pointing at the entry point."""
    def impl(*args, **kwargs):
        raise NotImplementedError(
            f"op '{name}' executes host-side with data-dependent output "
            f"shapes; call the python API ({api_hint}) directly — it is "
            "not replayable through generic op dispatch")
    return impl


def _scalar(text: str):
    return {"true": True, "false": False}.get(text, text)


def parse_table(text: str) -> list:
    """The `ops:` list of an ops.yaml: one `- {key: value, ...}` flow
    mapping per line, plain scalars; comments and blank lines skipped;
    the list ends at the next top-level key."""
    entries, in_ops = [], False
    for line in text.splitlines():
        body = line.split("#", 1)[0].rstrip()
        if not body.strip():
            continue
        if not line[:1].isspace() and not body.startswith("-"):
            in_ops = body == "ops:"
            continue
        if not in_ops:
            continue
        body = body.strip()
        if not (body.startswith("- {") and body.endswith("}")):
            raise ValueError(f"ops.yaml: not a one-line entry: {line!r}")
        entry = {}
        for part in body[3:-1].split(","):
            key, sep, value = part.partition(":")
            if not sep:
                raise ValueError(f"ops.yaml: bad field {part!r} in {line!r}")
            entry[key.strip()] = _scalar(value.strip())
        entries.append(entry)
    return entries


def _load_table() -> None:
    path = os.path.join(os.path.dirname(__file__), "ops.yaml")
    with open(path) as f:
        table = parse_table(f.read())
    for entry in table:
        name = entry["name"]
        OPS[name] = OpDef(
            name, getattr(impl_mod, name),
            diff=entry.get("diff", True),
            dynamic=entry.get("dynamic", False),
            rng=entry.get("rng", False),
            method=entry.get("method", True),
            inplace=entry.get("inplace"))


def _tensors_of(obj, out):
    from paddle_tpu_torch.core.tensor import Tensor

    if isinstance(obj, Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for e in obj:
            _tensors_of(e, out)
    return out


class _Unwrap:
    """Tensor -> its torch value for the impl (dispatch step 3)."""

    def __init__(self, cast, need_grad, device):
        self.cast = cast
        self.need_grad = need_grad
        self.device = device

    def __call__(self, obj):
        from paddle_tpu_torch.core.tensor import Tensor

        if isinstance(obj, Tensor):
            v = obj._value
            if obj.stop_gradient and v.requires_grad and self.need_grad:
                v = v.detach()
            if self.cast is not None and v.dtype in _CAST_FROM:
                v = v.to(self.cast)
            return v
        if isinstance(obj, (list, tuple)):
            return tuple(self(e) for e in obj)
        if isinstance(obj, np.ndarray):
            from paddle_tpu_torch.core.place import expected_device

            v = torch.as_tensor(obj)
            return v.to(device=self.device or expected_device(),
                        dtype=dtype_mod.canonical(v.dtype))
        return obj


def _is_float(v: torch.Tensor) -> bool:
    return v.is_floating_point() or v.is_complex()


def _generator(tensors):
    from paddle_tpu_torch.core.place import expected_device
    from paddle_tpu_torch.core.random import (default_generator,
                                              torch_generator)

    device = tensors[0]._value.device if tensors else expected_device()
    return torch_generator(default_generator.next_key(), device)


def _check_nan_inf(name, outs):
    for o in outs:
        if _is_float(o) and not bool(torch.isfinite(o).all()):
            raise FloatingPointError(f"op {name} produced NaN/Inf output")


def dispatch(name: str, args, kwargs, _op=None):
    """The generic eager op (see the module docstring). `_op`: an
    unregistered OpDef dispatched directly."""
    from paddle_tpu_torch.core.tensor import Tensor

    if TRACE_HOOK[0] is not None:
        TRACE_HOOK[0](name, args, kwargs)
    if STATS_HOOK[0] is not None:
        STATS_HOOK[0](name, args, kwargs)
    op = _op if _op is not None else OPS[name]
    tensors = _tensors_of(tuple(kwargs.values()), _tensors_of(args, []))
    if op.rng:
        args = (args[0], _generator(tensors)) + tuple(args[1:])
    need_grad = (op.diff and torch.is_grad_enabled()
                 and any(not t.stop_gradient for t in tensors))
    unwrap = _Unwrap(current_cast_dtype(name), need_grad,
                     tensors[0]._value.device if tensors else None)
    vals = tuple(unwrap(a) for a in args)
    kw = {k: unwrap(v) for k, v in kwargs.items()}
    with torch.set_grad_enabled(need_grad):
        out = op.impl(*vals, **kw)
        multi = isinstance(out, (tuple, list))
        outs = list(out) if multi else [out]
        inputs = {id(t._value) for t in tensors}
        for i, o in enumerate(outs):
            if not isinstance(o, torch.Tensor):
                o = torch.as_tensor(o, device=unwrap.device)
            elif id(o) in inputs:
                o = o.view_as(o)    # an output is never an input's object
            outs[i] = o.to(dtype_mod.canonical(o.dtype))

    if flags.flag("FLAGS_check_nan_inf"):
        _check_nan_inf(name, outs)
    if CHECK_HOOK[0] is not None:
        CHECK_HOOK[0](name, outs)
    wrapped = [Tensor(o, stop_gradient=not (need_grad and _is_float(o)))
               for o in outs]
    return tuple(wrapped) if multi else wrapped[0]


def make_op_function(name: str):
    def op_fn(*args, **kwargs):
        return dispatch(name, args, kwargs)

    op_fn.__name__ = name
    op_fn.__qualname__ = name
    op_fn.__doc__ = ((OPS[name].impl.__doc__ or "")
                     + "\n(Dispatched op; see ops.yaml)")
    return op_fn


_load_table()


# ------------------------------------------------------------ indexing

def _long(i):
    if isinstance(i, torch.Tensor) and not i.is_floating_point() \
            and i.dtype not in (torch.bool, torch.uint8, torch.int64):
        return i.long()
    return i


def _flip_negative_steps(x, idx):
    """Torch slices take no negative step: each such slice of ``idx`` is
    applied to ``x`` first as an index_select along its dim and replaced
    by ':'. Only ints, slices, None and one Ellipsis may sit beside one."""
    idx = list(idx)
    if any(isinstance(e, torch.Tensor) for e in idx):
        raise NotImplementedError(
            "indexing with a negative step beside a tensor index")
    consumed = sum(1 for e in idx if e is not None and e is not Ellipsis)
    dim = 0
    for pos, e in enumerate(idx):
        if e is Ellipsis:
            dim += x.dim() - consumed
            continue
        if e is None:
            continue
        if isinstance(e, slice) and e.step is not None and e.step < 0:
            picks = list(range(*e.indices(x.shape[dim])))
            x = x.index_select(dim, torch.tensor(picks, dtype=torch.long,
                                                 device=x.device))
            idx[pos] = slice(None)
        dim += 1
    return x, tuple(idx)


def _normal(x, idx):
    idx = tuple(_long(i) for i in idx) if isinstance(idx, tuple) \
        else (_long(idx),)
    if any(isinstance(e, slice) and e.step is not None and e.step < 0
           for e in idx):
        x, idx = _flip_negative_steps(x, idx)
    return x, idx


def _getitem_impl(x, idx):
    x, idx = _normal(x, idx)
    return x[idx]


def set_index(base, idx, value):
    """base[idx] = value in place (the value cast to base's dtype), the
    write of JAX's `.at[idx].set`."""
    idx = tuple(_long(i) for i in idx) if isinstance(idx, tuple) \
        else _long(idx)
    if isinstance(value, torch.Tensor):
        value = value.to(device=base.device, dtype=base.dtype)
    base[idx] = value
    return base


# basic-indexing view op (the JAX registry's "_getitem")
OPS["_getitem"] = OpDef("_getitem", _getitem_impl, diff=True, method=False)


class _COps:
    """_C_ops-style namespace."""

    def __init__(self):
        for name in OPS:
            setattr(self, name, make_op_function(name))

    def __getattr__(self, name):
        # ops registered after import resolve lazily
        if not name.startswith("_") and name in OPS:
            fn = make_op_function(name)
            setattr(self, name, fn)
            return fn
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute {name!r}")


C_OPS = _COps()
