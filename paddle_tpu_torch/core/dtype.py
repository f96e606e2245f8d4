"""Dtypes: the paddle names and aliases over torch dtypes.

Counterpart of paddle_tpu/core/dtype.py. The JAX package runs with
``jax_enable_x64`` off, so every 64-bit type it is handed becomes its
32-bit twin (int64 -> int32, uint64 -> uint32, float64 -> float32,
complex128 -> complex64): `to_tensor` of an int64 array is int32,
`arange(5)` and `argmax` are int32. The port canonicalises the same way,
in one place: `canonical` here, applied by `to_tensor` and the creation
functions and by the dispatcher to every op output (torch's own int64
results, such as argmax's or an integer sum's, are cast back to int32).

`Tensor.dtype` is a torch.dtype; `dtype_name` gives the paddle name
("float32", "int32", "bool", ...), which is what compares across the two
packages.
"""

from __future__ import annotations

import numpy as np
import torch

# canonical name -> torch dtype
_NAME_TO_DTYPE = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "int": "int32",
    "long": "int64",
    "bf16": "bfloat16",
    "fp16": "float16",
    "fp32": "float32",
    "fp64": "float64",
}

# x64 off: the 64-bit types and the 32-bit ones they become
_CANONICAL = {
    torch.int64: torch.int32,
    torch.float64: torch.float32,
    torch.complex128: torch.complex64,
}
if hasattr(torch, "uint64"):
    _CANONICAL[torch.uint64] = torch.uint32

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_TORCH_NAMES = {v: k for k, v in _NAME_TO_DTYPE.items()}
if hasattr(torch, "uint32"):
    _TORCH_NAMES[torch.uint32] = "uint32"
if hasattr(torch, "uint16"):
    _TORCH_NAMES[torch.uint16] = "uint16"


def _raw(dtype) -> torch.dtype:
    """A dtype spec (a name, an alias, a torch dtype, a numpy dtype or
    scalar type, a python type) as a torch dtype, not canonicalised."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
        if name in _NAME_TO_DTYPE:
            return _NAME_TO_DTYPE[name]
        if name.startswith("torch."):
            return getattr(torch, name[len("torch."):])
    if dtype is bool:
        return torch.bool
    if dtype is int:
        return torch.int64
    if dtype is float:
        return torch.float64
    if dtype is complex:
        return torch.complex128
    name = np.dtype(dtype).name
    if name in _NAME_TO_DTYPE:
        return _NAME_TO_DTYPE[name]
    if hasattr(torch, name):
        return getattr(torch, name)
    raise TypeError(f"no torch dtype for {dtype!r}")


def canonical(dtype: torch.dtype) -> torch.dtype:
    """The 32-bit twin of a 64-bit torch dtype (x64 off), else the dtype."""
    return _CANONICAL.get(dtype, dtype)


def to_torch_dtype(dtype):
    """Normalize a paddle-style dtype spec (str / torch / numpy dtype) to a
    torch dtype, canonicalised as the JAX package's x64-off mode does (the
    counterpart of to_jax_dtype). None stays None."""
    if dtype is None:
        return None
    return canonical(_raw(dtype))


def dtype_name(dtype) -> str:
    """Canonical string name for a dtype ("float32", "bool", ...)."""
    if not isinstance(dtype, torch.dtype):
        dtype = _raw(dtype)
    return _TORCH_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def is_floating(dtype) -> bool:
    return _raw(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = _raw(dtype)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def is_complex(dtype) -> bool:
    return _raw(dtype).is_complex


def promote_types(a, b):
    """Binary promotion, canonicalised (jnp's lattice for these types)."""
    return canonical(torch.promote_types(_raw(a), _raw(b)))
