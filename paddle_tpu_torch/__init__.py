"""PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package serves and
trains the same models with PyTorch on an NVIDIA H100, through
hand-written CUDA kernels: the two paged-attention kernels of the serving
path (``ops.ragged_paged_attention``, ``ops.paged_attention``) and the
flash-attention forward and backward kernels of the training path
(``ops.flash_attention``, under ``models.Llama.forward``,
``jit.TrainStep`` and the attention ops of ``_C_ops``). It imports torch
and numpy only, never jax and never ``paddle_tpu``.

The Paddle-style eager surface sits here as in the JAX package: the
Tensor (``core/``), ``to_tensor`` and the creation functions, every op of
``ops/ops.yaml`` as a module function, a Tensor method and a ``_C_ops``
entry, the grad-mode names over torch.autograd, the dtype names, places,
``seed`` / ``get_rng_state`` / ``set_rng_state`` and the flags. The
default place is the card: ``to_tensor`` and the creation functions raise
on a machine without CUDA unless ``set_device("cpu")`` was called.
Nothing initialises CUDA or builds a kernel at import.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``;
on CPU tensors each kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.autograd.engine import (
    enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled,
)
from paddle_tpu_torch.core import dtype as _dtype_mod
from paddle_tpu_torch.core.dtype import (
    bfloat16, bool_, complex64, complex128, float16, float32, float64,
    int8, int16, int32, int64, uint8,
)
from paddle_tpu_torch.core.place import (
    CPUPlace, CUDAPlace, Place, TPUPlace, device_count, expected_place,
    get_device, set_device,
)
from paddle_tpu_torch.core.random import get_rng_state, seed, set_rng_state
from paddle_tpu_torch.core.tensor import Parameter, Tensor
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.ops.registry import C_OPS as _C_ops
from paddle_tpu_torch.ops.registry import OPS as _OPS
from paddle_tpu_torch.utils.flags import get_flags, set_flags

__version__ = "0.1.0"

# ---------------------------------------------------------------- creation


def _default_float():
    from paddle_tpu_torch.utils.flags import flag

    return _dtype_mod.to_torch_dtype(flag("FLAGS_default_dtype"))


def get_default_dtype():
    return _dtype_mod.dtype_name(_default_float())


def set_default_dtype(d):
    set_flags({"FLAGS_default_dtype": _dtype_mod.dtype_name(
        _dtype_mod.to_torch_dtype(d))})


def _place_device():
    return expected_place().torch_device()


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """paddle.to_tensor: host data (or a Tensor) as a Tensor on ``place``
    (the expected place by default), its dtype canonicalised as the JAX
    package's (float64 -> float32, int64 -> int32)."""
    dev = place.torch_device() if place is not None else _place_device()
    if isinstance(data, Tensor):
        v = data._value.detach()
        if dtype is not None:
            v = v.to(_dtype_mod.to_torch_dtype(dtype))
        return Tensor(v, stop_gradient=stop_gradient)
    if isinstance(data, torch.Tensor):
        v = data.detach()
    else:
        arr = np.asarray(data)
        if arr.dtype == object:
            raise TypeError(f"to_tensor: cannot make a tensor of {data!r}")
        v = torch.as_tensor(arr if arr.flags.writeable else arr.copy())
    dt = _dtype_mod.to_torch_dtype(dtype) if dtype is not None \
        else _dtype_mod.canonical(v.dtype)
    # a copy, as JAX's device_put: the caller's buffer stays its own
    v = v.to(device=dev, dtype=dt, copy=True)
    return Tensor(v, stop_gradient=stop_gradient)


def _creation(fn):
    def wrapper(*args, dtype=None, **kwargs):
        d = _dtype_mod.to_torch_dtype(dtype) if dtype is not None else None
        return Tensor(fn(*args, dtype=d, device=_place_device(), **kwargs))

    wrapper.__name__ = wrapper.__qualname__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def _shape(shape):
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


@_creation
def zeros(shape, dtype=None, device=None):
    return torch.zeros(_shape(shape), dtype=dtype or _default_float(),
                       device=device)


@_creation
def ones(shape, dtype=None, device=None):
    return torch.ones(_shape(shape), dtype=dtype or _default_float(),
                      device=device)


@_creation
def full(shape, fill_value, dtype=None, device=None):
    return torch.full(_shape(shape), fill_value,
                      dtype=dtype or _default_float(), device=device)


@_creation
def empty(shape, dtype=None, device=None):
    return torch.zeros(_shape(shape), dtype=dtype or _default_float(),
                       device=device)


@_creation
def arange(start, end=None, step=1, dtype=None, device=None):
    """jnp.arange's dtypes: int32 for integer bounds, the default float
    for float ones."""
    if end is None:
        start, end = 0, start
    out = torch.arange(start, end, step, device=device)
    return out.to(dtype or _dtype_mod.canonical(out.dtype))


@_creation
def linspace(start, stop, num, dtype=None, device=None):
    from paddle_tpu_torch.ops.impl_extra import _linspace

    return _linspace(start, stop, num, device).to(dtype or _default_float())


@_creation
def eye(num_rows, num_columns=None, dtype=None, device=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=dtype or _default_float(),
                     device=device)


def _like(fn, x, dtype, *args):
    d = _dtype_mod.to_torch_dtype(dtype) if dtype is not None else None
    return Tensor(fn(x._value.detach(), *args, dtype=d))


def zeros_like(x, dtype=None):
    return _like(torch.zeros_like, x, dtype)


def ones_like(x, dtype=None):
    return _like(torch.ones_like, x, dtype)


def full_like(x, fill_value, dtype=None):
    return _like(torch.full_like, x, dtype, fill_value)


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


# ---------------------------------------------------------------- random
#
# Each draws from a torch.Generator seeded from the default Generator's
# next key, on the expected place (core/random.py: the JAX keys, torch's
# draws).


def _gen(device=None):
    from paddle_tpu_torch.core.random import default_generator, \
        torch_generator

    return torch_generator(default_generator.next_key(),
                           device or _place_device())


def _float_or_default(dtype):
    return _dtype_mod.to_torch_dtype(dtype) or _default_float()


def rand(shape, dtype=None):
    g = _gen()
    return Tensor(torch.rand(_shape(shape), generator=g, device=g.device,
                             dtype=_float_or_default(dtype)))


def randn(shape, dtype=None):
    g = _gen()
    return Tensor(torch.randn(_shape(shape), generator=g, device=g.device,
                              dtype=_float_or_default(dtype)))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0):  # noqa: A002
    g = _gen()
    u = torch.rand(_shape(shape), generator=g, device=g.device,
                   dtype=_float_or_default(dtype))
    return Tensor(u * (max - min) + min)


def normal(mean=0.0, std=1.0, shape=None):
    g = _gen()
    out = torch.randn(_shape(shape), generator=g, device=g.device) * std \
        + mean
    return Tensor(out.to(_default_float()))


def randint(low, high=None, shape=(1,), dtype="int64"):
    if high is None:
        low, high = 0, low
    g = _gen()
    return Tensor(torch.randint(low, high, _shape(shape), generator=g,
                                device=g.device).to(
        _dtype_mod.to_torch_dtype(dtype)))


def randperm(n, dtype="int64"):
    g = _gen()
    return Tensor(torch.randperm(n, generator=g, device=g.device).to(
        _dtype_mod.to_torch_dtype(dtype)))


def bernoulli(x):
    g = _gen(x._value.device)
    return Tensor(torch.bernoulli(x._value.detach(), generator=g))


def multinomial(x, num_samples=1, replacement=False):
    """Draws with replacement, as the JAX function does whatever
    ``replacement`` says."""
    g = _gen(x._value.device)
    v = x._value.detach().float()
    flat = v.reshape(-1, v.shape[-1])
    out = torch.multinomial(flat, num_samples, replacement=True, generator=g)
    return Tensor(out.reshape(tuple(v.shape[:-1]) + (num_samples,)).int())


# ------------------------------------------------- top-level op functions

# Every op of the table becomes paddle_tpu_torch.<op>; a name defined
# above (the creation and random functions) keeps its definition, as in
# the JAX package.
_g = globals()
for _name in _OPS:
    if not _name.startswith("_") and _name not in _g:
        _g[_name] = getattr(_C_ops, _name)
del _name

# paddle-style aliases
mm = _g["matmul"]


def numel(x):
    return to_tensor(x.size, dtype="int64", place=x.place)


def shape(x):
    return to_tensor(np.asarray(x.shape, dtype=np.int32), place=x.place)


def is_tensor(x):
    return isinstance(x, Tensor)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return bool(_C_ops.isclose(x, y, rtol=rtol, atol=atol,
                               equal_nan=equal_nan)._value.all())


def equal_all(x, y):
    same = tuple(x.shape) == tuple(y.shape) and bool(
        (x._value == y._value).all())
    return to_tensor(same, place=x.place)


def assign(x, output=None):
    v = x._value if isinstance(x, Tensor) else to_tensor(x)._value
    if output is not None:
        output._inplace_update(v)
        return output
    return Tensor(v.detach())


def clone(x):
    return x.clone()


def increment(x, value=1.0):
    x._inplace_update(x._value + value)
    return x


# ---------------------------------------- Tensor methods from the table

def _install_methods():
    """A method for every op of the table marked `method` (and its in-place
    twin), unless the Tensor already has the name; the deferred ops get
    none."""
    from paddle_tpu_torch.ops.impl_extra import DEFERRED

    for name, opdef in _OPS.items():
        if not opdef.method or name.startswith("_") or name in DEFERRED:
            continue
        if hasattr(Tensor, name):
            continue
        setattr(Tensor, name, _make_method(name))
        if opdef.inplace:
            setattr(Tensor, opdef.inplace, _make_inplace_method(name))


def _make_method(name):
    fn = getattr(_C_ops, name)

    def method(self, *args, **kwargs):
        return fn(self, *args, **kwargs)

    method.__name__ = name
    return method


def _make_inplace_method(name):
    fn = getattr(_C_ops, name)

    def method(self, *args, **kwargs):
        out = fn(self.detach(), *args, **kwargs)
        self._inplace_update(out._value)
        return self

    method.__name__ = name + "_"
    return method


_install_methods()

from paddle_tpu_torch import amp  # noqa: E402,F401
from paddle_tpu_torch import autograd  # noqa: E402,F401
from paddle_tpu_torch.core.selected_rows import (  # noqa: E402,F401
    SelectedRows, get_tensor_from_selected_rows, merge_selected_rows,
)
