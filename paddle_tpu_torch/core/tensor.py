"""The eager Tensor.

Counterpart of paddle_tpu/core/tensor.py. `_value` is a torch.Tensor and
gradients are torch's autograd: no tape of the port's own. What the JAX
Tensor keeps beside its value maps onto torch so:

  * `stop_gradient` is a flag of the Tensor, as in JAX. False on a
    floating leaf sets requires_grad on its value, True clears it. On an
    op output True cuts the output off the graph for every later op (the
    dispatcher detaches an input whose flag is set, as the JAX walk skips
    it) and False joins it again; the value keeps its history, so a
    backward from the output itself still runs, as in JAX. False on an
    integer tensor is allowed, as in JAX, and no gradient flows.
  * `.grad` is a Tensor over the leaf's torch grad (None on a non-leaf);
    backward calls accumulate into it; `clear_grad` / `clear_gradient`
    (set_to_zero) act on it.
  * `register_hook` wraps a torch tensor hook: the hook sees and returns
    Tensors.
  * `_inplace_update` replaces the value (as JAX's functional update
    does: a tensor saved for a backward keeps its old value) and raises
    the JAX RuntimeError on a non-leaf that needs grad; a leaf keeps its
    requires_grad and its `.grad`.
  * `__setitem__` writes into a copy of the value under torch.no_grad()
    (JAX's `.at[idx].set`), so it works on a leaf that needs grad, where
    torch refuses an in-place write.
  * the operators dispatch as registry ops (`C_OPS.add`, ...), so AMP
    casts them as in JAX; a python scalar operand becomes a 0-d tensor of
    the other operand's dtype where both are floating (fp16 / fp32 /
    fp64, numpy's floating kinds) or both integer, as JAX's
    `_as_tensor_like` does.

`numpy()` of a bf16 tensor is fp32 (an exact widening: the card's
machine has no numpy bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.autograd import engine
from paddle_tpu_torch.core import dtype as dtype_mod

# numpy's floating kinds: the AMP cast and the scalar rule touch these only
_NP_FLOATING = (torch.float16, torch.float32, torch.float64)


def _differentiable(v: torch.Tensor) -> bool:
    return v.is_floating_point() or v.is_complex()


class Tensor:
    __slots__ = ("_value", "_stop_gradient", "name", "persistable",
                 "trainable", "__weakref__")

    def __init__(self, value, stop_gradient: bool = True, name: str = ""):
        if isinstance(value, Tensor):
            value = value._value
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
            value = value.to(dtype_mod.canonical(value.dtype))
        self._value = value
        self._stop_gradient = bool(stop_gradient)
        if not stop_gradient and value.grad_fn is None \
                and _differentiable(value) and not value.requires_grad:
            value.requires_grad_(True)
        self.name = name
        self.persistable = False
        self.trainable = not stop_gradient

    # ------------------------------------------------------------- basics

    @staticmethod
    def _wrap(value) -> "Tensor":
        return Tensor(value, stop_gradient=True)

    @property
    def stop_gradient(self) -> bool:
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, flag):
        flag = bool(flag)
        self._stop_gradient = flag
        v = self._value
        if v.grad_fn is None and _differentiable(v) \
                and v.requires_grad == flag:
            v.requires_grad_(not flag)

    @property
    def grad(self):
        v = self._value
        if v.grad_fn is not None or v.grad is None:
            return None
        return Tensor(v.grad)

    @grad.setter
    def grad(self, g):
        self._value.grad = None if g is None else (
            g._value if isinstance(g, Tensor) else g)

    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def ndim(self):
        return self._value.dim()

    @property
    def size(self):
        return self._value.numel()

    @property
    def T(self):
        from paddle_tpu_torch.ops.registry import C_OPS

        return C_OPS.t(self)

    @property
    def place(self):
        from paddle_tpu_torch.core.place import place_of

        return place_of(self._value.device)

    @property
    def is_leaf(self):
        return self._value.grad_fn is None

    def numel(self):
        return self.size

    def numpy(self):
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()

    def item(self):
        return self._value.item()

    def tolist(self):
        return self._value.tolist()

    def astype(self, dtype):
        from paddle_tpu_torch.ops.registry import C_OPS

        return C_OPS.cast(self, dtype_mod.to_torch_dtype(dtype))

    cast = astype

    def detach(self) -> "Tensor":
        return Tensor(self._value.detach(), stop_gradient=True,
                      name=self.name)

    def clone(self) -> "Tensor":
        from paddle_tpu_torch.ops.registry import C_OPS

        return C_OPS.scale(self, 1.0)

    def to(self, *args, device=None, dtype=None, blocking=None):
        out = self
        for a in args:
            if isinstance(a, str) and a.split(":")[0] in ("cpu", "gpu",
                                                          "cuda"):
                device = a
            elif isinstance(a, torch.device):
                device = a
            else:
                dtype = a
        if device is not None:
            from paddle_tpu_torch.core.place import CUDAPlace, Place

            if isinstance(device, Place):
                dev = device.torch_device()
            elif isinstance(device, torch.device):
                dev = device
            else:
                name, _, idx = str(device).partition(":")
                dev = torch.device("cpu") if name == "cpu" else CUDAPlace(
                    int(idx) if idx else 0).torch_device()
            out = Tensor(out._value.detach().to(dev),
                         stop_gradient=out.stop_gradient)
        if dtype is not None:
            out = out.astype(dtype)
        return out

    def cpu(self):
        return self.to("cpu")

    def pin_memory(self):
        return self

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True

    # ------------------------------------------------------------ autograd

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        engine.backward(self, grad_tensor, retain_graph=retain_graph)

    def gradient(self):
        g = self.grad
        return None if g is None else g.numpy()

    def clear_grad(self):
        self._value.grad = None

    def clear_gradient(self, set_to_zero: bool = False):
        g = self._value.grad
        self._value.grad = (torch.zeros_like(g)
                            if set_to_zero and g is not None else None)

    def register_hook(self, hook):
        def _hook(g):
            out = hook(Tensor(g))
            return out._value if isinstance(out, Tensor) else out

        if self._value.requires_grad:
            return self._value.register_hook(_hook)

        class _Handle:     # no gradient reaches this tensor: nothing to hook
            def remove(inner):
                pass

        return _Handle()

    def zero_(self):
        self._inplace_update(torch.zeros_like(self._value))
        return self

    def fill_(self, value):
        self._inplace_update(torch.full_like(self._value, value))
        return self

    def copy_(self, other, blocking=True):
        v = other._value if isinstance(other, Tensor) else torch.as_tensor(
            np.asarray(other))
        self._inplace_update(v.to(device=self._value.device,
                                  dtype=self._value.dtype))
        return self

    def set_value(self, value):
        self.copy_(value)

    def _inplace_update(self, new_value):
        old = self._value
        if not self.stop_gradient and engine.is_grad_enabled() \
                and old.grad_fn is not None:
            raise RuntimeError(
                "in-place update on a non-leaf tensor that requires grad is "
                "not supported; wrap in paddle_tpu.no_grad() or use detach()")
        new = new_value.detach()
        if old.grad_fn is None and old.requires_grad and _differentiable(new):
            new.requires_grad_(True)
            if old.grad is not None and old.grad.shape == new.shape \
                    and old.grad.dtype == new.dtype:
                new.grad = old.grad
        self._value = new

    # ------------------------------------------------------------ indexing

    def __getitem__(self, idx):
        from paddle_tpu_torch.ops.registry import dispatch

        return dispatch("_getitem", (self,),
                        {"idx": _normalize_index(idx, self._value.device)})

    def __setitem__(self, idx, value):
        from paddle_tpu_torch.ops.registry import set_index

        idx = _normalize_index(idx, self._value.device)
        v = value._value if isinstance(value, Tensor) else value
        with torch.no_grad():
            new = set_index(self._value.detach().clone(), idx, v)
        self._inplace_update(new)

    # ---------------------------------------------------------- operators

    def _binop(self, name, other, reverse=False):
        from paddle_tpu_torch.ops.registry import C_OPS

        fn = getattr(C_OPS, name)
        if reverse:
            return fn(_as_tensor_like(other, self), self)
        return fn(self, _as_tensor_like(other, self))

    def __add__(self, o):
        return self._binop("add", o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop("subtract", o)

    def __rsub__(self, o):
        return self._binop("subtract", o, reverse=True)

    def __mul__(self, o):
        return self._binop("multiply", o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop("divide", o)

    def __rtruediv__(self, o):
        return self._binop("divide", o, reverse=True)

    def __floordiv__(self, o):
        return self._binop("floor_divide", o)

    def __mod__(self, o):
        return self._binop("remainder", o)

    def __pow__(self, o):
        return self._binop("pow", o)

    def __rpow__(self, o):
        return self._binop("pow", o, reverse=True)

    def __matmul__(self, o):
        return self._binop("matmul", o)

    def __neg__(self):
        from paddle_tpu_torch.ops.registry import C_OPS

        return C_OPS.neg(self)

    def __abs__(self):
        from paddle_tpu_torch.ops.registry import C_OPS

        return C_OPS.abs(self)

    def __eq__(self, o):
        return self._binop("equal", o)

    def __ne__(self, o):
        return self._binop("not_equal", o)

    def __lt__(self, o):
        return self._binop("less_than", o)

    def __le__(self, o):
        return self._binop("less_equal", o)

    def __gt__(self, o):
        return self._binop("greater_than", o)

    def __ge__(self, o):
        return self._binop("greater_equal", o)

    def __invert__(self):
        from paddle_tpu_torch.ops.registry import C_OPS

        return C_OPS.logical_not(self)

    def __hash__(self):
        return id(self)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __bool__(self):
        return bool(self._value)

    def __float__(self):
        return float(self._value)

    def __int__(self):
        return int(self._value)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        grad_s = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, "
                f"dtype={dtype_mod.dtype_name(self.dtype)}{grad_s},\n"
                f"       {self.numpy()!r})")


class Parameter(Tensor):
    """Trainable parameter (the JAX Parameter's attributes)."""

    __slots__ = ("optimize_attr", "regularizer", "is_distributed",
                 "sparse_grad")

    def __init__(self, value, trainable: bool = True, name: str = ""):
        super().__init__(value, stop_gradient=not trainable, name=name)
        self.trainable = trainable
        self.persistable = True
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.is_distributed = False
        self.sparse_grad = None


def _as_tensor_like(other, ref: Tensor) -> Tensor:
    """A non-Tensor operand as a Tensor beside ``ref`` (JAX's rule: python
    scalars are 32-bit, then take ref's dtype where both are numpy-floating
    or both integer)."""
    if isinstance(other, Tensor):
        return other
    dev = ref._value.device
    if isinstance(other, torch.Tensor):
        v = other.to(device=dev)
    else:
        arr = np.asarray(other)
        dt = dtype_mod.to_torch_dtype(arr.dtype)
        # a 0-d operand is a fill on the device: no host copy
        v = (torch.full((), arr.item(), dtype=dt, device=dev)
             if arr.ndim == 0
             else torch.as_tensor(arr).to(device=dev, dtype=dt))
    v = v.to(dtype_mod.canonical(v.dtype))
    rd = ref._value.dtype
    if v.dtype in _NP_FLOATING and rd in _NP_FLOATING:
        v = v.to(rd)
    if dtype_mod.is_integer(v.dtype) and dtype_mod.is_integer(rd):
        v = v.to(rd)
    return Tensor._wrap(v)


def _normalize_index(idx, device):
    """Tensors in an index become their values, lists index tensors (as
    JAX's jnp.asarray of a list)."""
    if isinstance(idx, Tensor):
        return idx._value
    if isinstance(idx, tuple):
        return tuple(i._value if isinstance(i, Tensor) else i for i in idx)
    if isinstance(idx, list):
        return torch.as_tensor(idx, device=device)
    return idx
