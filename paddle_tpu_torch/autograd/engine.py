"""Eager autograd over torch.autograd.

Counterpart of paddle_tpu/autograd/engine.py. The JAX package records a
tape of GradNodes (each op's jax.vjp) and walks it; the port has no tape
of its own: a Tensor's `_value` is a torch.Tensor, the dispatcher runs
each op under torch's grad mode, and torch.autograd records the graph and
walks it. This module keeps the JAX names and semantics over it:

  backward(tensors, grad_tensors, retain_graph)  roots seeded with ones
      (of any shape), roots that need no grad skipped, gradients
      accumulated into the leaves' `.grad`
  grad(outputs, inputs, grad_outputs, retain_graph, create_graph,
       allow_unused)  paddle.grad: the inputs' gradients, not accumulated;
      an input that gets none raises unless allow_unused
  no_grad, enable_grad, set_grad_enabled, is_grad_enabled  torch's grad
      mode (thread-local in torch, process-global in JAX)

A second backward over a freed graph raises RuntimeError in both.
"""

from __future__ import annotations

import functools

import torch


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool) -> None:
    torch.set_grad_enabled(bool(mode))


class no_grad:
    """Context manager / decorator: disable autograd recording."""

    _mode = False

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with type(self)():
                return fn(*args, **kwargs)

        return wrapper


class enable_grad(no_grad):
    _mode = True


def _values(tensors):
    return [t._value for t in tensors]


def _seed(t, g):
    """The root gradient: ones of t's shape unless one was given."""
    if g is None:
        return torch.ones_like(t._value)
    from paddle_tpu_torch.core.tensor import Tensor

    v = g._value if isinstance(g, Tensor) else torch.as_tensor(g)
    return v.to(device=t._value.device, dtype=t._value.dtype)


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward."""
    if not isinstance(tensors, (list, tuple)):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    roots, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        if t._value.requires_grad:
            roots.append(t._value)
            seeds.append(_seed(t, g))
    if roots:
        torch.autograd.backward(roots, seeds, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """paddle.grad: partial-graph gradients. With create_graph the returned
    gradients carry their own graph (grad of grad)."""
    from paddle_tpu_torch.core.tensor import Tensor

    if not isinstance(outputs, (list, tuple)):
        outputs = [outputs]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    if retain_graph is None:
        retain_graph = bool(create_graph)
    outs, seeds = [], []
    for t, g in zip(outputs, grad_outputs):
        if t._value.requires_grad:
            outs.append(t._value)
            seeds.append(_seed(t, g))
    # inputs that take no gradient (stop_gradient, or no part of a graph)
    # get None, as the JAX walk leaves them uncaptured
    live = [i for i, t in enumerate(inputs)
            if not t.stop_gradient and t._value.requires_grad]
    res = [None] * len(inputs)
    if outs and live:
        got = torch.autograd.grad(
            outs, [inputs[i]._value for i in live], seeds,
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=True)
        for i, g in zip(live, got):
            if g is not None:
                res[i] = Tensor(g, stop_gradient=not create_graph)
    if not allow_unused and any(g is None for g in res):
        raise RuntimeError(
            "one of the input tensors received no gradient; pass "
            "allow_unused=True to permit this")
    return res
