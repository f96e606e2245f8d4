"""The CPU side of the op sweep: each case of `_torch_op_cases` through
the JAX package's `_C_ops` (eagerly: FLAGS_eager_op_jit off, so no per-op
compile) and through the port's `_C_ops` on CPU Tensors, compared by
`_torch_op_cases.compare`.

The JAX dispatch cannot take the VJP of an op whose impl returns a
namedtuple (jnp.linalg's svd, qr and eigh results: "unexpected tree
structure"), so for those three the JAX impl's result is handed to the
dispatcher as a plain tuple; the JAX package itself is not changed.
"""

import contextlib

import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.core import place

import _torch_op_cases as oc

torch.set_num_threads(1)

NAMEDTUPLE_OPS = ("svd", "qr", "eigh")


def _plain(impl):
    def op(*args, **kwargs):
        out = impl(*args, **kwargs)
        return tuple(out) if isinstance(out, tuple) else out
    return op


@contextlib.contextmanager
def cpu_sweep():
    """The port on CPU Tensors, the JAX dispatch eager, the namedtuple
    ops as plain tuples; everything restored after."""
    saved_place = place._expected_place
    saved_flag = paddle_tpu.get_flags("FLAGS_eager_op_jit")
    saved_impls = {n: jax_registry.OPS[n].impl for n in NAMEDTUPLE_OPS}
    paddle_tpu_torch.set_device("cpu")
    paddle_tpu.set_flags({"FLAGS_eager_op_jit": False})
    for n, impl in saved_impls.items():
        jax_registry.OPS[n].impl = _plain(impl)
    try:
        yield
    finally:
        for n, impl in saved_impls.items():
            jax_registry.OPS[n].impl = impl
        paddle_tpu.set_flags(saved_flag)
        place._expected_place = saved_place


def check(case):
    """Assert the port's result of ``case`` equals the JAX package's."""
    ref = oc.run(paddle_tpu, case)
    got = oc.run(paddle_tpu_torch, case)
    problems = oc.compare(ref, got, *(case.tol or (oc.RTOL, oc.ATOL)))
    assert not problems, f"{case.id}: {problems}"
