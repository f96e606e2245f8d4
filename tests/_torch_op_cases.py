"""The op sweep's case table: inputs, attributes and tolerances for every
ported op of ops.yaml, and one runner that drives a case through either
package's `_C_ops` (both have the same surface: to_tensor, _C_ops,
Tensor.backward, .grad, .numpy()).

Importable without jax: `tests/test_torch_ops_*.py` run each case through
paddle_tpu and paddle_tpu_torch on the CPU and compare; `chip_smoke.py`
runs each case through paddle_tpu_torch on CUDA tensors and on CPU
tensors and compares those.

A case: the op, a function making its positional arguments from a numpy
Generator (`T(array)` marks a tensor, `TL([...])` a list of tensors,
anything else is passed as it is), keyword attributes, and options:
  tol     (rtol, atol) where the default (1e-5, 1e-6) is too tight, with
          the reason beside the case
  post    post(outs, api) -> the outputs to compare (and to take the loss
          of), for outputs that are unique only up to signs or order
  grad    False: compare no gradients (non-diff ops take none anyway)
  rng     a random op: compared by dtype, shape and moments, not values
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

RTOL, ATOL = 1e-5, 1e-6


class T:
    """A tensor argument (float32 arrays take gradients)."""

    def __init__(self, array, grad=None):
        self.array = np.asarray(array)
        self.grad = (self.array.dtype == np.float32) if grad is None else grad


class TL:
    """A list of tensor arguments."""

    def __init__(self, items):
        self.items = list(items)


@dataclass
class Case:
    op: str
    build: Callable
    kwargs: dict = field(default_factory=dict)
    tol: Optional[tuple] = None
    post: Optional[Callable] = None
    grad: bool = True
    rng: bool = False
    label: str = ""

    @property
    def id(self):
        return self.op + (f"-{self.label}" if self.label else "")

    def args(self):
        rng = np.random.default_rng(zlib.crc32(self.id.encode()))
        return self.build(rng)


# ------------------------------------------------------------- generators

def f(r, *shape, lo=-1.0, hi=1.0):
    return r.uniform(lo, hi, shape).astype(np.float32)


def fp(r, *shape):
    """Positive, away from 0."""
    return r.uniform(0.5, 2.0, shape).astype(np.float32)


def fu(r, *shape):
    """Inside (0, 1), away from the ends."""
    return r.uniform(0.1, 0.9, shape).astype(np.float32)


def fgt1(r, *shape):
    """Above 1 (acosh's domain)."""
    return r.uniform(1.1, 3.0, shape).astype(np.float32)


def ii(r, *shape, lo=-5, hi=6):
    return r.integers(lo, hi, shape).astype(np.int32)


def bb(r, *shape):
    return r.random(shape) < 0.5


def spd(r, n):
    a = f(r, n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def tri(r, n, upper=True):
    a = f(r, n, n) + 3 * np.eye(n, dtype=np.float32)
    return (np.triu(a) if upper else np.tril(a)).astype(np.float32)


def distinct(r, *shape):
    """Floats with no ties (sort, arg-reductions, cummax)."""
    n = int(np.prod(shape))
    return (r.permutation(n).reshape(shape) / n
            + r.uniform(0, 0.1 / n, shape)).astype(np.float32)


C = Case
CASES = []


def add(*cases):
    CASES.extend(cases)


def x1(shape=(3, 4), gen=f, **kw):
    return lambda r: [T(gen(r, *shape))]


def x2(shape=(3, 4), gen=f, gen2=None):
    return lambda r: [T(gen(r, *shape)), T((gen2 or gen)(r, *shape))]


# ============================================================ first block
# ---- elementwise binary math
add(C("add", x2()), C("add", lambda r: [T(f(r, 3, 4)), T(f(r, 4))],
                      label="broadcast"),
    C("add", lambda r: [T(ii(r, 3)), T(ii(r, 3))], label="int"),
    C("add", lambda r: [T(f(r, 3, 4)), T(np.float32(2.0))], label="0d"),
    C("add", lambda r: [T(f(r, 3)), 1.5], label="scalar"),
    C("subtract", x2()), C("multiply", x2()),
    C("multiply", lambda r: [T(ii(r, 4)), 2.5], label="int-float"),
    C("divide", lambda r: [T(f(r, 3, 4)), T(fp(r, 3, 4))]),
    C("divide", lambda r: [T(ii(r, 4)), T(ii(r, 4, lo=1, hi=5))],
      label="int"),
    C("floor_divide", lambda r: [T(ii(r, 6)), T(ii(r, 6, lo=1, hi=4))]),
    C("floor_divide", lambda r: [T(f(r, 6)), T(fp(r, 6))], label="float",
      grad=False),
    C("remainder", lambda r: [T(ii(r, 6, lo=-9, hi=9)),
                              T(ii(r, 6, lo=1, hi=4))]),
    C("remainder", lambda r: [T(f(r, 6, lo=-3, hi=3)), T(fp(r, 6))],
      label="float"),
    C("pow", lambda r: [T(fp(r, 3, 4)), T(f(r, 3, 4))]),
    C("pow", lambda r: [T(ii(r, 4, lo=0, hi=4)), 2], label="int"),
    C("maximum", x2()), C("minimum", x2()), C("fmax", x2()),
    C("fmin", x2()), C("atan2", x2()),
    C("lerp", lambda r: [T(f(r, 3, 4)), T(f(r, 3, 4)), T(fu(r, 3, 4))]))
# ---- elementwise unary math
for name, gen in (("abs", f), ("neg", f), ("exp", f), ("expm1", f),
                  ("log", fp), ("log2", fp), ("log10", fp), ("log1p", fp),
                  ("sqrt", fp), ("rsqrt", fp), ("square", f),
                  ("reciprocal", fp), ("sin", f), ("cos", f), ("tan", f),
                  ("asin", fu), ("acos", fu), ("atan", f), ("sinh", f),
                  ("cosh", f), ("tanh", f), ("asinh", f), ("acosh", fgt1),
                  ("atanh", fu), ("frac", f), ("erf", f), ("erfinv", fu),
                  ("lgamma", fp), ("digamma", fp)):
    add(C(name, x1((3, 4), gen)))
for name in ("floor", "ceil", "round", "trunc", "sign"):
    add(C(name, lambda r: [T(f(r, 3, 4, lo=-3, hi=3))]))
add(C("abs", lambda r: [T(ii(r, 5))], label="int"),
    C("exp", lambda r: [T(ii(r, 5))], label="int"),
    C("logit", x1((3, 4), fu)), C("logit", x1((3, 4), fu),
                                  {"eps": 0.2}, label="eps"),
    C("clip", x1(), {"min": -0.5, "max": 0.5}),
    C("clip", x1(), {"min": -0.5}, label="min"),
    C("scale", x1(), {"scale": 2.0, "bias": 0.5}),
    C("scale", x1(), {"scale": 2.0, "bias": 0.5,
                      "bias_after_scale": False}, label="before"),
    C("isnan", lambda r: [T(np.array([1.0, np.nan, np.inf, -1],
                                     np.float32))]),
    C("isinf", lambda r: [T(np.array([1.0, np.nan, np.inf, -1],
                                     np.float32))]),
    C("isfinite", lambda r: [T(np.array([1.0, np.nan, np.inf, -1],
                                        np.float32))]),
    C("addmm", lambda r: [T(f(r, 3, 5)), T(f(r, 3, 4)), T(f(r, 4, 5))],
      {"beta": 0.5, "alpha": 2.0}))
# ---- comparison / logical
for name in ("equal", "not_equal", "greater_than", "greater_equal",
             "less_than", "less_equal"):
    add(C(name, lambda r: [T(ii(r, 3, 4, lo=0, hi=3)),
                           T(ii(r, 3, 4, lo=0, hi=3))]))
for name in ("logical_and", "logical_or", "logical_xor"):
    add(C(name, lambda r: [T(bb(r, 3, 4)), T(bb(r, 3, 4))]))
add(C("logical_not", lambda r: [T(bb(r, 3, 4))]),
    C("logical_and", lambda r: [T(ii(r, 5, lo=0, hi=2)),
                                T(f(r, 5))], label="numbers"),
    C("isclose", lambda r: [T(np.array([1.0, 1.0, 2.0], np.float32)),
                            T(np.array([1.0, 1.0 + 1e-6, 2.1],
                                       np.float32))]))
# ---- matmul / linalg
add(C("matmul", lambda r: [T(f(r, 2, 3, 4)), T(f(r, 2, 4, 5))]),
    C("matmul", lambda r: [T(f(r, 4, 3)), T(f(r, 5, 4))],
      {"transpose_x": True, "transpose_y": True}, label="transposed"),
    C("matmul", lambda r: [T(f(r, 4)), T(f(r, 4, 3))], label="vector"),
    C("dot", x2((3, 4))),
    C("einsum", lambda r: ["ij,jk->ik", T(f(r, 3, 4)), T(f(r, 4, 2))]),
    C("norm", x1()), C("norm", x1(), {"p": 1, "axis": 1}, label="p1"),
    C("norm", x1(), {"p": float("inf"), "axis": 0, "keepdim": True},
      label="inf"),
    C("norm", x1((3, 4), fp), {"p": 3, "axis": -1}, label="p3"),
    C("t", x1()), C("outer", lambda r: [T(f(r, 3)), T(f(r, 4))]),
    C("bmm", lambda r: [T(f(r, 2, 3, 4)), T(f(r, 2, 4, 5))]),
    C("mv", lambda r: [T(f(r, 3, 4)), T(f(r, 4))]),
    C("cholesky", lambda r: [T(spd(r, 4))], tol=(1e-5, 1e-5)),
    C("cholesky", lambda r: [T(spd(r, 4))], {"upper": True},
      label="upper", tol=(1e-5, 1e-5)),
    C("triangular_solve", lambda r: [T(tri(r, 4)), T(f(r, 4, 2))],
      tol=(1e-5, 1e-5)),
    C("triangular_solve", lambda r: [T(tri(r, 4, False)), T(f(r, 4, 2))],
      {"upper": False, "transpose": True}, label="lower-t",
      tol=(1e-5, 1e-5)),
    C("inverse", lambda r: [T(spd(r, 4))], tol=(1e-5, 1e-5)))
# ---- reductions
add(C("sum", x1()), C("sum", x1(), {"axis": 1, "keepdim": True},
                      label="axis"),
    C("sum", lambda r: [T(bb(r, 3, 4))], {"axis": 0}, label="bool"),
    C("sum", lambda r: [T(ii(r, 3, 4))], {"axis": [0, 1]}, label="int"),
    C("sum", lambda r: [T(ii(r, 3, 4))], {"dtype": "float32"},
      label="dtype"),
    C("mean", x1()), C("mean", x1(), {"axis": -1}, label="axis"),
    C("mean", lambda r: [T(ii(r, 3, 4))], label="int"),
    C("max", x1((3, 4), distinct)),
    C("max", x1((3, 4), distinct), {"axis": 1, "keepdim": True},
      label="axis"),
    C("min", x1((3, 4), distinct), {"axis": 0}),
    C("prod", x1((3, 4), fp)), C("prod", x1((3, 4), fp),
                                 {"axis": [0, 1]}, label="axes"),
    C("std", x1()), C("std", x1(), {"axis": 1, "unbiased": False},
                      label="biased"),
    C("var", x1(), {"axis": 0, "keepdim": True}),
    C("logsumexp", x1()), C("logsumexp", x1(), {"axis": 1}, label="axis"),
    C("all", lambda r: [T(bb(r, 3, 4))], {"axis": 1}),
    C("any", lambda r: [T(bb(r, 3, 4))]),
    C("amax", x1((3, 4), distinct), {"axis": 1}),
    C("amin", x1((3, 4), distinct)),
    C("argmax", x1((3, 4), distinct)),
    C("argmax", x1((3, 4), distinct), {"axis": 1, "keepdim": True},
      label="axis"),
    C("argmin", x1((3, 4), distinct), {"axis": 0}),
    C("cumsum", x1(), {"axis": 1}), C("cumsum", x1(), label="flat"),
    C("cumsum", lambda r: [T(ii(r, 5))], {"axis": 0}, label="int"),
    C("cumprod", x1((3, 4), fp), {"dim": 1}),
    C("median", x1((3, 4), distinct)),
    C("median", x1((3, 4), distinct), {"axis": 1}, label="axis"),
    C("nanmean", lambda r: [T(np.where(bb(r, 3, 4), np.nan,
                                       f(r, 3, 4)).astype(np.float32))],
      {"axis": 1}, grad=False),
    C("count_nonzero", lambda r: [T(ii(r, 3, 4, lo=0, hi=2))],
      {"axis": 1}))
# ---- manipulation
add(C("reshape", x1(), {"shape": [4, 3]}),
    C("reshape", x1(), {"shape": [2, -1]}, label="infer"),
    C("transpose", x1((2, 3, 4)), {"perm": [2, 0, 1]}),
    C("swapaxes", x1((2, 3, 4)), {"axis0": 0, "axis1": 2}),
    C("concat", lambda r: [TL([T(f(r, 2, 3)), T(f(r, 1, 3))])]),
    C("concat", lambda r: [TL([T(f(r, 2, 3)), T(f(r, 2, 2))])],
      {"axis": 1}, label="axis"),
    C("stack", lambda r: [TL([T(f(r, 2, 3)), T(f(r, 2, 3))])],
      {"axis": 1}),
    C("split", x1((6, 4)), {"num_or_sections": 3}),
    C("split", x1((6, 4)), {"num_or_sections": [1, -1, 2], "axis": 0},
      label="sections"),
    C("chunk", x1((10, 2)), {"chunks": 4}),
    C("squeeze", x1((3, 1, 4, 1))),
    C("squeeze", x1((3, 1, 4, 1)), {"axis": 1}, label="axis"),
    C("unsqueeze", x1(), {"axis": [0, 2]}),
    C("flatten", x1((2, 3, 4)), {"start_axis": 1}),
    C("tile", x1((2, 3)), {"repeat_times": [2, 1, 2]}),
    C("expand", x1((1, 3)), {"shape": [2, -1, 3]}),
    C("broadcast_to", x1((1, 3)), {"shape": [4, 3]}),
    C("flip", x1(), {"axis": [0, 1]}),
    C("roll", x1(), {"shifts": 2, "axis": 1}),
    C("roll", x1(), {"shifts": 5}, label="flat"),
    C("where", lambda r: [T(bb(r, 3, 4)), T(f(r, 3, 4)), T(f(r, 3, 4))]),
    C("gather", lambda r: [T(f(r, 5, 3)), T(np.array([0, 4, 2, 2]))]),
    C("gather", lambda r: [T(f(r, 5, 3)), T(np.array([[0, 1], [2, 0]]))],
      {"axis": 1}, label="axis"),
    C("gather_nd", lambda r: [T(f(r, 3, 4, 2)),
                              T(np.array([[0, 1], [2, 3], [1, 1]]))]),
    C("take_along_axis", lambda r: [T(f(r, 3, 4)),
                                    T(r.integers(0, 4, (3, 2)))],
      {"axis": 1}),
    C("put_along_axis", lambda r: [T(f(r, 3, 4)),
                                   T(np.array([[0], [3], [1]])),
                                   T(f(r, 3, 1))], {"axis": 1}),
    C("put_along_axis", lambda r: [T(f(r, 3, 4)),
                                   T(np.array([[0, 2], [3, 3], [1, 0]])),
                                   T(f(r, 3, 2))],
      {"axis": 1, "reduce": "add"}, label="add"),
    C("index_select", lambda r: [T(f(r, 5, 3)), T(np.array([4, 0, 1]))]),
    C("index_sample", lambda r: [T(f(r, 3, 5)),
                                 T(r.integers(0, 5, (3, 2)))]),
    C("masked_select", lambda r: [T(f(r, 3, 4)), T(bb(r, 3, 4))]),
    C("masked_fill", lambda r: [T(f(r, 3, 4)), T(bb(r, 3, 4))],
      {"value": 0.5}),
    C("scatter", lambda r: [T(f(r, 5, 3)), T(np.array([1, 3])),
                            T(f(r, 2, 3))]),
    C("scatter", lambda r: [T(f(r, 5, 3)), T(np.array([1, 1])),
                            T(f(r, 2, 3))], {"overwrite": False},
      label="add"),
    C("scatter_nd_add", lambda r: [T(f(r, 4, 3)),
                                   T(np.array([[1], [1], [3]])),
                                   T(f(r, 3, 3))]),
    C("pad", x1((2, 3)), {"pad": [1, 2, 0, 1], "value": 0.5}),
    C("pad", x1((1, 2, 4, 5)), {"pad": [1, 2, 2, 1], "mode": "reflect"},
      label="reflect"),
    C("pad", x1((1, 2, 4, 5)), {"pad": [1, 2], "mode": "replicate"},
      label="replicate"),
    C("pad", x1((1, 2, 4, 5)), {"pad": [3, 1], "mode": "circular"},
      label="circular"),
    C("tril", x1((4, 4)), {"diagonal": -1}), C("triu", x1((4, 5))),
    C("diag", x1((4,))), C("diag", x1((4, 5)), {"offset": 1},
                           label="matrix"),
    C("diagonal", x1((2, 3, 4)), {"offset": 1, "axis1": 1, "axis2": 2}),
    C("repeat_interleave", x1((2, 3)), {"repeats": 2, "axis": 1}),
    C("unbind", x1((3, 4)), {"axis": 1}),
    C("unstack", x1((3, 4))),
    C("one_hot", lambda r: [T(np.array([0, 3, 1]))], {"num_classes": 4}),
    C("kron", lambda r: [T(f(r, 2, 3)), T(f(r, 2, 2))]),
    C("cross", x2((4, 3))),
    C("searchsorted", lambda r: [T(np.array([1.0, 2, 3, 5], np.float32)),
                                 T(np.array([0.5, 2, 4, 6], np.float32))]),
    C("searchsorted", lambda r: [T(np.array([1.0, 2, 3, 5], np.float32)),
                                 T(np.array([2.0, 5], np.float32))],
      {"right": True, "out_int32": True}, label="right"),
    C("bincount", lambda r: [T(np.array([0, 1, 1, 3, 3, 3]))],
      {"minlength": 6}),
    C("cast", x1(), {"dtype": "float16"}, grad=False),
    C("cast", x1((3, 4), fp), {"dtype": "int64"}, label="int"),
    C("cast", lambda r: [T(ii(r, 4))], {"dtype": "float32"},
      label="to-float"))
# ---- sort / search
add(C("topk", x1((3, 6), distinct), {"k": 2}),
    C("topk", x1((3, 6), distinct), {"k": 3, "axis": 0, "largest": False},
      label="smallest"),
    C("sort", x1((3, 6), distinct)),
    C("sort", x1((3, 6), distinct), {"axis": 0, "descending": True},
      label="descending"),
    C("argsort", lambda r: [T(ii(r, 3, 6, lo=0, hi=3))]),
    C("argsort", lambda r: [T(ii(r, 3, 6, lo=0, hi=3))],
      {"descending": True}, label="descending"),
    C("nonzero", lambda r: [T(ii(r, 3, 4, lo=0, hi=2))]),
    C("unique", lambda r: [T(ii(r, 3, 4, lo=0, hi=4))]),
    C("unique", lambda r: [T(ii(r, 3, 4, lo=0, hi=4))],
      {"return_index": True, "return_inverse": True,
       "return_counts": True}, label="all"))
# ---- activations
for name in ("relu", "relu6", "sigmoid", "silu", "swish", "mish",
             "hardswish", "selu", "softsign", "tanhshrink"):
    add(C(name, lambda r: [T(f(r, 3, 4, lo=-4, hi=4))]))
add(C("gelu", x1()), C("gelu", x1(), {"approximate": True}, label="tanh"),
    C("hardsigmoid", lambda r: [T(f(r, 3, 4, lo=-5, hi=5))]),
    C("hardtanh", lambda r: [T(f(r, 3, 4, lo=-2, hi=2))],
      {"min": -0.5, "max": 0.7}),
    C("leaky_relu", x1(), {"negative_slope": 0.2}),
    C("elu", x1(), {"alpha": 0.7}), C("celu", x1(), {"alpha": 1.3}),
    C("softplus", lambda r: [T(f(r, 3, 4, lo=-4, hi=4))],
      {"beta": 2.0, "threshold": 3.0}),
    C("softshrink", x1(), {"threshold": 0.3}),
    C("hardshrink", x1(), {"threshold": 0.3}),
    C("prelu", lambda r: [T(f(r, 2, 3, 4)), T(f(r, 1, 3, 1))]),
    C("softmax", x1()), C("softmax", x1(), {"axis": 0}, label="axis"),
    C("log_softmax", x1(), {"axis": -1}),
    C("glu", x1((3, 4))), C("swiglu", x1((3, 4))),
    C("swiglu", x2((3, 4)), label="pair"))
# ---- nn core
add(C("linear", lambda r: [T(f(r, 2, 3, 4)), T(f(r, 4, 5)), T(f(r, 5))]),
    C("embedding", lambda r: [T(np.array([[0, 2], [3, 1]])),
                              T(f(r, 4, 3))]),
    C("embedding", lambda r: [T(np.array([[0, 2], [3, 1]])),
                              T(f(r, 4, 3))], {"padding_idx": 2},
      label="padding"),
    C("dropout", x1(), {"p": 0.0}, label="p0"),
    C("dropout", x1(), {"p": 0.3, "training": False,
                        "mode": "downscale_in_infer"}, label="infer"),
    C("dropout", x1((64, 64)), {"p": 0.25}, rng=True),
    C("layer_norm", lambda r: [T(f(r, 2, 3, 4)), T(f(r, 4)), T(f(r, 4))],
      tol=(1e-5, 1e-5)),
    C("layer_norm", lambda r: [T(f(r, 2, 3, 4)), T(f(r, 3, 4))],
      {"begin_norm_axis": 1}, label="axis1", tol=(1e-5, 1e-5)),
    C("rms_norm", lambda r: [T(f(r, 2, 3, 4)), T(f(r, 4))],
      tol=(1e-5, 1e-5)),
    C("batch_norm", lambda r: [T(f(r, 2, 3, 4, 4)), T(f(r, 3)),
                               T(fp(r, 3)), T(f(r, 3)), T(f(r, 3))],
      tol=(1e-5, 1e-5)),
    C("batch_norm", lambda r: [T(f(r, 2, 3, 4, 4)), T(f(r, 3)),
                               T(fp(r, 3)), T(f(r, 3)), T(f(r, 3))],
      {"training": True}, label="training", tol=(1e-5, 1e-5)),
    C("group_norm", lambda r: [T(f(r, 2, 4, 3, 3)), T(f(r, 4)),
                               T(f(r, 4))], {"groups": 2},
      tol=(1e-5, 1e-5)),
    C("instance_norm", lambda r: [T(f(r, 2, 3, 4, 4)), T(f(r, 3)),
                                  T(f(r, 3))], tol=(1e-5, 1e-5)))
# ---- conv / pool / vision
add(C("conv2d", lambda r: [T(f(r, 2, 3, 6, 6)), T(f(r, 4, 3, 3, 3)),
                           T(f(r, 4))], {"stride": 2, "padding": 1}),
    C("conv2d", lambda r: [T(f(r, 1, 4, 7, 7)), T(f(r, 4, 2, 3, 3))],
      {"padding": "SAME", "stride": 2, "groups": 2, "dilation": 1},
      label="same-groups"),
    C("conv2d", lambda r: [T(f(r, 1, 5, 5, 3)), T(f(r, 2, 3, 2, 2))],
      {"data_format": "NHWC", "padding": [0, 1, 1, 0]}, label="nhwc"),
    C("conv1d", lambda r: [T(f(r, 2, 3, 8)), T(f(r, 4, 3, 3)),
                           T(f(r, 4))], {"padding": 1, "stride": 2}),
    C("conv2d_transpose", lambda r: [T(f(r, 1, 4, 3, 3)),
                                     T(f(r, 4, 2, 3, 3)), T(f(r, 2))],
      {"stride": 2, "padding": 1, "output_padding": 1}),
    C("max_pool2d", x1((1, 2, 6, 6)), {"kernel_size": 2}),
    C("max_pool2d", x1((1, 2, 7, 7)),
      {"kernel_size": 3, "stride": 2, "padding": 1, "ceil_mode": True},
      label="ceil"),
    C("avg_pool2d", x1((1, 2, 6, 6)), {"kernel_size": 3, "stride": 3}),
    C("avg_pool2d", x1((1, 2, 7, 7)),
      {"kernel_size": 3, "stride": 2, "padding": 1}, label="exclusive"),
    C("adaptive_avg_pool2d", x1((1, 2, 6, 6)), {"output_size": 3}),
    C("adaptive_avg_pool2d", x1((1, 2, 7, 5)), {"output_size": [3, 2]},
      label="resize"),
    C("adaptive_max_pool2d", x1((1, 2, 6, 4)), {"output_size": [3, 2]}),
    C("interpolate", x1((1, 2, 3, 4)), {"scale_factor": 2}),
    C("interpolate", x1((1, 2, 3, 4)), {"size": [5, 7],
                                        "mode": "bilinear"},
      label="bilinear"),
    C("interpolate", x1((1, 2, 6, 8)), {"size": [4, 3],
                                        "mode": "bicubic"},
      label="bicubic-down"),
    C("pixel_shuffle", x1((1, 8, 2, 3)), {"upscale_factor": 2}),
    C("unfold", x1((1, 2, 5, 5)), {"kernel_sizes": 3, "strides": 2,
                                   "paddings": 1}))
# ---- losses
add(C("softmax_with_cross_entropy",
      lambda r: [T(f(r, 4, 5)), T(np.array([[1], [4], [-100], [0]]))]),
    C("softmax_with_cross_entropy",
      lambda r: [T(f(r, 4, 5)), T(fu(r, 4, 5))], {"soft_label": True},
      label="soft"),
    C("cross_entropy", lambda r: [T(f(r, 4, 5)),
                                  T(np.array([1, 4, -100, 0]))]),
    C("cross_entropy", lambda r: [T(f(r, 4, 5)), T(np.array([1, 4, 2, 0]))],
      {"weight": None, "label_smoothing": 0.1, "reduction": "sum"},
      label="smoothing"),
    C("cross_entropy", lambda r: [T(f(r, 4, 5)),
                                  T(np.array([[1], [4], [2], [0]])),
                                  ],
      {"reduction": "none"}, label="none"),
    C("cross_entropy", lambda r: [T(f(r, 4, 5)), T(fu(r, 4, 5))],
      {"soft_label": True}, label="soft"),
    C("nll_loss", lambda r: [T(f(r, 4, 5)), T(np.array([1, 4, -100, 0])),
                             T(fp(r, 5))]),
    C("mse_loss", x2()), C("l1_loss", x2(), {"reduction": "sum"}),
    C("smooth_l1_loss", lambda r: [T(f(r, 3, 4, lo=-3, hi=3)),
                                   T(f(r, 3, 4))], {"delta": 0.5}),
    C("binary_cross_entropy", x2((3, 4), fu)),
    C("binary_cross_entropy_with_logits",
      lambda r: [T(f(r, 3, 4, lo=-3, hi=3)), T(fu(r, 3, 4))]),
    C("binary_cross_entropy_with_logits",
      lambda r: [T(f(r, 3, 4, lo=-3, hi=3)), T(fu(r, 3, 4))],
      {"pos_weight": None, "reduction": "none"}, label="none"),
    C("kl_div", lambda r: [T(f(r, 3, 4)), T(fu(r, 3, 4))]),
    C("cosine_similarity", x2((3, 4))))
# ---- statistics extensions
add(C("histogram", x1((20,)), {"bins": 5}),
    C("histogram", x1((20,)), {"bins": 4, "min": -0.5, "max": 0.5},
      label="range"),
    C("quantile", x1((3, 6), distinct), {"q": 0.3, "axis": 1}),
    C("quantile", x1((3, 6), distinct), {"q": [0.25, 0.75]},
      label="list"),
    C("nanquantile", lambda r: [T(np.where(bb(r, 3, 6), np.nan,
                                           distinct(r, 3, 6)))],
      {"q": 0.5, "axis": 1}, grad=False),
    C("nansum", lambda r: [T(np.where(bb(r, 3, 4), np.nan,
                                      f(r, 3, 4)).astype(np.float32))],
      {"axis": 0}, grad=False),
    C("kthvalue", x1((3, 6), distinct), {"k": 2}),
    C("kthvalue", x1((3, 6), distinct), {"k": 3, "axis": 0,
                                         "keepdim": True}, label="axis"),
    C("mode", lambda r: [T(np.array([[1., 2, 2, 3, 3], [4, 4, 1, 1, 0]],
                                    np.float32))]),
    C("diff", x1((3, 6))), C("diff", x1((3, 6)), {"n": 2, "axis": 0},
                             label="n2"),
    C("logcumsumexp", x1(), {"axis": 1}),
    C("trapezoid", x1((3, 5)), {"dx": 0.5}),
    C("trapezoid", lambda r: [T(f(r, 3, 5))],
      {"x": None, "axis": 0}, label="axis"),
    C("bucketize", lambda r: [T(np.array([0.5, 2, 4, 6], np.float32)),
                              T(np.array([1.0, 2, 3, 5], np.float32))]),
    C("heaviside", lambda r: [T(np.array([-1.0, 0, 2, 0], np.float32)),
                              T(np.array([0.5, 0.25, 1, 1], np.float32))],
      grad=False),
    C("gcd", lambda r: [T(ii(r, 6, lo=0, hi=30)), T(ii(r, 6, lo=0, hi=30))]),
    C("lcm", lambda r: [T(ii(r, 6, lo=1, hi=12)), T(ii(r, 6, lo=1, hi=12))]),
    C("deg2rad", x1()), C("rad2deg", x1()),
    C("angle", lambda r: [T(np.array([-1.0, 2.0, -3.0], np.float32))],
      grad=False),
    C("conj", x1()), C("real", x1()), C("imag", x1()),
    C("nan_to_num", lambda r: [T(np.array([1.0, np.nan, np.inf, -np.inf],
                                          np.float32))],
      {"nan": 0.5, "posinf": 9.0}),
    C("rot90", x1((3, 4)), {"k": 1}),
    C("rot90", x1((2, 3, 4)), {"k": 3, "axes": [1, 2]}, label="k3"),
    C("vander", lambda r: [T(np.array([1.0, 2, 3], np.float32))],
      {"n": 4}),
    C("vander", lambda r: [T(np.array([1.0, 2, 3], np.float32))],
      {"increasing": True}, label="increasing"),
    C("renorm", x1((3, 4), fp), {"p": 2.0, "axis": 0, "max_norm": 2.0}))
# ---- attention
add(C("scaled_dot_product_attention",
      lambda r: [T(f(r, 2, 5, 2, 8)), T(f(r, 2, 5, 2, 8)),
                 T(f(r, 2, 5, 2, 8))], {"is_causal": True}),
    C("scaled_dot_product_attention",
      lambda r: [T(f(r, 2, 5, 2, 8)), T(f(r, 2, 6, 2, 8)),
                 T(f(r, 2, 6, 2, 8)),
                 T(np.where(bb(r, 2, 1, 1, 6), 0.0, -1e30)
                   .astype(np.float32), grad=False)], label="mask"),
    C("flash_attn", lambda r: [T(f(r, 1, 6, 2, 8)), T(f(r, 1, 6, 2, 8)),
                               T(f(r, 1, 6, 2, 8))], {"causal": True}),
    C("flash_attn_qkvpacked", x1((1, 6, 3, 2, 8))),
    C("flash_attn_unpadded",
      lambda r: [T(f(r, 7, 2, 8)), T(f(r, 7, 2, 8)), T(f(r, 7, 2, 8)),
                 T(np.array([0, 3, 7])), T(np.array([0, 3, 7]))],
      {"causal": True}),
    C("flash_attn_varlen_qkvpacked",
      lambda r: [T(f(r, 7, 3, 2, 8)), T(np.array([0, 4, 7])),
                 T(np.array([0, 4, 7]))]),
    C("flashmask_attention",
      lambda r: [T(f(r, 1, 6, 2, 8)), T(f(r, 1, 6, 2, 8)),
                 T(f(r, 1, 6, 2, 8)),
                 T(np.array([6, 6, 4, 5, 6, 6]).reshape(1, 1, 6, 1))],
      {"causal": True}),
    C("sparse_attention",
      lambda r: [T(f(r, 1, 2, 4, 8)), T(f(r, 1, 2, 4, 8)),
                 T(f(r, 1, 2, 4, 8)),
                 T(np.tile(np.array([0, 1, 3, 5, 8]), (1, 2, 1))),
                 T(np.tile(np.array([0, 0, 1, 1, 2, 0, 2, 3]),
                           (1, 2, 1)))]),
    C("rotary_embedding",
      lambda r: [T(f(r, 2, 4, 2, 8)), T(f(r, 2, 4, 2, 8)),
                 T(f(r, 4, 8)), T(f(r, 4, 8))]))
FIRST_BLOCK_CASES = len(CASES)

# ============================================================ round 2
def _sym(r, n=4):
    a = f(r, n, n)
    return ((a + a.T) / 2).astype(np.float32)


def _svd_post(outs, api):
    u, s, vh = outs
    c = api._C_ops
    return [c.matmul(c.multiply(u, c.unsqueeze(s, -2)), vh), s]


def _eigh_post(outs, api):
    w, v = outs
    c = api._C_ops
    return [w, c.matmul(c.multiply(v, c.unsqueeze(w, -2)), c.t(v))]


def _eig_post(outs, api):
    c = api._C_ops
    return [c.sort(c.real(outs[0]))]


def _eigvals_post(outs, api):
    c = api._C_ops
    return [c.sort(c.real(outs[0]))]


# ---- linalg family
add(C("svd", x1((4, 3)), post=_svd_post, tol=(1e-5, 1e-5)),
    C("svdvals", x1((4, 3)), tol=(1e-5, 1e-5)),
    C("qr", x1((4, 3)), tol=(1e-5, 1e-5)),
    C("eig", lambda r: [T(_sym(r))], post=_eig_post, tol=(1e-5, 1e-5)),
    C("eigvals", lambda r: [T(_sym(r))], post=_eigvals_post,
      tol=(1e-5, 1e-5)),
    C("eigh", lambda r: [T(_sym(r))], post=_eigh_post, tol=(1e-5, 1e-5)),
    C("eigvalsh", lambda r: [T(_sym(r))], tol=(1e-5, 1e-5)),
    C("lstsq", lambda r: [T(f(r, 5, 3)), T(f(r, 5, 2))], grad=False,
      tol=(1e-4, 1e-5)),
    C("lu", lambda r: [T(f(r, 4, 4))], tol=(1e-5, 1e-5)),
    C("lu_unpack", lambda r: [T(f(r, 4, 4)),
                              T(np.array([2, 4, 3, 4], np.int32))]),
    C("det", lambda r: [T(spd(r, 3) / 3)], tol=(1e-5, 1e-5)),
    C("slogdet", lambda r: [T(f(r, 3, 3) + 2 * np.eye(3, dtype=np.float32))],
      tol=(1e-5, 1e-5)),
    C("solve", lambda r: [T(spd(r, 4)), T(f(r, 4, 2))], tol=(1e-5, 1e-5)),
    C("cholesky_solve", lambda r: [T(f(r, 4, 2)),
                                   T(np.linalg.cholesky(spd(r, 4))
                                     .astype(np.float32))],
      tol=(1e-5, 1e-5)),
    C("matrix_power", lambda r: [T(f(r, 3, 3))], {"n": 3}),
    C("matrix_rank", lambda r: [T(np.outer(f(r, 4), f(r, 4)))]),
    C("multi_dot", lambda r: [TL([T(f(r, 2, 3)), T(f(r, 3, 4)),
                                  T(f(r, 4, 2))])]),
    C("trace", x1((4, 5)), {"offset": 1}),
    C("p_norm", x1((3, 4)), {"porder": 3.0, "axis": 1}),
    C("p_norm", x1((3, 4)), {"porder": float("inf"), "asvector": True},
      label="inf"),
    C("frobenius_norm", x1((3, 4)), {"axis": [0, 1]}),
    C("dist", x2((3, 4)), {"p": 3.0}),
    # no derivative in either package: the inputs take no gradient
    C("nextafter", lambda r: [T(f(r, 3, 4), grad=False),
                              T(f(r, 3, 4), grad=False)]))
# ---- creation
add(C("empty", lambda r: [[2, 3]], {"dtype": "float32"}),
    C("empty_like", x1()),
    C("eye", lambda r: [3, 4], {"dtype": "int64"}),
    C("full", lambda r: [[2, 3], 1.5]),
    C("full_like", x1(), {"fill_value": 2, "dtype": "int64"}),
    C("linspace", lambda r: [0.0, 1.0, 7]),
    C("linspace", lambda r: [0, 10, 4], {"dtype": "int32"}, label="int"),
    C("logspace", lambda r: [0.0, 2.0, 5], {"base": 2.0}),
    C("meshgrid", lambda r: [TL([T(f(r, 3)), T(f(r, 2))])]),
    C("ones", lambda r: [[2, 2]], {"dtype": "bool"}),
    C("ones_like", x1()), C("zeros", lambda r: [[3]]),
    C("zeros_like", lambda r: [T(ii(r, 3))], {"dtype": "float32"}),
    C("tril_indices", lambda r: [4, 3], {"offset": -1}),
    C("triu_indices", lambda r: [3, 4], {"offset": 1}),
    C("diag_embed", x1((2, 3)), {"offset": 1}))
# ---- random (compared by dtype, shape and moments)
add(C("bernoulli", lambda r: [T(np.full((64, 64), 0.3, np.float32))],
      rng=True),
    C("binomial", lambda r: [T(np.full((64, 64), 10.0, np.float32))],
      {"prob": T(np.full((64, 64), 0.3, np.float32))}, rng=True),
    C("dirichlet", lambda r: [T(np.full((1024, 3), 2.0, np.float32))],
      rng=True),
    C("exponential_", lambda r: [T(np.zeros((64, 64), np.float32))],
      {"lam": 2.0}, rng=True),
    C("gumbel_softmax", lambda r: [T(np.zeros((1024, 4), np.float32))],
      {"temperature": 0.5}, rng=True),
    C("multinomial", lambda r: [T(np.array([[0.1, 0.2, 0.7]] * 4096,
                                           np.float32))], rng=True),
    C("poisson", lambda r: [T(np.full((64, 64), 3.0, np.float32))],
      rng=True),
    C("standard_gamma", lambda r: [T(np.full((64, 64), 2.0, np.float32))],
      rng=True),
    C("rrelu", lambda r: [T(-np.ones((64, 64), np.float32))], rng=True),
    C("gaussian", lambda r: [[64, 64]], {"mean": 1.0, "std": 2.0},
      rng=True),
    C("uniform", lambda r: [[64, 64]], {"min": -2.0, "max": 1.0},
      rng=True),
    C("randint", lambda r: [3], {"high": 9, "shape": [64, 64]}, rng=True),
    C("randperm", lambda r: [1000], rng=True),
    C("truncated_gaussian_random", lambda r: [[64, 64]],
      {"std": 1.5, "a": -1.0, "b": 2.0}, rng=True))
# ---- bitwise
add(C("bitwise_and", lambda r: [T(ii(r, 6, lo=-50, hi=50)),
                                T(ii(r, 6, lo=-50, hi=50))]),
    C("bitwise_or", lambda r: [T(ii(r, 6, lo=-50, hi=50)),
                               T(ii(r, 6, lo=-50, hi=50))]),
    C("bitwise_xor", lambda r: [T(bb(r, 6)), T(bb(r, 6))]),
    C("bitwise_not", lambda r: [T(ii(r, 6, lo=-50, hi=50))]),
    C("bitwise_left_shift", lambda r: [T(ii(r, 6, lo=-50, hi=50)),
                                       T(ii(r, 6, lo=0, hi=5))]),
    C("bitwise_right_shift", lambda r: [T(ii(r, 6, lo=-50, hi=50)),
                                        T(ii(r, 6, lo=0, hi=5))]),
    C("bitwise_right_shift", lambda r: [T(ii(r, 6, lo=-50, hi=50)),
                                        T(ii(r, 6, lo=0, hi=5))],
      {"is_arithmetic": False}, label="logical"))
# ---- unary extras
add(C("copysign", x2()), C("gammaln", x1((3, 4), fp)),
    C("i0", x1()), C("i0e", x1()), C("i1", x1()), C("i1e", x1()),
    C("logsigmoid", x1()), C("polygamma", x1((3, 4), fp), {"n": 1}),
    C("polygamma", x1((3, 4), fp), label="n0"),
    C("stanh", x1()), C("tanh_shrink", x1()),
    C("thresholded_relu", lambda r: [T(f(r, 3, 4, lo=-2, hi=2))],
      {"threshold": 0.5, "value": 0.1}),
    C("increment", x1(), {"value": 2.0}))
# ---- losses
add(C("bce_loss", x2((3, 4), fu)),
    C("hinge_loss", lambda r: [T(f(r, 3, 4, lo=-2, hi=2)),
                               T(np.sign(f(r, 3, 4)).astype(np.float32))]),
    C("huber_loss", lambda r: [T(f(r, 3, 4, lo=-2, hi=2)), T(f(r, 3, 4))],
      {"delta": 0.5}),
    C("kldiv_loss", lambda r: [T(f(r, 3, 4)), T(fu(r, 3, 4))]),
    C("kldiv_loss", lambda r: [T(f(r, 3, 4)), T(f(r, 3, 4))],
      {"reduction": "batchmean", "log_target": True}, label="log"),
    C("log_loss", x2((3, 4), fu)),
    C("sigmoid_cross_entropy_with_logits",
      lambda r: [T(f(r, 3, 4, lo=-2, hi=2)),
                 T(np.array([[0., 1, -100, 1]] * 3, np.float32),
                   grad=False)], {"normalize": True}),
    C("identity_loss", x1(), {"reduction": "mean"}),
    C("cross_entropy_with_softmax", lambda r: [T(f(r, 4, 5)),
                                               T(np.array([[1], [4], [2],
                                                           [-100]]))]))
# ---- manipulation / indexing
add(C("as_complex", x1((3, 2)), grad=False),
    C("as_real", lambda r: [T(f(r, 3) + 1j * f(r, 3))], grad=False),
    C("complex", x2((3,)), grad=False),
    C("as_strided", x1((4, 5)), {"shape": [3, 2], "stride": [2, 5],
                                 "offset": 1}),
    C("broadcast_tensors", lambda r: [TL([T(f(r, 3, 1)), T(f(r, 1, 4))])]),
    C("crop", x1((4, 5)), {"shape": [2, 3], "offsets": [1, 2]}),
    C("expand_as", lambda r: [T(f(r, 1, 4)), T(f(r, 3, 4))]),
    C("fill", x1(), {"value": 3.0}),
    C("fill_diagonal", x1((4, 3)), {"value": 2.0, "offset": 1}),
    C("fill_diagonal", x1((7, 3)), {"value": 2.0, "wrap": True},
      label="wrap"),
    C("fill_diagonal_tensor", lambda r: [T(f(r, 3, 4)), T(f(r, 3))],
      {"offset": 1}),
    C("index_add", lambda r: [T(f(r, 4, 3)), T(np.array([0, 2, 0])),
                              T(f(r, 3, 3))]),
    C("index_put", lambda r: [T(f(r, 4, 3)),
                              TL([T(np.array([0, 2])), T(np.array([1, 1]))]),
                              T(f(r, 2))], {"accumulate": True}),
    C("reverse", x1(), {"axis": [1]}),
    C("sequence_mask", lambda r: [T(np.array([1, 3, 0]))], {"max_len": 4}),
    C("shard_index", lambda r: [T(np.array([[1], [6], [12], [19]]))],
      {"index_num": 20, "nshards": 2, "shard_id": 0}),
    C("slice", x1((4, 5)), {"axes": [0, 1], "starts": [1, -3],
                            "ends": [3, 100]}),
    C("strided_slice", x1((4, 6)), {"axes": [1], "starts": [5],
                                    "ends": [0], "strides": [-2]}),
    C("split_with_num", x1((4, 6)), {"num": 3, "axis": 1}),
    C("multiplex", lambda r: [TL([T(f(r, 3, 2)), T(f(r, 3, 2))]),
                              T(np.array([[1], [0], [1]]))]),
    C("unique_consecutive", lambda r: [T(np.array([1, 1, 2, 2, 2, 3, 1]))],
      {"return_inverse": True, "return_counts": True}))
# ---- reductions / checks
add(C("allclose", lambda r: [T(np.array([1.0, 2.0], np.float32)),
                             T(np.array([1.0, 2.0 + 1e-6], np.float32))]),
    C("equal_all", lambda r: [T(ii(r, 4)), T(ii(r, 4))]),
    C("mean_all", x1()), C("numel", x1()), C("shape", x1((2, 3, 4))),
    C("is_empty", x1((0, 3))),
    C("nanmedian", lambda r: [T(np.where(bb(r, 3, 6), np.nan,
                                         distinct(r, 3, 6)))],
      {"axis": 1}, grad=False),
    C("cummax", x1((3, 5)), {"axis": 1}),
    C("cummax", lambda r: [T(ii(r, 8, lo=0, hi=3))], label="ties"),
    C("cummin", x1((3, 5)), {"axis": 0}),
    C("l1_norm", x1()), C("squared_l2_norm", x1()),
    C("clip_by_norm", x1(), {"max_norm": 0.5}))

# the 51 names of the round-2 block that raise, naming ROADMAP.md item 12
DEFERRED = (
    "affine_grid", "grid_sample", "channel_shuffle", "pixel_unshuffle",
    "fold", "temporal_shift", "maxout", "label_smooth", "pad3d", "pool3d",
    "max_pool3d", "avg_pool3d", "max_pool2d_with_index",
    "max_pool3d_with_index", "lp_pool2d", "nms", "gather_tree",
    "conv3d", "conv3d_transpose", "depthwise_conv2d",
    "depthwise_conv2d_transpose",
    "bilinear_interp", "nearest_interp", "bicubic_interp", "linear_interp",
    "trilinear_interp", "bilinear",
    "accuracy", "auc", "affine_channel", "conv2d_transpose_bias", "fft_c2c",
    "fft_r2c", "fft_c2r", "fractional_max_pool2d", "fractional_max_pool3d",
    "frame", "overlap_add", "stft", "full_", "gammaincc", "hsigmoid_loss",
    "matrix_rank_tol", "matrix_rank_atol_rtol", "pool2d", "reduce_as",
    "spectral_norm", "unpool", "unpool3d", "conv1d_transpose", "warpctc",
)

def cases_between(first, last):
    """The value cases (no rng case) from the first one of op ``first`` to
    the last one of op ``last``, in table order."""
    names = [c.op for c in CASES]
    lo = names.index(first)
    hi = len(names) - 1 - names[::-1].index(last)
    return [c for c in CASES[lo:hi + 1] if not c.rng]


# ------------------------------------------------------------- the runner

def _to(api, arg, grads):
    if isinstance(arg, T):
        t = api.to_tensor(arg.array, stop_gradient=not arg.grad)
        if arg.grad:
            grads.append(t)
        return t
    if isinstance(arg, TL):
        return [_to(api, a, grads) for a in arg.items]
    return arg


def run(api, case, with_grad=True):
    """Drive ``case`` through ``api`` (paddle_tpu or paddle_tpu_torch) on
    its expected place. Returns {"values": [...], "dtypes": [...],
    "grads": [...] or None} with numpy arrays."""
    grads_of = []
    args = [_to(api, a, grads_of) for a in case.args()]
    kwargs = {k: _to(api, v, grads_of) for k, v in case.kwargs.items()}
    out = getattr(api._C_ops, case.op)(*args, **kwargs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if case.post is not None:
        outs = case.post(outs, api)
    res = {"values": [o.numpy() for o in outs],
           "dtypes": [api.core.dtype.dtype_name(o.dtype) for o in outs],
           "grads": None}
    float_outs = [o for o, d in zip(outs, res["dtypes"])
                  if "float" in d and not o.stop_gradient]
    if with_grad and case.grad and grads_of and float_outs:
        c = api._C_ops
        rng = np.random.default_rng(7)
        loss = None
        for o in float_outs:
            w = rng.standard_normal(tuple(o.shape)).astype(np.float32)
            term = c.sum(c.multiply(o, api.to_tensor(w)))
            loss = term if loss is None else c.add(loss, term)
        loss.backward()
        res["grads"] = [None if t.grad is None else t.grad.numpy()
                        for t in grads_of]
    return res


def draw(api, case):
    """An rng case's output: (dtype name, shape, values as float64)."""
    out = run(api, case, with_grad=False)
    v = out["values"][0]
    return out["dtypes"][0], tuple(v.shape), v.astype(np.float64)


def compare(ref, got, rtol=RTOL, atol=ATOL):
    """The differences between two `run` results (empty when they agree):
    dtype names and shapes equal, values within (rtol, atol) (integer and
    bool outputs exact), gradients within the same (None reads as 0)."""
    problems = []
    if ref["dtypes"] != got["dtypes"]:
        problems.append(f"dtypes {ref['dtypes']} != {got['dtypes']}")
    if len(ref["values"]) != len(got["values"]):
        return problems + [f"{len(ref['values'])} outputs != "
                           f"{len(got['values'])}"]
    for i, (a, b) in enumerate(zip(ref["values"], got["values"])):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            problems.append(f"output {i}: shape {a.shape} != {b.shape}")
            continue
        exact = a.dtype.kind in "biu"
        wide = np.complex128 if a.dtype.kind == "c" else np.float64
        if exact:
            ok = np.array_equal(a, b)
        else:
            ok = np.allclose(b.astype(wide), a.astype(wide), rtol=rtol,
                             atol=atol, equal_nan=True)
        if not ok:
            err = np.nanmax(np.abs(b.astype(wide) - a.astype(wide))) \
                if a.size else 0.0
            problems.append(f"output {i}: values differ (max {err})")
    if (ref["grads"] is None) != (got["grads"] is None):
        problems.append(f"grads: {ref['grads'] is None} vs "
                        f"{got['grads'] is None} (None)")
    elif ref["grads"] is not None:
        for i, (a, b) in enumerate(zip(ref["grads"], got["grads"])):
            a = np.zeros(1, np.float32) if a is None else np.asarray(a)
            b = np.zeros(1, np.float32) if b is None else np.asarray(b)
            shape = np.broadcast_shapes(a.shape, b.shape)
            a = np.broadcast_to(a, shape).astype(np.float64)
            b = np.broadcast_to(b, shape).astype(np.float64)
            if not np.allclose(b, a, rtol=rtol, atol=atol):
                problems.append(f"grad {i}: differs (max "
                                f"{np.max(np.abs(b - a))})")
    return problems


def moments_agree(a, b):
    """Two draws of one rng case agree in dtype, shape, mean (within six
    standard errors) and standard deviation (within 10 %)."""
    (da, sa, va), (db, sb, vb) = a, b
    if (da, sa) != (db, sb):
        return False
    n = va.size
    sd = max(va.std(), vb.std())
    return (abs(va.mean() - vb.mean()) <= 6 * sd / np.sqrt(n) + 1e-6
            and abs(va.std() - vb.std()) <= 0.1 * sd + 1e-6)
