"""Op implementations: plain PyTorch functions over torch tensors, one for
each op of the first block of `ops.yaml` (the counterpart of
paddle_tpu/ops/impl.py), and the flash attention family over the K3
kernels. impl_extra's names are imported at the end, so the registry
finds every op here.

Same signatures and semantics as the JAX functions of the same names:
tensors positionally, attributes as keywords; NCHW for conv and pool;
layouts [b, s, h, d] for attention and rotary embeddings, [in, out] for
linear weights; fp32 statistics in rms_norm and layer_norm; cross-entropy
means over the valid labels only. Where torch's function differs from
jnp's, the jnp semantics are written out: `chunk` splits as
array_split, `median` averages the two middle values, `argsort(
descending)` flips the stable ascending order, `one_hot` is fp32,
`interpolate` and `adaptive_avg_pool2d` apply jax.image.resize's weights
(antialiased), `max_pool2d(ceil_mode)` pads as the JAX function does. Two
tensors of different dtypes promote as jnp promotes them (`_promote`):
torch lets a 0-d tensor lose to an n-d one of the same kind (fp16 n-d
times fp32 0-d is fp16 in torch, fp32 in jnp). Outputs come back in
torch's dtypes; the dispatcher canonicalises them to the JAX package's
32-bit types.

Creation ops make their tensors on the expected place
(`core.place.expected_device`); rng ops take a torch.Generator as their
second argument and draw on its device.

The functions the models call directly (add, getitem, matmul, linear,
the norms, embedding, dropout, rotary_embedding, swiglu, gelu, tanh,
repeat_interleave, the attention family and the losses) cast their own
inputs under their JAX op name (`amp.state.cast_inputs`, the cast of the
JAX registry's dispatch); the dispatcher casts again, which changes
nothing. Outside auto_cast nothing is cast. `add` and `getitem` are the
JAX Tensor's `+` and indexing, which dispatch as registry ops and so are
cast under O2 too (an fp32 norm output plus an fp16 branch is fp16
there); the models' residual and embedding sums go through them.
`dropout` draws from an explicit torch.Generator where the JAX one takes
a jax.random key: the two streams differ.

`scaled_dot_product_attention` dispatches as the JAX function does, with
one difference on the card: where the JAX package quietly falls back to
its dense O(s^2) path, the port raises on CUDA tensors. With
FLAGS_use_flash_attention on, an attn_mask that broadcasts to
[b, 1|h, sq, sk] (or none) and shapes the flash kernels take, it runs
`ops.flash_attention` (the CUDA kernels on CUDA tensors, their plain
versions on CPU tensors); the kernels take any length, so the JAX
package's pad-to-128 branch has no counterpart. With the flag off (the
caller's explicit choice) it runs the dense path on either device.
`dropout_p` is ignored on every path, as it is in the JAX package. The
rest of the flash family lowers onto the same kernels as in JAX:
`flash_attn_unpadded` (cu_seqlens -> segment ids), `flash_attn`,
`flash_attn_qkvpacked`, `flash_attn_varlen_qkvpacked`,
`flashmask_attention` (row ranges and windows -> an additive mask) and
`sparse_attention` (CSR -> an additive mask and a block mask). No
function here calls a library attention.
"""

from __future__ import annotations

import builtins
import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.amp.state import cast_inputs
from paddle_tpu_torch.core.dtype import to_torch_dtype
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.utils.flags import flag

NEG_INF = -1e30
_DROPOUT_ITEM = ("attention dropout is not in the flash kernels: ROADMAP.md "
                 "'Still to port' item 19 (attention dropout); train with "
                 "dropout=0.0")

_py_sum, _py_min, _py_max, _py_abs, _py_round = (
    builtins.sum, builtins.min, builtins.max, builtins.abs, builtins.round)

# ============================================================ helpers


def _device():
    from paddle_tpu_torch.core.place import expected_device

    return expected_device()


def _dt(dtype):
    return to_torch_dtype(dtype)


def _axes(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    return tuple(int(a) for a in axis) if isinstance(axis, (list, tuple)) \
        else (int(axis),)


def _ints(seq):
    if isinstance(seq, torch.Tensor):
        seq = seq.tolist()
    if isinstance(seq, (list, tuple)):
        return tuple(int(s) for s in seq)
    return (int(seq),)


def _red(fn, x, axis, keepdim, **kw):
    """A reduction over ``axis`` (None: all), keepdim as jnp keeps it."""
    if axis is None:
        out = fn(x, **kw)
        return out.reshape((1,) * x.dim()) if keepdim else out
    return fn(x, dim=_axes(axis), keepdim=keepdim, **kw)


def _floating(x):
    """x as jnp's inexact ops take it: integers and bools in fp32."""
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _promote(x, y):
    """x and y in their common dtype as jnp promotes (no 0-d exception);
    python scalars stay weak."""
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) \
            and x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        return x.to(dt), y.to(dt)
    return x, y


def _t(value, like):
    """A python number as a 0-d tensor beside ``like`` (a fill, no host
    copy), in like's dtype."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.full((), value, dtype=like.dtype, device=like.device)


# ============================================================ element-wise math


def add(x, y):
    """x + y as the JAX Tensor's `+` dispatches it: the registry's "add"
    op, whose inputs AMP casts under O2 (fp32 with fp16 is then fp16, where
    torch's promotion would give fp32); outside O2 jnp's promotion. The
    models' residual and embedding sums go through it."""
    x, y = cast_inputs("add", x, y)
    x, y = _promote(x, y)
    return x + y


def getitem(x, idx):
    """x[idx] as the JAX Tensor's indexing dispatches it: the registry's
    "_getitem" op, whose input AMP casts under O2 (fp32 to the AMP
    dtype)."""
    (x,) = cast_inputs("_getitem", x)
    return x[idx]


def subtract(x, y):
    x, y = _promote(x, y)
    return x - y


def multiply(x, y):
    x, y = _promote(x, y)
    return x * y


def divide(x, y):
    x, y = _promote(x, y)
    return torch.true_divide(x, y)


def floor_divide(x, y):
    x, y = _promote(x, y)
    return torch.floor_divide(x, y)


def remainder(x, y):
    x, y = _promote(x, y)
    return torch.remainder(x, y)


def pow(x, y):  # noqa: A001
    x, y = _promote(x, y)
    return torch.pow(x, y)


def maximum(x, y):
    x, y = _promote(x, y)
    return torch.maximum(x, _t(y, x))


def minimum(x, y):
    x, y = _promote(x, y)
    return torch.minimum(x, _t(y, x))


def fmax(x, y):
    x, y = _promote(x, y)
    return torch.fmax(x, _t(y, x))


def fmin(x, y):
    x, y = _promote(x, y)
    return torch.fmin(x, _t(y, x))


def atan2(x, y):
    x, y = _promote(_floating(x), _floating(y))
    return torch.atan2(x, y)


def lerp(x, y, weight):
    x, y = _promote(x, y)
    return x + weight * (y - x)


def abs(x):  # noqa: A001
    return torch.abs(x)


def neg(x):
    return torch.neg(x)


def exp(x):
    return torch.exp(_floating(x))


def expm1(x):
    return torch.expm1(_floating(x))


def log(x):
    return torch.log(_floating(x))


def log2(x):
    return torch.log2(_floating(x))


def log10(x):
    return torch.log10(_floating(x))


def log1p(x):
    return torch.log1p(_floating(x))


def sqrt(x):
    return torch.sqrt(_floating(x))


def rsqrt(x):
    return torch.rsqrt(_floating(x))


def square(x):
    return torch.square(x)


def reciprocal(x):
    return torch.reciprocal(x)


def sin(x):
    return torch.sin(_floating(x))


def cos(x):
    return torch.cos(_floating(x))


def tan(x):
    return torch.tan(_floating(x))


def asin(x):
    return torch.asin(_floating(x))


def acos(x):
    return torch.acos(_floating(x))


def atan(x):
    return torch.atan(_floating(x))


def sinh(x):
    return torch.sinh(_floating(x))


def cosh(x):
    return torch.cosh(_floating(x))


def tanh(x):
    (x,) = cast_inputs("tanh", x)
    return torch.tanh(x)


def asinh(x):
    return torch.asinh(_floating(x))


def acosh(x):
    return torch.acosh(_floating(x))


def atanh(x):
    return torch.atanh(_floating(x))


def floor(x):
    return torch.floor(x)


def ceil(x):
    return torch.ceil(x)


def round(x):  # noqa: A001
    return torch.round(x)


def trunc(x):
    return torch.trunc(x)


def frac(x):
    return x - torch.trunc(x)


def sign(x):
    return torch.sign(x)


def erf(x):
    return torch.erf(_floating(x))


def erfinv(x):
    return torch.erfinv(_floating(x))


def digamma(x):
    return torch.digamma(_floating(x))


def lgamma(x):
    return torch.lgamma(_floating(x))


def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def clip(x, min=None, max=None):  # noqa: A002
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


def isnan(x):
    return torch.isnan(x)


def isinf(x):
    return torch.isinf(x)


def isfinite(x):
    return torch.isfinite(x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def addmm(input, x, y, beta=1.0, alpha=1.0):  # noqa: A002
    return beta * input + alpha * torch.matmul(x, y)


# ============================================================ comparison/logical


def equal(x, y):
    return torch.eq(x, y)


def not_equal(x, y):
    return torch.ne(x, y)


def greater_than(x, y):
    return torch.gt(x, y)


def greater_equal(x, y):
    return torch.ge(x, y)


def less_than(x, y):
    return torch.lt(x, y)


def less_equal(x, y):
    return torch.le(x, y)


def logical_and(x, y):
    return torch.logical_and(x, _t(y, x))


def logical_or(x, y):
    return torch.logical_or(x, _t(y, x))


def logical_xor(x, y):
    return torch.logical_xor(x, _t(y, x))


def logical_not(x):
    return torch.logical_not(x)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    x, y = _promote(x, _t(y, x))
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


# ============================================================ matmul / linalg


def matmul(x, y, transpose_x=False, transpose_y=False):
    """x @ y, either operand transposed over its last two axes first (the
    JAX `matmul` op; the tied heads of Llama and ERNIE call it)."""
    x, y = cast_inputs("matmul", x, y)
    x, y = _promote(x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def dot(x, y):
    x, y = _promote(x, y)
    return torch.sum(x * y, dim=-1)


def einsum(equation, *operands):
    return torch.einsum(equation, *operands)


def norm(x, p=2, axis=None, keepdim=False):
    if p == "fro" or p == 2:
        return torch.sqrt(_red(torch.sum, torch.square(x), axis, keepdim))
    if p == 1:
        return _red(torch.sum, torch.abs(x), axis, keepdim)
    if p == float("inf"):
        return _red(torch.amax, torch.abs(x), axis, keepdim)
    if p == float("-inf"):
        return _red(torch.amin, torch.abs(x), axis, keepdim)
    return torch.pow(_red(torch.sum, torch.pow(torch.abs(x), p), axis,
                          keepdim), 1.0 / p)


def t(x):
    return x.transpose(-1, -2) if x.dim() >= 2 else x


def outer(x, y):
    x, y = _promote(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


def bmm(x, y):
    return torch.matmul(x, y)


def mv(x, vec):
    return torch.matmul(x, vec)


def cholesky(x, upper=False):
    return torch.linalg.cholesky(x, upper=upper)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper, left=True,
                                         unitriangular=unitriangular)


def inverse(x):
    return torch.linalg.inv(x)


# ============================================================ reductions


def sum(x, axis=None, dtype=None, keepdim=False):  # noqa: A001
    kw = {} if dtype is None else {"dtype": _dt(dtype)}
    return _red(torch.sum, x, axis, keepdim, **kw)


def mean(x, axis=None, keepdim=False):
    return _red(torch.mean, _floating(x), axis, keepdim)


def max(x, axis=None, keepdim=False):  # noqa: A001
    return _red(torch.amax, x, axis, keepdim)


def min(x, axis=None, keepdim=False):  # noqa: A001
    return _red(torch.amin, x, axis, keepdim)


def prod(x, axis=None, keepdim=False, dtype=None):
    if dtype is not None:
        x = x.to(_dt(dtype))
    if axis is None:
        out = torch.prod(x)
        return out.reshape((1,) * x.dim()) if keepdim else out
    for a in sorted((a % x.dim() for a in _axes(axis)), reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim)
    return x


def std(x, axis=None, unbiased=True, keepdim=False):
    return _red(torch.std, _floating(x), axis, keepdim,
                correction=1 if unbiased else 0)


def var(x, axis=None, unbiased=True, keepdim=False):
    return _red(torch.var, _floating(x), axis, keepdim,
                correction=1 if unbiased else 0)


def logsumexp(x, axis=None, keepdim=False):
    x = _floating(x)
    if axis is None:
        out = torch.logsumexp(x.reshape(-1), dim=0)
        return out.reshape((1,) * x.dim()) if keepdim else out
    return torch.logsumexp(x, dim=_axes(axis), keepdim=keepdim)


def all(x, axis=None, keepdim=False):  # noqa: A001
    return _red(torch.all, x.bool(), axis, keepdim)


def any(x, axis=None, keepdim=False):  # noqa: A001
    return _red(torch.any, x.bool(), axis, keepdim)


def amax(x, axis=None, keepdim=False):
    return _red(torch.amax, x, axis, keepdim)


def amin(x, axis=None, keepdim=False):
    return _red(torch.amin, x, axis, keepdim)


def _arg(fn, x, axis, keepdim, dtype):
    if axis is None:
        out = fn(x.reshape(-1))
        out = out.reshape((1,) * x.dim()) if keepdim else out
    else:
        out = fn(x, dim=int(axis), keepdim=keepdim)
    return out.to(_dt(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def _int_acc(x, dtype):
    """jnp's cumulative / product accumulator: ints stay 32-bit (x64 off)."""
    if dtype is not None:
        return _dt(dtype)
    return torch.int32 if x.dtype in (torch.bool, torch.int8, torch.int16,
                                      torch.uint8) else None


def cumsum(x, axis=None, dtype=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=int(axis), dtype=_int_acc(x, dtype))


def cumprod(x, dim=None, dtype=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim=int(dim), dtype=_int_acc(x, dtype))


def median(x, axis=None, keepdim=False):
    """jnp.median: the mean of the two middle values at an even count."""
    return quantile(x, 0.5, axis=axis, keepdim=keepdim)


def nanmean(x, axis=None, keepdim=False):
    return _red(torch.nanmean, _floating(x), axis, keepdim)


def count_nonzero(x, axis=None, keepdim=False):
    out = torch.count_nonzero(x, dim=_axes(axis))
    if keepdim:
        axes = range(x.dim()) if axis is None else sorted(
            a % x.dim() for a in _axes(axis))
        for a in axes:
            out = out.unsqueeze(a)
    return out


# ============================================================ manipulation


def reshape(x, shape):
    return torch.reshape(x, _ints(shape))


def transpose(x, perm):
    return x.permute(_ints(perm))


def swapaxes(x, axis0, axis1):
    return torch.swapaxes(x, axis0, axis1)


def _common(xs):
    dt = xs[0].dtype
    for v in xs[1:]:
        dt = torch.promote_types(dt, v.dtype)
    return [v.to(dt) for v in xs]


def concat(xs, axis=0):
    return torch.cat(_common(list(xs)), dim=int(axis))


def stack(xs, axis=0):
    return torch.stack(_common(list(xs)), dim=int(axis))


def split(x, num_or_sections, axis=0):
    axis = int(axis)
    if isinstance(num_or_sections, int):
        n = x.shape[axis]
        if n % num_or_sections:
            raise ValueError(f"array split does not result in an equal "
                             f"division: {n} into {num_or_sections}")
        return tuple(torch.split(x, n // num_or_sections, dim=axis))
    sections = list(_ints(num_or_sections))
    # paddle allows one -1 section
    if -1 in sections:
        known = _py_sum(s for s in sections if s != -1)
        sections[sections.index(-1)] = x.shape[axis] - known
    return tuple(torch.split(x, sections, dim=axis))


def chunk(x, chunks, axis=0):
    """jnp.array_split: the first n % chunks pieces one longer."""
    return tuple(torch.tensor_split(x, int(chunks), dim=int(axis)))


def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    axes = _axes(axis)
    for a in axes:
        if x.shape[a] != 1:
            raise ValueError(f"cannot select an axis to squeeze out which "
                             f"has size not equal to one: axis {a} of "
                             f"shape {tuple(x.shape)}")
    return torch.squeeze(x, dim=axes)


def unsqueeze(x, axis):
    if isinstance(axis, (list, tuple, torch.Tensor)):
        for a in sorted(_ints(axis)):
            x = torch.unsqueeze(x, a)
        return x
    return torch.unsqueeze(x, int(axis))


def flatten(x, start_axis=0, stop_axis=-1):
    nd = x.dim()
    if nd == 0:
        return x.reshape((1,))
    s = start_axis % nd
    e = stop_axis % nd
    return torch.reshape(x, tuple(x.shape[:s]) + (-1,)
                         + tuple(x.shape[e + 1:]))


def tile(x, repeat_times):
    return torch.tile(x, _ints(repeat_times))


def expand(x, shape):
    shape = _ints(shape)
    shape = tuple(x.shape[i - (len(shape) - x.dim())] if s == -1 else s
                  for i, s in enumerate(shape))
    return x.expand(shape)


def broadcast_to(x, shape):
    return x.expand(_ints(shape))


def flip(x, axis):
    return torch.flip(x, _axes(axis) if axis is not None
                      else tuple(range(x.dim())))


def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x.reshape(-1), _ints(shifts)).reshape(x.shape)
    return torch.roll(x, _ints(shifts), _axes(axis))


def where(condition, x, y):
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        x, y = _promote(x, y)
    return torch.where(condition.bool(), x, y)


def _index(index):
    return index.long() if isinstance(index, torch.Tensor) else \
        torch.as_tensor(index).long()


def gather(x, index, axis=0):
    """jnp.take: out is x.shape[:axis] + index.shape + x.shape[axis+1:]."""
    axis = int(axis) % x.dim()
    index = _index(index).to(x.device)
    picked = torch.index_select(x, axis, index.reshape(-1))
    return picked.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                          + tuple(x.shape[axis + 1:]))


def gather_nd(x, index):
    index = _index(index)
    return x[tuple(index.movedim(-1, 0))]


def take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, _index(indices), dim=int(axis))


def put_along_axis(x, indices, values, axis, reduce="assign"):
    axis = int(axis)
    indices = _index(indices)
    if not isinstance(values, torch.Tensor):
        values = torch.full((), values, dtype=x.dtype, device=x.device)
    values = values.to(x.dtype).expand(indices.shape)
    if reduce == "assign":
        return x.scatter(axis, indices, values)
    if reduce == "add":
        return x.scatter_add(axis, indices, values)
    if reduce in ("multiply", "mul"):
        return x.scatter_reduce(axis, indices, values, "prod")
    raise ValueError(f"unsupported reduce {reduce}")


def index_select(x, index, axis=0):
    return gather(x, index, axis)


def index_sample(x, index):
    return torch.take_along_dim(x, _index(index), dim=1)


def masked_select(x, mask):
    return x[mask.bool()]


def masked_fill(x, mask, value):
    if isinstance(value, torch.Tensor):
        x, value = _promote(x, value)
        return torch.where(mask.bool(), value, x)
    return torch.where(mask.bool(), torch.full((), value, device=x.device,
                                               dtype=torch.result_type(
                                                   x, value)), x)


def scatter(x, index, updates, overwrite=True):
    updates = updates.to(x.dtype)
    return x.index_put((_index(index),), updates, accumulate=not overwrite)


def scatter_nd_add(x, index, updates):
    index = _index(index)
    return x.index_put(tuple(index.movedim(-1, 0)), updates.to(x.dtype),
                       accumulate=True)


def _pad_picks(n, lo, hi, mode):
    """Source positions of a size-n axis padded by (lo, hi) in a
    non-constant mode (numpy's reflect, edge and wrap)."""
    pos = np.arange(-lo, n + hi)
    if mode == "replicate":
        return np.clip(pos, 0, n - 1)
    if mode == "circular":
        return np.mod(pos, n)
    period = 2 * (n - 1)
    pos = np.mod(np.abs(pos), period) if period else np.zeros_like(pos)
    return np.where(pos >= n, period - pos, pos)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    pad = _ints(pad)
    if len(pad) == 2 * x.dim():
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.dim())]
    else:
        # paddle nn.functional.pad pads trailing spatial dims, given as
        # [l, r, (t, b, ...)] for the last len(pad)//2 dims (NCHW)
        n = len(pad) // 2
        width = [(0, 0)] * (x.dim() - n)
        for i in range(n):
            width.append((pad[2 * (n - 1 - i)], pad[2 * (n - 1 - i) + 1]))
    if mode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return F.pad(x, flat, mode="constant", value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise KeyError(mode)
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            picks = torch.as_tensor(_pad_picks(x.shape[d], lo, hi, mode),
                                    device=x.device)
            x = torch.index_select(x, d, picks)
    return x


def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def diag(x, offset=0):
    return torch.diag(x, offset)


def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


def repeat_interleave(x, repeats, axis=None):
    (x,) = cast_inputs("repeat_interleave", x)
    return torch.repeat_interleave(x, repeats, dim=axis)


def unbind(x, axis=0):
    return tuple(torch.unbind(x, dim=int(axis)))


def unstack(x, axis=0, num=None):
    return tuple(torch.unbind(x, dim=int(axis)))


def one_hot(x, num_classes):
    """jax.nn.one_hot: fp32, all zeros for an index out of range."""
    classes = torch.arange(int(num_classes), device=x.device)
    return (x.long()[..., None] == classes).float()


def kron(x, y):
    x, y = _promote(x, y)
    return torch.kron(x, y)


def cross(x, y, axis=-1):
    x, y = _promote(x, y)
    return torch.linalg.cross(x, y, dim=int(axis))


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    values = values.to(sorted_sequence.dtype) if isinstance(
        values, torch.Tensor) else values
    out = torch.searchsorted(sorted_sequence.contiguous(), values,
                             right=right)
    return out.int() if out_int32 else out


def bincount(x, weights=None, minlength=0):
    out = torch.bincount(x.reshape(-1).long(), weights=weights,
                         minlength=int(minlength))
    return out if weights is None or out.dtype != torch.float64 \
        else out.to(weights.dtype)


def cast(x, dtype):
    return x.to(_dt(dtype))


# ============================================================ sort / search


def topk(x, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    vals, idx = torch.topk(x, int(k), dim=int(axis), largest=largest,
                           sorted=True)
    return vals, idx


def sort(x, axis=-1, descending=False):
    out = torch.sort(x, dim=int(axis), stable=True).values
    return torch.flip(out, (int(axis),)) if descending else out


def argsort(x, axis=-1, descending=False):
    """jnp.argsort, then a flip for descending (ties: the later index
    first, as the JAX function gives)."""
    out = torch.argsort(x, dim=int(axis), stable=True)
    return torch.flip(out, (int(axis),)) if descending else out


def nonzero(x):
    return torch.nonzero(x)


def unique(x, return_index=False, return_inverse=False, return_counts=False):
    """jnp.unique over the flattened input: the sorted values, then the
    index of each one's first occurrence, the inverse (shaped as x) and
    the counts, as asked."""
    flat = x.reshape(-1)
    vals, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True)
    out = [vals]
    if return_index:
        pos = torch.arange(flat.numel(), device=x.device)
        first = torch.full(vals.shape, flat.numel(), dtype=torch.long,
                           device=x.device)
        out.append(first.scatter_reduce(0, inv, pos, "amin"))
    if return_inverse:
        out.append(inv.reshape(x.shape))
    if return_counts:
        out.append(counts)
    return tuple(out) if len(out) > 1 else vals


# ============================================================ activations


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def gelu(x, approximate=False):
    """jax.nn.gelu: the tanh form with ``approximate``, else the erf form."""
    (x,) = cast_inputs("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x):
    return torch.sigmoid(x)


def silu(x):
    return F.silu(x)


def swish(x):
    return F.silu(x)


def mish(x):
    return F.mish(x)


def hardswish(x):
    return F.hardswish(x)


def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardtanh(x, min=-1.0, max=1.0):  # noqa: A002
    return torch.clamp(x, min, max)


def leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0):
    return F.elu(x, alpha)


def selu(x):
    return F.selu(x)


def celu(x, alpha=1.0):
    return F.celu(x, alpha)


def softplus(x, beta=1.0, threshold=20.0):
    return torch.where(beta * x > threshold, x,
                       (1.0 / beta) * torch.log1p(torch.exp(beta * x)))


def softsign(x):
    return F.softsign(x)


def softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def tanhshrink(x):
    return x - torch.tanh(x)


def prelu(x, weight):
    return torch.where(x >= 0, x, weight * x)


def softmax(x, axis=-1):
    return torch.softmax(_floating(x), dim=int(axis))


def log_softmax(x, axis=-1):
    return torch.log_softmax(_floating(x), dim=int(axis))


def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=int(axis))
    return a * torch.sigmoid(b)


def swiglu(x, y=None):
    """silu(x) * y; with y None, x is split in two halves along its last
    axis (the fused swiglu op)."""
    x, y = cast_inputs("swiglu", x, y)
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y


# ============================================================ nn core ops


def linear(x, weight, bias=None):
    """x @ weight (+ bias) with weight in the [in, out] layout."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight, padding_idx=None):
    (weight,) = cast_inputs("embedding", weight)
    out = F.embedding(x.long(), weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return out


def dropout(x, generator=None, p=0.5, training=True,
            mode="upscale_in_train"):
    """Paddle's dropout: in training each element is kept with probability
    1 - p (a uniform draw from ``generator`` below 1 - p, as
    jax.random.bernoulli draws) and scaled by 1 / (1 - p) in
    upscale_in_train; in inference x as it is, or x * (1 - p) in
    downscale_in_infer."""
    (x,) = cast_inputs("dropout", x)
    if p == 0.0:
        return x
    keep = 1.0 - p
    if not training:
        if mode == "downscale_in_infer":
            return (x * keep).to(x.dtype)
        return x
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    if mode == "upscale_in_train":
        x = x / keep
    return torch.where(kept, x, torch.zeros_like(x)).to(x.dtype)


def layer_norm(x, weight=None, bias=None, epsilon=1e-5, begin_norm_axis=-1):
    """Normalize over the trailing dims from begin_norm_axis with fp32
    statistics (mean, biased variance), cast back to x's dtype, then times
    weight plus bias, both shaped as those dims."""
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    if begin_norm_axis < 0:
        begin_norm_axis += x.dim()
    shape = tuple(x.shape[begin_norm_axis:])
    out = F.layer_norm(x.float(), shape, eps=epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def rms_norm(x, weight=None, epsilon=1e-6):
    """x / rms(x) with the statistics in fp32, cast back to x's dtype, then
    times weight."""
    x, weight = cast_inputs("rms_norm", x, weight)
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW"):
    """Returns (out, new_mean, new_var); the running variance takes the
    biased batch variance, as the JAX function (and the reference) do."""
    if data_format == "NCHW":
        axes = (0,) + tuple(range(2, x.dim()))
        shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    else:
        axes = tuple(range(x.dim() - 1))
        shape = [1] * (x.dim() - 1) + [x.shape[-1]]
    if training:
        xf = x.float()
        mean_ = torch.mean(xf, dim=axes)
        var_ = torch.var(xf, dim=axes, correction=0)
        new_mean = momentum * running_mean + (1 - momentum) * mean_
        new_var = momentum * running_var + (1 - momentum) * var_
    else:
        mean_, var_ = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    out = (x - mean_.reshape(shape)) * torch.rsqrt(
        var_.reshape(shape).float() + epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.to(x.dtype), new_mean, new_var


def group_norm(x, weight=None, bias=None, epsilon=1e-5, groups=1,
               data_format="NCHW"):
    if data_format != "NCHW":
        x = torch.movedim(x, -1, 1)
    n, c = x.shape[0], x.shape[1]
    g = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, g.dim()))
    mean_ = torch.mean(g, dim=axes, keepdim=True)
    var_ = torch.var(g, dim=axes, keepdim=True, correction=0)
    out = ((g - mean_) * torch.rsqrt(var_ + epsilon)).reshape(x.shape)
    shape = [1, c] + [1] * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    if data_format != "NCHW":
        out = torch.movedim(out, 1, -1)
    return out


def instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    axes = tuple(range(2, x.dim()))
    mean_ = torch.mean(x, dim=axes, keepdim=True)
    var_ = torch.var(x, dim=axes, keepdim=True, correction=0)
    out = (x - mean_) * torch.rsqrt(var_ + epsilon)
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


# ============================================================ conv / pool


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


def _same_pads(size, k, s, d):
    """XLA's SAME padding of one spatial axis: (low, high)."""
    out = -(-size // s)
    total = _py_max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """lax.conv_general_dilated's arithmetic: weight OIHW, activations
    NCHW or NHWC, padding an int, a pair, four numbers, "SAME" or
    "VALID"."""
    x, weight, bias = cast_inputs("conv2d", x, weight, bias)
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d: unsupported data_format {data_format!r}")
    stride = _pair(stride)
    dilation = _pair(dilation)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    kh, kw = weight.shape[2], weight.shape[3]
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = [(0, 0), (0, 0)]
        else:
            pads = [_same_pads(x.shape[2], kh, stride[0], dilation[0]),
                    _same_pads(x.shape[3], kw, stride[1], dilation[1])]
    else:
        p = _pair(padding)
        pads = ([(p[0], p[1]), (p[2], p[3])] if len(p) == 4
                else [(p[0], p[0]), (p[1], p[1])])
    x = F.pad(x, [pads[1][0], pads[1][1], pads[0][0], pads[0][1]])
    out = F.conv2d(x, weight, None, stride, 0, dilation, groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    if data_format == "NHWC":
        out = out.permute(0, 2, 3, 1)
    return out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    s = stride if isinstance(stride, int) else stride[0]
    d = dilation if isinstance(dilation, int) else dilation[0]
    p = padding if isinstance(padding, int) else padding[0]
    out = conv2d(x[:, :, None, :], weight[:, :, None, :], bias,
                 stride=(1, s), padding=(0, p), dilation=(1, d),
                 groups=groups)
    return out[:, :, 0, :]


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1):
    """weight [in, out / groups, kh, kw], as paddle (and torch) store a
    transposed conv's filter."""
    x, weight, bias = cast_inputs("conv2d_transpose", x, weight, bias)
    out = F.conv_transpose2d(x, weight, None, _pair(stride), _pair(padding),
                             _pair(output_padding), groups, _pair(dilation))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def _pool_pads(x, k, s, p, ceil_mode):
    """Low/high spatial padding; ceil_mode adds extra high padding so the
    last partial window is included (the JAX function's rule)."""
    extra = [0, 0]
    if ceil_mode:
        for i, dim in enumerate((2, 3)):
            size = x.shape[dim] + 2 * p[i]
            rem = (size - k[i]) % s[i]
            if rem:
                extra[i] = s[i] - rem
    return [p[1], p[1] + extra[1], p[0], p[0] + extra[0]]


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    p = _pair(padding)
    fill = float("-inf") if x.is_floating_point() else \
        torch.iinfo(x.dtype).min
    xp = F.pad(x, _pool_pads(x, k, s, p, ceil_mode), value=fill)
    return F.max_pool2d(xp, k, s)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCHW"):
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    p = _pair(padding)
    pads = _pool_pads(x, k, s, p, ceil_mode)
    summed = F.avg_pool2d(F.pad(x, pads), k, s) * (k[0] * k[1])
    if exclusive and (p[0] or p[1] or ceil_mode):
        ones = F.pad(torch.ones_like(x[:1, :1]), pads)
        counts = F.avg_pool2d(ones, k, s) * (k[0] * k[1])
        return summed / counts
    return summed / (k[0] * k[1])


def _resize_weights(m, n, kernel):
    """jax.image.resize's weight matrix [m, n] of one axis (antialiased,
    scale n / m, no translation), in fp32."""
    inv_scale = m / n
    kernel_scale = _py_max(inv_scale, 1.0)
    sample = (np.arange(n, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(m, dtype=np.float64)[:, None]) \
        / kernel_scale
    if kernel == "linear":
        w = np.maximum(0, 1 - np.abs(x))
    else:   # Keys cubic, a = -0.5
        w = ((1.5 * x - 2.5) * x) * x + 1.0
        w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
        w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _resize(x, size, method):
    """jax.image.resize of the two trailing axes of an NCHW tensor."""
    out = x if x.is_floating_point() else x.float()
    for d, n in ((2, size[0]), (3, size[1])):
        m = out.shape[d]
        if m == n:
            continue
        if method == "nearest":
            picks = np.floor(((np.arange(n, dtype=np.float32) + 0.5)
                              * np.float32(m) / np.float32(n))
                             .astype(np.float32)).astype(np.int64)
            out = torch.index_select(out, d, torch.as_tensor(
                picks, device=x.device))
            continue
        w = torch.as_tensor(_resize_weights(m, n, method),
                            device=x.device).to(out.dtype)
        out = torch.movedim(torch.tensordot(torch.movedim(out, d, -1), w,
                                            dims=1), -1, d)
    return out if method != "nearest" else out.to(x.dtype)


def adaptive_avg_pool2d(x, output_size):
    oh, ow = _pair(output_size)
    n, c, h, w = x.shape
    if h % oh == 0 and w % ow == 0:
        return torch.mean(x.reshape(n, c, oh, h // oh, ow, w // ow),
                          dim=(3, 5))
    return _resize(x, (oh, ow), "linear")      # as JAX: resize, approx


def adaptive_max_pool2d(x, output_size):
    oh, ow = _pair(output_size)
    n, c, h, w = x.shape
    assert h % oh == 0 and w % ow == 0, \
        "adaptive_max_pool2d needs divisible sizes"
    return torch.amax(x.reshape(n, c, oh, h // oh, ow, w // ow), dim=(3, 5))


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """jax.image.resize (align_corners is not read, as in JAX)."""
    n, c, h, w = x.shape
    if size is None:
        sf = _pair(scale_factor)
        size = (int(h * sf[0]), int(w * sf[1]))
    method = {"nearest": "nearest", "bilinear": "linear",
              "bicubic": "cubic"}[mode]
    return _resize(x, _ints(size), method)


def pixel_shuffle(x, upscale_factor):
    n, c, h, w = x.shape
    r = upscale_factor
    x = x.reshape(n, c // (r * r), r, r, h, w)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    return F.unfold(x, _pair(kernel_sizes), _pair(dilations), _pair(paddings),
                    _pair(strides))


# ============================================================ losses


def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100):
    """Per-example loss -log_softmax(logits)[label], 0 where label ==
    ignore_index; the label may carry a trailing axis of 1. With
    soft_label, -sum(label * log_softmax) over ``axis``, kept."""
    (logits,) = cast_inputs("softmax_with_cross_entropy", logits)
    return _softmax_with_cross_entropy(logits, label, soft_label, axis,
                                       ignore_index)


def _softmax_with_cross_entropy(logits, label, soft_label, axis,
                                ignore_index):
    axis = axis % logits.dim()
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        return -torch.sum(label * logp, dim=axis, keepdim=True)
    lab = label.squeeze(axis) if label.dim() == logits.dim() else label
    lab = lab.long()
    picked = torch.gather(logp, axis, lab.clamp_min(0).unsqueeze(axis))
    loss = -picked
    return torch.where((lab == ignore_index).unsqueeze(axis),
                       torch.zeros_like(loss), loss)


def cross_entropy(logits, label, soft_label=False, axis=-1,
                  ignore_index=-100, reduction="mean", weight=None,
                  label_smoothing=0.0):
    """Cross-entropy (hard or soft labels, class weights, label
    smoothing); the mean divides by the summed weights of the labels that
    are not ignore_index."""
    (logits,) = cast_inputs("cross_entropy", logits)
    ax = axis % logits.dim()
    num_classes = logits.shape[ax]
    if label_smoothing > 0.0 and not soft_label:
        onehot = one_hot(label, num_classes).to(logits.dtype)
        soft = onehot * (1 - label_smoothing) + label_smoothing / num_classes
        loss = _softmax_with_cross_entropy(logits, soft, True, axis,
                                           ignore_index)
        valid = torch.ones_like(loss)
    else:
        loss = _softmax_with_cross_entropy(logits, label, soft_label, axis,
                                           ignore_index)
        if soft_label:
            valid = torch.ones_like(loss)
        else:
            lab = label.squeeze(ax) if label.dim() == logits.dim() \
                else label
            valid = (lab != ignore_index).to(logits.dtype).unsqueeze(ax)
    if weight is not None and not soft_label:
        lab = label if label.dim() < logits.dim() else label.squeeze(ax)
        w = weight[lab.long().clamp_min(0)].unsqueeze(ax)
        loss = loss * w
        valid = valid * w
    if reduction == "mean":
        return torch.sum(loss) / torch.clamp_min(torch.sum(valid), 1e-8)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


def nll_loss(log_prob, label, weight=None, ignore_index=-100,
             reduction="mean"):
    lab = label.long()
    picked = -torch.gather(log_prob, -1, lab.clamp_min(0)[..., None])[..., 0]
    valid = (lab != ignore_index).to(log_prob.dtype)
    w = weight[lab.clamp_min(0)] * valid if weight is not None else valid
    picked = picked * w
    if reduction == "mean":
        return torch.sum(picked) / torch.clamp_min(torch.sum(w), 1e-8)
    if reduction == "sum":
        return torch.sum(picked)
    return picked


def mse_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce_loss(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce_loss(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):  # noqa: A002
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce_loss(loss, reduction)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(input + eps)
             + (1 - label) * torch.log(1 - input + eps))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    max_val = torch.clamp(-logit, min=0)
    soft = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        loss = (1 - label) * logit + log_w * (soft + max_val)
    else:
        loss = (1 - label) * logit + max_val + soft
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean"):  # noqa: A002
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    return _reduce_loss(loss, reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot_ = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    n2 = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot_ / torch.clamp(n1 * n2, min=eps)


# ============================================================ attention


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rotary_embedding(q, k, cos, sin, position_ids=None):
    """Rotate-half RoPE. q, k: [b, s, h, d]; cos, sin: [s, d] rows for
    positions 0..s-1, or, with integer ``position_ids`` [b, s], the table
    rows those ids name (the JAX `take`). The tables stay fp32 unless the
    AMP state casts them (O2), so q * cos promotes to fp32 and the result
    is cast back to q's dtype."""
    q, k, cos, sin = cast_inputs("rotary_embedding", q, k, cos, sin)
    if position_ids is not None:
        ids = torch.as_tensor(position_ids, device=cos.device).long()
        cos = cos[ids][:, :, None, :]
        sin = sin[ids][:, :, None, :]
    else:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    q_out = q * cos + _rotate_half(q) * sin
    k_out = k * cos + _rotate_half(k) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def _dense_attention(q, k, v, attn_mask, is_causal, scale):
    """The dense path: [b, h, sq, sk] scores, softmax probabilities in q's
    dtype, and rows with no visible key set to 0 (the flash kernels'
    masked-row semantics)."""
    sq, sk = q.shape[1], k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores,
                                 torch.full_like(scores, NEG_INF))
        else:
            scores = scores + attn_mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if is_causal or attn_mask is not None:
        row_live = (scores > NEG_INF * 0.5).any(dim=-1, keepdim=True)
        probs = torch.where(row_live, probs, torch.zeros_like(probs))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _mask_broadcasts(attn_mask, b, h, sq, sk) -> bool:
    """The JAX function's shape-only classification of an attn_mask the
    kernels take: rank 4, broadcastable to [b, 1|h, sq, sk]."""
    ms = tuple(attn_mask.shape)
    return (len(ms) == 4 and ms[0] in (1, b) and ms[1] in (1, h)
            and ms[2] in (1, sq) and ms[3] in (1, sk))


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, scale=None, *,
                                 cast_mask=True):
    """Attention over [b, s, h, d] operands (paddle's flash-attn layout).
    See the module docstring for the dispatch. Under AMP q, k, v and a
    floating attn_mask are cast as the op's inputs; ``cast_mask=False``
    leaves the mask as it is, as the JAX registry leaves a mask passed as
    a plain array and not a Tensor (ERNIE's additive key mask: it reaches
    the kernels in fp32 at every AMP level)."""
    q, k, v = cast_inputs("scaled_dot_product_attention", q, k, v)
    if cast_mask:
        (attn_mask,) = cast_inputs("scaled_dot_product_attention",
                                   attn_mask)
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if flag("FLAGS_use_flash_attention"):
        mask_ok = attn_mask is None or _mask_broadcasts(attn_mask, b, h, sq,
                                                        sk)
        if mask_ok and fa.flash_attention_ok(q, k, v):
            return fa.flash_attention(q, k, v, causal=is_causal, scale=scale,
                                      mask=attn_mask)
        if fa.on_card(q):
            if not mask_ok:
                raise ValueError(
                    f"scaled_dot_product_attention: the masked flash "
                    f"kernels (K3-m) take an attn_mask broadcastable to "
                    f"[b, 1|h, sq, sk] = [{b}, 1|{h}, {sq}, {sk}], got "
                    f"{tuple(attn_mask.shape)}; set_flags("
                    "{'FLAGS_use_flash_attention': False}) asks for the "
                    "dense path")
            raise ValueError(
                f"scaled_dot_product_attention: the flash kernels do not "
                f"take q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                f"{tuple(v.shape)} (head dim % 8 == 0 and <= 256, matching "
                "batch and heads); set_flags({'FLAGS_use_flash_attention': "
                "False}) asks for the dense path")
    return _dense_attention(q, k, v, attn_mask, is_causal, scale)


def flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False):
    """Varlen (packed) attention: q, k, v [total, h, d] hold several
    sequences one after another, cu_seqlens_* int [n + 1] their
    boundaries. The boundaries become per-token segment ids
    (searchsorted, side right) and the kernels attend only within a
    segment; with `causal`, q and k must share a packing. No padding: the
    kernels take any length."""
    q, k, v = cast_inputs("flash_attn_unpadded", q, k, v)
    tq, _, d = q.shape
    tk = k.shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if dropout:
        raise NotImplementedError(f"flash_attn_unpadded: {_DROPOUT_ITEM}")
    if causal and tq != tk:
        raise ValueError(
            "flash_attn_unpadded(causal=True) requires q and k to share a "
            f"packing (got {tq} vs {tk} total tokens): global causal over "
            "mismatched packings is not per-sequence causal")

    def segments(cu, n):
        cu = torch.as_tensor(cu, device=q.device).long()
        tokens = torch.arange(n, device=q.device)
        return torch.searchsorted(cu, tokens, right=True).int()[None]

    out = fa.flash_attention(
        q[None], k[None], v[None], causal=causal, scale=scale,
        segment_ids=(segments(cu_seqlens_q, tq), segments(cu_seqlens_k, tk)))
    return out[0]


def flash_attn(q, k, v, dropout=0.0, causal=False):
    """The base dense form: scaled_dot_product_attention's dispatch."""
    return scaled_dot_product_attention(q, k, v, dropout_p=dropout,
                                        is_causal=causal)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False):
    """Packed [b, s, 3, h, d] form."""
    return flash_attn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                      dropout=dropout, causal=causal)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q=None, max_seqlen_k=None,
                                scale=None, dropout=0.0, causal=False):
    """Packed varlen [total, 3, h, d] form over flash_attn_unpadded."""
    return flash_attn_unpadded(
        qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens_q, cu_seqlens_k,
        max_seqlen_q=max_seqlen_q, max_seqlen_k=max_seqlen_k, scale=scale,
        dropout=dropout, causal=causal)


def flashmask_attention(q, k, v, startend_row_indices=None, dropout=0.0,
                        causal=False, window_size=None):
    """FlashMask column-sparse masks: startend_row_indices int [b, 1|h, sk,
    {1, 2, 4}] gives each key column its masked row ranges (LTS; LTS, LTE;
    LTS, UTE; LTS, LTE, UTS, UTE), and window_size a sliding window. They
    expand to an additive NEG_INF mask [b, 1|h, sq, sk] that the kernels
    read tile by tile, as in the JAX package."""
    q, k, v = cast_inputs("flashmask_attention", q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    if dropout:
        raise NotImplementedError(f"flashmask_attention: {_DROPOUT_ITEM}")
    if startend_row_indices is None and window_size is None:
        return fa.flash_attention(q, k, v, causal=causal, scale=scale)
    i = torch.arange(sq, device=q.device)[None, None, :, None]   # row
    j = torch.arange(sk, device=q.device)[None, None, None, :]   # column
    masked = torch.zeros((1, 1, sq, sk), dtype=torch.bool, device=q.device)
    if startend_row_indices is not None:
        idx = torch.as_tensor(startend_row_indices, device=q.device).long()
        n = idx.shape[-1]

        def col(c):                                  # [b, kh, 1, sk]
            return idx[..., c][:, :, None, :]

        if causal:
            lts = col(0)
            lte = col(1) if n >= 2 else torch.full_like(lts, sq)
            masked = (i >= lts) & (i < lte)
        elif n == 2:
            lts, ute = col(0), col(1)
            masked = ((i > j) & (i >= lts)) | ((i < j) & (i < ute))
        elif n == 4:
            lts, lte, uts, ute = col(0), col(1), col(2), col(3)
            masked = (((i > j) & (i >= lts) & (i < lte))
                      | ((i < j) & (i >= uts) & (i < ute)))
        else:
            raise ValueError(f"startend_row_indices last dim {n} invalid "
                             f"for causal={causal}")
    if window_size is not None:
        w = ((window_size, window_size) if isinstance(window_size, int)
             else tuple(window_size))
        outside = (j < i - w[0]) if causal else ((j < i - w[0])
                                                | (j > i + w[1]))
        masked = masked | outside
    mask = torch.zeros(masked.shape, dtype=torch.float32,
                       device=q.device).masked_fill_(masked, NEG_INF)
    return fa.flash_attention(q, k, v, causal=causal, scale=scale, mask=mask)


def sparse_attention(q, k, v, offset, columns, key_padding_mask=None,
                     attn_mask=None):
    """CSR-pattern sparse attention over [b, h, M, d] operands: offset
    [b, h, M + 1] and columns [b, h, nnz] name each row's allowed keys.
    The pattern (with key_padding_mask [b, M], 1 = keep, and an additive or
    bool attn_mask composed in) becomes an additive NEG_INF mask read tile
    by tile and a block mask at the JAX kernel's 128-blocks (the whole
    length when M % 128 != 0), so dead blocks are skipped."""
    q, k, v, key_padding_mask, attn_mask = cast_inputs(
        "sparse_attention", q, k, v, key_padding_mask, attn_mask)
    b, h, M, _ = q.shape
    dev = q.device
    flat_off = torch.as_tensor(offset, device=dev).long().reshape(b * h,
                                                                 M + 1)
    flat_col = torch.as_tensor(columns, device=dev).long().reshape(b * h, -1)
    nnz = flat_col.shape[1]
    pos = torch.arange(nnz, device=dev).expand(b * h, nnz).contiguous()
    # the row of each CSR entry: the last r with offset[r] <= entry; the
    # entries past offset[-1] are padding and keep nothing
    rows = torch.searchsorted(flat_off, pos, right=True) - 1
    valid = pos < flat_off[:, -1:]
    bh = torch.arange(b * h, device=dev)[:, None].expand(b * h, nnz)
    keep = torch.zeros(b * h, M, M, dtype=torch.bool, device=dev)
    keep[bh[valid], rows[valid], flat_col[valid]] = True
    keep = keep.reshape(b, h, M, M)
    if key_padding_mask is not None:
        kpm = torch.as_tensor(key_padding_mask, device=dev)
        if kpm.dtype != torch.bool:
            kpm = kpm > 0
        keep = keep & kpm[:, None, None, :]
    mask = torch.zeros(keep.shape, dtype=torch.float32,
                       device=dev).masked_fill_(~keep, NEG_INF)
    if attn_mask is not None:
        am = torch.as_tensor(attn_mask, device=dev)
        if am.dtype == torch.bool:
            am = torch.zeros(am.shape, dtype=torch.float32,
                             device=dev).masked_fill_(~am, NEG_INF)
        mask = mask + am.float()
    keep = keep & (mask > NEG_INF * 0.5)
    block = fa.JAX_BLOCK if M % fa.JAX_BLOCK == 0 else M
    nb = M // block
    block_mask = keep.reshape(b * h, nb, block, nb, block).any(4).any(2) \
        .any(0).int()
    out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=False, mask=mask,
                             block_mask=block_mask)
    return out.transpose(1, 2)


# ============================================================ statistics+


def histogram(x, bins=100, min=0, max=0):  # noqa: A002
    """min == max == 0 means the data's range (paddle semantics)."""
    flat = x.reshape(-1)
    if min == 0 and max == 0:
        lo, hi = torch.amin(flat), torch.amax(flat)
    else:
        lo = torch.full((), min, dtype=torch.float32, device=x.device)
        hi = torch.full((), max, dtype=torch.float32, device=x.device)
    lo, hi = lo.float(), hi.float()
    edges = lo + (hi - lo) * torch.linspace(0, 1, bins + 1, device=x.device)
    edges[-1] = hi
    fx = flat.float()
    idx = torch.clamp(torch.searchsorted(edges, fx, right=True) - 1, 0,
                      bins - 1)
    inside = ((fx >= lo) & (fx <= hi)).int()
    return torch.zeros(bins, dtype=torch.int32,
                       device=x.device).index_add(0, idx, inside)


def _quantile(fn, x, q, axis, keepdim):
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = fn(x.reshape(-1), qt, dim=0)
        if keepdim:
            out = out.reshape(tuple(qt.shape) + (1,) * x.dim())
        return out
    axes = _axes(axis)
    if len(axes) == 1:
        return fn(x, qt, dim=axes[0], keepdim=keepdim)
    axes = tuple(a % x.dim() for a in axes)
    rest = [d for d in range(x.dim()) if d not in axes]
    moved = x.permute(rest + list(axes)).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = fn(moved, qt, dim=-1)
    if keepdim:
        for a in sorted(axes):
            out = out.unsqueeze(a + qt.dim())
    return out


def quantile(x, q, axis=None, keepdim=False):
    return _quantile(torch.quantile, _floating(x), q, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False):
    return _quantile(torch.nanquantile, _floating(x), q, axis, keepdim)


def nansum(x, axis=None, keepdim=False):
    return _red(torch.nansum, x, axis, keepdim)


def kthvalue(x, k, axis=None, keepdim=False):
    """One stable sort: the k-th smallest value and its index."""
    axis = -1 if axis is None else int(axis)
    idxs = torch.argsort(x, dim=axis, stable=True)
    vals = torch.take_along_dim(x, idxs, dim=axis)
    taken = vals.select(axis, k - 1)
    itaken = idxs.select(axis, k - 1)
    if keepdim:
        taken, itaken = taken.unsqueeze(axis), itaken.unsqueeze(axis)
    return taken, itaken


def mode(x, axis=-1, keepdim=False):
    """(values, indices) as paddle.mode: the most frequent value (the
    smallest among ties) and the LAST index where it sits."""
    moved = torch.movedim(x, axis, -1)
    n = moved.shape[-1]
    flat = moved.reshape(-1, n)
    counts = (flat[:, :, None] == flat[:, None, :]).sum(-1)
    best = counts.amax(-1, keepdim=True)
    big = torch.full_like(flat, float("inf")) if flat.is_floating_point() \
        else torch.full_like(flat, torch.iinfo(flat.dtype).max)
    winner = torch.where(counts == best, flat, big).amin(-1)
    pos = torch.arange(n, device=x.device).expand_as(flat)
    hit = flat == winner[:, None]
    last = torch.where(hit, pos, torch.full_like(pos, -1)).amax(-1)
    # the value through a gather at its first place (where the JAX
    # function's sort-based unique sends the gradient)
    first = torch.where(hit, pos, torch.full_like(pos, n)).amin(-1)
    out_v = torch.gather(flat, 1, first[:, None])[:, 0]
    out_v = out_v.reshape(moved.shape[:-1])
    out_i = last.reshape(moved.shape[:-1])
    if keepdim:
        out_v, out_i = out_v.unsqueeze(axis), out_i.unsqueeze(axis)
    return out_v, out_i


def diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


def logcumsumexp(x, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, dim=int(axis))


def trapezoid(y, x=None, dx=None, axis=-1):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def heaviside(x, y):
    x, y = _promote(x, _t(y, x))
    return torch.heaviside(x, y)


def gcd(x, y):
    x, y = _promote(x, y)
    return torch.gcd(x, y)


def lcm(x, y):
    x, y = _promote(x, y)
    return torch.lcm(x, y)


def deg2rad(x):
    return torch.deg2rad(_floating(x))


def rad2deg(x):
    return torch.rad2deg(_floating(x))


def angle(x):
    return torch.angle(_floating(x))


def conj(x):
    return torch.conj(x).resolve_conj() if x.is_complex() else x


def real(x):
    return torch.real(x) if x.is_complex() else x


def imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, _ints(axes))


def vander(x, n=None, increasing=False):
    out = torch.linalg.vander(x, N=n)
    return out if increasing else torch.flip(out, (-1,))


def renorm(x, p, axis, max_norm):
    dims = [d for d in range(x.dim()) if d != axis]
    norms = torch.sum(torch.abs(x) ** p, dim=dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


# the round-2 ops: impl_extra's names join this namespace so the registry
# finds them here, as the JAX impl's star import does
from paddle_tpu_torch.ops.impl_extra import *  # noqa: F401,F403,E402
