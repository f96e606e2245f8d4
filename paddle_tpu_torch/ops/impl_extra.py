"""Op implementations, batch 2: the round-2 block of `ops.yaml`.

Counterpart of paddle_tpu/ops/impl_extra.py. Its first eight sections
are ported (linalg family, creation, random, bitwise, unary extras,
losses, manipulation, reductions / checks: 109 ops), with the JAX
semantics (phi's, not torch's: lu pivots are 1-based, huber_loss returns
the residual too, lu_unpack gives P with A = P L U). The other 51 names of
the table (vision / signal, conv extensions, interpolation variants and
the final-mile names, JAX impl_extra.py:774-1593) stay in the table and
raise NotImplementedError naming ROADMAP.md 'Still to port' item 12.

Creation ops make their tensors on the expected place. Random ops take
a torch.Generator (the dispatcher's, seeded from the default Generator's
next key) as their second argument and draw on its device with torch's
samplers: the same dtypes, shapes and distributions as JAX's draws, not
the same numbers (`core/random.py`).
"""

from __future__ import annotations

import builtins
import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtype import to_torch_dtype

__all__ = []     # filled below: the op names impl imports


def _op(fn):
    __all__.append(fn.__name__)
    return fn


def _device():
    from paddle_tpu_torch.core.place import expected_device

    return expected_device()


def _dt(dtype):
    return to_torch_dtype(dtype)


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return tuple(int(s) for s in shape)


def _floating(x):
    return x if x.is_floating_point() or x.is_complex() else x.float()


# ============================================================== linalg family


@_op
def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


@_op
def svdvals(x):
    return torch.linalg.svdvals(x)


@_op
def qr(x, mode="reduced"):
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


@_op
def eig(x):
    return tuple(torch.linalg.eig(x))


@_op
def eigvals(x):
    return torch.linalg.eigvals(x)


@_op
def eigh(x, UPLO="L"):  # noqa: N803
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


@_op
def eigvalsh(x, UPLO="L"):  # noqa: N803
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@_op
def lstsq(x, y, rcond=None, driver=None):
    """numpy's lstsq outputs: (solution, residuals, rank, singular values);
    residuals are the squared column norms of y - x @ solution when x is
    tall and of full rank, else empty."""
    m, n = x.shape[-2], x.shape[-1]
    sv = torch.linalg.svdvals(x)
    if rcond is None:
        rcond = torch.finfo(x.dtype).eps * builtins.max(m, n)
    rank = torch.sum(sv > rcond * sv.amax(-1, keepdim=True), dim=-1)
    vec = y.dim() == x.dim() - 1
    yy = y[..., None] if vec else y
    sol = torch.linalg.pinv(x, rtol=rcond) @ yy
    if m > n and bool((rank == n).all()):
        res = torch.sum(torch.square(x @ sol - yy), dim=-2)
        res = res[..., 0] if vec else res
    else:
        res = torch.zeros((0,), dtype=x.dtype, device=x.device)
    return (sol[..., 0] if vec else sol), res, rank, sv


@_op
def lu(x, pivot=True):
    """(lu, pivots, info); pivots 1-based int32 (LAPACK's convention)."""
    lu_mat, piv = torch.linalg.lu_factor(x, pivot=pivot)
    return lu_mat, piv.int(), torch.zeros(x.shape[:-2], dtype=torch.int32,
                                          device=x.device)


@_op
def lu_unpack(lu_mat, pivots, unpack_ludata=True, unpack_pivots=True):
    p, l_, u = torch.lu_unpack(lu_mat, pivots.int())
    return p, l_, u


@_op
def det(x):
    return torch.linalg.det(x)


@_op
def slogdet(x):
    sign, logdet = torch.linalg.slogdet(x)
    return sign, logdet


@_op
def solve(x, y):
    return torch.linalg.solve(x, y)


@_op
def cholesky_solve(x, y, upper=False):
    """Solve A z = x given y, the Cholesky factor of A: two triangular
    solves, which read (and differentiate) only y's triangle, as JAX's
    cho_solve does."""
    vec = x.dim() == 1
    b = x[:, None] if vec else x
    if upper:
        z = torch.linalg.solve_triangular(y.transpose(-1, -2), b, upper=False)
        out = torch.linalg.solve_triangular(y, z, upper=True)
    else:
        z = torch.linalg.solve_triangular(y, b, upper=False)
        out = torch.linalg.solve_triangular(y.transpose(-1, -2), z,
                                            upper=True)
    return out[:, 0] if vec else out


@_op
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, int(n))


@_op
def matrix_rank(x, tol=None, hermitian=False):
    s = torch.linalg.svdvals(x)
    if tol is None:
        tol = s.amax(-1, keepdim=True) * builtins.max(x.shape[-2:]) \
            * torch.finfo(s.dtype).eps
    elif isinstance(tol, torch.Tensor):
        tol = tol[..., None]
    return torch.sum(s > tol, dim=-1)


@_op
def multi_dot(xs):
    return torch.linalg.multi_dot(list(xs))


@_op
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@_op
def p_norm(x, porder=2.0, axis=-1, epsilon=1e-12, keepdim=False,
           asvector=False):
    if asvector:
        x, axis = x.reshape(-1), 0
    xf = x.float() if x.dtype == torch.bfloat16 else x
    if porder == float("inf"):
        out = torch.amax(torch.abs(xf), dim=axis, keepdim=keepdim)
    elif porder == float("-inf"):
        out = torch.amin(torch.abs(xf), dim=axis, keepdim=keepdim)
    elif porder == 0:
        out = torch.sum((xf != 0).to(xf.dtype), dim=axis, keepdim=keepdim)
    else:
        out = torch.sum(torch.abs(xf) ** porder, dim=axis,
                        keepdim=keepdim) ** (1.0 / porder)
    return out.to(x.dtype)


@_op
def frobenius_norm(x, axis=None, keepdim=False, reduce_all=False):
    if reduce_all or axis is None:
        return torch.sqrt(torch.sum(torch.square(x)))
    axis = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=keepdim))


@_op
def dist(x, y, p=2.0):
    d = (x - y).reshape(-1)
    if p == float("inf"):
        return torch.amax(torch.abs(d))
    if p == float("-inf"):
        return torch.amin(torch.abs(d))
    if p == 0:
        return torch.sum((d != 0).to(d.dtype))
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


@_op
def nextafter(x, y):
    if isinstance(y, torch.Tensor) and y.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    return torch.nextafter(x, y)


# ================================================================== creation


@_op
def empty(shape, dtype="float32"):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=_device())


@_op
def empty_like(x, dtype=None):
    return torch.zeros_like(x, dtype=None if dtype is None else _dt(dtype))


@_op
def eye(num_rows, num_columns=None, dtype="float32"):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=_dt(dtype), device=_device())


def _fill_value(v):
    return v.item() if isinstance(v, torch.Tensor) else v


@_op
def full(shape, fill_value, dtype="float32"):
    return torch.full(_shape(shape), _fill_value(fill_value),
                      dtype=_dt(dtype), device=_device())


@_op
def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, _fill_value(fill_value),
                           dtype=None if dtype is None else _dt(dtype))


def _linspace(start, stop, num, device):
    """jnp.linspace's fp32 arithmetic: start + i * delta, the last point
    stop."""
    start, stop, num = float(start), float(stop), int(num)
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    delta = np.float32(np.float32(stop) - np.float32(start)) \
        / np.float32(num - 1)
    out = np.float32(start) + torch.arange(num, dtype=torch.float32,
                                           device=device) * float(delta)
    out[-1] = stop
    return out


@_op
def linspace(start, stop, num, dtype="float32"):
    dt = _dt(dtype)
    out = _linspace(start, stop, num, _device())
    if not (dt.is_floating_point or dt.is_complex):
        out = torch.floor(out)
    return out.to(dt)


@_op
def logspace(start, stop, num, base=10.0, dtype="float32"):
    lin = _linspace(start, stop, num, _device())
    return torch.pow(torch.full((), float(base), dtype=torch.float32,
                                device=lin.device), lin).to(_dt(dtype))


@_op
def meshgrid(xs):
    return tuple(torch.meshgrid(*xs, indexing="ij"))


@_op
def ones(shape, dtype="float32"):
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=_device())


@_op
def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=None if dtype is None else _dt(dtype))


@_op
def zeros(shape, dtype="float32"):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=_device())


@_op
def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=None if dtype is None else _dt(dtype))


@_op
def tril_indices(rows, cols, offset=0, dtype="int64"):
    return torch.tril_indices(int(rows), int(cols), int(offset),
                              device=_device()).to(_dt(dtype))


@_op
def triu_indices(row, col, offset=0, dtype="int64"):
    return torch.triu_indices(int(row), int(col), int(offset),
                              device=_device()).to(_dt(dtype))


@_op
def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)


# ==================================================================== random


@_op
def bernoulli(x, generator):
    return torch.bernoulli(x, generator=generator)


@_op
def binomial(count, generator, prob=None):
    return torch.binomial(count.float(), prob.float(),
                          generator=generator).to(torch.int64)


@_op
def dirichlet(alpha, generator):
    g = torch._standard_gamma(alpha.float(), generator=generator)
    return (g / g.sum(-1, keepdim=True)).to(alpha.dtype)


@_op
def exponential_(x, generator, lam=1.0):
    e = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return (e.exponential_(1.0, generator=generator) / lam).to(x.dtype)


def _gumbel(shape, generator, device):
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


@_op
def gumbel_softmax(x, generator, temperature=1.0, hard=False, axis=-1):
    g = _gumbel(x.shape, generator, x.device)
    y = torch.softmax((x.float() + g) / temperature, dim=axis)
    if hard:
        onehot = (y == y.amax(dim=axis, keepdim=True)).to(y.dtype)
        y = (onehot - y).detach() + y     # straight-through estimator
    return y.to(x.dtype)


@_op
def multinomial(x, generator, num_samples=1, replacement=False):
    flat = x.float().reshape(-1, x.shape[-1])
    out = torch.multinomial(flat, int(num_samples), replacement=replacement,
                            generator=generator)
    return out.reshape(tuple(x.shape[:-1]) + (int(num_samples),))


@_op
def poisson(x, generator):
    return torch.poisson(x.float(), generator=generator).to(x.dtype)


@_op
def standard_gamma(x, generator):
    return torch._standard_gamma(x.float(), generator=generator).to(x.dtype)


@_op
def rrelu(x, generator, lower=1.0 / 8, upper=1.0 / 3, training=True):
    if training:
        a = torch.rand(x.shape, generator=generator, device=x.device) \
            * (upper - lower) + lower
    else:
        a = (lower + upper) / 2.0
    return torch.where(x >= 0, x, (a * x.float()).to(x.dtype))


@_op
def gaussian(shape, generator, mean=0.0, std=1.0, dtype="float32"):
    return mean + std * torch.randn(_shape(shape), generator=generator,
                                    device=generator.device,
                                    dtype=_dt(dtype))


@_op
def uniform(shape, generator, dtype="float32", min=-1.0,  # noqa: A002
            max=1.0):  # noqa: A002
    u = torch.rand(_shape(shape), generator=generator,
                   device=generator.device, dtype=_dt(dtype))
    return u * (max - min) + min


@_op
def randint(low, generator, high=None, shape=(1,), dtype="int64"):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=generator,
                         device=generator.device).to(_dt(dtype))


@_op
def randperm(n, generator, dtype="int64"):
    return torch.randperm(int(n), generator=generator,
                          device=generator.device).to(_dt(dtype))


@_op
def truncated_gaussian_random(shape, generator, mean=0.0, std=1.0, a=-2.0,
                              b=2.0, dtype="float32"):
    """The inverse-CDF draw jax.random.truncated_normal makes, with
    torch's uniforms."""
    def cdf(v):
        return 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))

    lo, hi = cdf(a), cdf(b)
    u = torch.rand(_shape(shape), generator=generator,
                   device=generator.device) * (hi - lo) + lo
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    z = torch.clamp(z, a, b)
    return (mean + std * z).to(_dt(dtype))


# =================================================================== bitwise


@_op
def bitwise_and(x, y):
    return torch.bitwise_and(x, y)


@_op
def bitwise_or(x, y):
    return torch.bitwise_or(x, y)


@_op
def bitwise_xor(x, y):
    return torch.bitwise_xor(x, y)


@_op
def bitwise_not(x):
    return torch.bitwise_not(x)


@_op
def bitwise_left_shift(x, y, is_arithmetic=True):
    return torch.bitwise_left_shift(x, y)


_BITS = {torch.int8: 8, torch.int16: 16, torch.int32: 32}


@_op
def bitwise_right_shift(x, y, is_arithmetic=True):
    bits = _BITS.get(x.dtype)
    if is_arithmetic or bits is None:
        return torch.bitwise_right_shift(x, y)
    # logical: shift the unsigned reading of x's bits, in int64
    unsigned = x.long() & ((1 << bits) - 1)
    y = y.long() if isinstance(y, torch.Tensor) else y
    return torch.bitwise_right_shift(unsigned, y).to(x.dtype)


# ============================================================== unary extras


@_op
def copysign(x, y):
    x = _floating(x)
    if isinstance(y, torch.Tensor):
        y = y.to(x.dtype)
    return torch.copysign(x, y)


@_op
def gammaln(x):
    return torch.lgamma(_floating(x))


@_op
def i0(x):
    return torch.special.i0(_floating(x))


@_op
def i0e(x):
    return torch.special.i0e(_floating(x))


@_op
def i1(x):
    return torch.special.i1(_floating(x))


@_op
def i1e(x):
    return torch.special.i1e(_floating(x))


@_op
def logsigmoid(x):
    return F.logsigmoid(x)


@_op
def polygamma(x, n=0):
    if n == 0:
        return torch.digamma(_floating(x))
    return torch.special.polygamma(int(n), _floating(x))


@_op
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@_op
def tanh_shrink(x):
    return x - torch.tanh(x)


@_op
def thresholded_relu(x, threshold=1.0, value=0.0):
    return torch.where(x > threshold, x, torch.full_like(x, value))


@_op
def increment(x, value=1.0):
    return x + torch.full((), value, dtype=x.dtype, device=x.device)


# ==================================================================== losses


@_op
def bce_loss(input, label):  # noqa: A002
    x = torch.clamp(input.float(), 1e-12, 1 - 1e-7)
    out = -(label * torch.log(x) + (1 - label) * torch.log1p(-x))
    return out.to(input.dtype)


@_op
def hinge_loss(logits, labels):
    return torch.clamp(1.0 - logits.float() * labels.float(),
                       min=0.0).to(logits.dtype)


@_op
def huber_loss(input, label, delta=1.0):  # noqa: A002
    """(out, residual) as phi's HuberLossKernel."""
    residual = (label - input).float()
    a = torch.abs(residual)
    out = torch.where(a <= delta, 0.5 * residual * residual,
                      delta * (a - 0.5 * delta))
    return out.to(input.dtype), residual.to(input.dtype)


@_op
def kldiv_loss(x, target, reduction="mean", log_target=False):
    t = target.float()
    xf = x.float()
    if log_target:
        out = torch.exp(t) * (t - xf)
    else:
        out = torch.where(t > 0, t * (torch.log(torch.clamp(t, min=1e-30))
                                      - xf), torch.zeros_like(t))
    if reduction == "mean":
        return torch.mean(out).to(x.dtype)
    if reduction == "batchmean":
        return (torch.sum(out) / x.shape[0]).to(x.dtype)
    if reduction == "sum":
        return torch.sum(out).to(x.dtype)
    return out.to(x.dtype)


@_op
def log_loss(input, label, epsilon=1e-4):  # noqa: A002
    x = input.float()
    out = (-label * torch.log(x + epsilon)
           - (1 - label) * torch.log(1 - x + epsilon))
    return out.to(input.dtype)


@_op
def sigmoid_cross_entropy_with_logits(x, label, normalize=False,
                                      ignore_index=-100):
    xf = x.float()
    lf = label.float()
    out = torch.clamp(xf, min=0) - xf * lf \
        + torch.log1p(torch.exp(-torch.abs(xf)))
    mask = lf != ignore_index
    out = torch.where(mask, out, torch.zeros_like(out))
    if normalize:
        out = out / torch.clamp(torch.sum(mask.float()), min=1.0)
    return out.to(x.dtype)


@_op
def identity_loss(x, reduction="none"):
    if reduction in ("mean", 0):
        return torch.mean(x)
    if reduction in ("sum", 1):
        return torch.sum(x)
    return x


@_op
def cross_entropy_with_softmax(logits, label, soft_label=False,
                               use_softmax=True, numeric_stable_mode=True,
                               ignore_index=-100, axis=-1):
    """(softmax, loss) as phi's CrossEntropyWithSoftmaxKernel."""
    lp = torch.log_softmax(logits.float(), dim=axis) if use_softmax \
        else torch.log(torch.clamp(logits, min=1e-30))
    sm = torch.exp(lp)
    if soft_label:
        loss = -torch.sum(label * lp, dim=axis, keepdim=True)
    else:
        lbl = label.long()
        idx = lbl if lbl.dim() == logits.dim() else lbl[..., None]
        picked = torch.gather(lp, axis, torch.clamp(idx, min=0))
        loss = torch.where(idx == ignore_index, torch.zeros_like(picked),
                           -picked)
    return sm.to(logits.dtype), loss.to(logits.dtype)


# ============================================================== manipulation


@_op
def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


@_op
def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


@_op
def complex(real, imag):  # noqa: A001
    return torch.complex(real, imag)


@_op
def as_strided(x, shape, stride, offset=0):
    """Functional as_strided: a gather from the flat buffer."""
    flat = x.reshape(-1)
    idx = torch.full((), int(offset), dtype=torch.long, device=x.device)
    for s, st in zip(_shape(shape), _shape(stride)):
        idx = idx[..., None] + torch.arange(s, device=x.device) * st
    return flat[idx.reshape(_shape(shape))]


@_op
def broadcast_tensors(xs):
    return tuple(torch.broadcast_tensors(*xs))


@_op
def crop(x, shape=None, offsets=None):
    offsets = offsets or [0] * x.dim()
    shape = shape or x.shape
    idx = tuple(builtins.slice(int(o), int(o) + int(s))
                for o, s in zip(offsets, shape))
    return x[idx]


@_op
def expand_as(x, y):
    return x.expand(y.shape)


@_op
def fill(x, value):
    return torch.full_like(x, value)


@_op
def fill_diagonal(x, value=0.0, offset=0, wrap=False):
    rows, cols = x.shape[-2], x.shape[-1]
    n = builtins.min(rows, cols)
    i = torch.arange(n, device=x.device)
    r = i + builtins.max(-offset, 0)
    c = i + builtins.max(offset, 0)
    ok = (r < rows) & (c < cols)
    r = torch.where(ok, r, torch.zeros_like(r))
    c = torch.where(ok, c, torch.zeros_like(c))
    val = torch.full((), value, dtype=x.dtype, device=x.device)
    upd = torch.where(ok, val, x[..., r, c])
    out = x.clone()
    out[..., r, c] = upd
    if wrap and x.dim() == 2 and rows > cols:
        # wrap the diagonal around tall matrices (numpy fill_diagonal)
        for start in range(cols + 1, rows, cols + 1):
            m = builtins.min(cols, rows - start)
            eye_ = torch.eye(m, dtype=torch.bool, device=x.device)
            out[start:start + m, :m] = torch.where(
                eye_, val, out[start:start + m, :m])
    return out


@_op
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1):
    nd = x.dim()
    d1, d2 = dim1 % nd, dim2 % nd
    xm = torch.movedim(x, (d1, d2), (nd - 2, nd - 1)).clone()
    rows, cols = xm.shape[-2], xm.shape[-1]
    n = builtins.min(rows - builtins.max(-offset, 0),
                     cols - builtins.max(offset, 0))
    i = torch.arange(n, device=x.device)
    xm[..., i + builtins.max(-offset, 0), i + builtins.max(offset, 0)] = \
        y.to(x.dtype)
    return torch.movedim(xm, (nd - 2, nd - 1), (d1, d2))


@_op
def index_add(x, index, add_value, axis=0):
    return x.index_add(axis % x.dim(), index.long(), add_value.to(x.dtype))


@_op
def index_put(x, indices, value, accumulate=False):
    idx = tuple(i.long() if not i.dtype == torch.bool else i
                for i in indices)
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=x.dtype, device=x.device)
    return x.index_put(idx, value.to(x.dtype), accumulate=accumulate)


@_op
def reverse(x, axis):
    axis = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return torch.flip(x, axis)


@_op
def sequence_mask(x, max_len=None, out_dtype="int64"):
    if max_len is None:
        raise ValueError("sequence_mask requires max_len under jit "
                         "(value-dependent output shape otherwise)")
    m = int(max_len)
    return (torch.arange(m, device=x.device) < x[..., None]).to(
        _dt(out_dtype))


@_op
def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    size = (index_num + nshards - 1) // nshards  # ceil (phi ShardIndex)
    in_shard = torch.div(x, size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, torch.remainder(x, size),
                       torch.full_like(x, ignore_value))


@_op
def slice(x, axes, starts, ends):  # noqa: A001
    slices = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        slices[ax] = builtins.slice(int(st), int(en))
    return x[tuple(slices)]


@_op
def strided_slice(x, axes, starts, ends, strides):
    for ax, st, en, sr in zip(axes, starts, ends, strides):
        picks = range(*builtins.slice(int(st), int(en), int(sr)).indices(
            x.shape[ax]))
        x = torch.index_select(x, ax, torch.as_tensor(
            list(picks), dtype=torch.long, device=x.device))
    return x


@_op
def split_with_num(x, num, axis=0):
    n = x.shape[int(axis)]
    if n % int(num):
        raise ValueError(f"array split does not result in an equal "
                         f"division: {n} into {num}")
    return tuple(torch.split(x, n // int(num), dim=int(axis)))


@_op
def multiplex(inputs, index):
    stacked = torch.stack(list(inputs))            # [K, N, ...]
    idx = index.reshape(-1).long()                 # [N]
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


@_op
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64"):
    flat = x.reshape(-1) if axis is None else x
    out, inv, counts = torch.unique_consecutive(
        flat, return_inverse=True, return_counts=True)
    rets = (out,)
    if return_inverse:
        rets += (inv.to(_dt(dtype)),)
    if return_counts:
        rets += (counts.to(_dt(dtype)),)
    return rets if len(rets) > 1 else out


# ======================================================== reductions / checks


@_op
def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    if isinstance(y, torch.Tensor) and y.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    return torch.isclose(x, y, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


@_op
def equal_all(x, y):
    if tuple(x.shape) != tuple(y.shape):
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.eq(x, y).all()


@_op
def mean_all(x):
    return torch.mean(_floating(x))


@_op
def numel(x):
    return torch.full((), x.numel(), dtype=torch.int64, device=x.device)


@_op
def shape(x):
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


@_op
def is_empty(x):
    return torch.full((), x.numel() == 0, dtype=torch.bool, device=x.device)


@_op
def nanmedian(x, axis=None, keepdim=False, mode="avg"):
    from paddle_tpu_torch.ops.impl import nanquantile

    return nanquantile(x, 0.5, axis=axis, keepdim=keepdim)


def _cum_with_idx(x, axis, strictly_better):
    """Running extremum and the index where it was first reached (a tie
    keeps the earlier index, as the JAX associative scan does)."""
    axis = axis % x.dim() if x.dim() else 0
    fn = torch.cummax if strictly_better is torch.gt else torch.cummin
    vals = fn(x, dim=axis).values
    n = x.shape[axis]
    pos = torch.arange(n, device=x.device).reshape(
        (1,) * axis + (-1,) + (1,) * (x.dim() - axis - 1)).expand(x.shape)
    prev = torch.cat([vals.narrow(axis, 0, 1), vals.narrow(axis, 0, n - 1)],
                     dim=axis)
    new = strictly_better(x, prev) | (pos == 0)
    idx = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)),
                       dim=axis).values
    return vals, idx


@_op
def cummax(x, axis=None, dtype="int64"):
    if axis is None:
        return _cum_with_idx(x.reshape(-1), 0, torch.gt)
    return _cum_with_idx(x, int(axis), torch.gt)


@_op
def cummin(x, axis=None, dtype="int64"):
    if axis is None:
        return _cum_with_idx(x.reshape(-1), 0, torch.lt)
    return _cum_with_idx(x, int(axis), torch.lt)


@_op
def l1_norm(x):
    return torch.sum(torch.abs(x))


@_op
def squared_l2_norm(x):
    return torch.sum(torch.square(x))


@_op
def clip_by_norm(x, max_norm):
    norm = torch.sqrt(torch.clamp(torch.sum(torch.square(x)), min=1e-12))
    return x * torch.clamp(max_norm / norm, max=1.0)


# ============================== not yet ported: the rest of the round-2 block

DEFERRED_ITEM = "ROADMAP.md 'Still to port' item 12"

# JAX impl_extra.py:774-1593: vision / signal, conv extensions,
# interpolation variants, final-mile names
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


def _deferred(name):
    def op(*args, **kwargs):
        raise NotImplementedError(
            f"op '{name}' is not ported yet: {DEFERRED_ITEM} (the next "
            "slice of the framework: the vision / signal ops, conv "
            "extensions, interpolation variants and final-mile names of "
            "JAX impl_extra.py:774-1593)")

    op.__name__ = op.__qualname__ = name
    return op


for _name in DEFERRED:
    globals()[_name] = _deferred(_name)
    __all__.append(_name)
del _name
