"""threefry2x32 and the draws built on it, bit for bit as jax.random.

Counterpart of the ``jax.random`` functions the JAX serving path samples
with (``key``, ``fold_in``, ``categorical`` and what they call), under
jax's defaults: the threefry2x32 implementation, ``jax_threefry_
partitionable`` on, 32-bit integers. A key is an int64 tensor ``[..., 2]``
holding two uint32 words; leading dimensions batch independent keys.

Every value is an int64 tensor masked to 32 bits (torch's uint32 lacks
the shifts and adds this needs), and nothing reads a value back to the
host, so each function runs on the device where its operands live and
inside a captured CUDA graph.

  threefry2x32(k1, k2, x1, x2)  the 20-round hash (jax/_src/prng.py)
  key(seed)                     jax.random.key: the seed wrapped to 32 bits
                                as jax's default mode converts it, then
                                threefry_seed, so the high word is 0 and
                                negative seeds and seeds >= 2**32 wrap
  fold_in(key, data)            threefry2x32(key, threefry_seed(data))
  random_bits(key, shape)       the partitionable bits: counters are the
                                (hi, lo) words of each element's flat index,
                                the result bits1 ^ bits2
  uniform(key, shape, lo, hi)   mantissa bits under exponent 0, minus 1
  gumbel(key, shape)            mode "low": -log(-log(uniform(tiny, 1)))
  categorical(key, logits)      argmax(gumbel + logits) over the last axis
  Generator, default_generator, the JAX package's RNG state (seed, key,
  seed, get_rng_state,          offset; next_key = fold_in(key, ++offset))
  set_rng_state

The logarithm is `xla_log`, not torch.log: XLA evaluates log on the CPU
with its own polynomial (Cephes' coefficients, several steps fused into
one multiply-add), up to 1.1 ulp from the exact value, and torch's log
rounds differently in about one element of seven. `xla_log` evaluates
the same polynomial in the same order; a fused step is an fp64 product
(exact for two fp32 factors) plus an fp64 add, rounded to fp32. fp64
arithmetic is IEEE on the CPU and on the card, so the Gumbel noise is
the same bits on both devices and equal to jax's.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
# the key schedule's parity constant and the two rotation sets, alternated
# over the five groups of four rounds
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = torch.finfo(torch.float32).tiny


def _words(x, device=None) -> torch.Tensor:
    """A python int or integer tensor as int64 uint32 words."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    # a fill on the device: no blocking host-to-device copy
    return torch.full((), int(x) & MASK, dtype=torch.int64, device=device)


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the counter pair (x1, x2) under the key
    (k1, k2); every operand an int64 tensor of uint32 words (they
    broadcast). Returns the two output words (new tensors; the rounds
    update them in place)."""
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    shape = torch.broadcast_shapes(k1.shape, x1.shape, x2.shape)
    x1 = (x1 + ks[0]).expand(shape).contiguous().bitwise_and_(MASK)
    x2 = (x2 + ks[1]).expand(shape).contiguous().bitwise_and_(MASK)
    for group in range(5):
        for r in ROTATIONS[group % 2]:
            x1.add_(x2).bitwise_and_(MASK)
            high = (x2 << r).bitwise_and_(MASK)
            x2.bitwise_right_shift_(32 - r).bitwise_or_(high).bitwise_xor_(x1)
        x1.add_(ks[(group + 1) % 3]).bitwise_and_(MASK)
        x2.add_(ks[(group + 2) % 3] + group + 1).bitwise_and_(MASK)
    return x1, x2


def threefry_seed(seed) -> torch.Tensor:
    """The raw key of a 64-bit integer seed: (seed >> 32, seed & MASK)."""
    if isinstance(seed, torch.Tensor):
        s = seed.to(torch.int64)
        return torch.stack([(s >> 32) & MASK, s & MASK], dim=-1)
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64)


def key(seed, device=None) -> torch.Tensor:
    """jax.random.key(seed): jax converts the seed to its default 32-bit
    integer before threefry_seed, so only its low word survives."""
    if isinstance(seed, torch.Tensor):
        return threefry_seed(seed.to(torch.int64) & MASK)
    return threefry_seed(int(seed) & MASK).to(device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: hash the uint32 ``data`` (an int or a tensor
    broadcasting against the key's batch) into the key."""
    d = _words(data, k.device)
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def random_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` for each key of the batch
    ([*batch, *shape] int64): the partitionable counters."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    lead = k.shape[:-1]
    k1 = k[..., 0].reshape(*lead, *([1] * len(shape)))
    k2 = k[..., 1].reshape(*lead, *([1] * len(shape)))
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return b1 ^ b2


def uniform(k: torch.Tensor, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """fp32 uniforms in [minval, maxval) from the top 23 bits. The bounds
    enter as fp32 numbers, so no host tensor crosses to the device."""
    bits = (random_bits(k, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * span + lo, min=lo)


# XLA's CPU log: Cephes' logf polynomial in three interleaved Horner chains
LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
         -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
         2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
LOG_Q1, LOG_Q2 = -2.12194440e-4, 0.693359375
SQRTHF = 0.707106781186547524


def _fma(a, b, c):
    """fp32 a * b + c with the product unrounded: ``a`` an fp64 copy of an
    fp32 tensor, ``b`` an fp64 tensor or an fp32-exact number, ``c`` an
    fp32 tensor or an fp32-exact number."""
    if isinstance(c, torch.Tensor):
        c = c.double()
    return (a * b + c).float()


def _f32(x: float) -> float:
    return float(np.float32(x))


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of fp32 ``x`` as XLA computes it on the CPU (see the
    module docstring), for positive finite x; 0 and subnormals (which XLA
    flushes to 0) give -inf, a negative x NaN and +inf +inf."""
    xc = torch.clamp(x, min=TINY)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < SQRTHF
    m = m - 1.0 + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    m2 = m * m
    m3 = m2 * m
    md, m3d = m.double(), m3.double()
    p = [_f32(c) for c in LOG_P]

    def chain(a, b, c):
        return _fma(_fma(md, a, b).double(), md, c)

    y = chain(*p[0:3])
    y1 = chain(*p[3:6])
    y2 = chain(*p[6:9])
    y = _fma(_fma(y.double(), m3d, y1).double(), m3d, y2)
    y = _fma(y.double(), m3d, e * LOG_Q1)
    out = m - m2 * 0.5 + y + e * LOG_Q2
    out = torch.where((x >= 0) & (x < TINY), torch.full_like(out,
                                                           float("-inf")),
                      out)
    out = torch.where(x < 0, torch.full_like(out, float("nan")), out)
    return torch.where(torch.isinf(x) & (x > 0), x, out)


def gumbel(k: torch.Tensor, shape) -> torch.Tensor:
    """Standard Gumbel noise, jax's mode "low"."""
    return -xla_log(-xla_log(uniform(k, shape, TINY, 1.0)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits`` ([*batch, V], batch matching the
    key's): the Gumbel-max argmax over the last axis."""
    return torch.argmax(gumbel(k, logits.shape[-1:]) + logits, dim=-1)


class Generator:
    """The JAX package's RNG state (`core/random.py`: phi::Generator): a
    threefry key of a seed and an offset counter; `next_key()` is
    fold_in(key, ++offset). Keys are host tensors [2]; a caller moves one
    to its device."""

    def __init__(self, seed: int = 0):
        self.manual_seed(seed)

    def manual_seed(self, seed: int) -> "Generator":
        self._seed = int(seed)
        self.key = key(self._seed)
        self.offset = 0
        return self

    def next_key(self) -> torch.Tensor:
        self.offset += 1
        return fold_in(self.key, self.offset)

    def get_state(self) -> dict:
        return {"seed": self._seed, "key": self.key.clone(),
                "offset": self.offset}

    def set_state(self, state) -> None:
        self._seed = state["seed"]
        self.key = state["key"].clone()
        self.offset = state["offset"]


default_generator = Generator(0)


def seed(s: int) -> Generator:
    """paddle.seed: reseed the default generator."""
    return default_generator.manual_seed(s)


def get_rng_state() -> dict:
    return default_generator.get_state()


def set_rng_state(state) -> None:
    default_generator.set_state(state)
