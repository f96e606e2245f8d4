"""The port's seeded sampling against jax.random and the JAX package.

`paddle_tpu_torch.core.random` carries threefry2x32 and the draws the JAX
serving path samples with; `models.generation._sample`, the engine's
`seeded_sample` and the runner's `_sampled_rows` are built on it. Every
pin here is exact equality, on the same inputs:

  * `key`, `fold_in`, the 32-bit `random_bits`, `uniform` and `gumbel`
    are bit-equal to jax for seeds {0, 1, 7, 2**31-1, 2**31, 2**32+5, -1},
    steps {0, 1, 31, 1000} and V in {1, 97, 32000} (jax's default 32-bit
    mode keeps only a seed's low word, and the port does the same);
  * `seeded_sample` tokens equal the JAX `seeded_sample` over seeds 0-3,
    steps 0-7, temperatures {0.3, 0.7, 1.0, 1.5} and (top_k, top_p) in
    {(None, None), (1, None), (50, None), (None, 0.9), (8, 0.9)}, on numpy
    rows from seed 0 at V = 97 and 32000;
  * a batched `_sampled_rows` equals the JAX
    `PagedModelRunner._sampled_rows` over 256 rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving.engine import seeded_sample as jax_seeded_sample
from paddle_tpu.serving.model_runner import PagedModelRunner as JaxRunner
from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.serving import seeded_sample
from paddle_tpu_torch.serving.model_runner import PagedModelRunner

torch.set_num_threads(1)

SEEDS = (0, 1, 7, 2**31 - 1, 2**31, 2**32 + 5, -1)
STEPS = (0, 1, 31, 1000)
WIDTHS = (1, 97, 32000)
TEMPS = (0.3, 0.7, 1.0, 1.5)
CONFIGS = ((None, None), (1, None), (50, None), (None, 0.9), (8, 0.9))


def _words(jax_key):
    return np.asarray(jax.random.key_data(jax_key)).astype(np.int64)


def _bits_of(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_are_bit_equal_to_jax(seed):
    jk, pk = jax.random.key(seed), prandom.key(seed)
    np.testing.assert_array_equal(pk.numpy(), _words(jk))
    for step in STEPS:
        np.testing.assert_array_equal(
            prandom.fold_in(pk, step).numpy(),
            _words(jax.random.fold_in(jk, step)))
    # a batch of keys from a tensor of seeds: the same words row by row
    batch = prandom.fold_in(prandom.key(torch.tensor([seed, 3])),
                            torch.tensor([STEPS[-1], 0]))
    np.testing.assert_array_equal(
        batch[0].numpy(), _words(jax.random.fold_in(jk, STEPS[-1])))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_gumbel_are_bit_equal_to_jax(seed):
    tiny = np.finfo(np.float32).tiny
    for step in STEPS:
        jk = jax.random.fold_in(jax.random.key(seed), step)
        pk = prandom.fold_in(prandom.key(seed), step)
        for V in WIDTHS:
            shape = (1, V)
            np.testing.assert_array_equal(
                prandom.random_bits(pk, shape).numpy(),
                np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(
                    np.int64))
            np.testing.assert_array_equal(
                _bits_of(prandom.uniform(pk, shape, prandom.TINY, 1.0)),
                _bits_of(jax.random.uniform(jk, shape, jnp.float32,
                                            minval=tiny, maxval=1.0)))
            np.testing.assert_array_equal(
                _bits_of(prandom.gumbel(pk, shape)),
                _bits_of(jax.random.gumbel(jk, shape, jnp.float32)))


def test_xla_log_matches_jax_log_and_its_edges():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.random(20000, np.float32),
        np.abs(rng.standard_normal(20000).astype(np.float32)) * 50,
        np.float32([1.0, 2.0, 0.5, np.finfo(np.float32).tiny, 3e38])])
    np.testing.assert_array_equal(
        _bits_of(prandom.xla_log(torch.from_numpy(x))),
        _bits_of(jnp.log(jnp.asarray(x))))
    edges = prandom.xla_log(torch.tensor([0.0, 1e-40, -1.0, float("inf")]))
    assert edges[0] == edges[1] == float("-inf")
    assert torch.isnan(edges[2]) and edges[3] == float("inf")


@pytest.mark.parametrize("V", [97, 32000])
@pytest.mark.parametrize("top_k,top_p", CONFIGS)
def test_seeded_sample_tokens_equal_jax(V, top_k, top_p):
    rows = np.random.default_rng(0).standard_normal((4, V)).astype(
        np.float32) * 3
    got, want = [], []
    for seed in range(4):
        for step in range(8):
            row = rows[(seed + step) % 4]
            for temp in TEMPS:
                got.append(seeded_sample(row, seed, step, temp, top_k, top_p))
                want.append(jax_seeded_sample(row, seed, step, temp, top_k,
                                              top_p))
    assert got == want


@pytest.mark.parametrize("top_k,top_p", CONFIGS)
def test_batched_sampled_rows_equal_jax(top_k, top_p):
    rng = np.random.default_rng(1)
    B, V = 256, 97
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    steps = rng.integers(0, 4096, B).astype(np.int32)
    temps = rng.choice(np.float32([0.0, 0.3, 0.7, 1.0, 1.5]), B)
    want = np.asarray(JaxRunner._sampled_rows(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.asarray(steps),
        jnp.asarray(temps), top_k, top_p))
    got = PagedModelRunner._sampled_rows(
        torch.from_numpy(logits), torch.from_numpy(seeds.astype(np.int64)),
        torch.from_numpy(steps), torch.from_numpy(temps), top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_rows_of_a_row_do_not_depend_on_the_batch():
    """The per-step engine samples a decode call's [B, V] rows, naive
    generation a [1, V] row: each row's token is the same."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy((rng.standard_normal((5, 97)) * 3).astype(
        np.float32))
    seeds = torch.arange(5, dtype=torch.int64)
    steps = torch.arange(5, dtype=torch.int64) * 3
    temps = torch.full((5,), 0.9)
    whole = PagedModelRunner._sampled_rows(logits, seeds, steps, temps, 8,
                                           0.9)
    for b in range(5):
        assert seeded_sample(logits[b].numpy(), int(seeds[b]), int(steps[b]),
                             0.9, 8, 0.9) == int(whole[b])
