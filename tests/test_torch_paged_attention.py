"""The port's paged decode attention (K2) and its dispatch gate against
the JAX package's.

The same numpy inputs go through the JAX kernel in Pallas interpret mode
and the port's wrapper on CPU tensors (its plain version). Tolerance
atol = rtol = 1e-5: both sum in fp32, in another order. `best_paged_impl`
must name the same kernel as the JAX gate over a grid of shapes.
"""

import importlib
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops import paged_attention as k2

# the JAX package re-exports the function under the module's name
jax_k2 = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# tiny shapes: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

ATOL = RTOL = 1e-5


def _inputs(seed, b=3, h=2, d=16, ps=8, pages=6):
    rng = np.random.default_rng(seed)
    nb = 1 + b * pages
    kp = rng.standard_normal((nb, ps, h, d)).astype(np.float32)
    vp = rng.standard_normal((nb, ps, h, d)).astype(np.float32)
    tbl = rng.permutation(np.arange(1, nb)).reshape(b, pages).astype(np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return q, kp, vp, tbl


def _port(q, kp, vp, tbl, pos):
    return k2.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tbl), torch.tensor(pos, dtype=torch.int32)).numpy()


def _jax(q, kp, vp, tbl, pos):
    return np.asarray(jax_k2.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(pos, jnp.int32), interpret=True))


@pytest.mark.parametrize("pos", [
    [0, 0, 0],              # first token only
    [7, 8, 9],              # around the first page boundary
    [15, 16, 47],           # boundaries and the table's last key
    [3, 30, 41],            # off boundaries
])
@pytest.mark.parametrize("d", [16, 64])
def test_plain_matches_jax_kernel(pos, d):
    q, kp, vp, tbl = _inputs(seed=sum(pos) + d, d=d)
    np.testing.assert_allclose(_port(q, kp, vp, tbl, pos),
                               _jax(q, kp, vp, tbl, pos),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ps,pages", [(1, 20), (4, 5), (16, 3)])
def test_plain_matches_jax_over_page_sizes(ps, pages):
    q, kp, vp, tbl = _inputs(seed=ps, h=4, ps=ps, pages=pages)
    cap = ps * pages
    pos = [cap - 1, cap // 2, 0]
    np.testing.assert_allclose(_port(q, kp, vp, tbl, pos),
                               _jax(q, kp, vp, tbl, pos),
                               rtol=RTOL, atol=ATOL)


def test_dead_slot_on_scratch_table_is_finite():
    """Dead decode slots carry all-scratch tables and pos 0: the call
    reads page 0 harmlessly and gives finite values (never read)."""
    q, kp, vp, tbl = _inputs(seed=9)
    tbl[1] = 0
    out = _port(q, kp, vp, tbl, [5, 0, 12])
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, _jax(q, kp, vp, tbl, [5, 0, 12]),
                               rtol=RTOL, atol=ATOL)


def test_plain_matches_ragged_at_q_len_1():
    """For MHA at one token, K2 and K1 compute the same function."""
    from paddle_tpu_torch.ops.ragged_paged_attention import ragged_reference

    q, kp, vp, tbl = _inputs(seed=4)
    pos = [9, 31, 2]
    t = torch.from_numpy
    ragged = ragged_reference(
        t(q)[:, None], t(kp), t(vp), t(tbl), torch.tensor(pos).int(),
        torch.ones(3, dtype=torch.int32))[:, 0]
    np.testing.assert_allclose(_port(q, kp, vp, tbl, pos), ragged.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_best_paged_impl_matches_jax_over_a_grid():
    grid = itertools.product((8, 12, 16, 64, 128, 130, 256), (1, 4, 8, 32),
                             (1, 2, 4, 8, 32), (1, 2, 8, 256))
    mismatched = [g for g in grid
                  if k2.best_paged_impl(*g) != jax_k2.best_paged_impl(*g)]
    assert not mismatched


def test_main_path_dispatch_for_llama2_7b():
    """LLaMA-2-7B (MHA, d=128) sends decode to K2 and every prefill
    bucket to K1; a GQA layout sends decode to K1 as well."""
    assert k2.best_paged_impl(128, 32, 32, 1) == "paged_decode"
    for bucket in (8, 16, 256):
        assert k2.best_paged_impl(128, 32, 32, bucket) == "ragged"
    assert k2.best_paged_impl(128, 32, 8, 1) == "ragged"


def test_wrapper_rejects_gqa_pools():
    q, kp, vp, tbl = _inputs(seed=1, h=4)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="MHA"):
        k2.paged_decode_attention(t(q), t(kp[:, :, :2]), t(vp[:, :, :2]),
                                  t(tbl), torch.zeros(3, dtype=torch.int32))


# ------------------------------------------------ the kernel's split algebra

def _split(q, kp, vp, tbl, pos, keys_per_split):
    return k2.paged_decode_split_reference(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tbl), torch.tensor(pos, dtype=torch.int32),
        keys_per_split=keys_per_split).numpy()


# a table of 24 pages of 4 keys: 96 keys, cut into splits of 16 (one tile),
# 32 (two tiles) or 128 (longer than any sequence)
SPLIT_SIZES = [k2.SPLIT_TILE, 2 * k2.SPLIT_TILE, 128]


@pytest.mark.parametrize("keys_per_split", SPLIT_SIZES)
@pytest.mark.parametrize("pos", [
    [0, 15, 16, 31],        # the first split's last key, the next's first
    [32, 63, 64, 95],       # split and page boundaries, the table's last key
    [3, 17, 50, 90],        # off split and page boundaries
    [1, 6, 37, 300],        # inside a page; past the table (capped)
])
def test_split_twin_matches_jax_kernel_and_plain(keys_per_split, pos):
    """Most sequences leave empty splits after their last key (and at 16
    keys a split, splits end inside pages); they must merge as nothing."""
    q, kp, vp, tbl = _inputs(seed=sum(pos) + keys_per_split, b=4, ps=4,
                             pages=24)
    got = _split(q, kp, vp, tbl, pos, keys_per_split)
    np.testing.assert_allclose(got, _jax(q, kp, vp, tbl, pos),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _port(q, kp, vp, tbl, pos),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("keys_per_split", SPLIT_SIZES)
def test_split_twin_over_a_dead_slot(keys_per_split):
    """A dead slot (all-scratch table, pos 0) sees one key of the scratch
    page: its output is that key's V row, and its neighbours' outputs are
    unchanged by it."""
    q, kp, vp, tbl = _inputs(seed=keys_per_split, b=3, ps=4, pages=24)
    tbl[1] = 0
    pos = [70, 0, 33]
    got = _split(q, kp, vp, tbl, pos, keys_per_split)
    np.testing.assert_allclose(got[1], vp[0, 0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _jax(q, kp, vp, tbl, pos),
                               rtol=RTOL, atol=ATOL)


def test_split_twin_without_keys_gives_zeros():
    """pos < 0 (no visible key, every split empty): zeros, not NaN."""
    q, kp, vp, tbl = _inputs(seed=5, ps=4, pages=8)
    got = _split(q, kp, vp, tbl, [-1, 0, 31], k2.SPLIT_TILE)
    assert np.isfinite(got).all()
    assert (got[0] == 0).all()
    np.testing.assert_allclose(got[1:], _port(q, kp, vp, tbl, [-1, 0, 31])[1:],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ps,pages", [(1, 40), (16, 3)])
def test_split_twin_over_page_sizes(ps, pages):
    """Page size 1 (every key its own page) and pages of 16 (a split of
    one tile per page)."""
    q, kp, vp, tbl = _inputs(seed=ps + 1, h=3, d=8, ps=ps, pages=pages)
    cap = ps * pages
    pos = [cap - 1, k2.SPLIT_TILE, cap // 2 + 1]
    got = _split(q, kp, vp, tbl, pos, k2.SPLIT_TILE)
    np.testing.assert_allclose(got, _jax(q, kp, vp, tbl, pos),
                               rtol=RTOL, atol=ATOL)


def test_split_count_follows_the_table_not_the_batch():
    """The kernel's workspace holds ceil(P * page_size / keys_per_split)
    splits a (sequence, head), at least one."""
    assert k2.KEYS_PER_SPLIT % k2.SPLIT_TILE == 0
    assert k2.n_splits(256, 16) == 4096 // k2.KEYS_PER_SPLIT
    assert k2.n_splits(3, 5, 16) == 1
    assert k2.n_splits(0, 16) == 1
    assert k2.n_splits(17, 1, 16) == 2
