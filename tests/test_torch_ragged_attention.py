"""The port's ragged paged attention (K1) against the JAX package's.

The same numpy inputs go through the JAX kernel in Pallas interpret mode,
the JAX gather oracle `ragged_reference`, and the port's wrapper on CPU
tensors (which runs the port's plain version). Swept over q_len,
start_pos, n_rep in {1, 2, 4}, page count, dead slots and padded buckets.
Tolerance atol = rtol = 1e-5: every path sums in fp32, in another order.
Rows at or past q_len and dead slots must come out exactly 0.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops import ragged_paged_attention as k1

# the JAX package re-exports the function under the module's name
jax_k1 = importlib.import_module(
    "paddle_tpu.ops.pallas.ragged_paged_attention")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# tiny shapes: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

ATOL = RTOL = 1e-5


def _inputs(seed, B=3, T=8, n_kv=2, n_rep=1, d=16, ps=8, pages=6):
    """Pools of 1 + B * pages pages (page 0 scratch), each sequence's table
    a distinct random set of live pages; q [B, T, n_kv * n_rep, d]."""
    rng = np.random.default_rng(seed)
    nb = 1 + B * pages
    kp = rng.standard_normal((nb, ps, n_kv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, ps, n_kv, d)).astype(np.float32)
    tbl = rng.permutation(np.arange(1, nb)).reshape(B, pages).astype(np.int32)
    q = rng.standard_normal((B, T, n_kv * n_rep, d)).astype(np.float32)
    return q, kp, vp, tbl


def _port(q, kp, vp, tbl, starts, qlens):
    out = k1.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tbl), torch.tensor(starts, dtype=torch.int32),
        torch.tensor(qlens, dtype=torch.int32))
    return out.numpy()


def _jax(q, kp, vp, tbl, starts, qlens, interpret=True):
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tbl), jnp.asarray(starts, jnp.int32),
            jnp.asarray(qlens, jnp.int32))
    if interpret:
        return np.asarray(jax_k1.ragged_paged_attention(*args,
                                                        interpret=True))
    return np.asarray(jax_k1.ragged_reference(*args))


def _assert_dead_rows_zero(out, qlens):
    for b, ql in enumerate(qlens):
        assert (out[b, ql:] == 0.0).all(), f"sequence {b}: rows >= {ql}"


@pytest.mark.parametrize("q_len,start_pos", [
    (1, 0), (1, 7), (1, 8), (1, 37),        # decode at page boundaries
    (5, 0), (8, 0),                          # fresh prefill
    (3, 13), (8, 16), (6, 40),               # offset chunks
])
@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_plain_matches_jax_kernel_sweep(q_len, start_pos, n_rep):
    q, kp, vp, tbl = _inputs(seed=q_len * 100 + start_pos, n_rep=n_rep)
    # a second live span and a dead slot ride in the same launch
    starts = [start_pos, max(0, start_pos - 2), 5]
    qlens = [q_len, max(1, q_len - 1), 0]
    ours = _port(q, kp, vp, tbl, starts, qlens)
    np.testing.assert_allclose(ours, _jax(q, kp, vp, tbl, starts, qlens),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ours, _jax(q, kp, vp, tbl, starts, qlens, interpret=False),
        rtol=RTOL, atol=ATOL)
    _assert_dead_rows_zero(ours, qlens)


@pytest.mark.parametrize("pages,T", [(1, 8), (3, 16), (9, 32)])
def test_plain_matches_jax_over_page_counts_and_buckets(pages, T):
    """Longer tables and wider padded buckets: chunks that end mid-page,
    start past the first page and leave bucket rows unused."""
    ps = 8
    q, kp, vp, tbl = _inputs(seed=pages, B=3, T=T, n_rep=2, ps=ps,
                             pages=pages)
    cap = pages * ps
    starts = [0, max(0, cap - T), cap // 3]
    qlens = [min(T, cap), min(T - 3, cap - max(0, cap - T)), 1]
    ours = _port(q, kp, vp, tbl, starts, qlens)
    np.testing.assert_allclose(ours, _jax(q, kp, vp, tbl, starts, qlens),
                               rtol=RTOL, atol=ATOL)
    _assert_dead_rows_zero(ours, qlens)


def test_gqa_row_order_is_rep_major():
    """Grouped rows are (rep, t) flattened: distinct values per q head of
    one kv group must land on their own head, or MHA passes and GQA
    fails."""
    q, kp, vp, tbl = _inputs(seed=3, B=2, T=4, n_kv=1, n_rep=4)
    starts, qlens = [6, 0], [4, 3]
    ours = _port(q, kp, vp, tbl, starts, qlens)
    ref = _jax(q, kp, vp, tbl, starts, qlens)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    # the heads of one group really differ, so a transposed grouping
    # would not agree by accident
    assert np.abs(ref[0, :, 0] - ref[0, :, 1]).max() > 1e-2


def test_all_dead_batch_is_exact_zero_without_nan():
    q, kp, vp, tbl = _inputs(seed=5)
    tbl[:] = 0                                   # all-scratch tables
    ours = _port(q, kp, vp, tbl, [0, 0, 0], [0, 0, 0])
    assert np.isfinite(ours).all()
    assert (ours == 0.0).all()


def test_port_reference_matches_jax_reference():
    q, kp, vp, tbl = _inputs(seed=11, n_rep=2)
    starts, qlens = [3, 17, 0], [8, 2, 0]
    ours = k1.ragged_reference(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tbl), torch.tensor(starts, dtype=torch.int32),
        torch.tensor(qlens, dtype=torch.int32)).numpy()
    np.testing.assert_allclose(
        ours, _jax(q, kp, vp, tbl, starts, qlens, interpret=False),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("page_size", [1, 8, 16])
def test_attention_page_reads_matches_jax(page_size):
    rng = np.random.default_rng(page_size)
    starts = rng.integers(0, 200, 32)
    qlens = rng.integers(0, 40, 32)
    qlens[:4] = 0                                # dead slots read nothing
    np.testing.assert_array_equal(
        k1.attention_page_reads(starts, qlens, page_size),
        jax_k1.attention_page_reads(starts, qlens, page_size))


@pytest.mark.parametrize("d,n_q,n_kv", [
    (128, 32, 32), (128, 32, 8), (64, 8, 2), (12, 4, 4), (16, 6, 4),
    (8, 3, 1), (130, 2, 2),
])
def test_gate_matches_jax(d, n_q, n_kv):
    assert k1.ragged_attention_ok(d, n_q, n_kv) == \
        jax_k1.ragged_attention_ok(d, n_q, n_kv)


def test_wrapper_rejects_bad_shapes():
    q, kp, vp, tbl = _inputs(seed=2, B=2, n_rep=2)
    t = torch.from_numpy
    starts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        k1.ragged_paged_attention(t(q[:, :, :3]), t(kp), t(vp), t(tbl),
                                  starts, starts)
    with pytest.raises(ValueError, match="block_table"):
        k1.ragged_paged_attention(t(q), t(kp), t(vp), t(tbl[:1]), starts,
                                  starts)
    with pytest.raises(ValueError, match="q_len"):
        k1.ragged_paged_attention(t(q), t(kp), t(vp), t(tbl), starts,
                                  starts[:1])
