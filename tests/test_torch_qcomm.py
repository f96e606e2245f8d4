"""The port's quantized collectives against the JAX package, on the CPU.

`paddle_tpu_torch.quantization.qcomm` takes the list of per-shard tensors
where the JAX primitives take ``(x, axis_name)`` inside a shard_map body.
Its `quantized_psum` and `quantized_allgather` are held bit for bit
against the JAX module's numpy references (which need no shard_map) over
tp 2 and 4, chunks 4 and 128 and a width the chunk does not divide; the
error bound, shard-count invariance, row independence and outlier honesty
of tests/test_serving_qcomm.py hold for them; `allreduce_bytes` and
`allgather_bytes` equal the JAX functions; the plain `psum` /
`all_gather` of `parallel.mesh` and `SpecLayout`'s collective hooks are
pinned too.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.parallel.compat import SpecLayout as JaxSpecLayout
from paddle_tpu.quantization import qcomm as jq
from paddle_tpu_torch.parallel import SpecLayout, all_gather, psum
from paddle_tpu_torch.quantization import qcomm

rng = np.random.default_rng(15)


def _t(parts):
    return [torch.from_numpy(np.ascontiguousarray(p)) for p in parts]


def _one(outs):
    """The per-shard results, which must all be the same value."""
    first = outs[0].numpy()
    for o in outs[1:]:
        np.testing.assert_array_equal(o.numpy(), first)
    return first


@pytest.mark.parametrize("width", [16, 130])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("chunk", [4, 128])
def test_quantized_psum_matches_numpy_oracle(tp, chunk, width):
    parts = [rng.standard_normal((3, 5, width)).astype(np.float32) * (i + 1)
             for i in range(tp)]
    out = _one(qcomm.quantized_psum(_t(parts), chunk=chunk))
    np.testing.assert_array_equal(
        out, jq.quantized_allreduce_reference(parts, chunk=chunk))
    np.testing.assert_array_equal(
        out, qcomm.quantized_allreduce_reference(parts, chunk=chunk))


@pytest.mark.parametrize("width", [16, 130])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("chunk", [4, 128])
def test_quantized_allgather_matches_numpy_oracle(tp, chunk, width):
    parts = [rng.standard_normal((2, 3, width)).astype(np.float32)
             * 10.0 ** (i - 1) for i in range(tp)]
    out = _one(qcomm.quantized_allgather(_t(parts), chunk=chunk))
    assert out.shape == (2, 3, width * tp)
    np.testing.assert_array_equal(
        out, jq.quantized_allgather_reference(parts, chunk=chunk))
    np.testing.assert_array_equal(
        out, qcomm.quantized_allgather_reference(parts, chunk=chunk))


def test_bf16_parts_come_back_in_bf16():
    """Any float dtype goes in; the arithmetic is fp32 and the result
    comes back at the parts' dtype, as JAX casts it."""
    parts = [rng.standard_normal((4, 32)).astype(np.float32)
             for _ in range(2)]
    bf = [p.to(torch.bfloat16) for p in _t(parts)]
    out = qcomm.quantized_psum(bf, chunk=8)[0]
    assert out.dtype == torch.bfloat16
    ref = jq.quantized_allreduce_reference(
        [p.float().numpy() for p in bf], chunk=8)
    assert torch.equal(out, torch.from_numpy(ref).to(torch.bfloat16))


@pytest.mark.parametrize("tp", [2, 4])
def test_quantized_psum_error_bound_vs_fp32(tp):
    """Per-element error at most tp half code steps at the shared scale
    (the never-clip bound), and a few percent of the signal."""
    parts = [rng.standard_normal((4, 64)).astype(np.float32)
             for _ in range(tp)]
    out = _one(qcomm.quantized_psum(_t(parts), chunk=16))
    exact = np.sum(parts, axis=0)
    chunks = np.stack([p.reshape(4, 4, 16) for p in parts])
    scale = (np.abs(chunks).max(axis=-1) / 127.0).max(axis=0)
    bound = (tp * 0.5 + 1e-3) * np.repeat(scale, 16, axis=1).reshape(4, 64)
    assert (np.abs(out - exact) <= bound + 1e-6).all()
    assert np.abs(out - exact).max() <= 0.05 * np.abs(exact).max() + 1e-3


def test_quantized_psum_shard_count_invariance():
    global_parts = [rng.standard_normal((2, 32)).astype(np.float32)
                    for _ in range(4)]
    out4 = _one(qcomm.quantized_psum(_t(global_parts), chunk=8))
    merged = [global_parts[0] + global_parts[1],
              global_parts[2] + global_parts[3]]
    out2 = _one(qcomm.quantized_psum(_t(merged), chunk=8))
    exact = np.sum(global_parts, axis=0)
    scale = max(np.abs(p).max() for p in global_parts) / 127.0
    assert np.abs(out4 - exact).max() <= 5 * scale
    assert np.abs(out2 - exact).max() <= 4 * scale


@pytest.mark.parametrize("fn", ["quantized_psum", "quantized_allgather"])
def test_row_independence(fn):
    """A row's result is bit-identical whatever rows ride with it: the
    batch-shape invariance the engines' token-exactness leans on."""
    f = getattr(qcomm, fn)
    row = rng.standard_normal((1, 24)).astype(np.float32)
    noise = rng.standard_normal((3, 24)).astype(np.float32) * 100.0
    solo = _one(f(_t([row, row * 0.5]), chunk=8))
    batch = _one(f(_t([np.concatenate([row, noise]),
                       np.concatenate([row * 0.5, noise * 2.0])]), chunk=8))
    np.testing.assert_array_equal(solo[0], batch[0])


def test_quantized_psum_zeros_and_outlier_honesty():
    zeros = [np.zeros((2, 16), np.float32)] * 2
    np.testing.assert_array_equal(
        _one(qcomm.quantized_psum(_t(zeros), chunk=8)), zeros[0])
    a = np.zeros((1, 8), np.float32)
    a[0, 0] = 1000.0
    b = np.ones((1, 8), np.float32) * 3.0
    out = _one(qcomm.quantized_psum(_t([a, b]), chunk=8))
    assert abs(out[0, 0] - 1003.0) <= 1000.0 / 127.0 + 1e-3


def test_chunk_must_be_positive():
    parts = _t([np.ones((1, 4), np.float32)] * 2)
    for f in (qcomm.quantized_psum, qcomm.quantized_allgather):
        with pytest.raises(ValueError, match="chunk"):
            f(parts, chunk=0)


@pytest.mark.parametrize("rows,width,chunk", [
    (10, 64, 64), (1, 130, 64), (10, 256, 128), (10, 100, 64), (3, 5, 128),
    (7, 4096, 128), (1, 32000, 128)])
@pytest.mark.parametrize("comm_dtype", ["fp32", "int8"])
def test_byte_accounting_equals_jax(rows, width, chunk, comm_dtype):
    for ours, ref in ((qcomm.allreduce_bytes, jq.allreduce_bytes),
                      (qcomm.allgather_bytes, jq.allgather_bytes)):
        assert ours(rows, width, comm_dtype, chunk=chunk) == \
            ref(rows, width, comm_dtype, chunk=chunk)
    for fn in (qcomm.allreduce_bytes, qcomm.allgather_bytes):
        with pytest.raises(ValueError):
            fn(1, 1, "bf16")
    assert (qcomm.QCOMM_QMAX, qcomm.QCOMM_CHUNK, qcomm.COMM_DTYPES) == \
        (jq.QCOMM_QMAX, jq.QCOMM_CHUNK, jq.COMM_DTYPES)


def test_plain_collectives_and_layout_hooks():
    """fp32 hooks are the plain psum (shard-order sum) and the tiled
    gather; int8 the quantized pair; other comm dtypes raise as in JAX;
    the specs equal JAX's as tuples."""
    parts = [rng.standard_normal((3, 8)).astype(np.float32)
             for _ in range(3)]
    np.testing.assert_array_equal(
        _one(psum(_t(parts))), (parts[0] + parts[1]) + parts[2])
    np.testing.assert_array_equal(_one(all_gather(_t(parts))),
                                  np.concatenate(parts, axis=-1))
    assert SpecLayout().row_parallel_reduce() is psum
    assert SpecLayout().column_parallel_gather() is all_gather
    q = SpecLayout(comm_dtype="int8")
    assert q.row_parallel_reduce() is qcomm.quantized_psum
    assert q.column_parallel_gather() is qcomm.quantized_allgather
    for bad in (SpecLayout(comm_dtype="fp8"), JaxSpecLayout(comm_dtype="fp8")):
        for hook in (bad.row_parallel_reduce, bad.column_parallel_gather):
            with pytest.raises(ValueError, match="comm_dtype"):
                hook()
    ours, ref = SpecLayout(model_axis="tp"), JaxSpecLayout(model_axis="tp")
    for name in ("replicated", "embeddings", "column_parallel",
                 "row_parallel", "bias_column", "heads", "kv_pool"):
        assert tuple(getattr(ours, name)()) == tuple(getattr(ref, name)())
