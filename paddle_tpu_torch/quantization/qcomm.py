"""Quantized collectives for tensor-parallel serving.

Counterpart of paddle_tpu/quantization/qcomm.py, whose jnp code ports as
plain torch. `quantized_psum` replaces the fp32 allreduce behind every
row-parallel matmul, `quantized_allgather` the column-parallel gather of
the logits, both with the JAX module's two-level arithmetic: a
per-(row, chunk) abs-max over each shard's last axis, the max over the
shards as the shared scale (so no shard's values clip), codes rounded
half to even and clipped to +-127 at that scale, an int32 sum (psum) or a
tiled int8 gather, and one dequantizing multiply. Chunks run along each
row's last axis, never across rows, so a row's result is independent of
the batch it rides in. With that arithmetic the results are bit-equal to
the numpy references `quantized_allreduce_reference` and
`quantized_allgather_reference`. `allreduce_bytes` / `allgather_bytes`
are the per-shard wire accounting, scale bytes counted.

Departure: the port is single-controller, so a primitive takes the list
of per-shard tensors where JAX takes ``(x, axis_name)`` inside a
shard_map body, and returns the per-shard results (``chunk`` stays
keyword-only). Each reduction works one way: every shard's scale and
codes go to the first shard's device, are combined there in shard order,
and the result goes back to each shard (`parallel.mesh.to_first` /
`to_each`; no-ops on one device).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.parallel.mesh import to_each, to_first

# symmetric int8 range shared with the KV quantization
QCOMM_QMAX = 127.0

# elements per shared scale along the last axis: 4/128 scale bytes an
# element, a 3.88x wire reduction
QCOMM_CHUNK = 128

COMM_DTYPES = ("fp32", "int8")


def _check_comm_dtype(comm_dtype: str) -> None:
    if comm_dtype not in COMM_DTYPES:
        raise ValueError(f"comm_dtype={comm_dtype!r}; expected one of "
                         f"{COMM_DTYPES}")


def _quantize(parts: Sequence[torch.Tensor], chunk: int):
    """The shared first level: (per-shard int8 codes [R, C, c] on the
    first shard's device, the shared scale [R, C], width)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    width = parts[0].shape[-1]
    c = min(int(chunk), int(width))
    pad = (-width) % c
    chunked = []
    for p in parts:
        rows = p.float().reshape(-1, width)                  # [R, W]
        if pad:
            rows = F.pad(rows, (0, pad))
        chunked.append(rows.reshape(rows.shape[0], -1, c))   # [R, C, c]
    # divided by a tensor: a CUDA division by a host scalar multiplies by
    # its reciprocal, which rounds some quotients one ulp off the numpy
    # reference's
    qmax = torch.full((1,), QCOMM_QMAX, device=parts[0].device)
    local = to_first([ch.abs().amax(dim=-1) / qmax.to(ch.device)
                      for ch in chunked])
    scale = local[0]
    for s in local[1:]:                                      # the pmax
        scale = torch.maximum(scale, s)
    safe = scale.clamp(min=1e-30)[..., None]
    codes = to_first([torch.clamp(torch.round(ch / safe.to(ch.device)),
                                  -QCOMM_QMAX, QCOMM_QMAX).to(torch.int8)
                      for ch in chunked])
    return codes, scale, width


def quantized_psum(parts: Sequence[torch.Tensor], *,
                   chunk: int = QCOMM_CHUNK) -> List[torch.Tensor]:
    """Sum the shards' partial sums with int8 wire traffic. ``parts`` are
    the per-shard tensors (one shape, any float dtype, at least one axis);
    returns the allreduced sum on each shard's device, at the parts'
    dtype."""
    codes, scale, width = _quantize(parts, chunk)
    total = codes[0].to(torch.int32)
    for c in codes[1:]:
        total = total + c.to(torch.int32)
    out = total.float() * scale[..., None]
    out = out.reshape(out.shape[0], -1)[:, :width]
    return to_each(out.reshape(parts[0].shape).to(parts[0].dtype), parts)


def quantized_allgather(parts: Sequence[torch.Tensor], *,
                        chunk: int = QCOMM_CHUNK) -> List[torch.Tensor]:
    """Gather the shards' last-axis slices with int8 wire traffic: the full
    [..., width * shards] value, tiled in shard order, on each shard's
    device at the parts' dtype."""
    codes, scale, width = _quantize(parts, chunk)
    rows = scale.shape[0]
    slices = [(c.float() * scale[..., None]).reshape(rows, -1)[:, :width]
              for c in codes]
    out = torch.cat(slices, dim=-1)
    shape = parts[0].shape
    return to_each(out.reshape(*shape[:-1], -1).to(parts[0].dtype), parts)


def quantized_allreduce_reference(parts, *, chunk: int = QCOMM_CHUNK):
    """Numpy oracle of `quantized_psum` (the JAX module's, verbatim)."""
    parts = [np.asarray(p, np.float32) for p in parts]
    shape = parts[0].shape
    width = shape[-1]
    c = min(int(chunk), int(width))
    pad = (-width) % c
    rows = [p.reshape(-1, width) for p in parts]
    if pad:
        rows = [np.pad(r, ((0, 0), (0, pad))) for r in rows]
    chunks = [r.reshape(r.shape[0], -1, c) for r in rows]
    local = [np.abs(ch).max(axis=-1) / QCOMM_QMAX for ch in chunks]
    scale = np.maximum.reduce(local)
    safe = np.maximum(scale, 1e-30)[..., None]
    total = np.zeros_like(chunks[0], dtype=np.int32)
    for ch in chunks:
        total += np.clip(np.round(ch / safe),
                         -QCOMM_QMAX, QCOMM_QMAX).astype(np.int32)
    out = total.astype(np.float32) * scale[..., None]
    return out.reshape(total.shape[0], -1)[:, :width].reshape(shape)


def quantized_allgather_reference(parts, *, chunk: int = QCOMM_CHUNK):
    """Numpy oracle of `quantized_allgather` (the JAX module's,
    verbatim)."""
    parts = [np.asarray(p, np.float32) for p in parts]
    shape = parts[0].shape
    width = shape[-1]
    c = min(int(chunk), int(width))
    pad = (-width) % c
    rows = [p.reshape(-1, width) for p in parts]
    if pad:
        rows = [np.pad(r, ((0, 0), (0, pad))) for r in rows]
    chunks = [r.reshape(r.shape[0], -1, c) for r in rows]
    local = [np.abs(ch).max(axis=-1) / QCOMM_QMAX for ch in chunks]
    scale = np.maximum.reduce(local)
    safe = np.maximum(scale, 1e-30)[..., None]
    slices = []
    for ch in chunks:
        codes = np.clip(np.round(ch / safe),
                        -QCOMM_QMAX, QCOMM_QMAX).astype(np.int32)
        deq = codes.astype(np.float32) * scale[..., None]
        slices.append(deq.reshape(deq.shape[0], -1)[:, :width])
    out = np.concatenate(slices, axis=-1)
    return out.reshape(*shape[:-1], -1)


def allreduce_bytes(rows: int, width: int, comm_dtype: str,
                    *, chunk: int = QCOMM_CHUNK) -> int:
    """Wire bytes ONE shard contributes to one row-parallel allreduce of a
    [rows, width] activation: 4 a value at fp32; at int8 one code byte a
    value plus 4 bytes a (row, chunk) shared scale."""
    _check_comm_dtype(comm_dtype)
    rows, width = int(rows), int(width)
    if comm_dtype == "fp32":
        return rows * width * 4
    c = min(int(chunk), max(width, 1))
    return rows * width + rows * (-(-width // c)) * 4


def allgather_bytes(rows: int, width: int, comm_dtype: str,
                    *, chunk: int = QCOMM_CHUNK) -> int:
    """Wire bytes ONE shard contributes to one column-parallel all-gather
    of its [rows, width] slice, counted as `allreduce_bytes` counts."""
    return allreduce_bytes(rows, width, comm_dtype, chunk=chunk)
