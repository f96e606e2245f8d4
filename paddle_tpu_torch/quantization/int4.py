"""Packed int4 weight-only quantization with group-wise scales.

Counterpart of paddle_tpu/quantization/int4.py, op for op in torch (the
reference wrote it as jnp code the XLA compiler fuses, not as a Pallas
kernel). One fp32 scale per `group_size` reduction rows per output
channel (default 128) bounds an outlier to its own group.

Storage layout (the serving runner's params-dict contract):

  codes   int8 [ceil(in/2), out]: `_pack_int4`'s nibbles (low = even
          in-row, high = odd in-row);
  scales  fp32 [out, n_groups], n_groups = ceil(in / group_size): the
          out-dim leads, as the int8 per-channel scale vector's does.

`int4_matmul` keeps the JAX grouped epilogue: a partial product per
group, each multiplied by its scale before the groups are summed, which
equals `x @ int4_dequantize(codes, scales)` by linearity. Its partials
take R x n_groups x out elements of x's dtype (R the rows of x).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.quantization.int8 import _pack_int4, _unpack_int4

# symmetric signed-int4 code range [-7, 7] (-8 unused: negation is exact)
INT4_QMAX = 7.0

# default reduction-dim group size: 4 bytes of scale per 64 bytes of codes
INT4_GROUP_SIZE = 128


def _check_2d(w, what: str = "int4_quantize"):
    if w.dim() != 2:
        raise ValueError(
            f"{what} needs a 2-D [in, out] matrix, got shape "
            f"{tuple(w.shape)}: group scales reduce over axis 0 (the "
            "in-dim); flatten a fused-QKV weight to [in, 3*num_heads*"
            "head_dim] first")


def _group_geometry(k: int, group_size: int):
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    g = min(int(group_size), int(k))
    return g, -(-int(k) // g)


def int4_quantize(w, group_size: int = INT4_GROUP_SIZE):
    """A 2-D [in, out] weight -> (codes int8 [in // 2, out], scales fp32
    [out, ceil(in / group_size)]): symmetric abs-max per (group, output
    channel), a partial last group padded with zeros for its abs-max. The
    in-dim must be even."""
    _check_2d(w)
    k, n = w.shape
    g, n_groups = _group_geometry(k, group_size)
    wf = F.pad(w.float(), (0, 0, 0, n_groups * g - k))
    wg = wf.reshape(n_groups, g, n)                         # [G, g, n]
    scale = wg.abs().amax(dim=1) / INT4_QMAX                # [G, n]
    # zero groups (pruned, padded) quantize to 0, not NaN
    q = torch.clamp(torch.round(wg / scale.clamp(min=1e-9)[:, None, :]),
                    -INT4_QMAX, INT4_QMAX)
    q = q.reshape(n_groups * g, n)[:k].to(torch.int8)
    return _pack_int4(q), scale.T.float().contiguous()      # [n, G]


def int4_matmul(x, codes, scale, group_size: int = INT4_GROUP_SIZE):
    """`x @ int4_dequantize(codes, scale)` through the grouped epilogue:
    unpack the nibbles, one partial product per group of in-rows, each
    scaled by its group's scale, then the groups summed. x: [..., in] of
    any float dtype; returns [..., out] in x's dtype."""
    q = _unpack_int4(codes)                                 # [k, n] int8
    k, n = q.shape
    g, n_groups = _group_geometry(k, group_size)
    lead = x.shape[:-1]
    pad = n_groups * g - k
    xr = F.pad(x.reshape(-1, k), (0, pad))
    wg = F.pad(q, (0, 0, 0, pad)).reshape(n_groups, g, n).to(x.dtype)
    xg = xr.reshape(xr.shape[0], n_groups, g).transpose(0, 1)   # [G, R, g]
    part = torch.bmm(xg, wg)                                # [G, R, n]
    out = (part * scale.T[:, None, :].to(x.dtype)).sum(dim=0)
    return out.reshape(*lead, n)


def int4_dequantize(codes, scale, group_size: int = INT4_GROUP_SIZE):
    """Packed codes and group scales back to the fp32 [in, out] weight
    (tests and debugging; serving feeds `int4_matmul`)."""
    q = _unpack_int4(codes)
    k, n = q.shape
    g, n_groups = _group_geometry(k, group_size)
    wg = F.pad(q, (0, 0, 0, n_groups * g - k)).reshape(
        n_groups, g, n).float()
    return (wg * scale.float().T[:, None, :]).reshape(n_groups * g, n)[:k]


def int4_dequantize_reference(codes, scale,
                              group_size: int = INT4_GROUP_SIZE):
    """Pure-numpy oracle of `int4_dequantize` (numpy in and out, or any
    array numpy reads)."""
    p = np.asarray(codes).astype(np.int32) & 0xFF
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = lo - 16 * (lo >= 8)
    hi = hi - 16 * (hi >= 8)
    k2, n = p.shape
    q = np.stack([lo, hi], axis=1).reshape(2 * k2, n)
    k = q.shape[0]
    s = np.asarray(scale, np.float32)
    g, n_groups = _group_geometry(k, group_size)
    pad = n_groups * g - k
    if pad:
        q = np.pad(q, ((0, pad), (0, 0)))
    wg = q.reshape(n_groups, g, n).astype(np.float32)
    return (wg * s.T[:, None, :]).reshape(n_groups * g, n)[:k]


def int4_weight_bytes(k: int, n: int,
                      group_size: int = INT4_GROUP_SIZE) -> int:
    """Resident bytes of one quantized [k, n] weight: the packed codes
    plus the fp32 group scales."""
    g, n_groups = _group_geometry(int(k), group_size)
    return (int(k) // 2) * int(n) + int(n) * n_groups * 4
