"""Weight-only int8 quantization and the int4 nibble packing.

Counterpart of paddle_tpu/quantization/int8.py:40-110 (`_pack_int4`,
`_unpack_int4`, `_weight_quantize`), the pieces the serving runner's
weight ladder uses. The scale and the codes follow the JAX arithmetic op
for op (an fp32 abs-max over the in-dim divided by qmax, a division by
max(scale, 1e-9), round half to even, a clip), so the codes and scales
are bit-equal to the JAX quantizer's on the same fp32 weight.
"""

from __future__ import annotations

import torch


def _pack_int4(q):
    """Pack two signed int4 rows per int8 byte along axis 0 (the in-dim):
    the low nibble holds the even row, the high nibble the odd row."""
    k = q.shape[0]
    if k % 2:
        raise ValueError(f"int4 packing needs an even in-dim, got {k}")
    lo = q[0::2].to(torch.int32) & 0xF
    hi = q[1::2].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def _unpack_int4(packed):
    """Inverse of `_pack_int4`: int8 [k // 2, n] -> the signed int4 values
    [k, n] (int8 dtype)."""
    p = packed.to(torch.int32) & 0xFF
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = lo - 16 * (lo >= 8).to(torch.int32)   # sign-extend the nibble
    hi = hi - 16 * (hi >= 8).to(torch.int32)
    k2, n = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * k2, n).to(torch.int8)


def _weight_quantize(w, algo="weight_only_int8", group_size=-1):
    """Per-output-channel symmetric abs-max quantization of a 2-D [in, out]
    weight: (codes int8 [in, out], scale [out] in w's dtype); with
    ``group_size`` > 0 one scale per group of in-rows ([in / group, out]);
    "int4" in ``algo`` packs the codes two a byte ([in // 2, out]).
    Non-2-D weights raise: the scales reduce over axis 0, so a fused-QKV
    weight in its (3, heads, d) layout must be flattened first."""
    if w.dim() != 2:
        raise ValueError(
            f"weight_quantize needs a 2-D [in, out] matrix, got shape "
            f"{tuple(w.shape)}: per-output-channel scales reduce over "
            "axis 0 (the in-dim); flatten a fused-QKV weight to [in, "
            "3*num_heads*head_dim] first")
    bits = 4 if "int4" in algo else 8
    qmax = 2.0 ** (bits - 1) - 1
    if group_size and group_size > 0:
        k, n = w.shape
        wg = w.reshape(k // group_size, group_size, n)
        scale = wg.abs().amax(dim=1) / qmax                 # [g, n]
        q = torch.clamp(torch.round(wg / scale.clamp(min=1e-9)[:, None, :]),
                        -qmax, qmax).reshape(k, n).to(torch.int8)
        return (_pack_int4(q) if bits == 4 else q), scale
    scale = w.abs().amax(dim=0) / qmax                      # [out]
    # zero channels (pruned, zero-init) quantize to 0, not NaN
    q = torch.clamp(torch.round(w / scale.clamp(min=1e-9)[None, :]),
                    -qmax, qmax).to(torch.int8)
    return (_pack_int4(q) if bits == 4 else q), scale
