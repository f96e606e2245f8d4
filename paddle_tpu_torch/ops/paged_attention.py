"""Paged single-token decode attention for MHA models (K2).

Counterpart of paddle_tpu/ops/pallas/paged_attention.py. One decode token
per sequence attends over its pages through the block table: q [b, h, d];
pools [num_blocks, block_size, h, d]; block_table [b, pages] int32; pos [b]
int32, keys at positions <= pos visible (the current token's K/V is written
before the call). Returns [b, h, d].

`paged_decode_attention` launches csrc/paged_decode_attention.cu on a CUDA
tensor and runs `paged_decode_reference` on a CPU tensor. `best_paged_impl`
is the serving runner's single dispatch gate, copied from the JAX package.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.ops._build import (
    LaunchCounts, check, library, require_launchable,
)
from paddle_tpu_torch.ops.ragged_paged_attention import (
    MAX_HEAD_DIM, NEG_INF, ragged_attention_ok,
)

COUNTS = LaunchCounts()


def paged_decode_attention(q, k_pool, v_pool, block_table, pos, scale=None):
    """One-token decode attention over a paged KV cache (MHA)."""
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be [b, h, d] and pools [N, bs, h, d]; got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    b, h, d = q.shape
    if v_pool.shape != k_pool.shape or tuple(k_pool.shape[2:]) != (h, d):
        raise ValueError(f"pools {tuple(k_pool.shape)} must carry the "
                         f"query's {h} heads of dim {d} (MHA only)")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or tuple(pos.shape) != (b,):
        raise ValueError(f"block_table must be [{b}, P] and pos [{b}]; got "
                         f"{tuple(block_table.shape)} and "
                         f"{tuple(pos.shape)}")
    devices = {t.device for t in (q, k_pool, v_pool, block_table, pos)}
    if len(devices) != 1:
        raise ValueError(f"paged_decode_attention: operands on several "
                         f"devices {sorted(map(str, devices))}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"paged_decode_attention runs on cuda or cpu "
                         f"tensors, got {q.device}")
    # the same operand rules on both devices (see ragged_paged_attention)
    require_launchable("paged_decode_attention", (q, k_pool, v_pool),
                       (block_table, pos))
    if q.device.type == "cpu":
        COUNTS.plain_launches += 1
        return paged_decode_reference(q, k_pool, v_pool, block_table, pos,
                                      scale)
    if not paged_decode_ok(d) or d > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA paged-decode kernel takes head_dim % 8 "
                         f"== 0 and <= {MAX_HEAD_DIM}; got {d}")
    out = torch.empty_like(q)
    err = library().paged_decode_attention_f32(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h, d,
        k_pool.shape[1], block_table.shape[1], scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "paged_decode_attention")
    COUNTS.kernel_launches += 1
    return out


def paged_decode_reference(q, k_pool, v_pool, block_table, pos, scale=None):
    """Plain PyTorch version: gather the table's pages, mask keys past pos,
    dense softmax."""
    b, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    idx = block_table.long()
    L = idx.shape[1] * k_pool.shape[1]
    k = k_pool[idx].reshape(b, L, h, d).float()
    v = v_pool[idx].reshape(b, L, h, d).float()
    s = torch.einsum("bhd,bLhd->bhL", q.float(), k) * scale
    visible = torch.arange(L, device=q.device)[None, :] \
        <= pos.long()[:, None]                     # [b, L]
    s = torch.where(visible[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhL,bLhd->bhd", p, v).to(q.dtype)


def paged_decode_ok(h_dim: int) -> bool:
    """Kernel tiling gate: the head dim 8-aligned."""
    return h_dim % 8 == 0


def best_paged_impl(head_dim: int, n_heads: int, n_kv_heads: int,
                    q_len: int):
    """Which paged kernel serves this attention shape: the single-token MHA
    decode kernel wins its exact shape; the ragged kernel covers GQA,
    chunked prefill and mixed spans. Returns "paged_decode" | "ragged" |
    None (None = no kernel tiles; callers take the gather path)."""
    if q_len == 1 and n_heads == n_kv_heads and paged_decode_ok(head_dim):
        return "paged_decode"
    if ragged_attention_ok(head_dim, n_heads, n_kv_heads):
        return "ragged"
    return None
