"""Ragged paged attention: the serving path's prefill/GQA kernel (K1).

Counterpart of paddle_tpu/ops/pallas/ragged_paged_attention.py (fp32
pools). One call computes causal attention for a ragged batch of query
spans straight off the paged K/V pools: decode steps (q_len = 1),
prefill chunks (q_len = chunk at an offset), and dead batch slots
(q_len = 0).

Layout: q [B, T, n_q, d] (T is the padded span length); pools
[num_pages, page_size, n_kv, d]; block_table [B, P] int32; start_pos and
q_len [B] int32. Query row t of sequence b attends the keys at positions
<= start_pos[b] + t. Rows at or past q_len produce exact zeros. GQA serves
the n_q / n_kv query heads of a kv head from one page walk.

`ragged_paged_attention` is the wrapper: on a CUDA tensor it launches the
hand-written kernel in csrc/ragged_paged_attention.cu, on a CPU tensor it
runs `ragged_reference`, the plain gather + dense-mask version with the
same output contract. There is no other path.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.ops._build import (
    LaunchCounts, check, library, require_launchable,
)

NEG_INF = -1e30
# the widest head the kernels hold in registers (they refuse wider ones)
MAX_HEAD_DIM = 256

COUNTS = LaunchCounts()


def _check_shapes(q, k_pool, v_pool, block_table, start_pos, q_len):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"q must be [B, T, n_q, d] and pools [N, ps, n_kv, "
                         f"d]; got {tuple(q.shape)} and "
                         f"{tuple(k_pool.shape)}")
    B, _, n_q, d = q.shape
    if v_pool.shape != k_pool.shape or k_pool.shape[3] != d:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match head_dim {d}")
    if n_q % k_pool.shape[2]:
        raise ValueError(f"n_q_heads={n_q} not a multiple of "
                         f"n_kv_heads={k_pool.shape[2]}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be [{B}, P], got "
                         f"{tuple(block_table.shape)}")
    for name, t in (("start_pos", start_pos), ("q_len", q_len)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be [{B}], got {tuple(t.shape)}")
    devices = {t.device for t in (q, k_pool, v_pool, block_table, start_pos,
                                  q_len)}
    if len(devices) != 1:
        raise ValueError(f"ragged_paged_attention: operands on several "
                         f"devices {sorted(map(str, devices))}")


def ragged_paged_attention(q, k_pool, v_pool, block_table, start_pos, q_len,
                           scale=None):
    """Causal attention for a ragged batch of query spans over paged KV.
    Returns [B, T, n_q, d] in q's dtype."""
    _check_shapes(q, k_pool, v_pool, block_table, start_pos, q_len)
    B, T, n_q, d = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu "
                         f"tensors, got {q.device}")
    # the same operand rules on both devices, so a CPU run refuses what
    # the kernel would refuse
    require_launchable("ragged_paged_attention", (q, k_pool, v_pool),
                       (block_table, start_pos, q_len))
    if q.device.type == "cpu":
        COUNTS.plain_launches += 1
        return ragged_reference(q, k_pool, v_pool, block_table, start_pos,
                                q_len, scale)
    _, page_size, n_kv, _ = k_pool.shape
    if not ragged_attention_ok(d, n_q, n_kv) or d > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA ragged kernel takes head_dim % 8 == 0 "
                         f"and <= {MAX_HEAD_DIM}; got {d}")
    out = torch.empty_like(q)
    err = library().ragged_paged_attention_f32(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), start_pos.data_ptr(), q_len.data_ptr(),
        out.data_ptr(), B, T, n_q, n_kv, d, page_size, block_table.shape[1],
        scale, torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "ragged_paged_attention")
    COUNTS.kernel_launches += 1
    return out


def ragged_attention_ok(head_dim: int, n_q_heads: int,
                        n_kv_heads: int) -> bool:
    """Kernel tiling gate (same rule as the JAX package): the head dim
    8-aligned, and the query heads splitting evenly over the KV heads."""
    return head_dim % 8 == 0 and n_q_heads % max(1, n_kv_heads) == 0


def ragged_reference(q, k_pool, v_pool, block_table, start_pos, q_len,
                     scale=None):
    """Plain PyTorch version of the kernel: gather every table page, mask,
    dense softmax. Padded rows and dead slots produce exact zeros."""
    B, T, n_q, d = q.shape
    page_size, n_kv = k_pool.shape[1], k_pool.shape[2]
    n_rep = n_q // n_kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    idx = block_table.long()
    L = idx.shape[1] * page_size
    kg = k_pool[idx].reshape(B, L, n_kv, d)        # [B, L, n_kv, d]
    vg = v_pool[idx].reshape(B, L, n_kv, d)
    if n_rep > 1:
        kg = kg.repeat_interleave(n_rep, dim=2)
        vg = vg.repeat_interleave(n_rep, dim=2)
    start = start_pos.long().reshape(-1)
    qlen = q_len.long().reshape(-1)
    qT = q.transpose(1, 2).float()                 # [B, nq, T, d]
    kT = kg.transpose(1, 2).float()                # [B, nq, L, d]
    vT = vg.transpose(1, 2).float()
    s = torch.einsum("bhtd,bhLd->bhtL", qT, kT) * scale
    t_idx = torch.arange(T, device=q.device)
    q_pos = start[:, None] + t_idx[None, :]        # [B, T]
    k_pos = torch.arange(L, device=q.device)
    visible = ((k_pos[None, None, :] <= q_pos[:, :, None])
               & (t_idx[None, :, None] < qlen[:, None, None]))  # [B, T, L]
    s = torch.where(visible[:, None], s, torch.full_like(s, NEG_INF))
    row_live = (s > NEG_INF * 0.5).any(dim=-1, keepdim=True)
    p = torch.where(row_live, torch.softmax(s, dim=-1),
                    torch.zeros_like(s))
    out = torch.einsum("bhtL,bhLd->bhtd", p, vT).to(q.dtype)
    return out.transpose(1, 2).contiguous()


def attention_page_reads(start_pos, q_len, page_size: int):
    """Pages one launch reads per sequence: pages [0, last visible page],
    nothing for dead slots (host-side analytics, numpy in and out)."""
    start = np.asarray(start_pos, np.int64).reshape(-1)
    qlen = np.asarray(q_len, np.int64).reshape(-1)
    last = np.maximum(start + qlen - 1, 0)
    return np.where(qlen > 0, last // page_size + 1, 0)
