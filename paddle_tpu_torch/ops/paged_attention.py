"""Paged single-token decode attention for MHA models (K2).

Counterpart of paddle_tpu/ops/pallas/paged_attention.py. One decode token
per sequence attends over its pages through the block table: q [b, h, d];
pools [num_blocks, block_size, h, d]; block_table [b, pages] int32; pos
int32 [b] or one position for the whole batch (a Python int or a 0-d
tensor, broadcast to [b] on q's device, as the JAX kernel broadcasts it),
keys at positions <= pos visible (the current token's K/V is written
before the call). Returns [b, h, d].

`paged_decode_attention` launches csrc/paged_decode_attention.cu on a CUDA
tensor and runs `paged_decode_reference` on a CPU tensor. The kernel cuts
each sequence's visible keys into splits of KEYS_PER_SPLIT keys, scores
the splits in parallel and merges them in split order;
`paged_decode_split_reference` is the plain twin of that algebra, for the
tests. `best_paged_impl` is the serving runner's single dispatch gate,
copied from the JAX package. Under a captured CUDA graph the launch
counts are credited per replay by the capturing runner (see
`_build.LaunchCounts`), and the ticket buffer must exist before the
capture (`_tickets`).
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.ops._build import (
    LaunchCounts, check, library, refuse_interpret, require_launchable,
)
from paddle_tpu_torch.ops.ragged_paged_attention import (
    MAX_HEAD_DIM, NEG_INF, ragged_attention_ok,
)

COUNTS = LaunchCounts()

# keys of one split of a sequence's page walk (a multiple of SPLIT_TILE, the
# four warps' tiles of the kernel). A constant: a sequence's splits, and so
# its output bit for bit, never depend on the rest of the batch.
KEYS_PER_SPLIT = 256
SPLIT_TILE = 16

# (device index, stream) -> int32 tickets of the kernel's last-split merge,
# zero between calls (the kernel resets each one it uses)
_TICKETS = {}


def _tickets(device, stream, n):
    """The stream's ticket buffer, at least n long. It is made (zeroed)
    outside any CUDA graph capture: made inside one, it would live in the
    graph's private pool and the graph would zero it on every replay. A
    capture's warm-up on the capture stream makes it first; a capture
    that finds none large enough raises."""
    key = (device.index, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_decode_attention: no ticket buffer of "
                f"{n} entries for this stream; run the step once on the "
                "capture stream (the warm-up) before capturing it")
        t = _TICKETS[key] = torch.zeros(max(n, 256), dtype=torch.int32,
                                        device=device)
    return t


def n_splits(pages_per_seq: int, page_size: int,
             keys_per_split: int = KEYS_PER_SPLIT) -> int:
    """Splits of the longest walk a [b, pages_per_seq] table allows."""
    return max(1, -(-pages_per_seq * page_size // keys_per_split))


def paged_decode_attention(q, k_pool, v_pool, block_table, pos, scale=None,
                           interpret=None):
    """One-token decode attention over a paged KV cache (MHA).
    ``interpret`` is the JAX flag (`_build.refuse_interpret`)."""
    refuse_interpret("paged_decode_attention", interpret, q)
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be [b, h, d] and pools [N, bs, h, d]; got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    b, h, d = q.shape
    if not isinstance(pos, torch.Tensor):      # one position for the batch
        pos = torch.full((b,), int(pos), dtype=torch.int32, device=q.device)
    elif pos.dim() == 0:
        pos = pos.to(q.device, torch.int32).expand(b).contiguous()
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
    ps, P, ks = k_pool.shape[1], block_table.shape[1], KEYS_PER_SPLIT
    S = n_splits(P, ps, ks)
    stream = torch.cuda.current_stream(q.device)
    out = torch.empty_like(q)
    # each split's (acc [d], m, l), read only where a sequence has several
    part = torch.empty(b * h * S * (d + 2), dtype=torch.float32,
                       device=q.device)
    err = library().paged_decode_attention_f32(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        part.data_ptr(), _tickets(q.device, stream, b * h).data_ptr(), b, h,
        d, ps, P, ks, S, scale, stream.cuda_stream)
    check(err, "paged_decode_attention")
    COUNTS.kernel_launches += 1
    return out


def paged_decode_reference(q, k_pool, v_pool, block_table, pos, scale=None):
    """Plain PyTorch version: gather the table's pages, mask keys past pos,
    dense softmax."""
    b, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k, v, L = _gather(q, k_pool, v_pool, block_table)
    s = torch.einsum("bhd,bLhd->bhL", q, k) * scale
    visible = torch.arange(L, device=q.device)[None, :] \
        <= pos.long()[:, None]                     # [b, L]
    s = torch.where(visible[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhL,bLhd->bhd", p, v)


def _gather(q, k_pool, v_pool, block_table):
    """The table's pages as [b, L, h, d] K and V in q's dtype (fp64
    operands give the fp64 evaluation), and L."""
    b, h, d = q.shape
    idx = block_table.long()
    L = idx.shape[1] * k_pool.shape[1]
    return (k_pool[idx].reshape(b, L, h, d).to(q.dtype),
            v_pool[idx].reshape(b, L, h, d).to(q.dtype), L)


def paged_decode_split_reference(q, k_pool, v_pool, block_table, pos,
                                 scale=None, keys_per_split=KEYS_PER_SPLIT):
    """Plain twin of the kernel's split-and-merge algebra (tests only).

    Sequence b's visible keys (positions <= pos[b], capped at the table's
    P * page_size; none for pos < 0) are cut at multiples of
    ``keys_per_split``. Split s keeps m_s = its max score, l_s = sum
    exp(score - m_s) and acc_s = sum exp(score - m_s) v over its own keys;
    a split with no visible key keeps m_s = NEG_INF, l_s = 0, acc_s = 0.
    The merge, over every split of the table in split order: M = max m_s,
    f_s = exp(m_s - M), out = sum f_s acc_s / max(sum f_s l_s, 1e-30), so
    an empty split adds nothing and a sequence without keys gets zeros."""
    b, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k, v, L = _gather(q, k_pool, v_pool, block_table)
    S = n_splits(block_table.shape[1], k_pool.shape[1], keys_per_split)
    pad = S * keys_per_split - L
    s = torch.einsum("bhd,bLhd->bhL", q, k) * scale
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    n = pos.long().clamp(min=-1, max=L - 1) + 1               # [b]
    visible = torch.arange(S * keys_per_split, device=q.device)[None, :] \
        < n[:, None]
    s = torch.where(visible[:, None, :], s, torch.full_like(s, NEG_INF))
    s = s.reshape(b, h, S, keys_per_split)
    m = s.max(dim=-1).values                                  # [b, h, S]
    p = torch.where(s <= NEG_INF * 0.5, torch.zeros_like(s),
                    torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhSk,bSkhd->bhSd", p,
                       v.reshape(b, S, keys_per_split, h, d))
    f = torch.exp(m - m.max(dim=-1, keepdim=True).values)
    den = (f * l).sum(dim=-1).clamp(min=1e-30)
    return (f[..., None] * acc).sum(dim=2) / den[..., None]


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
