"""Paged single-token decode attention for MHA models (K2).

Counterpart of paddle_tpu/ops/pallas/paged_attention.py. One decode token
per sequence attends over its pages through the block table: q [b, h, d];
pools [num_blocks, block_size, h, d]; block_table [b, pages] int32; pos
int32 [b] or one position for the whole batch (a Python int or a 0-d
tensor, broadcast to [b] on q's device, as the JAX kernel broadcasts it),
keys at positions <= pos visible (the current token's K/V is written
before the call). Returns [b, h, d]. q and the pools are all fp32 (K2),
all bf16 (K2-bf16, a bf16 runner's) or all fp16 (K2-fp16, an fp16
runner's); the output is in q's dtype, the softmax and the sums fp32, as
the Pallas kernel casts each tile to fp32.

`paged_decode_attention` launches csrc/paged_decode_attention.cu on a CUDA
tensor (its fp32, bf16 or fp16 instantiation, never a cast to another)
and runs `paged_decode_reference` on a CPU tensor. Each dtype counts its
own launches: `COUNTS` (fp32), `COUNTS_BF16` and `COUNTS_F16`. The kernel
cuts each sequence's visible keys into splits of KEYS_PER_SPLIT keys, scores
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
    HALF_DTYPES, LaunchCounts, check, library, refuse_interpret,
    require_launchable, stream_buffer,
)
from paddle_tpu_torch.ops.ragged_paged_attention import (
    MAX_HEAD_DIM, NEG_INF, ragged_attention_ok,
)

COUNTS = LaunchCounts()        # fp32 (K2)
COUNTS_BF16 = LaunchCounts()   # bf16 (K2-bf16)
COUNTS_F16 = LaunchCounts()    # fp16 (K2-fp16)

# dtype -> (launch counts, C entry point)
_VARIANTS = {
    torch.float32: (COUNTS, "paged_decode_attention_f32"),
    torch.bfloat16: (COUNTS_BF16, "paged_decode_attention_bf16"),
    torch.float16: (COUNTS_F16, "paged_decode_attention_f16"),
}


def counts_for(dtype) -> LaunchCounts:
    """The launch counts of the fp32, bf16 or fp16 kernel."""
    return _VARIANTS[dtype][0]

# keys of one split of a sequence's page walk (a multiple of SPLIT_TILE, the
# four warps' tiles of the kernel). A constant: a sequence's splits, and so
# its output bit for bit, never depend on the rest of the batch.
KEYS_PER_SPLIT = 256
SPLIT_TILE = 16

def _tickets(device, stream, n):
    """The stream's int32 ticket buffer of the split walks' last-split
    merges, at least n long, zero between calls (`_build.stream_buffer`;
    K1's split walk shares it). The capture stream is shared by every
    runner on the device (model_runner._capture_stream)."""
    return stream_buffer("tickets", device, stream, n, torch.int32,
                         zeroed=True)


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
    if q.dtype not in _VARIANTS or {k_pool.dtype, v_pool.dtype} != {q.dtype}:
        raise TypeError(f"paged_decode_attention takes q and pools all "
                        f"fp32, all bf16 or all fp16, got {q.dtype} over "
                        f"{k_pool.dtype} / {v_pool.dtype}")
    # the same operand rules on both devices (see ragged_paged_attention)
    half = q.dtype in HALF_DTYPES
    floats = (q, k_pool, v_pool)
    require_launchable("paged_decode_attention", () if half else floats,
                       (block_table, pos), halves=floats if half else ())
    counts, entry = _VARIANTS[q.dtype]
    if q.device.type == "cpu":
        counts.plain_launches += 1
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
    err = getattr(library(), entry)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        part.data_ptr(), _tickets(q.device, stream, b * h).data_ptr(), b, h,
        d, ps, P, ks, S, scale, stream.cuda_stream)
    check(err, "paged_decode_attention")
    counts.kernel_launches += 1
    return out


def paged_decode_reference(q, k_pool, v_pool, block_table, pos, scale=None):
    """Plain PyTorch version: gather the table's pages, mask keys past pos,
    dense softmax; in fp32 (fp64 for fp64 q), returned in q's dtype."""
    b, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k, v, L = _gather(q, k_pool, v_pool, block_table)
    s = torch.einsum("bhd,bLhd->bhL", q.to(k.dtype), k) * scale
    visible = torch.arange(L, device=q.device)[None, :] \
        <= pos.long()[:, None]                     # [b, L]
    s = torch.where(visible[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhL,bLhd->bhd", p, v).to(q.dtype)


def _gather(q, k_pool, v_pool, block_table):
    """The table's pages as [b, L, h, d] K and V in the plain versions'
    compute dtype (fp32; fp64 for fp64 q, the fp64 evaluation), and L."""
    b, h, d = q.shape
    idx = block_table.long()
    L = idx.shape[1] * k_pool.shape[1]
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    return (k_pool[idx].reshape(b, L, h, d).to(dt),
            v_pool[idx].reshape(b, L, h, d).to(dt), L)


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
    s = torch.einsum("bhd,bLhd->bhL", q.to(k.dtype), k) * scale
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
    return ((f[..., None] * acc).sum(dim=2) / den[..., None]).to(q.dtype)


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
