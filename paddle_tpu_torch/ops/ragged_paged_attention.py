"""Ragged paged attention: the serving path's prefill/GQA kernel (K1).

Counterpart of paddle_tpu/ops/pallas/ragged_paged_attention.py, over fp32
pools (K1) and over quantized pools (K1-q): int8 codes with k_scale /
v_scale [num_pages, n_kv] fp32 (one scale per page per kv head), or
float8_e4m3fn pools. One call computes causal attention for a ragged
batch of query spans straight off the paged K/V pools: decode steps
(q_len = 1), prefill chunks (q_len = chunk at an offset), and dead batch
slots (q_len = 0). Quantized pages are dequantized inside the page walk
(code * scale[page, kv head], or the fp8 value as fp32); the softmax and
the output stay fp32.

Layout: q [B, T, n_q, d] (T is the padded span length); pools
[num_pages, page_size, n_kv, d]; block_table [B, P] int32; start_pos and
q_len [B] int32. Query row t of sequence b attends the keys at positions
<= start_pos[b] + t. Rows at or past q_len produce exact zeros. GQA serves
the n_q / n_kv query heads of a kv head from one page walk.

`ragged_paged_attention` is the wrapper: on a CUDA tensor it launches the
hand-written kernel in csrc/ragged_paged_attention.cu for the pools'
dtype, in the form `ragged_form` picks from the grouped rows G = n_rep *
T (the span form on the tensor cores for prefill chunks and GQA spans,
the key-parallel decode form for G <= DECODE_ROWS); on a CPU tensor it
runs `ragged_reference`, the plain gather + dense-mask version with the
same output contract, which computes in q's dtype (fp64 operands give the
fp64 oracle the card's accuracy gate uses). There is no other path. Each
pool dtype counts its own launches: `COUNTS` (fp32 pools), `COUNTS_I8`
and `COUNTS_F8`, with the kernel launches of each form under
`form_launches`. A launch inside a captured CUDA graph counts at its
capture; the capturing runner takes that count back out and credits it
on every replay (`_build.counts_delta`). The output is allocated per
call, so under a graph it is the graph's buffer, which each replay
overwrites.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.ops._build import (
    LaunchCounts, check, library, refuse_interpret, require_launchable,
)

NEG_INF = -1e30
# the widest head the kernels hold in registers (they refuse wider ones)
MAX_HEAD_DIM = 256

# G = n_rep * T at or below this takes the decode form (kDecodeRows in
# csrc/ragged_paged_attention.cu)
DECODE_ROWS = 8
# the C side's form argument
_FORMS = {"span": 0, "decode": 1}

COUNTS = LaunchCounts()        # fp32 pools (K1)
COUNTS_I8 = LaunchCounts()     # int8 pools + scales (K1-q)
COUNTS_F8 = LaunchCounts()     # float8_e4m3fn pools (K1-q)

# pool dtype -> (launch counts, C entry point)
_VARIANTS = {
    torch.float32: (COUNTS, "ragged_paged_attention_f32"),
    torch.int8: (COUNTS_I8, "ragged_paged_attention_i8"),
    torch.float8_e4m3fn: (COUNTS_F8, "ragged_paged_attention_f8"),
}


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


def _check_scales(k_pool, v_pool, k_scale, v_scale):
    """int8 pools take both scale pools [num_pages, n_kv]; fp32 and fp8
    pools take none."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if k_pool.dtype != v_pool.dtype or k_pool.dtype not in _VARIANTS:
        raise TypeError(f"ragged_paged_attention takes fp32, int8 or "
                        f"float8_e4m3fn pools of one dtype, got "
                        f"{k_pool.dtype} / {v_pool.dtype}")
    if (k_pool.dtype == torch.int8) != (k_scale is not None):
        raise ValueError(f"{k_pool.dtype} pools: int8 pools need k_scale "
                         "and v_scale, fp32 and fp8 pools take none")
    if k_scale is not None:
        want = (k_pool.shape[0], k_pool.shape[2])
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(t.shape) != want:
                raise ValueError(f"{name} must be {list(want)} (one scale "
                                 f"per page per kv head), got "
                                 f"{tuple(t.shape)}")


def ragged_paged_attention(q, k_pool, v_pool, block_table, start_pos, q_len,
                           scale=None, interpret=None, k_scale=None,
                           v_scale=None):
    """Causal attention for a ragged batch of query spans over paged KV.
    q is fp32; the pools fp32, int8 (with k_scale / v_scale) or
    float8_e4m3fn. Returns [B, T, n_q, d] fp32. ``interpret`` is the JAX
    flag (`_build.refuse_interpret`)."""
    refuse_interpret("ragged_paged_attention", interpret, q)
    _check_shapes(q, k_pool, v_pool, block_table, start_pos, q_len)
    _check_scales(k_pool, v_pool, k_scale, v_scale)
    B, T, n_q, d = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu "
                         f"tensors, got {q.device}")
    scales = () if k_scale is None else (k_scale, v_scale)
    if any(t.device != q.device for t in scales):
        raise ValueError("ragged_paged_attention: the scales lie on another "
                         "device than q")
    # the same operand rules on both devices, so a CPU run refuses what
    # the kernel would refuse
    quantized = k_pool.dtype != torch.float32
    require_launchable(
        "ragged_paged_attention", (q,) if quantized else (q, k_pool, v_pool),
        (block_table, start_pos, q_len),
        codes=(k_pool, v_pool) if quantized else (), scales=scales)
    counts, entry = _VARIANTS[k_pool.dtype]
    if q.device.type == "cpu":
        counts.plain_launches += 1
        return ragged_reference(q, k_pool, v_pool, block_table, start_pos,
                                q_len, scale, k_scale, v_scale)
    _, page_size, n_kv, _ = k_pool.shape
    if not ragged_attention_ok(d, n_q, n_kv) or d > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA ragged kernel takes head_dim % 8 == 0 "
                         f"and <= {MAX_HEAD_DIM}; got {d}")
    form = ragged_form(n_q // n_kv, T)
    out = torch.empty_like(q)
    pools = (k_pool.data_ptr(), v_pool.data_ptr(),
             *(t.data_ptr() for t in scales))
    err = getattr(library(), entry)(
        q.data_ptr(), *pools, block_table.data_ptr(), start_pos.data_ptr(),
        q_len.data_ptr(), out.data_ptr(), B, T, n_q, n_kv, d, page_size,
        block_table.shape[1], _FORMS[form], scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "ragged_paged_attention")
    counts.count_kernel(form)
    return out


def ragged_form(n_rep: int, T: int) -> str:
    """The kernel form for a launch of G = n_rep * T grouped rows per kv
    head: "decode" (one block per sequence and kv head, its warps splitting
    the keys, on the CUDA cores) for G <= DECODE_ROWS, where the page
    bytes bound the work; "span" (tiles of 32 rows on the tensor cores)
    above, where the products do."""
    return "decode" if n_rep * T <= DECODE_ROWS else "span"


def ragged_attention_ok(head_dim: int, n_q_heads: int,
                        n_kv_heads: int) -> bool:
    """Kernel tiling gate (same rule as the JAX package): the head dim
    8-aligned, and the query heads splitting evenly over the KV heads."""
    return head_dim % 8 == 0 and n_q_heads % max(1, n_kv_heads) == 0


def dequantize_pages(pool, pages, scale=None, dtype=torch.float32):
    """Gather pool[pages] ([..., page_size, n_kv, d]) in ``dtype`` (fp32,
    or fp64 for the oracle): int8 codes times their page's per-kv-head
    scale, fp8 values cast, float pools as they are."""
    if pool.dtype == torch.float8_e4m3fn:   # gathered as bytes
        return pool.view(torch.uint8)[pages].view(pool.dtype).to(dtype)
    out = pool[pages].to(dtype)
    if scale is not None:
        out = out * scale[pages].to(dtype).unsqueeze(-2).unsqueeze(-1)
    return out


def ragged_reference(q, k_pool, v_pool, block_table, start_pos, q_len,
                     scale=None, k_scale=None, v_scale=None):
    """Plain PyTorch version of the kernel: gather every table page (and
    dequantize it), mask, dense softmax. Padded rows and dead slots
    produce exact zeros. It computes in q's dtype: fp32 for fp32 q, fp64
    for fp64 q (with fp64 float pools, or 1-byte pools and their scales,
    which fp64 holds exactly)."""
    B, T, n_q, d = q.shape
    page_size, n_kv = k_pool.shape[1], k_pool.shape[2]
    n_rep = n_q // n_kv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    idx = block_table.long()
    L = idx.shape[1] * page_size
    dt = q.dtype
    kg = dequantize_pages(k_pool, idx, k_scale, dt).reshape(B, L, n_kv, d)
    vg = dequantize_pages(v_pool, idx, v_scale, dt).reshape(B, L, n_kv, d)
    if n_rep > 1:
        kg = kg.repeat_interleave(n_rep, dim=2)
        vg = vg.repeat_interleave(n_rep, dim=2)
    start = start_pos.long().reshape(-1)
    qlen = q_len.long().reshape(-1)
    qT = q.transpose(1, 2)                         # [B, nq, T, d]
    kT = kg.transpose(1, 2)                        # [B, nq, L, d]
    vT = vg.transpose(1, 2)
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
    out = torch.einsum("bhtL,bhLd->bhtd", p, vT)
    return out.transpose(1, 2).contiguous()


def attention_page_reads(start_pos, q_len, page_size: int):
    """Pages one launch reads per sequence: pages [0, last visible page],
    nothing for dead slots (host-side analytics, numpy in and out)."""
    start = np.asarray(start_pos, np.int64).reshape(-1)
    qlen = np.asarray(q_len, np.int64).reshape(-1)
    last = np.maximum(start + qlen - 1, 0)
    return np.where(qlen > 0, last // page_size + 1, 0)
