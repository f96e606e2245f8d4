"""The gather reference path of paged attention.

Counterpart of the two helpers of paddle_tpu/models/generation.py that
the serving runner's ``attn_impl="reference"`` path uses: gather every
page of the block table into a contiguous cache, then one dense masked
softmax. O(table width) bytes per call; the kernels exist to avoid it.
"""

from __future__ import annotations

import math

import torch


def masked_cache_attention(q, k_cache, v_cache, pos, scale=None):
    """Causal attention of [b, t, h, d] queries at offset ``pos`` (a
    scalar or per-sequence [b] tensor) over a [b, L, h, d] cache. Query
    row i sees the keys at positions <= pos + i. Returns [b, t, h*d]."""
    b, t, h, d = q.shape
    L = k_cache.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qT = q.transpose(1, 2).float()                         # [b, h, t, d]
    kT = k_cache.transpose(1, 2).float()                   # [b, h, L, d]
    vT = v_cache.transpose(1, 2).float()
    s = torch.einsum("bhtd,bhLd->bhtL", qT, kT) * scale
    pos = torch.as_tensor(pos, device=q.device).reshape(-1, 1, 1).long()
    q_pos = pos + torch.arange(t, device=q.device)[None, :, None]
    mask = torch.arange(L, device=q.device)[None, None, :] <= q_pos
    s = torch.where(mask[:, None], s, torch.full_like(s, -1e30))
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bhtL,bhLd->bhtd", probs, vT).to(q.dtype)
    return out.transpose(1, 2).reshape(b, t, h * d)


def paged_gather(pool, block_table):
    """[num_blocks, bs, h, d] gathered through [b, P] to [b, P*bs, h, d]."""
    pages = pool[block_table.long()]                      # [b, P, bs, h, d]
    b, P, bs = pages.shape[:3]
    return pages.reshape(b, P * bs, *pages.shape[3:])
