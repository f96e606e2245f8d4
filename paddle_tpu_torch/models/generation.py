"""The gather reference path of paged attention, and the token sampler.

Counterpart of three helpers of paddle_tpu/models/generation.py: the two
that the serving runner's ``attn_impl="reference"`` path uses (gather
every page of the block table into a contiguous cache, then one dense
masked softmax; O(table width) bytes per call, the kernels exist to
avoid it) and `_sample`, the temperature / top-k / top-p / categorical
draw every sampled token of the serving path goes through.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core import random as prandom


def _sample(logits, key, temperature, top_k, top_p):
    """The JAX package's `_sample`, op for op, on a [..., V] batch of rows
    with one threefry key per row (``key`` [..., 2], `core.random`): the
    argmax at temperature 0 (a number), else `core.random.categorical` of
    `_masked_logits`. Returns int64 tokens [...]."""
    if not isinstance(temperature, torch.Tensor) and temperature == 0.0:
        return torch.argmax(logits.float(), dim=-1)
    return prandom.categorical(
        key, _masked_logits(logits, temperature, top_k, top_p))


def _masked_logits(logits, temperature, top_k, top_p):
    """`_sample`'s logits before the draw. ``temperature`` is a number or
    an fp32 tensor broadcasting against the rows ([..., 1]); it divides
    the logits as a tensor on every device (torch turns a division by a
    CPU scalar on the card into a multiplication by its reciprocal, which
    rounds otherwise). top-k masks the logits below the k-th largest
    (from one sort); top-p masks those below the cutoff of the sorted
    softmax's cumulative sum, its index ``sum(cum < top_p)``, the softmax
    as ``exp(x - max) / sum``."""
    logits = logits.float()
    if not isinstance(temperature, torch.Tensor):
        temperature = torch.full((1,), float(temperature),
                                 dtype=torch.float32, device=logits.device)
    logits = logits / temperature
    neg_inf = torch.full_like(logits, float("-inf"))
    V = logits.shape[-1]
    if top_k is not None and top_k > 0:
        # jnp's sort(...)[..., -top_k] clamps an index past the front to 0
        kth = torch.sort(logits, dim=-1).values[..., max(V - top_k, 0)]
        logits = torch.where(logits < kth[..., None], neg_inf, logits)
    if top_p is not None and top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        un = torch.exp(sorted_l - sorted_l.max(dim=-1, keepdim=True).values)
        probs = un / un.sum(dim=-1, keepdim=True)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_l, -1, cutoff_idx.clamp(max=V - 1))
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits


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
