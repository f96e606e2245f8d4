"""Autoregressive generation over a dense or a paged KV cache, the
gather reference path of paged attention, and the token samplers.

Counterpart of paddle_tpu/models/generation.py:

  _block_params, _layer_norm,   the functional GPT pieces over a flat
  _attn_with_cache, _mlp,       parameter dict (the JAX names and
  _forward_with_cache           [in, out] layout), shared with the
                                serving runner's GPTRunner
  _sample                       the serving path's sampler: one threefry
                                key per row (``key`` [..., 2])
  _sample_shared_key            the generators' sampler, JAX's `_sample`:
                                one key for the whole [b, V] batch, whose
                                Gumbel noise takes counters 0..b*V-1, as
                                jax.random.categorical(key, logits) draws
  masked_cache_attention,       the gather reference: every page of the
  paged_gather                  block table gathered into a contiguous
                                cache, then one dense masked softmax
  GPTGenerator                  prefill + per-token decode over a dense
                                [b, max_len, h, d] cache per layer, greedy,
                                temperature / top-k / top-p with a seed,
                                eos padding, beam search
  PagedKVCache, paged_write_*,  the same over a block-table paged cache,
  block_multihead_attention,    whose one-token decode attention is the
  PagedGPTGenerator             paged-decode kernel (K2)

The JAX functions return new caches; here the caches and pools are
written in place and the same tensors are returned, so the call shapes
stay the same; `_forward_paged` takes the pools and the block table and
returns the logits alone (the JAX package's `_CacheView`, a holder of the
pools its jitted steps return, has no use here). The decode loops run
eagerly (the JAX package jits each step), making each step's positions
on the device so the host never waits for the card between steps.
`block_multihead_attention` sends a one-token decode to K2
(`ops.paged_attention.paged_decode_attention`: the CUDA kernel on the
card, its plain version on the CPU); prefill and head dims K2 does not
tile take the gather path, in plain torch, as the JAX package computes
them outside Pallas. On the card a head dim K2 does not tile raises
unless the caller asked for ``attn_impl="reference"``.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models.gpt import DIST_ITEM, TP_ITEM
from paddle_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_ok,
)
from paddle_tpu_torch.ops.ragged_paged_attention import MAX_HEAD_DIM

logger = logging.getLogger(__name__)


def model_params(model, device=None) -> Dict[str, torch.Tensor]:
    """The model's parameters as the flat dict a generator or a serving
    runner serves, detached, moved to ``device`` when one is given."""
    dev = resolve_device(device) if device is not None else None
    return {k: (v.detach().to(dev) if dev is not None else v.detach())
            for k, v in model.named_parameters()}


def _block_params(all_params, i):
    """Block ``i``'s parameters without their ``blocks.{i}.`` prefix."""
    pre = f"blocks.{i}."
    return {k[len(pre):]: v for k, v in all_params.items()
            if k.startswith(pre)}


def _layer_norm(x, w, b, eps=1e-5):
    """LayerNorm with fp32 statistics, cast back to x's dtype before the
    gain and bias."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


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
    rows = torch.arange(t, device=q.device)[None, :, None]
    if isinstance(pos, torch.Tensor):
        q_pos = pos.to(q.device).reshape(-1, 1, 1).long() + rows
    else:   # a number: added on the device, no blocking host copy
        q_pos = int(pos) + rows
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


def _sample_shared_key(logits, key, temperature, top_k, top_p):
    """The JAX generators' `_sample` on logits [b, V] with ONE threefry key
    ([2]): the argmax at temperature 0, else argmax(gumbel(key, [b, V]) +
    `_masked_logits`), the counters of the noise running over the whole
    batch as jax.random.categorical draws them. Returns int64 [b]."""
    if temperature == 0.0:
        return torch.argmax(logits.float(), dim=-1)
    masked = _masked_logits(logits, temperature, top_k, top_p)
    noise = prandom.gumbel(key.to(logits.device), tuple(masked.shape))
    return torch.argmax(noise + masked, dim=-1)


def _qkv(p, x, n_heads: int):
    """The fused projection of x [b, t, H] split into contiguous q, k, v
    [b, t, n_heads, d] (the weight's columns in (3, n_heads, d) order)."""
    b, t, hdim = x.shape
    qkv = (x @ p["attn.qkv.weight"] + p["attn.qkv.bias"]).reshape(
        b, t, 3, n_heads, hdim // n_heads)
    return (qkv[:, :, j].contiguous() for j in range(3))


def _attn_with_cache(p, x, k_cache, v_cache, pos: int, n_heads: int):
    """x [b, t, H] at positions pos..pos+t-1; caches [b, L, h, d], this
    step's K/V written in place at pos. Returns (out [b, t, H], caches)."""
    t = x.shape[1]
    q, k, v = _qkv(p, x, n_heads)
    k_cache[:, pos:pos + t] = k
    v_cache[:, pos:pos + t] = v
    out = masked_cache_attention(q, k_cache, v_cache, pos)
    return out @ p["attn.out.weight"] + p["attn.out.bias"], k_cache, v_cache


def _mlp(p, x):
    """fc2(gelu_tanh(fc1(x))); a switch-MoE block raises."""
    if "mlp.gate" in p:
        raise NotImplementedError(
            f"a switch-MoE block (mlp.gate) is not ported yet: {DIST_ITEM}")
    h = F.gelu(x @ p["mlp.fc1.weight"] + p["mlp.fc1.bias"],
               approximate="tanh")
    return h @ p["mlp.fc2.weight"] + p["mlp.fc2.bias"]


def _embed(params, tokens, pos: int):
    """Token plus learned position embeddings of tokens [b, t] at
    positions pos..pos+t-1."""
    t = tokens.shape[1]
    positions = pos + torch.arange(t, device=tokens.device)
    return (F.embedding(tokens, params["wte.weight"])
            + params["wpe.weight"][positions])


def _head(params, x):
    """The final LayerNorm and the head (tied, or lm_head when untied)."""
    x = _layer_norm(x, params["ln_f.weight"], params["ln_f.bias"])
    if "lm_head.weight" in params:
        return x @ params["lm_head.weight"]
    return x @ params["wte.weight"].T


def _forward_with_cache(params, cfg, tokens, caches, pos: int):
    """tokens [b, t] at positions pos..; caches a list of (k, v) per
    layer, written in place. Returns (logits [b, t, V], caches)."""
    x = _embed(params, tokens, pos)
    for i in range(cfg.num_layers):
        p = _block_params(params, i)
        h = _layer_norm(x, p["ln1.weight"], p["ln1.bias"])
        a, _, _ = _attn_with_cache(p, h, caches[i][0], caches[i][1], pos,
                                   cfg.num_heads)
        x = x + a
        h = _layer_norm(x, p["ln2.weight"], p["ln2.bias"])
        x = x + _mlp(p, h)
    return _head(params, x), caches


def _topk(x, k: int):
    """jax.lax.top_k over the last axis: the k largest, the lower index
    first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class GPTGenerator:
    """Prefill + decode loop over a dense KV cache.

        gen = GPTGenerator(model); out = gen.generate(input_ids, ...)

    The generator serves the model's parameters (moved to ``device`` when
    given). The JAX generator shards over an active mesh; a ``mesh`` here
    raises, naming its ROADMAP item."""

    def __init__(self, model, max_len: Optional[int] = None, *, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                f"GPTGenerator(mesh=...): sharded generation is not ported "
                f"yet: {TP_ITEM}")
        self.model = model
        self.cfg = model.cfg
        self.max_len = max_len or self.cfg.max_seq_len
        self.params = model_params(model, device)
        self.device = self.params["wte.weight"].device

    def _empty_caches(self, batch):
        cfg = self.cfg
        d = cfg.hidden_size // cfg.num_heads
        shape = (batch, self.max_len, cfg.num_heads, d)
        dt = self.params["wte.weight"].dtype
        return [(torch.zeros(shape, dtype=dt, device=self.device),
                 torch.zeros(shape, dtype=dt, device=self.device))
                for _ in range(cfg.num_layers)]

    # the template's hooks: the paged generator overrides these five

    def _make_state(self, batch):
        return self._empty_caches(batch)

    @torch.no_grad()
    def _prefill_call(self, ids, state):
        logits, state = _forward_with_cache(self.params, self.cfg, ids,
                                            state, 0)
        return logits[:, -1], state

    def _decode_call(self, tok, state, pos, key, temperature, top_k, top_p):
        logits, state = self._decode_logits_call(tok, state, pos)
        return _sample_shared_key(logits, key, temperature, top_k,
                                  top_p), state

    @torch.no_grad()
    def _decode_logits_call(self, tok, state, pos):
        logits, state = _forward_with_cache(self.params, self.cfg,
                                            tok[:, None], state, pos)
        return logits[:, -1], state

    def _expand_state(self, state, b, k):
        """Tile the post-prefill state from b rows to b*k beam rows."""
        return [(kc.repeat_interleave(k, dim=0), vc.repeat_interleave(k, 0))
                for kc, vc in state]

    def _gather_state(self, state, idx):
        """Reorder every cache's leading (batch*beam) axis by idx."""
        return [(kc[idx], vc[idx]) for kc, vc in state]

    @torch.no_grad()
    def _beam_search(self, ids, max_new_tokens, num_beams, length_penalty,
                     eos_token_id):
        """The JAX `_beam_search`: beams fold into the batch axis, the
        cache reorder is a leading-axis gather after each step, finished
        beams continue with eos at zero added score, and the best beam per
        row wins under the GNMT length penalty."""
        b, t = ids.shape
        k = num_beams
        v = self.cfg.vocab_size
        dev = ids.device
        state = self._make_state(b)
        last_logits, state = self._prefill_call(ids, state)
        logp = torch.log_softmax(last_logits.float(), dim=-1)
        scores, tok0 = _topk(logp, k)                      # [b, k]
        state = self._expand_state(state, b, k)
        tokens = tok0.reshape(b * k)
        seqs = tokens[:, None]
        finished = (tokens == eos_token_id) if eos_token_id is not None \
            else torch.zeros(b * k, dtype=torch.bool, device=dev)
        eos_row = None
        if eos_token_id is not None:
            eos_row = torch.full((v,), -1e9, dtype=torch.float32, device=dev)
            eos_row[eos_token_id] = 0.0
        pos = t
        for _ in range(max_new_tokens - 1):
            logits, state = self._decode_logits_call(tokens, state, pos)
            logp = torch.log_softmax(logits.float(), dim=-1)
            if eos_row is not None:
                logp = torch.where(finished[:, None], eos_row[None], logp)
            total = scores.reshape(b * k, 1) + logp
            scores, idx = _topk(total.reshape(b, k * v), k)
            beam = idx // v
            gather = (torch.arange(b, device=dev)[:, None] * k
                      + beam).reshape(-1)
            state = self._gather_state(state, gather)
            seqs = seqs[gather]
            finished = finished[gather]
            tokens = (idx % v).reshape(-1)
            if eos_token_id is not None:
                finished = finished | (tokens == eos_token_id)
            seqs = torch.cat([seqs, tokens[:, None]], dim=1)
            pos += 1
            if eos_token_id is not None and bool(finished.all()):
                break
        gen_len = seqs.shape[1]
        if eos_token_id is not None:
            hit = seqs == eos_token_id
            lengths = torch.where(hit.any(dim=1),
                                  torch.argmax(hit.int(), dim=1) + 1,
                                  torch.full_like(hit[:, 0], gen_len,
                                                  dtype=torch.int64))
        else:
            lengths = torch.full((b * k,), gen_len, device=dev)
        norm = scores.reshape(-1) / (lengths.float() ** length_penalty)
        best = torch.argmax(norm.reshape(b, k), dim=1)
        pick = torch.arange(b, device=dev) * k + best
        return torch.cat([ids, seqs[pick]], dim=1)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=None, top_p=None, eos_token_id=None, seed=None,
                 num_beams=1, length_penalty=1.0):
        """The JAX `generate`: prefill, then one token per step, sampled
        through `_sample_shared_key` from key(seed) (or the default
        generator's next key), step i's key fold_in(key, i); rows past
        their eos keep emitting eos, and the loop ends once every row has
        finished. num_beams > 1 runs beam search. Returns int64 [b, t +
        new tokens] on the generator's device."""
        ids = torch.as_tensor(input_ids).to(self.device, torch.int64)
        if ids.dim() == 1:
            ids = ids[None]
        b, t = ids.shape
        assert t + max_new_tokens <= self.max_len
        if num_beams > 1:
            return self._beam_search(ids, max_new_tokens, num_beams,
                                     length_penalty, eos_token_id)
        state = self._make_state(b)
        last_logits, state = self._prefill_call(ids, state)
        key = (prandom.key(seed) if seed is not None
               else prandom.default_generator.next_key()).to(self.device)
        tok = _sample_shared_key(last_logits, key, temperature, top_k, top_p)
        finished = torch.zeros(b, dtype=torch.bool, device=self.device)
        if eos_token_id is not None:
            finished = tok == eos_token_id
        outs = [tok]
        pos = t
        for i in range(max_new_tokens - 1):
            key = prandom.fold_in(key, i)
            tok, state = self._decode_call(tok, state, pos, key, temperature,
                                           top_k, top_p)
            if eos_token_id is not None:
                tok = torch.where(finished, torch.full_like(tok,
                                                            eos_token_id),
                                  tok)
                finished = finished | (tok == eos_token_id)
            outs.append(tok)
            pos += 1
            if eos_token_id is not None and bool(finished.all()):
                break
        return torch.cat([ids, torch.stack(outs, dim=1)], dim=1)


# ==================================================================== paged KV

class PagedKVCache:
    """Block-table KV cache (the reference's block_multihead_attention
    layout): pools [num_blocks, block_size, h, d] per layer and an int32
    block table [b, blocks_per_seq]; sequence r owns the contiguous run
    of blocks [r * bps, (r + 1) * bps). ``sharding`` (the JAX cache's
    placement over a mesh) raises unless None."""

    def __init__(self, batch, max_len, n_heads, head_dim, n_layers, dtype,
                 block_size=64, sharding=None, *, device="cuda"):
        if sharding is not None:
            raise NotImplementedError(
                f"PagedKVCache(sharding=...): sharded pools are not ported "
                f"yet: {TP_ITEM}")
        assert max_len % block_size == 0
        dev = resolve_device(device)
        self.block_size = block_size
        self.blocks_per_seq = max_len // block_size
        num_blocks = batch * self.blocks_per_seq
        self.block_table = torch.arange(
            num_blocks, dtype=torch.int32, device=dev).reshape(
                batch, self.blocks_per_seq)
        shape = (num_blocks, block_size, n_heads, head_dim)
        self.pools = [(torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev))
                      for _ in range(n_layers)]


def paged_write_prefill(pool, block_table, kv, block_size):
    """Write [b, t, h, d] prefill keys/values from position 0 through the
    block table, in place. Returns the pool."""
    t = kv.shape[1]
    n_full, rem = divmod(t, block_size)
    table = block_table.long()
    for j in range(n_full):
        pool[table[:, j]] = kv[:, j * block_size:(j + 1) * block_size]
    if rem:
        pool[table[:, n_full], :rem] = kv[:, n_full * block_size:]
    return pool


def paged_write_token(pool, block_table, kv_tok, pos, block_size):
    """Write one [b, h, d] token at position ``pos`` (an int, a 0-d tensor
    or per-sequence [b] positions), in place. Returns the pool."""
    b = kv_tok.shape[0]
    if isinstance(pos, torch.Tensor):
        pos = pos.to(pool.device).long().expand(b)
    else:   # a fill on the device, no blocking host copy
        pos = torch.full((b,), int(pos), dtype=torch.int64,
                         device=pool.device)
    blk = torch.gather(block_table.long(), 1,
                       (pos // block_size)[:, None])[:, 0]
    pool[blk, pos % block_size] = kv_tok
    return pool


_PAGED_FALLBACK_WARNED: set = set()


def block_multihead_attention(q, k_pool, v_pool, block_table, pos,
                              scale=None, *, attn_impl: str = "auto"):
    """Attention of q [b, t, h, d] at offset ``pos`` over a paged KV cache
    whose current keys are already written; returns [b, t, h*d].

    t == 1 runs the paged-decode kernel (K2) straight off the pools, pos
    a scalar or [b] (keys at index <= pos visible). Prefill (t > 1), head
    dims K2 does not tile and ``attn_impl="reference"`` take the gather +
    dense-mask path. On the card a head dim K2 does not tile raises unless
    ``attn_impl="reference"``; on the CPU it warns once and gathers, as
    the JAX package does."""
    if attn_impl not in ("auto", "reference"):
        raise ValueError(f"attn_impl={attn_impl!r}; expected 'auto' or "
                         "'reference'")
    b, t, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if t == 1 and attn_impl == "auto":
        # the JAX gate, and the widest head the kernel is built for
        if paged_decode_ok(d) and d <= MAX_HEAD_DIM:
            out = paged_decode_attention(q[:, 0], k_pool, v_pool,
                                         block_table, pos, scale=scale)
            return out.reshape(b, 1, h * d)
        if q.device.type == "cuda":
            raise ValueError(
                f"block_multihead_attention: the CUDA paged-decode kernel "
                f"does not tile head_dim {d}; pass attn_impl='reference' "
                "to decode through the plain gather path")
        if d not in _PAGED_FALLBACK_WARNED:
            _PAGED_FALLBACK_WARNED.add(d)
            logger.warning("paged decode: head dim %d not tiled by the "
                           "paged kernel; gathering the whole cache", d)
    k = paged_gather(k_pool, block_table)
    v = paged_gather(v_pool, block_table)
    return masked_cache_attention(q, k, v, pos, scale=scale)


def _attn_paged(p, x, k_pool, v_pool, block_table, pos, n_heads,
                block_size, attn_impl="auto"):
    q, k, v = _qkv(p, x, n_heads)
    if x.shape[1] == 1:
        paged_write_token(k_pool, block_table, k[:, 0], pos, block_size)
        paged_write_token(v_pool, block_table, v[:, 0], pos, block_size)
    else:
        paged_write_prefill(k_pool, block_table, k, block_size)
        paged_write_prefill(v_pool, block_table, v, block_size)
    out = block_multihead_attention(q, k_pool, v_pool, block_table, pos,
                                    attn_impl=attn_impl)
    return out @ p["attn.out.weight"] + p["attn.out.bias"], k_pool, v_pool


def _forward_paged(params, cfg, tokens, pools, block_table, block_size,
                   pos: int, attn_impl="auto"):
    """tokens [b, t] at positions pos.. through the paged ``pools`` (a
    (k, v) pair per layer, written in place). Returns logits [b, t, V].
    A decode step makes its [b] int32 positions once, on the device, for
    every layer's writes and K2."""
    x = _embed(params, tokens, pos)
    if tokens.shape[1] == 1:
        pos = torch.full((tokens.shape[0],), pos, dtype=torch.int32,
                         device=tokens.device)
    for i in range(cfg.num_layers):
        p = _block_params(params, i)
        h = _layer_norm(x, p["ln1.weight"], p["ln1.bias"])
        a, _, _ = _attn_paged(p, h, pools[i][0], pools[i][1], block_table,
                              pos, cfg.num_heads, block_size, attn_impl)
        x = x + a
        h = _layer_norm(x, p["ln2.weight"], p["ln2.bias"])
        x = x + _mlp(p, h)
    return _head(params, x)


class PagedGPTGenerator(GPTGenerator):
    """GPTGenerator over the paged block-table KV cache: the same
    contract, the attention through `block_multihead_attention`. The
    block size is the largest divisor of max_len at most ``block_size``.
    ``attn_impl="reference"`` decodes through the gather path."""

    def __init__(self, model, max_len: Optional[int] = None,
                 block_size: int = 64, *, mesh=None, device=None,
                 attn_impl: str = "auto"):
        super().__init__(model, max_len=max_len, mesh=mesh, device=device)
        bs = min(block_size, self.max_len)
        while self.max_len % bs:   # largest divisor <= requested
            bs -= 1
        self.block_size = bs
        self.attn_impl = attn_impl

    @torch.no_grad()
    def _run_paged(self, tokens, state, pos):
        pools, table = state
        logits = _forward_paged(self.params, self.cfg, tokens, pools, table,
                                self.block_size, pos, self.attn_impl)
        return logits[:, -1], state

    def _make_state(self, batch):
        cfg = self.cfg
        cache = PagedKVCache(batch, self.max_len, cfg.num_heads,
                             cfg.hidden_size // cfg.num_heads,
                             cfg.num_layers,
                             self.params["wte.weight"].dtype,
                             block_size=self.block_size, device=self.device)
        return cache.pools, cache.block_table

    def _prefill_call(self, ids, state):
        return self._run_paged(ids, state, 0)

    def _decode_logits_call(self, tok, state, pos):
        return self._run_paged(tok[:, None], state, pos)

    # Beam hooks: pool axis 0 is the block index (batch * blocks_per_seq),
    # so a beam gather of rows is a gather of each row's whole block run;
    # the block table stays the identity mapping.

    def _row_to_block_idx(self, row_idx):
        bps = self.max_len // self.block_size
        return (row_idx[:, None] * bps + torch.arange(
            bps, device=row_idx.device)[None, :]).reshape(-1)

    def _expand_state(self, state, b, k):
        pools, _ = state
        rows = torch.arange(b, device=self.device).repeat_interleave(k)
        blocks = self._row_to_block_idx(rows)
        new_pools = [(kp[blocks], vp[blocks]) for kp, vp in pools]
        bps = self.max_len // self.block_size
        table = torch.arange(b * k * bps, dtype=torch.int32,
                             device=self.device).reshape(b * k, bps)
        return new_pools, table

    def _gather_state(self, state, idx):
        pools, table = state
        blocks = self._row_to_block_idx(idx)
        return [(kp[blocks], vp[blocks]) for kp, vp in pools], table
