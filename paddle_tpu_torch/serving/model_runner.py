"""Model runners: paged-KV step functions for the serving engine.

Counterpart of paddle_tpu/serving/model_runner.py for fp32 Llama and GPT
on one device, over fp32, int8 or fp8 KV pools (``kv_dtype``). A runner
adapts a model's flat parameter dict into the step functions the engine
calls over the shared page pool:

  prefill(tokens, table_row, pools)                 -> (logits[V], pools)
  prefill_chunk(tokens, start_pos, table_row, pools) -> (logits[V], pools)
  decode(tokens[B], tables[B, P], pos[B], pools)     -> (logits[B, V], pools)
  decode_multi(tokens, tables, pos, pools, s, ...)   -> (packed[2|3, B, s],
                                                         pools)

`decode_multi` is the device-resident horizon: s decode steps in one
call, each step's token (the argmax, or a seeded sample with
``horizon_sampling``) fed back on the device, drained by the engine as
one packed int32 buffer. Each inner step is `decode`'s body: the same
`_forward`, `paged_attend` and kernels.

Every step writes this step's K/V through the block table, then attends
through one of three paths chosen per span bucket by `_attn_impl_for`:
the ragged paged-attention kernel (prefill chunks, GQA decode), the
single-token paged-decode kernel (MHA decode), or the gather + dense-mask
reference. "auto" resolves exactly as `best_paged_impl` says on every
device, except that int8 and fp8 pools never go to the paged-decode
kernel (it has no dequantize step): their MHA decode takes the ragged
kernel, as in the JAX package. On CUDA tensors the wrappers launch the
CUDA kernels, on CPU tensors they run their plain versions. A shape no
kernel tiles takes the gather path on the CPU and raises on CUDA unless
the caller asked for attn_impl="reference". Chunk lengths are padded to
power-of-2 buckets (`bucket_len`); padded positions write to the scratch
page and their logits are never read. Dead decode slots carry
all-scratch tables, so they self-neutralize without a mask.

Where the port departs from the JAX package:
  * in-place pools: JAX writes the pools functionally (`.at[].set`) and
    the runner returns new pools; here `paged_attend` writes them in
    place with `index_put_` and the steps still return `(logits, pools)`
    (the same list), so the call signatures stay the same. A retried
    step rewrites the same slots with the same values (an int8 write
    re-derives the same scales and codes), so retries stay idempotent;
  * dispatch: the JAX package's shape-keyed jit cache (`_jitted`)
    becomes `_graphed`, a cache of captured CUDA graphs of the decode
    kinds ("decode", "decode_multi", "decode_multi_x"), keyed by the
    jit key plus the pools' addresses (a graph writes the pools it was
    captured on). Host operands go through pinned staging buffers into
    the graph's static inputs before each replay; the output buffer is
    the graph's own, so a caller drains it before the same graph
    replays again. Prefill chunks run eagerly. On CPU tensors (or with
    ``graphs`` set False) every kind runs eagerly: the caller's choice.
    On the card a capture or replay that fails raises; nothing retries
    eagerly;
  * the horizon loop is a Python loop of the decode body (the JAX
    `lax.scan`), inside one graph on the card.

The instrumented-pool counters (`attn_kv_bytes_read` /
`attn_kv_bytes_gather`) account the pool bytes each dispatch touches vs
what the gather path would read, host-side from the call's operands.
"""

from __future__ import annotations

import logging
import os
import time
from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.models.generation import (
    _block_params, _head, _layer_norm, _mlp, _qkv, _sample,
    masked_cache_attention, model_params, paged_gather,
)
from paddle_tpu_torch.models.gpt import GPT
from paddle_tpu_torch.models.llama import Llama, rope_tables
from paddle_tpu_torch.ops._build import (
    counts_credit, counts_delta, counts_snapshot,
)
from paddle_tpu_torch.ops.paged_attention import (
    best_paged_impl, paged_decode_attention,
)
from paddle_tpu_torch.ops.ragged_paged_attention import (
    attention_page_reads, dequantize_pages, ragged_attention_ok,
    ragged_paged_attention,
)
from paddle_tpu_torch.serving.kv_cache import (
    SCRATCH_PAGE, check_kv_dtype, fp8_page_write, quantized_page_write,
)

logger = logging.getLogger(__name__)


def bucket_len(t: int, minimum: int = 8) -> int:
    """Power-of-2 length bucket shared by every prefill path."""
    b = minimum
    while b < t:
        b *= 2
    return b


def paged_attend(q, k_new, v_new, layer_pools, tables, write_page,
                 write_off, pos_q, q_len, n_rep: int, impl: str,
                 shard_ctx=None):
    """Write this step's K/V through the block table, then attend.

    q: [B, T, n_h, d]; k_new/v_new: [B, T, n_kv, d]; layer_pools: one
    layer's pool tuple, written IN PLACE: fp32 or float8_e4m3fn (k_pool,
    v_pool) (fp8 appends are a pure cast, `fp8_page_write`), or int8
    (k_codes, v_codes, k_scale, v_scale) (`quantized_page_write`
    quantizes at append time; the attend paths dequantize with the
    per-page-per-head scales); tables: [B, P] int32; write_page/
    write_off: [B, T] int64; pos_q: [B] int32 context position of q row
    0; q_len: [B] int32 live rows per span. impl is the resolved
    attention path ("reference" | "paged_decode" | "ragged"). shard_ctx,
    the JAX (mesh, model_axis) of a sharded runner, raises unless None
    (ROADMAP.md item 10). Returns ([B, T, n_h*d], layer_pools)."""
    if shard_ctx is not None:
        raise NotImplementedError(
            "paged_attend(shard_ctx=...): kernels mapped over a mesh's "
            "model axis are not ported yet: ROADMAP.md 'Still to port' "
            "item 10 (tensor-parallel serving)")
    k_pool, v_pool = layer_pools[:2]
    scales = (None, None)
    if len(layer_pools) == 4:
        scales = layer_pools[2:]
        quantized_page_write(k_pool, scales[0], write_page, write_off, k_new)
        quantized_page_write(v_pool, scales[1], write_page, write_off, v_new)
    elif k_pool.dtype == torch.float8_e4m3fn:
        fp8_page_write(k_pool, write_page, write_off, k_new)
        fp8_page_write(v_pool, write_page, write_off, v_new)
    else:
        k_pool[write_page, write_off] = k_new
        v_pool[write_page, write_off] = v_new
    B, T = q.shape[0], q.shape[1]
    if impl == "paged_decode":
        if k_pool.dtype != torch.float32:
            raise ValueError("paged_decode has no int8/fp8-pool path: "
                             "_attn_impl_for routes quantized pools to the "
                             "ragged kernel or the gather reference")
        out = paged_decode_attention(q[:, 0], k_pool, v_pool, tables, pos_q)
        return out.reshape(B, 1, -1), layer_pools
    if impl == "ragged":
        out = ragged_paged_attention(q, k_pool, v_pool, tables, pos_q, q_len,
                                     k_scale=scales[0], v_scale=scales[1])
        return out.reshape(B, T, -1), layer_pools
    if k_pool.dtype == torch.float32:
        kg = paged_gather(k_pool, tables)
        vg = paged_gather(v_pool, tables)
    else:   # dequantize the gathered pages with their page/head scales
        idx = tables.long()
        kg = dequantize_pages(k_pool, idx, scales[0]).flatten(1, 2)
        vg = dequantize_pages(v_pool, idx, scales[1]).flatten(1, 2)
    if n_rep > 1:  # GQA: repeat kv groups up to the query heads
        kg = kg.repeat_interleave(n_rep, dim=2)
        vg = vg.repeat_interleave(n_rep, dim=2)
    return masked_cache_attention(q, kg, vg, pos_q), layer_pools


def check_weight_dtype(weight_dtype: str) -> None:
    """Only fp32 weights are ported: the weight ladder raises."""
    if weight_dtype != "fp32":
        raise NotImplementedError(
            f"weight_dtype={weight_dtype!r}: only fp32 weights are ported; "
            "the weight ladder (int8, int4, fp8) is ROADMAP.md 'Still to "
            "port' item 8 (quantized serving)")


def check_weight_group_size(weight_group_size: int) -> None:
    """The JAX runners' default of 128 rows per weight scale is accepted;
    another value only matters to the weight ladder, which raises."""
    if weight_group_size != 128:
        raise NotImplementedError(
            f"weight_group_size={weight_group_size!r}: grouped weight "
            "scales belong to the weight ladder (int4, int8, fp8), "
            "ROADMAP.md 'Still to port' item 8 (quantized serving)")


class _CudaGraph:
    """A torch.cuda.CUDAGraph captured on the runner's capture stream."""

    def __init__(self, stream):
        self.graph = torch.cuda.CUDAGraph()
        self.stream = stream

    def capture(self, fn):
        with torch.cuda.graph(self.graph, stream=self.stream):
            return fn()

    def replay(self) -> None:
        self.graph.replay()

    def pool_bytes(self) -> int:
        """Bytes of the segments of the graph's private memory pool."""
        pool = tuple(self.graph.pool())
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


class CapturedStep:
    """One captured step: its static operands on the device, their pinned
    host staging, the graph, its output buffer and the launch counts one
    replay credits (what the capture added, taken back out at capture)."""

    def __init__(self, graph, operands, staging, out, credit, seconds,
                 pool_bytes):
        self.graph = graph
        self.operands = operands
        self.staging = staging
        self.out = out
        self.credit = credit
        self.seconds = seconds
        self.pool_bytes = pool_bytes
        self._copied = None     # event after the last staging copies

    def replay(self, host):
        """Copy the host operands in, replay, credit the launch counts;
        returns the graph's output buffer (the next replay overwrites
        it). A staging buffer is rewritten only once the copy that read
        it last has run."""
        if self._copied is not None:
            self._copied.synchronize()
        for a, pin, dev in zip(host, self.staging, self.operands):
            if pin is None:
                dev.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            else:
                pin.numpy()[...] = a
                dev.copy_(pin, non_blocking=True)
        if self.staging and self.staging[0] is not None:
            self._copied = torch.cuda.Event()
            self._copied.record()
        self.graph.replay()
        counts_credit(self.credit)
        return self.out


def capture_step(body, host, pools, device, graph):
    """Run ``body(pools, *operands)`` once for real on the host operands,
    then capture it into ``graph`` (a `_CudaGraph`, or an object with the
    same capture(fn) / replay()). The real call is the warm-up: it runs
    on the capture stream, so it builds the kernel library and makes
    every lazily allocated buffer (the K2 ticket buffer of that stream)
    outside the capture, and its launches count as any call's. The
    captured launches did not run, so their counts are taken back out
    and credited per replay. Returns (the step, the real call's output)."""
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    staging = [None] * len(host)
    operands = []
    for i, a in enumerate(host):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if cuda:
            staging[i] = t.pin_memory()
        operands.append(t.to(device))
    stream = getattr(graph, "stream", None)
    if stream is not None:
        main = torch.cuda.current_stream(device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            first = body(pools, *operands)
        main.wait_stream(stream)
        first.record_stream(main)
    else:
        first = body(pools, *operands)
    before = counts_snapshot()
    out = graph.capture(lambda: body(pools, *operands))
    credit = counts_delta(before, counts_snapshot())
    counts_credit(credit, -1)
    if cuda:
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    pool_bytes = graph.pool_bytes() if hasattr(graph, "pool_bytes") else 0
    step = CapturedStep(graph, operands, staging, out, credit, seconds,
                        pool_bytes)
    return step, first


def _pools_key(pools) -> tuple:
    """The pools' addresses, shapes and dtypes: a graph writes the pools it
    was captured on, or any that later lie at the same addresses."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for layer in pools for t in layer)


class PagedModelRunner:
    """Shared runner chassis: write-index math, dispatch, byte counters.

    Subclasses set the architecture fields in __init__ and implement
    `_forward(tokens, positions, write_page, write_off, tables, pos_q,
    q_lens, pools) -> (logits[B, T, V], pools)`.
    """

    num_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int

    ATTN_IMPLS = ("auto", "pallas", "ragged", "reference")

    def __init__(self, params: Dict[str, torch.Tensor], block_size: int,
                 max_model_len: int, attn_impl: str = "auto",
                 kv_dtype: str = "fp32", weight_dtype: str = "fp32",
                 weight_group_size: int = 128):
        if attn_impl not in self.ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}; expected one of "
                             f"{self.ATTN_IMPLS}")
        check_kv_dtype(kv_dtype, type(self).__name__)
        check_weight_dtype(weight_dtype)
        check_weight_group_size(weight_group_size)
        self.weight_group_size = weight_group_size
        self.params = params
        self.block_size = block_size
        self.max_model_len = max_model_len
        self.attn_impl = attn_impl
        # the engine builds its pools with the runner's kv_dtype
        self.kv_dtype = kv_dtype
        self.device = next(iter(params.values())).device
        self.dtype = torch.float32
        self._impl_logged: set = set()
        # instrumented-pool counters: device bytes of KV pool the chosen
        # attention path touches vs what the gather path would have read
        self.attn_kv_bytes_read = 0.0
        self.attn_kv_bytes_gather = 0.0
        # CUDA graphs of the decode kinds on the card (`_graphed`); False
        # runs them eagerly there too
        self.graphs = True
        self._graph_cache: "OrderedDict[tuple, CapturedStep]" = OrderedDict()
        self._capture_stream = None
        # one entry per capture: kind, key, seconds, graph pool bytes
        self.captures: List[dict] = []

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads

    # --------------------------------------------------------- dispatch

    def _attn_impl_for(self, q_len_bucket: int) -> str:
        """Resolve the attention path for one (padded) query-span length.
        "auto" and "pallas" take the kernel `best_paged_impl` names;
        "ragged" forces the ragged kernel; "reference" forces the gather
        path. Where no kernel tiles the shape, a CPU runner takes the
        gather path as the JAX package does, and a CUDA runner raises: on
        the card only an explicit "reference" runs the plain path. The
        chosen impl is logged once per bucket so a serve's dispatch is
        auditable."""
        if self.attn_impl == "reference":
            impl = "reference"
        elif self.attn_impl == "ragged":
            impl = ("ragged" if ragged_attention_ok(
                self.head_dim, self.n_heads, self.n_kv_heads) else None)
        else:
            impl = best_paged_impl(self.head_dim, self.n_heads,
                                   self.n_kv_heads, q_len_bucket)
        if self.kv_dtype in ("int8", "fp8") and impl == "paged_decode":
            # the paged-decode kernel has no dequantize step: int8 and fp8
            # pools take the ragged kernel, which dequantizes in its walk
            impl = ("ragged" if ragged_attention_ok(
                self.head_dim, self.n_heads, self.n_kv_heads) else None)
        if impl is None:
            if self.device.type == "cuda":
                raise ValueError(
                    f"attn_impl={self.attn_impl!r}: no CUDA attention kernel "
                    f"tiles head_dim {self.head_dim} with {self.n_heads} "
                    f"query / {self.n_kv_heads} kv heads (q_len bucket "
                    f"{q_len_bucket}); pass attn_impl='reference' to serve "
                    "this model through the plain gather path")
            impl = "reference"
        key = (q_len_bucket, impl)
        if key not in self._impl_logged:
            self._impl_logged.add(key)
            logger.info(
                "serving attention impl: %s (q_len bucket %d, heads %d/%d, "
                "head_dim %d, attn_impl=%s, device %s)", impl, q_len_bucket,
                self.n_heads, self.n_kv_heads, self.head_dim, self.attn_impl,
                self.device)
        return impl

    def _kv_page_bytes(self) -> int:
        """Device bytes ONE page costs this runner's attention per call:
        int8 pools count the code bytes PLUS the per-page-per-head scale
        bytes the dequantize reads, fp8 pools one byte per element."""
        data = self.block_size * self.n_kv_heads * self.head_dim
        if self.kv_dtype == "int8":
            return 2 * self.num_layers * (data + self.n_kv_heads * 4)
        if self.kv_dtype == "fp8":
            return 2 * self.num_layers * data
        return 2 * self.num_layers * data * self.dtype.itemsize

    def _account_attn(self, impl: str, starts, q_lens, table_width: int):
        """Bump the instrumented-pool counters for one step call: the
        kernels read only each span's live pages; the gather path reads
        every table entry of every slot."""
        per_page = self._kv_page_bytes()
        gather_pages = len(np.asarray(starts).reshape(-1)) * table_width
        if impl in ("paged_decode", "ragged"):
            pages = int(attention_page_reads(starts, q_lens,
                                             self.block_size).sum())
        else:
            pages = gather_pages
        self.attn_kv_bytes_read += pages * per_page
        self.attn_kv_bytes_gather += gather_pages * per_page

    def reset_attn_counters(self) -> None:
        self.attn_kv_bytes_read = 0.0
        self.attn_kv_bytes_gather = 0.0

    # ------------------------------------------------------------- steps

    def _stage(self, *host_arrays):
        """Copy host operands to the runner's device, one copy each."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in host_arrays)

    def _write_indices(self, positions, tables, valid):
        """positions/valid: [B, T]; tables: [B, P] -> page/off [B, T]
        int64. Invalid positions are redirected to the scratch page."""
        page = torch.gather(tables.long(), 1, positions // self.block_size)
        page = torch.where(valid, page, torch.full_like(page, SCRATCH_PAGE))
        return page, positions % self.block_size

    @torch.no_grad()
    def prefill(self, tokens: List[int], table_row: List[int], pools):
        """Run one sequence's (re-)prefill; returns (last_logits[V], pools)."""
        return self.prefill_chunk(tokens, 0, table_row, pools)

    @torch.no_grad()
    def prefill_chunk(self, tokens: List[int], start_pos: int,
                      table_row: List[int], pools):
        """Compute context positions [start_pos, start_pos + len(tokens))
        for one sequence, attending over everything the block table
        already holds. Returns the logits of the chunk's LAST position
        plus the (updated in place) pools."""
        t = len(tokens)
        tb = bucket_len(t)
        padded = np.zeros((1, tb), np.int64)
        padded[0, :t] = tokens
        self._account_attn(self._attn_impl_for(tb), np.asarray([start_pos]),
                           np.asarray([t]), len(table_row))
        toks, table, span = self._stage(
            padded, np.asarray(table_row, np.int32)[None],
            np.asarray([start_pos, t], np.int32))
        offs = torch.arange(tb, device=self.device)[None, :]      # [1, T]
        valid = offs < t
        positions = torch.where(valid, start_pos + offs,
                                torch.zeros_like(offs))
        page, off = self._write_indices(positions, table, valid)
        logits, pools = self._forward(toks, positions, page, off, table,
                                      span[:1], span[1:], pools)
        return logits[0, t - 1], pools

    # --------------------------------------------------- graphs (kinds)

    def _use_graphs(self) -> bool:
        return self.graphs and self.device.type == "cuda"

    def _new_graph(self):
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        return _CudaGraph(self._capture_stream)

    def _graphed(self, kind: str, shape_key, body, host, pools):
        """The counterpart of the JAX runner's `_jitted`: the captured
        step of (kind, shape_key) on these pools. Its first call runs the
        step for real and captures it (`capture_step`), later calls
        replay it. Every capture is logged; PADDLE_TPU_MAX_JIT_CACHE
        bounds the entries with LRU eviction. Returns the step's output."""
        key = (kind, shape_key, _pools_key(pools))
        step = self._graph_cache.get(key)
        if step is not None:
            self._graph_cache.move_to_end(key)
            return step.replay(host)
        step, first = capture_step(body, host, pools, self.device,
                                   self._new_graph())
        self._graph_cache[key] = step
        self.captures.append(dict(kind=kind, key=shape_key,
                                  seconds=step.seconds,
                                  pool_bytes=step.pool_bytes))
        logger.info("serving graph capture %s key=%s in %.3f s, graph pool "
                    "%d bytes (cache entries: %d)", kind, shape_key,
                    step.seconds, step.pool_bytes, len(self._graph_cache))
        cap = int(os.environ.get("PADDLE_TPU_MAX_JIT_CACHE", "0") or "0")
        if cap > 0:
            while len(self._graph_cache) > cap:
                evicted, _ = self._graph_cache.popitem(last=False)
                logger.warning(
                    "serving graph cache over PADDLE_TPU_MAX_JIT_CACHE=%d; "
                    "evicting %s", cap, evicted[:2])
        return first

    def _launch(self, kind: str, shape_key, body, host, pools):
        """``body(pools, *operands)`` on the host operands (numpy):
        eagerly, or through its graph."""
        if not self._use_graphs():
            return body(pools, *self._stage(*host))
        return self._graphed(kind, shape_key, body, host, pools)

    # ----------------------------------------------------- decode bodies

    def _decode_body(self, pools, tokens, tables, pos, write_mask=None):
        """One decode step on device operands: tokens and pos [B] int32,
        tables [B, P] int32. ``write_mask`` [B] False sends a row's K/V
        write to the scratch page (an early-stopped horizon row). Returns
        logits [B, V]."""
        positions = pos.long()[:, None]                            # [B, 1]
        valid = (torch.ones_like(positions, dtype=torch.bool)
                 if write_mask is None else write_mask[:, None])
        page, off = self._write_indices(positions, tables, valid)
        ones = torch.ones_like(pos)
        logits, _ = self._forward(tokens.long()[:, None], positions, page,
                                  off, tables, pos, ones, pools)
        return logits[:, 0]

    def _decode_multi_body(self, pools, tokens, tables, pos, *,
                           num_steps: int):
        """The greedy horizon: ``num_steps`` decode steps, each argmax
        fed back as the next token, positions pos, pos+1, ... Returns
        packed [2, B, s] int32: the tokens and the per-step all-finite
        flags."""
        toks, p, out_t, out_f = tokens, pos, [], []
        for _ in range(num_steps):
            logits = self._decode_body(pools, toks, tables, p)
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
            out_t.append(toks)
            out_f.append(torch.isfinite(logits).all(dim=-1).to(torch.int32))
            p = p + 1
        return torch.stack([torch.stack(out_t, 1), torch.stack(out_f, 1)])

    def _decode_multi_x_body(self, pools, tokens, tables, pos, seeds,
                             base_steps, temps, stop_ids, remaining, *,
                             num_steps: int, top_k, top_p, sampling: bool,
                             early_stop: bool):
        """The extended horizon: rows with temps > 0 draw their seeded
        step-indexed sample (`_sampled_rows`) instead of the argmax, and
        with ``early_stop`` a row whose token hits its stop set (stop_ids,
        -1-padded) or exhausts ``remaining`` sets a done bit that sends
        its later K/V writes to the scratch page and holds its position.
        Returns packed [3, B, s] int32: tokens, finite flags, LIVE flags
        (0 after a row's done bit: not a real token)."""
        B = tokens.shape[0]
        toks, p = tokens, pos
        done = torch.zeros(B, dtype=torch.bool, device=tokens.device)
        cnt = torch.zeros_like(pos)
        out_t, out_f, out_l = [], [], []
        for _ in range(num_steps):
            logits = self._decode_body(pools, toks, tables, p,
                                       write_mask=torch.logical_not(done))
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            fin = torch.isfinite(logits).all(dim=-1)
            if sampling:
                # the row's step index is its generated-token count
                sampled = self._sampled_rows(logits, seeds, base_steps + cnt,
                                             temps, top_k, top_p)
                nxt = torch.where(temps > 0.0, sampled.to(torch.int32), nxt)
            live = torch.logical_not(done)
            if early_stop:
                hit = (nxt[:, None] == stop_ids).any(dim=1)
                cnt = cnt + live.to(torch.int32)
                done = done | (live & (hit | (cnt >= remaining)))
            else:
                cnt = cnt + 1
            p = torch.where(live, p + 1, p)      # frozen rows hold position
            toks = nxt
            out_t.append(nxt)
            out_f.append(fin.to(torch.int32))
            out_l.append(live.to(torch.int32))
        return torch.stack([torch.stack(out_t, 1), torch.stack(out_f, 1),
                            torch.stack(out_l, 1)])

    @staticmethod
    def _sampled_rows(logits, seeds, steps, temps, top_k, top_p):
        """Seeded sampling of every row of logits [B, V]: row b draws with
        fold_in(key(seeds[b]), steps[b]) at temperature temps[b] (1 where
        temps[b] is 0; the caller takes the argmax for those rows), through
        `models.generation._sample` with one (top_k, top_p) for the batch.
        The per-step engine, `seeded_sample` and the horizon loop all
        sample through here, so a horizon's stream equals the per-step
        stream bit for bit where both run on one device. Returns int64
        tokens [B]."""
        keys = prandom.fold_in(prandom.key(seeds), steps)
        t = torch.where(temps > 0.0, temps, torch.ones_like(temps))
        return _sample(logits, keys, t.float()[:, None], top_k, top_p)

    # ------------------------------------------------------------ decode

    @torch.no_grad()
    def decode(self, tokens, tables, pos, pools):
        """Batched decode step; tokens [B], tables [B, P], pos [B]."""
        pos_np = np.asarray(pos, np.int32)
        tabs = np.asarray(tables, np.int32)
        B, P = tabs.shape
        self._account_attn(self._attn_impl_for(1), pos_np,
                           np.ones_like(pos_np), P)
        host = (np.asarray(tokens, np.int32), tabs, pos_np)
        return self._launch("decode", (B, P), self._decode_body, host,
                            pools), pools

    @torch.no_grad()
    def decode_multi(self, tokens, tables, pos, pools, num_steps: int, *,
                     seeds=None, base_steps=None, temps=None, top_k=None,
                     top_p=None, stop_ids=None, remaining=None,
                     early_stop: bool = False):
        """Device-resident multi-step decode: ``num_steps`` decode steps
        in one call, each step's token fed back on the device. tokens [B]
        (the fed last tokens), tables [B, P] (mapping every page the
        horizon's live rows write), pos [B].

        With no extension operands the loop is greedy and returns
        (packed [2, B, num_steps] int32, pools): tokens and finite flags.
        ``seeds`` / ``base_steps`` / ``temps`` [B] turn on seeded sampling
        (rows with temps > 0 draw fold_in(key(seed), base_step +
        emitted)); ``stop_ids`` [B, S] (-1-padded), ``remaining`` [B] and
        ``early_stop`` set the per-row done bit. Any extension returns
        [3, B, num_steps] (tokens, finite, live)."""
        if num_steps < 1:
            raise ValueError("decode_multi needs num_steps >= 1")
        pos_np = np.asarray(pos, np.int32)
        tabs = np.asarray(tables, np.int32)
        B, P = tabs.shape
        impl = self._attn_impl_for(1)
        for t in range(num_steps):      # inner step t attends at pos + t
            self._account_attn(impl, pos_np + t, np.ones_like(pos_np), P)
        toks = np.asarray(tokens, np.int32)
        sampling = temps is not None
        if not (sampling or early_stop):
            def body(pools_, *ops):
                return self._decode_multi_body(pools_, *ops,
                                               num_steps=num_steps)
            return self._launch("decode_multi", (B, P, num_steps), body,
                                (toks, tabs, pos_np), pools), pools
        seeds = np.zeros((B,), np.int64) if seeds is None \
            else np.asarray(seeds, np.int64)
        base_steps = np.zeros((B,), np.int32) if base_steps is None \
            else np.asarray(base_steps, np.int32)
        temps = np.zeros((B,), np.float32) if temps is None \
            else np.asarray(temps, np.float32)
        stop_ids = np.full((B, 1), -1, np.int32) if stop_ids is None \
            else np.asarray(stop_ids, np.int32)
        remaining = np.full((B,), num_steps, np.int32) if remaining is None \
            else np.asarray(remaining, np.int32)
        early_stop = bool(early_stop)

        def body_x(pools_, *ops):
            return self._decode_multi_x_body(
                pools_, *ops, num_steps=num_steps, top_k=top_k, top_p=top_p,
                sampling=sampling, early_stop=early_stop)
        key = (B, P, num_steps, top_k, top_p, sampling, early_stop,
               stop_ids.shape[1])
        host = (toks, tabs, pos_np, seeds, base_steps, temps, stop_ids,
                remaining)
        return self._launch("decode_multi_x", key, body_x, host,
                            pools), pools

    def _forward(self, tokens, positions, write_page, write_off, tables,
                 pos_q, q_lens, pools):
        raise NotImplementedError


class LlamaRunner(PagedModelRunner):
    """Paged-step adapter for models.Llama (RMSNorm + RoPE + GQA +
    SwiGLU). The runner serves the model's own parameters (moved to
    ``device`` when they live elsewhere). The model's `x @ w` products are
    plain torch.matmul in full fp32. The positional parameters are the JAX
    runner's; ``device`` is keyword-only after them."""

    def __init__(self, model: Llama, block_size: int = 16,
                 max_model_len: int | None = None, attn_impl: str = "auto",
                 kv_dtype: str = "fp32", weight_dtype: str = "fp32",
                 weight_group_size: int = 128, *, device=None):
        cfg = model.cfg
        super().__init__(model_params(model, device), block_size,
                         max_model_len or cfg.max_seq_len, attn_impl,
                         kv_dtype, weight_dtype, weight_group_size)
        self.cfg = cfg
        self.num_layers = cfg.num_layers
        self.n_heads = cfg.num_heads
        self.n_kv_heads = cfg.num_kv_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.vocab_size = cfg.vocab_size
        self._rope_cos, self._rope_sin = rope_tables(
            self.max_model_len, self.head_dim, cfg.rope_theta,
            device=self.device)                              # [L, d] fp32

    def _rope(self, x, cos, sin):
        # rotate-half convention of ops.rotary_embedding
        x1, x2 = x.chunk(2, dim=-1)
        rot = torch.cat([-x2, x1], dim=-1)
        return x * cos[:, :, None, :] + rot * sin[:, :, None, :]

    def _rms(self, x, w):
        var = x.pow(2).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.cfg.rms_eps) * w

    def _forward(self, tokens, positions, write_page, write_off, tables,
                 pos_q, q_lens, pools):
        cfg, p = self.cfg, self.params
        B, T = tokens.shape
        d = self.head_dim
        impl = self._attn_impl_for(T)
        x = F.embedding(tokens, p["embed_tokens.weight"])
        cos = self._rope_cos[positions]                      # [B, T, d]
        sin = self._rope_sin[positions]
        for i in range(cfg.num_layers):
            pre = f"layers.{i}."
            h = self._rms(x, p[pre + "input_layernorm.weight"])
            q = (h @ p[pre + "self_attn.q_proj.weight"]
                 ).reshape(B, T, self.n_heads, d)
            k = (h @ p[pre + "self_attn.k_proj.weight"]
                 ).reshape(B, T, self.n_kv_heads, d)
            v = (h @ p[pre + "self_attn.v_proj.weight"]
                 ).reshape(B, T, self.n_kv_heads, d)
            q = self._rope(q, cos, sin)
            k = self._rope(k, cos, sin)
            out, _ = paged_attend(q, k, v, pools[i], tables, write_page,
                                  write_off, pos_q, q_lens, self.n_rep, impl)
            x = x + out @ p[pre + "self_attn.o_proj.weight"]
            h = self._rms(x, p[pre + "post_attention_layernorm.weight"])
            gate = h @ p[pre + "mlp.gate_proj.weight"]
            up = h @ p[pre + "mlp.up_proj.weight"]
            x = x + (F.silu(gate) * up) @ p[pre + "mlp.down_proj.weight"]
        x = self._rms(x, p["norm.weight"])
        if cfg.tie_embeddings:
            return x @ p["embed_tokens.weight"].T, pools
        return x @ p["lm_head.weight"], pools


class GPTRunner(PagedModelRunner):
    """Paged-step adapter for models.GPT (pre-LN, learned positions, fused
    QKV, GELU MLP), over the functional block helpers the generators run
    (`models.generation._block_params`, `_layer_norm`, `_mlp`). MHA: the
    pools hold all ``num_heads`` heads (n_rep 1), so a decode step takes
    the paged-decode kernel (K2) over fp32 pools and the ragged kernel's
    decode form (K1-q) over int8 / fp8 pools, and prefill chunks the
    ragged kernel (its span form; a chunk of at most 8 rows its decode
    form). fp32 weights only; the positional
    parameters are the JAX runner's, ``device`` keyword-only after them.
    The JAX runner's tensor-parallel placements (`_param_specs`,
    `_constrain_heads`) wait for item 10."""

    def __init__(self, model: GPT, block_size: int = 16,
                 max_model_len: int | None = None, attn_impl: str = "auto",
                 kv_dtype: str = "fp32", weight_dtype: str = "fp32",
                 weight_group_size: int = 128, *, device=None):
        cfg = model.cfg
        super().__init__(model_params(model, device), block_size,
                         max_model_len or cfg.max_seq_len, attn_impl,
                         kv_dtype, weight_dtype, weight_group_size)
        self.cfg = cfg
        self.num_layers = cfg.num_layers
        self.n_heads = cfg.num_heads
        self.n_kv_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.vocab_size = cfg.vocab_size

    def _forward(self, tokens, positions, write_page, write_off, tables,
                 pos_q, q_lens, pools):
        cfg, params = self.cfg, self.params
        impl = self._attn_impl_for(tokens.shape[1])
        x = (F.embedding(tokens, params["wte.weight"])
             + params["wpe.weight"][positions])
        for i in range(cfg.num_layers):
            p = _block_params(params, i)
            h = _layer_norm(x, p["ln1.weight"], p["ln1.bias"])
            q, k, v = _qkv(p, h, self.n_heads)
            out, _ = paged_attend(q, k, v, pools[i], tables, write_page,
                                  write_off, pos_q, q_lens, 1, impl)
            x = x + (out @ p["attn.out.weight"] + p["attn.out.bias"])
            h = _layer_norm(x, p["ln2.weight"], p["ln2.bias"])
            x = x + _mlp(p, h)
        return _head(params, x), pools


def runner_for(model, block_size: int = 16, max_model_len: int | None = None,
               attn_impl: str = "auto", kv_dtype: str = "fp32",
               weight_dtype: str = "fp32", weight_group_size: int = 128, *,
               device=None) -> PagedModelRunner:
    """Pick the runner for a supported decoder: Llama or GPT."""
    if isinstance(model, Llama):
        return LlamaRunner(model, block_size, max_model_len, attn_impl,
                           kv_dtype, weight_dtype, weight_group_size,
                           device=device)
    if isinstance(model, GPT):
        return GPTRunner(model, block_size, max_model_len, attn_impl,
                         kv_dtype, weight_dtype, weight_group_size,
                         device=device)
    raise TypeError(
        f"no serving runner for {type(model).__name__}; supported: Llama, "
        "GPT (write a PagedModelRunner subclass for custom decoders)")
