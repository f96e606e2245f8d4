"""Model runners: paged-KV step functions for the serving engine.

Counterpart of paddle_tpu/serving/model_runner.py for Llama and GPT, on one
device or sharded over a mesh's model axis (`shard`): fp32, bf16 or fp16
compute (the dtype of the first floating
parameter, `dtype`; `inference.create_serving_engine(dtype=...)` casts),
over fp32 (the runner's dtype), int8, fp8 or "mixed" KV pools
(``kv_dtype``), with
fp32, int8, int4 or fp8 matmul weights (``weight_dtype``, the weight
ladder: `_quantize_weights`, `_mm`). A runner adapts a model's flat
parameter dict into the step functions the engine calls over the shared
page pool:

  prefill(tokens, table_row, pools)                 -> (logits[V], pools)
  prefill_chunk(tokens, start_pos, table_row, pools) -> (logits[V], pools)
  decode(tokens[B], tables[B, P], pos[B], pools)     -> (logits[B, V], pools)
  decode_multi(tokens, tables, pos, pools, s, ...)   -> (packed[2|3, B, s],
                                                         pools)
  decode_multi_spec(tokens, tables, pos, pools, drafts[B, s, K], ...)
                                                     -> (packed[3, B, s,
                                                         K+1], pools)
  ragged_step(tokens[B, T], tables, start_pos[B], q_lens[B], pools,
              full_logits=False)                     -> (logits[B, V] or
                                                         [B, T, V], pools)

``pools`` is the page pool's `KVCachePool.shards`: each shard's list of
layer tuples, one shard on an unsharded pool (whose `KVCachePool.pools`
is that shard's list, the JAX package's shape). One `_forward` serves
both: an unsharded runner is a runner of one shard.

`decode_multi` is the device-resident horizon: s decode steps in one
call, each step's token (the argmax, or a seeded sample with
``horizon_sampling``) fed back on the device, drained by the engine as
one packed int32 buffer. Each inner step is `decode`'s body: the same
`_forward`, `paged_attend` and kernels. `ragged_step` is one mixed
batch: prefill chunks at an offset, decode rows, verify spans of 1 + k
rows and dead slots (q_len 0) in one forward, so one ragged-kernel
launch a layer. `decode_multi_spec` is the speculative horizon: each
inner step feeds every row its fed token plus a draft span, accepts on
the device and advances each row by its kept count.

Every step writes this step's K/V through the block table, then attends
through one of three paths chosen per span bucket by `_attn_impl_for`:
the ragged paged-attention kernel (prefill chunks, GQA decode), the
single-token paged-decode kernel (MHA decode), or the gather + dense-mask
reference. "auto" resolves exactly as `best_paged_impl` says on every
device, except that int8 and fp8 pools never go to the paged-decode
kernel (it has no dequantize step): their MHA decode takes the ragged
kernel, as in the JAX package ("mixed" pools store the runner's dtype and
keep the full dispatch). A bf16 or fp16 runner's q and pools take the
kernels' variants of its dtype. On CUDA tensors the wrappers launch the
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
    kinds ("decode", "decode_multi", "decode_multi_x",
    "decode_multi_spec"), keyed by the jit key plus the pools' addresses
    (a graph writes the pools it was captured on). Host operands go
    through pinned staging buffers into the graph's static inputs before
    each replay; the output buffer is the graph's own, so a caller drains
    it before the same graph replays again. Prefill chunks and ragged
    steps run eagerly. On CPU tensors (or with
    ``graphs`` set False) every kind runs eagerly: the caller's choice.
    On the card a capture or replay that fails raises; nothing retries
    eagerly;
  * concurrent runners: the replicas of a serving tier are threads of
    one process, sharing its CUDA context, its compute stream and one
    capture stream per device. Every capture (its warm-up call on the
    capture stream included) holds `_CAPTURE_LOCK`, so captures of
    concurrent replicas run one at a time, and captures in
    ``capture_error_mode="thread_local"``, so the other replicas' work
    (eager chunks, replays, drains, host-tier copies and syncs) goes on
    during a capture: only the capturing thread is barred from unsafe
    calls. A capture's warm-up runs for real on the capture stream,
    whose persistent buffers (K2's split tickets, the 16-bit split walk's
    workspace) every graph captured on it also uses when it replays, on
    the compute stream: `_CAPTURE_STREAM_LOCK` keeps another runner's
    replay from being enqueued between the warm-up's wait on the compute
    stream and the compute stream's wait on the warm-up, so the two never
    run at once on the card. Why not a capture stream per replica:
    `torch.cuda.graph` enters with a device synchronize and an
    `empty_cache`, which PyTorch's allocator refuses while any capture is
    under way, so captures must be
    serialized whatever their streams; and cuBLAS keeps a 32 MiB workspace
    for every stream it has run on, which a stream per replica (and per
    restart) would hold;
  * the horizon loops are Python loops of the decode bodies (the JAX
    `lax.scan`), inside one graph on the card; a speculative horizon's
    per-row positions, kept counts and stop bits stay device tensors;
  * tensor parallelism is single-controller, as the JAX engine is, but
    explicit where JAX leaves the partition to GSPMD: `_forward` runs each
    shard's column products, its attention over its own pool slices at
    n_heads / tp and n_kv_heads / tp heads and its row products' partials,
    and the layout's collectives (`SpecLayout.row_parallel_reduce`,
    `column_parallel_gather`) join them; replicated activations are
    computed once. An unsharded runner is the case of one shard. The
    steps take the pool's `shards` where the JAX runner takes its
    ``pools``. A sharded decode kind is still one CUDA graph.

The instrumented-pool counters (`attn_kv_bytes_read` /
`attn_kv_bytes_gather`) account the pool bytes each dispatch touches vs
what the gather path would read, host-side from the call's operands.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.models.generation import (
    DIST_ITEM, _layer_norm, _sample,
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
from paddle_tpu_torch.quantization.int4 import int4_matmul, int4_quantize
from paddle_tpu_torch.quantization.int8 import _weight_quantize
from paddle_tpu_torch.quantization.qcomm import (
    COMM_DTYPES, allgather_bytes, allreduce_bytes,
)
from paddle_tpu_torch.serving.kv_cache import (
    SCRATCH_PAGE, _fp8_cast, check_kv_dtype, fp8_page_write, fp8_round,
    quantized_page_write, require_fp8,
)

logger = logging.getLogger(__name__)

# params-dict key suffix of a quantized weight's scale tensor:
# "layers.0.self_attn.q_proj.weight::scale" ([out] fp32 for int8,
# [out, ceil(in / group)] fp32 for int4; fp8 weights have none)
SCALE_SUFFIX = "::scale"

# the weight ladder: "int8" codes with per-output-channel scales, "int4"
# packed nibbles with group scales, "fp8" float8_e4m3fn, scale-free
WEIGHT_DTYPES = ("fp32", "int8", "int4", "fp8")


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
    layer's pool tuple, written IN PLACE: (k_pool, v_pool) in the runner's
    dtype or float8_e4m3fn (fp8 appends are a pure cast,
    `fp8_page_write`), mixed (k_pool, v_pool, tag) (the runner's dtype
    and a bool plane per page: rows landing on fp8-tagged pages are
    written through `fp8_round`, the value a native fp8 pool holds,
    the others verbatim), or int8 (k_codes, v_codes, k_scale, v_scale)
    (`quantized_page_write` quantizes at append time; the attend paths
    dequantize with the per-page-per-head scales); tables: [B, P] int32;
    write_page/write_off: [B, T] int64; pos_q: [B] int32 context position
    of q row 0; q_len: [B] int32 live rows per span. impl is the resolved
    attention path ("reference" | "paged_decode" | "ragged"). shard_ctx is
    the (mesh, model_axis) of a sharded runner's per-shard call: q, k_new,
    v_new and layer_pools are then one shard's (n_h / tp and n_kv / tp
    heads, its own pool slices), and the call runs as an unsharded one at
    those head counts (the JAX package maps the kernel over the model axis
    with shard_map; here the runner calls it once a shard). Returns
    ([B, T, n_h*d], layer_pools)."""
    if shard_ctx is not None:
        mesh, axis = shard_ctx
        tp = int(mesh.shape[axis])
        heads = layer_pools[0].shape[2]
        if k_new.shape[2] != heads or q.shape[2] != n_rep * heads:
            raise ValueError(
                f"paged_attend(shard_ctx=tp {tp}): a shard's call takes its "
                f"own heads; got q {q.shape[2]} / kv {k_new.shape[2]} heads "
                f"over a pool slice of {heads} kv heads (n_rep {n_rep})")
    k_pool, v_pool = layer_pools[:2]
    scales = (None, None)
    quantized = len(layer_pools) == 4
    if quantized:
        scales = layer_pools[2:]
        quantized_page_write(k_pool, scales[0], write_page, write_off, k_new)
        quantized_page_write(v_pool, scales[1], write_page, write_off, v_new)
    elif len(layer_pools) == 3:     # mixed: the tag plane steers the write
        is8 = layer_pools[2][write_page][..., None, None]   # [B, T, 1, 1]
        k_pool[write_page, write_off] = torch.where(is8, fp8_round(k_new),
                                                    k_new)
        v_pool[write_page, write_off] = torch.where(is8, fp8_round(v_new),
                                                    v_new)
    elif k_pool.dtype == torch.float8_e4m3fn:
        fp8_page_write(k_pool, write_page, write_off, k_new)
        fp8_page_write(v_pool, write_page, write_off, v_new)
    else:
        k_pool[write_page, write_off] = k_new
        v_pool[write_page, write_off] = v_new
    B, T = q.shape[0], q.shape[1]
    one_byte = quantized or k_pool.dtype == torch.float8_e4m3fn
    if impl == "paged_decode":
        if one_byte:
            raise ValueError("paged_decode has no int8/fp8-pool path: "
                             "_attn_impl_for routes quantized pools to the "
                             "ragged kernel or the gather reference")
        out = paged_decode_attention(q[:, 0], k_pool, v_pool, tables, pos_q)
        return out.reshape(B, 1, -1), layer_pools
    if impl == "ragged":
        out = ragged_paged_attention(q, k_pool, v_pool, tables, pos_q, q_len,
                                     k_scale=scales[0], v_scale=scales[1])
        return out.reshape(B, T, -1), layer_pools
    if not one_byte:
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


class _CudaGraph:
    """A torch.cuda.CUDAGraph captured on its device's capture stream."""

    def __init__(self, stream):
        self.graph = torch.cuda.CUDAGraph()
        self.stream = stream

    def capture(self, fn):
        # thread_local: the other replicas' threads may sync and allocate
        # while this one captures (the caller holds _CAPTURE_LOCK)
        with torch.cuda.graph(self.graph, stream=self.stream,
                              capture_error_mode="thread_local"):
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
        with _CAPTURE_STREAM_LOCK:      # never beside a capture's warm-up
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
        with _CAPTURE_STREAM_LOCK:
            # no replay of a graph captured on this stream may run beside
            # the warm-up: they share the stream's persistent buffers
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


# the capture stream of each device, shared by every runner: cuBLAS keeps
# a workspace for every stream it has run on (32 MiB a stream on the H100)
# and never frees it, so a stream per runner would hold one per runner
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}

# held by every capture of the process (the warm-up call on the shared
# capture stream through the end of the capture): the runners of a
# serving tier's replica threads capture one at a time
_CAPTURE_LOCK = threading.Lock()

# held while a capture's warm-up is enqueued on the capture stream (from
# its wait on the compute stream to the compute stream's wait on it) and
# while a replay is enqueued: a replay writes the capture stream's
# persistent buffers (K2's tickets), which the warm-up's kernels use too
_CAPTURE_STREAM_LOCK = threading.Lock()


def _capture_stream(device) -> "torch.cuda.Stream":
    """The stream graphs are captured on for ``device``, made once."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _CAPTURE_STREAMS.get(idx)
    if stream is None:
        stream = _CAPTURE_STREAMS[idx] = torch.cuda.Stream(device)
    return stream


def _flat_tensors(x):
    """The tensors of a nested list / tuple, in order."""
    if isinstance(x, torch.Tensor):
        yield x
    else:
        for y in x:
            yield from _flat_tensors(y)


def _pools_key(pools) -> tuple:
    """The pools' addresses, shapes and dtypes (every shard's tensors on a
    sharded pool): a graph writes the pools it was captured on, or any
    that later lie at the same addresses."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for t in _flat_tensors(pools))


class PagedModelRunner:
    """Shared runner chassis: write-index math, dispatch, byte counters.

    Subclasses set the architecture fields in __init__ and implement
    `_forward(tokens, positions, write_page, write_off, tables, pos_q,
    q_lens, pools) -> (logits[B, T, V], pools)` over ``pools``, the pool's
    shards.
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
        if weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype={weight_dtype!r}; expected one "
                             f"of {WEIGHT_DTYPES}")
        if weight_dtype == "fp8":
            require_fp8(f"{type(self).__name__}(weight_dtype='fp8')")
        if int(weight_group_size) < 1:
            raise ValueError(f"weight_group_size must be >= 1, got "
                             f"{weight_group_size}")
        self.weight_dtype = weight_dtype
        self.weight_group_size = int(weight_group_size)
        # the params `_quantize_weights` converted: the byte accounting's
        # map back to their logical fp32 shapes
        self._quantized_names: frozenset = frozenset()
        self.params = params
        self.block_size = block_size
        self.max_model_len = max_model_len
        self.attn_impl = attn_impl
        # the engine builds its pools with the runner's kv_dtype
        self.kv_dtype = kv_dtype
        self.device = next(iter(params.values())).device
        self._impl_logged: set = set()
        # instrumented-pool counters: device bytes of KV pool the chosen
        # attention path touches vs what the gather path would have read
        self.attn_kv_bytes_read = 0.0
        self.attn_kv_bytes_gather = 0.0
        # tensor parallelism (`shard`): unsharded until a mesh is given
        self.mesh = None
        self.data_axis = "data"
        self.model_axis = "model"
        self.tp_size = 1
        self.comm_dtype = "fp32"
        self._layout = None
        self._specs: Dict[str, tuple] = {}
        # each shard's parameter dict and device once sharded
        # (`_shard_params` / `_shard_devices` read them)
        self._mesh_params: List[Dict[str, torch.Tensor]] = []
        self._mesh_devices: List[torch.device] = []
        self._row_names: frozenset = frozenset()
        self._row_out_dims: tuple = ()
        self._gather_names: frozenset = frozenset()
        self._gather_out_dims: tuple = ()
        # per-shard wire bytes of the row-parallel allreduces and of the
        # logits gather at the comm dtype, and what fp32 would move
        self.tp_comm_bytes = 0.0
        self.tp_comm_bytes_fp32 = 0.0
        self.tp_gather_bytes = 0.0
        self.tp_gather_bytes_fp32 = 0.0
        # CUDA graphs of the decode kinds on the card (`_graphed`); False
        # runs them eagerly there too
        self.graphs = True
        self._graph_cache: "OrderedDict[tuple, CapturedStep]" = OrderedDict()
        # one entry per capture: kind, key, seconds, graph pool bytes
        self.captures: List[dict] = []

    @property
    def dtype(self):
        """The runner's compute dtype: the first floating parameter's
        (int8 weight codes are storage, not the serving precision)."""
        for v in self.params.values():
            if v.is_floating_point():
                return v.dtype
        return next(iter(self.params.values())).dtype

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads

    # ------------------------------------------------- the weight ladder

    def _quantize_weights(self, names) -> None:
        """Convert the named 2-D [in, out] matmul weights to this runner's
        rung: "int8" codes and a per-output-channel fp32 scale vector
        (`quantization.int8._weight_quantize`), "int4" packed nibbles and
        [out, ceil(in / weight_group_size)] fp32 group scales
        (`quantization.int4.int4_quantize`), "fp8" a scale-free
        float8_e4m3fn cast. Scales land as ``name + SCALE_SUFFIX``; the
        matmul epilogue that applies them is `_mm`. Norms, biases and
        embeddings stay floating. The runner's own dict entries are
        replaced; the model's parameters are untouched."""
        for name in names:
            w = self.params[name]
            if self.weight_dtype == "int4":
                qw, scale = int4_quantize(w, self.weight_group_size)
            elif self.weight_dtype == "fp8":
                qw, scale = _fp8_cast(w), None      # ml_dtypes' rounding
            else:
                qw, scale = _weight_quantize(w)
                scale = scale.float()
            self.params[name] = qw
            if scale is not None:
                self.params[name + SCALE_SUFFIX] = scale
        logger.info("serving weights %s: %d matrices (group %d)",
                    self.weight_dtype, len(names), self.weight_group_size)
        self._quantized_names = frozenset(names)

    def _mm(self, params, name, x, epilogue: bool = True):
        """x @ a possibly quantized weight. fp32 (or cast) weights take the
        plain ``x @ w``; fp8 weights are cast to x's dtype first; int8
        codes are cast to x's dtype and their per-output-channel scale
        multiplies the product (``x @ (q * s)`` by linearity); int4 goes
        through `int4_matmul`'s grouped epilogue. Codes and scales are
        cast to x's dtype as the JAX runner casts them. ``epilogue`` False
        leaves int8's scale to the caller (a row-parallel product applies
        it after the reduce)."""
        w = params[name]
        s = params.get(name + SCALE_SUFFIX)
        if s is None:
            if w.dtype == torch.float8_e4m3fn:
                return x @ w.to(x.dtype)
            return x @ w
        if s.dim() == 2:
            return int4_matmul(x, w, s, self.weight_group_size)
        out = x @ w.to(x.dtype)
        return out * s.to(x.dtype) if epilogue else out

    def weight_bytes(self) -> int:
        """Resident bytes of the whole params dict at their storage dtypes:
        codes, scales and the floating parameters."""
        return int(sum(v.numel() * v.element_size()
                       for v in self.params.values()))

    def weight_bytes_fp32(self) -> int:
        """What the same logical parameters would take at fp32: a packed
        int4 byte holds two elements, scale tensors do not exist there."""
        total = 0
        for name, v in self.params.items():
            if name.endswith(SCALE_SUFFIX):
                continue
            elems = v.numel()
            if name in self._quantized_names and self.weight_dtype == "int4":
                elems *= 2
            total += elems * 4
        return total

    def weight_bytes_reduction_x(self) -> float:
        """The whole model's weight-byte reduction against fp32 (1.0 on an
        fp32 runner, 2.0 on a bf16- or fp16-cast one)."""
        wb = self.weight_bytes()
        return self.weight_bytes_fp32() / wb if wb else 1.0

    # ------------------------------------------------- tensor parallelism

    @property
    def is_sharded(self) -> bool:
        return self.mesh is not None

    @property
    def _shard_params(self) -> List[Dict[str, torch.Tensor]]:
        """Each shard's parameters: an unsharded runner is one shard,
        its own ``params``."""
        return self._mesh_params if self.mesh is not None else [self.params]

    @property
    def _shard_devices(self) -> List[torch.device]:
        return self._mesh_devices if self.mesh is not None else [self.device]

    @property
    def _shard_ctx(self):
        """`paged_attend`'s shard_ctx for one shard's call (None when
        unsharded)."""
        return None if self.mesh is None else (self.mesh, self.model_axis)

    def _param_specs(self, layout) -> Dict[str, tuple]:
        """name -> PartitionSpec for this architecture (subclass hook;
        unlisted params ride replicated)."""
        raise NotImplementedError

    @staticmethod
    def _spec_fits(shape, spec, mesh) -> bool:
        """Every sharded dim divides evenly across its mesh axes."""
        for dim, axes in zip(shape, tuple(spec)):
            if axes is None:
                continue
            names = axes if isinstance(axes, tuple) else (axes,)
            parts = int(np.prod([mesh.shape[a] for a in names]))
            if dim % parts:
                return False
        return True

    def shard(self, mesh, *, data_axis: str = "data",
              model_axis: str = "model",
              comm_dtype: str = "fp32") -> "PagedModelRunner":
        """Shard this runner's weights over ``mesh``'s model axis (a
        `parallel.mesh.Mesh`); returns self. The placements are the JAX
        runner's (`_param_specs`, `SpecLayout`): QKV / gate / up (GPT's
        fc1) column-parallel, out-proj / down-proj (fc2) row-parallel with
        the layout's `row_parallel_reduce()` on their partial products,
        embeddings vocab-sharded, an untied lm_head column-parallel with
        its logits gathered by `column_parallel_gather()`; GPT's fused
        QKV stays replicated (its (3, heads, d) columns would split across
        q / k / v) and each shard takes its heads of the product. A
        quantized weight's scale shards with it (int8's [out] vector on
        the out axis, int4's [out, groups] matrix on the transposed spec,
        an int4 row-parallel shard owning whole groups); a weight whose
        sharded dim does not divide stays replicated with its scale,
        logged. n_kv_heads and n_heads must divide by tp (GQA shards in
        whole kv heads). The engine builds its pools over the same mesh.

        Each shard's tensors are the ``params`` tensors themselves where
        replicated and views of them where sharded (narrowed on the
        sharded dim), on the shard's device: on a mesh whose shards share
        the weights' device (every mesh the port runs: one card, or the
        CPU) no weight is copied. A runner on another device than the
        mesh's moves its parameters there first."""
        from paddle_tpu_torch.parallel.compat import P, SpecLayout

        if comm_dtype not in COMM_DTYPES:
            raise ValueError(f"comm_dtype={comm_dtype!r}; expected one "
                             f"of {COMM_DTYPES}")
        for axis in (data_axis, model_axis):
            if axis not in mesh.axis_names:
                raise ValueError(
                    f"mesh axes {mesh.axis_names} lack {axis!r}: build "
                    "the serving mesh with parallel.mesh.serving_mesh("
                    "data, model)")
        tp = int(mesh.shape[model_axis])
        if self.n_kv_heads % tp:
            raise ValueError(
                f"n_kv_heads={self.n_kv_heads} is not divisible by the "
                f"tensor-parallel degree {tp} ({model_axis!r} axis): GQA "
                "shards along kv-heads, so every shard needs a whole "
                "kv-head slice of the paged pools; choose tp dividing "
                "n_kv_heads or reshape the mesh")
        if self.n_heads % tp:
            raise ValueError(
                f"n_heads={self.n_heads} is not divisible by the tensor-"
                f"parallel degree {tp} ({model_axis!r} axis)")
        devices = mesh.axis_devices(model_axis)
        if devices[0] != self.device:
            self.params = {k: v.to(devices[0])
                           for k, v in self.params.items()}
            self.device = devices[0]
            self._move_tables(self.device)
        layout = SpecLayout(data_axis=data_axis, model_axis=model_axis,
                            comm_dtype=comm_dtype)
        specs = dict(self._param_specs(layout))
        # a quantized weight's scale takes its placement from the weight's
        # spec: int8's [out] the out axis, int4's [out, groups] the
        # transposed spec; fp8 has no scale
        for name in list(specs):
            sname = name + SCALE_SUFFIX
            if sname in self.params:
                spec = tuple(specs[name])
                if len(spec) < 2:
                    specs[sname] = P()
                elif self.params[sname].dim() == 2:
                    specs[sname] = P(spec[1], spec[0])
                else:
                    specs[sname] = P(spec[1])
        final: Dict[str, tuple] = {}
        for name, v in self.params.items():
            if name.endswith(SCALE_SUFFIX):
                continue                # placed with its weight below
            spec = tuple(specs.get(name, P()))
            sname = name + SCALE_SUFFIX
            sspec = tuple(specs.get(sname, P()))
            fits = spec == () or self._spec_fits(v.shape, spec, mesh)
            if fits and sname in self.params and sspec != ():
                sarr = self.params[sname]
                fits = self._spec_fits(sarr.shape, sspec, mesh)
                if fits and sarr.dim() == 2 and \
                        spec == tuple(layout.row_parallel()):
                    # int4 row-parallel: whole reduction groups a shard
                    # (the logical in-dim is twice the packed rows)
                    k = 2 * int(v.shape[0])
                    fits = (k // tp) % min(self.weight_group_size, k) == 0
            if spec != () and not fits:
                logger.warning(
                    "shard: %s %s does not divide over %s: this param "
                    "(and its scale) stays replicated", name,
                    tuple(v.shape), spec)
                spec, sspec = (), ()
            final[name] = P(*spec)
            if sname in self.params:
                final[sname] = P(*sspec)
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.tp_size = tp
        self.comm_dtype = comm_dtype
        self._layout = layout
        self._specs = final
        self._mesh_devices = devices
        self._mesh_params = [
            {name: self._local(v, final[name], s).to(devices[s])
             for name, v in self.params.items()} for s in range(tp)]
        row = tuple(layout.row_parallel())
        rows = sorted(n for n in specs if not n.endswith(SCALE_SUFFIX)
                      and tuple(final.get(n, ())) == row)
        col = tuple(layout.column_parallel())
        gathers = sorted(n for n in ("lm_head.weight",)
                         if n in self.params and tuple(final[n]) == col)
        self._row_names = frozenset(rows)
        self._row_out_dims = tuple(int(self.params[n].shape[1])
                                   for n in rows)
        self._gather_names = frozenset(gathers)
        self._gather_out_dims = tuple(int(self.params[n].shape[1]) // tp
                                      for n in gathers)
        self._graph_cache.clear()       # graphs are per forward
        logger.info(
            "serving runner sharded: mesh=%s tp=%d (%d/%d heads, %d/%d "
            "kv-heads per shard) comm_dtype=%s (%d row-parallel "
            "allreduces + %d column-parallel gathers/step)",
            dict(mesh.shape), tp, self.n_heads // tp, self.n_heads,
            self.n_kv_heads // tp, self.n_kv_heads, comm_dtype,
            len(rows), len(gathers))
        return self

    def _move_tables(self, device) -> None:
        """Move the runner's non-parameter device tables (subclass hook)."""

    def _local(self, v: torch.Tensor, spec: tuple, s: int) -> torch.Tensor:
        """Shard ``s``'s part of a parameter: ``v`` narrowed on each dim
        its spec puts on the model axis (a view), or ``v`` itself."""
        for dim, axis in enumerate(spec):
            if axis == self.model_axis:
                n = v.shape[dim] // self.tp_size
                v = v.narrow(dim, s * n, n)
        return v

    def _sharded(self, name: str) -> bool:
        return any(a == self.model_axis for a in self._specs.get(name, ()))

    def _shard_slice(self, name: str, s: int, dim: int = -1):
        """Shard ``s``'s slice (1/tp of ``dim``) of a parameter, whether it
        is sharded (its own view) or replicated (narrowed here)."""
        if self._sharded(name):
            return self._shard_params[s][name]
        v = self._shard_params[s][name]
        n = v.shape[dim] // self.tp_size
        return v.narrow(dim, s * n, n)

    def _col(self, name: str, h) -> List[torch.Tensor]:
        """A column-parallel product of the replicated input ``h``: each
        shard's output columns. A weight left replicated computes the
        whole product once and each shard takes its columns."""
        if self._sharded(name):
            return [self._mm(sp, name, h.to(dev)) for sp, dev in
                    zip(self._shard_params, self._shard_devices)]
        full = self._mm(self._shard_params[0], name, h)
        n = full.shape[-1] // self.tp_size
        return [full.narrow(-1, s * n, n).to(dev)
                for s, dev in enumerate(self._shard_devices)]

    def _row(self, name: str, parts) -> torch.Tensor:
        """A row-parallel product of the shards' input slices ``parts``,
        returned replicated (the first shard's copy). Each shard's `_mm`
        multiplies its rows (int4's grouped epilogue and fp8's cast
        in-shard), the layout's `row_parallel_reduce()` sums the partial
        products, and int8's per-output-channel scale, replicated,
        multiplies the sum. A weight left replicated (every weight of an
        unsharded runner) joins the inputs and multiplies once."""
        if name not in self._row_names:
            x = parts[0] if len(parts) == 1 else torch.cat(
                [p.to(self.device) for p in parts], dim=-1)
            return self._mm(self._shard_params[0], name, x)
        partial = [self._mm(sp, name, x, epilogue=False)
                   for sp, x in zip(self._shard_params, parts)]
        out = self._layout.row_parallel_reduce()(partial)[0]
        s = self._shard_params[0].get(name + SCALE_SUFFIX)
        if s is not None and s.dim() == 1:
            out = out * s.to(out.dtype)
        return out

    def _embed(self, name: str, tokens) -> torch.Tensor:
        """The embedding lookup of a vocab-sharded table: each shard looks
        up the tokens in its rows (zeros elsewhere) and the plain psum
        joins them, exactly (the JAX package's GSPMD lookup)."""
        if not self._sharded(name):
            return F.embedding(tokens, self._shard_params[0][name])
        from paddle_tpu_torch.parallel.mesh import psum
        parts = []
        for s, (sp, dev) in enumerate(zip(self._shard_params,
                                          self._shard_devices)):
            table = sp[name]
            n = table.shape[0]
            local = tokens.to(dev) - s * n
            hit = (local >= 0) & (local < n)
            e = F.embedding(local.clamp(0, n - 1), table)
            parts.append(torch.where(hit[..., None], e,
                                     torch.zeros_like(e)))
        return psum(parts)[0]

    def _logits(self, x, head: str, table: str) -> torch.Tensor:
        """The logits of the final hidden states: an untied ``head``
        through `_mm` (column-parallel: each shard's vocab slice, joined by
        the layout's `column_parallel_gather()`), or a tied ``table``
        (vocab-sharded: each shard's slice, joined by the plain gather)."""
        from paddle_tpu_torch.parallel.mesh import all_gather
        if head in self._shard_params[0]:
            if head not in self._gather_names:
                return self._mm(self._shard_params[0], head, x)
            gather = self._layout.column_parallel_gather()
            return gather([self._mm(sp, head, x.to(dev)) for sp, dev in
                           zip(self._shard_params, self._shard_devices)])[0]
        if not self._sharded(table):
            return x @ self._shard_params[0][table].T
        return all_gather([x.to(dev) @ sp[table].T for sp, dev in
                           zip(self._shard_params, self._shard_devices)])[0]

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
        bytes the dequantize reads, fp8 pools one byte per element, the
        others (fp32 and "mixed" pools store the runner's dtype; the tag
        plane is never read by the attention) its itemsize. A sharded
        runner counts one shard's n_kv / tp heads."""
        nkv = self.n_kv_heads // self.tp_size      # per shard
        data = self.block_size * nkv * self.head_dim
        if self.kv_dtype == "int8":
            return 2 * self.num_layers * (data + nkv * 4)
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

    def _account_comm(self, rows: int, steps: int = 1) -> None:
        """Bump the comm counters for one step call: every forward runs one
        allreduce of [rows, out] a row-parallel weight and one gather of
        [rows, V / tp] a gathered head, counted per shard at the comm
        dtype and at fp32 (`qcomm.allreduce_bytes` / `allgather_bytes`,
        scale bytes included), from the call's padded operand rows."""
        if self.tp_size <= 1 or not (self._row_out_dims
                                     or self._gather_out_dims):
            return
        r = int(rows) * int(steps)
        for d in self._row_out_dims:
            self.tp_comm_bytes_fp32 += allreduce_bytes(r, d, "fp32")
            self.tp_comm_bytes += allreduce_bytes(r, d, self.comm_dtype)
        for d in self._gather_out_dims:
            self.tp_gather_bytes_fp32 += allgather_bytes(r, d, "fp32")
            self.tp_gather_bytes += allgather_bytes(r, d, self.comm_dtype)

    def reset_attn_counters(self) -> None:
        self.attn_kv_bytes_read = 0.0
        self.attn_kv_bytes_gather = 0.0
        self.tp_comm_bytes = 0.0
        self.tp_comm_bytes_fp32 = 0.0
        self.tp_gather_bytes = 0.0
        self.tp_gather_bytes_fp32 = 0.0

    # ------------------------------------------------------------- steps

    def _stage(self, *host_arrays):
        """Copy host operands to the runner's device, one copy each. On a
        sharded runner that is the first shard's device, which every shard
        of a mesh the port runs shares (the JAX runner's one replicated
        device_put)."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in host_arrays)

    def stage_host_pages(self, layer_data):
        """Stage host-tier pages onto the runner's device ahead of the step
        that reads them. ``layer_data`` is the host tier's slot layout: per
        layer a tuple of page tensors (K / V pages, and the scale rows on
        int8 pools), of one slot or of a run of slots (a leading slot
        axis). The copies are non-blocking on the current stream;
        the engine issues them on the host tier's side stream from pinned
        buffers, so they overlap device work, and its fence orders the
        compute stream after them. On the CPU the tensors come back as
        they are. On a sharded runner the pages stay in the logical layout
        (all kv heads) on the shards' device, and `KVCachePool.write_pages`
        scatters each shard's head slice into its pools (a departure: the
        JAX runner stages them head-sharded)."""
        return [tuple(a.to(self.device, non_blocking=True) for a in layer)
                for layer in layer_data]

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
        self._account_comm(tb)
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
        return _CudaGraph(_capture_stream(self.device))

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
        with _CAPTURE_LOCK:
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

    def _decode_multi_spec_body(self, pools, tokens, tables, pos, drafts,
                                seeds, base_steps, temps, stop_ids,
                                remaining, *, top_k, top_p, sampling: bool):
        """The speculative horizon: every inner step feeds row b the span
        [fed token, drafts[b, t, :]] (-1-padded drafts; q_len 1 + #real
        drafts, 0 once the row is done) through the ragged forward, then
        resolves accept / reject on the device: emission i is the argmax
        (or the seeded sample at step base + emitted + i) of span position
        i, KEPT iff the row is live, every earlier draft matched its
        emission and no earlier kept emission hit a stop or the budget.
        The last kept emission feeds the next step and the row's position
        advances by its kept count. Writes past max_model_len go to the
        scratch page. Returns packed [3, B, s, K + 1] int32: emitted
        tokens, finite flags, the KEEP mask (a per-step prefix; the host
        replays nothing past it)."""
        B, num_steps, K = drafts.shape
        T = K + 1
        offs = torch.arange(T, device=tokens.device)[None, :]       # [1, T]
        toks, p = tokens.long(), pos.long()
        done = torch.zeros(B, dtype=torch.bool, device=tokens.device)
        cnt = torch.zeros_like(p)
        zero = torch.zeros_like(p)
        out_t, out_f, out_k = [], [], []
        for t in range(num_steps):
            draft_t = drafts[:, t].long()                           # [B, K]
            ndraft = (draft_t >= 0).long().sum(dim=1)
            span = torch.cat([toks[:, None], draft_t.clamp(min=0)], dim=1)
            q_lens = torch.where(done, zero, ndraft + 1)
            valid = ((offs < q_lens[:, None])
                     & (p[:, None] + offs < self.max_model_len))
            positions = torch.where(valid, p[:, None] + offs,
                                    torch.zeros_like(offs))
            page, off = self._write_indices(positions, tables, valid)
            logits, _ = self._forward(span, positions, page, off, tables,
                                      p.to(torch.int32),
                                      q_lens.to(torch.int32), pools)
            nxt = torch.argmax(logits, dim=-1)                      # [B, T]
            fin = torch.isfinite(logits).all(dim=-1)
            if sampling:
                steps = base_steps.long()[:, None] + cnt[:, None] + offs
                sampled = self._sampled_span(logits, seeds, steps, temps,
                                             top_k, top_p)
                nxt = torch.where(temps[:, None] > 0.0, sampled, nxt)
            match = (draft_t == nxt[:, :K]) & (draft_t >= 0)
            hit = (nxt[:, :, None] == stop_ids.long()[:, None, :]).any(dim=2)
            pos_done = hit | (cnt[:, None] + 1 + offs
                              >= remaining.long()[:, None])
            cont = match & torch.logical_not(pos_done[:, :K])
            live = torch.logical_not(done)
            keep = torch.cat(
                [live[:, None],
                 live[:, None] & torch.cumprod(cont.long(), dim=1).bool()],
                dim=1)                                              # [B, T]
            m = keep.long().sum(dim=1)
            last = (m - 1).clamp(min=0)
            fb = torch.gather(nxt, 1, last[:, None])[:, 0]
            toks = torch.where(m > 0, fb, toks)
            done = done | (keep & pos_done).any(dim=1)
            p = p + m
            cnt = cnt + m
            out_t.append(nxt)
            out_f.append(fin)
            out_k.append(keep)
        return torch.stack([torch.stack(out_t, 1).to(torch.int32),
                            torch.stack(out_f, 1).to(torch.int32),
                            torch.stack(out_k, 1).to(torch.int32)])

    @staticmethod
    def _sampled_span(logits, seeds, steps, temps, top_k, top_p):
        """Seeded sampling of every position of logits [B, T, V]: position
        i of row b draws with fold_in(key(seeds[b]), steps[b, i]) through
        `_sampled_rows` (the per-step stream's function, row by row).
        Returns int64 tokens [B, T]."""
        B, T, V = logits.shape
        return PagedModelRunner._sampled_rows(
            logits.reshape(B * T, V), seeds.repeat_interleave(T),
            steps.reshape(-1), temps.repeat_interleave(T), top_k,
            top_p).reshape(B, T)

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
        self._account_comm(B)
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
        self._account_comm(B, steps=num_steps)
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

    @torch.no_grad()
    def decode_multi_spec(self, tokens, tables, pos, pools, drafts, *,
                          seeds=None, base_steps=None, temps=None,
                          top_k=None, top_p=None, stop_ids=None,
                          remaining=None):
        """Speculative horizon: ``drafts.shape[1]`` inner steps, each
        carrying a [B, K] -1-padded draft span verified and accepted on
        the device (`_decode_multi_spec_body`). tokens [B] (the fed last
        tokens), tables [B, P] (mapping every page the funded writes can
        touch), pos [B], drafts [B, s, K] int32 with K + 1 a `bucket_len`
        bucket, so a fused span takes the per-step verify path's
        attention path. The stop plane (stop_ids [B, S] -1-padded,
        remaining [B]) is always on; seeds / base_steps / temps turn on
        seeded sampling as in `decode_multi`. Returns (packed [3, B, s,
        K + 1] int32, pools): tokens, finite flags, keep mask; on the card
        one CUDA graph replay."""
        drafts = np.asarray(drafts, np.int32)
        if drafts.ndim != 3 or drafts.shape[1] < 1:
            raise ValueError(
                f"drafts must be [B, num_steps>=1, K], got {drafts.shape}")
        B, num_steps, K = drafts.shape
        pos_np = np.asarray(pos, np.int32)
        tabs = np.asarray(tables, np.int32)
        P = tabs.shape[1]
        impl = self._attn_impl_for(K + 1)
        spans = np.full((B,), K + 1, np.int32)
        for t in range(num_steps):   # upper-bounds the per-step reads
            self._account_attn(impl, pos_np + t * (K + 1), spans, P)
        self._account_comm(B * (K + 1), steps=num_steps)
        sampling = temps is not None
        seeds = np.zeros((B,), np.int64) if seeds is None \
            else np.asarray(seeds, np.int64)
        base_steps = np.zeros((B,), np.int32) if base_steps is None \
            else np.asarray(base_steps, np.int32)
        temps = np.zeros((B,), np.float32) if temps is None \
            else np.asarray(temps, np.float32)
        stop_ids = np.full((B, 1), -1, np.int32) if stop_ids is None \
            else np.asarray(stop_ids, np.int32)
        remaining = np.full((B,), num_steps * (K + 1), np.int32) \
            if remaining is None else np.asarray(remaining, np.int32)

        def body(pools_, *ops):
            return self._decode_multi_spec_body(
                pools_, *ops, top_k=top_k, top_p=top_p, sampling=sampling)
        key = (B, P, num_steps, K, top_k, top_p, sampling,
               stop_ids.shape[1])
        host = (np.asarray(tokens, np.int32), tabs, pos_np, drafts, seeds,
                base_steps, temps, stop_ids, remaining)
        return self._launch("decode_multi_spec", key, body, host,
                            pools), pools

    # ------------------------------------------------------------ ragged

    def _ragged_core(self, pools, tokens, tables, start_pos, q_lens):
        """One mixed ragged batch on device operands: tokens [B, T], every
        slot its own span (decode rows q_len 1, prefill chunks at an
        offset, verify spans 1 + k, dead slots 0) in ONE forward. Returns
        logits [B, T, V]; rows past a span's q_len are never read."""
        T = tokens.shape[1]
        offs = torch.arange(T, device=tokens.device)[None, :]       # [1, T]
        valid = offs < q_lens.long()[:, None]
        positions = torch.where(valid, start_pos.long()[:, None] + offs,
                                torch.zeros_like(offs))
        page, off = self._write_indices(positions, tables, valid)
        logits, _ = self._forward(tokens.long(), positions, page, off,
                                  tables, start_pos, q_lens, pools)
        return logits

    def _ragged_step(self, pools, tokens, tables, start_pos, q_lens):
        """`_ragged_core` returning each slot's logits at its span's LAST
        live row only: [B, V]."""
        logits = self._ragged_core(pools, tokens, tables, start_pos, q_lens)
        last = (q_lens.long() - 1).clamp(min=0)
        return logits[torch.arange(logits.shape[0], device=logits.device),
                      last]

    @torch.no_grad()
    def ragged_step(self, tokens, tables, start_pos, q_lens, pools,
                    full_logits: bool = False):
        """One mixed ragged batch (the fused chunk + decode step): tokens
        [B, T] with T a `bucket_len` bucket (verify spans and chunks share
        the bucket rule, so a 1 + k verify span lands in the 8-row
        bucket), tables [B, P], start_pos / q_lens [B]. Returns (logits,
        pools): [B, V] at each span's last live row, or [B, T, V] with
        ``full_logits`` (the speculative verify step scores every span
        position from one launch). Runs eagerly."""
        tokens = np.asarray(tokens, np.int32)
        T = tokens.shape[1]
        start_pos = np.asarray(start_pos, np.int32)
        q_lens = np.asarray(q_lens, np.int32)
        tabs = np.asarray(tables, np.int32)
        self._account_attn(self._attn_impl_for(T), start_pos, q_lens,
                           tabs.shape[1])
        self._account_comm(tokens.shape[0] * T)
        body = self._ragged_core if full_logits else self._ragged_step
        return body(pools, *self._stage(tokens, tabs, start_pos,
                                        q_lens)), pools

    def _forward(self, tokens, positions, write_page, write_off, tables,
                 pos_q, q_lens, pools):
        raise NotImplementedError


class LlamaRunner(PagedModelRunner):
    """Paged-step adapter for models.Llama (RMSNorm + RoPE + GQA +
    SwiGLU). The runner serves the model's own parameters (moved to
    ``device`` when they live elsewhere), the matmul weights through
    `_mm` (the weight ladder quantizes its own dict entries). The `x @ w`
    products are plain torch.matmul in the runner's dtype (fp32 with TF32
    off, bf16 or fp16). The norms and RoPE compute in fp32 and cast back to
    the activations' dtype at the JAX runner's points. The positional
    parameters are the JAX runner's; ``device`` is keyword-only after
    them."""

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
        if weight_dtype != "fp32":
            names = [f"layers.{i}.{n}" for i in range(self.num_layers)
                     for n in ("self_attn.q_proj.weight",
                               "self_attn.k_proj.weight",
                               "self_attn.v_proj.weight",
                               "self_attn.o_proj.weight",
                               "mlp.gate_proj.weight", "mlp.up_proj.weight",
                               "mlp.down_proj.weight")]
            if "lm_head.weight" in self.params:
                names.append("lm_head.weight")
            # embeddings stay floating (a lookup table; a tied head too)
            self._quantize_weights(names)

    def _param_specs(self, layout):
        """Megatron placements of the Llama block (the JAX runner's):
        Q / K / V and gate / up column-parallel, o_proj / down_proj
        row-parallel, embeddings vocab-sharded, an untied lm_head
        column-parallel; norms replicated."""
        col, row = layout.column_parallel(), layout.row_parallel()
        specs = {"embed_tokens.weight": layout.embeddings()}
        for i in range(self.num_layers):
            pre = f"layers.{i}."
            for n in ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                      "self_attn.v_proj.weight", "mlp.gate_proj.weight",
                      "mlp.up_proj.weight"):
                specs[pre + n] = col
            specs[pre + "self_attn.o_proj.weight"] = row
            specs[pre + "mlp.down_proj.weight"] = row
        if "lm_head.weight" in self.params:
            specs["lm_head.weight"] = col
        return specs

    def _move_tables(self, device) -> None:
        self._rope_cos = self._rope_cos.to(device)
        self._rope_sin = self._rope_sin.to(device)

    def _rope(self, x, cos, sin):
        # rotate-half convention of ops.rotary_embedding; the fp32 tables
        # promote the product, cast back to x's dtype
        x1, x2 = x.chunk(2, dim=-1)
        rot = torch.cat([-x2, x1], dim=-1)
        return (x * cos[:, :, None, :] + rot * sin[:, :, None, :]).to(x.dtype)

    def _rms(self, x, w):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.cfg.rms_eps)).to(x.dtype) * w

    def _forward(self, tokens, positions, write_page, write_off, tables,
                 pos_q, q_lens, pools):
        """One forward over the runner's shards (one when unsharded):
        ``pools`` holds each shard's layer tuples. Replicated activations
        (the residual stream, the norms) are computed once on the first
        shard's device; each shard runs its column products, its attention
        at n_heads / tp and n_kv_heads / tp heads over its own pool slices
        (the kernels launch once a shard), and its row products' partials,
        which the layout's reduce sums: two reductions a layer, plus the
        vocab-sharded embedding's."""
        cfg = self.cfg
        B, T = tokens.shape
        d, tp = self.head_dim, self.tp_size
        nh, nkv = self.n_heads // tp, self.n_kv_heads // tp
        impl = self._attn_impl_for(T)
        ctx = self._shard_ctx
        x = self._embed("embed_tokens.weight", tokens)
        cos = self._rope_cos[positions]                      # [B, T, d]
        sin = self._rope_sin[positions]
        p0 = self._shard_params[0]
        for i in range(cfg.num_layers):
            pre = f"layers.{i}."
            h = self._rms(x, p0[pre + "input_layernorm.weight"])
            qs = self._col(pre + "self_attn.q_proj.weight", h)
            ks = self._col(pre + "self_attn.k_proj.weight", h)
            vs = self._col(pre + "self_attn.v_proj.weight", h)
            outs = []
            for sh, dev in enumerate(self._shard_devices):
                c, sn = cos.to(dev), sin.to(dev)
                q = self._rope(qs[sh].reshape(B, T, nh, d), c, sn)
                k = self._rope(ks[sh].reshape(B, T, nkv, d), c, sn)
                v = vs[sh].reshape(B, T, nkv, d)
                out, _ = paged_attend(
                    q, k, v, pools[sh][i], tables.to(dev),
                    write_page.to(dev), write_off.to(dev), pos_q.to(dev),
                    q_lens.to(dev), self.n_rep, impl, shard_ctx=ctx)
                outs.append(out)
            x = x + self._row(pre + "self_attn.o_proj.weight", outs)
            h = self._rms(x, p0[pre + "post_attention_layernorm.weight"])
            gates = self._col(pre + "mlp.gate_proj.weight", h)
            ups = self._col(pre + "mlp.up_proj.weight", h)
            x = x + self._row(pre + "mlp.down_proj.weight",
                              [F.silu(g) * u for g, u in zip(gates, ups)])
        x = self._rms(x, p0["norm.weight"])
        return self._logits(x, "lm_head.weight", "embed_tokens.weight"), pools


class GPTRunner(PagedModelRunner):
    """Paged-step adapter for models.GPT (pre-LN, learned positions, fused
    QKV, GELU MLP), its matmuls through the runner's `_mm` and its norms
    through the generators' `models.generation._layer_norm`. MHA: the
    pools hold all ``num_heads`` heads (n_rep 1), so a decode step takes
    the paged-decode kernel (K2) over fp32, bf16, fp16 and mixed pools and
    the ragged kernel's decode form (K1-q) over int8 / fp8 pools, and prefill
    chunks the ragged kernel (its span form; a chunk of at most 8 rows its
    decode form). The weight ladder quantizes the fused QKV, the output
    projection, the dense MLP and an untied head; the positional
    parameters are the JAX runner's, ``device`` keyword-only after them.
    Over a mesh (`shard`) the JAX runner's placements apply
    (`_param_specs`)."""

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
        if weight_dtype != "fp32":
            # the fused QKV weight is flat [hidden, 3 nh d], so its
            # per-output-channel and group scales are per fused column;
            # MoE blocks (mlp.gate) keep their expert weights floating
            names = []
            for i in range(self.num_layers):
                pre = f"blocks.{i}."
                names += [pre + "attn.qkv.weight", pre + "attn.out.weight"]
                if pre + "mlp.fc1.weight" in self.params:
                    names += [pre + "mlp.fc1.weight", pre + "mlp.fc2.weight"]
            if "lm_head.weight" in self.params:
                names.append("lm_head.weight")
            self._quantize_weights(names)

    def _param_specs(self, layout):
        """GPT placements (the JAX runner's): the fused attn.qkv keeps its
        (3, heads, d) columns replicated (a flat column shard would split
        across q / k / v; the head-sharded pools carry the attention
        split), out-proj and fc2 row-parallel, fc1 and its bias
        column-parallel, the vocab matrices sharded."""
        col, row = layout.column_parallel(), layout.row_parallel()
        specs = {"wte.weight": layout.embeddings()}
        for i in range(self.num_layers):
            pre = f"blocks.{i}."
            specs[pre + "attn.out.weight"] = row
            specs[pre + "mlp.fc1.weight"] = col
            specs[pre + "mlp.fc1.bias"] = layout.bias_column()
            specs[pre + "mlp.fc2.weight"] = row
        if "lm_head.weight" in self.params:
            specs["lm_head.weight"] = col
        return specs

    def _forward(self, tokens, positions, write_page, write_off, tables,
                 pos_q, q_lens, pools):
        """One forward over the runner's shards, as `LlamaRunner._forward`:
        the replicated fused QKV product is computed once and each shard
        attends over its heads of it."""
        cfg = self.cfg
        B, T = tokens.shape
        d, tp = self.head_dim, self.tp_size
        nh = self.n_heads // tp
        impl = self._attn_impl_for(T)
        ctx = self._shard_ctx
        p0 = self._shard_params[0]
        x = self._embed("wte.weight", tokens) + p0["wpe.weight"][positions]
        for i in range(cfg.num_layers):
            pre = f"blocks.{i}."
            if pre + "mlp.gate" in p0:
                raise NotImplementedError(
                    f"a switch-MoE block (mlp.gate) is not ported yet: "
                    f"{DIST_ITEM}")
            h = _layer_norm(x, p0[pre + "ln1.weight"], p0[pre + "ln1.bias"])
            qkv = (self._mm(p0, pre + "attn.qkv.weight", h)
                   + p0[pre + "attn.qkv.bias"]).reshape(B, T, 3,
                                                        self.n_heads, d)
            outs = []
            for sh, dev in enumerate(self._shard_devices):
                q, k, v = (qkv[:, :, j, sh * nh:(sh + 1) * nh].contiguous()
                           .to(dev) for j in range(3))
                out, _ = paged_attend(
                    q, k, v, pools[sh][i], tables.to(dev),
                    write_page.to(dev), write_off.to(dev), pos_q.to(dev),
                    q_lens.to(dev), 1, impl, shard_ctx=ctx)
                outs.append(out)
            x = x + (self._row(pre + "attn.out.weight", outs)
                     + p0[pre + "attn.out.bias"])
            h = _layer_norm(x, p0[pre + "ln2.weight"], p0[pre + "ln2.bias"])
            hs = [F.gelu(f + self._shard_slice(pre + "mlp.fc1.bias", sh),
                         approximate="tanh")
                  for sh, f in enumerate(self._col(pre + "mlp.fc1.weight",
                                                   h))]
            x = x + (self._row(pre + "mlp.fc2.weight", hs)
                     + p0[pre + "mlp.fc2.bias"])
        x = _layer_norm(x, p0["ln_f.weight"], p0["ln_f.bias"])
        return self._logits(x, "lm_head.weight", "wte.weight"), pools


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
