"""ServingEngine: continuous-batching generation over the paged KV pool.

Counterpart of paddle_tpu/serving/engine.py's default loop: an admission
queue feeds a fixed-slot decode batch; prefill computes a new request's
context in CHUNKS bounded by a per-step token budget
(`max_prefill_tokens_per_step`), then every step decodes one token for
every decode-phase request in a single batched call; finished requests
free their pages and their slot is refilled from the queue.

The engine is deterministic end-to-end: FCFS admission, sorted-free-list
pages, greedy or seeded sampling (temperature > 0 draws with
fold_in(key(seed), generated-token index), the JAX package's threefry
stream, `core.random`). `naive_generate` is the scheduling oracle: the
same runner, one request at a time, no scheduler — continuous batching
must reproduce its tokens exactly.

Four knobs change how decode runs, never its tokens:
  decode_horizon=s     a decode batch with no prefill chunk this step
                       runs up to s steps in one runner.decode_multi
                       call (a CUDA graph on the card), each token fed
                       back on the device, and the host drains one
                       packed [2|3, B, s] buffer per horizon; the buffer
                       replays token by token through the per-step
                       bookkeeping, and tokens past a stop are discarded
                       with their pages (horizon_overshoot_tokens)
  horizon_sampling     temperature > 0 batches ride the horizon too, the
                       seeded sampler inside the device loop (one
                       (top_k, top_p) per batch, else the per-step path)
  horizon_early_stop   a row that hits its stop set or budget freezes on
                       the device (K/V writes to scratch), so overshoot
                       is neither computed nor replayed
  pipelined            step() plans (deadlines, admission, chunk slices)
                       while the previous step's decode launch runs, then
                       commits it (drain + replay) and leaves this step's
                       launch in flight: one launch in flight, a step
                       returns the previous launch's tokens, and
                       run() / has_work() / flush() drain the tail

Four more change what a step computes, never its tokens:
  enable_prefix_cache  full KV pages are refcounted and hash-indexed;
                       admission maps the longest cached page-aligned
                       prefix into the table (prefix_hit_tokens), and a
                       write that would touch a shared page forks it
                       first (cow_copies); the fork is an in-place copy
                       on the current stream, ordered before the step
                       that writes it
  ragged_batch         a step with prefill chunks AND decode rows runs
                       them in ONE runner.ragged_step call (one
                       ragged-kernel launch a layer); a request whose
                       prefill completes inside it decodes next step
  num_speculative_tokens=k
                       up to k draft tokens (n-gram prompt lookup, or a
                       draft model: spec_draft_model) ride each decode
                       row's span; the longest prefix the target model
                       reproduces is accepted in one step and the
                       rejected tail's pages roll back. A step with
                       prefill chunks (or a batch outside the horizon
                       sampler's envelope) verifies through one
                       full-logits ragged_step; otherwise the drafts
                       ride a device-resident horizon
                       (runner.decode_multi_spec, a CUDA graph on the
                       card) that accepts on the device, one drain per
                       horizon (spec_fused_horizons)
  host_tier_pages=N    a host KV tier of N pinned pages (`HostKVTier`): a
                       preemption spills the victim's exclusively owned
                       pages there and its resume pages them back in,
                       bit for bit (offload_resumes, pagein_pages); the
                       prefix cache demotes evicted pages there. The
                       tier's copies run on a side stream; `_fence_pagein`
                       makes the compute stream wait for a page-in before
                       it scatters the pages, so every launch of the step
                       (graph replays included, on the same stream) reads
                       them. pagein_prefetch stages the next offloaded
                       waiters' pages at the end of a step
                       (pagein_hidden_ratio), host_tier_headroom counts
                       free host slots as admission headroom, spill_async
                       waits for a spill's copies and hashes them on a
                       worker thread

`snapshot` serializes every request's state as JSON, and
`ServingEngine.restore` rebuilds an engine from it, each request
re-entering through `inject_request` and recompute-on-resume, token for
token as an uninterrupted run (host pages do not survive). With a
``tokenizer``, `stream_text` gives a request's text so far through a
`StreamDetokenizer` (a multi-byte character split across tokens waits for
its last byte).

Sampling runs where the logits live, through the runner's
`_sampled_rows`: the per-step path samples the [B, V] logits of a decode
call on the device and drains the tokens with the greedy grid in one
transfer; the horizon samples the same rows with the same ops inside
its loop.

Failure modes end requests instead of raising from step():

  finish_reason   trigger
  "stop"/"length" normal completion
  "timeout"       SamplingParams.timeout_s exceeded (queue wait counts)
  "aborted"       engine.abort(request_id)
  "shed"          bounded queue overflowed under shed_policy="drop_oldest"
  "error"         prefill failed past max_step_retries, a decode batch
                  was quarantined, or NaN/Inf logits under nan_policy
                  "abort" (or with no finite entry at all)

The serving tier above the engine (`router.ServingRouter`) moves requests
between engines: `role="prefill"` stages every request whose prefill
completed (first token sampled) in a handoff buffer, its pages spilled to
the host tier from page 0; `extract_handoff` exports them (numpy page
arrays with CRC content hashes) and a sibling's `import_handoff` writes
them into its own tier, re-verifying each hash, and injects the request,
whose admission then pages them in through the tier's side-stream copy
and fence. `stage_migration` stages one running request on demand (a
drain), and `extract_request` takes a waiting one out. With ``kv_store``
(a host-wide `kv_cache.SharedKVStore`, or a replica child's
`store_service.SharedKVStoreClient`) the host tier is a facade over the
store under this engine's ``kv_store_owner`` tag, and a handoff carries
slot references (ids, generations and CRCs) instead of page bytes: the
sender moves its refs to a transfer tag, the receiver adopts them after
checking each generation and CRC.

Where the port departs from the JAX engine: the pools are written in
place, so an in-flight launch carries no snapshot of the pools it read
(`prev_pools`). A fault that surfaces only at the deferred drain reruns
the step from live state through the retry path, which rewrites the
same slots with the same values on fp32 and fp8 pools; on an int8 pool
a rerun horizon quantizes against the page scales the failed run
already grew.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.serving.detokenize import StreamDetokenizer
from paddle_tpu_torch.serving.kv_cache import (
    SCRATCH_PAGE, KVCachePool, OffloadRecord, consecutive_runs,
)
from paddle_tpu_torch.serving.metrics import EngineMetrics
from paddle_tpu_torch.serving.model_runner import (
    PagedModelRunner, bucket_len, runner_for,
)
from paddle_tpu_torch.serving.resilience import QueueFullError, audit_engine
from paddle_tpu_torch.serving.scheduler import (
    FCFSScheduler, Request, RequestState, SamplingParams,
    ensure_arrival_counter_above,
)
from paddle_tpu_torch.serving.speculate import (
    AdaptiveK, DraftModelProposer, NgramProposer, shadow_runner,
)

logger = logging.getLogger(__name__)


@dataclass
class TokenEvent:
    """One streamed token (the engine's per-step output unit)."""

    request_id: str
    token: int
    index: int                   # position within the generated sequence
    finished: bool = False
    finish_reason: Optional[str] = None


@dataclass
class RequestOutput:
    request_id: str
    prompt_tokens: List[int]
    output_tokens: List[int]
    finish_reason: str
    num_preemptions: int = 0
    ttft_s: Optional[float] = None
    e2e_s: Optional[float] = None


def seeded_sample(logits_row, seed: int, step: int, temperature: float,
                  top_k, top_p) -> int:
    """THE seeded sampler of one [V] logits row (temperature > 0): the key
    fold_in(key(seed), step). It runs where the row lives (a numpy row on
    the CPU) through the runner's `_sampled_rows`, the function the
    per-step engine and the horizon loop sample with, so their streams
    are the same bits."""
    row = torch.as_tensor(logits_row)[None]
    dev = row.device
    return int(PagedModelRunner._sampled_rows(
        row, torch.tensor([int(seed)], dtype=torch.int64, device=dev),
        torch.tensor([int(step)], dtype=torch.int64, device=dev),
        torch.tensor([float(temperature)], dtype=torch.float32, device=dev),
        top_k, top_p)[0])


def sample_token(logits_row, sampling: SamplingParams, step: int,
                 fallback_seed: int) -> int:
    """Sample the next token from one [V] logits row (numpy or a tensor).

    Keys are step-indexed (fold_in by generated-token index), so a
    preempted request resumes the identical stream; ``fallback_seed``
    stands in for a request without a seed."""
    if sampling.temperature == 0.0:
        return int(np.argmax(_to_host(logits_row)))
    seed = sampling.seed if sampling.seed is not None else fallback_seed
    return seeded_sample(logits_row, seed, step, sampling.temperature,
                         sampling.top_k, sampling.top_p)


def _to_host(x) -> np.ndarray:
    """THE device->host sync boundary: every blocking drain the engine
    performs funnels through here, so a test can patch this one symbol
    and count how often a step waited on the device."""
    if isinstance(x, torch.Tensor):
        # numpy has no bf16: widen, exactly (fp16 crosses as it is, as
        # the JAX engine's fp16 logits do)
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def greedy_grid(logits):
    """ONE argmax and ONE finiteness reduction over a [..., V] logits
    tensor, computed where the logits live, then ONE small host transfer
    of both as a packed int32 array. Tie-breaking matches np.argmax
    (first max wins)."""
    packed = _to_host(token_grid(logits))
    return packed[0], packed[1].astype(bool)


# one sampled group of a launch: (top_k, top_p, seeds [B], steps [B]
# (or [B, T] for full-logits spans), temps [B], slots)
SampleGroup = Tuple[Optional[int], Optional[float], np.ndarray, np.ndarray,
                    np.ndarray, List[int]]


def token_grid(logits, groups: Sequence[SampleGroup] = ()):
    """The device side of a drain, not yet drained: [2 + G, B(, T)]
    int32 holding the argmax, the all-finite flags and, for each sampled
    group (one (top_k, top_p) each), every row's seeded sample of the
    [B, V] (or [B, T, V] verify-span) logits through `_sampled_rows`,
    position t of row b at step steps[b, t]."""
    planes = [logits.argmax(dim=-1).to(torch.int32),
              torch.isfinite(logits).all(dim=-1).to(torch.int32)]
    dev = logits.device
    rows = logits.reshape(-1, logits.shape[-1])
    for top_k, top_p, seeds, steps, temps, _ in groups:
        n = rows.shape[0] // seeds.shape[0]       # span positions per row
        planes.append(PagedModelRunner._sampled_rows(
            rows, torch.from_numpy(np.repeat(seeds, n)).to(dev),
            torch.from_numpy(np.ascontiguousarray(steps).reshape(-1)).to(dev),
            torch.from_numpy(np.repeat(temps, n)).to(dev),
            top_k, top_p).reshape(logits.shape[:-1]).to(torch.int32))
    return torch.stack(planes)


@dataclass
class _InflightLaunch:
    """One dispatched-but-undrained launch (the pipelined loop's unit of
    deferred work). ``batch`` pins (request, slot) pairs as of launch
    time; a member aborted or expired before the commit is skipped at
    replay. The pools are written in place, so no snapshot of them rides
    along (module docstring)."""

    kind: str        # "decode" | "decode_multi" | "decode_spec" | "ragged"
    batch: list                  # [(Request, slot), ...] at launch
    result: object               # the token grid, or the packed buffer
    s: int = 1                   # horizon length (decode_multi)
    logits: object = None        # decode / ragged: the rows for a rescue
    groups: tuple = ()           # decode / ragged: the grid's groups
    # ragged: (req, start, end, prop, slot) per span as of launch time
    spans: Optional[list] = None
    # decode_spec: the draft grid [B, s, K] for the commit-time replay
    spec: Optional[dict] = None
    # decode_spec: {id(req): funded upcoming tokens} (the auditor's
    # over-provision credit)
    upcoming: Optional[dict] = None


class ServingEngine:
    """Continuous-batching LLM serving over a paged KV cache.

    engine = ServingEngine(runner, num_blocks=64, block_size=16,
                           max_batch_size=8, max_model_len=256)
    rid = engine.add_request([1, 2, 3], SamplingParams(max_tokens=8))
    for events in iter(engine.step, []): ...   # streaming
    outputs = engine.run()                     # or drain to completion

    Robustness knobs (defaults reproduce the happy path):
      max_queue_depth      bound on the waiting queue; None = unbounded
      shed_policy          "reject" (add_request raises QueueFullError) or
                           "drop_oldest" (oldest waiting request is shed)
      admission_watermark  pool fraction beyond which admission pauses
      max_step_retries     transient-failure retries per runner step
      retry_backoff_s      base of the bounded exponential backoff
      nan_policy           "abort" kills a request on NaN/Inf logits;
                           "greedy" argmaxes the finite entries instead
      audit                run resilience.audit_engine after every step
                           (None = the PADDLE_TPU_SERVING_AUDIT env var)
      max_prefill_tokens_per_step
                           per-step prefill token budget: long prompts
                           are computed in chunks of at most this many
                           tokens, interleaved with decode (None = whole
                           context in one chunk)
      decode_horizon, horizon_sampling, horizon_early_stop, pipelined
                           device-resident decode horizons and the
                           pipelined loop (module docstring); defaults
                           1 / False keep the per-step loop
      enable_prefix_cache, ragged_batch, num_speculative_tokens
                           the shared-prefix page cache, fused ragged
                           steps and speculative decoding (module
                           docstring); off by default
      host_tier_pages      capacity in pages of the host KV tier (0 = no
                           tier; module docstring)
      host_tier_headroom   free host slots count as admission headroom
                           above the watermark
      pagein_prefetch      how many queue-head offloaded waiters get their
                           pages staged at the end of a step (0 = stage at
                           the fence only)
      spill_async          a spill's copies are waited for and hashed on a
                           worker thread, never on the engine loop
      spec_max_ngram / spec_min_ngram
                           suffix n-gram lengths the draft proposer
                           matches (longest first, most recent wins)
      spec_ngram_window    bound of the stateless n-gram scan (None =
                           unbounded)
      spec_adaptive_k      per-request draft length from an EWMA of the
                           acceptance rate, in [0, num_speculative_tokens]
      spec_draft_model     None = n-gram prompt lookup; "shadow[:int8|
                           int4|fp8|fp32]" = a shadow of the target
                           runner on that rung of the weight ladder
                           ("shadow" alone is int8), proposing greedy
                           chains from its own pool (spec_draft_blocks
                           pages); or a runner instance
      tokenizer            for `stream_text`: an object with
                           id_to_bytes(tok), convert_ids_to_tokens (HF
                           style) or decode([tok])
    """

    def __init__(self, runner: PagedModelRunner, *, num_blocks: int,
                 block_size: Optional[int] = None, max_batch_size: int = 8,
                 max_model_len: Optional[int] = None,
                 metrics: Optional[EngineMetrics] = None,
                 max_queue_depth: Optional[int] = None,
                 shed_policy: str = "reject",
                 admission_watermark: float = 1.0,
                 max_step_retries: int = 2,
                 retry_backoff_s: float = 0.02,
                 nan_policy: str = "abort",
                 max_prefill_tokens_per_step: Optional[int] = None,
                 enable_prefix_cache: bool = False,
                 host_tier_pages: int = 0,
                 host_tier_headroom: bool = False,
                 pagein_prefetch: int = 2,
                 ragged_batch: bool = False,
                 decode_horizon: int = 1,
                 pipelined: bool = False,
                 horizon_sampling: bool = False,
                 horizon_early_stop: bool = False,
                 spill_async: bool = False,
                 role: str = "mixed",
                 kv_store=None,
                 kv_store_owner: Optional[str] = None,
                 num_speculative_tokens: int = 0,
                 spec_max_ngram: int = 3,
                 spec_min_ngram: int = 1,
                 spec_adaptive_k: bool = False,
                 spec_draft_model=None,
                 spec_draft_blocks: Optional[int] = None,
                 spec_ngram_window: Optional[int] = None,
                 tokenizer=None,
                 sleep_fn: Optional[Callable[[float], None]] = None,
                 audit: Optional[bool] = None):
        self.runner = runner
        block_size = block_size or runner.block_size
        if block_size != runner.block_size:
            raise ValueError(
                f"engine block_size={block_size} != runner.block_size="
                f"{runner.block_size} — they share the pool layout")
        self.max_model_len = max_model_len or runner.max_model_len
        if self.max_model_len > runner.max_model_len:
            raise ValueError("max_model_len exceeds the runner's rope table "
                             f"length {runner.max_model_len}")
        if shed_policy not in ("reject", "drop_oldest"):
            raise ValueError(f"shed_policy={shed_policy!r}; expected "
                             "'reject' or 'drop_oldest'")
        if nan_policy not in ("abort", "greedy"):
            raise ValueError(f"nan_policy={nan_policy!r}; expected "
                             "'abort' or 'greedy'")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 (None = unbounded)")
        if decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1 (1 = sync with "
                             "the host every step)")
        self.decode_horizon = int(decode_horizon)
        self.pipelined = bool(pipelined)
        self.horizon_sampling = bool(horizon_sampling)
        self.horizon_early_stop = bool(horizon_early_stop)
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"role={role!r}; expected 'mixed', "
                             "'prefill', or 'decode'")
        self.role = role
        # the handoff buffer: requests a prefill-role engine finished
        # prefilling (or a drain staged), request id -> OffloadRecord of
        # their spilled pages (None: no pages could ride, the receiver
        # recomputes); the requests stay in self._requests until
        # extract_handoff()
        self._handoffs: Dict[str, Optional[OffloadRecord]] = {}
        # the pipelined loop's single in-flight launch: dispatched at the
        # end of one step, drained and replayed by the next (or flush())
        self._inflight: Optional[_InflightLaunch] = None
        # the KV storage rung is a runner property: the runner quantizes at
        # append time, so the engine builds its pools with the same rung,
        # in the runner's dtype (fp32, or bf16 / fp16 after a dtype= cast)
        self.kv_dtype = runner.kv_dtype
        # a sharded runner (runner.shard(mesh)) brings its mesh along: the
        # pools are born split on the kv-head axis over its model axis;
        # the allocator, tables, scheduler and prefix cache stay mesh-blind
        self.mesh = getattr(runner, "mesh", None)
        self.pool = KVCachePool(runner.num_layers, num_blocks, block_size,
                                runner.n_kv_heads, runner.head_dim,
                                runner.dtype, mesh=self.mesh,
                                model_axis=getattr(runner, "model_axis",
                                                   "model"),
                                kv_dtype=self.kv_dtype,
                                device=runner.device)
        self.enable_prefix_cache = bool(enable_prefix_cache)
        if self.enable_prefix_cache:
            self.pool.enable_prefix_cache()
        if host_tier_pages < 0:
            raise ValueError("host_tier_pages must be >= 0 (0 = no host "
                             "tier)")
        if pagein_prefetch < 0:
            raise ValueError("pagein_prefetch must be >= 0")
        self.host_tier_pages = int(host_tier_pages)
        self.host_tier_headroom = bool(host_tier_headroom)
        self.pagein_prefetch = int(pagein_prefetch)
        self.spill_async = bool(spill_async)
        self.ragged_batch = bool(ragged_batch)
        if num_speculative_tokens < 0:
            raise ValueError("num_speculative_tokens must be >= 0 (0 = "
                             "speculation off)")
        self.num_speculative_tokens = int(num_speculative_tokens)
        self.spec_max_ngram = int(spec_max_ngram)
        self.spec_min_ngram = int(spec_min_ngram)
        self.spec_adaptive_k = bool(spec_adaptive_k)
        self.spec_ngram_window = (int(spec_ngram_window)
                                  if spec_ngram_window else None)
        self.spec_draft_blocks = (int(spec_draft_blocks)
                                  if spec_draft_blocks else None)
        # the draft rung: None = n-gram prompt lookup, a "shadow[:dtype]"
        # string, or a runner instance (recorded as "custom")
        self.spec_draft_model = (spec_draft_model
                                 if isinstance(spec_draft_model, str)
                                 else None if spec_draft_model is None
                                 else "custom")
        self.proposer = None
        if self.num_speculative_tokens:
            if spec_draft_model is not None:
                if isinstance(spec_draft_model, str):
                    base, _, dt = spec_draft_model.partition(":")
                    if base != "shadow":
                        raise ValueError(
                            f"spec_draft_model={spec_draft_model!r}; "
                            "expected a runner instance or "
                            "'shadow[:int8|int4|fp8|fp32]'")
                    draft = shadow_runner(runner, dt or "int8")
                else:
                    draft = spec_draft_model
                self.proposer = DraftModelProposer(
                    draft, num_blocks=self.spec_draft_blocks,
                    max_model_len=self.max_model_len)
            else:
                self.proposer = NgramProposer(
                    self.spec_max_ngram, self.spec_min_ngram,
                    scan_window=self.spec_ngram_window)
        self.adaptive_k = (AdaptiveK(self.num_speculative_tokens)
                           if self.num_speculative_tokens
                           and self.spec_adaptive_k else None)
        self.tokenizer = tokenizer
        self._detoks: Dict[str, StreamDetokenizer] = {}
        self.max_pages_per_seq = self.pool.blocks_for_tokens(
            self.max_model_len)
        self.scheduler = FCFSScheduler(self.pool, max_batch_size,
                                       self.max_pages_per_seq,
                                       admission_watermark,
                                       max_prefill_tokens_per_step,
                                       count_host_headroom=(
                                           self.host_tier_headroom))
        self.admission_watermark = admission_watermark
        self.max_batch_size = max_batch_size
        self.max_prefill_tokens_per_step = max_prefill_tokens_per_step
        self.max_queue_depth = max_queue_depth
        self.shed_policy = shed_policy
        self.max_step_retries = max_step_retries
        self.retry_backoff_s = retry_backoff_s
        self.nan_policy = nan_policy
        self._sleep = sleep_fn or time.sleep
        if audit is None:
            audit = os.environ.get("PADDLE_TPU_SERVING_AUDIT",
                                   "") not in ("", "0")
        self.audit = audit
        self.metrics = metrics or EngineMetrics()
        # static per-pool ratios: the page-byte reduction (scale bytes
        # counted) and the matching sessions-per-fixed-memory factor
        self.metrics.kv_bytes_reduction_x.set(
            self.pool.kv_bytes_reduction_x())
        self.metrics.sessions_per_pool_x.set(
            self.pool.kv_bytes_reduction_x())
        self.metrics.weight_bytes_reduction_x.set(
            float(runner.weight_bytes_reduction_x()))
        # the host tier, built after the metrics it mirrors its spill and
        # drop accounting into; with a kv_store, a facade over the
        # host-wide store (its capacity, refs under this engine's owner)
        self.kv_store = kv_store
        self.kv_store_owner = (str(kv_store_owner) if kv_store_owner
                               else f"eng-{id(self):x}")
        if kv_store is not None:
            self.pool.enable_host_tier(kv_store.max_pages,
                                       metrics=self.metrics,
                                       async_spill=self.spill_async,
                                       store=kv_store,
                                       owner=self.kv_store_owner)
        elif self.host_tier_pages:
            self.pool.enable_host_tier(self.host_tier_pages,
                                       metrics=self.metrics,
                                       async_spill=self.spill_async)
        # page-ins staged ahead of their fence: (slot, generation) ->
        # (the step that issued them, (staged tensors, copy event)); the
        # generation makes an entry dead once its slot is freed
        self._pagein_staged: Dict[tuple, tuple] = {}
        self._step_count = 0
        self._requests: Dict[str, Request] = {}
        self._outputs: Dict[str, RequestOutput] = {}

    # ----------------------------------------------------------- intake

    def _check_kv_dtype(self, sampling: SamplingParams) -> None:
        """Per-request KV precision gate: a homogeneous pool serves only
        its own rung; a "mixed" pool serves fp32 and fp8 tenants side by
        side (pages tagged at allocation). Loud at intake: a silently
        widened or narrowed tenant would break the byte accounting and
        the accuracy story."""
        want = sampling.kv_dtype
        if want is None:
            return
        allowed = ({"fp32", "fp8"} if self.kv_dtype == "mixed"
                   else {self.pool.native_kv_tag()})
        if want not in allowed:
            raise ValueError(
                f"SamplingParams.kv_dtype={want!r} is not servable by this "
                f"engine's kv_dtype={self.kv_dtype!r} pool (allowed: "
                f"{sorted(allowed)}); build the engine with "
                "kv_dtype='mixed' to serve mixed-precision tenants from "
                "one pool geometry")

    def add_request(self, prompt_tokens: Sequence[int],
                    sampling: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None) -> str:
        sampling = sampling or SamplingParams()
        self._check_kv_dtype(sampling)
        req = Request(prompt_tokens=list(map(int, prompt_tokens)),
                      sampling=sampling, request_id=request_id or "")
        if len(req.prompt_tokens) + sampling.max_tokens > self.max_model_len:
            raise ValueError(
                f"prompt({len(req.prompt_tokens)}) + max_tokens"
                f"({sampling.max_tokens}) exceeds max_model_len="
                f"{self.max_model_len}")
        if (self.max_queue_depth is not None
                and self.scheduler.queue_depth >= self.max_queue_depth):
            self.metrics.shed_requests.inc()
            if self.shed_policy == "reject":
                raise QueueFullError(
                    f"admission queue full ({self.scheduler.queue_depth} "
                    f"waiting >= max_queue_depth={self.max_queue_depth}); "
                    "shed_policy='reject'")
            # drop-oldest-waiting: freshness beats age under overload
            self._finish_abnormal(self.scheduler.waiting[0], "shed",
                                  counted=True)
        req.arrival_time = self.metrics.clock()
        self._requests[req.request_id] = req
        self.scheduler.add(req)
        self.metrics.requests_added.inc()
        self.metrics.queue_depth.set(self.scheduler.queue_depth)
        return req.request_id

    def abort(self, request_id: str, reason: str = "aborted") -> bool:
        """Cancel an in-flight request: its pages/slot are freed and the
        output surfaces with finish_reason="aborted". Returns False if the
        request is unknown or already finished."""
        req = self._requests.get(request_id)
        if req is None or req.done:
            return False
        self._finish_abnormal(req, reason)
        self.metrics.queue_depth.set(self.scheduler.queue_depth)
        return True

    def has_work(self) -> bool:
        # an in-flight launch is work: the pipelined loop's last launch
        # still needs its commit after the queue drains
        return self.scheduler.has_work() or self._inflight is not None

    def _timed_drain(self, fn):
        """Run one blocking device->host drain, charging its wall time to
        drain_wait_seconds."""
        t0 = self.metrics.clock()
        try:
            return fn()
        finally:
            self.metrics.drain_wait_seconds.inc(self.metrics.clock() - t0)

    # ------------------------------------------------- failure plumbing

    def _finish_abnormal(self, req: Request, reason: str,
                         counted: bool = False) -> None:
        """Terminate a request on a non-token path (timeout / abort / shed
        / error): release whatever it holds, record the RequestOutput with
        the partial generation, bump the matching failure counter."""
        now = self.metrics.clock()
        if req.request_id in self._handoffs:
            # staged for handoff: not in the waiting queue; release the
            # spilled host slots and finish in place
            rec = self._handoffs.pop(req.request_id)
            if rec is not None and self.pool.host_tier is not None:
                self.pool.host_tier.free_slots(rec.slots)
            req.state = RequestState.FINISHED
            req.finish_reason = reason
        elif req.state is RequestState.RUNNING:
            self.scheduler.finish(req, reason)
        else:
            self.scheduler.remove_waiting(req)
            req.state = RequestState.FINISHED
            req.finish_reason = reason
        self._release_spec_state(req)
        req.finish_time = now
        if not counted:        # shed is pre-counted at the add_request gate
            counter = {"timeout": self.metrics.requests_timed_out,
                       "shed": self.metrics.shed_requests}.get(
                           reason, self.metrics.requests_aborted)
            counter.inc()
        self._outputs[req.request_id] = RequestOutput(
            request_id=req.request_id,
            prompt_tokens=list(req.prompt_tokens),
            output_tokens=list(req.output_tokens),
            finish_reason=reason,
            num_preemptions=req.num_preemptions,
            ttft_s=(req.first_token_time - req.arrival_time
                    if req.first_token_time is not None else None),
            e2e_s=now - req.arrival_time)

    def _expire_deadlines(self) -> None:
        """Time out every request (queued or running) past its deadline —
        queue wait counts against timeout_s."""
        now = self.metrics.clock()
        for req in (*self.scheduler.running, *self.scheduler.waiting):
            t = req.sampling.timeout_s
            if t is not None and now - req.arrival_time >= t:
                self._finish_abnormal(req, "timeout")

    def _resolve_token(self, req: Request, greedy_tok, finite,
                       row_fn: Callable[[], np.ndarray],
                       sampled_tok=None) -> Optional[int]:
        """NaN/Inf-guarded token for ONE logits row, fed from a drained
        `token_grid`: the argmax, or for temperature > 0 the row's seeded
        sample (``sampled_tok``); `row_fn` fetches the [V] row only for a
        NaN rescue. Returns None when the request must be aborted
        (nan_policy="abort", or no finite logit exists)."""
        if not finite:
            self.metrics.nan_logit_events.inc()
            if self.nan_policy == "greedy":
                row = np.asarray(row_fn())
                ok = np.isfinite(row)
                if ok.any():
                    return int(np.argmax(np.where(ok, row, -np.inf)))
            return None
        if req.sampling.temperature == 0.0:
            return int(greedy_tok)
        return int(sampled_tok)

    def _sample_groups(self, batch_slots, B: int) -> List[SampleGroup]:
        """The sampled rows of a batch, one group per (top_k, top_p): each
        row's seed (sp.seed, else its arrival index), step (its generated
        tokens so far) and temperature, over all B slots."""
        groups: Dict[tuple, SampleGroup] = {}
        for req, sl in batch_slots:
            sp = req.sampling
            if sp.temperature == 0.0:
                continue
            g = groups.get((sp.top_k, sp.top_p))
            if g is None:
                g = groups[(sp.top_k, sp.top_p)] = (
                    sp.top_k, sp.top_p, np.zeros((B,), np.int64),
                    np.zeros((B,), np.int64), np.zeros((B,), np.float32), [])
            g[2][sl] = sp.seed if sp.seed is not None else req.arrival_index
            g[3][sl] = len(req.output_tokens)
            g[4][sl] = sp.temperature
            g[5].append(sl)
        return list(groups.values())

    def _drain_grid(self, grid, groups):
        """One blocking drain of a `token_grid`: (argmax, finite flags,
        {slot: sampled token})."""
        host = self._timed_drain(lambda: _to_host(grid))
        self.metrics.host_syncs.inc()
        return self._split_grid(host, groups)

    @staticmethod
    def _split_grid(host, groups):
        sampled = {sl: host[2 + g][sl]
                   for g, group in enumerate(groups) for sl in group[5]}
        return host[0], host[1].astype(bool), sampled

    def _guarded_sample(self, logits_row, req: Request) -> Optional[int]:
        """The completing prefill chunk's token: the single-row grid (its
        argmax, finite flag and, for temperature > 0, its seeded sample),
        one drain."""
        slots = [(req, 0)]
        groups = self._sample_groups(slots, 1)
        am, fin, sampled = self._drain_grid(
            token_grid(logits_row[None], groups), groups)
        return self._resolve_token(req, am[0], fin[0],
                                   lambda: _to_host(logits_row),
                                   sampled.get(0))

    # ------------------------------------------------- host-tier page-in

    def _stage_slots(self, tier, slots) -> Dict[int, tuple]:
        """Issue the host-to-device copies of host-tier slots (the JAX
        engine's `_stage_slot`, by runs): through the runner's
        `stage_host_pages`, one copy a pool array for each run of
        consecutive slots, on the tier's side stream on the card
        (non-blocking, from the pinned slots). Returns {slot: (its staged
        per-layer page tensors, the event after its run's copies, None on
        the CPU)}; nothing waits here."""
        stage = getattr(self.runner, "stage_host_pages", None)
        out: Dict[int, tuple] = {}
        for _, first, n in consecutive_runs(slots):
            data = tier.read_slots(first, n)
            with tier.stream():
                staged = stage(data) if stage is not None else data
            ev = tier.note_read(*range(first, first + n))
            for k in range(n):
                out[first + k] = ([tuple(a[k] for a in layer)
                                   for layer in staged], ev)
        return out

    def _fence_pagein(self, admitted: Sequence[Request]) -> None:
        """Apply every pending page-in of this step's admissions to the
        pools: THE fence, after which the restored pages are ordinary pool
        state for this step's launches. Transfers staged in an earlier
        step (keyed by (slot, generation)) resolve here and count as
        hidden; the rest stage now. On the card the compute stream waits
        for the copies' events, then the pages are scattered in place on
        it. Consumed slots return to the tier."""
        tier = self.pool.host_tier
        pending = [r for r in admitted if r.pending_pagein]
        if tier is None or not pending:
            return
        pages: List[int] = []
        slots: List[int] = []
        staged_list = []
        hidden = 0
        for req in pending:
            for page, slot in req.pending_pagein:
                entry = self._pagein_staged.pop(
                    (slot, tier.generation(slot)), None)
                if entry is not None:
                    issued_step, staged = entry
                    if issued_step < self._step_count:
                        hidden += 1
                else:
                    staged = None            # staged below, with the rest
                pages.append(page)
                slots.append(slot)
                staged_list.append(staged)
            req.pending_pagein = []
        now = self._stage_slots(tier, [s for s, st in zip(slots, staged_list)
                                       if st is None])
        staged_list = [st if st is not None else now[s]
                       for s, st in zip(slots, staged_list)]
        if tier.cuda:
            compute = torch.cuda.current_stream(self.pool.device)
            for data, ev in staged_list:
                compute.wait_event(ev)
                for layer in data:
                    for t in layer:
                        t.record_stream(compute)
        first = staged_list[0][0]
        layer_data = [tuple(torch.stack([d[li][j] for d, _ in staged_list])
                            for j in range(len(first[li])))
                      for li in range(len(first))]
        self.pool.write_pages(pages, layer_data)
        tier.free_slots(slots)
        tier.paged_in_pages += len(pages)
        self.metrics.pagein_pages.inc(len(pages))
        if hidden:
            self.metrics.pagein_hidden_pages.inc(hidden)

    def _prefetch_pagein(self) -> None:
        """Stage the host pages of the next `pagein_prefetch` offloaded
        waiters at the END of a step, ahead of the admission that maps
        them, so their copies run under this step's launches. An entry
        whose slot generation moved on (the waiter was dropped, the slot
        reused) never resolves and is pruned here."""
        tier = self.pool.host_tier
        if tier is None or self.pagein_prefetch <= 0:
            return
        for key in list(self._pagein_staged):
            slot, gen = key
            if tier.generation(slot) != gen:
                del self._pagein_staged[key]
        seen = 0
        for req in self.scheduler.waiting:
            if seen >= self.pagein_prefetch:
                break
            if req.offload is None:
                continue
            seen += 1
            todo = [s for s in req.offload.slots
                    if (s, tier.generation(s)) not in self._pagein_staged]
            for slot, staged in self._stage_slots(tier, todo).items():
                self._pagein_staged[(slot, tier.generation(slot))] = (
                    self._step_count, staged)

    # ------------------------------------------------------------- step

    def step(self) -> List[TokenEvent]:
        """One engine iteration: expire deadlines, admit new requests
        (mapping cached prefixes), (pipelined: commit the previous step's
        launch,) run this step's prefill chunks under the token budget,
        reserve decode pages (preempting if needed), then one batched
        decode step, one device-resident horizon, one fused ragged step
        or one speculative launch over the decode-phase requests. Returns
        the tokens produced this step (pipelined: the previous launch's).
        Load- and fault-induced failures never escape: they end requests
        with an explicit finish_reason."""
        if not self.has_work():
            return []
        self.metrics.mark_active()
        self._step_count += 1
        t0 = self.metrics.clock()
        events: List[TokenEvent] = []
        # ---- PLAN (host work; pipelined, the previous launch still runs)
        # deadlines first: an expired request must not win admission
        self._expire_deadlines()
        # admitting against a state that predates the in-flight launch's
        # tokens is safe: its commit only frees pages and slots
        admitted = self.scheduler.admit()
        for req in admitted:
            if req.admit_prefix_tokens:
                self.metrics.prefix_hit_tokens.inc(req.admit_prefix_tokens)
        if not self.pipelined:
            # the page-in fence: every host page an admission mapped is in
            # the pools before anything this step computes reads it
            self._fence_pagein(admitted)
        plan = self.scheduler.prefill_plan()
        t_plan = self.metrics.clock() - t0
        self.metrics.host_plan_seconds.inc(t_plan)
        if self._inflight is not None:
            # planning ran under an in-flight launch: host time the device
            # did not wait for
            self.metrics.planned_ahead_steps.inc()
            self.metrics.overlapped_plan_seconds.inc(t_plan)
        if self.pipelined:
            # ---- COMMIT: drain and replay the previous step's launch, then
            # the page-in fence; re-slice the plan after it (a committed
            # fused launch advanced chunk coverage, and a commit can end a
            # request)
            events.extend(self._commit_inflight())
            self._fence_pagein(admitted)
            plan = self.scheduler.prefill_plan()
        if self.role == "prefill":
            # every request that finished its prefill (decode phase, first
            # token sampled) leaves the running set here, its pages
            # spilled to the host tier, parked for the router to ship to a
            # decode replica; after the commit (nothing in flight) and
            # before this step's launches, so a staged request joins none
            self._stage_handoffs()
        # ---- EXECUTE
        fused = bool(self.ragged_batch and plan
                     and self.scheduler.decode_ready())
        if self.num_speculative_tokens > 0 and self.scheduler.decode_ready():
            chunk_tokens = sum(end - start for _, start, end in plan)
            if not plan and self._spec_horizon_ready():
                # drafts ride the device-resident horizon: accept on the
                # device, one drain per horizon, deferred like any horizon
                self._reserve_decode()
                events.extend(self._decode_spec_with_recovery(
                    defer=self.pipelined))
            else:
                # the per-step verify path: prefill chunks this step (fused
                # into the launch under ragged_batch) or a batch outside
                # the horizon sampler's envelope
                if not fused:
                    events.extend(self._run_chunks(plan))
                self._reserve_decode()
                proposals = self._plan_speculation(chunk_tokens)
                events.extend(self._ragged_step_with_recovery(
                    proposals, include_chunks=fused))
        elif fused:
            self._reserve_decode()
            # the fused launch defers exactly like a decode launch
            events.extend(self._ragged_step_with_recovery(
                defer=self.pipelined))
        else:
            events.extend(self._run_chunks(plan))
            self._reserve_decode()
            if self.scheduler.running:
                s = self._plan_horizon(chunks_in_flight=bool(plan))
                if s > 1:
                    events.extend(self._decode_multi_with_recovery(
                        s, defer=self.pipelined))
                else:
                    events.extend(self._decode_with_recovery(
                        defer=self.pipelined))
        self.metrics.decode_steps.inc()

        self.metrics.attn_kv_bytes_read.set(self.runner.attn_kv_bytes_read)
        self.metrics.attn_kv_bytes_gather.set(
            self.runner.attn_kv_bytes_gather)
        # the tensor-parallel wire bytes a shard moved (row-parallel
        # allreduces, the logits gather) at the comm dtype vs fp32
        for name in ("tp_comm_bytes", "tp_gather_bytes"):
            wire = getattr(self.runner, name, None)
            if wire is not None:
                fp32 = getattr(self.runner, name + "_fp32")
                getattr(self.metrics, name).set(wire)
                getattr(self.metrics, name + "_fp32").set(fp32)
                getattr(self.metrics, name + "_reduction_x").set(
                    fp32 / wire if wire else 0.0)
        a = self.pool.allocator
        self.metrics.queue_depth.set(self.scheduler.queue_depth)
        self.metrics.running.set(len(self.scheduler.running))
        self.metrics.pool_used_pages.set(a.num_usable - a.num_free)
        self.metrics.pool_utilization.set(self.pool.utilization())
        if self.pool.prefix_cache is not None:
            self.metrics.prefix_cached_pages.set(len(self.pool.prefix_cache))
        tier = self.pool.host_tier
        if tier is not None:
            # stage the next resumable requests' pages while this step's
            # launches still run on the device
            self._prefetch_pagein()
            self.metrics.host_tier_bytes.set(tier.bytes_used)
            self.metrics.host_tier_pages_used.set(tier.used_count)
        self.metrics.step_seconds.inc(self.metrics.clock() - t0)
        tot = self.metrics.step_seconds.value
        blocked = (self.metrics.drain_wait_seconds.value
                   + self.metrics.overlapped_plan_seconds.value)
        self.metrics.device_idle_fraction.set(
            max(0.0, 1.0 - min(blocked / tot, 1.0)) if tot > 0 else 0.0)
        if self.audit:
            audit_engine(self)
        return events

    def _run_chunks(self, plan) -> List[TokenEvent]:
        """This step's prefill chunks, oldest first, each its own call."""
        events = []
        for req, start, end in plan:
            ev = self._prefill_chunk_with_recovery(req, start, end)
            if ev is not None:
                events.append(ev)
        return events

    def _reserve_decode(self) -> None:
        """Decode-page reservation; pool pressure preempts youngest-first."""
        for _ in self.scheduler.reserve_decode():
            self.metrics.preemptions.inc()

    def _cow(self, req: Request, start: int, end: int) -> None:
        """Fork every shared page a write over [start, end) would touch
        (idempotent: a forked page is private when a call retries)."""
        cow = req.kv.ensure_writable(start, end)
        if cow:
            self.metrics.cow_copies.inc(cow)

    def _register(self, req: Request, tokens=None) -> None:
        """Push the request's newly full pages into the prefix cache."""
        if self.pool.prefix_cache is not None:
            self.pool.prefix_cache.register_seq(
                req.kv, req.context_tokens if tokens is None else tokens)

    def _prefill_chunk_with_recovery(self, req: Request, start: int,
                                     end: int) -> Optional[TokenEvent]:
        """Compute context positions [start, end) of one request's
        (re-)prefill, retrying transient runner failures with bounded
        exponential backoff; a request whose chunk keeps failing is
        quarantined (finish_reason="error"). The chunk that completes the
        context samples the request's next token and flips it into the
        decode phase."""
        self._cow(req, start, end)
        table = self.pool.pad_table(req.kv.pages, self.max_pages_per_seq)
        chunk = req.context_tokens[start:end]
        delay = self.retry_backoff_s
        for attempt in range(self.max_step_retries + 1):
            try:
                logits, new_pools = self.runner.prefill_chunk(
                    chunk, start, table, self.pool.shards)
                break
            except Exception:
                if attempt >= self.max_step_retries:
                    logger.exception("prefill of %s failed; quarantined",
                                     req.request_id)
                    self._finish_abnormal(req, "error")
                    return None
                self.metrics.step_retries.inc()
                self._sleep(delay)
                delay *= 2
        self.pool.shards = new_pools
        req.kv.num_tokens = end
        self.metrics.prefill_tokens.inc(end - start)
        self.metrics.prefill_chunks.inc()
        self._register(req)
        if end < req.num_context:
            return None              # intermediate chunk: logits unread
        tok = self._guarded_sample(logits, req)
        if tok is None:
            self._finish_abnormal(req, "error")
            return None
        req.phase = "decode"
        return self._append_token(req, tok)

    def _decode_operands(self, batch):
        """The fed tokens, block tables and positions of a decode batch
        over all max_batch_size slots; the other slots carry all-scratch
        tables and self-neutralize."""
        B, P = self.max_batch_size, self.max_pages_per_seq
        tokens = np.zeros((B,), np.int32)
        tables = np.full((B, P), SCRATCH_PAGE, np.int32)
        pos = np.zeros((B,), np.int32)
        for req in batch:
            s = req.slot
            tokens[s] = req.output_tokens[-1]
            tables[s, :len(req.kv.pages)] = req.kv.pages
            pos[s] = req.num_context - 1   # position of the fed token
        return tokens, tables, pos

    def _decode_with_recovery(self, defer: bool = False
                              ) -> List[TokenEvent]:
        """One batched decode step with transient-failure recovery: retry
        with backoff; once retries are exhausted, quarantine the youngest
        decode request (the step is then rebuilt without it). Each
        quarantine shrinks the batch, so the loop ends.

        A retried decode is exact: a failed attempt either never reached
        the device or re-writes the same K/V values through the same
        block tables. Only decode-phase requests join the batch. The
        launch includes the step's `token_grid` (argmax, finite flags,
        seeded samples); with ``defer`` (the pipelined loop) it is left in
        flight for the next step's commit."""
        attempts = 0
        delay = self.retry_backoff_s
        while True:
            batch = self.scheduler.decode_ready()
            if not batch:
                return []
            for req in batch:    # the fed token's write: never on a shared
                self._cow(req, req.num_context - 1, req.num_context)
            slots = [(r, r.slot) for r in batch]
            groups = self._sample_groups(slots, self.max_batch_size)
            try:
                logits, new_pools = self.runner.decode(
                    *self._decode_operands(batch), self.pool.shards)
                grid = token_grid(logits, groups)
                break
            except Exception:
                if attempts < self.max_step_retries:
                    attempts += 1
                    self.metrics.step_retries.inc()
                    self._sleep(delay)
                    delay *= 2
                    continue
                logger.exception("decode failed; quarantining %s",
                                 batch[-1].request_id)
                self._finish_abnormal(batch[-1], "error")
                attempts = 0
                delay = self.retry_backoff_s
        self.pool.shards = new_pools
        self.metrics.batch_occupancy.observe(len(batch))
        if defer:
            self._inflight = _InflightLaunch("decode", slots, grid, 1,
                                             logits, tuple(groups))
            return []
        return self._finish_decode(slots, logits,
                                   self._drain_grid(grid, groups))

    def _finish_decode(self, batch_slots, logits, drained
                       ) -> List[TokenEvent]:
        """Resolve one drained decode launch: the per-request append /
        stop / NaN bookkeeping (the [B, V] rows reach the host only for a
        NaN rescue). Shared by the synchronous loop and the pipelined
        commit. A batch member that finished while the launch was in
        flight is skipped."""
        am, fin, sampled = drained
        host: Dict[str, np.ndarray] = {}

        def _rows() -> np.ndarray:
            if "l" not in host:
                host["l"] = self._timed_drain(lambda: _to_host(logits))
                self.metrics.host_syncs.inc()
            return host["l"]

        events = []
        for req, sl in batch_slots:
            if req.done:
                continue
            req.kv.num_tokens = req.num_context
            self._register(req)
            tok = self._resolve_token(req, am[sl], fin[sl],
                                      lambda s=sl: _rows()[s],
                                      sampled.get(sl))
            if tok is None:
                self._finish_abnormal(req, "error")
                continue
            events.append(self._append_token(req, tok))
        return events

    # ----------------------------------------- fused ragged / speculation

    def _release_spec_state(self, req: Request) -> None:
        """Drop per-request proposer and adaptive-k state on every terminal
        path: the n-gram suffix index, a draft model's KV pages and the
        acceptance EWMA key on request_id and would leak otherwise."""
        if self.num_speculative_tokens <= 0:
            return
        release = getattr(self.proposer, "release", None)
        if release is not None:
            release(req.request_id)
        if self.adaptive_k is not None:
            self.adaptive_k.release(req.request_id)

    def _draft_len(self, req: Request) -> int:
        """The request's draft length before its own caps."""
        k = self.num_speculative_tokens
        if self.adaptive_k is not None:
            k = min(k, self.adaptive_k.k_for(req.request_id))
        return k

    def _plan_speculation(self, chunk_tokens: int
                          ) -> Dict[Request, List[int]]:
        """Draft proposals for this step's decode batch, capped in
        admission order by the request's remaining tokens (the corrected
        or bonus token always fits), the model-length headroom, the
        step's leftover token budget (verify spans count against
        max_prefill_tokens_per_step as chunks do) and best-effort page
        reservation (a proposal shrinks instead of preempting)."""
        budget = self.scheduler.speculation_budget(chunk_tokens)
        proposals: Dict[Request, List[int]] = {}
        for req in self.scheduler.decode_ready():      # admission order
            k = self._draft_len(req)
            k = min(k, req.sampling.max_tokens - len(req.output_tokens) - 1)
            k = min(k, self.max_model_len - req.num_context)
            if budget is not None:
                k = min(k, budget)
            if k <= 0:
                continue
            prop = self.proposer.propose(req.context_tokens, k,
                                         request_id=req.request_id)
            if not prop:
                continue
            if budget is not None:
                budget -= len(prop)
            proposals[req] = prop
        self.scheduler.reserve_speculation(proposals)
        return proposals

    def _span_groups(self, spans, B: int, T: Optional[int] = None
                     ) -> List[SampleGroup]:
        """The sampled rows of a ragged launch. With full logits (``T``)
        each group's steps become a [B, T] grid: a verify span's position
        i draws at generated-token index o + i, a chunk's rows all at o
        (only its last live row is read)."""
        groups = self._sample_groups([(r, sl) for r, _, _, _, sl in spans],
                                     B)
        if T is None:
            return groups
        chunk_slots = [sl for _, _, _, prop, sl in spans if prop is None]
        out = []
        for top_k, top_p, seeds, steps, temps, slots in groups:
            grid = steps[:, None] + np.arange(T)
            grid[chunk_slots] = steps[chunk_slots, None]
            out.append((top_k, top_p, seeds, grid, temps, slots))
        return out

    def _ragged_step_with_recovery(
            self, proposals: Optional[Dict[Request, List[int]]] = None,
            include_chunks: bool = True,
            defer: bool = False) -> List[TokenEvent]:
        """ONE mixed ragged runner call for this step: every planned
        prefill chunk and every decode-phase request rides its slot as a
        (start, q_len) span into runner.ragged_step, one ragged-kernel
        launch a layer. With ``proposals`` each decode span stretches to
        1 + k rows (the fed token plus its draft) and the call returns
        full per-position logits for `_accept_verify`. The launch carries
        its `token_grid` (argmax, finite flags, seeded samples at each
        position's step index). Transient failures retry the whole call
        (exact: forks happen before it, and a retry rewrites the same
        K/V); exhausted retries quarantine the youngest spanning request
        and rebuild. With ``defer`` (pipelined, no proposals) the launch
        is left in flight; the commit replays the span bookkeeping and
        the next plan is re-sliced after it, so no chunk runs twice."""
        full = proposals is not None
        attempts = 0
        delay = self.retry_backoff_s
        while True:
            # rebuild from live scheduler state each attempt: reservation
            # may have preempted, quarantine may have removed
            spans = []
            if include_chunks:
                spans += [(req, start, end, None, req.slot)
                          for req, start, end
                          in self.scheduler.prefill_plan()]
            for req in self.scheduler.decode_ready():
                prop = proposals.get(req, []) if full else []
                spans.append((req, req.num_context - 1,
                              req.num_context + len(prop), prop, req.slot))
            if not spans:
                return []
            B, P = self.max_batch_size, self.max_pages_per_seq
            T = bucket_len(max(end - start for _, start, end, _, _ in spans))
            tokens = np.zeros((B, T), np.int32)
            starts = np.zeros((B,), np.int32)
            qlens = np.zeros((B,), np.int32)
            tables = np.full((B, P), SCRATCH_PAGE, np.int32)
            for req, start, end, prop, sl in spans:
                self._cow(req, start, end)
                span_toks = (req.context_tokens[start:end] if prop is None
                             else req.output_tokens[-1:] + list(prop))
                tokens[sl, :end - start] = span_toks
                starts[sl] = start
                qlens[sl] = end - start
                tables[sl, :len(req.kv.pages)] = req.kv.pages
            groups = self._span_groups(spans, B, T if full else None)
            try:
                logits, new_pools = self.runner.ragged_step(
                    tokens, tables, starts, qlens, self.pool.shards,
                    full_logits=full)
                grid = token_grid(logits, groups)
                break
            except Exception:
                if attempts < self.max_step_retries:
                    attempts += 1
                    self.metrics.step_retries.inc()
                    self._sleep(delay)
                    delay *= 2
                    continue
                victim = max((r for r, *_ in spans),
                             key=lambda r: r.admission_index)
                logger.exception("ragged step failed; quarantining %s",
                                 victim.request_id)
                self._finish_abnormal(victim, "error")
                attempts = 0
                delay = self.retry_backoff_s
        self.pool.shards = new_pools
        self.metrics.batch_occupancy.observe(len(spans))
        if defer and not full:
            self._inflight = _InflightLaunch(
                "ragged", [(r, sl) for r, _, _, _, sl in spans], grid, 1,
                logits, tuple(groups), spans=spans)
            return []
        return self._finish_ragged(spans, logits, full,
                                   self._drain_grid(grid, groups))

    def _finish_ragged(self, spans, logits, full: bool, drained
                       ) -> List[TokenEvent]:
        """Resolve one drained fused ragged launch: chunk coverage
        advances and prefix registration, completing-chunk and fused
        decode tokens, verify-span acceptance. Shared by the synchronous
        path and the pipelined commit; a span member that finished while
        the launch was in flight is skipped."""
        am, fin, sampled = drained
        host: Dict[str, np.ndarray] = {}

        def _rows() -> np.ndarray:
            if "l" not in host:
                host["l"] = self._timed_drain(lambda: _to_host(logits))
                self.metrics.host_syncs.inc()
            return host["l"]

        events: List[TokenEvent] = []
        for req, start, end, prop, sl in spans:
            if req.done:
                continue
            if prop is None:                    # prefill chunk span
                req.kv.num_tokens = end
                self.metrics.prefill_tokens.inc(end - start)
                self.metrics.prefill_chunks.inc()
                self._register(req)
                if end < req.num_context:
                    continue
                if full:                        # its last live row
                    r = end - start - 1
                    tok = self._resolve_token(
                        req, am[sl, r], fin[sl, r],
                        lambda sl=sl, r=r: _rows()[sl, r],
                        sampled[sl][r] if sl in sampled else None)
                else:
                    tok = self._resolve_token(
                        req, am[sl], fin[sl], lambda sl=sl: _rows()[sl],
                        sampled.get(sl))
                if tok is None:
                    self._finish_abnormal(req, "error")
                    continue
                req.phase = "decode"
                events.append(self._append_token(req, tok))
            elif not full:                      # plain fused decode
                req.kv.num_tokens = req.num_context
                self._register(req)
                tok = self._resolve_token(req, am[sl], fin[sl],
                                          lambda sl=sl: _rows()[sl],
                                          sampled.get(sl))
                if tok is None:
                    self._finish_abnormal(req, "error")
                    continue
                events.append(self._append_token(req, tok))
            else:                               # verify span
                self._accept_verify(
                    req, prop, am[sl], fin[sl],
                    lambda i, sl=sl: _rows()[sl, i], sampled.get(sl),
                    events)
        return events

    def _accept_verify(self, req: Request, prop: List[int], row_am, row_fin,
                       row_fn, row_sampled, events: List[TokenEvent]) -> None:
        """Token-exact acceptance of one verify span. Position i scored
        the token after context + prop[:i]; its target token is the
        request's own (the argmax, or the seeded sample at generated-token
        index o + i, ``row_sampled[i]``), so accepting means "the draft IS
        the token the model would have emitted". The longest matching
        draft prefix is accepted, then the first divergent position adds
        its corrected token (or the bonus token after a full accept). The
        rejected tail rolls back before any append can finish the
        request: coverage truncates to the accepted prefix and the pages
        grown only for the span are decref'd."""
        k = len(prop)
        o = len(req.output_tokens)
        C = req.num_context
        toks: List[int] = []
        accepted = 0
        aborted = False
        for i in range(k + 1):
            tok = self._resolve_token(
                req, row_am[i], row_fin[i], lambda i=i: row_fn(i),
                None if row_sampled is None else row_sampled[i])
            if tok is None:
                aborted = True
                break
            toks.append(tok)
            matched = i < k and int(prop[i]) == tok
            if matched:
                accepted += 1
            done = (tok in req.sampling.stop_token_ids
                    or o + len(toks) >= req.sampling.max_tokens)
            if done or not matched:
                break
        self.metrics.spec_proposed_tokens.inc(k)
        self.metrics.spec_accepted_tokens.inc(accepted)
        self.metrics.spec_dead_positions.inc(max(k - accepted, 0))
        if self.adaptive_k is not None:
            self.adaptive_k.update(req.request_id, k, accepted)
        # positions C..C+accepted-1 hold accepted-draft KV; the rejected
        # tail [C+accepted, C+k) rolls back, then register / append
        dropped = req.kv.truncate(C + accepted)
        if dropped:
            self.metrics.spec_rollback_pages.inc(dropped)
        self._register(req, req.context_tokens + toks[:accepted])
        for t in toks:
            events.append(self._append_token(req, t))
            if req.done:
                break
        if aborted and not req.done:
            self._finish_abnormal(req, "error")

    def _spec_horizon_ready(self) -> bool:
        """Whether this step's decode batch can ride drafts inside the
        device-resident horizon: the horizon sampler's envelope (one
        (top_k, top_p) per batch, seeds below 2**31 as in the JAX
        package) and no request deferred by a mid-horizon NaN (the
        per-step path fetches real logits to rescue from). No
        decode_horizon >= 2 requirement: a fused span wins at s == 1
        too (one drain resolves k + 1 tokens)."""
        batch = self.scheduler.decode_ready()
        if not batch:
            return False
        deferred = False
        for r in batch:
            if r.defer_horizon:
                r.defer_horizon = False
                deferred = True
        if deferred:
            return False
        sampled = [r for r in batch if r.sampling.temperature != 0.0]
        if sampled:
            if not self.horizon_sampling:
                return False
            if len({(r.sampling.top_k, r.sampling.top_p)
                    for r in sampled}) > 1:
                return False
            if any((r.sampling.seed if r.sampling.seed is not None
                    else r.arrival_index) >= 2 ** 31 for r in sampled):
                return False
        return True

    def _decode_spec_with_recovery(self, defer: bool = False
                                   ) -> List[TokenEvent]:
        """One fused speculative horizon: the batch's next ``s`` inner
        steps each carry a per-row draft span (k drafts, -1-padded to the
        batch's bucketed K) through runner.decode_multi_spec, which
        accepts on the device and feeds the corrected or bonus token
        back; the host drains ONE packed [3, B, s, K+1] buffer and
        replays it through `_replay_spec_horizon`.

        Drafts come from one proposer chain per row (s * (k+1) - 1
        tokens, the continuation under full acceptance) sliced at (k+1)
        strides. Pages are funded by scheduler.plan_spec_horizon (s
        trimmed first, then per-row k, never preempting); the stop plane
        is always on, which bounds kept tokens by `remaining` and makes
        that funding a true worst case. Retries are exact (proposals and
        acceptance are deterministic given the context); exhausted
        retries quarantine the youngest request and rebuild. With
        ``defer`` the launch stays in flight with its draft grid and the
        per-row funded token counts (the auditor's credit)."""
        batch = self.scheduler.decode_ready()
        if not batch:
            return []
        # plan once: deterministic given request state, so a retry rebuilds
        # the identical launch
        rem = {r: self._row_remaining(r) for r in batch}
        s = max(1, min(self.decode_horizon, max(rem.values())))
        budget = self.scheduler.speculation_budget(0)
        row_k: Dict[Request, int] = {}
        chains: Dict[Request, List[int]] = {}
        for req in batch:
            k = min(self._draft_len(req), max(rem[req] - 1, 0))
            if budget is not None:
                k = min(k, budget)
            chain: List[int] = []
            if k > 0:
                chain = list(self.proposer.propose_chain(
                    req.context_tokens, s * (k + 1) - 1,
                    request_id=req.request_id))
                if not chain:
                    k = 0
            if k > 0 and budget is not None:
                budget -= k
            row_k[req] = k
            chains[req] = chain
        s = self.scheduler.plan_spec_horizon(s, row_k, rem)
        kmax = max(row_k.values())
        if kmax <= 0:
            # every draft shrank away: ride the plain horizon machinery,
            # re-planned (grow is incremental) for its overshoot rules
            s = self._plan_horizon(False)
            if s > 1:
                return self._decode_multi_with_recovery(s, defer=defer)
            return self._decode_with_recovery(defer=defer)
        K = bucket_len(1 + kmax) - 1
        wall = self.max_pages_per_seq * self.pool.block_size
        upc = {r: max(1, min(s * (row_k[r] + 1), rem[r] + row_k[r],
                             wall - r.kv.num_tokens))
               for r in batch}
        attempts = 0
        delay = self.retry_backoff_s
        while True:
            batch = [r for r in self.scheduler.decode_ready() if r in row_k]
            if not batch:
                return []
            B, P = self.max_batch_size, self.max_pages_per_seq
            tokens = np.zeros((B,), np.int32)
            tables = np.full((B, P), SCRATCH_PAGE, np.int32)
            pos = np.zeros((B,), np.int32)
            drafts = np.full((B, s, K), -1, np.int32)
            sampling = any(r.sampling.temperature != 0.0 for r in batch)
            seeds = np.zeros((B,), np.int64)
            base = np.zeros((B,), np.int32)
            temps = np.zeros((B,), np.float32)
            top_k = top_p = None
            S = max([1] + [len(r.sampling.stop_token_ids) for r in batch])
            stop_ids = np.full((B, S), -1, np.int32)
            remaining = np.ones((B,), np.int32)
            for req in batch:
                # every page the horizon may write is private before the
                # launch (idempotent: forks survive a retry)
                self._cow(req, req.num_context - 1,
                          req.num_context - 1 + upc[req])
                sl, sp = req.slot, req.sampling
                tokens[sl] = req.output_tokens[-1]
                tables[sl, :len(req.kv.pages)] = req.kv.pages
                pos[sl] = req.num_context - 1
                k, chain = row_k[req], chains[req]
                for t in range(s):
                    piece = chain[t * (k + 1):t * (k + 1) + k]
                    if piece:
                        drafts[sl, t, :len(piece)] = piece
                seeds[sl] = (sp.seed if sp.seed is not None
                             else req.arrival_index)
                base[sl] = len(req.output_tokens)
                temps[sl] = sp.temperature
                if sp.temperature != 0.0:
                    top_k, top_p = sp.top_k, sp.top_p
                ids = tuple(sp.stop_token_ids)
                stop_ids[sl, :len(ids)] = ids
                remaining[sl] = rem[req]
            kw: dict = dict(stop_ids=stop_ids, remaining=remaining)
            if sampling:
                kw.update(seeds=seeds, base_steps=base, temps=temps,
                          top_k=top_k, top_p=top_p)
            try:
                packed, new_pools = self.runner.decode_multi_spec(
                    tokens, tables, pos, self.pool.shards, drafts, **kw)
                break
            except Exception:
                if attempts < self.max_step_retries:
                    attempts += 1
                    self.metrics.step_retries.inc()
                    self._sleep(delay)
                    delay *= 2
                    continue
                logger.exception("speculative horizon failed; quarantining "
                                 "%s", batch[-1].request_id)
                self._finish_abnormal(batch[-1], "error")
                attempts = 0
                delay = self.retry_backoff_s
        self.pool.shards = new_pools
        self.metrics.batch_occupancy.observe(len(batch))
        self.metrics.decode_horizon_steps.inc(s)
        self.metrics.spec_fused_horizons.inc()
        slots = [(r, r.slot) for r in batch]
        if defer:
            self._inflight = _InflightLaunch(
                "decode_spec", slots, packed, s, spec={"drafts": drafts},
                upcoming={id(r): upc[r] for r in batch})
            return []
        drained = self._timed_drain(lambda: _to_host(packed))
        self.metrics.host_syncs.inc()       # the horizon's ONE host sync
        return self._replay_spec_horizon(slots, drained, drafts)

    def _replay_spec_horizon(self, batch_slots, drained, drafts
                             ) -> List[TokenEvent]:
        """Replay one drained speculative horizon, [3, B, s, K+1]: per
        inner step the span's emitted tokens, finite flags and the KEEP
        plane (position 0 the fed token's emission, then the accepted
        drafts' continuations, all gated by the row's live bit). Each
        kept position gets `_accept_verify`'s bookkeeping (acceptance
        counts, coverage and registration before the append, the stop and
        length handling, the NaN policy through `_horizon_nan`), so
        streams, finish reasons and spec_* metrics match the per-step
        verify path. An unfinished row then truncates back to the
        per-step invariant (num_tokens = num_context - 1), dropping the
        pages grown for rejected or unreached positions. A member that
        finished while the launch was in flight is skipped."""
        toks, fins, keeps = drained[0], drained[1], drained[2]
        s = toks.shape[1]
        events: List[TokenEvent] = []
        for req, sl in batch_slots:
            if req.done:
                continue
            C = req.num_context
            emitted = proposed = accepted = 0
            halted = False
            for t in range(s):
                krow = keeps[sl, t]
                if not krow[0]:
                    break          # row froze on the device: tail is dead
                row_draft = drafts[sl, t]
                ndraft = int(np.sum(row_draft >= 0))
                proposed += ndraft
                m = int(np.sum(krow != 0))
                for i in range(m):
                    if not fins[sl, t, i]:
                        self._horizon_nan(req, C, emitted)
                        halted = True
                        break
                    tok = int(toks[sl, t, i])
                    if i < ndraft and int(row_draft[i]) == tok:
                        accepted += 1
                    req.kv.num_tokens = C + emitted
                    self._register(req)
                    events.append(self._append_token(req, tok))
                    emitted += 1
                    if req.done:
                        halted = True
                        break
                if halted:
                    break
            self.metrics.spec_proposed_tokens.inc(proposed)
            self.metrics.spec_accepted_tokens.inc(accepted)
            self.metrics.spec_dead_positions.inc(max(proposed - accepted, 0))
            if self.adaptive_k is not None:
                self.adaptive_k.update(req.request_id, proposed, accepted)
            if not req.done and emitted > 0:
                dropped = req.kv.truncate(C + emitted - 1)
                if dropped:
                    self.metrics.spec_rollback_pages.inc(dropped)
        return events

    # ------------------------------------------- multi-step decode (s>1)

    def _plan_horizon(self, chunks_in_flight: bool) -> int:
        """Effective horizon for THIS step's decode batch; 1 (the per-step
        path) when the batch cannot ride one: decode_horizon 1, prefill
        chunks this step, a request deferred by a mid-horizon NaN, sampled
        rows without horizon_sampling or with several (top_k, top_p).
        Otherwise s is capped at the batch's token headroom (with early
        stop: the longest row's, each row funding min(s, its remaining)
        pages) and the scheduler pre-commits the pages, trimming s under
        pool pressure."""
        s = self.decode_horizon
        batch = self.scheduler.decode_ready()
        if s <= 1 or not batch or chunks_in_flight:
            return 1
        deferred = False
        for r in batch:
            if r.defer_horizon:
                r.defer_horizon = False
                deferred = True
        if deferred:
            return 1
        sampled = [r for r in batch if r.sampling.temperature != 0.0]
        if sampled and (not self.horizon_sampling or len(
                {(r.sampling.top_k, r.sampling.top_p) for r in sampled}) > 1):
            return 1
        if self.horizon_early_stop:
            rem = {r: self._row_remaining(r) for r in batch}
            s = min(s, max(rem.values()))
            if s <= 1:
                return 1
            return self.scheduler.plan_decode_horizon(s, row_caps=rem)
        s = min(s, max(r.sampling.max_tokens - len(r.output_tokens)
                       for r in batch))
        s = min(s, min(self.max_model_len - r.num_context + 1
                       for r in batch))
        if s <= 1:
            return 1
        return self.scheduler.plan_decode_horizon(s)

    def _row_remaining(self, req: Request) -> int:
        """Tokens this request may still emit before a length finish or
        the model-length wall: the on-device early-stop budget and the
        per-row page-funding cap."""
        return min(req.sampling.max_tokens - len(req.output_tokens),
                   self.max_model_len - req.num_context + 1)

    def _horizon_ctx(self, batch: List[Request], s: int) -> dict:
        """Extension operands of one decode_multi launch: the seeded key
        schedule (seeds, generated-token base indices, temperatures and
        the batch's one (top_k, top_p)) and the early-stop state
        (-1-padded stop sets, remaining budgets). Empty = the greedy
        [2, B, s] loop."""
        sampling = any(r.sampling.temperature != 0.0 for r in batch)
        if not (sampling or self.horizon_early_stop):
            return {}
        B = self.max_batch_size
        ctx: dict = {}
        if sampling:
            seeds = np.zeros((B,), np.int64)
            base = np.zeros((B,), np.int32)
            temps = np.zeros((B,), np.float32)
            top_k = top_p = None
            for r in batch:
                sp = r.sampling
                seeds[r.slot] = (sp.seed if sp.seed is not None
                                 else r.arrival_index)
                base[r.slot] = len(r.output_tokens)
                temps[r.slot] = sp.temperature
                if sp.temperature != 0.0:
                    top_k, top_p = sp.top_k, sp.top_p
            ctx.update(seeds=seeds, base_steps=base, temps=temps,
                       top_k=top_k, top_p=top_p)
        if self.horizon_early_stop:
            S = max([1] + [len(r.sampling.stop_token_ids) for r in batch])
            stop_ids = np.full((B, S), -1, np.int32)
            remaining = np.ones((B,), np.int32)
            for r in batch:
                ids = tuple(r.sampling.stop_token_ids)
                stop_ids[r.slot, :len(ids)] = ids
                remaining[r.slot] = self._row_remaining(r)
            ctx.update(stop_ids=stop_ids, remaining=remaining,
                       early_stop=True)
        return ctx

    def _decode_multi_with_recovery(self, s: int, defer: bool = False
                                    ) -> List[TokenEvent]:
        """One device-resident horizon with the per-step path's recovery:
        the batch's next ``s`` decode steps in ONE runner.decode_multi
        call and ONE drain of its packed buffer (host_syncs += 1), then
        `_replay_horizon` through the per-step bookkeeping. Retries are
        exact as decode retries are; exhausted retries quarantine the
        youngest request and rebuild. With ``defer`` the launch is left
        in flight for the next step's commit."""
        attempts = 0
        delay = self.retry_backoff_s
        while True:
            batch = self.scheduler.decode_ready()
            if not batch:
                return []
            for req in batch:
                # every page the horizon writes must be private before the
                # launch; early-stop rows freeze past their own budget
                w = s if not self.horizon_early_stop else \
                    min(s, self._row_remaining(req))
                self._cow(req, req.num_context - 1, req.num_context - 1 + w)
            ctx = self._horizon_ctx(batch, s)
            try:
                packed, new_pools = self.runner.decode_multi(
                    *self._decode_operands(batch), self.pool.shards, s,
                    **ctx)
                break
            except Exception:
                if attempts < self.max_step_retries:
                    attempts += 1
                    self.metrics.step_retries.inc()
                    self._sleep(delay)
                    delay *= 2
                    continue
                logger.exception("decode horizon failed; quarantining %s",
                                 batch[-1].request_id)
                self._finish_abnormal(batch[-1], "error")
                attempts = 0
                delay = self.retry_backoff_s
        self.pool.shards = new_pools
        self.metrics.batch_occupancy.observe(len(batch))
        self.metrics.decode_horizon_steps.inc(s)
        slots = [(r, r.slot) for r in batch]
        if defer:
            self._inflight = _InflightLaunch("decode_multi", slots, packed, s)
            return []
        drained = self._timed_drain(lambda: _to_host(packed))
        self.metrics.host_syncs.inc()       # the horizon's ONE host sync
        return self._replay_horizon(slots, drained, s)

    def _replay_horizon(self, batch_slots, drained, s: int
                        ) -> List[TokenEvent]:
        """Replay one drained horizon through the per-step bookkeeping
        (_append_token's stop / length handling, the NaN policy), so
        streams, finish reasons and metrics match the s=1 loop. ``drained``
        is [2, B, s] (tokens, finite) or [3, B, s] with a LIVE plane:
        entries past a row's on-device done bit are never replayed. A
        member that finished while the launch was in flight is skipped."""
        toks, fins = drained[0], drained[1]
        live = drained[2] if drained.shape[0] > 2 else None
        events: List[TokenEvent] = []
        for req, sl in batch_slots:
            if req.done:
                continue
            C = req.num_context
            accepted = 0
            for j in range(s):
                if live is not None and not live[sl, j]:
                    break          # row froze on the device: tail is dead
                if not fins[sl, j]:
                    self._horizon_nan(req, C, accepted)
                    break
                req.kv.num_tokens = C + j
                self._register(req)
                events.append(self._append_token(req, int(toks[sl, j])))
                accepted += 1
                if req.done:
                    tail = (s - accepted if live is None
                            else int(np.sum(live[sl, accepted:] != 0)))
                    self.metrics.horizon_overshoot_tokens.inc(tail)
                    break
        return events

    def _horizon_nan(self, req: Request, C: int, accepted: int) -> None:
        """Non-finite logits mid-horizon: the device loop kept no [V] row
        to rescue from. nan_policy="abort" ends the request like an
        unrescuable per-step row; "greedy" rolls the horizon's tail back
        (coverage truncated, its pages freed) and defers the request to
        the per-step path, which fetches the real logits."""
        self.metrics.nan_logit_events.inc()
        if self.nan_policy == "abort":
            self._finish_abnormal(req, "error")
            return
        req.kv.truncate(max(C + accepted - 1, 1))
        req.defer_horizon = True

    # --------------------------------------------------- pipelined loop

    def _commit_inflight(self) -> List[TokenEvent]:
        """COMMIT: drain the in-flight launch and replay it through the
        per-step bookkeeping. A fault at the drain reruns the step from
        live state through the retry path (module docstring)."""
        inf = self._inflight
        if inf is None:
            return []
        self._inflight = None
        try:
            drained = self._timed_drain(lambda: _to_host(inf.result))
        except Exception:
            logger.exception("drain of an in-flight %s failed; rerunning",
                             inf.kind)
            self.metrics.step_retries.inc()
            self._sleep(self.retry_backoff_s)
            if inf.kind == "decode":
                return self._decode_with_recovery()
            if inf.kind == "ragged":
                # chunk coverage never advanced (that happens at commit),
                # so the rebuilt spans recompute the same chunks and feeds
                return self._ragged_step_with_recovery()
            if inf.kind == "decode_spec":
                return self._decode_spec_with_recovery()
            return self._decode_multi_with_recovery(inf.s)
        self.metrics.host_syncs.inc()
        if inf.kind == "decode":
            return self._finish_decode(inf.batch, inf.logits,
                                       self._split_grid(drained, inf.groups))
        if inf.kind == "ragged":
            return self._finish_ragged(inf.spans, inf.logits, False,
                                       self._split_grid(drained, inf.groups))
        if inf.kind == "decode_spec":
            return self._replay_spec_horizon(inf.batch, drained,
                                             inf.spec["drafts"])
        return self._replay_horizon(inf.batch, drained, inf.s)

    def flush(self) -> List[TokenEvent]:
        """Fence the pipeline: commit any in-flight launch and return its
        events (a no-op with nothing in flight)."""
        return self._commit_inflight()

    def _append_token(self, req: Request, tok: int) -> TokenEvent:
        now = self.metrics.clock()
        if req.first_token_time is None:
            req.first_token_time = now
            self.metrics.ttft_s.observe(now - req.arrival_time)
        req.output_tokens.append(tok)
        self.metrics.tokens_generated.inc()
        reason = None
        if tok in req.sampling.stop_token_ids:
            reason = "stop"
        elif len(req.output_tokens) >= req.sampling.max_tokens:
            reason = "length"
        if reason is not None:
            req.finish_time = now
            self.scheduler.finish(req, reason)
            self._release_spec_state(req)
            self.metrics.requests_finished.inc()
            self.metrics.e2e_latency_s.observe(now - req.arrival_time)
            self._outputs[req.request_id] = RequestOutput(
                request_id=req.request_id,
                prompt_tokens=list(req.prompt_tokens),
                output_tokens=list(req.output_tokens),
                finish_reason=reason,
                num_preemptions=req.num_preemptions,
                ttft_s=req.first_token_time - req.arrival_time,
                e2e_s=req.finish_time - req.arrival_time)
        return TokenEvent(req.request_id, tok,
                          len(req.output_tokens) - 1,
                          finished=reason is not None, finish_reason=reason)

    # -------------------------------------------------------- streaming

    def stream_text(self, request_id: str) -> str:
        """The detokenized text of a request's generation so far: every
        output token up to the last byte-complete UTF-8 boundary (a
        character split across tokens waits for its last byte), and the
        whole text, dangling bytes replaced, once the request finished.
        Needs the engine's ``tokenizer``. Safe at any time, after a
        restore too: the request's detokenizer replays its token history
        from where it stopped."""
        if self.tokenizer is None:
            raise ValueError("stream_text() needs ServingEngine("
                             "tokenizer=...): an object exposing "
                             "id_to_bytes(tok) or decode([tok])")
        req = self._requests.get(request_id)
        if req is None:
            raise KeyError(f"unknown request {request_id!r}")
        d = self._detoks.get(request_id)
        if d is None:
            d = self._detoks[request_id] = StreamDetokenizer(self.tokenizer)
        while not d.finished and d.consumed < len(req.output_tokens):
            d.push(req.output_tokens[d.consumed])
        if req.done and not d.finished:
            d.finish()
        return d.text

    # -------------------------------------------------------------- run

    def run(self) -> Dict[str, RequestOutput]:
        """Drain the engine; returns every finished RequestOutput.
        has_work() counts an in-flight launch, so the last iteration
        commits the pipeline's tail."""
        while self.has_work():
            self.step()
        return dict(self._outputs)

    def outputs(self) -> Dict[str, RequestOutput]:
        return dict(self._outputs)

    def release_prefix_cache(self) -> int:
        """Drop the prefix cache's index and its page references:
        cached-free pages return to the free list (demoted to the host
        tier when it is on), pages still mapped by running sequences stay
        live. Returns the pages released. After a drain plus this call,
        check_no_leaks() holds again."""
        if self.pool.prefix_cache is None:
            return 0
        return self.pool.prefix_cache.clear()

    # ------------------------------------------------ inject / snapshot

    def inject_request(self, prompt_tokens: Sequence[int],
                       sampling: Optional[SamplingParams] = None, *,
                       request_id: Optional[str] = None,
                       output_tokens: Sequence[int] = (),
                       arrival_index: Optional[int] = None,
                       num_preemptions: int = 0,
                       elapsed_s: float = 0.0,
                       first_token_elapsed_s: Optional[float] = None,
                       offload: Optional[OffloadRecord] = None) -> str:
        """Admit a request WITH prior generation state: the restore
        primitive. The request re-enters the queue with its prompt AND
        partial ``output_tokens``; admission re-prefills the whole context
        and the step-indexed sample keys keep the continued stream token
        for token. Keeping ``arrival_index`` keeps seedless sampling
        streams and auto ids (the counter moves past it). ``offload`` (a
        record of slots already in this engine's host tier) resumes by
        page-in instead. Bypasses the bounded-queue shed gate: recovered
        requests are never shed by their own restore."""
        sampling = sampling or SamplingParams()
        if arrival_index is not None:
            ensure_arrival_counter_above(int(arrival_index))
            req = Request(prompt_tokens=list(map(int, prompt_tokens)),
                          sampling=sampling, request_id=request_id or "",
                          arrival_index=int(arrival_index))
        else:
            req = Request(prompt_tokens=list(map(int, prompt_tokens)),
                          sampling=sampling, request_id=request_id or "")
        if len(req.prompt_tokens) + sampling.max_tokens > self.max_model_len:
            raise ValueError(
                f"prompt({len(req.prompt_tokens)}) + max_tokens"
                f"({sampling.max_tokens}) exceeds max_model_len="
                f"{self.max_model_len}")
        if req.request_id in self._requests:
            raise ValueError(f"request {req.request_id!r} already present")
        req.output_tokens = list(map(int, output_tokens))
        req.num_preemptions = int(num_preemptions)
        now = self.metrics.clock()
        req.arrival_time = now - float(elapsed_s)
        if first_token_elapsed_s is not None:
            req.first_token_time = req.arrival_time + \
                float(first_token_elapsed_s)
        if offload is not None:
            req.offload = offload
            req.phase = "offloaded"
        self._requests[req.request_id] = req
        self.scheduler.add(req)
        self.metrics.requests_added.inc()
        self.metrics.queue_depth.set(self.scheduler.queue_depth)
        return req.request_id

    # ------------------------------------------ migration (router tier)

    # A preemption's OffloadRecord and inject_request already migrate a
    # request within one engine; these methods stretch the same machinery
    # across two: spill -> export the slots (page bytes, scale rows, CRC
    # content hashes) -> import into the sibling's tier -> inject with the
    # record attached, after which the sibling's page-in path takes over.

    def _stage(self, req: Request) -> None:
        """Park one running decode-phase request in the handoff buffer:
        its pages spill to the host tier from page 0 (shared prefix pages
        included: the record must stand alone on a sibling), coverage
        clamped to context - 1 as in preemption, so the receiver always
        computes the position it samples the next token from; the device
        pages and the slot are released."""
        tier = self.pool.host_tier
        rec = None
        if tier is not None:
            covered = min(req.kv.num_tokens, req.num_context - 1)
            rec = tier.spill_sequence(req.kv, covered,
                                      include_registered=True)
        self.scheduler.release_running(req)
        self._release_spec_state(req)
        req.phase = "handoff"
        req.offload = None
        self._handoffs[req.request_id] = rec
        self.metrics.handoffs_out.inc()
        if rec is not None:
            self.metrics.handoff_pages_out.inc(len(rec.slots))

    def _stage_handoffs(self) -> None:
        """Stage every request that completed its prefill (decode phase,
        at least one sampled token): the prefill role's step."""
        for req in [r for r in self.scheduler.running
                    if r.phase == "decode" and r.output_tokens
                    and not r.done]:
            self._stage(req)

    def stage_migration(self, request_id: str) -> bool:
        """Stage ONE running decode-phase request on demand, whatever the
        role: the graceful-drain primitive, so a draining replica's
        running requests ride to a sibling with their pages. Returns False
        when the request is not stageable (waiting, finished, still
        prefilling, no sampled token yet); the caller then falls back to
        extract_request or a registry recompute."""
        req = self._requests.get(request_id)
        if (req is None or req.done
                or req.state is not RequestState.RUNNING
                or req.phase != "decode" or not req.output_tokens):
            return False
        self._stage(req)
        return True

    def handoff_ready(self) -> List[str]:
        """Request ids staged for handoff, oldest first."""
        return list(self._handoffs)

    def _request_state(self, req: Request) -> dict:
        """The migration state of a request (the snapshot's per-request
        shape, with a live SamplingParams)."""
        now = self.metrics.clock()
        return {
            "request_id": req.request_id,
            "prompt_tokens": list(req.prompt_tokens),
            "output_tokens": list(req.output_tokens),
            "sampling": req.sampling,
            "arrival_index": req.arrival_index,
            "num_preemptions": req.num_preemptions,
            "elapsed_s": now - req.arrival_time,
            "first_token_elapsed_s": (
                req.first_token_time - req.arrival_time
                if req.first_token_time is not None else None),
        }

    def extract_handoff(self, request_id: str):
        """Remove a staged handoff and return (state, payload): the
        migration state and the page payload, per layer the stacked page
        arrays (numpy; scale rows included on int8 pools) and each slot's
        CRC content hash. payload is None when no pages rode along (no
        tier, or a full one); the receiver then recomputes. The host slots
        are freed here: the payload owns the bytes now. Over a host-wide
        store the payload is slot references instead ("slot_refs",
        "gens", "hashes", "xfer_owner"): this engine's refs move to the
        transfer tag "xfer:<request id>" and no page byte is copied."""
        if request_id not in self._handoffs:
            raise KeyError(f"request {request_id!r} is not staged for "
                           "handoff")
        rec = self._handoffs.pop(request_id)
        req = self._requests[request_id]
        state = self._request_state(req)
        payload = None
        tier = self.pool.host_tier
        if rec is not None and tier is not None and tier.store is not None:
            xfer = f"xfer:{request_id}"
            hashes = [tier.slot_hash(s) for s in rec.slots]
            tier.retag_out(rec.slots, xfer)
            payload = {
                "start_page": rec.start_page,
                "covered_tokens": rec.covered_tokens,
                "slot_refs": list(rec.slots),
                "gens": [tier.generation(s) for s in rec.slots],
                "hashes": hashes,
                "xfer_owner": xfer,
            }
        elif rec is not None and tier is not None:
            payload = {
                "start_page": rec.start_page,
                "covered_tokens": rec.covered_tokens,
                "hashes": [tier.slot_hash(s) for s in rec.slots],
                "layers": tier.export_slots(rec.slots),
            }
            self.metrics.handoff_bytes_out.inc(sum(
                int(a.nbytes) for layer in payload["layers"]
                for a in layer))
            tier.free_slots(rec.slots)
        del self._requests[request_id]
        self._detoks.pop(request_id, None)
        return state, payload

    def import_handoff(self, state: dict, payload: Optional[dict]) -> str:
        """Accept a handed-off request: write the page payload into this
        engine's host tier (each content hash re-verified against the
        bytes written: a corrupted transfer raises, it is never served)
        and inject the request with the rebuilt OffloadRecord. Admission
        then pages the slots in (the side-stream copy and the fence before
        compute), so the continued stream is token-exact, int8 codes
        included: the pages are copies, not recompute. A payload that
        cannot land (no tier here, or a full one) resumes by recompute,
        counted. A slot-reference payload is adopted from the host-wide
        store this engine shares with the sender (a stale generation
        recomputes, a CRC mismatch raises); an engine without a store
        raises ValueError for one."""
        rec = None
        tier = self.pool.host_tier
        refs = payload is not None and payload.get("slot_refs") is not None
        if refs and (tier is None or tier.store is None):
            # loud, not a silent recompute: the sender moved its refs to a
            # transfer tag, which the router's fallback reaps
            raise ValueError(
                "received a slot-reference handoff but this engine has no "
                "shared KV store: sender and receiver must share one host "
                "store")
        if payload is not None and tier is not None:
            if refs:
                slots = tier.adopt_slots(
                    payload["slot_refs"], payload["gens"],
                    payload["hashes"], payload["xfer_owner"])
            else:
                slots = tier.import_slots(payload["layers"],
                                          payload["hashes"])
            if slots is not None:
                rec = OffloadRecord(
                    start_page=int(payload["start_page"]),
                    covered_tokens=int(payload["covered_tokens"]),
                    slots=slots)
        if rec is None:
            self.metrics.handoff_recompute_fallbacks.inc()
        else:
            self.metrics.handoff_pages_in.inc(len(rec.slots))
        self.metrics.handoffs_in.inc()
        return self.inject_request(
            state["prompt_tokens"], state["sampling"],
            request_id=state["request_id"],
            output_tokens=state["output_tokens"],
            arrival_index=(int(state["arrival_index"])
                           if state.get("arrival_index") is not None
                           else None),
            num_preemptions=int(state.get("num_preemptions", 0)),
            elapsed_s=float(state.get("elapsed_s", 0.0)),
            first_token_elapsed_s=state.get("first_token_elapsed_s"),
            offload=rec)

    def extract_request(self, request_id: str) -> dict:
        """Remove a WAITING request and return its migration state: the
        router extracts queued requests from a restored or draining
        replica and injects them into siblings. RUNNING requests hold
        device pages and cannot move this way; FINISHED ones have nothing
        to move."""
        req = self._requests.get(request_id)
        if req is None:
            raise KeyError(f"unknown request {request_id!r}")
        if req.state is not RequestState.WAITING \
                or request_id in self._handoffs:
            raise ValueError(
                f"request {request_id!r} is {req.state.value}; only "
                "WAITING requests can be extracted")
        self.scheduler.remove_waiting(req)
        del self._requests[request_id]
        self._detoks.pop(request_id, None)
        self.metrics.queue_depth.set(self.scheduler.queue_depth)
        return self._request_state(req)

    def snapshot(self) -> dict:
        """Crash-safe serialization of ALL request state (prompts,
        generated tokens, sampling params, arrival order) and the
        finished outputs, JSON-serializable, in the JAX package's layout.
        Device and host-tier state is left out: `restore` rebuilds KV by
        recompute-on-resume, which the step-indexed sample keys make
        token-exact, and the prefix cache's index (it points at device
        pages) starts empty. Output tokens hold only committed tokens: an
        in-flight launch of the pipelined loop is recomputed."""
        now = self.metrics.clock()

        def req_state(req: Request) -> dict:
            sp = asdict(req.sampling)
            sp["stop_token_ids"] = list(sp["stop_token_ids"])
            return {
                "request_id": req.request_id,
                "prompt_tokens": list(req.prompt_tokens),
                "output_tokens": list(req.output_tokens),
                "sampling": sp,
                "arrival_index": req.arrival_index,
                "num_preemptions": req.num_preemptions,
                "elapsed_s": now - req.arrival_time,
                "first_token_elapsed_s": (
                    req.first_token_time - req.arrival_time
                    if req.first_token_time is not None else None),
            }

        # resume priority: running requests first (admission order), then
        # the waiting queue left to right (preempted first); staged
        # handoffs ride as plain waiters (their host pages die with a
        # crash, so a restored engine re-prefills them, and a restored
        # prefill-role engine re-stages them)
        reqs = [req_state(r) for r in (*self.scheduler.running,
                                       *self.scheduler.waiting)]
        reqs += [req_state(self._requests[rid]) for rid in self._handoffs]
        return {
            "version": 1,
            "config": {
                "num_blocks": self.pool.num_blocks,
                "block_size": self.pool.block_size,
                "max_batch_size": self.max_batch_size,
                "max_model_len": self.max_model_len,
                "max_queue_depth": self.max_queue_depth,
                "shed_policy": self.shed_policy,
                "admission_watermark": self.admission_watermark,
                "max_step_retries": self.max_step_retries,
                "retry_backoff_s": self.retry_backoff_s,
                "nan_policy": self.nan_policy,
                "max_prefill_tokens_per_step":
                    self.max_prefill_tokens_per_step,
                "enable_prefix_cache": self.enable_prefix_cache,
                # the tier's knobs ride along, its pages do not (pinned
                # host memory dies with the process)
                "host_tier_pages": self.host_tier_pages,
                "host_tier_headroom": self.host_tier_headroom,
                "pagein_prefetch": self.pagein_prefetch,
                "ragged_batch": self.ragged_batch,
                "decode_horizon": self.decode_horizon,
                "pipelined": self.pipelined,
                "horizon_sampling": self.horizon_sampling,
                "horizon_early_stop": self.horizon_early_stop,
                "spill_async": self.spill_async,
                "role": self.role,
                "num_speculative_tokens": self.num_speculative_tokens,
                "spec_max_ngram": self.spec_max_ngram,
                "spec_min_ngram": self.spec_min_ngram,
                "spec_adaptive_k": self.spec_adaptive_k,
                "spec_draft_model": self.spec_draft_model,
                "spec_draft_blocks": self.spec_draft_blocks,
                "spec_ngram_window": self.spec_ngram_window,
                # the dtypes ride along for the record; restore follows
                # the new runner's (recompute rebuilds KV from tokens)
                "kv_dtype": self.kv_dtype,
                "weight_dtype": getattr(self.runner, "weight_dtype",
                                        "fp32"),
                "weight_group_size": getattr(self.runner,
                                             "weight_group_size", 128),
                "comm_dtype": getattr(self.runner, "comm_dtype", "fp32"),
                # the mesh's shape for the record; restore follows the new
                # runner's mesh (recompute-on-resume is sharding-blind)
                "mesh_axes": (
                    {str(a): int(n) for a, n in self.mesh.shape.items()}
                    if self.mesh is not None else None),
            },
            "requests": reqs,
            "finished": [asdict(o) for o in self._outputs.values()],
        }

    @classmethod
    def restore(cls, runner: PagedModelRunner, state: dict, *,
                metrics: Optional[EngineMetrics] = None,
                tokenizer=None,
                kv_store=None, kv_store_owner: Optional[str] = None,
                sleep_fn: Optional[Callable[[float], None]] = None,
                audit: Optional[bool] = None) -> "ServingEngine":
        """Rebuild an engine from `snapshot` on a fresh runner. Every
        in-flight request re-enters the queue with its prompt AND partial
        generation, and admission re-prefills its whole context, so the
        continued stream equals an uninterrupted run's. ``kv_store`` and
        ``kv_store_owner`` attach the restored engine's host tier to a
        host-wide store, as the constructor's do."""
        if state.get("version") != 1:
            raise ValueError(f"unknown snapshot version {state.get('version')}")
        cfg = state["config"]
        draft_model = cfg.get("spec_draft_model")
        if draft_model == "custom":
            # a caller-built draft runner cannot be rebuilt from JSON; the
            # streams stay exact (acceptance never depends on the draft)
            logger.info("restore: snapshot used a custom draft-model "
                        "instance; restoring with the n-gram proposer")
            draft_model = None
        eng = cls(runner, num_blocks=cfg["num_blocks"],
                  block_size=cfg["block_size"],
                  max_batch_size=cfg["max_batch_size"],
                  max_model_len=cfg["max_model_len"],
                  max_queue_depth=cfg["max_queue_depth"],
                  shed_policy=cfg["shed_policy"],
                  admission_watermark=cfg["admission_watermark"],
                  max_step_retries=cfg["max_step_retries"],
                  retry_backoff_s=cfg["retry_backoff_s"],
                  nan_policy=cfg["nan_policy"],
                  max_prefill_tokens_per_step=cfg.get(
                      "max_prefill_tokens_per_step"),
                  enable_prefix_cache=cfg.get("enable_prefix_cache", False),
                  host_tier_pages=cfg.get("host_tier_pages", 0),
                  host_tier_headroom=cfg.get("host_tier_headroom", False),
                  pagein_prefetch=cfg.get("pagein_prefetch", 2),
                  ragged_batch=cfg.get("ragged_batch", False),
                  decode_horizon=cfg.get("decode_horizon", 1),
                  pipelined=cfg.get("pipelined", False),
                  horizon_sampling=cfg.get("horizon_sampling", False),
                  horizon_early_stop=cfg.get("horizon_early_stop", False),
                  spill_async=cfg.get("spill_async", False),
                  role=cfg.get("role", "mixed"),
                  num_speculative_tokens=cfg.get("num_speculative_tokens", 0),
                  spec_max_ngram=cfg.get("spec_max_ngram", 3),
                  spec_min_ngram=cfg.get("spec_min_ngram", 1),
                  spec_adaptive_k=cfg.get("spec_adaptive_k", False),
                  spec_draft_model=draft_model,
                  spec_draft_blocks=cfg.get("spec_draft_blocks"),
                  spec_ngram_window=cfg.get("spec_ngram_window"),
                  tokenizer=tokenizer,
                  kv_store=kv_store, kv_store_owner=kv_store_owner,
                  metrics=metrics, sleep_fn=sleep_fn, audit=audit)
        for r in state["requests"]:
            sp = dict(r["sampling"])
            sp["stop_token_ids"] = tuple(sp.get("stop_token_ids", ()))
            eng.inject_request(
                r["prompt_tokens"], SamplingParams(**sp),
                request_id=r["request_id"],
                output_tokens=r["output_tokens"],
                arrival_index=int(r["arrival_index"]),
                num_preemptions=int(r.get("num_preemptions", 0)),
                elapsed_s=float(r.get("elapsed_s", 0.0)),
                first_token_elapsed_s=r.get("first_token_elapsed_s"))
        for o in state.get("finished", []):
            eng._outputs[o["request_id"]] = RequestOutput(**o)
        eng.metrics.queue_depth.set(eng.scheduler.queue_depth)
        snap_mesh = cfg.get("mesh_axes")
        run_mesh = ({str(a): int(n) for a, n in eng.mesh.shape.items()}
                    if eng.mesh is not None else None)
        if snap_mesh != run_mesh:
            # legal (recompute-on-resume is token-exact on any mesh), but
            # capacity and throughput differ
            logger.info("restore: snapshot mesh %s -> runner mesh %s",
                        snap_mesh, run_mesh)
        snap_q = (cfg.get("kv_dtype", "fp32"),
                  cfg.get("weight_dtype", "fp32"),
                  cfg.get("comm_dtype", "fp32"),
                  cfg.get("weight_group_size", 128))
        run_q = (eng.kv_dtype, getattr(runner, "weight_dtype", "fp32"),
                 getattr(runner, "comm_dtype", "fp32"),
                 getattr(runner, "weight_group_size", 128))
        if snap_q != run_q:
            # legal (restore recomputes KV from tokens), but the continued
            # stream follows the new runner's quantization
            logger.info("restore: snapshot kv/weight dtype %s -> runner "
                        "%s", snap_q, run_q)
        return eng


def naive_generate(runner: PagedModelRunner, prompt_tokens: Sequence[int],
                   sampling: Optional[SamplingParams] = None,
                   max_model_len: Optional[int] = None,
                   fallback_seed: int = 0) -> List[int]:
    """Sequential single-request generation — the scheduling oracle.

    Same runner, same page layout (a private identity-mapped pool), no
    scheduler, no batching, no preemption. ServingEngine must match this
    token-for-token for every request. ``fallback_seed`` is the seed of a
    sampled request without one (the engine uses its arrival index)."""
    sampling = sampling or SamplingParams()
    max_model_len = max_model_len or runner.max_model_len
    max_pages = -(-max_model_len // runner.block_size)
    pool = KVCachePool(runner.num_layers, max_pages + 1, runner.block_size,
                       runner.n_kv_heads, runner.head_dim, runner.dtype,
                       mesh=getattr(runner, "mesh", None),
                       model_axis=getattr(runner, "model_axis", "model"),
                       device=runner.device, kv_dtype=runner.kv_dtype)
    pages = pool.allocator.alloc(max_pages)
    # the oracle's pages carry the request's effective tag, so a mixed
    # pool's fp8 tenant writes through the same fp8 round trip
    pool.tag_pages(pages, sampling.kv_dtype or pool.native_kv_tag())
    table = pool.pad_table(pages, max_pages)
    tokens = list(map(int, prompt_tokens))
    logits, pools = runner.prefill(tokens, table, pool.shards)
    tok = sample_token(logits, sampling, 0, fallback_seed)
    out: List[int] = [tok]
    tables = np.asarray(table, np.int32)[None]
    while len(out) < sampling.max_tokens and tok not in \
            sampling.stop_token_ids:
        pos = np.asarray([len(tokens) + len(out) - 1], np.int32)
        logits, pools = runner.decode(np.asarray([tok], np.int32), tables,
                                      pos, pools)
        tok = sample_token(logits[0], sampling, len(out), fallback_seed)
        out.append(tok)
    return out


def create_engine(model, *, num_blocks: int = 128, block_size: int = 16,
                  max_batch_size: int = 8,
                  max_model_len: Optional[int] = None,
                  attn_impl: str = "auto", mesh=None,
                  data_axis: str = "data", model_axis: str = "model",
                  kv_dtype: str = "fp32", weight_dtype: str = "fp32",
                  weight_group_size: int = 128,
                  comm_dtype: str = "fp32", device="cuda",
                  **engine_kw) -> ServingEngine:
    """Build a ServingEngine for a supported model (Llama or GPT) on
    ``device`` (default "cuda"; pass "cpu" for the plain versions). The
    parameters are the JAX package's, in its order, ``device`` after
    them. A ``mesh`` (`parallel.mesh.serving_mesh`) serves
    tensor-parallel: the runner is sharded over its ``model_axis``
    (`PagedModelRunner.shard`, with ``data_axis`` and ``comm_dtype``) and
    the pools split on the kv-head axis; without one ``data_axis`` and
    ``model_axis`` are ignored, as JAX ignores them, and ``comm_dtype``
    other than "fp32" is an error of the call (ValueError, as in JAX: the
    quantized collective needs a mesh). ``weight_group_size`` goes to the
    runner."""
    if comm_dtype != "fp32" and mesh is None:
        raise ValueError(
            f"comm_dtype={comm_dtype!r} needs a tensor-parallel mesh: the "
            "quantized collective replaces the row-parallel allreduce, "
            "which only exists at tp > 1")
    runner = runner_for(model, block_size=block_size,
                        max_model_len=max_model_len, attn_impl=attn_impl,
                        kv_dtype=kv_dtype, weight_dtype=weight_dtype,
                        weight_group_size=weight_group_size, device=device)
    if mesh is not None:
        runner.shard(mesh, data_axis=data_axis, model_axis=model_axis,
                     comm_dtype=comm_dtype)
    return ServingEngine(runner, num_blocks=num_blocks,
                         block_size=block_size,
                         max_batch_size=max_batch_size,
                         max_model_len=max_model_len, **engine_kw)
