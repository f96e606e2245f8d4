"""ServingEngine: continuous-batching generation over the paged KV pool.

Counterpart of paddle_tpu/serving/engine.py's default loop: an admission
queue feeds a fixed-slot decode batch; prefill computes a new request's
context in CHUNKS bounded by a per-step token budget
(`max_prefill_tokens_per_step`), then every step decodes one token for
every decode-phase request in a single batched call; finished requests
free their pages and their slot is refilled from the queue.

The engine is deterministic end-to-end: FCFS admission, sorted-free-list
pages, greedy sampling. `naive_generate` is the scheduling oracle: the
same runner, one request at a time, no scheduler — continuous batching
must reproduce its tokens exactly.

Failure modes end requests instead of raising from step():

  finish_reason   trigger
  "stop"/"length" normal completion
  "timeout"       SamplingParams.timeout_s exceeded (queue wait counts)
  "aborted"       engine.abort(request_id)
  "shed"          bounded queue overflowed under shed_policy="drop_oldest"
  "error"         prefill failed past max_step_retries, a decode batch
                  was quarantined, or NaN/Inf logits under nan_policy
                  "abort" (or with no finite entry at all)

The JAX engine's other knobs (prefix cache, fused ragged batches, decode
horizons, the pipelined loop, speculation, host tiers, roles, the
detokenizer) are not ported yet: passing any of them with a value other
than its default raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.serving.kv_cache import KVCachePool, SCRATCH_PAGE
from paddle_tpu_torch.serving.metrics import EngineMetrics
from paddle_tpu_torch.serving.model_runner import PagedModelRunner, runner_for
from paddle_tpu_torch.serving.resilience import QueueFullError, audit_engine
from paddle_tpu_torch.serving.scheduler import (
    FCFSScheduler, Request, RequestState, SamplingParams,
)

logger = logging.getLogger(__name__)

_ITEM = "ROADMAP.md 'Still to port' item "

# the JAX engine's knobs this port does not carry yet: name -> (the
# default that keeps the feature off, the ROADMAP item that ports it)
UNPORTED_KNOBS = {
    "enable_prefix_cache": (False, _ITEM + "5 (prefix cache)"),
    "ragged_batch": (False, _ITEM + "6 (ragged_batch)"),
    "decode_horizon": (1, _ITEM + "7 (horizons and speculation)"),
    "pipelined": (False, _ITEM + "7 (horizons and speculation)"),
    "horizon_sampling": (False, _ITEM + "7 (horizons and speculation)"),
    "horizon_early_stop": (False, _ITEM + "7 (horizons and speculation)"),
    "num_speculative_tokens": (0, _ITEM + "7 (horizons and speculation)"),
    "spec_max_ngram": (3, _ITEM + "7 (horizons and speculation)"),
    "spec_min_ngram": (1, _ITEM + "7 (horizons and speculation)"),
    "spec_adaptive_k": (False, _ITEM + "7 (horizons and speculation)"),
    "spec_draft_model": (None, _ITEM + "7 (horizons and speculation)"),
    "spec_draft_blocks": (None, _ITEM + "7 (horizons and speculation)"),
    "spec_ngram_window": (None, _ITEM + "7 (horizons and speculation)"),
    "host_tier_pages": (0, _ITEM + "9 (host tier)"),
    "host_tier_headroom": (False, _ITEM + "9 (host tier)"),
    "pagein_prefetch": (2, _ITEM + "9 (host tier)"),
    "spill_async": (False, _ITEM + "9 (host tier)"),
    "kv_store": (None, _ITEM + "9 (host tier)"),
    "kv_store_owner": (None, _ITEM + "9 (host tier)"),
    "role": ("mixed", _ITEM + "11 (tier)"),
    "tokenizer": (None, _ITEM + "15 (serving extras: detokenizer)"),
}


def refuse_unported(knobs: Dict[str, object]) -> None:
    """Raise for any JAX engine knob this port does not carry, unless it
    holds its default; unknown names raise TypeError like any keyword."""
    for name, value in knobs.items():
        if name not in UNPORTED_KNOBS:
            raise TypeError(f"unexpected engine knob {name!r}")
        default, item = UNPORTED_KNOBS[name]
        if value != default:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet: {item}")


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


def _refuse_sampled(sampling: SamplingParams) -> None:
    if sampling.temperature != 0.0:
        raise NotImplementedError(
            f"temperature={sampling.temperature}: seeded sampling is not "
            "ported yet (it needs the threefry port): " + _ITEM
            + "4 (seeded sampling)")


def _refuse_session(sampling: SamplingParams) -> None:
    if sampling.session_id is not None:
        raise NotImplementedError(
            f"session_id={sampling.session_id!r}: session affinity belongs "
            "to the serving tier (router, replicas), not ported yet: "
            + _ITEM + "11 (tier)")


def sample_token(logits_row: np.ndarray, sampling: SamplingParams) -> int:
    """The next token from one [V] logits row, host-side (greedy)."""
    _refuse_sampled(sampling)
    return int(np.argmax(logits_row))


def _to_host(x) -> np.ndarray:
    """THE device->host sync boundary: every blocking drain the engine
    performs funnels through here, so a test can patch this one symbol
    and count how often a step waited on the device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def greedy_grid(logits):
    """ONE argmax and ONE finiteness reduction over a [..., V] logits
    tensor, computed where the logits live, then ONE small host transfer
    of both as a packed int32 array. Tie-breaking matches np.argmax
    (first max wins)."""
    packed = _to_host(torch.stack(
        [logits.argmax(dim=-1).to(torch.int32),
         torch.isfinite(logits).all(dim=-1).to(torch.int32)]))
    return packed[0], packed[1].astype(bool)


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
                 sleep_fn: Optional[Callable[[float], None]] = None,
                 audit: Optional[bool] = None,
                 **unported):
        refuse_unported(unported)
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
        # the KV storage rung is a runner property: the runner quantizes at
        # append time, so the engine builds its pools with the same rung
        self.kv_dtype = runner.kv_dtype
        self.pool = KVCachePool(runner.num_layers, num_blocks, block_size,
                                runner.n_kv_heads, runner.head_dim,
                                runner.dtype, device=runner.device,
                                kv_dtype=self.kv_dtype)
        self.max_pages_per_seq = self.pool.blocks_for_tokens(
            self.max_model_len)
        self.scheduler = FCFSScheduler(self.pool, max_batch_size,
                                       self.max_pages_per_seq,
                                       admission_watermark,
                                       max_prefill_tokens_per_step)
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
        self._requests: Dict[str, Request] = {}
        self._outputs: Dict[str, RequestOutput] = {}

    # ----------------------------------------------------------- intake

    def _check_kv_dtype(self, sampling: SamplingParams) -> None:
        """Per-request KV precision gate: a pool serves only its own
        rung. Loud at intake: a silently widened or narrowed tenant would
        break the byte accounting and the accuracy story."""
        want = sampling.kv_dtype
        if want is not None and want != self.kv_dtype:
            raise ValueError(
                f"SamplingParams.kv_dtype={want!r} is not servable by this "
                f"engine's kv_dtype={self.kv_dtype!r} pool (allowed: "
                f"{[self.kv_dtype]}); the 'mixed' pool that serves several "
                "is ROADMAP.md 'Still to port' item 8")

    def add_request(self, prompt_tokens: Sequence[int],
                    sampling: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None) -> str:
        sampling = sampling or SamplingParams()
        _refuse_sampled(sampling)
        _refuse_session(sampling)
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
        return self.scheduler.has_work()

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
        if req.state is RequestState.RUNNING:
            self.scheduler.finish(req, reason)
        else:
            self.scheduler.remove_waiting(req)
            req.state = RequestState.FINISHED
            req.finish_reason = reason
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

    def _resolve_token(self, greedy_tok, finite,
                       row_fn: Callable[[], np.ndarray]) -> Optional[int]:
        """NaN/Inf-guarded greedy token for ONE logits row, fed from a
        `greedy_grid` pass; `row_fn` fetches the [V] row only for a NaN
        rescue. Returns None when the request must be aborted
        (nan_policy="abort", or no finite logit exists)."""
        if finite:
            return int(greedy_tok)
        self.metrics.nan_logit_events.inc()
        if self.nan_policy == "greedy":
            row = np.asarray(row_fn())
            ok = np.isfinite(row)
            if ok.any():
                return int(np.argmax(np.where(ok, row, -np.inf)))
        return None

    # ------------------------------------------------------------- step

    def step(self) -> List[TokenEvent]:
        """One engine iteration: expire deadlines, admit new requests,
        run this step's prefill chunks under the token budget, reserve
        decode pages (preempting if needed), run one batched decode step
        over the decode-phase requests. Returns the tokens produced this
        step. Load- and fault-induced failures never escape: they end
        requests with an explicit finish_reason."""
        if not self.has_work():
            return []
        self.metrics.mark_active()
        t0 = self.metrics.clock()
        events: List[TokenEvent] = []
        # deadlines first: an expired request must not win admission
        self._expire_deadlines()
        self.scheduler.admit()
        plan = self.scheduler.prefill_plan()
        self.metrics.host_plan_seconds.inc(self.metrics.clock() - t0)
        for req, start, end in plan:
            ev = self._prefill_chunk_with_recovery(req, start, end)
            if ev is not None:
                events.append(ev)
        # decode-page reservation; pool pressure preempts youngest-first
        for _ in self.scheduler.reserve_decode():
            self.metrics.preemptions.inc()
        if self.scheduler.running:
            events.extend(self._decode_with_recovery())
        self.metrics.decode_steps.inc()

        self.metrics.attn_kv_bytes_read.set(self.runner.attn_kv_bytes_read)
        self.metrics.attn_kv_bytes_gather.set(
            self.runner.attn_kv_bytes_gather)
        a = self.pool.allocator
        self.metrics.queue_depth.set(self.scheduler.queue_depth)
        self.metrics.running.set(len(self.scheduler.running))
        self.metrics.pool_used_pages.set(a.num_usable - a.num_free)
        self.metrics.pool_utilization.set(self.pool.utilization())
        self.metrics.step_seconds.inc(self.metrics.clock() - t0)
        if self.audit:
            audit_engine(self)
        return events

    def _prefill_chunk_with_recovery(self, req: Request, start: int,
                                     end: int) -> Optional[TokenEvent]:
        """Compute context positions [start, end) of one request's
        (re-)prefill, retrying transient runner failures with bounded
        exponential backoff; a request whose chunk keeps failing is
        quarantined (finish_reason="error"). The chunk that completes the
        context samples the request's next token and flips it into the
        decode phase."""
        table = self.pool.pad_table(req.kv.pages, self.max_pages_per_seq)
        chunk = req.context_tokens[start:end]
        delay = self.retry_backoff_s
        for attempt in range(self.max_step_retries + 1):
            try:
                logits, new_pools = self.runner.prefill_chunk(
                    chunk, start, table, self.pool.pools)
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
        self.pool.pools = new_pools
        req.kv.num_tokens = end
        self.metrics.prefill_tokens.inc(end - start)
        self.metrics.prefill_chunks.inc()
        if end < req.num_context:
            return None              # intermediate chunk: logits unread
        am, fin = self._timed_drain(lambda: greedy_grid(logits))
        self.metrics.host_syncs.inc()
        tok = self._resolve_token(am, fin, lambda: _to_host(logits))
        if tok is None:
            self._finish_abnormal(req, "error")
            return None
        req.phase = "decode"
        return self._append_token(req, tok)

    def _decode_with_recovery(self) -> List[TokenEvent]:
        """One batched decode step with transient-failure recovery: retry
        with backoff; once retries are exhausted, quarantine the youngest
        decode request (the step is then rebuilt without it). Each
        quarantine shrinks the batch, so the loop ends.

        A retried decode is exact: a failed attempt either never reached
        the device or re-writes the same K/V values through the same
        block tables. Only decode-phase requests join the batch; the
        other slots carry all-scratch tables and self-neutralize."""
        attempts = 0
        delay = self.retry_backoff_s
        while True:
            batch = self.scheduler.decode_ready()
            if not batch:
                return []
            B, P = self.max_batch_size, self.max_pages_per_seq
            tokens = np.zeros((B,), np.int32)
            tables = np.full((B, P), SCRATCH_PAGE, np.int32)
            pos = np.zeros((B,), np.int32)
            for req in batch:
                s = req.slot
                tokens[s] = req.output_tokens[-1]
                tables[s, :len(req.kv.pages)] = req.kv.pages
                pos[s] = req.num_context - 1   # position of the fed token
            try:
                logits, new_pools = self.runner.decode(tokens, tables, pos,
                                                       self.pool.pools)
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
        self.pool.pools = new_pools
        self.metrics.batch_occupancy.observe(len(batch))
        am, fin = self._timed_drain(lambda: greedy_grid(logits))
        self.metrics.host_syncs.inc()
        host: Dict[str, np.ndarray] = {}

        def _rows() -> np.ndarray:
            if "l" not in host:
                host["l"] = self._timed_drain(lambda: _to_host(logits))
                self.metrics.host_syncs.inc()
            return host["l"]

        events = []
        for req in batch:
            sl = req.slot
            req.kv.num_tokens = req.num_context
            tok = self._resolve_token(am[sl], fin[sl],
                                      lambda s=sl: _rows()[s])
            if tok is None:
                self._finish_abnormal(req, "error")
                continue
            events.append(self._append_token(req, tok))
        return events

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

    # -------------------------------------------------------------- run

    def run(self) -> Dict[str, RequestOutput]:
        """Drain the engine; returns every finished RequestOutput."""
        while self.has_work():
            self.step()
        return dict(self._outputs)

    def outputs(self) -> Dict[str, RequestOutput]:
        return dict(self._outputs)


def naive_generate(runner: PagedModelRunner, prompt_tokens: Sequence[int],
                   sampling: Optional[SamplingParams] = None,
                   max_model_len: Optional[int] = None,
                   fallback_seed: int = 0) -> List[int]:
    """Sequential single-request generation — the scheduling oracle.

    Same runner, same page layout (a private identity-mapped pool), no
    scheduler, no batching, no preemption. ServingEngine must match this
    token-for-token for every request. ``fallback_seed`` (the stream of a
    sampled request without a seed) is read only on a sampled path, which
    raises until seeded sampling is ported."""
    sampling = sampling or SamplingParams()
    _refuse_sampled(sampling)
    max_model_len = max_model_len or runner.max_model_len
    max_pages = -(-max_model_len // runner.block_size)
    pool = KVCachePool(runner.num_layers, max_pages + 1, runner.block_size,
                       runner.n_kv_heads, runner.head_dim, runner.dtype,
                       device=runner.device, kv_dtype=runner.kv_dtype)
    pages = pool.allocator.alloc(max_pages)
    table = pool.pad_table(pages, max_pages)
    tokens = list(map(int, prompt_tokens))
    logits, pools = runner.prefill(tokens, table, pool.pools)
    tok = sample_token(_to_host(logits), sampling)
    out: List[int] = [tok]
    tables = np.asarray(table, np.int32)[None]
    while len(out) < sampling.max_tokens and tok not in \
            sampling.stop_token_ids:
        pos = np.asarray([len(tokens) + len(out) - 1], np.int32)
        logits, pools = runner.decode(np.asarray([tok], np.int32), tables,
                                      pos, pools)
        tok = sample_token(_to_host(logits)[0], sampling)
        out.append(tok)
    return out


def create_engine(model, *, num_blocks: int = 128, block_size: int = 16,
                  max_batch_size: int = 8,
                  max_model_len: Optional[int] = None,
                  attn_impl: str = "auto", device="cuda", mesh=None,
                  kv_dtype: str = "fp32", weight_dtype: str = "fp32",
                  **engine_kw) -> ServingEngine:
    """Build a ServingEngine for a supported model (Llama) on ``device``
    (default "cuda"; pass "cpu" for the plain versions)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (tensor-parallel serving) is not ported yet: "
            + _ITEM + "10 (TP)")
    runner = runner_for(model, block_size=block_size,
                        max_model_len=max_model_len, attn_impl=attn_impl,
                        kv_dtype=kv_dtype, weight_dtype=weight_dtype,
                        device=device)
    return ServingEngine(runner, num_blocks=num_blocks,
                         block_size=block_size,
                         max_batch_size=max_batch_size,
                         max_model_len=max_model_len, **engine_kw)
