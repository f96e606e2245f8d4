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

The JAX engine's other knobs (prefix cache, fused ragged batches,
speculation, host tiers, roles, the detokenizer) are not ported yet:
passing any of them with a value other than its default raises
NotImplementedError naming its ROADMAP item.

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
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
    "num_speculative_tokens": (0, _ITEM + "7 part B (speculation)"),
    "spec_max_ngram": (3, _ITEM + "7 part B (speculation)"),
    "spec_min_ngram": (1, _ITEM + "7 part B (speculation)"),
    "spec_adaptive_k": (False, _ITEM + "7 part B (speculation)"),
    "spec_draft_model": (None, _ITEM + "7 part B (speculation)"),
    "spec_draft_blocks": (None, _ITEM + "7 part B (speculation)"),
    "spec_ngram_window": (None, _ITEM + "7 part B (speculation)"),
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


def _refuse_session(sampling: SamplingParams) -> None:
    if sampling.session_id is not None:
        raise NotImplementedError(
            f"session_id={sampling.session_id!r}: session affinity belongs "
            "to the serving tier (router, replicas), not ported yet: "
            + _ITEM + "11 (tier)")


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
        return x.detach().cpu().numpy()
    return np.asarray(x)


def greedy_grid(logits):
    """ONE argmax and ONE finiteness reduction over a [..., V] logits
    tensor, computed where the logits live, then ONE small host transfer
    of both as a packed int32 array. Tie-breaking matches np.argmax
    (first max wins)."""
    packed = _to_host(token_grid(logits))
    return packed[0], packed[1].astype(bool)


# one sampled group of a decode batch: (top_k, top_p, seeds [B], steps
# [B], temps [B], slots)
SampleGroup = Tuple[Optional[int], Optional[float], np.ndarray, np.ndarray,
                    np.ndarray, List[int]]


def token_grid(logits, groups: Sequence[SampleGroup] = ()):
    """The device side of a decode drain, not yet drained: [2 + G, ...]
    int32 holding the argmax, the all-finite flags and, for each sampled
    group (one (top_k, top_p) each), every row's seeded sample of the
    [B, V] logits through `_sampled_rows`."""
    planes = [logits.argmax(dim=-1).to(torch.int32),
              torch.isfinite(logits).all(dim=-1).to(torch.int32)]
    dev = logits.device
    for top_k, top_p, seeds, steps, temps, _ in groups:
        planes.append(PagedModelRunner._sampled_rows(
            logits, torch.from_numpy(seeds).to(dev),
            torch.from_numpy(steps).to(dev), torch.from_numpy(temps).to(dev),
            top_k, top_p).to(torch.int32))
    return torch.stack(planes)


@dataclass
class _InflightLaunch:
    """One dispatched-but-undrained decode launch (the pipelined loop's
    unit of deferred work). ``batch`` pins (request, slot) pairs as of
    launch time; a member aborted or expired before the commit is skipped
    at replay. The pools are written in place, so no snapshot of them
    rides along (module docstring)."""

    kind: str                    # "decode" | "decode_multi"
    batch: list                  # [(Request, slot), ...] at launch
    result: object               # the token grid, or packed [2|3, B, s]
    s: int = 1                   # horizon length (decode_multi)
    logits: object = None        # decode: the [B, V] rows for a NaN rescue
    groups: tuple = ()           # decode: the grid's sampled groups


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
                 decode_horizon: int = 1,
                 pipelined: bool = False,
                 horizon_sampling: bool = False,
                 horizon_early_stop: bool = False,
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
        if decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1 (1 = sync with "
                             "the host every step)")
        self.decode_horizon = int(decode_horizon)
        self.pipelined = bool(pipelined)
        self.horizon_sampling = bool(horizon_sampling)
        self.horizon_early_stop = bool(horizon_early_stop)
        # the pipelined loop's single in-flight launch: dispatched at the
        # end of one step, drained and replayed by the next (or flush())
        self._inflight: Optional[_InflightLaunch] = None
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

    # ------------------------------------------------------------- step

    def step(self) -> List[TokenEvent]:
        """One engine iteration: expire deadlines, admit new requests,
        (pipelined: commit the previous step's launch,) run this step's
        prefill chunks under the token budget, reserve decode pages
        (preempting if needed), then one batched decode step or one
        device-resident horizon over the decode-phase requests. Returns
        the tokens produced this step (pipelined: the previous launch's).
        Load- and fault-induced failures never escape: they end requests
        with an explicit finish_reason."""
        if not self.has_work():
            return []
        self.metrics.mark_active()
        t0 = self.metrics.clock()
        events: List[TokenEvent] = []
        # ---- PLAN (host work; pipelined, the previous launch still runs)
        # deadlines first: an expired request must not win admission
        self._expire_deadlines()
        # admitting against a state that predates the in-flight launch's
        # tokens is safe: its commit only frees pages and slots
        self.scheduler.admit()
        plan = self.scheduler.prefill_plan()
        t_plan = self.metrics.clock() - t0
        self.metrics.host_plan_seconds.inc(t_plan)
        if self._inflight is not None:
            self.metrics.planned_ahead_steps.inc()
        if self.pipelined:
            # ---- COMMIT: drain and replay the previous step's launch;
            # re-slice the plan after it (a commit can end a request)
            events.extend(self._commit_inflight())
            plan = self.scheduler.prefill_plan()
        # ---- EXECUTE
        for req, start, end in plan:
            ev = self._prefill_chunk_with_recovery(req, start, end)
            if ev is not None:
                events.append(ev)
        # decode-page reservation; pool pressure preempts youngest-first
        for _ in self.scheduler.reserve_decode():
            self.metrics.preemptions.inc()
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
            slots = [(r, r.slot) for r in batch]
            groups = self._sample_groups(slots, self.max_batch_size)
            try:
                logits, new_pools = self.runner.decode(
                    *self._decode_operands(batch), self.pool.pools)
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
        self.pool.pools = new_pools
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
            tok = self._resolve_token(req, am[sl], fin[sl],
                                      lambda s=sl: _rows()[s],
                                      sampled.get(sl))
            if tok is None:
                self._finish_abnormal(req, "error")
                continue
            events.append(self._append_token(req, tok))
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
            ctx = self._horizon_ctx(batch, s)
            try:
                packed, new_pools = self.runner.decode_multi(
                    *self._decode_operands(batch), self.pool.pools, s,
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
        self.pool.pools = new_pools
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
            return self._decode_multi_with_recovery(inf.s)
        self.metrics.host_syncs.inc()
        if inf.kind == "decode":
            return self._finish_decode(inf.batch, inf.logits,
                                       self._split_grid(drained, inf.groups))
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
        """Drain the engine; returns every finished RequestOutput.
        has_work() counts an in-flight launch, so the last iteration
        commits the pipeline's tail."""
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
    token-for-token for every request. ``fallback_seed`` is the seed of a
    sampled request without one (the engine uses its arrival index)."""
    sampling = sampling or SamplingParams()
    max_model_len = max_model_len or runner.max_model_len
    max_pages = -(-max_model_len // runner.block_size)
    pool = KVCachePool(runner.num_layers, max_pages + 1, runner.block_size,
                       runner.n_kv_heads, runner.head_dim, runner.dtype,
                       device=runner.device, kv_dtype=runner.kv_dtype)
    pages = pool.allocator.alloc(max_pages)
    table = pool.pad_table(pages, max_pages)
    tokens = list(map(int, prompt_tokens))
    logits, pools = runner.prefill(tokens, table, pool.pools)
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
                  attn_impl: str = "auto", device="cuda", mesh=None,
                  kv_dtype: str = "fp32", weight_dtype: str = "fp32",
                  **engine_kw) -> ServingEngine:
    """Build a ServingEngine for a supported model (Llama or GPT) on
    ``device`` (default "cuda"; pass "cpu" for the plain versions)."""
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
