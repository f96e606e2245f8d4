"""Continuous-batching scheduler: FCFS admission, chunked prefill plans,
decode reservation, youngest-first preemption.

Counterpart of paddle_tpu/serving/scheduler.py without the prefix cache,
the host tier and speculation. `plan_decode_horizon` pre-commits the
pages of a device-resident decode horizon. Determinism contract (the
equivalence test with naive_generate leans on every clause):
  * admission is strict FCFS with head-of-line blocking;
  * pages come from a sorted free list, so the same trace of events
    always yields the same block tables;
  * preemption victims are chosen youngest-first (last admitted), and a
    preempted request resumes with its full context (prompt + generated
    so far) re-prefilled: recompute, not cache migration.

`max_prefill_tokens_per_step` bounds the prefill tokens computed per
engine step, and `prefill_plan()` slices the running requests'
outstanding context into chunks under that budget, oldest first.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Deque, List, Optional, Sequence, Tuple

from paddle_tpu_torch.serving.kv_cache import KVCachePool, SequenceKV


@dataclass
class SamplingParams:
    """Per-request sampling controls; greedy by default. temperature > 0
    draws from fold_in(key(seed), generated-token index) through top_k /
    top_p (engine.sample_token); without a seed the engine uses the
    request's arrival index."""

    max_tokens: int = 16
    temperature: float = 0.0          # 0.0 = greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: Optional[int] = None
    stop_token_ids: Tuple[int, ...] = ()
    timeout_s: Optional[float] = None   # deadline from arrival; None = never
    # session affinity across the replicas of a tier; the engine refuses
    # any value but None (the tier is ROADMAP.md 'Still to port' item 11)
    session_id: Optional[str] = None
    # per-request KV precision: None = the pool's own rung; otherwise it
    # must name the engine's kv_dtype (the engine checks at intake; the
    # "mixed" pool that serves several is ROADMAP.md item 8)
    kv_dtype: Optional[str] = None

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError("timeout_s must be positive (None = no deadline)")
        if self.kv_dtype not in (None, "fp32", "fp8", "int8"):
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r}; expected None, 'fp32', "
                "'fp8', or 'int8'")


class RequestState(Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


_req_counter = itertools.count()

# Request fields of the JAX host tier (item 9) and prefix cache (item 5),
# each taken at its default (None, [] or 0) only
UNPORTED_REQUEST_FIELDS = {"offload": 9, "pending_pagein": 9,
                           "admit_prefix_tokens": 5,
                           "admit_pagein_tokens": 9}


@dataclass(eq=False)          # identity semantics: the scheduler tracks
class Request:                # requests by object, never by field value
    """One in-flight generation request."""

    prompt_tokens: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    request_id: str = ""
    arrival_index: int = field(default_factory=lambda: next(_req_counter))
    state: RequestState = RequestState.WAITING
    output_tokens: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None
    kv: Optional[SequenceKV] = None
    slot: Optional[int] = None
    # "prefill" until the chunk that completes the context samples its
    # token, then "decode"; reset at every (re-)admission
    phase: str = "prefill"
    # set when a decode horizon hit non-finite logits it could not rescue
    # without the row (nan_policy="greedy"): the next engine step takes
    # the per-step path once, which fetches the real logits
    defer_horizon: bool = False
    # the JAX host-tier and prefix-cache state, in the JAX order: the port
    # takes them at their defaults only (`__post_init__`)
    offload: Optional[object] = None
    pending_pagein: List[Tuple[int, int]] = field(default_factory=list)
    admit_prefix_tokens: int = 0
    admit_pagein_tokens: int = 0
    admission_index: int = -1              # set fresh at every admission
    num_preemptions: int = 0
    arrival_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    def __post_init__(self):
        if not self.prompt_tokens:
            raise ValueError("empty prompt")
        for name, item in UNPORTED_REQUEST_FIELDS.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"Request({name}={getattr(self, name)!r}): the port "
                    f"takes it at its default only; ROADMAP.md 'Still to "
                    f"port' item {item}")
        if not self.request_id:
            self.request_id = f"req-{self.arrival_index}"

    @property
    def context_tokens(self) -> List[int]:
        """Prompt plus everything generated — what a (re-)prefill runs."""
        return self.prompt_tokens + self.output_tokens

    @property
    def num_context(self) -> int:
        return len(self.prompt_tokens) + len(self.output_tokens)

    @property
    def done(self) -> bool:
        return self.state is RequestState.FINISHED


class FCFSScheduler:
    """Admission queue + running set over one KVCachePool."""

    def __init__(self, pool: KVCachePool, max_batch_size: int,
                 max_pages_per_seq: int, admission_watermark: float = 1.0,
                 max_prefill_tokens_per_step: Optional[int] = None,
                 count_host_headroom: bool = False):
        if count_host_headroom:
            raise NotImplementedError(
                "FCFSScheduler(count_host_headroom=True): the host KV tier "
                "whose free slots it counts is not ported yet: ROADMAP.md "
                "'Still to port' item 9 (host KV tier)")
        if max_pages_per_seq > pool.allocator.num_usable:
            raise ValueError(
                f"max_pages_per_seq={max_pages_per_seq} exceeds the pool's "
                f"{pool.allocator.num_usable} usable pages — one sequence "
                "could never fit; enlarge num_blocks")
        if not 0.0 < admission_watermark <= 1.0:
            raise ValueError("admission_watermark must be in (0, 1]")
        if (max_prefill_tokens_per_step is not None
                and max_prefill_tokens_per_step < 1):
            raise ValueError("max_prefill_tokens_per_step must be >= 1 "
                             "(None = whole context in one chunk)")
        self.max_prefill_tokens_per_step = max_prefill_tokens_per_step
        self.pool = pool
        self.max_batch_size = max_batch_size
        self.max_pages_per_seq = max_pages_per_seq
        self.admission_watermark = admission_watermark
        # pool high watermark: admission stops once allocation would cross
        # this many pages, leaving headroom for running sequences to GROW
        self._watermark_pages = int(admission_watermark
                                    * pool.allocator.num_usable)
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []     # kept in admission order
        self._admission_counter = itertools.count()
        self._free_slots = list(range(max_batch_size))  # ascending

    # ------------------------------------------------------------- queue

    def add(self, req: Request) -> None:
        req.state = RequestState.WAITING
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    # --------------------------------------------------------- admission

    def _effective_watermark(self) -> int:
        """The admission high watermark in pages (the port has no host
        tier whose free slots the JAX package may count as headroom)."""
        return self._watermark_pages

    def admit(self) -> List[Request]:
        """Admit queue-head requests while a slot and enough pages exist
        for their full context PLUS one decode token. Strict FCFS: stop at
        the first request that does not fit."""
        admitted: List[Request] = []
        alloc = self.pool.allocator
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            need = self.pool.blocks_for_tokens(req.num_context + 1)
            if need > self.max_pages_per_seq:
                raise ValueError(
                    f"request {req.request_id} needs {need} pages > "
                    f"max_pages_per_seq={self.max_pages_per_seq}")
            used = alloc.num_usable - alloc.num_free
            # over the high watermark: stop admitting — unless nothing is
            # running at all (a request larger than the watermark must
            # still be servable alone)
            over_watermark = (used + need > self._effective_watermark()
                              and (self.running or admitted))
            if not alloc.can_alloc(need) or over_watermark:
                break
            self.waiting.popleft()
            req.kv = SequenceKV(self.pool)
            req.kv.grow(req.num_context + 1)
            req.slot = self._free_slots.pop(0)
            req.admission_index = next(self._admission_counter)
            req.state = RequestState.RUNNING
            req.phase = "prefill"
            self.running.append(req)
            admitted.append(req)
        return admitted

    # ---------------------------------------------------- chunked prefill

    def prefill_plan(self) -> List[Tuple[Request, int, int]]:
        """Slice the running requests' outstanding context into prefill
        chunks for THIS step, oldest-first, spending at most
        `max_prefill_tokens_per_step` tokens total (None = one chunk per
        request). Returns (request, start, end) token ranges;
        `end == request.num_context` marks the completing chunk whose
        logits the engine samples from."""
        budget = self.max_prefill_tokens_per_step
        plan: List[Tuple[Request, int, int]] = []
        for req in self.running:               # admission order = oldest
            if req.phase != "prefill":
                continue
            take = req.num_context - req.kv.num_tokens
            if budget is not None:
                take = min(take, budget)
            plan.append((req, req.kv.num_tokens, req.kv.num_tokens + take))
            if budget is not None:
                budget -= take
                if budget <= 0:
                    break
        return plan

    def decode_ready(self) -> List[Request]:
        """Decode-phase running requests in admission order — the spans
        the batched decode step feeds."""
        return [r for r in self.running if r.phase == "decode"]

    # ------------------------------------------------- multi-step decode

    def plan_decode_horizon(self, s: int, row_caps=None) -> int:
        """Pre-commit pages for up to ``s`` future decode tokens per
        decode-ready request: a horizon writes K/V against block tables
        fixed at launch, so every page must exist before the call. Trims
        ``s``, never preempting, while the free list or the admission
        watermark cannot fund the extra pages; assumes reserve_decode()
        funded step one. Grows every decode-ready sequence to the returned
        horizon and returns it (0 with no decode-ready request).

        ``row_caps`` ({request: max upcoming tokens}, on-device early
        stop): a row that freezes after its budget funds pages for only
        min(s, cap) tokens."""
        batch = self.decode_ready()
        if not batch:
            return 0
        s = max(1, int(s))
        alloc = self.pool.allocator

        def up(r, n):
            return min(n, row_caps[r]) if row_caps else n

        while s > 1:
            short = sum(r.kv.pages_short(up(r, s)) for r in batch)
            if short == 0:
                break
            used = alloc.num_usable - alloc.num_free
            if (alloc.can_alloc(short)
                    and used + short <= self._effective_watermark()):
                break
            s -= 1
        if s > 1:
            for r in batch:
                r.kv.grow(up(r, s))
        return s

    # -------------------------------------------------------- preemption

    def reserve_decode(self) -> List[Request]:
        """Reserve the KV page each running sequence's next token will
        write, preempting youngest-first when the pool runs dry. Returns
        the victims (already recycled to the queue front). Called before
        every decode step."""
        victims: List[Request] = []
        for req in list(self.running):      # admission order = oldest first
            if req not in self.running:     # already preempted this pass
                continue
            while True:
                short = req.kv.pages_short(1)
                if short == 0 or self.pool.allocator.can_alloc(short):
                    req.kv.grow(1)
                    break
                victim = self.running[-1]   # youngest
                if victim is req and len(self.running) == 1:
                    raise MemoryError(
                        f"request {req.request_id} cannot grow even with "
                        "the pool to itself — num_blocks too small for "
                        "max_model_len")
                self._preempt(victim)
                victims.append(victim)
                if victim is req:
                    break
        # queue-front recycle in arrival order: oldest victim resumes first
        for v in sorted(victims, key=lambda r: r.arrival_index, reverse=True):
            self.waiting.appendleft(v)
        return victims

    def _preempt(self, req: Request) -> None:
        req.kv.release()
        req.kv = None
        self._release_slot(req)
        self.running.remove(req)
        req.state = RequestState.WAITING
        req.num_preemptions += 1

    # ---------------------------------------------------------- finish

    def remove_waiting(self, req: Request) -> None:
        """Drop a queued (never-admitted or preempted) request — the
        deadline/abort/shed path. It holds no pages or slot."""
        self.waiting.remove(req)      # identity match (Request is eq=False)

    def finish(self, req: Request, reason: str) -> None:
        req.kv.release()
        req.kv = None
        self._release_slot(req)
        self.running.remove(req)
        req.state = RequestState.FINISHED
        req.finish_reason = reason

    def _release_slot(self, req: Request) -> None:
        self._free_slots.append(req.slot)
        self._free_slots.sort()            # lowest slot reused first
        req.slot = None

    def running_in_order(self) -> Sequence[Request]:
        return tuple(self.running)
