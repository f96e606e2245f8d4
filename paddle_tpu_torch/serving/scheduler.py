"""Continuous-batching scheduler: FCFS admission, chunked prefill plans,
decode reservation, youngest-first preemption.

Counterpart of paddle_tpu/serving/scheduler.py. Admission maps the
longest cached prefix (the pool's `PrefixCache`) into a new request's
table; with the pool's host tier on, the match extends into the host's
demoted pages and a preempted request's `OffloadRecord`, whose pages the
engine pages in before the step's compute (`pending_pagein`). A
preemption spills the victim's exclusively owned pages to the tier
first. `plan_decode_horizon` pre-commits the pages of a
device-resident decode horizon; `speculation_budget`,
`reserve_speculation` and `plan_spec_horizon` fund speculative verify
spans, never by preempting. Determinism contract (the equivalence test
with naive_generate leans on every clause):
  * admission is strict FCFS with head-of-line blocking;
  * pages come from a sorted free list, so the same trace of events
    always yields the same block tables;
  * preemption victims are chosen youngest-first (last admitted), and a
    preempted request resumes with its full context (prompt + generated
    so far) re-prefilled: recompute (with the prefix cache on, its
    registered pages come back as cache hits), or, with the host tier,
    by page-in of its spilled pages, which leaves its tokens unchanged.

`max_prefill_tokens_per_step` bounds the prefill tokens computed per
engine step, and `prefill_plan()` slices the running requests'
outstanding context into chunks under that budget, oldest first.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.serving.kv_cache import (
    KVCachePool, OffloadRecord, SequenceKV,
)


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
    # multi-turn session id: the serving tier (`ServingRouter`) routes a
    # repeat turn back to the replica that served the session; one engine
    # ignores it
    session_id: Optional[str] = None
    # per-request KV precision: None = the pool's own rung; otherwise the
    # engine's rung, or "fp32" / "fp8" on a kv_dtype="mixed" engine, whose
    # "fp8" tenants get fp8-rounded pages (the engine checks at intake)
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


def ensure_arrival_counter_above(n: int) -> None:
    """Advance the global arrival counter past ``n``. A restored request
    keeps its arrival_index (it seeds seedless sampling and names auto
    request ids), so requests added after a restore must start beyond
    every restored index."""
    global _req_counter
    current = next(_req_counter)
    _req_counter = itertools.count(max(current + 1, n + 1))


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
    # host-tier state: while WAITING with phase "offloaded", `offload`
    # names the host slots of this request's spilled KV; admission turns
    # it into (device page, host slot) pairs the engine's fence restores
    # before the step's compute, and stamps the admit_* token splits
    offload: Optional[OffloadRecord] = None
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
        # free host-tier slots count as near-headroom above the watermark:
        # a growth overflow then spills and pages back in
        self.count_host_headroom = bool(count_host_headroom)
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
        """The admission high watermark in pages. With the host tier on
        and `count_host_headroom` set, free host slots count as headroom
        (capped at the pool size)."""
        wm = self._watermark_pages
        tier = self.pool.host_tier
        if tier is not None and self.count_host_headroom:
            wm = min(self.pool.allocator.num_usable, wm + tier.free_count)
        return wm

    def admit(self) -> List[Request]:
        """Admit queue-head requests while a slot and enough pages exist
        for their full context PLUS one decode token. Strict FCFS: stop at
        the first request that does not fit.

        With the pool's PrefixCache enabled, the longest cached
        page-aligned prefix of the request's context is mapped (shared,
        increfed) into its table before the rest is allocated: those
        tokens are live KV already, so prefill starts after them, and
        the pool funds only the unmatched tail. Cached-free pages count as
        headroom, not pressure.

        With the host tier on, the match extends into the host: demoted
        prefix pages and the request's own OffloadRecord map onto fresh
        device pages whose contents the engine pages in before this
        step's compute (`pending_pagein`). The record must connect to the
        matched prefix (its start_page covered by the device and host
        matches); a hole falls back to the recompute path."""
        admitted: List[Request] = []
        alloc = self.pool.allocator
        cache = self.pool.prefix_cache
        tier = self.pool.host_tier
        bs = self.pool.block_size
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            need = self.pool.blocks_for_tokens(req.num_context + 1)
            if need > self.max_pages_per_seq:
                raise ValueError(
                    f"request {req.request_id} needs {need} pages > "
                    f"max_pages_per_seq={self.max_pages_per_seq}")
            tag = req.sampling.kv_dtype or self.pool.native_kv_tag()
            if cache is not None:
                matched, host_matched = cache.match_tiered(
                    req.context_tokens, tag=tag)
            else:
                matched, host_matched = [], []
            if matched:
                # pin the match BEFORE any allocation: an incref lifts the
                # pages above refcount 1, so the eviction alloc may run
                # cannot reclaim them mid-admission
                cache.acquire(matched)
            need_new = need - len(matched)
            used_live = (alloc.num_usable - alloc.num_free
                         - alloc.num_evictable)
            # over the high watermark: stop admitting, unless nothing is
            # running at all (a request larger than the watermark must
            # still be servable alone)
            over_watermark = (used_live + need_new
                              > self._effective_watermark()
                              and (self.running or admitted))
            if not alloc.can_alloc(need_new) or over_watermark:
                if matched:
                    cache.unacquire(matched)
                break
            self.waiting.popleft()
            req.kv = SequenceKV(self.pool, kv_tag=tag)
            if matched:
                req.kv.adopt_prefix(matched, bs)
            # host-demoted prefix pages: a fresh device page each, restored
            # by the engine's fence, re-entering the device index. Over a
            # host-wide store a promotion may miss (a sibling's recomputed
            # registration dropped the entry since the match): the chain
            # ends there and the rest recomputes
            promoted = 0
            for h in host_matched:
                slot = tier.promote(h)
                if slot is None:
                    break
                page = alloc.alloc(1)[0]
                self.pool.tag_pages([page], tag)
                cache.register_page(page, h)
                req.kv.pages.append(page)
                req.kv.hash_chain.append(h)
                req.kv.registered_pages += 1
                req.kv.num_tokens = len(req.kv.pages) * bs
                req.pending_pagein.append((page, slot))
                promoted += 1
            req.admit_prefix_tokens = req.kv.num_tokens
            req.admit_pagein_tokens = 0
            m_total = len(matched) + promoted
            off, req.offload = req.offload, None
            if off is not None and tier is not None:
                if (m_total >= off.start_page
                        and off.covered_tokens > req.kv.num_tokens):
                    for j, slot in enumerate(off.slots):
                        if off.start_page + j < m_total:
                            # the prefix match covers this page already
                            # (same tokens, same KV): the copy is redundant
                            tier.free_slots([slot])
                            continue
                        page = alloc.alloc(1)[0]
                        self.pool.tag_pages([page], tag)
                        req.kv.pages.append(page)
                        req.pending_pagein.append((page, slot))
                    req.admit_pagein_tokens = (off.covered_tokens
                                               - req.kv.num_tokens)
                    req.kv.num_tokens = off.covered_tokens
                    tier.note_resume()
                else:
                    # a hole in the restorable prefix (or the match covers
                    # everything): release the copies and re-prefill
                    tier.free_slots(off.slots)
                    if m_total < off.start_page:
                        tier.note_fallback()
            req.kv.grow(req.num_context + 1 - req.kv.num_tokens)
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

    # ------------------------------------------------------- speculation

    def speculation_budget(self, chunk_tokens: int) -> Optional[int]:
        """Per-step budget left for speculative (draft) tokens after this
        step's prefill chunks: verify spans count against
        `max_prefill_tokens_per_step` as chunk tokens do. Only the EXTRA
        tokens are budgeted; the one-token decode feed always runs.
        None = unbounded."""
        if self.max_prefill_tokens_per_step is None:
            return None
        return max(0, self.max_prefill_tokens_per_step - chunk_tokens)

    def reserve_speculation(self, proposals: Dict[Request, List[int]]
                            ) -> int:
        """Best-effort page reservation for this step's verify spans, in
        admission order: each proposal is trimmed (in place) until the
        pages its 1 + k span writes can be funded WITHOUT preempting;
        under pool pressure speculation degrades to a plain decode.
        Runs after reserve_decode(). Returns the reserved draft tokens."""
        total = 0
        for req in self.running:
            prop = proposals.get(req)
            if req.phase != "decode" or not prop:
                continue
            k = len(prop)
            while k:
                short = req.kv.pages_short(1 + k)
                if short == 0 or self.pool.allocator.can_alloc(short):
                    break
                k -= 1
            del prop[k:]
            if k:
                req.kv.grow(1 + k)
                total += k
        return total

    def plan_spec_horizon(self, s: int, row_k: Dict[Request, int],
                          row_rem: Dict[Request, int]) -> int:
        """Page funding for a fused speculative horizon of ``s`` steps: a
        row writes up to min(s * (k+1), remaining + k) tokens past its
        coverage (full acceptance moves k + 1 tokens a step; the stop
        plane bounds kept tokens by `remaining`, and one span's k drafts
        may overhang), clamped at the table width. Never preempts: ``s``
        is trimmed toward 1 under free-list or watermark pressure, then
        each row's k shrinks in place. ``row_k`` is updated to the funded
        draft lengths. Returns the horizon (0 with no decode-ready
        request)."""
        batch = self.decode_ready()
        if not batch:
            return 0
        s = max(1, int(s))
        alloc = self.pool.allocator
        cap = self.max_pages_per_seq * self.pool.block_size

        def up(r, n, k=None):
            k = row_k.get(r, 0) if k is None else k
            return max(1, min(n * (k + 1), row_rem.get(r, 1) + k,
                              cap - r.kv.num_tokens))

        while s > 1:
            short = sum(r.kv.pages_short(up(r, s)) for r in batch)
            if short == 0:
                break
            used_live = (alloc.num_usable - alloc.num_free
                         - alloc.num_evictable)
            if (alloc.can_alloc(short)
                    and used_live + short <= self._effective_watermark()):
                break
            s -= 1
        if s == 1:
            # shrink and grow row by row: each grow lands before the next
            # row's can_alloc check
            for r in batch:
                k = row_k.get(r, 0)
                while k:
                    short = r.kv.pages_short(up(r, 1, k))
                    if short == 0 or alloc.can_alloc(short):
                        break
                    k -= 1
                row_k[r] = k
                r.kv.grow(up(r, 1, k))
            return 1
        for r in batch:
            r.kv.grow(up(r, s))
        return s

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
            used_live = (alloc.num_usable - alloc.num_free
                         - alloc.num_evictable)
            if (alloc.can_alloc(short)
                    and used_live + short <= self._effective_watermark()):
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
        tier = self.pool.host_tier
        if tier is not None and req.kv is not None:
            # spill the victim's exclusively owned pages BEFORE release()
            # frees them: resume then restores them by copy. Coverage stops
            # at context - 1, so the resumed request has a token to compute
            covered = min(req.kv.num_tokens, req.num_context - 1)
            req.offload = tier.spill_sequence(req.kv, covered)
        req.kv.release()
        req.kv = None
        self._release_slot(req)
        self.running.remove(req)
        req.state = RequestState.WAITING
        if req.offload is not None:
            req.phase = "offloaded"
        req.num_preemptions += 1

    def _drop_offload(self, req: Request) -> None:
        """Release a request's host-tier state (abort, timeout or shed of
        an offloaded waiter): the slots return to the tier, the request
        reverts to a recompute-on-resume waiter."""
        if req.offload is not None:
            tier = self.pool.host_tier
            if tier is not None:
                tier.free_slots(req.offload.slots)
            req.offload = None
            if req.phase == "offloaded":
                req.phase = "prefill"

    # ---------------------------------------------------------- finish

    def remove_waiting(self, req: Request) -> None:
        """Drop a queued (never-admitted or preempted) request — the
        deadline/abort/shed path. It holds no device pages or slot; its
        host-tier slots (an offloaded waiter's) are released here."""
        self.waiting.remove(req)      # identity match (Request is eq=False)
        self._drop_offload(req)

    def release_running(self, req: Request) -> None:
        """Release a RUNNING request's device pages and slot WITHOUT
        finishing it: the handoff-staging path. The caller has spilled the
        pages to the host tier; the request leaves the running set in
        state WAITING but does not rejoin the queue (the engine's handoff
        buffer owns it until the router extracts it)."""
        req.kv.release()
        req.kv = None
        self._release_slot(req)
        self.running.remove(req)
        req.state = RequestState.WAITING

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
