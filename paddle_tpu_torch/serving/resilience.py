"""Failure vocabulary, the fault injector and the invariant auditor of
the serving engine.

Counterpart of paddle_tpu/serving/resilience.py, limited to the state
this port has: one pool (fp32, 16-bit, int8, fp8 or mixed) with its
prefix cache and its private host tier, at most one in-flight launch (the
pipelined loop).

  FaultInjector      a drop-in runner wrapper that raises simulated
                     device errors, corrupts logits with NaN, stalls, or
                     crashes the whole replica on chosen calls of its six
                     ops (prefill, prefill_chunk, decode, decode_multi,
                     decode_multi_spec, ragged_step)
  audit_engine       page accounting, refcounts, the prefix-cache index,
                     the host tier (the handoff buffer's slots included),
                     slots and block tables must agree after every step
  WireFaultInjector  deterministic wire faults of the process tier
                     (drop, corrupt, truncate, delay, reset) on an
                     EngineClient's RPCs
  audit_router       every live replica passes audit_engine (inside the
                     replica process on the process backend), and the
                     router's at-most-once registry is consistent

Fault schedules are keyed by call index (never wall time or RNG), so a
failing trace replays exactly. A crash is raised before the wrapped call
reaches the runner, so it never leaves a stream capturing or a copy
half issued. `audit_store` (and `store_audit_problems`) checks the
host-wide page store: its slot partition, refcounts and index, the live
owners, and a rotating CRC spot check of its bytes.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Optional

import torch

from paddle_tpu_torch.serving.kv_cache import SCRATCH_PAGE
from paddle_tpu_torch.serving.model_runner import SCALE_SUFFIX

logger = logging.getLogger(__name__)


class InjectedDeviceError(RuntimeError):
    """A simulated transient device failure (FaultInjector's default)."""


class QueueFullError(RuntimeError):
    """add_request rejected: bounded queue full under shed_policy='reject'."""


class InvariantViolation(AssertionError):
    """Engine state is internally inconsistent (leak / double-own / slot
    corruption). Raised by audit_engine; always a bug, never load."""


class ReplicaCrashError(BaseException):
    """A simulated whole-replica failure. A BaseException on purpose: the
    engine's transient-fault recovery catches Exception, so a crash is
    never absorbed by step retries or quarantine; it escapes
    engine.step() and ends the replica's worker thread, the contract of a
    real replica death. The router's Supervisor owns it: it fences the
    replica, restores it from its last snapshot and resubmits what the
    snapshot missed."""


class ReplicaGoneError(ReplicaCrashError):
    """A replica PROCESS is unreachable: its command socket hit EOF, a
    reset or a deadline, or waitpid reported an exit. A ReplicaCrashError
    on purpose: the process backend's dead replica rides the same
    contract as a crashed thread, so the router worker fences it and the
    Supervisor spawns a fresh process."""


class FaultInjector:
    """Wrap a PagedModelRunner and inject faults on selected calls.

    Drop-in: the runner's attributes (block_size, num_layers, dtype, ...)
    delegate through, so ``ServingEngine(FaultInjector(runner, ...),
    ...)`` behaves exactly like the bare runner except on the scheduled
    calls; a sharded runner's ``mesh``, ``model_axis`` and ``tp_size``
    too, so the engine builds kv-head-sharded pools, and an injected error
    hits the sharded launch before any shard's device work. Call indices
    are 1-based and counted PER OP ("prefill": prefill and prefill_chunk;
    "decode": decode, decode_multi, decode_multi_spec and ragged_step,
    each the step's decode call site), so ``error_every=5`` fails decode
    calls 5, 10, 15, ...

    Fault classes (each with ``*_every`` periodic and ``*_calls`` exact
    schedules, and a target op "prefill" | "decode" | "both"):

      error  raise InjectedDeviceError BEFORE the real runner runs (the
             pools are untouched, so a retry is exact);
      nan    run the real step, then set the leading ``nan_fraction`` of
             the vocab to NaN (logits), or zero the finite plane of a
             horizon's packed buffer (decode_multi, decode_multi_spec);
      stall  call ``on_stall`` (default: time.sleep(stall_s)) first;
      crash  raise ReplicaCrashError BEFORE the real runner runs: the
             engine cannot absorb it, so the call kills the replica
             (the Supervisor's drill)."""

    def __init__(self, runner, *,
                 error_every: int = 0, error_calls: Iterable[int] = (),
                 error_target: str = "decode",
                 nan_every: int = 0, nan_calls: Iterable[int] = (),
                 nan_target: str = "decode", nan_fraction: float = 1.0,
                 stall_every: int = 0, stall_calls: Iterable[int] = (),
                 stall_target: str = "decode", stall_s: float = 0.0,
                 on_stall: Optional[Callable[[], None]] = None,
                 crash_every: int = 0, crash_calls: Iterable[int] = (),
                 crash_target: str = "decode"):
        self._runner = runner
        for t in (error_target, nan_target, stall_target, crash_target):
            if t not in ("prefill", "decode", "both"):
                raise ValueError(f"fault target {t!r}")
        if not 0.0 < nan_fraction <= 1.0:
            raise ValueError("nan_fraction must be in (0, 1]")
        self._error = (error_every, frozenset(error_calls), error_target)
        self._nan = (nan_every, frozenset(nan_calls), nan_target)
        self._stall = (stall_every, frozenset(stall_calls), stall_target)
        self._crash = (crash_every, frozenset(crash_calls), crash_target)
        self.nan_fraction = nan_fraction
        self._on_stall = on_stall or (lambda: time.sleep(stall_s))
        self.calls = {"prefill": 0, "decode": 0}
        self.injected = {"error": 0, "nan": 0, "stall": 0, "crash": 0}

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_runner"), name)

    @staticmethod
    def _hits(schedule, op: str, n: int) -> bool:
        every, calls, target = schedule
        if target not in (op, "both"):
            return False
        return (every > 0 and n % every == 0) or n in calls

    def _corrupt(self, logits):
        out = torch.as_tensor(logits).clone()
        k = max(1, int(round(out.shape[-1] * self.nan_fraction)))
        out[..., :k] = float("nan")
        return out

    def _pre(self, op: str) -> int:
        self.calls[op] += 1
        n = self.calls[op]
        if self._hits(self._stall, op, n):
            self.injected["stall"] += 1
            self._on_stall()
        if self._hits(self._crash, op, n):
            self.injected["crash"] += 1
            raise ReplicaCrashError(f"injected replica crash: {op} call {n}")
        if self._hits(self._error, op, n):
            self.injected["error"] += 1
            raise InjectedDeviceError(f"injected device error: {op} call {n}")
        return n

    def _post(self, op: str, n: int, out, packed: bool = False):
        if not self._hits(self._nan, op, n):
            return out
        self.injected["nan"] += 1
        if not packed:
            return self._corrupt(out)
        out = out.clone()
        out[1] = 0                  # the finite plane of every layout
        return out

    def prefill(self, tokens, table, pools):
        n = self._pre("prefill")
        logits, pools = self._runner.prefill(tokens, table, pools)
        return self._post("prefill", n, logits), pools

    def prefill_chunk(self, tokens, start_pos, table, pools):
        # chunks share the "prefill" counter: a chunked engine sees the
        # same per-prefill-call schedule as a monolithic one
        n = self._pre("prefill")
        logits, pools = self._runner.prefill_chunk(tokens, start_pos, table,
                                                   pools)
        return self._post("prefill", n, logits), pools

    def decode(self, tokens, tables, pos, pools):
        n = self._pre("decode")
        logits, pools = self._runner.decode(tokens, tables, pos, pools)
        return self._post("decode", n, logits), pools

    def decode_multi(self, tokens, tables, pos, pools, num_steps, **kw):
        # NaN cannot reach the logits inside the device loop: it zeroes
        # the packed finite plane, so the horizon "goes NaN" at step one
        n = self._pre("decode")
        packed, pools = self._runner.decode_multi(tokens, tables, pos,
                                                  pools, num_steps, **kw)
        return self._post("decode", n, packed, packed=True), pools

    def decode_multi_spec(self, tokens, tables, pos, pools, drafts, **kw):
        n = self._pre("decode")
        packed, pools = self._runner.decode_multi_spec(
            tokens, tables, pos, pools, drafts, **kw)
        return self._post("decode", n, packed, packed=True), pools

    def ragged_step(self, tokens, tables, start_pos, q_lens, pools,
                    full_logits: bool = False):
        # the fused chunk + decode call and the speculative verify call
        # are the step's decode call site: the "decode" counter
        n = self._pre("decode")
        logits, pools = self._runner.ragged_step(
            tokens, tables, start_pos, q_lens, pools,
            full_logits=full_logits)
        return self._post("decode", n, logits), pools


class WireFaultInjector:
    """Deterministic WIRE fault schedules of the process tier: attached to
    an `EngineClient` (`client.wire_faults = WireFaultInjector(...)`),
    consulted once per RPC attempt, and keyed by call index over the RPCs
    `target` matches, never wall time or RNG, so a failing trace replays
    exactly.

    Fault classes (each with ``*_every`` periodic and ``*_calls`` exact
    schedules; call indices are 1-based over target-matched RPCs):

      drop      the request's framed bytes never leave the host: the
                client's deadline trips cleanly (idempotent RPCs retry,
                mutating ones escalate to the supervisor);
      corrupt   one payload byte of the outbound request is flipped after
                framing: the replica's CRC check must reject it and NAK;
      truncate  only the first half of the framed bytes are sent: the
                replica blocks mid-frame, the client's deadline trips,
                and a retry desyncs into a loud connection error;
      delay     the request is sent, then the client sleeps `delay_s`
                before reading: a slow but alive replica whose reply lands
                after the deadline (seq-matched as stale by the retry);
      reset     the client's half of the connection is shut down under the
                RPC: always fatal, the supervisor respawns.

    `target` picks which RPCs the schedule counts: "all", "idempotent"
    (the retry-safe set), "mutating", or an exact command name or tuple of
    names (e.g. "step").
    """

    ACTIONS = ("reset", "truncate", "corrupt", "drop", "delay")

    def __init__(self, *, drop_every: int = 0,
                 drop_calls: Iterable[int] = (),
                 corrupt_every: int = 0,
                 corrupt_calls: Iterable[int] = (),
                 truncate_every: int = 0,
                 truncate_calls: Iterable[int] = (),
                 delay_every: int = 0, delay_calls: Iterable[int] = (),
                 delay_s: float = 0.5,
                 reset_every: int = 0, reset_calls: Iterable[int] = (),
                 target="all"):
        from paddle_tpu_torch.serving.wire import IDEMPOTENT_RPCS

        self._idempotent = IDEMPOTENT_RPCS
        if isinstance(target, str) and target not in ("all",
                                                      "idempotent",
                                                      "mutating"):
            target = (target,)
        self.target = target
        self.delay_s = float(delay_s)
        self._sched = {
            "drop": (drop_every, frozenset(drop_calls)),
            "corrupt": (corrupt_every, frozenset(corrupt_calls)),
            "truncate": (truncate_every, frozenset(truncate_calls)),
            "delay": (delay_every, frozenset(delay_calls)),
            "reset": (reset_every, frozenset(reset_calls)),
        }
        self.calls = 0
        self.injected = {a: 0 for a in self.ACTIONS}

    def _matches(self, cmd: str) -> bool:
        if self.target == "all":
            return True
        if self.target == "idempotent":
            return cmd in self._idempotent
        if self.target == "mutating":
            return cmd not in self._idempotent
        return cmd in self.target

    def action(self, cmd: str) -> Optional[str]:
        """The fault to inject on this RPC attempt, or None. Counts only
        target-matched attempts; the first scheduled class in ACTIONS
        order wins when several match one index."""
        if not self._matches(cmd):
            return None
        self.calls += 1
        n = self.calls
        for act in self.ACTIONS:
            every, calls = self._sched[act]
            if (every > 0 and n % every == 0) or n in calls:
                self.injected[act] += 1
                return act
        return None


def audit_engine(engine) -> None:
    """Assert that page accounting, slot assignment and block tables are
    mutually consistent — the opt-in post-step check
    (ServingEngine(..., audit=True) or PADDLE_TPU_SERVING_AUDIT=1).

    A page's refcount equals the number of sequences mapping it plus one
    if the prefix cache's index holds it, every allocated page has an
    owner or a cache entry (no leaks), the cache's index is a bijection
    that holds no free page, a page appears at most once in one table,
    each running sequence holds the pages its live tokens need and no
    more than its context plus one upcoming token needs, slots partition
    between running requests and the free list, and the pool's layer
    tuples have the layout of its kv_dtype (a mixed pool's tag planes
    equal across layers and the host tags), every page a running sequence
    maps carries its owner's kv-dtype tag and no free page carries one,
    the host tier's slots partition between its free list and one owner
    each (an offload record of a waiting request or the tier's prefix
    index), no chain hash is both device-live and host-resident, no
    page-in survives its step's fence, and a rotating sample of spilled
    slots still matches its content hash,
    and a quantized runner's weights keep the weight ladder's storage
    contract (int8 codes with fp32 [out] or [out, ceil(in / group)]
    scales, fp8 weights scale-free). A member of the pipelined
    loop's in-flight launch may also hold the pages its undrained horizon
    was funded (a fused speculative horizon records them per request).
    Raises InvariantViolation listing every broken invariant. Host work
    only."""
    alloc = engine.pool.allocator
    sched = engine.scheduler
    cache = engine.pool.prefix_cache
    problems = []
    inflight = getattr(engine, "_inflight", None)
    inflight_horizon = ({id(r): inflight.s for r, _ in inflight.batch}
                        if inflight is not None else {})
    inflight_upcoming = (dict(inflight.upcoming)
                         if inflight is not None and inflight.upcoming
                         else {})

    # -- allocator self-consistency
    free_list = list(alloc._free)
    fset, aset = set(free_list), set(alloc._ref)
    if len(free_list) != len(fset):
        problems.append("duplicate pages in the free list")
    if fset & aset:
        problems.append(f"pages both free and allocated: {sorted(fset & aset)}")
    if SCRATCH_PAGE in (fset | aset):
        problems.append("scratch page entered the allocator")
    expected = set(range(1, alloc.num_blocks))
    if (fset | aset) != expected:
        problems.append(
            f"page accounting broken: lost={sorted(expected - fset - aset)} "
            f"foreign={sorted((fset | aset) - expected)}")
    if any(rc < 1 for rc in alloc._ref.values()):
        problems.append("allocated page with refcount < 1")

    # -- ownership: allocated pages == running sequences' pages
    owner_counts: dict = {}
    for req in sched.running:
        if req.kv is None:
            problems.append(f"{req.request_id} RUNNING without kv state")
            continue
        rid, pages = req.request_id, req.kv.pages
        if SCRATCH_PAGE in pages:
            problems.append(f"{rid} block table maps the scratch page")
        if len(set(pages)) != len(pages):
            problems.append(f"{rid} maps the same page twice")
        if req.kv.num_tokens > req.num_context:
            problems.append(f"{rid} kv covers {req.kv.num_tokens} tokens > "
                            f"context {req.num_context}")
        if req.phase not in ("prefill", "decode"):
            problems.append(f"{rid} unknown phase {req.phase!r}")
        elif (req.phase == "decode"
                and req.kv.num_tokens < req.num_context - 1):
            problems.append(f"{rid} decode-phase but kv covers only "
                            f"{req.kv.num_tokens} of {req.num_context} "
                            "context tokens")
        need = engine.pool.blocks_for_tokens(max(1, req.kv.num_tokens))
        if len(pages) < need:
            problems.append(f"{rid} under-provisioned: {len(pages)} pages "
                            f"< {need} needed for {req.kv.num_tokens} tokens")
        if len(pages) > engine.max_pages_per_seq:
            problems.append(f"{rid} holds {len(pages)} pages > "
                            "max_pages_per_seq")
        upcoming = inflight_upcoming.get(
            id(req), 1 + inflight_horizon.get(id(req), 0))
        cap = engine.pool.blocks_for_tokens(req.num_context + upcoming)
        if len(pages) > cap:
            problems.append(f"{rid} holds {len(pages)} pages > {cap} needed "
                            f"for its context plus {upcoming} tokens "
                            "(speculative or horizon pages survived their "
                            "step)")
        for p in pages:
            owner_counts[p] = owner_counts.get(p, 0) + 1
    cached = set(cache.pages()) if cache is not None else set()
    oset = set(owner_counts)
    if cache is None and len(owner_counts) != sum(owner_counts.values()):
        dupes = sorted(p for p, c in owner_counts.items() if c > 1)
        problems.append(f"pages owned by two sequences: {dupes}")
    if oset | cached != aset:
        problems.append(
            f"page leak: allocated-but-unowned={sorted(aset - oset - cached)}"
            f" owned-but-not-allocated={sorted((oset | cached) - aset)}")
    for p in aset:
        want = owner_counts.get(p, 0) + (1 if p in cached else 0)
        if alloc._ref.get(p) != want:
            problems.append(
                f"page {p} refcount {alloc._ref.get(p)} != "
                f"{owner_counts.get(p, 0)} owners + {int(p in cached)} "
                "cache refs")

    # -- prefix-cache index consistency
    if cache is not None:
        if SCRATCH_PAGE in cached:
            problems.append("scratch page registered in the prefix cache")
        if cached & fset:
            problems.append(
                f"cached pages on the free list: {sorted(cached & fset)}")
        index_pages = list(cache._index.values())
        if len(index_pages) != len(set(index_pages)):
            problems.append("prefix-cache index maps two hashes to one page")
        if set(index_pages) != cached or any(
                cache._index.get(cache._page_hash.get(p)) != p
                for p in cached):
            problems.append("prefix-cache hash index and page index "
                            "disagree")

    # -- the host tier: slots free XOR used, one owner per used slot, the
    #    prefix index a bijection disjoint from the device index, and a
    #    rotating CRC spot check of spilled bytes (after joining every
    #    pending spill job: a slot's bytes and hash are defined only then)
    tier = getattr(engine.pool, "host_tier", None)
    if tier is not None and tier.store is not None:
        problems += _store_tier_problems(engine, tier, sched)
    elif tier is not None:
        problems += _tier_problems(engine, tier, sched, cache)

    # -- slot accounting
    slots = [r.slot for r in sched.running]
    if any(s is None for s in slots):
        problems.append("RUNNING request without a slot")
    elif len(set(slots)) != len(slots):
        problems.append(f"slot assigned twice: {sorted(slots)}")
    else:
        sset, free_slots = set(slots), list(sched._free_slots)
        if (len(free_slots) != len(set(free_slots))
                or (sset | set(free_slots)) != set(range(sched.max_batch_size))
                or sset & set(free_slots)):
            problems.append(f"slot accounting broken: used={sorted(sset)} "
                            f"free={sorted(free_slots)}")

    # -- pool layout: an int8 pool's layer tuples carry int8 code pools
    #    and ONE fp32 scale per page per kv head; an fp8 pool stores
    #    float8 pages and carries NO scale rows (fp8 casts are scale-free);
    #    a mixed pool the (k, v) pair in its logical dtype and a bool tag
    #    plane of one bit a page; an fp32 pool the plain (k, v) pair in its
    #    logical dtype (the runner's)
    pool = engine.pool
    want_len = {"int8": 4, "mixed": 3}.get(pool.kv_dtype, 2)
    want_dtype = {"int8": torch.int8,
                  "fp8": torch.float8_e4m3fn}.get(pool.kv_dtype, pool.dtype)
    tp = getattr(pool, "tp_size", 1)
    heads = pool.n_kv_heads // tp
    shards = pool.shards
    for sh, layers in enumerate(shards):
        where = f"shard {sh} " if tp > 1 else ""
        for li, layer in enumerate(layers):
            if len(layer) != want_len:
                problems.append(
                    f"{where}layer {li} pool tuple has {len(layer)} entries "
                    f"!= {want_len} for kv_dtype={pool.kv_dtype}")
                continue
            for nm, arr in zip("kv", layer[:2]):
                if arr.dtype != want_dtype:
                    problems.append(
                        f"{where}layer {li} {nm}-pool dtype {arr.dtype} != "
                        f"{want_dtype} on a {pool.kv_dtype} pool")
            if pool.kv_dtype == "mixed":
                tag = layer[2]
                if tag.dtype != torch.bool or tuple(tag.shape) != (
                        pool.num_blocks,):
                    problems.append(
                        f"{where}layer {li} tag plane {tuple(tag.shape)} "
                        f"{tag.dtype} != ({pool.num_blocks},) bool")
            if tp > 1:
                # -- sharded pools: every shard holds EVERY page's slice
                #    of n_kv / tp heads (the block tables are replicated,
                #    so a page id names the same page on every shard), its
                #    int8 scale pools split on the same head axis
                named = [("k", layer[0], (pool.num_blocks, pool.block_size,
                                          heads, pool.head_dim)),
                         ("v", layer[1], (pool.num_blocks, pool.block_size,
                                          heads, pool.head_dim))]
                if pool.kv_dtype == "int8":
                    named += [("k-scale", layer[2], (pool.num_blocks, heads)),
                              ("v-scale", layer[3], (pool.num_blocks, heads))]
                for nm, arr, want in named:
                    if tuple(arr.shape) != want:
                        problems.append(
                            f"{where}layer {li} {nm}-pool per-shard shape "
                            f"{tuple(arr.shape)} != {want}: every shard "
                            f"holds all {pool.num_blocks} pages sharded only "
                            "on the kv-head axis")
                for nm, arr in zip("kv", layer[2:]):
                    if pool.kv_dtype == "int8" and arr.dtype != torch.float32:
                        problems.append(
                            f"{where}layer {li} {nm}-scale pool dtype "
                            f"{arr.dtype} != float32: one fp32 scale per "
                            "page per kv head")
                continue
            if pool.kv_dtype == "mixed":
                continue
            for nm, arr in zip("kv", layer[2:]):
                if (tuple(arr.shape) != (pool.num_blocks, pool.n_kv_heads)
                        or arr.dtype != torch.float32):
                    problems.append(
                        f"layer {li} {nm}-scale pool {tuple(arr.shape)} "
                        f"{arr.dtype} != "
                        f"{(pool.num_blocks, pool.n_kv_heads)} float32: one "
                        "scale per page per kv head")

    # -- kv-dtype tags: every page a running sequence owns carries its
    #    owner's tag, only allocated pages carry one, never the scratch
    #    page; on a mixed pool the device tag planes agree with each
    #    other and with the host tags on every allocated page (one host
    #    read of the first plane)
    tags = dict(alloc._tags)
    if SCRATCH_PAGE in tags:
        problems.append("scratch page carries a kv-dtype tag")
    stray = sorted(set(tags) - aset)
    if stray:
        problems.append(f"kv-dtype tags on unallocated pages: {stray}")
    for req in sched.running:
        if req.kv is None:
            continue
        bad = [p for p in req.kv.pages if tags.get(p) != req.kv.kv_tag]
        if bad:
            problems.append(
                f"{req.request_id} (kv_tag={req.kv.kv_tag!r}) owns pages "
                f"with mismatched tags: "
                f"{[(p, tags.get(p)) for p in bad[:8]]}")
    layers = [layer for layers in shards for layer in layers]
    if pool.kv_dtype == "mixed" and layers and all(
            len(layer) == 3 for layer in layers):
        planes = [layer[2] for layer in layers]
        if any(not torch.equal(planes[0], pl) for pl in planes[1:]):
            problems.append("mixed-pool tag planes disagree across layers "
                            "or shards")
        plane = planes[0].cpu().tolist()
        for p in sorted(aset):
            if plane[p] != (tags.get(p) == "fp8"):
                problems.append(f"page {p} device tag bit {plane[p]} != "
                                f"host tag {tags.get(p)!r}")
                break
        if plane[SCRATCH_PAGE]:
            problems.append("scratch page tagged fp8 on the device plane")

    # -- the weight ladder's storage contract: int4 codes int8 with fp32
    #    scales [out, ceil(in / g)] (in = 2 x the packed rows), int8 codes
    #    with an fp32 [out] scale, fp8 weights float8 and scale-free
    problems += _weight_problems(engine.runner)

    # -- waiting requests hold no device resources
    for req in sched.waiting:
        if req.kv is not None or req.slot is not None:
            problems.append(f"{req.request_id} WAITING but holds kv/slot")

    if problems:
        raise InvariantViolation("; ".join(problems))


def _store_tier_problems(engine, tier, sched) -> list:
    """The broken invariants of a store-backed tier, from this engine's
    side (the JAX auditor's store branch): every slot an offload record or
    a staged handoff names carries at least as many of this engine's owner
    refs, and no page-in survives the step fence. The slot partition, the
    refcounts and the index are tier-wide: `store_audit_problems` checks
    them where the store lives (here on the thread backend, in the router
    on the process backend). The device-XOR-host check is gone on
    purpose: the shared index mirrors device-live hashes (a promotion
    keeps the store copy serving the siblings)."""
    problems = []
    tier.sync()
    store = tier.store
    need: dict = {}
    for req in sched.waiting:
        off = req.offload
        if off is not None:
            if req.phase != "offloaded":
                problems.append(f"{req.request_id} holds an offload record "
                                f"but phase={req.phase!r}")
            for s in off.slots:
                need[s] = need.get(s, 0) + 1
        elif req.phase == "offloaded":
            problems.append(f"{req.request_id} phase 'offloaded' without "
                            "an offload record")
    for rec in getattr(engine, "_handoffs", {}).values():
        if rec is not None:
            for s in rec.slots:
                need[s] = need.get(s, 0) + 1
    for req in sched.running:
        if req.offload is not None:
            problems.append(f"{req.request_id} RUNNING with an offload "
                            "record")
        if req.pending_pagein:
            problems.append(f"{req.request_id} pending page-ins survived "
                            "the step fence")
    for s, cnt in need.items():
        have = store.owner_count(s, tier.owner)
        if have < cnt:
            problems.append(
                f"store slot {s}: engine {tier.owner!r} references it "
                f"{cnt}x but holds only {have} store refs")
    if getattr(store, "_lock", None) is not None:
        problems += store_audit_problems(
            store, tick=int(engine.metrics.decode_steps.value))
    return problems


def _tier_problems(engine, tier, sched, cache) -> list:
    """The broken invariants of a private host tier (the JAX auditor's
    private-tier section)."""
    problems = []
    tier.sync()
    hfree, hused = list(tier._free), set(tier._hash)
    hfset = set(hfree)
    if len(hfree) != len(hfset):
        problems.append("duplicate slots in the host tier free list")
    if hfset & hused:
        problems.append(
            f"host slots both free and used: {sorted(hfset & hused)}")
    if (hfset | hused) != set(range(tier.max_pages)):
        problems.append(
            "host tier slot accounting broken: "
            f"lost={sorted(set(range(tier.max_pages)) - hfset - hused)}")
    slot_owner: dict = {}
    for req in sched.waiting:
        off = req.offload
        if off is not None:
            if req.phase != "offloaded":
                problems.append(f"{req.request_id} holds an offload record "
                                f"but phase={req.phase!r}")
            for s in off.slots:
                slot_owner[s] = slot_owner.get(s, 0) + 1
        elif req.phase == "offloaded":
            problems.append(f"{req.request_id} phase 'offloaded' without "
                            "an offload record")
    # the handoff buffer: a staged request's spilled pages are owned by its
    # record until extract_handoff ships (and frees) them, or an abort
    # releases them
    for rec in getattr(engine, "_handoffs", {}).values():
        if rec is None:
            continue
        for s in rec.slots:
            slot_owner[s] = slot_owner.get(s, 0) + 1
    for req in sched.running:
        if req.offload is not None:
            problems.append(f"{req.request_id} RUNNING with an offload "
                            "record")
        if req.pending_pagein:
            problems.append(f"{req.request_id} pending page-ins survived "
                            "the step fence")
    dupes = sorted(s for s, c in slot_owner.items() if c > 1)
    if dupes:
        problems.append(f"host slots owned by two requests: {dupes}")
    pslots = set(tier._prefix.values())
    if len(pslots) != len(tier._prefix):
        problems.append("host tier prefix index maps two hashes to one "
                        "slot")
    if {s: h for h, s in tier._prefix.items()} != tier._prefix_slot:
        problems.append("host tier prefix index and reverse map disagree")
    overlap = set(slot_owner) & pslots
    if overlap:
        problems.append("host slots owned by a request AND the prefix "
                        f"index: {sorted(overlap)}")
    orphans = hused - set(slot_owner) - pslots
    if orphans:
        problems.append(f"host slots used but unowned: {sorted(orphans)}")
    unbacked = (set(slot_owner) | pslots) - hused
    if unbacked:
        problems.append(f"host slots owned but not marked used: "
                        f"{sorted(unbacked)}")
    if cache is not None:
        both = set(cache._index) & set(tier._prefix)
        if both:
            problems.append(f"{len(both)} prefix hashes resident on device "
                            "AND host (XOR violated)")
    sample = sorted(hused)
    if sample:
        # a window keyed by the step counter: over a run the spot check
        # sweeps the whole tier, each audit reads at most 4 slots
        start = int(engine.metrics.decode_steps.value) % len(sample)
        for i in range(min(4, len(sample))):
            s = sample[(start + i) % len(sample)]
            if tier.content_hash(s) != tier._hash[s]:
                problems.append(
                    f"host slot {s} content-hash mismatch: spilled bytes "
                    "corrupted in the host buffer")
    return problems


def _weight_problems(runner) -> list:
    """The broken weight-ladder invariants of a runner's params dict (the
    JAX auditor's packed-weight checks, one device)."""
    problems = []
    w_dtype = getattr(runner, "weight_dtype", "fp32")
    params = getattr(runner, "params", None)
    if w_dtype == "fp32" or params is None:
        return problems
    for name in sorted(getattr(runner, "_quantized_names", ())):
        w, s = params.get(name), params.get(name + SCALE_SUFFIX)
        if w is None:
            problems.append(f"quantized weight {name} missing from params")
            continue
        if w_dtype == "fp8":
            if w.dtype != torch.float8_e4m3fn:
                problems.append(f"{name} dtype {w.dtype} is not a float8 "
                                "type on an fp8 runner")
            if s is not None:
                problems.append(f"{name} carries a scale tensor on an fp8 "
                                "runner: fp8 weights are scale-free casts")
            continue
        if w.dtype != torch.int8:
            problems.append(f"{name} code dtype {w.dtype} != int8 on a "
                            f"{w_dtype} runner")
        if s is None:
            problems.append(f"{name} has no {SCALE_SUFFIX} tensor on a "
                            f"{w_dtype} runner")
            continue
        if s.dtype != torch.float32:
            problems.append(f"{name}{SCALE_SUFFIX} dtype {s.dtype} != "
                            "float32")
        if w_dtype == "int4":
            k = 2 * int(w.shape[0])
            g = min(int(runner.weight_group_size), k)
            want = (int(w.shape[1]), -(-k // g))
            if tuple(s.shape) != want:
                problems.append(
                    f"{name}{SCALE_SUFFIX} shape {tuple(s.shape)} != {want}"
                    f": one fp32 scale per output channel per {g}-row "
                    "reduction group")
        elif s.dim() != 1 or int(s.shape[0]) != int(w.shape[1]):
            problems.append(f"{name}{SCALE_SUFFIX} shape {tuple(s.shape)} "
                            f"!= ({int(w.shape[1])},): one scale per output "
                            "channel")
    return problems


def store_audit_problems(store, live_owners: Optional[set] = None,
                         tick: int = 0, spot_checks: int = 4) -> list:
    """The broken invariants of one SharedKVStore, as a list (audit_engine
    folds them in, audit_store raises):

      * the free and used slots partition range(max_pages), no duplicate;
      * the prefix index, its reverse map and the indexed set agree;
      * every used slot is referenced (owner refs and / or the index ref),
        no free slot is, no hash survives on an unreferenced slot;
      * with ``live_owners``: every owner tag is a live engine
        incarnation or a transfer in flight ("xfer:*"): a dead replica's
        refs must have been reaped;
      * a rotating window of ``spot_checks`` slots, keyed by ``tick``, is
        re-CRC'd against the recorded hashes, so corrupted segment bytes
        are caught before any replica serves them."""
    problems = []
    with store._lock:
        free = list(store._free)
        fset = set(free)
        owned = {s for s, o in store._owners.items() if o}
        indexed = set(store._indexed)
        used = owned | indexed
        everything = set(range(store.max_pages))
        if len(free) != len(fset):
            problems.append("duplicate slots in the store free list")
        if fset & used:
            problems.append("store slots both free and referenced: "
                            f"{sorted(fset & used)}")
        if (fset | used) != everything:
            problems.append(
                "store slot accounting broken: "
                f"lost={sorted(everything - fset - used)} "
                f"foreign={sorted((fset | used) - everything)}")
        stale_hash = sorted(set(store._hash) - used)
        if stale_hash:
            problems.append("store hash bookkeeping survives on "
                            f"unreferenced slots: {stale_hash}")
        if len(set(store._prefix.values())) != len(store._prefix):
            problems.append("store prefix index maps two hashes to one "
                            "slot")
        if {s: h for h, s in store._prefix.items()} != store._prefix_slot:
            problems.append("store prefix index and reverse map disagree")
        if indexed != set(store._prefix.values()):
            problems.append("store indexed-slot set disagrees with the "
                            "prefix index")
        for s, own in store._owners.items():
            if any(c <= 0 for c in own.values()):
                problems.append(f"store slot {s} holds a non-positive "
                                f"owner count: {own}")
        if live_owners is not None:
            for s, own in store._owners.items():
                for o in own:
                    if o not in live_owners and not str(o).startswith(
                            "xfer:"):
                        problems.append(
                            f"store slot {s} referenced by dead or unknown "
                            f"owner {o!r}: reap leaked")
        sample = sorted(s for s in used if store._hash.get(s) is not None)
    if sample:
        start = int(tick) % len(sample)
        for i in range(min(spot_checks, len(sample))):
            s = sample[(start + i) % len(sample)]
            recorded = store.slot_hash(s)
            if recorded is not None and store.content_hash(s) != recorded:
                problems.append(f"store slot {s} content-hash mismatch: "
                                "segment bytes corrupted")
    return problems


def audit_store(store, live_owners: Optional[set] = None,
                tick: int = 0) -> None:
    """Raise InvariantViolation on any broken SharedKVStore invariant (see
    store_audit_problems)."""
    problems = store_audit_problems(store, live_owners, tick)
    if problems:
        raise InvariantViolation("; ".join(problems))


def audit_router(router) -> None:
    """Tier-level invariant auditor: every LIVE replica passes
    audit_engine, and the router's at-most-once bookkeeping is
    consistent — each unfinished request is owned by exactly one live
    replica (or by a failed one the supervisor has not yet recovered,
    never by two), no request id is in flight on two live engines at
    once (the double-completion hazard resubmission must never create),
    delivery cursors match the delivered token streams, and the
    prefix-affinity index only names valid replicas. Raises
    InvariantViolation listing every broken invariant."""
    problems = []
    replicas = list(router._replicas)
    for rep in replicas:
        if rep.status != "live":
            continue
        remote = getattr(rep.engine, "remote_audit", None)
        try:
            with rep.lock:
                if remote is not None:
                    # process backend: audit_engine runs INSIDE the
                    # replica process; only its verdict crosses the wire
                    p = remote()
                    if p:
                        problems.append(f"replica {rep.index}: {p}")
                else:
                    audit_engine(rep.engine)
        except InvariantViolation as e:
            problems.append(f"replica {rep.index}: {e}")
        except BaseException as e:
            # a replica dying UNDER the audit is a liveness event for
            # the supervisor, not an invariant violation
            logger.warning("replica %d unreachable mid-audit: %s",
                           rep.index, e)

    store = getattr(router, "kv_store", None)
    if store is not None:
        # the host-wide store: every live replica's tier joins its pending
        # spill jobs, then the store is audited against the LIVE owner set
        # (a dead replica's un-reaped refs are a violation)
        live_owners = set()
        for rep in replicas:
            if rep.status != "live":
                continue
            if rep.store_owner:
                live_owners.add(rep.store_owner)
            t = getattr(getattr(rep.engine, "pool", None), "host_tier",
                        None)
            if t is not None:
                try:
                    with rep.lock:
                        t.sync()
                except BaseException:      # pragma: no cover - dying
                    pass
        problems.extend(store_audit_problems(
            store, live_owners,
            tick=int(router.metrics.requests_completed.value)))

    with router._lock:
        n = len(replicas)
        inflight = {}
        for rep in replicas:
            if rep.status != "live":
                continue
            for rid, req in rep.engine._requests.items():
                if not req.done:
                    if rid in inflight:
                        problems.append(
                            f"request {rid} in flight on replicas "
                            f"{inflight[rid]} AND {rep.index}")
                    inflight[rid] = rep.index
        for rid, rec in router._reqs.items():
            if rec.cursor != len(rec.tokens):
                problems.append(f"request {rid} cursor {rec.cursor} != "
                                f"{len(rec.tokens)} delivered tokens")
            if rec.done:
                continue
            if not 0 <= rec.owner_idx < n:
                problems.append(f"request {rid} owned by replica "
                                f"{rec.owner_idx} out of range")
                continue
            owner = replicas[rec.owner_idx]
            if owner.status == "live":
                if rec.owner_epoch != owner.epoch:
                    problems.append(
                        f"request {rid} owned by stale epoch "
                        f"{rec.owner_epoch} of live replica {rec.owner_idx}"
                        f" (now epoch {owner.epoch})")
                elif rid not in rep_requests(owner):
                    problems.append(
                        f"request {rid} owned by live replica "
                        f"{rec.owner_idx} but unknown to its engine")
        for h, idx in router._affinity.items():
            if not 0 <= idx < n:
                problems.append(f"affinity entry {h} -> replica {idx} "
                                "out of range")

    if problems:
        raise InvariantViolation("; ".join(problems))


def rep_requests(rep) -> frozenset:
    """Request ids a replica's engine knows (finished included)."""
    return frozenset(rep.engine._requests)
