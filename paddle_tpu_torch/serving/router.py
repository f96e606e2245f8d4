"""Multi-engine serving router: prefix-affinity routing over N engine
replicas, each a worker thread in this process or an OS process of its
own.

Counterpart of paddle_tpu/serving/router.py: `ServingRouter` owns N engine
replicas, each a full ServingEngine (its own paged KV pool, scheduler,
prefix cache, host tier and CUDA graphs) driven by a worker thread, behind
one submit / abort / outputs surface. With `backend="thread"` (the
default) the engines live in this process: on the card they share one
CUDA context, one compute stream and the model's weights (every replica's
runner comes from the caller's factory, which hands it the model's
parameter tensors, see `inference.create_serving_router`), and graph
captures of concurrent replicas are serialized by the runner's capture
lock (model_runner). With `backend="process"` every replica is a child
process (`python -m paddle_tpu_torch.serving.replica`, its own CUDA
context and weights) and the worker thread drives it through a
`launch.EngineClient` over a CRC-framed socket; `runner_factory` is then a
JSON spec the children import their factory from, and a prefill ->
decode handoff crosses the wire as page bytes.

Routing is SESSION-STICKY first: a request whose
`SamplingParams.session_id` names a session the router has seen goes back
to the replica that served it (`RouterMetrics.session_sticky_hits`). Then
PREFIX-AFFINITY: the router hashes each prompt's page-aligned prefix chain
with the PrefixCache's own scheme (`kv_cache.page_content_hash` over the
same chain seed), remembers which replica last served each chain hash,
and routes a new request to the replica that holds its longest cached
prefix. When that target's bounded queue is full the request SHEDS TO A
SIBLING (least loaded by a queue-depth x pool-headroom score); only when
every queue is full does the tier's shed policy apply (reject, or
overflow into the least-loaded engine's own drop-oldest gate).

Delivery is AT-MOST-ONCE: the router keeps one record per request (prompt,
sampling, owner replica and epoch, a delivery cursor over the tokens the
client has seen). Engines are deterministic, so any re-execution (a
supervisor restore from a stale snapshot, a resubmission onto a sibling)
regenerates the same prefix; the cursor drops already delivered indices,
and epoch fencing discards anything a retired replica says after its
failure was declared.

With `prefill_replicas=N` the first N replicas take role "prefill": fresh
prompts enter there, and every request whose prefill completed migrates
with its KV pages to the least-loaded decode replica
(`ServingEngine.extract_handoff` / `import_handoff`). With `journal_path`
every registry change is journaled first (`journal.RouterJournal`), and
`ServingRouter.recover` rebuilds the tier from the journal.

With `shared_kv_pages` the replicas' host tiers are facades over ONE
host-wide `kv_cache.SharedKVStore` the router owns: a demotion by any
replica serves every replica's admission, a handoff moves slot references
instead of page bytes, and a dead replica's refs are reaped by refcount.
On the process backend the store's bytes live in shared-memory segments
every child maps, and its metadata is served to the children by a
`store_service.StoreServer`; the segments survive a router crash, and
`recover` reattaches them and revives the journaled content index.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.journal import RouterJournal
from paddle_tpu_torch.serving.kv_cache import _CHAIN_SEED, page_content_hash
from paddle_tpu_torch.serving.metrics import (
    Counter, Gauge, Histogram, aggregate_snapshots,
)
from paddle_tpu_torch.serving.resilience import (
    QueueFullError, ReplicaCrashError,
)
from paddle_tpu_torch.serving.scheduler import SamplingParams
from paddle_tpu_torch.serving.wire import (
    sampling_from_dict, sampling_to_dict,
)

logger = logging.getLogger(__name__)

ROUTING_POLICIES = ("prefix", "least_loaded", "round_robin", "random")


@dataclass
class RouterOutput:
    """Tier-level completion record: the router's RequestOutput."""

    request_id: str
    prompt_tokens: List[int]
    output_tokens: List[int]
    finish_reason: str
    replica: int                      # final owner replica index
    resubmissions: int = 0            # recovery / migration hops
    replicas: List[int] = field(default_factory=list)   # ownership history
    ttft_s: Optional[float] = None
    e2e_s: Optional[float] = None


class _RequestRecord:
    """The router's per-request bookkeeping: everything needed to deliver
    each token exactly once and to resubmit the request from scratch if
    every engine-side trace of it is lost."""

    __slots__ = ("request_id", "prompt_tokens", "sampling", "owner_idx",
                 "owner_epoch", "arrival_index", "submit_time",
                 "first_token_time", "last_token_time", "finish_time",
                 "cursor", "tokens", "done", "finish_reason",
                 "resubmissions", "replicas")

    def __init__(self, request_id, prompt_tokens, sampling, owner_idx,
                 owner_epoch, arrival_index, submit_time):
        self.request_id = request_id
        self.prompt_tokens = prompt_tokens
        self.sampling = sampling
        self.owner_idx = owner_idx
        self.owner_epoch = owner_epoch
        self.arrival_index = arrival_index
        self.submit_time = submit_time
        self.first_token_time = None
        self.last_token_time = None
        self.finish_time = None
        self.cursor = 0               # tokens delivered to the client
        self.tokens: List[int] = []   # the delivered stream
        self.done = False
        self.finish_reason: Optional[str] = None
        self.resubmissions = 0
        self.replicas: List[int] = [owner_idx]


class EngineReplica:
    """One engine and its worker-thread state. `lock` serializes every
    touch of the engine (step, add, extract, snapshot); `fenced` is the
    at-most-once kill switch: once set, nothing this object's thread
    delivers is believed, even if the thread is still un-hanging. `role`
    is "mixed", or "prefill" / "decode" when the router runs split. On the
    process backend `engine` is a launch.EngineClient (the same surface,
    one socket command per call) and `runner` is None: the runner lives in
    the child."""

    def __init__(self, index: int, epoch: int, engine: ServingEngine,
                 runner, now: float, role: str = "mixed"):
        self.index = index
        self.epoch = epoch
        self.engine = engine
        self.runner = runner
        self.role = role
        self.lock = threading.RLock()
        self.wake = threading.Event()
        self.stop = False
        self.fenced = False
        self.status = "live"          # live | crashed | hung | retired
        self.crash: Optional[str] = None
        self.steps_done = 0
        self.last_beat = now          # step-progress heartbeat
        self.last_snapshot: Optional[dict] = None
        self.thread: Optional[threading.Thread] = None
        # the engine incarnation's owner tag in the host-wide store
        self.store_owner: Optional[str] = None


class RouterMetrics:
    """Tier-level instrument panel (the engine metrics stay per replica;
    `ServingRouter.metrics_snapshot` aggregates both)."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock = clock or time.monotonic
        self.requests_routed = Counter("requests_routed")
        # requests whose session_id re-routed to the replica that served
        # the session's previous turn, ahead of prefix affinity
        self.session_sticky_hits = Counter("session_sticky_hits")
        self.routed_affinity = Counter("routed_affinity")
        self.routed_least_loaded = Counter("routed_least_loaded")
        self.routed_round_robin = Counter("routed_round_robin")
        self.routed_random = Counter("routed_random")
        # a hot affinity target's full queue shed the request to a sibling
        self.shed_reroutes = Counter("shed_reroutes")
        self.tier_rejections = Counter("tier_rejections")
        self.tier_overflow = Counter("tier_overflow")
        self.requests_completed = Counter("requests_completed")
        self.tokens_delivered = Counter("tokens_delivered")
        # tokens a recovered or stale execution regenerated that the
        # cursor refused to deliver twice
        self.duplicate_tokens_dropped = Counter("duplicate_tokens_dropped")
        self.replica_crashes = Counter("replica_crashes")
        self.replica_hangs = Counter("replica_hangs")
        self.replica_restarts = Counter("replica_restarts")
        self.resubmitted_requests = Counter("resubmitted_requests")
        self.redistributed_requests = Counter("redistributed_requests")
        # graceful maintenance: replicas drained on purpose, the requests
        # their drains migrated, and whole-tier rolling restarts
        self.replica_drains = Counter("replica_drains")
        self.drain_migrations = Counter("drain_migrations")
        self.rolling_restarts = Counter("rolling_restarts")
        # requests rebuilt from the journal by ServingRouter.recover()
        self.recovered_requests = Counter("recovered_requests")
        # fence-to-live latency of replica restores and journal recoveries
        self.recovery_s = Histogram("router_recovery_s")
        # requests migrated from a prefill replica to a decode replica
        # with their KV pages, and those whose move failed (resubmitted)
        self.handoffs = Counter("handoffs")
        self.handoff_fallbacks = Counter("handoff_fallbacks")
        self.live_replicas = Gauge("live_replicas")
        self.ttft_s = Histogram("router_ttft_s")
        self.itl_s = Histogram("router_itl_s")
        self.e2e_latency_s = Histogram("router_e2e_latency_s")

    def snapshot(self) -> Dict[str, float]:
        out = {c.name: c.value for c in (
            self.requests_routed, self.session_sticky_hits,
            self.routed_affinity,
            self.routed_least_loaded, self.routed_round_robin,
            self.routed_random, self.shed_reroutes, self.tier_rejections,
            self.tier_overflow, self.requests_completed,
            self.tokens_delivered, self.duplicate_tokens_dropped,
            self.replica_crashes, self.replica_hangs,
            self.replica_restarts, self.resubmitted_requests,
            self.redistributed_requests, self.replica_drains,
            self.drain_migrations, self.rolling_restarts,
            self.recovered_requests, self.handoffs,
            self.handoff_fallbacks)}
        out["live_replicas"] = self.live_replicas.value
        out["recovery_s_max"] = self.recovery_s.max
        out["recovery_s_mean"] = self.recovery_s.mean
        out["ttft_s_p50"] = self.ttft_s.percentile(50)
        out["ttft_s_p99"] = self.ttft_s.percentile(99)
        out["ttft_s_mean"] = self.ttft_s.mean
        out["itl_s_p50"] = self.itl_s.percentile(50)
        out["itl_s_p99"] = self.itl_s.percentile(99)
        out["e2e_latency_s_p50"] = self.e2e_latency_s.percentile(50)
        out["e2e_latency_s_p99"] = self.e2e_latency_s.percentile(99)
        return out


class ServingRouter:
    """N engine replicas behind one submit / abort / outputs surface.

    router = ServingRouter(runner_factory, replicas=2, num_blocks=64,
                           max_batch_size=4, enable_prefix_cache=True)
    rid = router.submit([1, 2, 3], SamplingParams(max_tokens=8))
    outs = router.drain(timeout_s=60)
    router.shutdown()        # or `with ServingRouter(...) as router:`

    `runner_factory(replica_index)` builds one PagedModelRunner per
    replica and per restart (a dead replica never reuses its possibly
    wedged runner). With backend="process" it is a JSON spec instead,
    {"factory": "module:callable", "factory_kw": {...}, "sys_path":
    [...]}, resolved inside each child (replica.model_runner_factory
    builds a seeded Llama or GPT). Every other keyword is a router knob
    below or goes to each replica's ServingEngine verbatim (as JSON on
    the process backend: a value that cannot be serialized raises
    TypeError).

    Router knobs:
      replicas             engine replica count
      prefill_replicas     disaggregated split: the first N replicas take
                           role "prefill" (admission, chunked prefill,
                           first token, then the KV handoff), the rest
                           role "decode"; fresh prompts route to the
                           prefill tier only. 0 = all mixed
      policy               "prefix" (default: session, then affinity,
                           then least loaded), "least_loaded",
                           "round_robin", or "random" (seeded)
      max_queue_depth      per-REPLICA bounded queue (also given to each
                           engine); a full affinity target sheds to a
                           sibling
      shed_policy          when EVERY replica is full: "reject" raises
                           QueueFullError at submit, "drop_oldest"
                           overflows into the least-loaded engine, whose
                           own gate sheds its oldest
      snapshot_every_steps worker snapshot cadence (0 = never: recovery
                           then rebuilds from the registry alone)
      supervise            attach a Supervisor (crash / hang detection and
                           restore); drain() also polls it inline
      heartbeat_timeout_s  no step progress for this long with work
                           pending = the replica is HUNG
      poll_interval_s      supervisor thread poll cadence
      redistribute         after a restore, spread the recovered queue
                           over the tier through the routing policy
      journal_path         write-ahead JSONL journal of registry records,
                           cursor advances, ownership changes and replica
                           snapshots; `ServingRouter.recover(factory,
                           path)` rebuilds the tier from it. None = off
      journal_fsync        "always" | "interval" (default) | "never"
      journal_compact_every  appends between snapshot compactions
      clock                the host clock of heartbeats and latencies
      backend              "thread" (engines in this process) or
                           "process" (each replica a child process)
      rendezvous_timeout_s process backend: how long a spawn or respawn
                           may take to publish its command port
      command_timeout_s    process backend: the deadline of every command
                           that may sit behind device work in the child
      rpc_fast_timeout_s   process backend: the deadline of the health
                           and stats reads
      rpc_max_retries      process backend: retries of an idempotent RPC
                           after a clean deadline trip or a CRC reject
      child_env            process backend: the children's environment
                           (default: this process's)
      shared_kv_pages      capacity in pages of ONE router-owned host-wide
                           SharedKVStore under every replica's host tier
                           (instead of private tiers): spills and
                           demotions publish into it (dedup by chain
                           hash), admission on any replica resolves its
                           prefix against it, handoffs move slot
                           references, a dead replica's refs are reaped.
                           0 = off (private tiers via host_tier_pages)
      shared_kv_shm        back the store with shared-memory segments
                           (None: on the process backend, not on threads);
                           they survive a router crash, so recover() can
                           reattach them
      shared_kv_geometry   process backend: the pool's page geometry
                           {num_layers, block_size, n_kv_heads, head_dim,
                           dtype?, kv_dtype?} (the router holds no runner
                           to take it from)
    """

    def __init__(self, runner_factory, *, replicas: int = 2,
                 policy: str = "prefix",
                 backend: str = "thread",
                 prefill_replicas: int = 0,
                 shared_kv_pages: int = 0,
                 shared_kv_shm: Optional[bool] = None,
                 shared_kv_geometry: Optional[dict] = None,
                 max_queue_depth: Optional[int] = None,
                 shed_policy: str = "reject",
                 snapshot_every_steps: int = 1,
                 idle_wait_s: float = 0.005,
                 supervise: bool = True,
                 heartbeat_timeout_s: float = 5.0,
                 poll_interval_s: float = 0.2,
                 redistribute: bool = True,
                 rendezvous_timeout_s: float = 120.0,
                 command_timeout_s: float = 120.0,
                 rpc_fast_timeout_s: float = 30.0,
                 rpc_max_retries: int = 2,
                 child_env: Optional[dict] = None,
                 journal_path: Optional[str] = None,
                 journal_fsync: str = "interval",
                 journal_compact_every: int = 512,
                 clock: Optional[Callable[[], float]] = None,
                 metrics: Optional[RouterMetrics] = None,
                 _recover_state: Optional[dict] = None,
                 **engine_kw):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if policy not in ROUTING_POLICIES:
            raise ValueError(f"policy={policy!r}; expected one of "
                             f"{ROUTING_POLICIES}")
        if backend not in ("thread", "process"):
            raise ValueError(f"backend={backend!r}; expected 'thread' "
                             "or 'process'")
        if shared_kv_pages < 0:
            raise ValueError("shared_kv_pages must be >= 0")
        if not 0 <= prefill_replicas < replicas:
            if prefill_replicas != 0:
                raise ValueError(
                    f"prefill_replicas={prefill_replicas} must leave at "
                    f"least one decode replica (replicas={replicas})")
        if shed_policy not in ("reject", "drop_oldest"):
            raise ValueError(f"shed_policy={shed_policy!r}; expected "
                             "'reject' or 'drop_oldest'")
        # the first `prefill_replicas` replicas prefill and hand off, the
        # rest decode; 0 = the all-mixed tier
        self._roles = (["prefill"] * prefill_replicas
                       + ["decode"] * (replicas - prefill_replicas)
                       if prefill_replicas else ["mixed"] * replicas)
        self._split = prefill_replicas > 0
        self.backend = backend
        self._runner_factory = runner_factory
        self._policy = policy
        self.max_queue_depth = max_queue_depth
        self.shed_policy = shed_policy
        self._snapshot_every = max(0, int(snapshot_every_steps))
        self._idle_wait_s = float(idle_wait_s)
        self._clock = clock or time.monotonic
        self.metrics = metrics or RouterMetrics(clock=self._clock)
        # each engine enforces the same bounded queue and shed policy: the
        # router's pre-check sheds across replicas, the engine's own gate
        # is the single-replica backstop
        engine_kw["max_queue_depth"] = max_queue_depth
        engine_kw["shed_policy"] = shed_policy
        self._engine_kw = dict(engine_kw)
        self._lock = threading.RLock()
        self._completion = threading.Event()
        self._reqs: Dict[str, _RequestRecord] = {}
        # steps whose registry change is made but not journaled yet
        self._unjotted = 0
        self._affinity: Dict[int, int] = {}      # chain hash -> replica
        self._sessions: Dict[str, int] = {}      # session_id -> replica
        self._retired_metrics: List[Dict[str, float]] = []
        self._epochs = itertools.count()
        self._rr = itertools.count()
        self._rids = itertools.count()
        self._rng = np.random.default_rng(0)
        self._replicas: List[EngineReplica] = []
        self._launcher = None
        # the host-wide KV store, when shared_kv_pages
        self.shared_kv_pages = int(shared_kv_pages)
        self._shared_kv_shm = shared_kv_shm
        self.kv_store = None
        self._store_server = None
        self._owner_seq = itertools.count()
        # the write-ahead journal; with _recover_state (the replayed view
        # of a dead router's journal) the file is first compacted to one
        # state record, so a second crash replays the recovered tier
        self._journal: Optional[RouterJournal] = None
        if journal_path is not None:
            self._journal = RouterJournal(
                journal_path, fsync=journal_fsync,
                compact_every=journal_compact_every,
                resume_state=_recover_state)
        recover_snaps = ((_recover_state or {}).get("snaps") or {})
        if backend == "process":
            # every replica a child process: runner_factory is the JSON
            # spec each child imports its factory from; the rendezvous
            # rides a TCPStore, and each replica's `engine` here is an
            # EngineClient over its socket
            from paddle_tpu_torch.serving.launch import ReplicaLauncher

            # the store exists before any child: its segments and the
            # metadata service's address ride each child's init command
            self._init_store(geometry=shared_kv_geometry,
                             recover_state=_recover_state)
            try:
                self._launcher = ReplicaLauncher(
                    runner_factory, engine_kw,
                    rendezvous_timeout_s=rendezvous_timeout_s,
                    command_timeout_s=command_timeout_s,
                    rpc_fast_timeout_s=rpc_fast_timeout_s,
                    rpc_max_retries=rpc_max_retries, env=child_env,
                    store_spec=self._store_attach_spec())
                snaps = ([recover_snaps.get(i) for i in range(replicas)]
                         if recover_snaps else None)
                clients = self._launcher.spawn_all(self._roles,
                                                   snapshots=snaps)
            except BaseException:
                # no tier came up: its store's segments go with it
                self._close_store()
                raise
            for idx, client in enumerate(clients):
                self._spawn(idx, client, None, start=False,
                            role=self._roles[idx])
        else:
            for idx in range(replicas):
                runner = self._make_runner(idx)
                if idx == 0:
                    # the store's page layout is the pool's: the first
                    # runner fixes it (the tiers check every other one)
                    self._init_store(runner=runner,
                                     recover_state=_recover_state)
                snap = recover_snaps.get(idx)
                owner = self._mint_owner(idx)
                if snap is not None:
                    # recovery: the replica restarts from its last
                    # journaled snapshot (recompute-on-resume,
                    # token-exact); what the snapshot missed is backfilled
                    # from the registry below
                    engine = ServingEngine.restore(
                        runner, snap, tokenizer=engine_kw.get("tokenizer"),
                        sleep_fn=engine_kw.get("sleep_fn"),
                        audit=engine_kw.get("audit"),
                        kv_store=self.kv_store, kv_store_owner=owner)
                else:
                    engine = self._build_engine(runner, self._roles[idx],
                                                store_owner=owner)
                self._spawn(idx, engine, runner, start=False,
                            role=self._roles[idx])
        self.block_size = self._replicas[0].engine.pool.block_size
        if _recover_state is not None:
            # rebuild the at-most-once registry from the journal BEFORE
            # any worker steps: cursors restored, undelivered work
            # resubmitted, zombies aborted
            self._restore_registry(_recover_state)
        for rep in self._replicas:
            self._start_worker(rep)
        self.metrics.live_replicas.set(replicas)
        self.supervisor = None
        if supervise:
            from paddle_tpu_torch.serving.supervisor import Supervisor

            self.supervisor = Supervisor(
                self, heartbeat_timeout_s=heartbeat_timeout_s,
                poll_interval_s=poll_interval_s,
                redistribute=redistribute)
            self.supervisor.start()

    # ------------------------------------------- durable control plane

    @classmethod
    def recover(cls, runner_factory, journal_path: str, **kw):
        """Rebuild a serving tier after a router crash: replay the
        write-ahead journal at `journal_path`, rebuild the replicas (each
        restored from its last journaled snapshot when one exists),
        rebuild the at-most-once registry with the journaled cursors,
        resubmit every undelivered request, and drop any token a restored
        execution re-delivers. Engines are deterministic, so the continued
        streams equal an uninterrupted run's: none lost, none duplicated.

        `runner_factory` and the knobs must describe the tier the dead
        router ran (the journal records request state, not model code).
        The journal keeps being written (compacted first), so recovery
        survives repeated crashes. With backend="process" the factory is
        the tier's JSON spec and a fresh fleet of children restores from
        the journaled snapshots."""
        state, discarded = RouterJournal.replay(journal_path)
        if discarded:
            logger.warning(
                "journal %s: %d torn/corrupt trailing line(s) "
                "discarded; their tokens will be regenerated",
                journal_path, discarded)
        kw.setdefault("journal_path", journal_path)
        return cls(runner_factory, _recover_state=state, **kw)

    def _jot(self, rec: dict) -> None:
        """Append one record to the journal (no-op without one). A failing
        write degrades durability, never availability."""
        if self._journal is None:
            return
        try:
            self._journal.append(rec)
        except OSError as e:             # pragma: no cover - disk full
            logger.error("journal append failed (%s); tier keeps "
                         "serving without durability for this record", e)

    def _restore_registry(self, state: dict) -> None:
        """Rebuild self._reqs from a replayed journal state and place every
        unfinished request on a live replica. Runs before the worker
        threads start, so no locking races exist yet."""
        now = self._clock()
        max_pid = -1
        reqs = state.get("reqs", {})
        order = sorted(reqs.items(),
                       key=lambda kv: (kv[1].get("ai") is None,
                                       kv[1].get("ai") or 0))
        for rid, js in order:
            sampling = sampling_from_dict(js["sampling"])
            rec = _RequestRecord(rid, list(js["prompt"]), sampling,
                                 owner_idx=int(js.get("owner") or 0),
                                 owner_epoch=-1,
                                 arrival_index=js.get("ai"),
                                 submit_time=now)
            rec.tokens = list(map(int, js["tokens"]))
            rec.cursor = len(rec.tokens)
            if rec.tokens:
                rec.first_token_time = now   # TTFT is meaningless
            rec.last_token_time = now        # across a router crash
            if js["done"]:
                rec.done = True
                rec.finish_reason = js.get("reason") or "stop"
                rec.finish_time = now
            self._reqs[rid] = rec
            if rid.startswith("req-p"):
                try:
                    max_pid = max(max_pid, int(rid[5:]))
                except ValueError:
                    pass
        # auto-minted ids must never collide with journaled ones
        self._rids = itertools.count(max_pid + 1)
        live = [r for r in self._replicas if r.status == "live"]
        # ADOPT a request where a restored snapshot already carries it,
        # else INJECT it from the registry with its delivered prefix
        for rid, rec in self._reqs.items():
            if rec.done:
                continue
            # a crash between a step's token batch and its fin record
            # leaves an unfinished request that already meets its stop
            # condition: finish it, a resubmission would decode past it
            sampling = rec.sampling
            if rec.tokens and rec.tokens[-1] in sampling.stop_token_ids:
                self._finish(rec, "stop")
                continue
            if len(rec.tokens) >= sampling.max_tokens:
                self._finish(rec, "length")
                continue
            # the journaled owner first: a split tier's snapshots, taken
            # at different steps, may carry a handed-off request on both
            # sides, and the decode side's is the later
            holders = [rep for rep in live
                       if rid in rep.engine._requests
                       and not rep.engine._requests[rid].done]
            owner = next((rep for rep in holders
                          if rep.index == rec.owner_idx),
                         holders[0] if holders else None)
            if owner is not None:
                self._adopt(owner, rec)
            else:
                target = None
                want = rec.owner_idx
                if 0 <= want < len(self._replicas) \
                        and self._replicas[want].status == "live":
                    target = self._replicas[want]
                if target is None and live:
                    target = min(live,
                                 key=lambda r: (self._load(r), r.index))
                if target is None:
                    self._finish(rec, "error")
                    continue
                self._inject(target, rec)
            self.metrics.recovered_requests.inc()
        # zombies: a restored snapshot resurrected requests the tier
        # already finished, or a copy of a request another replica owns
        # now; abort them instead of burning compute (or serving twice)
        for rep in live:
            for rid in list(rep.engine._requests):
                req = rep.engine._requests[rid]
                rec = self._reqs.get(rid)
                if not req.done and (rec is None or rec.done
                                     or rec.owner_idx != rep.index):
                    try:
                        rep.engine.abort(rid, "aborted")
                    except BaseException:    # pragma: no cover
                        pass

    # ------------------------------------------------ the host-wide store

    def _mint_owner(self, idx: int) -> Optional[str]:
        """The store owner tag of one engine incarnation, unique per
        (replica, restart): a respawned replica is never taken for its dead
        predecessor's un-reaped refs."""
        if not self.shared_kv_pages:
            return None
        return f"r{idx}o{next(self._owner_seq)}"

    def _init_store(self, runner=None, geometry=None,
                    recover_state: Optional[dict] = None) -> None:
        """Build the host-wide store, or on recovery REATTACH the dead
        router's segments (they survive until unlinked) and revive the
        journaled content index, each entry CRC-verified against the
        surviving bytes first. A journaled store this router will not
        revive is unlinked."""
        from paddle_tpu_torch.serving.kv_cache import SharedKVStore

        old_spec = (recover_state or {}).get("store")
        if not self.shared_kv_pages:
            if old_spec:
                SharedKVStore.unlink_spec(old_spec)
            return
        use_shm = (self._shared_kv_shm if self._shared_kv_shm is not None
                   else self.backend == "process")
        if self.backend == "process" and not use_shm:
            raise ValueError(
                "shared_kv_pages with backend='process' needs shared "
                "memory (shared_kv_shm=False cannot reach the children)")
        store = None
        if old_spec and use_shm:
            try:
                store = SharedKVStore.reattach(old_spec)
                revived = store.restore_index(
                    (recover_state or {}).get("store_idx"))
                logger.info("recover: reattached the shared KV store (%d "
                            "journaled prefix pages revived)", revived)
            except (OSError, ValueError, KeyError) as e:
                logger.warning("recover: store reattach failed (%s); "
                               "starting fresh", e)
                SharedKVStore.unlink_spec(old_spec)
                store = None
        elif old_spec:
            SharedKVStore.unlink_spec(old_spec)
        if store is None:
            if geometry is not None:
                store = SharedKVStore.for_geometry(
                    geometry, self.shared_kv_pages, use_shm=use_shm)
            elif runner is not None:
                store = SharedKVStore.for_runner(
                    runner, self.shared_kv_pages, use_shm=use_shm)
            else:
                raise ValueError(
                    "shared_kv_pages with backend='process' needs "
                    "shared_kv_geometry={num_layers, block_size, "
                    "n_kv_heads, head_dim, dtype?, kv_dtype?}: the router "
                    "process holds no runner to take the page layout from")
        self.kv_store = store
        self._jot({"t": "store", "spec": store.attach_spec()})
        if self.backend == "process":
            from paddle_tpu_torch.serving.store_service import StoreServer

            self._store_server = StoreServer(store)

    def _store_attach_spec(self) -> Optional[dict]:
        """What a replica child needs to join the store (the launcher ships
        it in the init command): the segment map and the metadata
        service's address."""
        if self.kv_store is None or self._store_server is None:
            return None
        return {"attach": self.kv_store.attach_spec(),
                "addr": list(self._store_server.address)}

    def _reap_store_owner(self, rep: "EngineReplica") -> int:
        """Release every store ref a dead or drained replica incarnation
        still holds: its slots are reclaimed by refcount (indexed content
        and the siblings' refs survive). Returns the slots freed."""
        if self.kv_store is None or not rep.store_owner:
            return 0
        freed = self.kv_store.reap_owner(rep.store_owner)
        if freed:
            logger.info("reaped %d store slots from dead replica %d "
                        "(owner %s)", freed, rep.index, rep.store_owner)
        return freed

    def _jot_store_index(self) -> None:
        """Journal the store's content index (recover() revives it)."""
        if self.kv_store is not None:
            self._jot({"t": "store_idx",
                       "state": self.kv_store.journal_state()})

    # --------------------------------------------------------- plumbing

    def _make_runner(self, idx: int):
        try:
            return self._runner_factory(idx)
        except TypeError:
            # zero-arg factories are fine too (index-blind replicas)
            return self._runner_factory()

    def _build_engine(self, runner, role: str = "mixed",
                      store_owner: Optional[str] = None) -> ServingEngine:
        kw = dict(self._engine_kw)
        if self.kv_store is not None:
            kw["kv_store"] = self.kv_store
            kw["kv_store_owner"] = store_owner
        return ServingEngine(runner, role=role, **kw)

    def _revive_engine(self, rep: "EngineReplica",
                       snapshot: Optional[dict]):
        """The replacement engine of a dead replica: a FRESH runner and
        ServingEngine.restore (or a fresh engine). On the process backend:
        SIGKILL whatever is left of the old process (a SIGSTOP'd one too),
        spawn a new child and let it restore from the snapshot in its own
        address space. Returns (engine, runner)."""
        if self.backend == "process":
            rep.engine.kill()
            client = self._launcher.spawn(rep.index, role=rep.role,
                                          snapshot=snapshot)
            return client, None
        runner = self._make_runner(rep.index)
        kw = self._engine_kw
        owner = self._mint_owner(rep.index)
        if snapshot is not None:
            engine = ServingEngine.restore(
                runner, snapshot, tokenizer=kw.get("tokenizer"),
                sleep_fn=kw.get("sleep_fn"), audit=kw.get("audit"),
                kv_store=self.kv_store, kv_store_owner=owner)
        else:
            engine = self._build_engine(runner, rep.role, store_owner=owner)
        return engine, runner

    def _replica_dead(self, rep: "EngineReplica") -> bool:
        """waitpid-style liveness probe (process backend): True when the
        replica's process has exited though no command has surfaced the
        death yet, so an IDLE replica's SIGKILL is seen without
        traffic."""
        probe = getattr(rep.engine, "proc_dead", None)
        return bool(probe and probe())

    def _note_dead(self, rep: "EngineReplica", why: str) -> None:
        """Fence a replica whose death surfaced OUTSIDE its worker thread
        (a submit or a handoff hit a crash)."""
        with self._lock:
            if rep.fenced:
                return
            rep.crash = why
            rep.status = "crashed"
            rep.fenced = True
            rep.stop = True
            self.metrics.replica_crashes.inc()
            self.metrics.live_replicas.set(
                sum(1 for r in self._replicas if r.status == "live"))
        rep.wake.set()
        self._completion.set()
        logger.warning("replica %d dead: %s", rep.index, why)

    def _spawn(self, idx: int, engine: ServingEngine, runner,
               start: bool = True, role: Optional[str] = None
               ) -> EngineReplica:
        rep = EngineReplica(idx, next(self._epochs), engine, runner,
                            self._clock(),
                            role=role if role is not None
                            else self._roles[idx])
        if self.kv_store is not None:
            # the incarnation's owner tag: a child's launcher key (unique
            # per spawn), a thread engine's minted tag
            rep.store_owner = (getattr(engine, "key", None)
                               or getattr(engine, "kv_store_owner", None))
        with self._lock:
            if idx == len(self._replicas):
                self._replicas.append(rep)
            else:
                self._replicas[idx] = rep
                # the old replica's cached pages died with its pool: any
                # affinity (or session pin) pointing there is stale
                self._affinity = {h: i for h, i in self._affinity.items()
                                  if i != idx}
                self._sessions = {s: i for s, i in self._sessions.items()
                                  if i != idx}
            self.metrics.live_replicas.set(
                sum(1 for r in self._replicas if r.status == "live"))
        if start:
            self._start_worker(rep)
        return rep

    def _start_worker(self, rep: EngineReplica) -> None:
        t = threading.Thread(
            target=self._worker, args=(rep,), daemon=True,
            name=f"serving-router-r{rep.index}e{rep.epoch}")
        rep.thread = t
        t.start()

    def _worker(self, rep: EngineReplica) -> None:
        """The replica's step loop. Everything engine-touching runs under
        rep.lock; a BaseException escaping step() (the engine absorbs every
        Exception-level fault itself) means the replica is DEAD: fence it
        and let the supervisor take over."""
        while True:
            if rep.stop:
                # graceful stop: commit any in-flight pipelined launch so
                # its tokens reach the registry. A FENCED replica skips
                # this: whatever it held is regenerated by recovery
                if not rep.fenced:
                    with rep.lock:
                        epoch = rep.epoch
                        try:
                            events = rep.engine.flush()
                        except BaseException:   # dying flush: recovery
                            events = []         # regenerates its tokens
                        if events and not rep.fenced:
                            self._deliver(rep, epoch, events)
                            self._collect(rep)
                return
            stepped = False
            with rep.lock:
                if not rep.stop and not rep.fenced \
                        and rep.engine.has_work():
                    epoch = rep.epoch
                    try:
                        events = rep.engine.step()
                    except BaseException as e:   # replica death, not load
                        if not rep.fenced:
                            rep.crash = f"{type(e).__name__}: {e}"
                            rep.status = "crashed"
                            rep.fenced = True
                            self.metrics.replica_crashes.inc()
                            self.metrics.live_replicas.set(
                                sum(1 for r in self._replicas
                                    if r.status == "live"))
                            self._completion.set()
                            logger.warning("replica %d crashed: %s",
                                           rep.index, rep.crash)
                        return
                    rep.steps_done += 1
                    rep.last_beat = self._clock()
                    self._deliver(rep, epoch, events)
                    self._collect(rep)
                    if (self._snapshot_every and not rep.fenced
                            and rep.steps_done % self._snapshot_every == 0):
                        rep.last_snapshot = rep.engine.snapshot()
                        # the journal keeps the last snapshot of each
                        # replica: recover() restores from it
                        self._jot({"t": "snap", "rep": rep.index,
                                   "snapshot": rep.last_snapshot})
                        # the store's content index rides beside the
                        # snapshots
                        self._jot_store_index()
                    stepped = True
            if rep.role == "prefill" and not rep.fenced and not rep.stop:
                # migrate every staged handoff to a decode replica. Outside
                # rep.lock: the move takes prefill.lock then decode.lock,
                # and only prefill replicas initiate, so the order is
                # acyclic
                self._service_handoffs(rep)
            if not stepped:
                rep.wake.wait(self._idle_wait_s)
                rep.wake.clear()

    # --------------------------------------------------------- delivery

    def _deliver(self, rep: EngineReplica, epoch: int, events) -> None:
        """Fold one step's TokenEvents into the registry. Caller holds
        rep.lock. Fencing first, then the cursor: a stale execution can
        only re-say what was already said; drop it."""
        if not events:
            return
        now = self._clock()
        delivered: Dict[str, List[int]] = {}
        finished: Dict[str, str] = {}
        with self._lock:
            if rep.fenced:
                return
            for ev in events:
                rec = self._reqs.get(ev.request_id)
                if (rec is None or rec.done
                        or rec.owner_idx != rep.index
                        or rec.owner_epoch != epoch):
                    continue
                if ev.index < rec.cursor:
                    self.metrics.duplicate_tokens_dropped.inc()
                    continue
                # deterministic engines emit indices densely, so the next
                # undelivered index is the only possible new event
                rec.tokens.append(int(ev.token))
                rec.cursor += 1
                delivered.setdefault(rec.request_id,
                                     []).append(int(ev.token))
                self.metrics.tokens_delivered.inc()
                if rec.first_token_time is None:
                    rec.first_token_time = now
                    self.metrics.ttft_s.observe(now - rec.submit_time)
                else:
                    self.metrics.itl_s.observe(now - rec.last_token_time)
                rec.last_token_time = now
                if ev.finished:
                    self._finish(rec, ev.finish_reason, jot=False)
                    finished[rec.request_id] = ev.finish_reason
            if delivered or finished:
                self._unjotted += 1
        self._jot_step(delivered, finished)

    def _collect(self, rep: EngineReplica) -> None:
        """Pick up completions that produced no TokenEvent (timeout, abort,
        shed, error, and finished outputs a restore carried). Caller holds
        rep.lock."""
        outs = rep.engine._outputs
        if not outs:
            return
        delivered: Dict[str, List[int]] = {}
        finished: Dict[str, str] = {}
        with self._lock:
            if rep.fenced:
                return
            for rid, out in list(outs.items()):
                rec = self._reqs.get(rid)
                if (rec is None or rec.done
                        or rec.owner_idx != rep.index
                        or rec.owner_epoch != rep.epoch):
                    continue
                for tok in out.output_tokens[rec.cursor:]:
                    rec.tokens.append(int(tok))
                    rec.cursor += 1
                    delivered.setdefault(rid, []).append(int(tok))
                    self.metrics.tokens_delivered.inc()
                self._finish(rec, out.finish_reason, jot=False)
                finished[rid] = out.finish_reason
            if delivered or finished:
                self._unjotted += 1
        self._jot_step(delivered, finished)

    def _jot_step(self, delivered: Dict[str, List[int]],
                  finished: Dict[str, str]) -> None:
        """Journal a step's cursor advance as ONE record, and only THEN its
        finishes: "done" never becomes durable before its tokens. The
        caller counted the step in `_unjotted` under the router lock, with
        the registry change; drain() waits for the count to fall back, so
        what it returns is journaled (a crash right after loses none of
        it)."""
        if not (delivered or finished):
            return
        try:
            if delivered:
                self._jot({"t": "tok", "d": delivered})
            for rid, reason in finished.items():
                self._jot({"t": "fin", "rid": rid, "reason": reason})
        finally:
            with self._lock:
                self._unjotted -= 1
            self._completion.set()

    def _finish(self, rec: _RequestRecord, reason: str,
                jot: bool = True) -> None:
        """Caller holds self._lock. `jot=False` leaves the fin record to
        the caller, which writes it AFTER the step's token batch."""
        rec.done = True
        rec.finish_reason = reason
        rec.finish_time = self._clock()
        self.metrics.requests_completed.inc()
        self.metrics.e2e_latency_s.observe(rec.finish_time
                                           - rec.submit_time)
        if jot:
            self._jot({"t": "fin", "rid": rec.request_id,
                       "reason": reason})
        self._completion.set()

    # ---------------------------------------------------------- routing

    def _affinity_chain(self, tokens: Sequence[int]) -> List[int]:
        """Page-aligned content-hash chain of a prompt: the hashes
        PrefixCache.match computes, capped strictly below len(tokens) as
        match() caps them (at least one token is always computed)."""
        bs = self.block_size
        chain: List[int] = []
        prev = _CHAIN_SEED
        for i in range((len(tokens) - 1) // bs):
            prev = page_content_hash(prev, tokens[i * bs:(i + 1) * bs])
            chain.append(prev)
        return chain

    def _load(self, rep: EngineReplica) -> float:
        """Queue-depth x pool-headroom load score (advisory, lock-free
        reads): deeper queues and fuller pools score higher."""
        sched = rep.engine.scheduler
        alloc = rep.engine.pool.allocator
        depth = sched.queue_depth + len(sched.running)
        headroom = ((alloc.num_free + alloc.num_evictable)
                    / max(alloc.num_usable, 1))
        return (1.0 + depth) * (2.0 - headroom)

    def _has_capacity(self, rep: EngineReplica) -> bool:
        if self.max_queue_depth is None:
            return True
        return rep.engine.scheduler.queue_depth < self.max_queue_depth

    def _intake_ok(self, rep: EngineReplica) -> bool:
        """Whether a replica takes FRESH prompts: under the split only the
        prefill tier does (decode replicas receive handoffs and recovery
        injections)."""
        return not self._split or rep.role in ("prefill", "mixed")

    def _choose(self, chain: Sequence[int],
                session_id: Optional[str] = None
                ) -> Tuple[EngineReplica, str]:
        with self._lock:
            live = [r for r in self._replicas
                    if r.status == "live" and self._intake_ok(r)]
            if not live:
                raise RuntimeError("no live intake replicas")
            first, how = None, None
            if self._policy == "prefix":
                # session stickiness outranks content affinity: a repeat
                # turn goes where the session's pages already live
                if session_id is not None:
                    idx = self._sessions.get(session_id)
                    if idx is not None \
                            and self._replicas[idx].status == "live" \
                            and self._intake_ok(self._replicas[idx]):
                        first, how = self._replicas[idx], "session"
                if first is None:
                    for h in reversed(chain):
                        idx = self._affinity.get(h)
                        if idx is not None \
                                and self._replicas[idx].status == "live" \
                                and self._intake_ok(self._replicas[idx]):
                            first, how = self._replicas[idx], "affinity"
                            break
            elif self._policy == "round_robin":
                first, how = live[next(self._rr) % len(live)], "round_robin"
            elif self._policy == "random":
                first = live[int(self._rng.integers(len(live)))]
                how = "random"
        if first is not None and self._has_capacity(first):
            return first, how
        if how in ("affinity", "session") and first is not None:
            # hot affinity / session target: shed to a sibling
            self.metrics.shed_reroutes.inc()
        ordered = sorted(live, key=lambda r: (self._load(r), r.index))
        for rep in ordered:
            if self._has_capacity(rep):
                return rep, "least_loaded"
        # every replica's queue is full: tier-level admission control
        if self.shed_policy == "reject":
            self.metrics.tier_rejections.inc()
            raise QueueFullError(
                f"all {len(live)} replica queues full "
                f"(max_queue_depth={self.max_queue_depth} each); tier "
                "shed_policy='reject'")
        self.metrics.tier_overflow.inc()
        return ordered[0], "overflow"

    # ----------------------------------------------------------- intake

    def submit(self, prompt_tokens: Sequence[int],
               sampling: Optional[SamplingParams] = None,
               request_id: Optional[str] = None) -> str:
        """Route one request to a replica and enqueue it. Raises
        QueueFullError only when EVERY replica's queue is full under
        shed_policy='reject'; a hot affinity target sheds to the
        least-loaded sibling instead."""
        sampling = sampling or SamplingParams()
        prompt = list(map(int, prompt_tokens))
        if request_id is not None:
            with self._lock:
                if request_id in self._reqs:
                    raise ValueError(f"request {request_id!r} already "
                                     "submitted")
        elif self.backend == "process":
            # tier-unique auto ids: each replica PROCESS counts its own
            # arrivals, so engine-assigned "req-N" names would collide
            # across replicas in the registry
            request_id = f"req-p{next(self._rids)}"
        chain = self._affinity_chain(prompt)
        for _ in range(len(self._replicas) + 2):
            rep, how = self._choose(chain, sampling.session_id)
            with rep.lock:
                if rep.fenced or rep.status != "live":
                    continue           # died between choose and lock
                try:
                    rid = rep.engine.add_request(prompt, sampling,
                                                 request_id=request_id)
                except ReplicaCrashError as e:
                    self._note_dead(rep, f"{type(e).__name__}: {e}")
                    continue
                arrival_index = rep.engine._requests[rid].arrival_index
                with self._lock:
                    rec = _RequestRecord(rid, prompt, sampling, rep.index,
                                         rep.epoch, arrival_index,
                                         self._clock())
                    self._reqs[rid] = rec
                    for h in chain:
                        self._affinity[h] = rep.index
                    if sampling.session_id is not None:
                        self._sessions[sampling.session_id] = rep.index
                # the registry record is durable before submit() returns
                self._jot({"t": "sub", "rid": rid, "prompt": prompt,
                           "sampling": sampling_to_dict(sampling),
                           "rep": rep.index, "epoch": rep.epoch,
                           "ai": arrival_index})
                # a drop_oldest overflow may have shed a sibling request
                # inside add_request: record it now
                self._collect(rep)
                rep.last_beat = max(rep.last_beat, self._clock())
            self.metrics.requests_routed.inc()
            if how != "overflow":      # tier_overflow counted in _choose
                {"session": self.metrics.session_sticky_hits,
                 "affinity": self.metrics.routed_affinity,
                 "round_robin": self.metrics.routed_round_robin,
                 "random": self.metrics.routed_random,
                 }.get(how, self.metrics.routed_least_loaded).inc()
            rep.wake.set()
            return rid
        raise RuntimeError("no live replicas accepted the request")

    def abort(self, request_id: str, reason: str = "aborted") -> bool:
        """Cancel an in-flight request tier-wide, even while its owner is
        dead and awaiting recovery (the registry then finishes it, and a
        later restore aborts the engine-side zombie)."""
        with self._lock:
            rec = self._reqs.get(request_id)
            if rec is None or rec.done:
                return False
            rep = self._replicas[rec.owner_idx]
            live_owner = (rep.status == "live"
                          and rec.owner_epoch == rep.epoch)
            if not live_owner:
                self._finish(rec, reason)
                return True
        with rep.lock:
            ok = rep.engine.abort(request_id, reason)
            self._collect(rep)
        if not ok:
            with self._lock:
                if not rec.done:
                    self._finish(rec, reason)
        return True

    # ------------------------------------------------ recovery plumbing
    # (driven by supervisor.Supervisor; here because they touch the
    # registry and affinity under the router lock)

    def _record_state(self, rec: _RequestRecord) -> dict:
        """A request's migration state from the registry alone: the
        resubmission source when no engine-side trace survives. The
        delivered prefix is authoritative (snapshots are taken after
        delivery)."""
        now = self._clock()
        return {
            "request_id": rec.request_id,
            "prompt_tokens": list(rec.prompt_tokens),
            "output_tokens": list(rec.tokens),
            "sampling": rec.sampling,
            "arrival_index": rec.arrival_index,
            "num_preemptions": 0,
            "elapsed_s": now - rec.submit_time,
            "first_token_elapsed_s": (
                rec.first_token_time - rec.submit_time
                if rec.first_token_time is not None else None),
        }

    def _inject(self, rep: EngineReplica, rec: _RequestRecord,
                state: Optional[dict] = None) -> None:
        """Resubmit a registry request into `rep`'s engine (restore
        backfill, redistribution). Prefers the registry's delivered prefix
        over an engine-side partial, so the engine recomputes as little
        delivered history as possible."""
        if state is None:
            state = self._record_state(rec)
        out = list(state.get("output_tokens") or ())
        if len(rec.tokens) > len(out):
            out = list(rec.tokens)
        with rep.lock:
            rep.engine.inject_request(
                state["prompt_tokens"], state["sampling"],
                request_id=rec.request_id, output_tokens=out,
                arrival_index=state["arrival_index"],
                num_preemptions=int(state.get("num_preemptions", 0)),
                elapsed_s=float(state.get("elapsed_s", 0.0)),
                first_token_elapsed_s=state.get("first_token_elapsed_s"))
            rep.last_beat = max(rep.last_beat, self._clock())
        with self._lock:
            rec.owner_idx, rec.owner_epoch = rep.index, rep.epoch
            rec.resubmissions += 1
            rec.replicas.append(rep.index)
            for h in self._affinity_chain(state["prompt_tokens"]):
                self._affinity[h] = rep.index
            sid = getattr(rec.sampling, "session_id", None)
            if sid is not None:      # the session follows its request
                self._sessions[sid] = rep.index
        self._jot({"t": "own", "rid": rec.request_id, "rep": rep.index})
        self.metrics.resubmitted_requests.inc()
        rep.wake.set()

    def _adopt(self, rep: EngineReplica, rec: _RequestRecord) -> None:
        """Re-own a record restored onto replica `rep` (no engine work:
        the restore already carries the request)."""
        with self._lock:
            rec.owner_idx, rec.owner_epoch = rep.index, rep.epoch
            if not rec.replicas or rec.replicas[-1] != rep.index:
                rec.replicas.append(rep.index)
        self._jot({"t": "own", "rid": rec.request_id, "rep": rep.index})

    def _orphans(self, idx: int, epoch: int) -> List[_RequestRecord]:
        with self._lock:
            return [rec for rec in self._reqs.values()
                    if not rec.done and rec.owner_idx == idx
                    and rec.owner_epoch == epoch]

    def _redistribute_from(self, rep: EngineReplica) -> int:
        """Drain the restored replica's queue back over the tier: the first
        max_batch_size requests stay (they refill its batch), the rest go
        to the least-loaded replicas, until one routes back here (the tier
        is balanced again)."""
        with self._lock:
            siblings = [r for r in self._replicas
                        if r.status == "live" and r is not rep]
        if not siblings:
            return 0
        with rep.lock:
            queue = [r.request_id
                     for r in rep.engine.scheduler.waiting]
        moved = 0
        for rid in queue[rep.engine.max_batch_size:]:
            with self._lock:
                rec = self._reqs.get(rid)
            if rec is None or rec.done:
                continue
            # least loaded, not affinity: the dead pool's pages are gone
            with self._lock:
                ordered = sorted(
                    (r for r in self._replicas if r.status == "live"),
                    key=lambda r: (self._load(r), r.index))
            target = next((t for t in ordered
                           if self._has_capacity(t)), None)
            if target is None or target is rep:
                break                  # tier is balanced (or full) again
            try:
                with rep.lock:
                    state = rep.engine.extract_request(rid)
            except (KeyError, ValueError):
                continue               # raced into RUNNING / FINISHED
            self._inject(target, rec, state)
            self.metrics.redistributed_requests.inc()
            moved += 1
        return moved

    # ------------------------------------------ prefill / decode handoff

    def _choose_decode(self) -> Optional[EngineReplica]:
        """The least-loaded live decode-capable replica, or None when every
        one is down (the handoff then stays staged until a restore)."""
        with self._lock:
            cands = [r for r in self._replicas if r.status == "live"
                     and r.role in ("decode", "mixed")]
        cands.sort(key=lambda r: (self._load(r), r.index))
        return cands[0] if cands else None

    def _service_handoffs(self, rep: EngineReplica) -> None:
        """Move every handoff the prefill replica has staged onto a decode
        replica. Lock order: rep (prefill), then target (decode), then the
        registry; only prefill replicas initiate, so the order is
        acyclic."""
        try:
            ready = rep.engine.handoff_ready()
        except BaseException:
            return                       # dying replica: supervisor's job
        for rid in ready:
            with self._lock:
                rec = self._reqs.get(rid)
            if rec is None or rec.done:
                # aborted or expired tier-side while staged: release the
                # engine-side state (frees the spilled host slots)
                try:
                    with rep.lock:
                        rep.engine.abort(rid, "aborted")
                except BaseException:
                    pass
                continue
            target = self._choose_decode()
            if target is None or target is rep:
                return
            self._migrate_handoff(rep, target, rec)

    def _migrate_handoff(self, rep: EngineReplica,
                         target: EngineReplica,
                         rec: _RequestRecord) -> None:
        try:
            with rep.lock:
                if rep.fenced:
                    return
                state, payload = rep.engine.extract_handoff(
                    rec.request_id)
        except KeyError:
            return                       # raced an abort
        except BaseException as e:
            # the prefill replica died mid-extract: the registry record
            # survives, and the supervisor backfills it like any orphan
            if isinstance(e, ReplicaCrashError):
                self._note_dead(rep, f"{type(e).__name__}: {e}")
            return
        npages = len(payload["hashes"]) if payload else 0
        try:
            with target.lock:
                if target.fenced or target.status != "live":
                    raise ReplicaCrashError("handoff target fenced")
                target.engine.import_handoff(state, payload)
                target.last_beat = max(target.last_beat, self._clock())
        except BaseException as e:
            # the decode side refused or died (fence, crash, or a content
            # hash mismatch raised at receive): the request is already out
            # of the prefill engine, so resubmit it from the registry
            if isinstance(e, ReplicaCrashError):
                self._note_dead(target, f"{type(e).__name__}: {e}")
            else:
                logger.warning("handoff of %s to replica %d failed "
                               "(%s); falling back to recompute "
                               "resubmission", rec.request_id,
                               target.index, e)
            self.metrics.handoff_fallbacks.inc()
            if self.kv_store is not None:
                # the transfer tag's refs die with the failed handoff (a
                # no-op where import_handoff already released them)
                self.kv_store.reap_owner(f"xfer:{rec.request_id}")
            fallback = self._choose_decode()
            with self._lock:
                live = [r for r in self._replicas if r.status == "live"]
            if fallback is None and live:
                fallback = live[0]
            if fallback is not None:
                self._inject(fallback, rec)
            return
        with self._lock:
            rec.owner_idx, rec.owner_epoch = target.index, target.epoch
            rec.replicas.append(target.index)
        self._jot({"t": "own", "rid": rec.request_id,
                   "rep": target.index})
        self.metrics.handoffs.inc()
        logger.debug("handoff %s: replica %d -> %d (%d pages)",
                     rec.request_id, rep.index, target.index, npages)
        target.wake.set()

    # --------------------------------- graceful drain / rolling restart

    def _drain_target(self, rep: "EngineReplica"
                      ) -> Optional["EngineReplica"]:
        """The least-loaded live sibling of a draining replica (capacity
        ignored: a migration rides inject_request, which bypasses the shed
        gate)."""
        with self._lock:
            cands = [r for r in self._replicas
                     if r.status == "live" and r is not rep]
        cands.sort(key=lambda r: (self._load(r), r.index))
        return cands[0] if cands else None

    def _migrate_out(self, rep: "EngineReplica",
                     rec: _RequestRecord) -> int:
        """Move ONE request off a draining replica, preferring (1) the KV
        handoff (staged handoffs, or running decode-phase requests staged
        on demand by stage_migration, so their pages ride when the host
        tier is on), then (2) extract_request for waiting requests, then
        (3) the registry resubmission, always correct. Returns 1 when the
        request moved."""
        rid = rec.request_id
        # 1) KV handoff
        try:
            with rep.lock:
                staged = rid in rep.engine.handoff_ready()
                if not staged:
                    staged = bool(rep.engine.stage_migration(rid))
            if staged:
                target = self._choose_decode()
                if target is not None and target is not rep:
                    self._migrate_handoff(rep, target, rec)
                    with self._lock:
                        moved = not (rec.owner_idx == rep.index
                                     and rec.owner_epoch == rep.epoch)
                    if moved:
                        self.metrics.drain_migrations.inc()
                        return 1
        except BaseException as e:
            logger.warning("drain: handoff migration of %s failed "
                           "(%s); falling back to resubmission", rid, e)
        # 2) queued: extract the serialized state (frees any host slots)
        state = None
        try:
            with rep.lock:
                state = rep.engine.extract_request(rid)
        except BaseException:
            state = None                 # running / finished / dead
        with self._lock:
            if rec.done:
                return 0
        target = self._drain_target(rep)
        if target is None:
            return 0     # no live sibling: restart_replica backfills
        # 3) inject (the extracted state, else the registry record)
        self._inject(target, rec, state)
        self.metrics.drain_migrations.inc()
        return 1

    def drain_replica(self, idx: int, timeout_s: float = 60.0) -> int:
        """Gracefully drain replica `idx`: stop routing to it, stop its
        worker (the graceful stop flushes any pipelined launch), migrate
        its queued AND running requests to siblings (pages ride the
        handoff when the host tier is on, recompute otherwise), then
        retire it as status 'drained' (process backend: a bounded
        shutdown RPC, then the child is reaped); `restart_replica` brings
        a fresh one back. Returns the number of requests migrated."""
        with self._lock:
            rep = self._replicas[idx]
            if rep.status != "live":
                return 0
            rep.status = "draining"      # routing no longer offers it
            self.metrics.live_replicas.set(
                sum(1 for r in self._replicas if r.status == "live"))
        rep.stop = True
        rep.wake.set()
        t = rep.thread
        if t is not None and t.is_alive():
            t.join(timeout_s)
            if t.is_alive():
                raise TimeoutError(
                    f"drain_replica({idx}): worker still stepping "
                    f"after {timeout_s}s; treat as hung and use "
                    "kill_replica / supervisor recovery instead")
        moved = 0
        for rec in self._orphans(rep.index, rep.epoch):
            moved += self._migrate_out(rep, rec)
        if self.kv_store is not None:
            # a draining replica demotes its whole device prefix cache
            # into the store (clear() fires evict_hook per page: publish,
            # or dedup), so the sessions it served resume on any sibling
            # by page-in: the zero-recompute rolling restart
            try:
                with rep.lock:
                    rep.engine.release_prefix_cache()
            except BaseException:        # pragma: no cover - dying
                pass
            self._jot_store_index()
        # the drained engine's counters join tier history
        try:
            self._retired_metrics.append(rep.engine.metrics.snapshot())
        except BaseException:            # pragma: no cover
            pass
        if self.backend == "process":
            try:
                rep.engine.shutdown()    # bounded: a shutdown RPC, a reap
            except BaseException:        # pragma: no cover
                pass
        with self._lock:
            rep.fenced = True
            rep.status = "drained"
            self._affinity = {h: i for h, i in self._affinity.items()
                              if i != idx}
            self._sessions = {s: i for s, i in self._sessions.items()
                              if i != idx}
        self._reap_store_owner(rep)
        self.metrics.replica_drains.inc()
        self._completion.set()
        logger.info("replica %d drained (%d requests migrated)",
                    idx, moved)
        return moved

    def restart_replica(self, idx: int) -> "EngineReplica":
        """Bring a drained (or retired) replica back as a FRESH engine (new
        epoch, empty pool; a new child on the process backend) and
        backfill any registry request the dead
        epoch still owns (the no-live-sibling drain case)."""
        rep = self._replicas[idx]
        if rep.status == "live":
            return rep
        old_epoch = rep.epoch
        if self.backend == "process":
            engine, runner = self._launcher.spawn(idx, role=rep.role), None
        else:
            runner = self._make_runner(idx)
            engine = self._build_engine(runner, rep.role,
                                        store_owner=self._mint_owner(idx))
        new = self._spawn(idx, engine, runner, start=False,
                          role=rep.role)
        for rec in self._orphans(idx, old_epoch):
            self._inject(new, rec)
        self._start_worker(new)
        self.metrics.replica_restarts.inc()
        self._completion.set()
        return new

    def rolling_restart(self, drain_timeout_s: float = 60.0) -> int:
        """Cycle the whole tier one replica at a time: drain_replica, then
        restart_replica, for every index in order. In-flight traffic keeps
        flowing through the siblings of the replica that is down, with no
        token lost or duplicated. Returns the number of replicas
        cycled."""
        cycled = 0
        for idx in range(len(self._replicas)):
            self.drain_replica(idx, timeout_s=drain_timeout_s)
            self.restart_replica(idx)
            cycled += 1
        self.metrics.rolling_restarts.inc()
        return cycled

    # ----------------------------------------------------------- drills

    def kill_replica(self, idx: int, reason: str = "killed") -> bool:
        """Simulate a replica death (a test and drill hook): fence it at
        once, even mid-step, and leave recovery to the supervisor (process
        backend: the child is SIGKILLed). Returns False if the replica is
        not live."""
        with self._lock:
            rep = self._replicas[idx]
            if rep.status != "live":
                return False
            rep.fenced = True
            rep.stop = True
            rep.status = "crashed"
            rep.crash = f"ReplicaKilled: {reason}"
            self.metrics.replica_crashes.inc()
            self.metrics.live_replicas.set(
                sum(1 for r in self._replicas if r.status == "live"))
        if self.backend == "process":
            # a drill kill ends the PROCESS (SIGKILL), not just the proxy:
            # recovery must prove a real respawn
            try:
                rep.engine.kill()
            except Exception:  # pragma: no cover
                pass
        rep.wake.set()
        self._completion.set()
        return True

    # ------------------------------------------------------------ drain

    def has_work(self) -> bool:
        with self._lock:
            return any(not rec.done for rec in self._reqs.values())

    def drain(self, timeout_s: Optional[float] = None,
              poll_s: float = 0.02) -> Dict[str, RouterOutput]:
        """Block until every submitted request has finished and its tokens
        and finish are journaled; returns outputs(). Polls the supervisor
        inline, so recovery happens even without its thread. Raises
        TimeoutError (listing the stuck requests) after `timeout_s`."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while True:
            with self._lock:
                pending = [rid for rid, rec in self._reqs.items()
                           if not rec.done]
                unjotted = self._unjotted
            if not pending and not unjotted:
                return self.outputs()
            if self.supervisor is not None:
                self.supervisor.poll()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{len(pending)} requests still pending after "
                    f"{timeout_s}s: {pending[:8]}")
            self._completion.wait(poll_s)
            self._completion.clear()

    def outputs(self) -> Dict[str, RouterOutput]:
        with self._lock:
            return {
                rid: RouterOutput(
                    request_id=rid,
                    prompt_tokens=list(rec.prompt_tokens),
                    output_tokens=list(rec.tokens),
                    finish_reason=rec.finish_reason,
                    replica=rec.owner_idx,
                    resubmissions=rec.resubmissions,
                    replicas=list(rec.replicas),
                    ttft_s=(rec.first_token_time - rec.submit_time
                            if rec.first_token_time is not None else None),
                    e2e_s=(rec.finish_time - rec.submit_time
                           if rec.finish_time is not None else None))
                for rid, rec in self._reqs.items() if rec.done}

    # ---------------------------------------------------------- metrics

    def metrics_snapshot(self) -> dict:
        """{"router": tier counters and latencies, "engines": the summed
        per-replica EngineMetrics (retired epochs included), "per_replica":
        live engine snapshots}, plus "journal" with a journal."""
        with self._lock:
            reps = list(self._replicas)
            retired = list(self._retired_metrics)
        per = []
        for rep in reps:
            if rep.status != "live":
                continue
            with rep.lock:
                snap = rep.engine.metrics.snapshot()
            per.append({"replica": rep.index, "epoch": rep.epoch,
                        "steps": rep.steps_done, **snap})
        engine_snaps = [{k: v for k, v in p.items()
                         if k not in ("replica", "epoch", "steps")}
                        for p in per] + retired
        out = {"router": self.metrics.snapshot(),
               "engines": aggregate_snapshots(engine_snaps),
               "per_replica": per}
        if self._journal is not None:
            out["journal"] = self._journal.stats()
        if self.kv_store is not None:
            out["store"] = self.kv_store.stats()
        return out

    # --------------------------------------------------------- teardown

    def release_prefix_caches(self) -> int:
        """release_prefix_cache() on every live replica (the tier's
        leak-audit hook). Returns the pages released."""
        total = 0
        for rep in self._replicas:
            if rep.status != "live":
                continue
            with rep.lock:
                total += rep.engine.release_prefix_cache()
        return total

    def check_no_leaks(self) -> bool:
        for rep in self._replicas:
            if rep.status != "live":
                continue
            with rep.lock:
                if not rep.engine.pool.allocator.check_no_leaks():
                    return False
        return True

    def shutdown(self, timeout_s: float = 2.0) -> None:
        if self.supervisor is not None:
            self.supervisor.stop()
        for rep in list(self._replicas):
            rep.stop = True
            rep.wake.set()
        for rep in list(self._replicas):
            t = rep.thread
            if t is not None and t.is_alive():
                t.join(timeout_s)
        if self.backend == "process":
            for rep in list(self._replicas):
                try:
                    rep.engine.shutdown()
                except BaseException:  # pragma: no cover
                    pass
            if self._launcher is not None:
                self._launcher.close()
        if self._journal is not None:
            self._journal.close()
        self._close_store()

    def _close_store(self) -> None:
        """Stop the store's metadata service and close the store (its
        creating or recovering router unlinks its segments)."""
        if self._store_server is not None:
            self._store_server.close()
            self._store_server = None
        if self.kv_store is not None:
            self.kv_store.close()
            self.kv_store = None

    def __enter__(self) -> "ServingRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
