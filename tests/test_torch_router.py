"""The port's serving router against the JAX package, on the CPU.

Ports the thread-backend pins of tests/test_serving_router.py (its two
sub-mesh cases are in tests/test_torch_tp.py): every stream through `ServingRouter` equals a
single engine's and `naive_generate`'s however requests are spread over
replicas, shed between queues, or moved by a replica kill, an injected
crash or a hang and the Supervisor's restore; nothing is lost or
delivered twice, and every replica's auditor stays green. The replicas
serve a small Llama (2 layers, width 64) through `LlamaRunner`s that
share its weights. Across the frameworks: the port's router and the JAX
router on the same numpy weights give the same greedy streams, and
`aggregate_snapshots` of the same snapshot dicts equals the JAX
function's.

The hang case waits on the router's own clock (a counter that advances
on every read) and the injector's stall hook, never on a wall-clock
heartbeat; every router is shut down and its threads joined.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.serving import LlamaRunner as JaxLlamaRunner
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingRouter as JaxServingRouter
from paddle_tpu.serving.metrics import \
    aggregate_snapshots as jax_aggregate_snapshots
from paddle_tpu_torch.models import Llama, LlamaConfig
from paddle_tpu_torch.serving import (
    EngineMetrics, FaultInjector, LlamaRunner, QueueFullError,
    ReplicaCrashError, SamplingParams, ServingEngine, ServingRouter,
    aggregate_snapshots, audit_router, naive_generate,
)
from paddle_tpu_torch.serving.engine import TokenEvent
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

VOCAB, BLOCK, MAXLEN = 97, 4, 64
SIZES = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=MAXLEN)


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    """Every replica engine audits its invariants after every step."""
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


@pytest.fixture(scope="module")
def pair():
    """(JAX Llama, the port's Llama holding its weights)."""
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(dropout=0.0, **SIZES))
    jm.eval()
    pm = Llama(LlamaConfig(**SIZES), device="cpu", seed=1)
    load_params(pm, {k: np.asarray(v) for k, v in
                     functionalize(jm).param_values().items()})
    return jm, pm


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def factory_of(model):
    return lambda idx=0: LlamaRunner(model, BLOCK, MAXLEN)


def oracle(model, prompt, sp):
    return naive_generate(LlamaRunner(model, BLOCK, MAXLEN), prompt, sp,
                          max_model_len=MAXLEN)


def make_router(model, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("num_blocks", 24)
    kw.setdefault("max_batch_size", 3)
    kw.setdefault("max_model_len", MAXLEN)
    kw.setdefault("poll_interval_s", 0.02)
    return ServingRouter(kw.pop("factory", factory_of(model)), **kw)


def tenant_workload(n, seed=0, tenants=3, header_pages=2):
    """Skewed multi-tenant prompts: half the traffic on tenant 0, each
    tenant sharing a page-aligned header."""
    rng = np.random.default_rng(seed)
    headers = [list(map(int, rng.integers(1, VOCAB, header_pages * BLOCK)))
               for _ in range(tenants)]
    prompts = []
    for i in range(n):
        t = 0 if i % 2 == 0 else 1 + (i // 2) % (tenants - 1)
        prompts.append(headers[t] + list(map(
            int, rng.integers(1, VOCAB, int(rng.integers(2, 8))))))
    return prompts


def _assert_exact(model, outs, prompts, sp, prefix="k"):
    for i, p in enumerate(prompts):
        o = outs[f"{prefix}{i}"]
        assert o.output_tokens == oracle(model, p, sp), \
            f"{prefix}{i}: {o.output_tokens} != oracle"
        assert o.finish_reason in ("stop", "length")


def _wait(cond, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.002)
    assert cond(), "condition not reached"


# ------------------------------------------------------- token exactness


def test_router_token_exact_vs_single_engine_greedy(model):
    prompts = tenant_workload(14)
    sp = SamplingParams(max_tokens=10)
    single = ServingEngine(LlamaRunner(model, BLOCK, MAXLEN), num_blocks=24,
                           max_batch_size=3, max_model_len=MAXLEN,
                           enable_prefix_cache=True,
                           max_prefill_tokens_per_step=8)
    for i, p in enumerate(prompts):
        single.add_request(p, sp, request_id=f"s{i}")
    single_outs = single.run()
    with make_router(model, enable_prefix_cache=True,
                     max_prefill_tokens_per_step=8) as router:
        for i, p in enumerate(prompts):
            router.submit(p, sp, request_id=f"s{i}")
        outs = router.drain(timeout_s=60)
        audit_router(router)
        for i, p in enumerate(prompts):
            assert outs[f"s{i}"].output_tokens == \
                single_outs[f"s{i}"].output_tokens == oracle(model, p, sp)
        assert all(o.finish_reason == "length" for o in outs.values())
        router.release_prefix_caches()
        assert router.check_no_leaks()


def test_router_token_exact_seeded_temperature(model):
    prompts = tenant_workload(10, seed=3)
    sps = [SamplingParams(max_tokens=8, temperature=0.7, top_k=12,
                          seed=100 + i) for i in range(len(prompts))]
    with make_router(model) as router:
        for i, (p, sp) in enumerate(zip(prompts, sps)):
            router.submit(p, sp, request_id=f"t{i}")
        outs = router.drain(timeout_s=60)
        audit_router(router)
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        assert outs[f"t{i}"].output_tokens == oracle(model, p, sp)


def test_port_router_equals_the_jax_router(pair):
    """The port's router and the JAX router (thread backend), each over
    two replicas of the same Llama weights with the prefix cache and
    chunked prefill on: the same greedy stream for every request."""
    jm, pm = pair
    prompts = tenant_workload(8, seed=21)
    kw = dict(replicas=2, num_blocks=24, max_batch_size=3,
              max_model_len=MAXLEN, enable_prefix_cache=True,
              max_prefill_tokens_per_step=8, poll_interval_s=0.02,
              heartbeat_timeout_s=60.0)
    with ServingRouter(factory_of(pm), **kw) as router:
        for i, p in enumerate(prompts):
            router.submit(p, SamplingParams(max_tokens=8), request_id=f"x{i}")
        outs = router.drain(timeout_s=60)
        audit_router(router)
    jrouter = JaxServingRouter(
        lambda idx=0: JaxLlamaRunner(jm, BLOCK, MAXLEN, "reference"), **kw)
    try:
        for i, p in enumerate(prompts):
            jrouter.submit(p, JaxSamplingParams(max_tokens=8),
                           request_id=f"x{i}")
        jouts = jrouter.drain(timeout_s=120)
    finally:
        jrouter.shutdown()
    for i in range(len(prompts)):
        assert outs[f"x{i}"].output_tokens == jouts[f"x{i}"].output_tokens
        assert outs[f"x{i}"].finish_reason == jouts[f"x{i}"].finish_reason


# --------------------------------------------------------------- routing


def test_affinity_routes_same_tenant_to_same_replica(model):
    header = list(range(1, 1 + 2 * BLOCK))
    with make_router(model, enable_prefix_cache=True) as router:
        rid0 = router.submit(header + [20, 21],
                             SamplingParams(max_tokens=2))
        home = router._reqs[rid0].owner_idx
        for k in range(4):
            rid = router.submit(header + [22 + k],
                                SamplingParams(max_tokens=2))
            assert router._reqs[rid].owner_idx == home
        assert router.metrics.routed_affinity.value == 4
        router.drain(timeout_s=30)


def test_session_stickiness_routes_repeat_turns_home(model):
    """session_id pins repeat turns to the replica that served the
    session, ahead of prefix affinity, even when the turns share no
    prefix."""
    with make_router(model, enable_prefix_cache=True) as router:
        rid0 = router.submit([7, 8, 9], SamplingParams(
            max_tokens=2, session_id="chat-a"))
        home = router._reqs[rid0].owner_idx
        for k in range(4):
            rid = router.submit([10 + 3 * k, 11 + 3 * k],
                                SamplingParams(max_tokens=2,
                                               session_id="chat-a"))
            assert router._reqs[rid].owner_idx == home
        assert router.metrics.session_sticky_hits.value == 4
        assert router.metrics.snapshot()["session_sticky_hits"] == 4
        router.submit([1, 2], SamplingParams(max_tokens=2,
                                             session_id="chat-b"))
        assert router.metrics.session_sticky_hits.value == 4
        outs = router.drain(timeout_s=30)
        audit_router(router)
        assert all(o.finish_reason == "length" for o in outs.values())


def test_session_pin_purged_when_replica_restarts(model):
    """A restarted replica's pool lost the session's pages: the pin is
    purged with the affinity entries, and the next turn re-pins."""
    with make_router(model, enable_prefix_cache=True) as router:
        rid = router.submit([5, 6, 7], SamplingParams(
            max_tokens=2, session_id="chat-x"))
        home = router._reqs[rid].owner_idx
        router.drain(timeout_s=30)
        assert router._sessions["chat-x"] == home
        router.kill_replica(home)
        deadline = time.monotonic() + 30
        while (router._replicas[home].status != "live"
               and time.monotonic() < deadline):
            router.supervisor.poll()
            time.sleep(0.01)
        assert "chat-x" not in router._sessions
        rid2 = router.submit([5, 6, 7], SamplingParams(
            max_tokens=2, session_id="chat-x"))
        assert router._sessions["chat-x"] == router._reqs[rid2].owner_idx
        router.drain(timeout_s=30)


def test_prefix_affinity_hit_rate_beats_random_and_matches_single(model):
    prompts = tenant_workload(20, seed=5)
    sp = SamplingParams(max_tokens=4)

    def run_router(policy):
        with make_router(model, policy=policy, enable_prefix_cache=True,
                         max_prefill_tokens_per_step=8) as router:
            for i, p in enumerate(prompts):
                router.submit(p, sp, request_id=f"p{i}")
                # tenant traffic trickles in: hits need registered pages
                router.drain(timeout_s=60) if i == len(prompts) - 1 \
                    else time.sleep(0.002)
            outs = router.drain(timeout_s=60)
            audit_router(router)
            agg = router.metrics_snapshot()["engines"]
            assert len(outs) == len(prompts)
            return agg["prefix_hit_tokens"]

    single = ServingEngine(LlamaRunner(model, BLOCK, MAXLEN), num_blocks=24,
                           max_batch_size=3, max_model_len=MAXLEN,
                           enable_prefix_cache=True,
                           max_prefill_tokens_per_step=8)
    for i, p in enumerate(prompts):
        single.add_request(p, sp, request_id=f"p{i}")
        single.step()
    single.run()
    single_hits = single.metrics.snapshot()["prefix_hit_tokens"]

    affinity_hits = run_router("prefix")
    random_hits = run_router("random")
    assert affinity_hits >= single_hits > 0
    assert affinity_hits > random_hits


def test_hot_affinity_target_sheds_to_sibling(model):
    header = list(range(1, 1 + 2 * BLOCK))
    sp = SamplingParams(max_tokens=2)
    stop = threading.Event()

    def slow_factory(idx):
        # per-call stalls stretch the decoys so queue depths stay
        # deterministic across the burst
        return FaultInjector(LlamaRunner(model, BLOCK, MAXLEN),
                             stall_every=1, stall_target="both",
                             on_stall=lambda: stop.wait(0.01))

    router = make_router(model, factory=slow_factory, max_queue_depth=2,
                         max_batch_size=1, enable_prefix_cache=True,
                         supervise=False)
    try:
        for d in ([9, 9, 9], [8, 8, 8]):
            router.submit(d, SamplingParams(max_tokens=40))
        _wait(lambda: sum(len(r.engine.scheduler.running)
                          for r in router._replicas) >= 2, 5)
        rids = [router.submit(header + [10 + k], sp) for k in range(3)]
        owners = [router._reqs[r].owner_idx for r in rids]
        assert owners[0] == owners[1]
        assert owners[2] != owners[0]
        assert router.metrics.shed_reroutes.value > 0
        assert router.metrics.tier_rejections.value == 0
        stop.set()
        outs = router.drain(timeout_s=30)
        assert len(outs) == 5
    finally:
        stop.set()
        router.shutdown()


def test_tier_queue_full_reject_and_drop_oldest(model):
    stop = threading.Event()

    def slow_factory(idx):
        return FaultInjector(LlamaRunner(model, BLOCK, MAXLEN),
                             stall_every=1, stall_target="both",
                             on_stall=lambda: stop.wait(0.05))

    sp = SamplingParams(max_tokens=2)
    router = make_router(model, factory=slow_factory, max_queue_depth=1,
                         shed_policy="reject", supervise=False,
                         max_batch_size=1, replicas=2)
    try:
        with pytest.raises(QueueFullError):
            for k in range(12):
                router.submit([1, 2, 3 + k], sp)
        assert router.metrics.tier_rejections.value >= 1
    finally:
        stop.set()
        router.shutdown()
    stop2 = threading.Event()

    def slow_factory2(idx):
        return FaultInjector(LlamaRunner(model, BLOCK, MAXLEN),
                             stall_every=1, stall_target="both",
                             on_stall=lambda: stop2.wait(0.05))

    router = make_router(model, factory=slow_factory2, max_queue_depth=1,
                         shed_policy="drop_oldest", supervise=False,
                         max_batch_size=1, replicas=2)
    try:
        rids = [router.submit([1, 2, 3 + k], sp) for k in range(10)]
        assert router.metrics.tier_overflow.value > 0
        stop2.set()
        outs = router.drain(timeout_s=30)
        audit_router(router)
        assert set(rids) == set(outs)
        reasons = {o.finish_reason for o in outs.values()}
        assert "shed" in reasons
        assert reasons <= {"shed", "length", "stop"}
    finally:
        stop2.set()
        router.shutdown()


# ---------------------------------------------- supervisor: kill / crash


def test_kill_replica_mid_run_zero_lost_token_exact(model):
    prompts = tenant_workload(12, seed=7)
    sp = SamplingParams(max_tokens=16)
    with make_router(model, enable_prefix_cache=True) as router:
        for i, p in enumerate(prompts):
            router.submit(p, sp, request_id=f"k{i}")
        _wait(lambda: router.metrics.tokens_delivered.value >= 12, 10)
        assert router.kill_replica(0)
        outs = router.drain(timeout_s=60)
        audit_router(router)
        _assert_exact(model, outs, prompts, sp)
        assert len(outs) == len(prompts)
        assert router.metrics.replica_restarts.value >= 1
        for rec in router._reqs.values():
            assert rec.cursor == len(rec.tokens)
        router.release_prefix_caches()
        assert router.check_no_leaks()


def test_kill_recovery_from_registry_alone(model):
    """snapshot_every_steps=0: the dead replica has no snapshot, so the
    supervisor rebuilds from the router registry alone."""
    prompts = tenant_workload(8, seed=9)
    sp = SamplingParams(max_tokens=12)
    with make_router(model, snapshot_every_steps=0) as router:
        for i, p in enumerate(prompts):
            router.submit(p, sp, request_id=f"k{i}")
        _wait(lambda: router.metrics.tokens_delivered.value >= 8, 10)
        router.kill_replica(1)
        outs = router.drain(timeout_s=60)
        audit_router(router)
        _assert_exact(model, outs, prompts, sp)
        assert router.metrics.resubmitted_requests.value >= 1


@pytest.mark.parametrize("target", ["decode", "prefill"])
def test_injected_replica_crash_escapes_engine_and_recovers(model, target):
    """A crash injected on a decode call, or on a prefill call, kills the
    replica; the Supervisor restores it on a fresh runner, once."""
    crashed = []

    def crash_factory(idx):
        runner = LlamaRunner(model, BLOCK, MAXLEN)
        if idx == 0 and not crashed:
            crashed.append(1)
            return FaultInjector(runner, crash_calls=[4],
                                 crash_target=target)
        return runner

    prompts = tenant_workload(10, seed=11)
    sp = SamplingParams(max_tokens=12)
    with make_router(model, factory=crash_factory) as router:
        for i, p in enumerate(prompts):
            router.submit(p, sp, request_id=f"k{i}")
        outs = router.drain(timeout_s=60)
        audit_router(router)
        _assert_exact(model, outs, prompts, sp)
        assert router.metrics.replica_crashes.value == 1
        assert router.metrics.replica_restarts.value == 1


def test_replica_crash_error_not_absorbed_by_engine_retries(model):
    """The engine's transient-failure recovery does not catch a replica
    crash: it escapes step()."""
    inj = FaultInjector(LlamaRunner(model, BLOCK, MAXLEN), crash_calls=[1],
                        crash_target="decode")
    eng = ServingEngine(inj, num_blocks=20, max_batch_size=2,
                        max_model_len=MAXLEN, max_step_retries=3,
                        retry_backoff_s=0.0)
    eng.add_request([1, 2, 3], SamplingParams(max_tokens=4))
    with pytest.raises(ReplicaCrashError):
        while eng.has_work():
            eng.step()
    assert eng.metrics.step_retries.value == 0
    assert inj.injected["crash"] == 1


def test_replica_hang_detected_and_restored(model):
    """A stall on replica 0's third decode call holds its worker; the
    router's clock (a counter that advances on every read) runs on, the
    Supervisor declares the replica hung and restores it, and the
    un-hung zombie, released afterwards, stays fenced."""
    ticks = itertools.count()
    stalled, release = threading.Event(), threading.Event()

    def on_stall():
        stalled.set()
        release.wait(30)

    made = []

    def stall_factory(idx):
        runner = LlamaRunner(model, BLOCK, MAXLEN)
        if idx == 0 and not made:
            made.append(1)
            return FaultInjector(runner, stall_calls=[3],
                                 stall_target="decode", on_stall=on_stall)
        return runner

    prompts = tenant_workload(10, seed=13)
    sp = SamplingParams(max_tokens=12)
    router = make_router(model, factory=stall_factory,
                         heartbeat_timeout_s=1.0,
                         clock=lambda: next(ticks) * 0.01)
    try:
        for i, p in enumerate(prompts):
            router.submit(p, sp, request_id=f"k{i}")
        assert stalled.wait(30)
        _wait(lambda: router.metrics.replica_hangs.value >= 1, 60)
        zombie = [t for t in threading.enumerate()
                  if t.name.startswith("serving-router-r0e")]
        release.set()
        outs = router.drain(timeout_s=60)
        audit_router(router)
        _assert_exact(model, outs, prompts, sp)
        assert router.metrics.replica_restarts.value >= 1
        for t in zombie:
            t.join(30)
        audit_router(router)
        for i, p in enumerate(prompts):
            assert outs[f"k{i}"].output_tokens == oracle(model, p, sp)
    finally:
        release.set()
        router.shutdown()


def test_redistribution_spreads_dead_replicas_backlog(model):
    header = list(range(1, 1 + 2 * BLOCK))
    sp = SamplingParams(max_tokens=6)
    with make_router(model, replicas=3, max_batch_size=2,
                     enable_prefix_cache=True) as router:
        rids = [router.submit(header + [10 + k], sp,
                              request_id=f"k{k}") for k in range(12)]
        home = router._reqs[rids[0]].owner_idx
        assert all(router._reqs[r].owner_idx == home for r in rids)
        router.kill_replica(home)
        outs = router.drain(timeout_s=60)
        audit_router(router)
        assert len(outs) == 12
        assert router.metrics.redistributed_requests.value > 0
        assert len({o.replica for o in outs.values()}) > 1
        prompts = [header + [10 + k] for k in range(12)]
        _assert_exact(model, outs, prompts, sp)


# ------------------------------------------------- at-most-once delivery


def test_stale_replay_is_deduplicated(model):
    """A retired execution re-saying delivered history is dropped by the
    cursor, token by token; a fenced replica delivers nothing."""
    with make_router(model, replicas=1, supervise=False) as router:
        rid = router.submit([1, 2, 3, 4, 5], SamplingParams(max_tokens=6))
        router.drain(timeout_s=30)
        rec = router._reqs[rid]
        before = list(rec.tokens)
        rep = router._replicas[0]
        replay = [TokenEvent(rid, t, i) for i, t in enumerate(before)]
        with rep.lock:
            router._deliver(rep, rep.epoch, replay)
        assert rec.tokens == before
        assert router.metrics.duplicate_tokens_dropped.value == 0
        rec.done = False
        with rep.lock:
            router._deliver(rep, rep.epoch, replay)
        rec.done = True
        assert rec.tokens == before
        assert router.metrics.duplicate_tokens_dropped.value == len(before)
        rep.fenced = True
        with rep.lock:
            router._deliver(rep, rep.epoch,
                            [TokenEvent(rid, 9, len(before))])
        assert rec.tokens == before


def test_abort_through_router(model):
    stop = threading.Event()

    def slow_factory(idx):
        return FaultInjector(LlamaRunner(model, BLOCK, MAXLEN),
                             stall_every=1, stall_target="both",
                             on_stall=lambda: stop.wait(0.03))

    with make_router(model, factory=slow_factory, supervise=False) as router:
        rid = router.submit([1, 2, 3], SamplingParams(max_tokens=50))
        assert router.abort(rid)
        stop.set()
        outs = router.drain(timeout_s=30)
        assert outs[rid].finish_reason == "aborted"
        assert not router.abort(rid)
        assert not router.abort("nope")


# -------------------------------------------------------- fuzz the tier


def test_tier_backpressure_and_kill_fuzz(model):
    """Random arrivals over small pools and bounded queues, a replica kill
    mid-trial on odd seeds: every request ends with an explicit reason,
    nothing lost or duplicated, audits green, no leaked page."""
    for seed in range(6):
        rng = np.random.default_rng(200 + seed)
        with make_router(model, replicas=int(rng.integers(2, 4)),
                         num_blocks=int(rng.integers(14, 24)),
                         max_batch_size=int(rng.integers(2, 4)),
                         max_queue_depth=int(rng.integers(2, 5)),
                         shed_policy="drop_oldest",
                         enable_prefix_cache=bool(seed % 2),
                         max_prefill_tokens_per_step=(
                             int(rng.integers(4, 12)) if seed % 3 else None),
                         ) as router:
            n = int(rng.integers(8, 16))
            rids = []
            for _ in range(n):
                plen = int(rng.integers(2, 12))
                rids.append(router.submit(
                    list(map(int, rng.integers(1, VOCAB, plen))),
                    SamplingParams(max_tokens=int(rng.integers(2, 10)))))
                if rng.random() < 0.2:
                    time.sleep(0.002)
            if seed % 2:
                router.kill_replica(int(rng.integers(
                    len(router._replicas))))
            outs = router.drain(timeout_s=60)
            audit_router(router)
            assert set(outs) == set(rids), f"seed {seed}: lost requests"
            assert all(o.finish_reason for o in outs.values())
            for rec in router._reqs.values():
                assert rec.cursor == len(rec.tokens)
            router.release_prefix_caches()
            assert router.check_no_leaks(), f"seed {seed}: leaked pages"


# --------------------------------------------------------------- metrics


def test_metrics_aggregation(model):
    snaps = [EngineMetrics().snapshot() for _ in range(2)]
    snaps[0]["tokens_generated"] = 10.0
    snaps[1]["tokens_generated"] = 6.0
    snaps[0]["decode_steps"] = 5.0
    snaps[1]["decode_steps"] = 3.0
    snaps[0]["busy_seconds"] = 2.0
    snaps[1]["busy_seconds"] = 4.0
    agg = aggregate_snapshots(snaps)
    assert agg["tokens_generated"] == 16.0
    assert agg["decode_steps"] == 8.0
    assert agg["busy_seconds"] == 4.0         # replicas run concurrently
    assert agg["steps_per_token"] == 0.5
    assert agg["tokens_per_sec"] == 4.0
    assert "ttft_s_p99" not in agg            # percentiles don't merge

    with make_router(model, supervise=False) as router:
        router.submit([1, 2, 3], SamplingParams(max_tokens=3))
        router.drain(timeout_s=30)
        snap = router.metrics_snapshot()
        assert snap["router"]["requests_completed"] == 1.0
        assert snap["engines"]["tokens_generated"] == 3.0
        assert len(snap["per_replica"]) == 2


def test_aggregate_snapshots_equals_the_jax_function(model):
    """The same snapshot dicts (two real engine snapshots, one with the
    handoff counters moved, and a random one) aggregate to the same dict
    in both packages."""
    eng = ServingEngine(LlamaRunner(model, BLOCK, MAXLEN), num_blocks=24,
                        max_batch_size=2, max_model_len=MAXLEN,
                        host_tier_pages=8)
    for p in tenant_workload(3, seed=2):
        eng.add_request(p, SamplingParams(max_tokens=4))
    eng.run()
    real = eng.metrics.snapshot()
    moved = dict(real, handoffs_out=3.0, handoff_pages_in=7.0,
                 handoff_bytes_out=4096.0)
    rng = np.random.default_rng(3)
    rand = {k: float(rng.integers(0, 100)) for k in real}
    for snaps in ([real, moved], [real, moved, rand], []):
        assert aggregate_snapshots(snaps) == jax_aggregate_snapshots(snaps)
