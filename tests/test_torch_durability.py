"""The port's tier durability against the JAX package, on the CPU: the
write-ahead journal, `ServingRouter.recover`, graceful drain and rolling
restart.

Ports the thread-backend pins of tests/test_serving_durability.py (its
wire, RPC-deadline, shutdown and process cases are in
tests/test_torch_wire.py and tests/test_torch_procs.py): a
router death loses nothing the journal saw (recover() resumes every
in-flight request token-exact with none lost or duplicated, at any
journal truncation offset), and a drained or rolling-restarted tier keeps
every stream exact while its replicas cycle one at a time. Across the
frameworks: `sampling_to_dict` / `sampling_from_dict` round-trip to the
JAX dicts, a journal the port writes replays in the JAX `RouterJournal`
to the same state and the reverse (records, a router's run, a torn tail),
and the port's router recovers from a journal the JAX router wrote.

The replicas serve a small Llama (2 layers, width 64); every router is
shut down and its threads joined.
"""

import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.serving import LlamaRunner as JaxLlamaRunner
from paddle_tpu.serving import RouterJournal as JaxRouterJournal
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingRouter as JaxServingRouter
from paddle_tpu.serving import wire as jax_wire
from _step_gate import StepGate
from paddle_tpu_torch.models import Llama, LlamaConfig
from paddle_tpu_torch.serving import (
    LlamaRunner, RouterJournal, SamplingParams, ServingRouter, audit_router,
    naive_generate,
)
from paddle_tpu_torch.serving import wire
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

VOCAB, BLOCK, MAXLEN = 97, 4, 64
SIZES = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=MAXLEN)
ENGINE_KW = dict(num_blocks=24, max_batch_size=4, max_model_len=MAXLEN,
                 enable_prefix_cache=True, max_prefill_tokens_per_step=8)
TIER_KW = dict(heartbeat_timeout_s=60.0, poll_interval_s=0.05)


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
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


def workload(n=12, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = list(map(int, rng.integers(1, VOCAB,
                                            int(rng.integers(4, 16)))))
        sp = SamplingParams(
            max_tokens=int(rng.integers(3, 8)),
            temperature=0.5 if i % 3 == 0 else 0.0,
            seed=100 + i if i % 3 == 0 else None)
        out.append((prompt, sp))
    return out


def _wait_tokens(router, n, timeout_s=30.0):
    import time
    deadline = time.monotonic() + timeout_s
    while (router.metrics.tokens_delivered.value < n
           and time.monotonic() < deadline):
        time.sleep(0.001)


# --------------------------------------------------------- journal unit


class TestJournal:
    def test_append_replay_roundtrip(self, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        j = RouterJournal(jp, fsync="never", compact_every=10_000)
        sp = SamplingParams(max_tokens=5)
        j.append({"t": "sub", "rid": "a", "prompt": [1, 2],
                  "sampling": wire.sampling_to_dict(sp), "rep": 0,
                  "epoch": 0, "ai": 0})
        j.append({"t": "tok", "d": {"a": [7, 8]}})
        j.append({"t": "own", "rid": "a", "rep": 1})
        j.append({"t": "snap", "rep": 1, "snapshot": {"k": "v"}})
        j.append({"t": "tok", "d": {"a": [9]}})
        j.append({"t": "fin", "rid": "a", "reason": "length"})
        j.close()
        state, discarded = RouterJournal.replay(jp)
        assert discarded == 0
        r = state["reqs"]["a"]
        assert r["tokens"] == [7, 8, 9]
        assert r["done"] and r["reason"] == "length"
        assert r["owner"] == 1 and r["ai"] == 0
        assert state["snaps"][1] == {"k": "v"}

    def test_fin_before_final_tok_record(self, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        j = RouterJournal(jp, fsync="never")
        j.append({"t": "sub", "rid": "a", "prompt": [1],
                  "sampling": wire.sampling_to_dict(SamplingParams()),
                  "rep": 0, "epoch": 0, "ai": 0})
        j.append({"t": "fin", "rid": "a", "reason": "length"})
        j.append({"t": "tok", "d": {"a": [3, 4]}})
        j.close()
        state, _ = RouterJournal.replay(jp)
        assert state["reqs"]["a"]["tokens"] == [3, 4]
        assert state["reqs"]["a"]["done"]

    def test_compaction_preserves_state_and_bounds_file(self, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        j = RouterJournal(jp, fsync="never", compact_every=5)
        sp = wire.sampling_to_dict(SamplingParams(max_tokens=3))
        for i in range(4):
            j.append({"t": "sub", "rid": f"r{i}", "prompt": [i],
                      "sampling": sp, "rep": 0, "epoch": 0, "ai": i})
        for k in range(20):
            j.append({"t": "tok", "d": {f"r{k % 4}": [k]}})
        assert j.compactions >= 3
        j.close()
        with open(jp) as f:
            lines = [ln for ln in f.read().split("\n") if ln]
        assert len(lines) <= 6
        state, _ = RouterJournal.replay(jp)
        assert sorted(state["reqs"]) == ["r0", "r1", "r2", "r3"]
        assert state["reqs"]["r0"]["tokens"] == [0, 4, 8, 12, 16]

    def test_torn_tail_discarded(self, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        j = RouterJournal(jp, fsync="never")
        sp = wire.sampling_to_dict(SamplingParams())
        j.append({"t": "sub", "rid": "a", "prompt": [1], "sampling": sp,
                  "rep": 0, "epoch": 0, "ai": 0})
        j.append({"t": "tok", "d": {"a": [5]}})
        j.close()
        with open(jp, "a") as f:         # torn mid-append, no newline
            f.write('deadbeef {"t": "tok", "d": {"a": [6')
        state, discarded = RouterJournal.replay(jp)
        assert discarded == 1
        assert state["reqs"]["a"]["tokens"] == [5]

    def test_corrupt_line_stops_replay(self, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        j = RouterJournal(jp, fsync="never")
        sp = wire.sampling_to_dict(SamplingParams())
        j.append({"t": "sub", "rid": "a", "prompt": [1], "sampling": sp,
                  "rep": 0, "epoch": 0, "ai": 0})
        j.append({"t": "tok", "d": {"a": [5]}})
        j.append({"t": "tok", "d": {"a": [6]}})
        j.close()
        with open(jp) as f:
            lines = f.read().split("\n")
        lines[2] = lines[2][:12] + ("X" if lines[2][12] != "X" else "Y") \
            + lines[2][13:]
        with open(jp, "w") as f:
            f.write("\n".join(lines))
        state, discarded = RouterJournal.replay(jp)
        assert discarded == 1
        assert state["reqs"]["a"]["tokens"] == [5]

    def test_fsync_policy_validated(self, tmp_path):
        with pytest.raises(ValueError, match="fsync"):
            RouterJournal(str(tmp_path / "x"), fsync="sometimes")
        for pol in ("always", "interval", "never"):
            j = RouterJournal(str(tmp_path / pol), fsync=pol)
            j.append({"t": "fin", "rid": "z", "reason": "stop"})
            j.close()
        assert RouterJournal(
            str(tmp_path / "always"), fsync="always").fsync == "always"


# ------------------------------------------------- across the packages


SAMPLINGS = [SamplingParams(), SamplingParams(
    max_tokens=7, temperature=0.7, top_k=5, top_p=0.9, seed=3,
    stop_token_ids=(4, 9), timeout_s=2.5, session_id="chat",
    kv_dtype="fp8")]


@pytest.mark.parametrize("i", range(len(SAMPLINGS)))
def test_sampling_dicts_round_trip_as_the_jax_ones(i):
    sp = SAMPLINGS[i]
    d = wire.sampling_to_dict(sp)
    jsp = JaxSamplingParams(**{**d, "stop_token_ids":
                               tuple(d["stop_token_ids"])})
    assert d == jax_wire.sampling_to_dict(jsp)
    assert json.loads(json.dumps(d)) == d
    assert wire.sampling_from_dict(d) == sp
    assert wire.sampling_to_dict(wire.sampling_from_dict(
        jax_wire.sampling_to_dict(jsp))) == d
    assert jax_wire.sampling_from_dict(d) == jsp


def _records():
    sp = wire.sampling_to_dict(SAMPLINGS[1])
    return [{"t": "sub", "rid": "a", "prompt": [1, 2], "sampling": sp,
             "rep": 0, "epoch": 0, "ai": 3},
            {"t": "sub", "rid": "b", "prompt": [5], "sampling": sp,
             "rep": 1, "epoch": 1, "ai": 4},
            {"t": "tok", "d": {"a": [7, 8], "b": [1]}},
            {"t": "own", "rid": "b", "rep": 0},
            {"t": "snap", "rep": 0, "snapshot": {"version": 1}},
            {"t": "fin", "rid": "a", "reason": "stop"},
            {"t": "tok", "d": {"b": [2, 3]}}]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("compact_every", [3, 10_000])
def test_journal_replays_to_the_same_state_in_both_packages(
        tmp_path, writer, compact_every):
    """Records written by one package (compacted mid-stream or not, with a
    torn tail) replay to the same state and discard count in both."""
    jp = str(tmp_path / "j.jsonl")
    Journal = RouterJournal if writer == "port" else JaxRouterJournal
    j = Journal(jp, fsync="never", compact_every=compact_every)
    for rec in _records():
        j.append(rec)
    j.close()
    with open(jp, "a") as f:
        f.write('00000000 {"t": "tok"')
    ours = RouterJournal.replay(jp)
    ref = JaxRouterJournal.replay(jp)
    assert ours == ref
    assert ours[1] == 1 and ours[0]["reqs"]["b"]["tokens"] == [1, 2, 3]
    with open(jp, "rb") as f:
        raw = f.read()
    other = str(tmp_path / "other.jsonl")
    Other = JaxRouterJournal if writer == "port" else RouterJournal
    j = Other(other, fsync="never", compact_every=compact_every)
    for rec in _records():
        j.append(rec)
    j.close()
    with open(other, "rb") as f:
        # byte for byte the same journal from both writers
        assert f.read() == raw[:raw.rindex(b"\n") + 1]


def test_router_journal_replays_the_same_in_jax(tmp_path, model):
    """A journal the port's router writes over a real run (submits,
    token batches, finishes, snapshots, compaction) replays in the JAX
    RouterJournal to the state the port's replay gives."""
    jp = str(tmp_path / "wal.jsonl")
    router = ServingRouter(factory_of(model), replicas=2, journal_path=jp,
                           journal_compact_every=40, snapshot_every_steps=2,
                           **TIER_KW, **ENGINE_KW)
    try:
        for p, sp in workload(6, seed=12):
            router.submit(p, sp)
        router.drain(timeout_s=60.0)
    finally:
        router.shutdown()
    ours, ref = RouterJournal.replay(jp), JaxRouterJournal.replay(jp)
    assert ours == ref
    assert len(ours[0]["reqs"]) == 6 and ours[0]["snaps"]


def test_port_router_recovers_a_jax_router_journal(tmp_path, pair):
    """The JAX router serves the traffic halfway on the JAX Llama and
    dies (fenced, its journal closed); the port's router recovers from
    that journal on the same weights: every stream is the uninterrupted
    one, none lost."""
    jm, pm = pair
    jp = str(tmp_path / "wal.jsonl")
    work = workload(8, seed=15)
    jrouter = JaxServingRouter(
        lambda idx=0: JaxLlamaRunner(jm, BLOCK, MAXLEN, "reference"),
        replicas=2, journal_path=jp, snapshot_every_steps=0,
        **TIER_KW, **ENGINE_KW)
    try:
        rids = [jrouter.submit(p, JaxSamplingParams(
            **wire.sampling_to_dict(sp) | {"stop_token_ids": ()}))
            for p, sp in work]
        _wait_tokens(jrouter, 10, 120.0)
        _crash_router(jrouter)
    finally:
        jrouter.shutdown()
    router = ServingRouter.recover(factory_of(pm), jp, replicas=2,
                                   snapshot_every_steps=0, **TIER_KW,
                                   **ENGINE_KW)
    try:
        outs = router.drain(timeout_s=60.0)
        audit_router(router)
        assert len(outs) == len(rids)
        for rid, (p, sp) in zip(rids, work):
            assert outs[rid].output_tokens == oracle(pm, p, sp), rid
    finally:
        router.shutdown()


# ------------------------------------- drain / rolling restart (thread)


class TestDrainRollingRestart:
    def _router(self, model, replicas=2, **kw):
        merged = dict(ENGINE_KW)
        merged.update(kw)
        return ServingRouter(factory_of(model), replicas=replicas,
                             **TIER_KW, **merged)

    def test_drain_replica_migrates_and_stays_token_exact(self, model):
        """Greedy and seeded streams survive a mid-run drain with the
        host tier on: running requests ride the KV handoff, queued ones
        extract / inject."""
        router = self._router(model, replicas=2, host_tier_pages=64)
        try:
            work = workload(12)
            rids = [router.submit(p, sp) for p, sp in work]
            _wait_tokens(router, 6)
            moved = router.drain_replica(0)
            assert router._replicas[0].status == "drained"
            outs = router.drain(timeout_s=60.0)
            audit_router(router)
            for rid, (p, sp) in zip(rids, work):
                assert outs[rid].output_tokens == oracle(model, p, sp), rid
            m = router.metrics.snapshot()
            assert m["replica_drains"] == 1
            assert m["drain_migrations"] == moved
            assert m["duplicate_tokens_dropped"] == 0
            router.release_prefix_caches()
            assert router.check_no_leaks()
        finally:
            router.shutdown()

    def test_drain_moves_running_requests_with_their_pages(self, model):
        """A drain stages each running decode-phase request
        (stage_migration) and its pages ride to the sibling: handoffs in,
        pages paged in, no recompute of a handed-off request."""
        router = ServingRouter(
            lambda idx=0: LlamaRunner(model, BLOCK, MAXLEN), replicas=2,
            host_tier_pages=64, **TIER_KW, **ENGINE_KW)
        try:
            work = [(list(range(1 + k, 13 + k)), SamplingParams(
                max_tokens=24)) for k in range(4)]
            # replica 0 steps only when the test lets it: after each step
            # the test reads its running set, and drains it before the
            # replica can take another step
            rep = router._replicas[0]
            gate = StepGate(rep)
            gate.close()
            rids = [router.submit(p, sp, request_id=f"m{k}")
                    for k, (p, sp) in enumerate(work)]
            deadline = time.monotonic() + 60
            while True:
                gate.step_once()
                with rep.lock:
                    running = [r.request_id for r in
                               rep.engine.scheduler.running
                               if r.output_tokens]
                if running:
                    break
                assert time.monotonic() < deadline, "replica 0 never decoded"
            router.drain_replica(0)
            gate.open()
            outs = router.drain(timeout_s=60.0)
            audit_router(router)
            for rid, (p, sp) in zip(rids, work):
                assert outs[rid].output_tokens == oracle(model, p, sp)
            eng = router.metrics_snapshot()["engines"]
            assert eng["handoffs_in"] >= len(running)
            assert eng["handoff_pages_in"] > 0
            assert eng["handoff_recompute_fallbacks"] == 0
        finally:
            router.shutdown()

    def test_drained_replica_receives_no_new_traffic(self, model):
        router = self._router(model, replicas=2)
        try:
            router.drain_replica(0)
            rids = [router.submit(p, sp) for p, sp in workload(6)]
            with router._lock:
                owners = {router._reqs[r].owner_idx for r in rids}
            assert owners == {1}
            router.drain(timeout_s=60.0)
        finally:
            router.shutdown()

    def test_restart_replica_comes_back_live_and_serves(self, model):
        router = self._router(model, replicas=2)
        try:
            router.drain_replica(0)
            rep = router.restart_replica(0)
            assert rep.status == "live" and rep.epoch > 0
            work = workload(8, seed=5)
            rids = [router.submit(p, sp) for p, sp in work]
            outs = router.drain(timeout_s=60.0)
            audit_router(router)
            for rid, (p, sp) in zip(rids, work):
                assert outs[rid].output_tokens == oracle(model, p, sp)
            assert {o.replica for o in outs.values()} == {0, 1}
        finally:
            router.shutdown()

    def test_rolling_restart_three_replicas_token_exact(self, model):
        """rolling_restart() across a 3-replica tier mid-stream: none lost
        or duplicated, greedy and seeded streams exact."""
        router = self._router(model, replicas=3, host_tier_pages=64)
        try:
            work = workload(14)
            rids = [router.submit(p, sp) for p, sp in work]
            _wait_tokens(router, 8)
            assert router.rolling_restart() == 3
            outs = router.drain(timeout_s=120.0)
            audit_router(router)
            for rid, (p, sp) in zip(rids, work):
                assert outs[rid].output_tokens == oracle(model, p, sp), rid
            m = router.metrics.snapshot()
            assert m["replica_drains"] == 3
            assert m["rolling_restarts"] == 1
            assert m["duplicate_tokens_dropped"] == 0
            assert len(outs) == len(rids)
            assert all(r.status == "live" for r in router._replicas)
            router.release_prefix_caches()
            assert router.check_no_leaks()
        finally:
            router.shutdown()

    def test_single_replica_drain_backfills_on_restart(self, model):
        """No live sibling: the drained requests wait in the registry and
        restart_replica's backfill resumes them token-exact."""
        router = self._router(model, replicas=1)
        try:
            work = workload(6, seed=2)
            rids = [router.submit(p, sp) for p, sp in work]
            _wait_tokens(router, 3)
            router.drain_replica(0)
            assert router.has_work()
            router.restart_replica(0)
            outs = router.drain(timeout_s=60.0)
            audit_router(router)
            for rid, (p, sp) in zip(rids, work):
                assert outs[rid].output_tokens == oracle(model, p, sp)
        finally:
            router.shutdown()


# ------------------------------------------- router recovery (journal)


def _crash_router(router):
    """The in-process equivalent of killing the router: fence every worker
    mid-flight (their tokens are discarded, as a dead process's would
    be), stop the supervisor, close the journal file."""
    for rep in router._replicas:
        rep.fenced = True
        rep.stop = True
        rep.wake.set()
    if router.supervisor is not None:
        router.supervisor.stop()
    router._journal.close()


class TestRouterRecover:
    def test_drain_returns_only_once_its_records_are_journaled(
            self, model, tmp_path, monkeypatch):
        """A step's tokens and finishes reach the registry before the
        worker journals them: drain() must not return in between, or a
        crash right after it loses finished requests (each journal append
        slowed here, so the worker is caught between the two)."""
        import time as _time
        append = RouterJournal.append

        def slow_append(journal, rec):
            if rec.get("t") in ("tok", "fin"):
                _time.sleep(0.05)
            return append(journal, rec)

        monkeypatch.setattr(RouterJournal, "append", slow_append)
        work = workload(4, seed=4)
        jp = str(tmp_path / "wal.jsonl")
        router = ServingRouter(factory_of(model), replicas=2,
                               journal_path=jp, **TIER_KW, **ENGINE_KW)
        rids = [router.submit(p, sp) for p, sp in work]
        router.drain(timeout_s=60.0)
        _crash_router(router)
        router.shutdown()
        state, _ = RouterJournal.replay(jp)
        assert all(state["reqs"][rid]["done"] for rid in rids)
        for rid, (p, sp) in zip(rids, work):
            assert state["reqs"][rid]["tokens"] == oracle(model, p, sp)

    def _run_and_crash(self, model, tmp_path, bar, work, snapshot_every=2):
        jp = str(tmp_path / "wal.jsonl")
        router = ServingRouter(factory_of(model), replicas=2,
                               journal_path=jp,
                               snapshot_every_steps=snapshot_every,
                               **TIER_KW, **ENGINE_KW)
        rids = [router.submit(p, sp) for p, sp in work]
        _wait_tokens(router, bar)
        _crash_router(router)
        router.shutdown()
        return jp, rids

    @pytest.mark.parametrize("bar", [4, 16, 30])
    def test_recover_mid_stream_token_exact(self, model, tmp_path, bar):
        """The router killed mid-stream at several depths: recover()
        resumes every in-flight request token-exact, none lost or
        duplicated."""
        work = workload(12)
        jp, rids = self._run_and_crash(model, tmp_path, bar, work)
        router = ServingRouter.recover(
            factory_of(model), jp, replicas=2, snapshot_every_steps=2,
            **TIER_KW, **ENGINE_KW)
        try:
            outs = router.drain(timeout_s=60.0)
            audit_router(router)
            assert len(outs) == len(rids)
            for rid, (p, sp) in zip(rids, work):
                assert outs[rid].output_tokens == oracle(model, p, sp), rid
            router.release_prefix_caches()
            assert router.check_no_leaks()
        finally:
            router.shutdown()

    def test_recover_without_snapshots_registry_only(self, model, tmp_path):
        work = workload(10, seed=3)
        jp, rids = self._run_and_crash(model, tmp_path, 8, work,
                                       snapshot_every=0)
        state, _ = RouterJournal.replay(jp)
        assert state["snaps"] == {}
        router = ServingRouter.recover(
            factory_of(model), jp, replicas=2, snapshot_every_steps=0,
            **TIER_KW, **ENGINE_KW)
        try:
            outs = router.drain(timeout_s=60.0)
            audit_router(router)
            for rid, (p, sp) in zip(rids, work):
                assert outs[rid].output_tokens == oracle(model, p, sp)
            assert router.metrics.snapshot()["recovered_requests"] >= 1
        finally:
            router.shutdown()

    def test_recover_restores_finished_outputs_and_new_ids(self, model,
                                                          tmp_path):
        work = workload(6, seed=4)
        jp = str(tmp_path / "wal.jsonl")
        router = ServingRouter(factory_of(model), replicas=2,
                               journal_path=jp, **TIER_KW, **ENGINE_KW)
        rids = [router.submit(p, sp) for p, sp in work]
        router.drain(timeout_s=60.0)
        _crash_router(router)
        router.shutdown()
        r2 = ServingRouter.recover(factory_of(model), jp, replicas=2,
                                   **TIER_KW, **ENGINE_KW)
        try:
            outs = r2.outputs()
            for rid, (p, sp) in zip(rids, work):
                assert outs[rid].output_tokens == oracle(model, p, sp)
            p2, sp2 = workload(1, seed=9)[0]
            new_rid = r2.submit(p2, sp2)
            assert new_rid not in rids
            assert r2.drain(timeout_s=30.0)[new_rid].output_tokens \
                == oracle(model, p2, sp2)
        finally:
            r2.shutdown()

    def test_recover_fin_cut_after_final_tok(self, model, tmp_path):
        """A journal cut between a request's last token batch and its fin
        record: recovery finishes it in place (reason 'length'), never
        decodes an extra token."""
        p, sp = [3, 1, 4, 1, 5], SamplingParams(max_tokens=4)
        ref = oracle(model, p, sp)
        assert len(ref) == 4
        jp = str(tmp_path / "wal.jsonl")
        j = RouterJournal(jp, fsync="never")
        j.append({"t": "sub", "rid": "cut", "prompt": p,
                  "sampling": wire.sampling_to_dict(sp), "rep": 0,
                  "epoch": 0, "ai": 0})
        j.append({"t": "tok", "d": {"cut": ref}})
        j.close()
        router = ServingRouter.recover(factory_of(model), jp, replicas=2,
                                       **TIER_KW, **ENGINE_KW)
        try:
            outs = router.drain(timeout_s=30.0)
            assert outs["cut"].output_tokens == ref
            assert outs["cut"].finish_reason == "length"
        finally:
            router.shutdown()

    def test_recover_fuzz_random_journal_offsets(self, model, tmp_path):
        """The router killed at random journal offsets (the journal cut at
        arbitrary bytes): every request whose submit record survived
        finishes token-exact under audit_router."""
        work = workload(10, seed=6)
        jp = str(tmp_path / "wal.jsonl")
        router = ServingRouter(factory_of(model), replicas=2,
                               journal_path=jp,
                               journal_compact_every=10_000,
                               snapshot_every_steps=2, **TIER_KW,
                               **ENGINE_KW)
        rids = [router.submit(p, sp) for p, sp in work]
        router.drain(timeout_s=60.0)
        _crash_router(router)
        router.shutdown()
        raw = open(jp, "rb").read()
        rng = np.random.default_rng(7)
        offsets = sorted({int(x) for x in rng.integers(1, len(raw), 5)})
        for off in offsets:
            jcut = str(tmp_path / f"cut{off}.jsonl")
            with open(jcut, "wb") as f:
                f.write(raw[:off])
            state, _ = RouterJournal.replay(jcut)
            known = set(state["reqs"])
            r2 = ServingRouter.recover(factory_of(model), jcut, replicas=2,
                                       **TIER_KW, **ENGINE_KW)
            try:
                outs = r2.drain(timeout_s=60.0)
                audit_router(r2)
                for rid, (p, sp) in zip(rids, work):
                    if rid in known:
                        assert outs[rid].output_tokens == \
                            oracle(model, p, sp), (off, rid)
                r2.release_prefix_caches()
                assert r2.check_no_leaks()
            finally:
                r2.shutdown()

    def test_journal_stats_ride_metrics_snapshot(self, model, tmp_path):
        jp = str(tmp_path / "wal.jsonl")
        router = ServingRouter(factory_of(model), replicas=1,
                               journal_path=jp, **TIER_KW, **ENGINE_KW)
        try:
            router.submit([1, 2, 3], SamplingParams(max_tokens=3))
            router.drain(timeout_s=30.0)
            snap = router.metrics_snapshot()
            assert snap["journal"]["journal_records"] >= 2
            assert snap["journal"]["journal_bytes"] > 0
        finally:
            router.shutdown()
