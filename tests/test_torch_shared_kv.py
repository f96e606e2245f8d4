"""The port's host-wide KV store (`SharedKVStore`) against the JAX package,
on the CPU.

Ports the pins of tests/test_serving_shared_kv.py: one content-addressed
page store under every engine's host tier. Spills and prefix demotions
from any engine publish into it (a second spill of a resident chain is a
ref, not a copy), admission on any engine resolves its prefix chain
against it and pages the bytes in, and a handoff moves slot references
instead of page bytes. Token streams do not change: fp32 equals
`naive_generate`, an int8 migration restores the exact codes and scale
rows. Ownership is refcount arithmetic audited tier-wide: a dead replica's
refs are reaped, generations invalidate stale references, and a rotating
CRC spot check catches corrupted bytes before they serve.

Then the pins across the two packages: `layout_for` gives the JAX list
(dtype names included), the same seeded sequence of store operations
leaves both stores in the same state at every step (refcounts, free
lists, generations, evictions, `content_hash`, `journal_state`), and a
client of either package works against the other's `StoreServer` over
one shared-memory store. And the hazards of a machine without the JAX
package: a fresh interpreter importing only the port maps fp8 and bf16
stores without `ml_dtypes`, and a SIGKILLed child that held an attach
leaves the segment to its owner. A process tier hands off by slot
reference with no page byte on the wire.

Engines run `_torch_stub.TorchStubRunner` under the invariant auditor;
children get `CUDA_VISIBLE_DEVICES=""` and `OMP_NUM_THREADS=1`; no
segment a test made is left under /dev/shm (an autouse check).
"""

import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from _torch_stub import TorchStubRunner
from paddle_tpu_torch.serving import (
    InvariantViolation, KVCachePool, SamplingParams, ServingEngine,
    ServingRouter, SharedKVStore, SharedKVStoreClient, StoreServer,
    audit_engine, audit_router, audit_store, naive_generate,
)
from paddle_tpu_torch.serving.kv_cache import _CHAIN_SEED, page_content_hash

torch.set_num_threads(1)

VOCAB, BLOCK, MAXLEN = 31, 4, 48
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS_DIR)
SHM = "/dev/shm"


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


def _exists(name):
    return os.path.exists(os.path.join(SHM, name.lstrip("/")))


@pytest.fixture(autouse=True)
def _no_segment_left(monkeypatch):
    """Every segment this process makes during a test is unlinked by its
    end (segments of other processes, test workers running beside this
    one included, are none of its business)."""
    from multiprocessing import shared_memory
    made = []
    real = shared_memory.SharedMemory.__init__

    def init(self, name=None, create=False, size=0, *a, **kw):
        real(self, name, create, size, *a, **kw)
        if create:
            made.append(self.name)
    monkeypatch.setattr(shared_memory.SharedMemory, "__init__", init)
    yield made
    left = [n for n in made if _exists(n)]
    for name in left:
        os.unlink(os.path.join(SHM, name.lstrip("/")))
    assert not left, f"segments left under {SHM}: {sorted(left)}"


def _runner(cls=TorchStubRunner):
    return cls(vocab_size=VOCAB, block_size=BLOCK, max_model_len=MAXLEN)


def _store(pages=64, **kw):
    return SharedKVStore.for_runner(_runner(), pages, **kw)


def _engine(store, owner, num_blocks=24, max_batch=4, runner=None, **kw):
    kw.setdefault("enable_prefix_cache", True)
    return ServingEngine(runner or _runner(), num_blocks=num_blocks,
                         max_batch_size=max_batch, max_model_len=MAXLEN,
                         kv_store=store, kv_store_owner=owner, **kw)


def _oracle(prompt, sp, runner=None):
    return naive_generate(runner or _runner(), prompt, sp,
                          max_model_len=MAXLEN)


def _pump(eng, cond, limit=500):
    for _ in range(limit):
        if cond():
            return
        eng.step()
    raise AssertionError("condition never reached "
                         f"(queue={eng.scheduler.queue_depth}, "
                         f"running={len(eng.scheduler.running)})")


class Int8StubRunner(TorchStubRunner):
    """The stub over an int8 pool: four arrays a layer (codes and scale
    rows); the stub writes token ids as codes (ids < 127), and the scale
    rows must survive every transfer verbatim."""

    kv_dtype = "int8"


def _child_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PADDLE_TPU_SERVING_AUDIT="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, TESTS_DIR] + ([env["PYTHONPATH"]]
                             if env.get("PYTHONPATH") else []))
    return env


# ------------------------------------------------------ store units


def test_store_refcount_dedup_units():
    st = _store(8)
    a = st.alloc(3, "e0")
    assert a == [0, 1, 2] and st.free_count == 5
    st.set_hash(a[0], 0xAB)
    assert st.index_prefix(111, a[0])
    assert st.refcount(a[0]) == 2
    assert not st.index_prefix(111, a[1])          # a dedup, not a copy
    assert st.stats()["store_dedup_pages"] == 1
    assert st.acquire_prefix(111, "e1") == a[0]
    assert st.refcount(a[0]) == 3
    st.release(a, "e0")
    st.release([a[0]], "e1")
    assert st.refcount(a[0]) == 1 and not st.has_prefix(999)
    assert st.free_count == 7
    g = st.generation(a[0])
    assert st.drop_prefix(111)
    assert st.free_count == 8 and st.generation(a[0]) == g + 1
    with pytest.raises(ValueError):
        st.release([a[0]], "e0")                   # the double-free guard


def test_store_retag_reap_and_lru_eviction():
    st = _store(4)
    a = st.alloc(2, "e0")
    st.set_hash(a[0], 1)
    st.set_hash(a[1], 2)
    st.retag([a[0]], "e0", "xfer:r1")
    assert st.owner_count(a[0], "e0") == 0
    assert st.owner_count(a[0], "xfer:r1") == 1
    assert st.reap_owner("e0") == 1
    assert st.free_count == 3
    assert st.reap_owner("xfer:r1") == 1
    assert st.free_count == 4
    slots = st.alloc(4, "pub")
    for i, s in enumerate(slots):
        st.set_hash(s, i)
        assert st.index_prefix(1000 + i, s)
    st.release(slots, "pub")                       # all index-only now
    st.acquire_prefix(1000, "e9")                  # chain 1000 LRU-hot
    st.release([st._prefix[1000]], "e9")
    got = st.alloc(2, "e2")                        # two evictions
    assert len(got) == 2
    assert st.has_prefix(1000)
    assert not st.has_prefix(1001) and not st.has_prefix(1002)
    assert st.stats()["store_evictions"] == 2


def test_store_layout_mismatch_is_loud():
    st = _store(8)
    other = TorchStubRunner(vocab_size=VOCAB, block_size=8,
                            max_model_len=MAXLEN)
    with pytest.raises(ValueError, match="layout mismatch"):
        ServingEngine(other, num_blocks=8, max_batch_size=2,
                      max_model_len=MAXLEN, kv_store=st)


# ------------------------------------- cross-engine page-in (fp32)


def test_spill_on_a_pagein_on_b_bit_exact_fp32():
    """A demotes its prefix cache into the store; B, another engine with
    another pool, admits the same prompt, resolves the chain in the store
    and pages the same bytes in: streams exact, B's restored device page
    byte-equal to the store's copy."""
    st = _store()
    prompt = list(range(1, 13))
    sp = SamplingParams(max_tokens=6)
    A = _engine(st, "rA")
    A.add_request(prompt, sp)
    outsA = A.run()
    assert A.release_prefix_cache() > 0
    assert st.prefix_count >= 2
    B = _engine(st, "rB")
    rid = B.add_request(prompt, sp)
    outsB = B.run()
    ref = _oracle(prompt, sp)
    assert list(outsA.values())[0].output_tokens == ref
    assert outsB[rid].output_tokens == ref
    m = B.metrics.snapshot()
    assert m["store_hit_pages"] >= 2
    assert m["pagein_pages"] >= 2
    assert m["prefill_tokens"] < len(prompt)
    h0 = page_content_hash(_CHAIN_SEED, prompt[:BLOCK])
    page = B.pool.prefix_cache._index[h0]
    assert st.has_prefix(h0)
    want = st.read_slot(st._prefix[h0])
    for layer, wlayer in zip(B.pool.pools, want):
        for a, w in zip(layer, wlayer):
            assert torch.equal(a[page], w)
    audit_engine(A)
    audit_engine(B)


def test_handoff_by_slot_reference_zero_payload_bytes():
    st = _store()
    A = _engine(st, "rA", role="prefill", host_tier_pages=0)
    B = _engine(st, "rB")
    prompt = list(range(2, 11))
    sp = SamplingParams(max_tokens=8)
    rid = A.add_request(prompt, sp)
    _pump(A, A.handoff_ready)
    state, payload = A.extract_handoff(rid)
    assert payload is not None and payload.get("slot_refs")
    assert "layers" not in payload
    assert A.metrics.handoff_bytes_out.value == 0
    B.import_handoff(state, payload)
    outs = B.run()
    assert outs[rid].output_tokens == _oracle(prompt, sp)
    assert B.metrics.handoff_pages_in.value == len(payload["slot_refs"])
    audit_engine(B)


def test_second_handoff_of_same_prefix_is_refcount_bump():
    st = _store()
    A = _engine(st, "rA", role="prefill", host_tier_pages=0,
                max_prefill_tokens_per_step=None)
    shared = list(range(1, 9))
    p1 = shared + [9, 10]
    p2 = shared + [11, 12]
    sp = SamplingParams(max_tokens=4)
    r1 = A.add_request(p1, sp)
    r2 = A.add_request(p2, sp)
    _pump(A, lambda: len(A.handoff_ready()) >= 2)
    published_before = st.stats()["store_published_pages"]
    assert A.pool.host_tier.store_dedups >= 1
    assert A.metrics.store_dedup_pages.value >= 1
    B = _engine(st, "rB")
    for rid in (r1, r2):
        state, payload = A.extract_handoff(rid)
        B.import_handoff(state, payload)
    outs = B.run()
    assert outs[r1].output_tokens == _oracle(p1, sp)
    assert outs[r2].output_tokens == _oracle(p2, sp)
    assert st.stats()["store_published_pages"] == published_before
    audit_engine(A)
    audit_engine(B)


# --------------------------------------------- int8 migrations exact


def test_int8_migration_restores_exact_codes_and_scales():
    st = SharedKVStore.for_runner(_runner(Int8StubRunner), 64)
    A = _engine(st, "rA", runner=_runner(Int8StubRunner), role="prefill")
    B = _engine(st, "rB", runner=_runner(Int8StubRunner))
    prompt = list(range(3, 12))
    sp = SamplingParams(max_tokens=6)
    rid = A.add_request(prompt, sp)
    _pump(A, A.handoff_ready)
    state, payload = A.extract_handoff(rid)
    assert payload is not None and payload.get("slot_refs")
    assert A.pool.host_tier.store_dedups == 0      # int8: always a copy
    snap = [st.read_slot(s) for s in payload["slot_refs"]]
    assert all(len(layer) == 4 for rec in snap for layer in rec)
    B.import_handoff(state, payload)
    outs = B.run()
    assert outs[rid].output_tokens == _oracle(prompt, sp,
                                              _runner(Int8StubRunner))
    audit_engine(B)


def test_int8_real_pool_slot_roundtrip_bit_exact():
    pool = KVCachePool(num_layers=2, num_blocks=8, block_size=4,
                       n_kv_heads=2, head_dim=3, kv_dtype="int8",
                       device="cpu")
    st = SharedKVStore(SharedKVStore.layout_for(2, 4, 2, 3,
                                                kv_dtype="int8"), 8)
    tier = pool.enable_host_tier(8, store=st, owner="e0")
    g = torch.Generator().manual_seed(7)
    for layer in pool.pools:
        for a in layer:
            if a.dtype == torch.int8:
                a.copy_(torch.randint(-127, 127, a.shape, generator=g))
            else:
                a.copy_(torch.rand(a.shape, generator=g))
    pages = pool.allocator.alloc(3)
    slots = tier.spill_pages(pages)
    want = pool.read_pages(pages)
    for j, s in enumerate(slots):
        for gl, wl in zip(tier.read_slot(s), want):
            for ga, wa in zip(gl, wl):
                assert torch.equal(ga, wa[j])
    for s in slots:
        assert tier.slot_hash(s) == st.content_hash(s)
    tier.free_slots(slots)
    pool.allocator.free(pages)
    assert st.free_count == st.max_pages


# ------------------------------------------- satellite: stale drops


def test_recomputed_registration_drops_store_copy_tierwide():
    st = _store()
    A = _engine(st, "rA")
    prompt = list(range(1, 9))
    sp = SamplingParams(max_tokens=8)
    A.add_request(prompt, sp)
    A.run()
    A.release_prefix_cache()
    hashes_before = st.prefix_count
    assert hashes_before >= 2
    B = _engine(st, "rB")
    rid = B.add_request(prompt, sp)         # the cap: (8-1)//4 = 1 page
    outs = B.run()
    assert outs[rid].output_tokens == _oracle(prompt, sp)
    assert B.metrics.snapshot()["store_hit_pages"] == 1
    assert st.prefix_count < hashes_before
    h0 = page_content_hash(_CHAIN_SEED, prompt[:BLOCK])
    h1 = page_content_hash(h0, prompt[BLOCK:2 * BLOCK])
    assert st.has_prefix(h0)                # promoted: still serving
    assert not st.has_prefix(h1)            # recomputed: dropped
    audit_engine(B)


def test_fuzz_caught_case_drop_while_sibling_pages_in():
    st = _store(8)
    s = st.alloc(1, "pub")[0]
    st.set_hash(s, st.content_hash(s))
    assert st.index_prefix(42, s)
    st.release([s], "pub")
    assert st.acquire_prefix(42, "rB") == s
    assert st.drop_prefix(42)
    assert st.free_count == 7 and st.refcount(s) == 1
    st.release([s], "rB")
    assert st.free_count == 8


# -------------------------------------- corruption + staleness guards


def _pool():
    return KVCachePool(num_layers=1, num_blocks=8, block_size=BLOCK,
                       n_kv_heads=1, head_dim=1, device="cpu")


def test_corrupted_segment_spot_check_trips_auditor():
    st = _store(8)
    pool = _pool()
    tier = pool.enable_host_tier(8, store=st, owner="e0")
    slots = tier.spill_pages(pool.allocator.alloc(2))
    audit_store(st)
    st.bufs[0][0][slots[0]] += 1.0
    with pytest.raises(InvariantViolation, match="content-hash"):
        audit_store(st)


def test_adopt_refuses_corrupt_and_degrades_on_stale():
    st = _store(8)
    pool = _pool()
    tierA = pool.enable_host_tier(8, store=st, owner="eA")
    tierB = _pool().enable_host_tier(8, store=st, owner="eB")
    slots = tierA.spill_pages(pool.allocator.alloc(2))
    hashes = [tierA.slot_hash(s) for s in slots]
    gens = [st.generation(s) for s in slots]
    tierA.retag_out(slots, "xfer:r1")
    st.bufs[0][0][slots[0]] += 1.0
    with pytest.raises(ValueError, match="content-hash"):
        tierB.adopt_slots(slots, gens, hashes, "xfer:r1")
    assert st.free_count == st.max_pages
    slots2 = tierA.spill_pages(pool.allocator.alloc(1))
    g2 = [st.generation(slots2[0])]
    h2 = [tierA.slot_hash(slots2[0])]
    tierA.retag_out(slots2, "xfer:r2")
    st.retag(slots2, "xfer:r2", "tmp")      # reuse: free, then realloc
    st.release(slots2, "tmp")
    assert st.alloc(1, "other") == slots2
    st.incref(slots2, "xfer:r2")
    assert tierB.adopt_slots(slots2, g2, h2, "xfer:r2") is None
    assert tierB.fallbacks == 1


# ---------------------------------------------- satellite: async spill


@pytest.mark.parametrize("store", [False, True], ids=["private", "store"])
def test_preempt_spill_never_blocks_loop_thread(store):
    """With spill_async a preemption storm never waits on the loop thread
    for a spill's bytes (no sync spill read, no blocking join), private or
    store-backed; spill_async=False is the positive control."""
    def run(spill_async):
        mm = 32
        runner = TorchStubRunner(vocab_size=VOCAB, block_size=BLOCK,
                                 max_model_len=mm)
        kw = dict(num_blocks=10, max_batch_size=4, max_model_len=mm,
                  enable_prefix_cache=True, spill_async=spill_async)
        if store:
            eng = ServingEngine(runner, kv_store=SharedKVStore.for_runner(
                runner, 64), kv_store_owner="rX", **kw)
        else:
            eng = ServingEngine(runner, host_tier_pages=32, **kw)
        for i in range(6):
            eng.add_request([1 + i, 2, 3, 4, 5, 6, 7],
                            SamplingParams(max_tokens=8))
        outs = eng.run()
        assert eng.metrics.snapshot()["preemptions"] > 0
        for o in outs.values():
            assert o.output_tokens == naive_generate(
                runner, o.prompt_tokens, SamplingParams(max_tokens=8),
                max_model_len=mm)
        return eng.pool.host_tier.sync_spill_reads
    assert run(True) == 0
    assert run(False) > 0


def test_async_store_spill_publishes_after_bytes_land():
    st = _store()
    A = _engine(st, "rA", spill_async=True)
    prompt = list(range(1, 13))
    sp = SamplingParams(max_tokens=6)
    A.add_request(prompt, sp)
    A.run()
    A.release_prefix_cache()
    A.pool.host_tier.sync()
    assert st.prefix_count >= 2
    for s in list(st._prefix.values()):
        assert st.slot_hash(s) is not None
        assert st.content_hash(s) == st.slot_hash(s)
    B = _engine(st, "rB", spill_async=True)
    rid = B.add_request(prompt, sp)
    assert B.run()[rid].output_tokens == _oracle(prompt, sp)


# -------------------------------------------------- router integration


def _factory(idx=0):
    return _runner()


def _router(tmp_path=None, replicas=2, **kw):
    kw.setdefault("num_blocks", 24)
    kw.setdefault("block_size", BLOCK)
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_model_len", MAXLEN)
    kw.setdefault("enable_prefix_cache", True)
    kw.setdefault("shared_kv_pages", 64)
    return ServingRouter(_factory, replicas=replicas, **kw)


def test_rolling_restart_resumes_from_store_zero_recompute():
    r = _router()
    try:
        sessions = {}
        for i in range(3):
            p = list(range(1 + i, 13 + i))
            sp = SamplingParams(max_tokens=6, session_id=f"s{i}")
            sessions[r.submit(p, sp)] = (p, sp)
        outs = r.drain(timeout_s=60)
        for rid, (p, sp) in sessions.items():
            assert outs[rid].output_tokens == _oracle(p, sp)
        r.rolling_restart()
        audit_router(r)
        base = r.metrics_snapshot()["engines"]
        turn2 = {}
        for rid, (p, sp) in sessions.items():
            p2 = p + outs[rid].output_tokens
            sp2 = SamplingParams(max_tokens=4, session_id=sp.session_id)
            turn2[r.submit(p2, sp2)] = (p2, sp2)
        outs2 = r.drain(timeout_s=60)
        for rid, (p2, sp2) in turn2.items():
            assert outs2[rid].output_tokens == _oracle(p2, sp2)
        audit_router(r)
        m = r.metrics_snapshot()["engines"]
        hits = m["store_hit_pages"] - base["store_hit_pages"]
        computed = m["prefill_tokens"] - base["prefill_tokens"]
        total_ctx = sum(len(p2) for p2, _ in turn2.values())
        assert hits >= 6
        assert computed < total_ctx / 2
        assert m["offload_recompute_fallbacks"] == \
            base["offload_recompute_fallbacks"]
    finally:
        r.shutdown()


def test_dead_replica_slots_reaped_never_leaked():
    r = _router(snapshot_every_steps=1, heartbeat_timeout_s=2.0,
                poll_interval_s=0.05)
    try:
        work = {}
        for i in range(4):
            p = list(range(1 + i, 12))
            sp = SamplingParams(max_tokens=8)
            work[r.submit(p, sp)] = (p, sp)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if any(rep.steps_done for rep in r._replicas):
                break
            time.sleep(0.01)
        dead_owner = r._replicas[0].store_owner
        r.kill_replica(0)
        outs = r.drain(timeout_s=60)
        for rid, (p, sp) in work.items():
            assert outs[rid].output_tokens == _oracle(p, sp), rid
        audit_router(r)
        for own in r.kv_store.owners_snapshot().values():
            assert dead_owner not in own
        r.release_prefix_caches()
        assert r.check_no_leaks()
    finally:
        r.shutdown()


def _abandon(r):
    """A router SIGKILL, simulated: no shutdown, the journal closed, the
    workers stopped, the store's segments left (a dead router cannot
    unlink them). Returns the store's attach spec."""
    r._journal.close()
    for rep in r._replicas:
        rep.stop = True
        rep.wake.set()
    if r.supervisor:
        r.supervisor.stop()
    for rep in r._replicas:
        rep.thread.join(10)
    return r.kv_store.attach_spec()


def _recover(jpath):
    return ServingRouter.recover(
        _factory, jpath, replicas=2, num_blocks=24, block_size=BLOCK,
        max_batch_size=4, max_model_len=MAXLEN, enable_prefix_cache=True,
        shared_kv_pages=64, shared_kv_shm=True, snapshot_every_steps=1)


@pytest.mark.parametrize("corrupt", [False, True],
                         ids=["journaled_index", "corrupted_entry"])
def test_router_kill_recovery_with_journaled_store_index(tmp_path, corrupt):
    """Router SIGKILL over a shared-memory store: the segments survive,
    recover() reattaches them and revives the journaled index, each entry
    CRC-verified; the next turn pages in from what the dead router
    published. An entry whose bytes were corrupted in the segment is
    skipped (the JAX pin of corrupted journaled entries): it recomputes,
    never serves."""
    jpath = str(tmp_path / "router.jsonl")
    r = _router(journal_path=jpath, journal_fsync="always",
                shared_kv_shm=True, snapshot_every_steps=1)
    spec = None
    r2 = None
    try:
        prompt = list(range(1, 13))
        sp = SamplingParams(max_tokens=6)
        rid = r.submit(prompt, sp)
        outs = r.drain(timeout_s=60)
        r.drain_replica(0)                  # demote, journal store_idx
        npages = r.kv_store.prefix_count
        assert npages >= 2
        if corrupt:
            victim = next(iter(r.kv_store._prefix.values()))
            r.kv_store.bufs[0][0][victim] += 1.0
        spec = _abandon(r)
        r2 = _recover(jpath)
        assert r2.kv_store.prefix_count == npages - int(corrupt)
        p2 = prompt + outs[rid].output_tokens
        sp2 = SamplingParams(max_tokens=4)
        rid2 = r2.submit(p2, sp2)
        outs2 = r2.drain(timeout_s=60)
        assert outs2[rid2].output_tokens == _oracle(p2, sp2)
        audit_router(r2)
        if not corrupt:
            m = r2.metrics_snapshot()["engines"]
            assert m["store_hit_pages"] >= 2
            assert m["prefill_tokens"] < len(p2)
    finally:
        if r2 is not None:
            r2.shutdown()
        r.kv_store.close(unlink=False)
        SharedKVStore.unlink_spec(spec)


def test_process_backend_store_handoff_zero_wire_bytes():
    """Process replicas share the store through shared memory: every
    prefill -> decode handoff ships slot references (handoff_bytes_out 0,
    no fallback), streams equal the single engine's, and the children's
    auditor stays green. The JAX pin :712, on CPU children."""
    spec = {"factory": "_torch_stub:TorchStubRunner",
            "factory_kw": {"vocab_size": VOCAB, "block_size": BLOCK,
                           "max_model_len": MAXLEN},
            "sys_path": [TESTS_DIR]}
    geom = {"num_layers": 1, "block_size": BLOCK, "n_kv_heads": 1,
            "head_dim": 1}
    r = ServingRouter(spec, replicas=2, backend="process",
                      prefill_replicas=1, num_blocks=24, block_size=BLOCK,
                      max_batch_size=4, max_model_len=MAXLEN,
                      enable_prefix_cache=True, shared_kv_pages=64,
                      shared_kv_geometry=geom, child_env=_child_env(),
                      heartbeat_timeout_s=60.0, rendezvous_timeout_s=120.0,
                      command_timeout_s=120.0)
    try:
        assert r.kv_store.use_shm
        work = {}
        for i in range(3):
            p = list(range(1, 13)) if i < 2 else [5, 6, 7, 8, 9]
            sp = SamplingParams(max_tokens=6)
            work[r.submit(p, sp)] = (p, sp)
        outs = r.drain(timeout_s=120)
        for rid, (p, sp) in work.items():
            assert outs[rid].output_tokens == _oracle(p, sp), rid
        audit_router(r)
        snap = r.metrics_snapshot()
        assert snap["router"]["handoffs"] == 3
        assert snap["router"]["handoff_fallbacks"] == 0
        assert snap["engines"]["handoff_bytes_out"] == 0
        assert snap["engines"]["handoff_pages_in"] > 0
        assert snap["store"]["store_prefix_hits"] > 0
        owners = {rep.store_owner for rep in r._replicas}
        assert owners == {rep.engine.key for rep in r._replicas}
    finally:
        r.shutdown()


# ------------------------------------------------ across the packages


LAYOUT_CASES = [(2, 16, 8, 128, "float32", "fp32"),
                (1, 4, 2, 3, "float32", "int8"),
                (3, 8, 4, 64, "float32", "fp8"),
                (2, 4, 1, 8, "float32", "mixed"),
                (1, 16, 32, 128, "bfloat16", "fp32"),
                (1, 16, 32, 128, "float16", "mixed")]


@pytest.mark.parametrize("case", LAYOUT_CASES,
                         ids=[f"{c[5]}-{c[4]}" for c in LAYOUT_CASES])
def test_layout_for_equals_jax(case):
    from paddle_tpu.serving import SharedKVStore as JaxStore
    assert SharedKVStore.layout_for(*case) == JaxStore.layout_for(*case)
    # a torch dtype names the same layout as its name does
    dt = getattr(torch, case[4])
    assert SharedKVStore.layout_for(*case[:4], dt, case[5]) == \
        JaxStore.layout_for(*case)


def _state(st):
    return (list(st._free), {s: dict(o) for s, o in st._owners.items()},
            sorted(st._indexed), dict(st._gen), dict(st._prefix),
            dict(st._hash), st.evictions, st.dropped_pages,
            st.dedup_pages, st.published_pages, st.prefix_hits,
            st.reaped_slots)


def test_store_ops_equal_jax_op_for_op():
    """The same seeded sequence of store operations, with the same page
    bytes written into each allocated slot, through a JAX store and the
    port's: every return value and the whole state (free list, owner
    refcounts, index, generations, hashes, evictions, drops) equal after
    every step, `content_hash` equal on every used slot, and the
    `journal_state` equal at the end."""
    from paddle_tpu.serving import SharedKVStore as JaxStore
    layout = SharedKVStore.layout_for(2, 4, 2, 3, kv_dtype="int8")
    ours, ref = SharedKVStore(layout, 12), JaxStore(layout, 12)
    rng = np.random.default_rng(0)
    owners = ["e0", "e1", "e2", "xfer:r1"]
    chains = list(range(100, 116))
    for step in range(400):
        op = rng.choice(["alloc", "alloc", "index", "acquire", "release",
                         "retag", "reap", "drop", "incref"])
        owner = str(rng.choice(owners))
        held = sorted(s for s, o in ref._owners.items() if o.get(owner))
        if op == "alloc":
            n = int(rng.integers(1, 5))
            got = ours.alloc(n, owner)
            want = ref.alloc(n, owner)
            assert got == want
            for s in want:
                for layer_o, layer_r in zip(ours.bufs, ref.bufs):
                    for bo, br in zip(layer_o, layer_r):
                        data = rng.integers(-100, 100, br[s].shape)
                        br[s] = data.astype(br.dtype)
                        bo[s] = torch.from_numpy(np.ascontiguousarray(
                            br[s]))
                h = ref.content_hash(s)
                assert ours.content_hash(s) == h
                ours.set_hash(s, h)
                ref.set_hash(s, h)
        elif op == "index" and set(held) - ref._indexed:
            # an engine publishes a slot it wrote, once
            s = int(rng.choice(sorted(set(held) - ref._indexed)))
            h = int(rng.choice(chains))
            assert ours.index_prefix(h, s) == ref.index_prefix(h, s)
        elif op == "acquire":
            h = int(rng.choice(chains))
            assert ours.acquire_prefix(h, owner) == \
                ref.acquire_prefix(h, owner)
        elif op == "release" and held:
            s = int(rng.choice(held))
            ours.release([s], owner)
            ref.release([s], owner)
        elif op == "retag" and held:
            s = int(rng.choice(held))
            to = str(rng.choice(owners))
            ours.retag([s], owner, to)
            ref.retag([s], owner, to)
        elif op == "reap":
            assert ours.reap_owner(owner) == ref.reap_owner(owner)
        elif op == "drop":
            h = int(rng.choice(chains))
            assert ours.drop_prefix(h) == ref.drop_prefix(h)
        elif op == "incref" and held:
            s = int(rng.choice(held))
            ours.incref([s], owner)
            ref.incref([s], owner)
        assert _state(ours) == _state(ref), (step, op)
        assert ours.stats() == ref.stats()
    used = set(range(12)) - set(ref._free)
    for s in used:
        assert ours.content_hash(s) == ref.content_hash(s)
    assert ref.evictions > 0 and ref.reaped_slots > 0
    assert ours.journal_state() == ref.journal_state()


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_clients_work_against_the_other_packages_server(server_side):
    """Over one shared-memory store: a port SharedKVStoreClient against a
    JAX StoreServer, and a JAX client against a port server. The client
    writes page bytes through its own mapping and publishes them; the
    server's store sees the same bytes and CRC, and the index, refcounts
    and errors travel both ways."""
    from paddle_tpu.serving import SharedKVStore as JaxStore
    from paddle_tpu.serving.store_service import (
        SharedKVStoreClient as JaxClient,
    )
    from paddle_tpu.serving.store_service import StoreServer as JaxServer
    layout = SharedKVStore.layout_for(2, 4, 2, 3)
    if server_side == "jax":
        store, server_cls, client_cls = JaxStore(layout, 8, use_shm=True), \
            JaxServer, SharedKVStoreClient
    else:
        store, server_cls, client_cls = SharedKVStore(
            layout, 8, use_shm=True), StoreServer, JaxClient
    server = client = None
    try:
        server = server_cls(store)
        client = client_cls(store.attach_spec(), server.address)
        slots = client.alloc(2, "child")
        assert slots == [0, 1] and store.free_count == 6
        for layer in client.bufs:
            for buf in layer:
                buf[slots[0]] = 1.5
        h = client.content_hash(slots[0])
        assert h == store.content_hash(slots[0])
        client.set_hash(slots[0], h)
        assert client.index_prefix(77, slots[0])
        assert not client.index_prefix(77, slots[1])
        assert store.has_prefix(77) and store.slot_hash(slots[0]) == h
        client.retag([slots[1]], "child", "xfer:r9")
        assert client.owner_count(slots[1], "xfer:r9") == 1
        assert client.acquire_prefix(77, "other") == slots[0]
        assert client.refcount(slots[0]) == 3
        with pytest.raises(ValueError):
            client.release([slots[1]], "child")    # not held any more
        assert client.reap_owner("child") == 0     # the index keeps slot 0
        assert client.reap_owner("xfer:r9") == 1
        assert (client.free_count, client.used_count,
                client.prefix_count) == (7, 1, 1)
        assert client.stats()["store_prefix_pages"] == 1.0
        assert client.generation(slots[1]) == store.generation(slots[1]) \
            == 1
    finally:
        if client is not None:
            client.close()
        if server is not None:
            server.close()
        store.close()


def test_fresh_interpreter_maps_fp8_and_bf16_stores_without_ml_dtypes():
    """The card has numpy without ml_dtypes, where np.dtype("bfloat16")
    raises: a fresh interpreter importing only the port builds fp8 and
    bf16 stores over shared memory, serves them and maps them through a
    client, and never imports ml_dtypes (or jax)."""
    code = textwrap.dedent("""
        import sys
        from paddle_tpu_torch.serving import (
            SharedKVStore, SharedKVStoreClient, StoreServer)
        for dtype, kv in (("float32", "fp8"), ("bfloat16", "fp32")):
            st = SharedKVStore(SharedKVStore.layout_for(
                2, 4, 2, 8, dtype, kv), 4, use_shm=True)
            srv = StoreServer(st)
            cl = SharedKVStoreClient(st.attach_spec(), srv.address)
            try:
                s = cl.alloc(1, "c")[0]
                cl.bufs[0][0][s] = 1.0
                assert cl.content_hash(s) == st.content_hash(s)
                assert str(cl.bufs[0][0].dtype) == str(st.bufs[0][0].dtype)
            finally:
                cl.close()
                srv.close()
                st.close()
        assert "ml_dtypes" not in sys.modules, "ml_dtypes imported"
        assert "jax" not in sys.modules, "jax imported"
        print("ok")
    """)
    env = _child_env()
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_sigkilled_child_leaves_the_segment_to_its_owner():
    """A child that attached a segment and is SIGKILLed must not take the
    segment with it (Python < 3.13 registers an attach with the child's
    resource tracker, which unlinks at the child's death): the segment
    still exists, and a fresh child maps it and reads its bytes."""
    st = SharedKVStore(SharedKVStore.layout_for(1, 4, 1, 2), 4,
                       use_shm=True)
    child = None
    try:
        st.bufs[0][0][2] = 7.0
        name = st.attach_spec()["segments"][0]
        attach = textwrap.dedent(f"""
            import sys, time
            from paddle_tpu_torch.serving.kv_cache import (
                _open_shm, _segment_views)
            seg = _open_shm({name!r})
            v = _segment_views(seg, (4, 4, 1, 2), "float32")
            print(float(v[2, 0, 0, 0]), flush=True)
            if sys.argv[1] == "hold":
                time.sleep(600)
        """)
        child = subprocess.Popen([sys.executable, "-c", attach, "hold"],
                                 env=_child_env(), stdout=subprocess.PIPE,
                                 text=True)
        assert child.stdout.readline().strip() == "7.0"
        os.kill(child.pid, signal.SIGKILL)
        child.wait(30)
        time.sleep(1.0)            # the child's tracker acts on its death
        assert _exists(name)
        again = subprocess.run([sys.executable, "-c", attach, "read"],
                               env=_child_env(), capture_output=True,
                               text=True, timeout=60)
        assert again.returncode == 0, again.stderr
        assert again.stdout.strip() == "7.0"
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait(30)
        st.close()


def test_store_close_unlinks_while_a_view_lives():
    """close() unlinks a segment whose mapping a tensor still views (the
    view owns the mapping); its memory goes with the last view."""
    st = SharedKVStore(SharedKVStore.layout_for(1, 4, 1, 2), 4,
                       use_shm=True)
    view = st.bufs[0][0]
    names = st.attach_spec()["segments"]
    st.close()
    assert not any(_exists(n) for n in names)
    view[0] = 1.0                  # the mapping itself is still valid
    assert float(view[0, 0, 0, 0]) == 1.0
    del view


def test_store_refuses_more_shm_than_is_free(monkeypatch, _no_segment_left):
    """The store checks /dev/shm's free space before it maps: a store
    larger than what is free raises OSError naming both numbers and makes
    no segment (tmpfs would create it and SIGBUS the first write)."""
    import shutil
    real = shutil.disk_usage

    def tiny(path):
        u = real(path)
        return type(u)(u.total, u.total - 1000, 1000)
    monkeypatch.setattr(shutil, "disk_usage", tiny)
    with pytest.raises(OSError, match=r"need \d+ bytes.*1000 bytes are "
                                      "free"):
        SharedKVStore(SharedKVStore.layout_for(1, 16, 8, 128), 64,
                      use_shm=True)
    assert _no_segment_left == []


def test_thread_router_store_lives_and_dies_with_the_router():
    """A thread router's store (no shm by default) is built from the first
    runner's geometry, shared by every replica under its own owner tag,
    reported in metrics_snapshot()["store"], and closed at shutdown."""
    r = _router()
    try:
        st = r.kv_store
        assert not st.use_shm and st.max_pages == 64
        tiers = [rep.engine.pool.host_tier for rep in r._replicas]
        assert all(t.store is st for t in tiers)
        assert len({t.owner for t in tiers}) == 2
        assert {rep.store_owner for rep in r._replicas} == \
            {t.owner for t in tiers}
        assert r.metrics_snapshot()["store"]["store_max_pages"] == 64.0
    finally:
        r.shutdown()
    assert r.kv_store is None and st.bufs == []


def test_store_threads_race_free_under_concurrent_engines():
    """Two engines sharing one store, each stepped by its own thread over
    overlapping prompts (demotions, dedups and page-ins interleaved):
    every stream exact and the store's audit clean."""
    st = _store(48)
    engines = [_engine(st, f"r{i}", num_blocks=16) for i in range(2)]
    rng = np.random.default_rng(3)
    work = [[list(map(int, rng.integers(0, VOCAB, int(n))))
             for n in rng.integers(5, 14, 6)] for _ in engines]
    outs = [None, None]

    def drive(i):
        eng = engines[i]
        ids = [eng.add_request(p, SamplingParams(max_tokens=5))
               for p in work[i]]
        res = eng.run()
        eng.release_prefix_cache()
        for p in work[i]:
            eng.add_request(p, SamplingParams(max_tokens=5))
        res2 = eng.run()
        outs[i] = ([res[k].output_tokens for k in ids], res2)
    threads = [threading.Thread(target=drive, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for i, eng in enumerate(engines):
        first, _ = outs[i]
        for p, got in zip(work[i], first):
            assert got == _oracle(p, SamplingParams(max_tokens=5))
        eng.pool.host_tier.sync()
        audit_engine(eng)
    audit_store(st)
