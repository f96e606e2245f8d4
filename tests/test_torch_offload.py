"""The port's host KV tier against the JAX package, on the CPU.

Ports the pins of tests/test_serving_offload.py: with
`host_tier_pages > 0` a preemption spills the victim's exclusively owned
pages to host buffers and the resume pages them back in, and nothing
about the token streams changes. Each pin runs the port's engine over a
torch twin of the JAX package's `StubPagedRunner` (the same hash of the
whole history gathered from the pool), and where the JAX pin has a JAX
engine, the same schedule through both gives equal tokens and equal
offload_* / pagein_* / host_tier_drops counts. On a small Llama bridged
from JAX the port's engine and the JAX engine with the tier on give equal
greedy tokens and counts (fp32, int8), and `content_hash` of the same
page bytes is equal in both packages. The card's half of the tier (pinned
buffers, side-stream copies, events) is in tests/test_torch_cuda.py.

Every engine runs under the invariant auditor, which owns the tier too.
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from _helpers import StubPagedRunner
from _torch_stub import TorchStubRunner
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.serving import KVCachePool as JaxKVCachePool
from paddle_tpu.serving import LlamaRunner as JaxLlamaRunner
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.models import Llama, LlamaConfig
from paddle_tpu_torch.serving import (
    FCFSScheduler, HostKVTier, InvariantViolation, KVCachePool, LlamaRunner,
    OffloadRecord, Request, SamplingParams, ServingEngine, audit_engine,
    naive_generate,
)
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

VOCAB, BLOCK, MAXLEN = 31, 4, 40
TIER_METRICS = ("offload_spill_pages", "pagein_pages", "pagein_hidden_pages",
                "offload_resumes", "offload_recompute_fallbacks",
                "host_tier_drops", "preemptions", "prefill_tokens")


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


def _engine(runner=None, num_blocks=11, max_batch=3, **kw):
    kw.setdefault("host_tier_pages", 32)
    kw.setdefault("max_model_len", MAXLEN)
    return ServingEngine(runner or TorchStubRunner(), num_blocks=num_blocks,
                         max_batch_size=max_batch, **kw)


def _jax_engine(num_blocks=11, max_batch=3, **kw):
    kw.setdefault("host_tier_pages", 32)
    return JaxServingEngine(StubPagedRunner(vocab_size=VOCAB,
                                            block_size=BLOCK,
                                            max_model_len=MAXLEN),
                            num_blocks=num_blocks, max_batch_size=max_batch,
                            max_model_len=MAXLEN, **kw)


def _workload(n=6, seed=0, max_tokens=(4, 12)):
    wl = np.random.default_rng(seed)
    work = []
    for _ in range(n):
        p = list(map(int, wl.integers(0, VOCAB, int(wl.integers(3, 12)))))
        work.append((p, int(wl.integers(*max_tokens))))
    return work


def _add(eng, work, sp_cls=SamplingParams):
    return [(eng.add_request(p, sp_cls(max_tokens=n)), p, n)
            for p, n in work]


def _assert_oracle(runner, ids, outs, max_model_len=MAXLEN):
    for rid, p, n in ids:
        ref = naive_generate(runner, p, SamplingParams(max_tokens=n),
                             max_model_len=max_model_len)
        assert outs[rid].output_tokens == ref, rid


def _twin_run(work, jax_kw=None, **kw):
    """The same workload through the port's engine and the JAX engine over
    the two stubs: (port outputs in order, JAX outputs, port metrics,
    JAX metrics, port engine)."""
    eng = _engine(**kw)
    ids = _add(eng, work)
    outs = eng.run()
    jeng = _jax_engine(**(jax_kw or kw))
    jids = _add(jeng, work, JaxSamplingParams)
    jouts = jeng.run()
    return ([outs[r].output_tokens for r, _, _ in ids],
            [jouts[r].output_tokens for r, _, _ in jids],
            eng.metrics.snapshot(), jeng.metrics.snapshot(), eng, ids)


# -------------------------------------------------- spill round-trips


def _filled_pool(kv_dtype, dtype=torch.float32, seed=1):
    pool = KVCachePool(num_layers=2, num_blocks=8, block_size=4,
                       n_kv_heads=2, head_dim=3, dtype=dtype,
                       kv_dtype=kv_dtype, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for layer in pool.pools:
        for a in layer:
            if a.dtype == torch.int8:
                a.copy_(torch.randint(-127, 128, a.shape, generator=g))
            elif a.dtype == torch.bool:
                a.copy_(torch.randint(0, 2, a.shape, generator=g).bool())
            else:
                a.copy_(torch.randn(a.shape, generator=g).to(a.dtype))
    return pool


ROUND_TRIPS = [("fp32", torch.float32), ("int8", torch.float32),
               ("fp8", torch.float32), ("mixed", torch.float32),
               ("fp32", torch.bfloat16), ("fp32", torch.float16)]


@pytest.mark.parametrize("kv_dtype,dtype", ROUND_TRIPS,
                         ids=[f"{k}-{str(d)[6:]}" for k, d in ROUND_TRIPS])
def test_spill_pagein_round_trip_is_bit_exact(kv_dtype, dtype):
    """Spilling device pages and paging them back in restores the exact
    bytes of every layer's pool arrays: the int8 codes AND scale rows, the
    fp8 bytes, a mixed pool's tag bits, 16-bit pages (JAX pins :73,
    :105). The host buffers mirror the pool layout."""
    pool = _filled_pool(kv_dtype, dtype)
    before = pool.read_pages([2, 5, 6])
    tier = pool.enable_host_tier(4)
    assert [b.dtype for b in tier._bufs[0]] == [a.dtype
                                                 for a in pool.pools[0]]
    slots = tier.spill_pages([2, 5, 6])
    assert slots == [0, 1, 2]
    pool.write_pages([2, 5, 6], [tuple(torch.zeros((3,) + a.shape[1:],
                                                   dtype=a.dtype)
                                       for a in layer)
                                 for layer in pool.pools])
    data = [tier.read_slot(s) for s in slots]
    pool.write_pages([2, 5, 6], [
        tuple(torch.stack([d[li][j] for d in data])
              for j in range(len(pool.pools[li]))) for li in range(2)])
    for b_layer, a_layer in zip(before, pool.read_pages([2, 5, 6])):
        for b, a in zip(b_layer, a_layer):
            assert b.dtype == a.dtype
            assert torch.equal(b.view(torch.uint8), a.view(torch.uint8))
    tier.free_slots(slots)
    assert tier.used_count == 0 and tier.free_count == 4


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8", "mixed"])
def test_content_hash_equals_the_jax_hash_of_the_same_bytes(kv_dtype):
    """The CRC-32 content hash runs over the same bytes in the same order
    in both packages, so the same pages hash equally."""
    import jax.numpy as jnp

    pool = _filled_pool(kv_dtype, seed=3)
    jpool = JaxKVCachePool(num_layers=2, num_blocks=8, block_size=4,
                           n_kv_heads=2, head_dim=3, kv_dtype=kv_dtype)
    jpool.pools = [tuple(
        jnp.asarray(a.view(torch.uint8).numpy()).view(j.dtype)
        if a.dtype == torch.float8_e4m3fn else jnp.asarray(a.numpy())
        for a, j in zip(layer, jlayer))
        for layer, jlayer in zip(pool.pools, jpool.pools)]
    tier, jtier = pool.enable_host_tier(4), jpool.enable_host_tier(4)
    slots, jslots = tier.spill_pages([1, 4, 7]), jtier.spill_pages([1, 4, 7])
    assert slots == jslots
    assert [tier.slot_hash(s) for s in slots] == \
        [jtier.slot_hash(s) for s in jslots]


def test_host_tier_validation_and_accounting():
    """JAX pin :144, and a host-wide store of another page geometry
    refused loudly (a store of the pool's geometry is served, see
    tests/test_torch_shared_kv.py)."""
    from paddle_tpu_torch.serving.kv_cache import SharedKVStore
    pool = KVCachePool(num_layers=1, num_blocks=6, block_size=4,
                       n_kv_heads=1, head_dim=2, device="cpu")
    with pytest.raises(ValueError):
        pool.enable_host_tier(0)
    with pytest.raises(ValueError, match="layout mismatch"):
        HostKVTier(pool, 2, store=SharedKVStore(
            SharedKVStore.layout_for(1, 8, 1, 2), 2))
    assert HostKVTier(pool, 0, store=SharedKVStore(
        SharedKVStore.layout_for(1, 4, 1, 2), 3)).max_pages == 3
    tier = pool.enable_host_tier(2)
    assert pool.enable_host_tier(99) is tier      # idempotent
    assert tier.capacity_bytes == 2 * pool.page_bytes()
    slots = tier.spill_pages([1, 2, 3])           # cap 2: one drops
    assert len(slots) == 2 and tier.dropped_pages == 1
    assert tier.bytes_used == 2 * pool.page_bytes()
    with pytest.raises(ValueError):
        tier.free_slots([slots[0], slots[0]])     # double free guard


def test_page_in_stages_each_run_of_consecutive_slots_at_once():
    """The engine stages a page-in by runs of consecutive slots (one copy a
    pool array a run on the card): each slot's staged pages are its own
    bytes, and [0, 1, 2, 5, 6] reads the tier twice."""
    eng = _engine(num_blocks=12)
    pool, tier = eng.pool, eng.pool.host_tier
    for layer in pool.pools:
        for a in layer:
            a.copy_(torch.randn(a.shape, generator=torch.Generator()
                                .manual_seed(4)))
    slots = tier.spill_pages([1, 2, 3, 4, 5, 6, 7])
    tier.free_slots([slots[3], slots[4]])
    reads = []
    read = tier.read_slots
    tier.read_slots = lambda first, n: reads.append((first, n)) or \
        read(first, n)
    want = [0, 1, 2, 5, 6]
    staged = eng._stage_slots(tier, want)
    assert reads == [(0, 3), (5, 2)]
    assert sorted(staged) == want
    for s in want:
        for got, ref in zip(staged[s][0], tier.read_slot(s)):
            for g, r in zip(got, ref):
                assert torch.equal(g, r)


# ------------------------------------------- preempt -> spill -> resume


@pytest.mark.parametrize("knobs", [{}, {"spill_async": True},
                                   {"pipelined": True},
                                   {"pagein_prefetch": 0}],
                         ids=["sync", "async", "pipelined", "no_prefetch"])
def test_preemption_resumes_by_pagein_token_exact(knobs):
    """JAX pin :162: a tight pool preempts, victims spill and wait
    offloaded, and resume by page-in, token for token as naive_generate;
    the JAX engine on the same schedule gives the same tokens and counts."""
    eng = _engine(**knobs)
    ids = _add(eng, _workload(seed=0))
    saw_offloaded = False
    while eng.has_work():
        eng.step()
        saw_offloaded = saw_offloaded or any(
            r.phase == "offloaded" and r.offload is not None
            for r in eng.scheduler.waiting)
    m = eng.metrics.snapshot()
    assert m["preemptions"] > 0 and saw_offloaded
    assert m["offload_spill_pages"] > 0 and m["pagein_pages"] > 0
    assert m["offload_resumes"] > 0
    assert m["offload_recompute_fallbacks"] == 0
    _assert_oracle(eng.runner, ids, eng.outputs())
    assert eng.pool.allocator.check_no_leaks()
    assert eng.pool.host_tier.used_count == 0
    got, want, ours, ref, _, _ = _twin_run(_workload(seed=0), **knobs)
    assert got == want
    assert {k: ours[k] for k in TIER_METRICS} == \
        {k: ref[k] for k in TIER_METRICS}


def test_async_spill_never_waits_on_the_engine_loop():
    """The port's pin of the JAX async-spill pin: with spill_async the
    spills of a preemption storm are waited for on the worker thread only
    (no synchronous spill on the loop); the sync path is the positive
    control."""
    for spill_async in (True, False):
        eng = _engine(TorchStubRunner(max_model_len=32),
                      spill_async=spill_async, enable_prefix_cache=True,
                      num_blocks=10, max_batch=4, max_model_len=32)
        for i in range(6):
            eng.add_request([1 + i, 2, 3, 4, 5, 6, 7],
                            SamplingParams(max_tokens=8))
        eng.run()
        tier = eng.pool.host_tier
        assert eng.metrics.preemptions.value > 0
        if spill_async:
            assert tier.sync_spill_reads == 0
            assert tier._executor is not None
            assert tier._executor._threads
            assert all(t is not threading.current_thread()
                       for t in tier._executor._threads)
        else:
            assert tier.sync_spill_reads > 0 and tier._executor is None


def test_resume_compute_at_least_3x_cheaper_than_recompute():
    """JAX pin: resuming costs >= 3x fewer computed prefill tokens with
    the tier than without on the same trace, and some page-ins were
    staged ahead of their fence."""
    def run(tier_pages):
        eng = _engine(host_tier_pages=tier_pages)
        ids = _add(eng, _workload(seed=3, max_tokens=(8, 14)))
        _assert_oracle(eng.runner, ids, eng.run())
        m = eng.metrics.snapshot()
        return m, m["prefill_tokens"] - sum(len(p) for _, p, _ in ids)

    m_recompute, resume_recompute = run(0)
    m_pagein, resume_pagein = run(32)
    assert m_recompute["preemptions"] == m_pagein["preemptions"] > 0
    assert resume_recompute >= 3 * max(resume_pagein, 1)
    assert 0.0 < m_pagein["pagein_hidden_ratio"] <= 1.0


def test_offload_record_dropped_on_abort_of_waiting_request():
    """JAX pin :219: aborting an offloaded waiter frees its host slots."""
    eng = _engine()
    _add(eng, _workload(seed=0))
    victim = None
    while eng.has_work() and victim is None:
        eng.step()
        victim = next((r for r in eng.scheduler.waiting
                       if r.offload is not None), None)
    assert victim is not None
    held = len(victim.offload.slots)
    used_before = eng.pool.host_tier.used_count
    assert eng.abort(victim.request_id)
    assert victim.offload is None
    assert eng.pool.host_tier.used_count == used_before - held
    eng.run()
    assert eng.pool.allocator.check_no_leaks()
    assert eng.pool.host_tier.used_count == 0


# --------------------------------------------------- recompute fallback


def test_recompute_fallback_on_connection_hole():
    """JAX pin :246: a record whose leading prefix pages are gone falls
    back to recompute: slots freed, the fallback counted."""
    pool = KVCachePool(num_layers=1, num_blocks=12, block_size=BLOCK,
                       n_kv_heads=1, head_dim=1, device="cpu")
    pool.enable_prefix_cache()
    tier = pool.enable_host_tier(8)
    sched = FCFSScheduler(pool, max_batch_size=2, max_pages_per_seq=10)
    pages = pool.allocator.alloc(2)
    slots = tier.spill_pages(pages)
    pool.allocator.free(pages)
    req = Request(prompt_tokens=list(range(1, 14)),
                  sampling=SamplingParams(max_tokens=2))
    req.offload = OffloadRecord(start_page=2, covered_tokens=12,
                                slots=slots)
    req.phase = "offloaded"
    sched.add(req)
    assert sched.admit() == [req]
    assert req.offload is None and req.pending_pagein == []
    assert req.kv.num_tokens == 0
    assert tier.used_count == 0 and tier.fallbacks == 1


def test_tier_cap_overflow_degrades_to_recompute_token_exact():
    """JAX pin :275: a 1-page tier drops most spills; the streams still
    equal the oracle's and the JAX engine's, counts included."""
    got, want, ours, ref, eng, ids = _twin_run(
        _workload(seed=3, max_tokens=(8, 14)), host_tier_pages=1)
    assert ours["preemptions"] > 0 and ours["host_tier_drops"] > 0
    _assert_oracle(eng.runner, ids, eng.outputs())
    assert got == want
    assert {k: ours[k] for k in TIER_METRICS} == \
        {k: ref[k] for k in TIER_METRICS}
    assert eng.pool.allocator.check_no_leaks()
    assert eng.pool.host_tier.used_count == 0


# ------------------------------------------------ prefix-cache demotion


def test_evict_hook_fires_on_evict_and_clear():
    """JAX pin :294: the hook sees LRU eviction and clear(), before the
    decref."""
    pool = KVCachePool(num_layers=1, num_blocks=8, block_size=2,
                       n_kv_heads=1, head_dim=1, device="cpu")
    cache = pool.enable_prefix_cache()
    calls = []
    cache.evict_hook = lambda page, h, reason: calls.append(
        (page, h, reason, pool.allocator.refcount(page)))
    pages = pool.allocator.alloc(3)
    for i, p in enumerate(pages):
        assert cache.register_page(p, 1000 + i)
    pool.allocator.free(pages)               # cached-free (rc 1)
    assert cache.evict(1) == 1
    assert len(calls) == 1 and calls[0][2] == "evict" and calls[0][3] == 1
    assert cache.clear() == 2
    assert len(calls) == 3 and {c[2] for c in calls[1:]} == {"clear"}
    assert pool.allocator.check_no_leaks()


def test_prefix_demotion_then_host_hit_pages_back_in():
    """JAX pin :321: evicted prefix pages demote to the host; a request
    with the same header hits the host index and pages them in."""
    eng = _engine(max_batch=2, enable_prefix_cache=True)
    header = list(range(5, 5 + 2 * BLOCK))
    ids = _add(eng, [(header + [1, 2, 3], 4)])
    eng.run()
    cache, tier = eng.pool.prefix_cache, eng.pool.host_tier
    demoted = cache.evict(10)
    assert demoted > 0 and tier.prefix_count == demoted
    ids += _add(eng, [(header + [9, 9, 9], 4)])
    eng.run()
    m = eng.metrics.snapshot()
    assert m["pagein_pages"] >= 2 and m["prefix_hit_tokens"] >= 2 * BLOCK
    _assert_oracle(eng.runner, ids, eng.outputs())
    assert tier.prefix_count == demoted - 2
    eng.release_prefix_cache()
    assert eng.pool.allocator.check_no_leaks()


def test_clear_demotes_to_host_no_silent_leak():
    """JAX pin :352: release_prefix_cache demotes through the same hook;
    every host slot keeps one owner."""
    eng = _engine(max_batch=2, enable_prefix_cache=True)
    eng.add_request(list(range(1, 1 + 3 * BLOCK)),
                    SamplingParams(max_tokens=2))
    eng.run()
    assert len(eng.pool.prefix_cache) > 0
    eng.release_prefix_cache()
    tier = eng.pool.host_tier
    assert tier.prefix_count == tier.used_count > 0
    assert eng.pool.allocator.check_no_leaks()
    audit_engine(eng)


# ------------------------------------------------- watermark headroom


def test_watermark_counts_host_headroom_when_knob_on():
    """JAX pin :374: free host slots lift the admission watermark."""
    def build(knob):
        pool = KVCachePool(num_layers=1, num_blocks=11, block_size=BLOCK,
                           n_kv_heads=1, head_dim=1, device="cpu")
        pool.enable_host_tier(16)
        sched = FCFSScheduler(pool, max_batch_size=4, max_pages_per_seq=10,
                              admission_watermark=0.5,
                              count_host_headroom=knob)
        for _ in range(3):
            sched.add(Request(prompt_tokens=[1] * 7,
                              sampling=SamplingParams(max_tokens=2)))
        return sched

    assert len(build(False).admit()) == 2
    assert len(build(True).admit()) == 3


def test_auditor_catches_corrupted_host_slot_and_double_owner():
    """JAX pin :397."""
    eng = _engine()
    _add(eng, _workload(seed=0))
    victim = None
    while eng.has_work() and victim is None:
        eng.step()
        victim = next((r for r in eng.scheduler.waiting
                       if r.offload is not None), None)
    assert victim is not None
    tier = eng.pool.host_tier
    slot = victim.offload.slots[0]
    tier._bufs[0][0][slot] += 1.0            # corrupt the spilled bytes
    with pytest.raises(InvariantViolation, match="content-hash"):
        audit_engine(eng)
    tier._hash[slot] = tier.content_hash(slot)   # heal
    audit_engine(eng)
    other = eng.scheduler.waiting[0]
    saved = other.offload
    other.offload = OffloadRecord(0, 4, [slot])  # double ownership
    with pytest.raises(InvariantViolation):
        audit_engine(eng)
    other.offload = saved
    eng.run()


# ------------------------------------------------------------------ fuzz


@pytest.mark.parametrize("block", range(3))
def test_fuzz_spill_pagein_token_exact_no_leaks(block):
    """The JAX fuzz (:533) at 12 trials a case: random pools, batches,
    tier caps (tiny caps drop), budgets, the prefix cache on half the
    trials, prefetch depths, async spills and mid-flight
    kill-and-restore, under the auditor: every trial drains token for
    token as naive_generate, with no device-page, slot or host-slot
    leak."""
    totals = dict.fromkeys(("preempt", "spill", "pagein", "resume",
                            "drops", "restores"), 0)
    for trial in range(12 * block, 12 * block + 12):
        wl = np.random.default_rng(9000 + trial)
        block_size = int(wl.integers(2, 5))
        num_blocks = int(wl.integers(5, 15))
        max_model_len = (num_blocks - 1) * block_size
        runner = TorchStubRunner(block_size=block_size,
                                 max_model_len=max_model_len)
        budget = (None if int(wl.integers(0, 4)) == 0
                  else int(wl.integers(1, 9)))
        kw = dict(num_blocks=num_blocks,
                  max_batch_size=int(wl.integers(1, 5)),
                  max_model_len=max_model_len,
                  max_prefill_tokens_per_step=budget,
                  enable_prefix_cache=bool(wl.integers(0, 2)),
                  host_tier_pages=int(wl.choice([1, 2, 4, 8, 32])),
                  host_tier_headroom=bool(wl.integers(0, 2)),
                  pagein_prefetch=int(wl.integers(0, 4)),
                  spill_async=bool(wl.integers(0, 2)))
        eng = ServingEngine(runner, **kw)
        assert eng.audit
        header = list(map(int, wl.integers(0, VOCAB,
                                           int(wl.integers(0, 10)))))
        pending = []
        for _ in range(int(wl.integers(2, 9))):
            plen = int(wl.integers(1, min(14, max_model_len - 1) + 1))
            p = list(map(int, wl.integers(0, VOCAB, plen)))
            if header and int(wl.integers(0, 2)) == 0:
                h = header[:max(0, plen - 1)]
                p[:len(h)] = h
            mt = int(wl.integers(1, min(8, max_model_len - plen) + 1))
            pending.append((p, mt))
        n_req = len(pending)
        work = []
        kill_at = (int(wl.integers(2, 10))
                   if int(wl.integers(0, 4)) == 0 else None)
        steps = 0

        def bank(m):
            for key, name in (("preempt", "preemptions"),
                              ("spill", "offload_spill_pages"),
                              ("pagein", "pagein_pages"),
                              ("resume", "offload_resumes"),
                              ("drops", "host_tier_drops")):
                totals[key] += m[name]

        while pending or eng.has_work():
            for _ in range(int(wl.integers(0, 3))):
                if pending:
                    p, mt = pending.pop(0)
                    work.append((eng.add_request(
                        p, SamplingParams(max_tokens=mt)), p, mt))
            eng.step()
            steps += 1
            if kill_at is not None and steps == kill_at:
                bank(eng.metrics.snapshot())
                eng = ServingEngine.restore(runner, eng.snapshot())
                assert eng.pool.host_tier.used_count == 0
                totals["restores"] += 1
        outs = eng.outputs()
        assert len(outs) == n_req, f"trial {trial}: lost requests"
        eng.release_prefix_cache()
        assert eng.pool.allocator.check_no_leaks(), trial
        tier = eng.pool.host_tier
        tier.sync()
        assert set(tier._hash) == set(tier._prefix.values()), trial
        bank(eng.metrics.snapshot())
        for rid, p, mt in work:
            assert outs[rid].finish_reason == "length"
            assert outs[rid].output_tokens == naive_generate(
                runner, p, SamplingParams(max_tokens=mt),
                max_model_len=max_model_len), f"trial {trial}: {rid}"
    assert totals["preempt"] > 0 and totals["spill"] > 0
    assert totals["pagein"] > 0 and totals["resume"] > 0
    assert totals["drops"] > 0


# ------------------------------------- a small Llama, against the JAX engine

SIZES = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             num_kv_heads=1, max_seq_len=64)


@pytest.fixture(scope="module")
def pair():
    """(JAX GQA Llama, the port's Llama holding its weights)."""
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(dropout=0.0, **SIZES))
    jm.eval()
    arrays = {k: np.asarray(v)
              for k, v in functionalize(jm).param_values().items()}
    pm = Llama(LlamaConfig(**SIZES), device="cpu", seed=1)
    load_params(pm, arrays)
    return jm, pm


def test_int8_offload_resume_matches_int8_naive_oracle(pair):
    """JAX pin :456: with whole-prompt prefill the int8 engine is token for
    token the int8 naive oracle across preemptions, because a page-in
    restores the exact codes and scales."""
    _, pm = pair
    runner = LlamaRunner(pm, 8, 64, kv_dtype="int8")
    eng = ServingEngine(runner, num_blocks=9, max_batch_size=2,
                        max_model_len=64, host_tier_pages=16)
    wl = np.random.default_rng(7)
    work = [(list(map(int, wl.integers(1, 97, 20))), 16) for _ in range(2)]
    ids = _add(eng, work)
    outs = eng.run()
    m = eng.metrics.snapshot()
    assert m["preemptions"] >= 1 and m["offload_resumes"] >= 1
    _assert_oracle(runner, ids, outs, max_model_len=64)
    assert eng.pool.allocator.check_no_leaks()
    assert eng.pool.host_tier.used_count == 0


@pytest.mark.parametrize("kv_dtype,knobs", [
    ("fp32", {}), ("fp32", {"pipelined": True, "spill_async": True}),
    ("int8", {}), ("fp32", {"enable_prefix_cache": True,
                            "max_prefill_tokens_per_step": 16})],
    ids=["fp32", "fp32-pipelined-async", "int8", "fp32-prefix-chunked"])
def test_llama_twins_with_the_tier_equal_the_jax_engine(pair, kv_dtype,
                                                        knobs):
    """The port's engine and the JAX engine with the tier on, a small
    Llama on the same numpy weights, a pool tight enough to preempt: equal
    greedy tokens and equal offload / page-in / drop counts on the same
    schedule."""
    jm, pm = pair
    kw = dict(num_blocks=10, max_batch_size=3, max_model_len=64,
              host_tier_pages=12, **knobs)
    eng = ServingEngine(LlamaRunner(pm, 8, 64, kv_dtype=kv_dtype), **kw)
    jeng = JaxServingEngine(JaxLlamaRunner(jm, 8, 64, "reference",
                                           kv_dtype=kv_dtype), **kw)
    wl = np.random.default_rng(11)
    work = [(list(map(int, wl.integers(1, 97, int(wl.integers(9, 20))))),
             int(wl.integers(8, 16))) for _ in range(5)]
    ids, jids = _add(eng, work), _add(jeng, work, JaxSamplingParams)
    outs, jouts = eng.run(), jeng.run()
    assert [outs[r].output_tokens for r, _, _ in ids] == \
        [jouts[r].output_tokens for r, _, _ in jids]
    m, jm_ = eng.metrics.snapshot(), jeng.metrics.snapshot()
    assert m["preemptions"] > 0 and m["offload_resumes"] > 0
    assert {k: m[k] for k in TIER_METRICS} == \
        {k: jm_[k] for k in TIER_METRICS}
    eng.release_prefix_cache()
    assert eng.pool.allocator.check_no_leaks()


def test_async_spill_worker_races_frees_and_reuse_without_a_lost_update():
    """The worker thread writes slot hashes while the loop frees and
    reuses the slots (a switch interval of 1 µs): after sync() every used
    slot's hash is its content's, no freed slot keeps one, and a failing
    job raises on the loop."""
    import sys
    import time

    pool = KVCachePool(num_layers=2, num_blocks=12, block_size=4,
                       n_kv_heads=2, head_dim=3, device="cpu")
    for layer in pool.pools:
        for a in layer:
            a.copy_(torch.randn(a.shape, generator=torch.Generator()
                                .manual_seed(6)))
    tier = pool.enable_host_tier(6, async_spill=True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t0 = time.monotonic()
    try:
        rng = np.random.default_rng(0)
        held = []
        for _ in range(300):
            held += tier.spill_pages(list(map(int, rng.integers(1, 12, 2))))
            if len(held) > 3:
                k = int(rng.integers(1, len(held)))
                tier.free_slots(held[:k])
                held = held[k:]
        tier.sync()
    finally:
        sys.setswitchinterval(old)
    assert time.monotonic() - t0 < 60
    assert set(tier._hash) == set(held)
    assert all(tier._hash[s] == tier.content_hash(s) for s in held)
    assert tier.free_count + len(held) == tier.max_pages

    def fail(*args):
        raise RuntimeError("copy failed")

    tier._spill_job = fail
    slots = tier.spill_pages([1])
    tier.free_slots(slots)
    with pytest.raises(RuntimeError, match="copy failed"):
        tier.sync()
