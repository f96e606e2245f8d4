"""The prefill / decode KV handoff of the port against the JAX package, on
the CPU.

Ports the thread-side pins of tests/test_serving_procs.py (its engine
handoff, int8 bit-exactness and thread-split cases; the process backend's
are in tests/test_torch_procs.py): a prefill-role engine samples each request's first
token, spills its pages from page 0 and parks it; `extract_handoff`
exports the pages (numpy arrays and CRC content hashes), a sibling's
`import_handoff` writes them into its own host tier, re-verifying each
hash, and its admission pages them in, so the continued stream equals
`naive_generate` with no recompute. Across the frameworks: the same
spilled fp32 or int8 page exports to the same bytes and CRC in both
packages, both engines hand off the same requests with the same counts
and tokens, and a payload with one flipped byte raises the same exception
in both. At the tier, `prefill_replicas=1` gives the mixed tier's streams
with every page moved by copy, int8 codes and scale rows included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.serving import KVCachePool as JaxKVCachePool
from paddle_tpu.serving import LlamaRunner as JaxLlamaRunner
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.models import Llama, LlamaConfig
from paddle_tpu_torch.serving import (
    KVCachePool, LlamaRunner, SamplingParams, ServingEngine, ServingRouter,
    audit_engine, audit_router, naive_generate,
)
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

VOCAB, BLOCK, MAXLEN = 97, 4, 64
SIZES = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=MAXLEN)
ENGINE_KW = dict(num_blocks=24, max_batch_size=4, max_model_len=MAXLEN,
                 enable_prefix_cache=True, max_prefill_tokens_per_step=8)
HANDOFF_METRICS = ("handoffs_out", "handoffs_in", "handoff_pages_out",
                   "handoff_pages_in", "handoff_recompute_fallbacks",
                   "handoff_bytes_out")


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


def runner(pm, kv_dtype="fp32"):
    return LlamaRunner(pm, BLOCK, MAXLEN, kv_dtype=kv_dtype)


def oracle(pm, prompt, sp, kv_dtype="fp32"):
    return naive_generate(runner(pm, kv_dtype), prompt, sp,
                          max_model_len=MAXLEN)


def build_engine(pm, kv_dtype="fp32", **kw):
    merged = dict(ENGINE_KW)
    merged.update(kw)
    return ServingEngine(runner(pm, kv_dtype), **merged)


def workload(n=12, seed=0):
    """Greedy and seeded-temperature requests over random prompts."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = list(map(int, rng.integers(1, VOCAB,
                                            int(rng.integers(4, 16)))))
        out.append((prompt, dict(
            max_tokens=int(rng.integers(3, 8)),
            temperature=0.5 if i % 3 == 0 else 0.0,
            seed=100 + i if i % 3 == 0 else None)))
    return out


def _stage_all(eng, rids, steps=80):
    for _ in range(steps):
        eng.step()
        if len(eng.handoff_ready()) == sum(1 for r in rids
                                           if r in eng._requests):
            break


# ------------------------------------------------- engine-level handoff


def test_prefill_role_stages_and_decode_continues_token_exact(pair):
    """A prefill-role engine hands every request to a decode engine with
    its pages: streams equal naive_generate, greedy and seeded, nothing
    recomputed, the imported slots' bytes equal the exported ones."""
    _, pm = pair
    pre = build_engine(pm, role="prefill", host_tier_pages=32)
    dec = build_engine(pm, role="decode", host_tier_pages=32)
    work = workload(6)
    rids = [pre.add_request(p, SamplingParams(**sp)) for p, sp in work]
    _stage_all(pre, rids)
    assert not pre.scheduler.has_work()
    moved = 0
    for rid in list(pre.handoff_ready()):
        state, payload = pre.extract_handoff(rid)
        assert payload is not None and payload["hashes"]
        dec.import_handoff(state, payload)
        rec = dec._requests[rid].offload
        for sent, got in zip(payload["layers"],
                             dec.pool.host_tier.export_slots(rec.slots)):
            for x, y in zip(sent, got):
                assert x.tobytes() == y.tobytes()
        moved += 1
    assert moved >= 5
    outs = dict(pre.outputs())
    outs.update(dec.run())
    for rid, (p, sp) in zip(rids, work):
        assert outs[rid].output_tokens == oracle(pm, p, SamplingParams(**sp))
    assert dec.metrics.handoff_recompute_fallbacks.value == 0
    assert dec.metrics.handoff_pages_in.value > 0
    assert dec.metrics.pagein_pages.value == \
        dec.metrics.handoff_pages_in.value
    for eng in (pre, dec):
        eng.release_prefix_cache()
        assert eng.pool.allocator.check_no_leaks()
        # what the tier still holds are the cache's demoted pages
        tier = eng.pool.host_tier
        assert tier.used_count == tier.prefix_count
        audit_engine(eng)


def test_handoff_counts_and_tokens_equal_the_jax_engines(pair):
    """The same requests through a prefill engine and a decode engine in
    each package: the same requests staged, the same handoff counts
    (payload bytes included) and the same continued tokens."""
    jm, pm = pair
    kw = dict(ENGINE_KW, host_tier_pages=32)
    work = workload(5, seed=4)
    results = []
    for mk_runner, SP, Engine in (
            (lambda: runner(pm), SamplingParams, ServingEngine),
            (lambda: JaxLlamaRunner(jm, BLOCK, MAXLEN, "reference"),
             JaxSamplingParams, JaxServingEngine)):
        pre = Engine(mk_runner(), role="prefill", **kw)
        dec = Engine(mk_runner(), role="decode", **kw)
        rids = [pre.add_request(p, SP(**sp), request_id=f"h{i}")
                for i, (p, sp) in enumerate(work)]
        _stage_all(pre, rids)
        staged = list(pre.handoff_ready())
        for rid in staged:
            dec.import_handoff(*pre.extract_handoff(rid))
        outs = dict(pre.outputs())
        outs.update(dec.run())
        snap = {k: pre.metrics.snapshot()[k] + dec.metrics.snapshot()[k]
                for k in HANDOFF_METRICS}
        results.append((staged, snap,
                        {r: outs[r].output_tokens for r in rids}))
    assert results[0] == results[1]
    assert results[0][1]["handoff_pages_in"] > 0


def test_handoff_without_tier_falls_back_to_recompute(pair):
    _, pm = pair
    pre = build_engine(pm, role="prefill")        # no host tier
    dec = build_engine(pm)
    p, sp = [1, 2, 3, 4, 5, 6], SamplingParams(max_tokens=6)
    rid = pre.add_request(p, sp)
    _stage_all(pre, [rid], 30)
    state, payload = pre.extract_handoff(rid)
    assert payload is None
    dec.import_handoff(state, payload)
    assert dec.run()[rid].output_tokens == oracle(pm, p, sp)
    assert dec.metrics.handoff_recompute_fallbacks.value == 1


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_flipped_byte_raises_at_receive_in_both_packages(pair, kv_dtype):
    """One flipped byte of a payload raises ValueError (content hash) at
    import_handoff in both packages, and the refused slots are freed."""
    jm, pm = pair
    kinds = []
    for Engine, mk, SP in (
            (ServingEngine, lambda: runner(pm, kv_dtype), SamplingParams),
            (JaxServingEngine, lambda: JaxLlamaRunner(
                jm, BLOCK, MAXLEN, "reference", kv_dtype=kv_dtype),
             JaxSamplingParams)):
        pre = Engine(mk(), role="prefill", host_tier_pages=32, **ENGINE_KW)
        dec = Engine(mk(), host_tier_pages=32, **ENGINE_KW)
        rid = pre.add_request([5, 4, 3, 2, 1, 6, 7, 8, 9],
                              SP(max_tokens=6))
        _stage_all(pre, [rid], 30)
        state, payload = pre.extract_handoff(rid)
        codes = np.asarray(payload["layers"][0][0])
        raw = bytearray(codes.tobytes())
        raw[3] ^= 0x01
        tampered = np.frombuffer(bytes(raw), codes.dtype).reshape(
            codes.shape)
        payload["layers"][0] = (tampered,) + tuple(payload["layers"][0][1:])
        with pytest.raises(Exception) as ei:
            dec.import_handoff(state, payload)
        assert "content-hash" in str(ei.value)
        assert dec.pool.host_tier.used_count == 0
        kinds.append(type(ei.value))
    assert kinds[0].__name__ == kinds[1].__name__ == "ValueError"


def test_abort_of_staged_handoff_releases_slots(pair):
    _, pm = pair
    pre = build_engine(pm, role="prefill", host_tier_pages=32)
    rid = pre.add_request([1, 2, 3, 4, 5, 6, 7], SamplingParams(max_tokens=6))
    _stage_all(pre, [rid], 30)
    assert pre.pool.host_tier.used_count > 0
    assert pre.abort(rid)
    assert pre.handoff_ready() == []
    assert pre.pool.host_tier.used_count == 0
    assert pre.outputs()[rid].finish_reason == "aborted"
    audit_engine(pre)


def test_snapshot_carries_staged_handoffs_and_role(pair):
    """A crash mid-handoff loses the host pages but never the request:
    the snapshot holds staged handoffs as waiters and the restored
    prefill engine re-stages them."""
    _, pm = pair
    pre = build_engine(pm, role="prefill", host_tier_pages=32)
    p, sp = [9, 8, 7, 6, 5, 4], SamplingParams(max_tokens=5)
    rid = pre.add_request(p, sp)
    _stage_all(pre, [rid], 30)
    snap = pre.snapshot()
    assert snap["config"]["role"] == "prefill"
    assert any(r["request_id"] == rid for r in snap["requests"])
    fresh = ServingEngine.restore(runner(pm), snap)
    assert fresh.role == "prefill"
    _stage_all(fresh, [rid], 30)
    state, payload = fresh.extract_handoff(rid)
    dec = build_engine(pm, host_tier_pages=32)
    dec.import_handoff(state, payload)
    assert dec.run()[rid].output_tokens == oracle(pm, p, sp)


def test_stage_migration_and_extract_request(pair):
    """stage_migration parks a running decode-phase request (pages
    spilled) and refuses one still prefilling; extract_request takes a
    waiting request out and refuses a running or staged one."""
    _, pm = pair
    eng = build_engine(pm, host_tier_pages=32, max_batch_size=1)
    a = eng.add_request([1, 2, 3, 4, 5, 6, 7], SamplingParams(max_tokens=8))
    b = eng.add_request([7, 6, 5, 4], SamplingParams(max_tokens=4))
    assert not eng.stage_migration(a)          # waiting, not admitted
    while not eng._requests[a].output_tokens:
        eng.step()
    with pytest.raises(ValueError, match="WAITING"):
        eng.extract_request(a)
    assert eng.stage_migration(a)
    assert eng.handoff_ready() == [a]
    with pytest.raises(ValueError):
        eng.extract_request(a)
    state = eng.extract_request(b)
    assert state["prompt_tokens"] == [7, 6, 5, 4]
    with pytest.raises(KeyError):
        eng.extract_request(b)
    st, payload = eng.extract_handoff(a)
    dec = build_engine(pm, host_tier_pages=32)
    dec.import_handoff(st, payload)
    dec.inject_request(state["prompt_tokens"], state["sampling"],
                       request_id=b, arrival_index=state["arrival_index"])
    outs = dec.run()
    assert outs[a].output_tokens == oracle(
        pm, [1, 2, 3, 4, 5, 6, 7], SamplingParams(max_tokens=8))
    assert outs[b].output_tokens == oracle(pm, [7, 6, 5, 4],
                                           SamplingParams(max_tokens=4))
    assert dec.metrics.handoff_recompute_fallbacks.value == 0


# -------------------------------------------- the tier's pages, by bytes


def _filled_pools(kv_dtype, seed=7):
    """A port pool and a JAX pool whose pages 1-3 hold the same random
    bytes (codes and scale rows on int8)."""
    rng = np.random.default_rng(seed)
    ours = KVCachePool(2, 8, BLOCK, 2, 4, torch.float32, device="cpu",
                       kv_dtype=kv_dtype)
    ref = JaxKVCachePool(2, 8, BLOCK, 2, 4, jnp.float32, kv_dtype=kv_dtype)
    pages = ours.allocator.alloc(3)
    assert ref.allocator.alloc(3) == pages
    new_ref = []
    for layer, jlayer in zip(ours.pools, ref.pools):
        jl = []
        for t, a in zip(layer, jlayer):
            shape = (3,) + tuple(t.shape[1:])
            if t.dtype == torch.int8:
                vals = rng.integers(-128, 128, shape).astype(np.int8)
            else:
                vals = rng.standard_normal(shape).astype(np.float32)
            t[pages] = torch.from_numpy(vals)
            jl.append(a.at[jnp.asarray(pages)].set(jnp.asarray(vals)))
        new_ref.append(tuple(jl))
    ref.pools = new_ref
    return ours, ref, pages


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_export_slots_equals_the_jax_export(kv_dtype):
    """The same spilled pages export to the same arrays (dtype, shape,
    bytes) and carry the same CRC content hashes in both packages; an
    import into a second tier lands bit for bit and re-verifies."""
    ours, ref, pages = _filled_pools(kv_dtype)
    for pool in (ours, ref):
        pool.enable_host_tier(8)
    slots = ours.host_tier.spill_pages(pages)
    jslots = ref.host_tier.spill_pages(pages)
    assert slots == jslots
    got, want = ours.host_tier.export_slots(slots), \
        ref.host_tier.export_slots(jslots)
    for layer, jlayer in zip(got, want):
        assert len(layer) == len(jlayer)
        for a, b in zip(layer, jlayer):
            b = np.asarray(b)
            assert (a.dtype, a.shape) == (b.dtype, b.shape)
            assert a.tobytes() == b.tobytes()
    hashes = [ours.host_tier.slot_hash(s) for s in slots]
    assert hashes == [ref.host_tier.slot_hash(s) for s in jslots]
    if kv_dtype == "int8":
        assert str(got[0][0].dtype) == "int8"
        assert str(got[0][2].dtype) == "float32"
    # across the packages: the JAX export imports into the port's tier
    dst = KVCachePool(2, 8, BLOCK, 2, 4, torch.float32, device="cpu",
                      kv_dtype=kv_dtype)
    dst.enable_host_tier(8)
    landed = dst.host_tier.import_slots(want, hashes)
    for a, b in zip(dst.host_tier.export_slots(landed), got):
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes()
    # a payload the tier cannot hold whole is refused, counted as drops
    assert dst.host_tier.import_slots(want, hashes[:1] * 9) is None
    assert dst.host_tier.dropped_pages == 9


def test_int8_pages_and_scales_byte_identical_after_transfer():
    """int8 codes AND scale rows survive spill -> export -> import byte
    for byte; the hashes re-verify, and a tampered transfer is refused
    with nothing held."""
    src, _, pages = _filled_pools("int8", seed=9)
    dst = KVCachePool(2, 8, BLOCK, 2, 4, torch.float32, device="cpu",
                      kv_dtype="int8")
    src.enable_host_tier(8)
    dst.enable_host_tier(8)
    slots = src.host_tier.spill_pages(pages)
    hashes = [src.host_tier.slot_hash(s) for s in slots]
    layers = src.host_tier.export_slots(slots)
    got = dst.host_tier.import_slots(layers, hashes)
    assert got is not None
    for a, b in zip(src.host_tier.export_slots(slots),
                    dst.host_tier.export_slots(got)):
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes()
    for s_src, s_dst in zip(slots, got):
        assert src.host_tier.slot_hash(s_src) == \
            dst.host_tier.slot_hash(s_dst)
    used = dst.host_tier.used_count
    layers[0][0].flat[0] ^= 1
    with pytest.raises(ValueError, match="content-hash"):
        dst.host_tier.import_slots(layers, hashes)
    assert dst.host_tier.used_count == used


# ----------------------------------------------------- the split tier


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_split_router_equals_the_mixed_tier_with_pages_by_copy(pair,
                                                               kv_dtype):
    """prefill_replicas=1 of 2: every request enters on the prefill
    replica and continues on the decode replica with its pages (int8 codes
    and scales included): streams equal the mixed tier's, no handoff
    recomputes, every received page paged in."""
    _, pm = pair
    work = workload(8)
    if kv_dtype == "int8":
        # int8 codes follow the chunk breaks: whole-prompt prefill keeps
        # the mixed tier's and the split tier's codes the same
        kw = dict(ENGINE_KW, max_prefill_tokens_per_step=None)
    else:
        kw = dict(ENGINE_KW)
    streams = []
    for split in (0, 1):
        router = ServingRouter(
            lambda idx=0: runner(pm, kv_dtype), replicas=2,
            prefill_replicas=split, host_tier_pages=64,
            heartbeat_timeout_s=60.0, poll_interval_s=0.05, **kw)
        try:
            assert [r.role for r in router._replicas] == (
                ["prefill", "decode"] if split else ["mixed", "mixed"])
            rids = [router.submit(p, SamplingParams(**sp),
                                  request_id=f"d{i}")
                    for i, (p, sp) in enumerate(work)]
            outs = router.drain(timeout_s=60.0)
            audit_router(router)
            streams.append({r: outs[r].output_tokens for r in rids})
            if split:
                rm = router.metrics.snapshot()
                eng = router.metrics_snapshot()["engines"]
                assert rm["handoffs"] >= 6 and rm["handoff_fallbacks"] == 0
                assert eng["handoffs_in"] == rm["handoffs"]
                assert eng["handoff_recompute_fallbacks"] == 0
                assert eng["handoff_pages_in"] > 0
                assert all(o.replicas[0] == 0 for o in outs.values())
            router.release_prefix_caches()
            assert router.check_no_leaks()
        finally:
            router.shutdown()
    assert streams[0] == streams[1]
    if kv_dtype == "fp32":
        for i, (p, sp) in enumerate(work):
            assert streams[1][f"d{i}"] == oracle(pm, p, SamplingParams(**sp))
