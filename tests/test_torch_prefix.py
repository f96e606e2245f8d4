"""The port's shared-prefix page cache against the JAX package, on the CPU.

Follows tests/test_serving_prefix.py on a small Llama bridged from JAX:

  * `page_content_hash` and `KVCachePool.chain_seed` equal the JAX ones;
  * the refcounted allocator, LRU eviction with cached-free pages as
    headroom, "a match leaves one token to compute", `truncate` refusing
    a registered page and copy-on-write never mutating a shared page
    (codes and scale rows on int8 pools, bytes on fp8 pools), as the JAX
    pins state them;
  * the port and JAX engines on seeded shared-prefix traffic give equal
    tokens, prefix_hit_tokens, cow_copies and block tables after every
    step, over fp32, int8 and fp8 pools; preemption resumes through cache
    hits;
  * a short fuzz of shared prefixes, budgets and pool sizes leaks nothing.

Every engine runs under the invariant auditor.
"""

import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.serving import KVCachePool as JaxKVCachePool
from paddle_tpu.serving import LlamaRunner as JaxLlamaRunner
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import page_content_hash as jax_page_content_hash
from paddle_tpu_torch.models import Llama, LlamaConfig
from paddle_tpu_torch.serving import (
    BlockAllocator, KVCachePool, LlamaRunner, PrefixCache, SamplingParams,
    SequenceKV, ServingEngine, naive_generate, page_content_hash,
)
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

SIZES = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=96)
MAX_LEN = 96
KINDS = ["fp32", "int8", "fp8"]


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


@pytest.fixture(scope="module")
def pair():
    """(JAX GQA Llama, the port's Llama holding its weights)."""
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(num_kv_heads=2, dropout=0.0, **SIZES))
    jm.eval()
    arrays = {k: np.asarray(v)
              for k, v in functionalize(jm).param_values().items()}
    pm = Llama(LlamaConfig(num_kv_heads=2, **SIZES), device="cpu", seed=1)
    load_params(pm, arrays)
    return jm, pm


def _engines(pair, kv_dtype="fp32", **kw):
    """(port engine, JAX engine) with the same knobs; the JAX runner takes
    its gather path, the port's the kernels' plain versions."""
    jm, pm = pair
    kw = {"num_blocks": 40, "max_batch_size": 3, "max_model_len": MAX_LEN,
          "max_prefill_tokens_per_step": 16, "enable_prefix_cache": True,
          **kw}
    ours = ServingEngine(LlamaRunner(pm, 8, MAX_LEN, kv_dtype=kv_dtype),
                         **kw)
    ref = JaxServingEngine(JaxLlamaRunner(jm, 8, MAX_LEN, "reference",
                                          kv_dtype=kv_dtype), **kw)
    return ours, ref


def _shared_prefix_work(seed, n=6, header=24, lo=2, hi=9, max_tokens=6):
    """Requests that share a ``header``-token system prompt, each with a
    tail of its own."""
    rng = np.random.default_rng(seed)
    head = list(map(int, rng.integers(1, 97, header)))
    return [(head + list(map(int, rng.integers(1, 97,
                                                int(rng.integers(lo, hi))))),
             max_tokens) for _ in range(n)]


def _tables(eng):
    return [(r.request_id, list(r.kv.pages)) for r in eng.scheduler.running]


def _lockstep(ours, ref, work, stagger=1):
    """Feed both engines the same requests (one more every ``stagger``
    steps after the first's first token), step them together and compare
    the block tables after every step. Returns each engine's streams."""
    pending = list(enumerate(work))
    outs = {}
    step = 0
    while pending or ours.has_work() or ref.has_work():
        if pending and (step == 0 or (step % stagger == 0
                                      and ours.metrics.tokens_generated.value
                                      > 0)):
            i, (p, mt) = pending.pop(0)
            ours.add_request(p, SamplingParams(max_tokens=mt), f"r{i}")
            ref.add_request(p, JaxSamplingParams(max_tokens=mt), f"r{i}")
        ours.step()
        ref.step()
        assert _tables(ours) == _tables(ref), f"block tables part at {step}"
        step += 1
    o, r = ours.outputs(), ref.outputs()
    for i in range(len(work)):
        outs[i] = (o[f"r{i}"].output_tokens, r[f"r{i}"].output_tokens)
    return outs


# ------------------------------------------------------------ the hash

def test_page_content_hash_and_chain_seed_equal_jax():
    rng = np.random.default_rng(0)
    ours = ref = KVCachePool(1, 4, 4, 1, 8, device="cpu").chain_seed(None)
    assert ref == JaxKVCachePool(1, 4, 4, 1, 8).chain_seed(None)
    for _ in range(6):
        page = list(map(int, rng.integers(0, 32000, 4)))
        ours = page_content_hash(ours, page)
        ref = jax_page_content_hash(ref, page)
        assert ours == ref
    for kv_dtype, tag in (("fp32", "fp32"), ("fp32", "fp8"), ("int8", "int8"),
                          ("fp8", "fp8"), ("int8", "fp32"), ("mixed", "fp32"),
                          ("mixed", "fp8")):
        seed = KVCachePool(1, 4, 4, 1, 8, device="cpu",
                           kv_dtype=kv_dtype).chain_seed(tag)
        jax_seed = JaxKVCachePool(1, 4, 4, 1, 8,
                                  kv_dtype=kv_dtype).chain_seed(tag)
        native = KVCachePool(1, 4, 4, 1, 8, device="cpu",
                             kv_dtype=kv_dtype).chain_seed(None)
        ref_native = JaxKVCachePool(1, 4, 4, 1, 8,
                                    kv_dtype=kv_dtype).chain_seed(None)
        if tag == ("fp32" if kv_dtype == "mixed" else kv_dtype):
            assert seed == jax_seed == native
        else:
            # another tag folds itself in, in both packages: the JAX one
            # by Python's per-process hash of (seed, tag), the port by a
            # CRC-32 of the tag's name, the same in every process
            assert seed != native and jax_seed != ref_native
            assert seed == page_content_hash(native, [zlib.crc32(
                tag.encode())])


# ----------------------------------------------- allocator and the cache

def test_refcounted_allocator_unit():
    a = BlockAllocator(8)
    pages = a.alloc(3)
    assert pages == [1, 2, 3]
    assert a.refcount(1) == 1
    assert a.incref(1) == 2
    assert a.decref(1) == 1
    assert 1 in a.allocated_pages
    assert a.decref(1) == 0
    assert 1 not in a.allocated_pages
    assert a.alloc(1) == [1]                # lowest-id-first, deterministic
    with pytest.raises(ValueError):
        a.decref(7)
    with pytest.raises(ValueError):
        a.incref(7)
    a.free([1, 2, 3])
    with pytest.raises(ValueError):
        a.free([2])                         # double free stays loud
    assert a.check_no_leaks()


def test_prefix_cache_eviction_lru_and_headroom():
    pool = KVCachePool(1, 6, 2, 1, 8, device="cpu")
    cache = pool.enable_prefix_cache()
    assert pool.enable_prefix_cache() is cache        # idempotent
    assert isinstance(cache, PrefixCache)
    seq = SequenceKV(pool)
    tokens = [1, 2, 3, 4, 5]
    seq.grow(len(tokens))                   # 3 pages
    seq.num_tokens = 4                      # two FULL pages
    assert cache.register_seq(seq, tokens) == 2
    assert len(cache) == 2 and cache.pages() == frozenset(seq.pages[:2])
    first, second = seq.pages[:2]
    cache.acquire(cache.match([1, 2, 9]))   # touches the first page only
    cache.unacquire(cache.match([1, 2, 9]))
    seq.release()                           # the cache alone holds them
    assert cache.evictable_count() == pool.allocator.num_evictable == 2
    assert pool.allocator.num_free == 3
    assert pool.allocator.can_alloc(5)      # 3 free + 2 evictable
    got = pool.allocator.alloc(4)           # evicts the LRU page only
    assert len(got) == 4 and second in got and first not in got
    assert cache.evictions == 1 and len(cache) == 1
    pool.allocator.free(got)
    assert cache.clear() == 1
    assert pool.allocator.check_no_leaks()


def test_match_tiered_has_no_host_part_and_register_page():
    pool = KVCachePool(1, 8, 2, 1, 8, device="cpu")
    cache = pool.enable_prefix_cache()
    page = pool.allocator.alloc(1)[0]
    h = page_content_hash(pool.chain_seed(None), [3, 4])
    assert cache.register_page(page, h)
    assert not cache.register_page(page, h)            # first writer wins
    assert cache.match_tiered([3, 4, 5]) == ([(h, page)], [])
    assert cache.match([3, 4]) == []        # the match leaves one token
    pool.allocator.free([page])
    cache.clear()
    assert pool.allocator.check_no_leaks()


def test_truncate_refuses_a_registered_page():
    pool = KVCachePool(1, 8, 2, 1, 8, device="cpu")
    cache = pool.enable_prefix_cache()
    seq = SequenceKV(pool)
    seq.grow(6)
    seq.num_tokens = 4
    cache.register_seq(seq, [1, 2, 3, 4, 5, 6])
    assert seq.truncate(5) == 0
    with pytest.raises(ValueError, match="registered"):
        seq.truncate(2)
    seq.release()
    cache.clear()
    assert pool.allocator.check_no_leaks()


def _write_page(pool, page, gen):
    """Fill one page of every layer with seeded values, as the runner's
    write would (codes and scale rows on int8, bytes on fp8)."""
    for layer in pool.pools:
        for t in layer:
            if t.dtype == torch.int8:
                t[page] = torch.randint(-127, 128, t[page].shape,
                                        generator=gen, dtype=torch.int8)
            elif t.dtype == torch.float8_e4m3fn:
                t.view(torch.uint8)[page] = torch.randint(
                    0, 120, t[page].shape, generator=gen,
                    dtype=torch.uint8)
            else:
                t[page] = torch.rand(t[page].shape, generator=gen)


def _page(pool, page):
    return [(t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
             else t)[page].clone() for layer in pool.pools for t in layer]


@pytest.mark.parametrize("kv_dtype", KINDS)
def test_cow_shared_page_never_mutated_in_place(kv_dtype):
    pool = KVCachePool(2, 8, 4, 2, 8, device="cpu", kv_dtype=kv_dtype)
    cache = pool.enable_prefix_cache()
    tokens = [5, 6, 7, 8, 9]
    a = SequenceKV(pool)
    a.grow(len(tokens) + 1)                 # pages [1, 2]
    _write_page(pool, a.pages[0], torch.Generator().manual_seed(3))
    a.num_tokens = len(tokens)
    cache.register_seq(a, tokens)           # page 1 is now cached (full)

    b = SequenceKV(pool)
    matched = cache.match(tokens)
    assert [p for _, p in matched] == [a.pages[0]]
    cache.acquire(matched)
    b.adopt_prefix(matched, pool.block_size)
    b.grow(len(tokens) + 1 - b.num_tokens)
    shared = b.pages[0]
    assert shared == a.pages[0]
    assert pool.allocator.refcount(shared) == 3      # a + b + the cache

    before = _page(pool, shared)
    assert len(before) == 2 * (4 if kv_dtype == "int8" else 2)
    assert b.ensure_writable(0, 4) == 1
    assert b.pages[0] != shared and a.pages[0] == shared
    assert pool.allocator.refcount(shared) == 2
    assert pool.allocator.refcount(b.pages[0]) == 1
    assert b.registered_pages == 0 and b.hash_chain == []
    for x, y, z in zip(before, _page(pool, shared), _page(pool, b.pages[0])):
        assert torch.equal(x, y)            # the shared page is unchanged
        assert torch.equal(x, z)            # the fork carries codes, scales
    assert b.ensure_writable(0, 4) == 0     # the fork is private now
    b.release()
    a.release()
    cache.clear()
    assert pool.allocator.check_no_leaks()


# --------------------------------------------------------------- engines

@pytest.mark.parametrize("kv_dtype", KINDS)
def test_engines_equal_jax_step_by_step(pair, kv_dtype):
    """Staggered shared-prefix traffic: the same tokens, prefix hits, forks
    and block tables after every step as the JAX engine."""
    ours, ref = _engines(pair, kv_dtype)
    work = _shared_prefix_work(seed=1)
    outs = _lockstep(ours, ref, work, stagger=2)
    for i, (a, b) in outs.items():
        assert a == b, f"request {i}"
    for key in ("prefix_hit_tokens", "cow_copies", "prefill_tokens",
                "prefix_cached_pages"):
        assert ours.metrics.snapshot()[key] == ref.metrics.snapshot()[key], \
            key
    assert ours.metrics.prefix_hit_tokens.value >= 3 * 24
    assert ours.release_prefix_cache() == ref.release_prefix_cache() > 0
    assert ours.pool.allocator.check_no_leaks()


def test_shared_prefix_saves_prefill_and_equals_naive(pair):
    ours, _ = _engines(pair, max_batch_size=2)
    work = _shared_prefix_work(seed=4, n=8, header=32)
    ids = []
    for p, mt in work[:1]:
        ids.append(ours.add_request(p, SamplingParams(max_tokens=mt)))
    ours.step()
    ours.step()
    ours.step()                             # the header is registered
    for p, mt in work[1:]:
        ids.append(ours.add_request(p, SamplingParams(max_tokens=mt)))
    outs = ours.run()
    total = sum(len(p) for p, _ in work)
    computed = ours.metrics.prefill_tokens.value
    hits = ours.metrics.prefix_hit_tokens.value
    assert computed + hits == total         # nothing skipped or doubled
    assert hits == 7 * 32
    for rid, (p, mt) in zip(ids, work):
        assert outs[rid].output_tokens == naive_generate(
            ours.runner, p, SamplingParams(max_tokens=mt),
            max_model_len=MAX_LEN)
    assert ours.release_prefix_cache() > 0
    assert ours.pool.allocator.check_no_leaks()


def test_prefix_match_always_leaves_one_token_to_compute(pair):
    ours, ref = _engines(pair, max_batch_size=1)
    p = list(range(1, 17))                  # exactly two pages
    outs = []
    for eng, sp in ((ours, SamplingParams), (ref, JaxSamplingParams)):
        first = eng.add_request(p, sp(max_tokens=2))
        eng.run()
        second = eng.add_request(p, sp(max_tokens=2))
        got = eng.run()
        assert got[first].output_tokens == got[second].output_tokens
        outs.append((eng.metrics.prefix_hit_tokens.value,
                     eng.metrics.prefill_tokens.value))
    assert outs[0] == outs[1] == (8, 16 + 8)


def test_preemption_resume_is_mostly_cache_hits(pair):
    ours, ref = _engines(pair, num_blocks=16, max_batch_size=3,
                         max_prefill_tokens_per_step=None)
    rng = np.random.default_rng(9)
    work = [(list(map(int, rng.integers(1, 97, int(rng.integers(24, 40))))),
             int(rng.integers(10, 20))) for _ in range(6)]
    outs = _lockstep(ours, ref, work, stagger=1)
    assert ours.metrics.preemptions.value >= 1, "no preemption exercised"
    assert ours.metrics.prefix_hit_tokens.value > 0
    assert ours.metrics.snapshot()["prefix_hit_tokens"] == \
        ref.metrics.snapshot()["prefix_hit_tokens"]
    for i, (a, b) in outs.items():
        assert a == b == naive_generate(
            ours.runner, work[i][0], SamplingParams(max_tokens=work[i][1]),
            max_model_len=MAX_LEN)
    ours.release_prefix_cache()
    assert ours.pool.allocator.check_no_leaks()


def test_cached_free_pages_count_as_admission_headroom(pair):
    """A pool full of cached-free pages still admits: eviction funds the
    new request, LRU first, and the auditor stays clean."""
    ours, _ = _engines(pair, num_blocks=14, max_batch_size=1,
                       admission_watermark=0.5)
    rng = np.random.default_rng(2)
    for _ in range(4):
        p = list(map(int, rng.integers(1, 97, 30)))
        rid = ours.add_request(p, SamplingParams(max_tokens=3))
        out = ours.run()[rid].output_tokens
        assert out == naive_generate(ours.runner, p,
                                     SamplingParams(max_tokens=3),
                                     max_model_len=MAX_LEN)
    assert ours.pool.prefix_cache.evictions > 0
    ours.release_prefix_cache()
    assert ours.pool.allocator.check_no_leaks()


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_shared_prefixes_leak_nothing(pair, seed):
    rng = np.random.default_rng(100 + seed)
    kw = dict(num_blocks=int(rng.integers(14, 40)),
              max_batch_size=int(rng.integers(1, 4)),
              max_prefill_tokens_per_step=[None, 8, 16][seed % 3],
              ragged_batch=bool(seed % 2))
    ours, _ = _engines(pair, **kw)
    heads = [list(map(int, rng.integers(1, 97, int(rng.integers(8, 30)))))
             for _ in range(2)]
    work = []
    for i in range(6):
        p = heads[i % 2] + list(map(int, rng.integers(
            1, 97, int(rng.integers(1, 9)))))
        sp = SamplingParams(max_tokens=int(rng.integers(2, 9)))
        work.append((ours.add_request(p, sp), p, sp))
        if i % 2:
            ours.step()
    outs = ours.run()
    for rid, p, sp in work:
        assert outs[rid].output_tokens == naive_generate(
            ours.runner, p, sp, max_model_len=MAX_LEN)
    ours.release_prefix_cache()
    assert ours.pool.allocator.check_no_leaks()
