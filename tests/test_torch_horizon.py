"""Device-resident decode horizons in the port, against the port's
per-step engine, its `naive_generate` and the JAX package, on the CPU.

Follows tests/test_serving_multistep.py: `decode_horizon=s` changes how
many decode steps one runner call runs (`decode_multi`) and how often the
host drains, never the tokens. On a small Llama bridged from JAX (the
sizes of tests/test_torch_serving.py):

  * `decode_multi`'s greedy tokens and finite flags equal the JAX
    runner's on the same weights and pools;
  * s in {1, 4, 8} is token-exact against the port's per-step engine,
    its `naive_generate` and the JAX engine with the same knobs;
  * one `_to_host` drain per horizon;
  * a stop mid-horizon discards the overshoot and reclaims its pages;
  * `plan_decode_horizon` trims and never preempts; pool pressure;
  * a fault-injected `decode_multi` retries exactly;
  * both NaN-mid-horizon policies;
  * a captured step (a stub graph here; CUDA graphs need the card)
    credits the launch counts of an eager call on every replay, and the
    graph cache keeps PADDLE_TPU_MAX_JIT_CACHE entries.

Every engine runs under the invariant auditor.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch.ops.paged_attention as k2
import paddle_tpu_torch.ops.ragged_paged_attention as k1
from paddle_tpu.inference import create_serving_engine as jax_create_engine
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.serving import KVCachePool as JaxKVCachePool
from paddle_tpu.serving import LlamaRunner as JaxLlamaRunner
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.models import Llama, LlamaConfig
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.serving import (
    KVCachePool, LlamaRunner, SamplingParams, ServingEngine, naive_generate,
)
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

SIZES = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=64)
MAX_LEN = 64


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


@pytest.fixture(scope="module")
def pair():
    """(JAX MHA Llama, the port's Llama holding its weights)."""
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(num_kv_heads=2, dropout=0.0, **SIZES))
    jm.eval()
    arrays = {k: np.asarray(v)
              for k, v in functionalize(jm).param_values().items()}
    pm = Llama(LlamaConfig(num_kv_heads=2, **SIZES), device="cpu", seed=1)
    load_params(pm, arrays)
    return jm, pm


@pytest.fixture(scope="module")
def runner(pair):
    return LlamaRunner(pair[1], 8, MAX_LEN)


def _engine(runner, **kw):
    kw = {"num_blocks": 40, "max_batch_size": 3, "max_model_len": MAX_LEN,
          **kw}
    return ServingEngine(runner, **kw)


def _workload(seed, n, lo=2, hi=14):
    rng = np.random.default_rng(seed)
    return [(list(map(int, rng.integers(1, 97, int(rng.integers(2, 9))))),
             SamplingParams(max_tokens=int(rng.integers(lo, hi))))
            for _ in range(n)]


def _serve(eng, work):
    ids = [eng.add_request(p, sp) for p, sp in work]
    outs = eng.run()
    assert eng.pool.allocator.check_no_leaks()
    return [outs[i].output_tokens for i in ids]


class Faulty:
    """The runner behind a fault schedule: every ``error_every``-th decode
    call (decode or decode_multi) raises before it runs; ``nan_calls``
    (1-based decode call numbers) come back with the finite plane of a
    horizon zeroed."""

    def __init__(self, runner, error_every=0, nan_calls=()):
        self._runner = runner
        self.error_every = error_every
        self.nan_calls = set(nan_calls)
        self.calls = 0
        self.errors = 0

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def _pre(self):
        self.calls += 1
        if self.error_every and self.calls % self.error_every == 0:
            self.errors += 1
            raise RuntimeError("injected device error")

    def decode(self, *a, **kw):
        self._pre()
        return self._runner.decode(*a, **kw)

    def decode_multi(self, *a, **kw):
        self._pre()
        packed, pools = self._runner.decode_multi(*a, **kw)
        if self.calls in self.nan_calls:
            packed = packed.clone()
            packed[1] = 0
        return packed, pools


# ---------------------------------------------------------------- runner


def test_decode_multi_matches_jax_runner(pair):
    jm, pm = pair
    prompt = [5, 9, 2, 33, 41, 7, 60, 12, 3, 88, 17]
    jr = JaxLlamaRunner(jm, 8, MAX_LEN)
    pr = LlamaRunner(pm, 8, MAX_LEN)
    jpool = JaxKVCachePool(2, 10, 8, 2, 16, jr.dtype)
    ppool = KVCachePool(2, 10, 8, 2, 16, device="cpu")
    table = jpool.pad_table(jpool.allocator.alloc(8), 8)
    ppool.allocator.alloc(8)
    jl, jpools = jr.prefill(prompt, table, jpool.pools)
    pl, ppools = pr.prefill(prompt, table, ppool.pools)
    fed = int(np.argmax(np.asarray(jl)))
    assert fed == int(torch.argmax(pl))
    tabs = np.asarray([table, [0] * 8], np.int32)
    args = (np.asarray([fed, 0], np.int32), tabs,
            np.asarray([len(prompt), 0], np.int32))
    jp, _ = jr.decode_multi(*args, jpools, 6)
    pp, _ = pr.decode_multi(*args, ppools, 6)
    assert pp.shape == (2, 2, 6) and pp.dtype == torch.int32
    np.testing.assert_array_equal(pp[:, 0].numpy(), np.asarray(jp)[:, 0])
    assert pp[1].all()


def test_decode_multi_equals_decode_steps(runner):
    """Each inner step is decode's body: s decode calls with the argmax
    fed back give the horizon's tokens."""
    pools = []
    for _ in range(2):
        pool = KVCachePool(2, 10, 8, 2, 16, device="cpu")
        table = pool.pad_table(pool.allocator.alloc(8), 8)
        runner.prefill([4, 8, 15, 16, 23, 42], table, pool.pools)
        pools.append(pool.pools)
    tabs = np.asarray([table], np.int32)
    packed, _ = runner.decode_multi(np.asarray([7], np.int32), tabs,
                                    np.asarray([6], np.int32), pools[0], 5)
    tok, steps = 7, []
    for t in range(5):
        logits, _ = runner.decode(np.asarray([tok], np.int32), tabs,
                                  np.asarray([6 + t], np.int32), pools[1])
        tok = int(torch.argmax(logits[0]))
        steps.append(tok)
    assert packed[0, 0].tolist() == steps
    with pytest.raises(ValueError):
        runner.decode_multi(np.asarray([7], np.int32), tabs,
                            np.asarray([6], np.int32), pools[0], 0)


def test_decode_horizon_knob_validation(runner):
    with pytest.raises(ValueError):
        _engine(runner, decode_horizon=0)


# --------------------------------------------------------- exactness


@pytest.mark.parametrize("s", [1, 4, 8])
def test_horizon_streams_exact(pair, runner, s):
    jm, _ = pair
    work = _workload(11, 6)
    per_step = _serve(_engine(runner), work)
    eng = _engine(runner, decode_horizon=s)
    got = _serve(eng, work)
    assert got == per_step
    for (p, sp), toks in zip(work, got):
        assert toks == naive_generate(runner, p, sp, max_model_len=MAX_LEN)
    if s > 1:
        assert eng.metrics.decode_horizon_steps.value > 0
    jeng = jax_create_engine(jm, block_size=8, max_model_len=MAX_LEN,
                             num_blocks=40, max_batch_size=3,
                             decode_horizon=s)
    ids = [jeng.add_request(p, JaxSamplingParams(max_tokens=sp.max_tokens))
           for p, sp in work]
    jout = jeng.run()
    assert [jout[i].output_tokens for i in ids] == got


def _count_to_host(monkeypatch):
    calls = {"n": 0}
    real = engine_mod._to_host

    def counting(x):
        calls["n"] += 1
        return real(x)

    monkeypatch.setattr(engine_mod, "_to_host", counting)
    return calls


def test_one_host_sync_per_sampled_token_on_s1(runner, monkeypatch):
    calls = _count_to_host(monkeypatch)
    eng = _engine(runner)
    eng.add_request([3, 1, 4, 1, 5], SamplingParams(max_tokens=9))
    eng.run()
    m = eng.metrics.snapshot()
    assert m["tokens_generated"] == 9
    assert m["host_syncs"] == calls["n"] == 9


def test_one_to_host_per_horizon(runner, monkeypatch):
    """1 prefill sample (token 1), 1 per-step decode in the admission
    step (a chunk ran there, token 2), then ceil(7 / 4) horizon drains."""
    calls = _count_to_host(monkeypatch)
    eng = _engine(runner, decode_horizon=4)
    eng.add_request([3, 1, 4, 1, 5], SamplingParams(max_tokens=9))
    eng.run()
    m = eng.metrics.snapshot()
    assert m["tokens_generated"] == 9
    assert m["host_syncs"] == calls["n"] == 2 + math.ceil(7 / 4)
    assert m["decode_horizon_steps"] == 7


def test_host_syncs_per_token_drop_4x_at_horizon_8(runner):
    spt = {}
    for s in (1, 8):
        eng = _engine(runner, max_batch_size=2, decode_horizon=s)
        for i in range(2):
            eng.add_request([i + 1, 2, 3, 4], SamplingParams(max_tokens=40))
        eng.run()
        m = eng.metrics.snapshot()
        assert m["host_syncs"] <= math.ceil(80 / s) + m["prefill_chunks"]
        spt[s] = m["host_syncs_per_token"]
    assert spt[1] / spt[8] >= 4.0, spt


def test_stop_mid_horizon_rolls_back_overshoot(runner):
    ref = naive_generate(runner, [5, 9], SamplingParams(max_tokens=24),
                         max_model_len=MAX_LEN)
    sp = SamplingParams(max_tokens=24, stop_token_ids=(ref[3],))
    eng = _engine(runner, max_batch_size=2, decode_horizon=8)
    rid = eng.add_request([5, 9], sp)
    out = eng.run()[rid]
    assert out.finish_reason == "stop"
    assert out.output_tokens == ref[:ref.index(ref[3]) + 1]
    assert eng.metrics.horizon_overshoot_tokens.value > 0
    assert eng.pool.allocator.check_no_leaks()


def test_chunks_in_flight_fall_back_then_horizon_resumes(runner):
    eng = _engine(runner, max_batch_size=2, decode_horizon=4,
                  max_prefill_tokens_per_step=4)
    prompt = list(range(1, 21))
    sp = SamplingParams(max_tokens=10)
    rid = eng.add_request(prompt, sp)
    assert eng.run()[rid].output_tokens == naive_generate(
        runner, prompt, sp, max_model_len=MAX_LEN)
    m = eng.metrics.snapshot()
    assert m["prefill_chunks"] >= 5 and m["decode_horizon_steps"] > 0


# ---------------------------------------------------- pages and pressure


def test_plan_decode_horizon_trims_never_preempts(pair):
    r = LlamaRunner(pair[1], 4, 28)
    eng = ServingEngine(r, num_blocks=8, max_batch_size=2, max_model_len=28,
                        decode_horizon=8)
    sp = SamplingParams(max_tokens=20)
    for p in ([1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13]):
        eng.add_request(p, sp)
    eng.step()                                   # admit + prefill both
    sched = eng.scheduler
    for _ in sched.reserve_decode():
        pass
    before = [r.num_preemptions for r in sched.running]
    s = sched.plan_decode_horizon(8)
    assert 1 <= s < 8, f"a tight pool must trim the horizon (got {s})"
    assert [r.num_preemptions for r in sched.running] == before
    for req in sched.decode_ready():
        assert req.kv.pages_short(s) == 0


def test_horizon_engine_under_pool_pressure_token_exact(pair):
    r = LlamaRunner(pair[1], 4, 40)
    eng = ServingEngine(r, num_blocks=11, max_batch_size=3, max_model_len=40,
                        decode_horizon=8)
    work = _workload(3, 6, lo=4, hi=12)
    got = _serve(eng, work)
    for (p, sp), toks in zip(work, got):
        assert toks == naive_generate(r, p, sp, max_model_len=40)


def test_truncate_returns_pages(runner):
    pool = KVCachePool(2, 10, 8, 2, 16, device="cpu")
    from paddle_tpu_torch.serving import SequenceKV
    kv = SequenceKV(pool)
    kv.grow(30)                                  # 4 pages of 8
    assert kv.truncate(9) == 2 and len(kv.pages) == 2
    assert kv.num_tokens == 9 and pool.allocator.num_free == 7


# -------------------------------------------------------------- faults


def test_fault_injected_decode_multi_retries_exactly(runner):
    inj = Faulty(runner, error_every=3)
    eng = _engine(inj, max_batch_size=2, decode_horizon=4,
                  retry_backoff_s=0.0, sleep_fn=lambda _t: None)
    work = [(list(map(int, np.random.default_rng(4).integers(1, 97, 5))),
             SamplingParams(max_tokens=12)) for _ in range(4)]
    got = _serve(eng, work)
    m = eng.metrics.snapshot()
    assert inj.errors > 0 and m["step_retries"] == inj.errors
    assert m["decode_horizon_steps"] > 0
    for (p, sp), toks in zip(work, got):
        assert toks == naive_generate(runner, p, sp, max_model_len=MAX_LEN)


def test_nan_mid_horizon_abort_policy(runner):
    inj = Faulty(runner, nan_calls=(2,))
    eng = _engine(inj, max_batch_size=2, decode_horizon=4)
    rid = eng.add_request([1, 2, 3], SamplingParams(max_tokens=12))
    out = eng.run()[rid]
    assert out.finish_reason == "error"
    assert eng.metrics.nan_logit_events.value > 0
    assert eng.pool.allocator.check_no_leaks()


def test_nan_mid_horizon_greedy_defers_and_recovers(runner):
    inj = Faulty(runner, nan_calls=(2,))
    eng = _engine(inj, max_batch_size=2, decode_horizon=4,
                  nan_policy="greedy")
    sp = SamplingParams(max_tokens=12)
    rid = eng.add_request([1, 2, 3], sp)
    out = eng.run()[rid]
    assert out.finish_reason == "length"
    assert out.output_tokens == naive_generate(runner, [1, 2, 3], sp,
                                               max_model_len=MAX_LEN)
    assert eng.metrics.nan_logit_events.value > 0
    assert eng.pool.allocator.check_no_leaks()


def test_create_serving_engine_routes_the_knobs(pair):
    eng = create_serving_engine(pair[1], device="cpu", block_size=8,
                                max_model_len=MAX_LEN, num_blocks=40,
                                decode_horizon=8, pipelined=True,
                                horizon_sampling=True,
                                horizon_early_stop=True)
    assert (eng.decode_horizon, eng.pipelined, eng.horizon_sampling,
            eng.horizon_early_stop) == (8, True, True, True)


# ------------------------------------------- graphs, pinned on the CPU


class StubGraph:
    """Stands in for a CUDA graph on the CPU: capture runs the call (its
    launches count, as a real capture's would) and puts the pools back as
    they were (a real capture computes nothing); replay reruns the
    recorded call with the counts put back as they were (a real replay
    never passes through the wrappers) and writes the static output."""

    def __init__(self, pools=()):
        self.pools = pools

    def capture(self, fn):
        saved = [t.clone() for layer in self.pools for t in layer]
        self.fn = fn
        self.out = fn()
        for t, old in zip((t for layer in self.pools for t in layer), saved):
            t.copy_(old)
        return self.out

    def replay(self):
        before = _build.counts_snapshot()
        fresh = self.fn()
        _build.counts_credit(_build.counts_delta(_build.counts_snapshot(),
                                                 before))
        self.out.copy_(fresh)


def _prefilled(runner, prompt):
    pool = KVCachePool(2, 10, 8, 2, 16, device="cpu",
                       kv_dtype=runner.kv_dtype)
    table = pool.pad_table(pool.allocator.alloc(8), 8)
    runner.prefill(prompt, table, pool.pools)
    return pool.pools, np.asarray([table, [0] * 8], np.int32)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_graph_replays_credit_the_eager_launch_counts(pair, kv_dtype,
                                                      monkeypatch):
    """Each captured step credits, on every replay, the launches its
    capture added: a graphed runner counts what an eager one counts, call
    for call, and returns the same outputs."""
    counts = {"fp32": k2.COUNTS, "int8": k1.COUNTS_I8}[kv_dtype]
    eager = LlamaRunner(pair[1], 8, MAX_LEN, kv_dtype=kv_dtype)
    graphed = LlamaRunner(pair[1], 8, MAX_LEN, kv_dtype=kv_dtype)
    monkeypatch.setattr(graphed, "_use_graphs", lambda: True)
    prompt = [5, 9, 2, 33, 41, 7]
    pools_e, tabs = _prefilled(eager, prompt)
    pools_g, _ = _prefilled(graphed, prompt)
    monkeypatch.setattr(graphed, "_new_graph", lambda: StubGraph(pools_g))
    ext = dict(seeds=np.asarray([3, 0]), base_steps=np.asarray([1, 0]),
               temps=np.asarray([0.8, 0.0], np.float32), top_k=20,
               stop_ids=np.asarray([[-1], [-1]]), remaining=[9, 1],
               early_stop=True)
    calls = [("decode", (np.asarray([5 + i, 0]), tabs,
                         np.asarray([6 + i, 0])), {}) for i in range(3)]
    calls += [("decode_multi", (np.asarray([3, 0]), tabs,
                                np.asarray([9 + 4 * i, 0])), 4, ext)
              for i in range(2)]
    for kind, args, *rest in calls:
        n = () if kind == "decode" else (rest[0],)
        kw = rest[-1]
        c0 = counts.plain_launches
        out_e, _ = getattr(eager, kind)(*args, pools_e, *n, **kw)
        c1 = counts.plain_launches
        out_g, _ = getattr(graphed, kind)(*args, pools_g, *n, **kw)
        assert counts.plain_launches - c1 == c1 - c0 > 0
        np.testing.assert_array_equal(out_g.numpy(), out_e.numpy())
    assert [c["kind"] for c in graphed.captures] == ["decode",
                                                     "decode_multi_x"]
    assert eager.captures == []
    for a, b in zip(pools_e, pools_g):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_graph_cache_is_lru_capped(pair, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_MAX_JIT_CACHE", "1")
    r = LlamaRunner(pair[1], 8, MAX_LEN)
    monkeypatch.setattr(r, "_use_graphs", lambda: True)
    monkeypatch.setattr(r, "_new_graph", StubGraph)
    pools, tabs = _prefilled(r, [1, 2, 3])
    for s in (2, 3, 2):
        r.decode_multi(np.asarray([4, 0]), tabs, np.asarray([3, 0]), pools,
                       s)
    assert [c["key"][2] for c in r.captures] == [2, 3, 2]
    assert len(r._graph_cache) == 1
