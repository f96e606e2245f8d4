"""The port's serving path against the JAX package's, on the CPU.

Small MHA and GQA Llama models are built in JAX and carried into the port
by the weight bridge (numpy arrays in, torch tensors out). Then:

  * per-call logits of `prefill_chunk` / `decode` match the JAX
    `LlamaRunner` at atol 1e-4 (fp32, summed in another order), and the
    K/V both write into their pools match;
  * the 16-request preemption workload is token-exact against the port's
    own `naive_generate`, with the invariant auditor armed and no leaks;
  * the port engine's greedy tokens equal the JAX engine's on the same
    weights;
  * the allocator, scheduler, metrics and failure-handling units mirror
    the JAX package's serving tests.

The port's "auto" dispatch runs the kernels' plain versions here (CPU
tensors); "reference" runs the gather path.
"""

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
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.models import Llama, LlamaConfig
from paddle_tpu_torch.serving import (
    BlockAllocator, EngineMetrics, FCFSScheduler, Histogram,
    InvariantViolation, KVCachePool, LlamaRunner, QueueFullError, Request,
    RequestState, SamplingParams, ServingEngine, audit_engine,
    create_engine, naive_generate, runner_for,
)
from paddle_tpu_torch.weights import load_params, params_from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the models here are tiny: intra-op threads only contend with the other
# test workers sharing the machine
torch.set_num_threads(1)

LOGIT_ATOL = 1e-4
SIZES = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=64)


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    """The invariant auditor runs after every engine step in these tests
    (engines built with audit=None read the env var)."""
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


def _jax_model(n_kv):
    paddle.seed(0)
    model = JaxLlama(JaxLlamaConfig(num_kv_heads=n_kv, dropout=0.0, **SIZES))
    model.eval()
    return model


def _bridge(jax_model):
    """The port's Llama holding the JAX model's weights."""
    arrays = {k: np.asarray(v)
              for k, v in functionalize(jax_model).param_values().items()}
    model = Llama(LlamaConfig(num_kv_heads=jax_model.cfg.num_kv_heads,
                              **SIZES), device="cpu", seed=1)
    load_params(model, arrays)
    return model


@pytest.fixture(scope="module", params=[2, 1], ids=["mha", "gqa"])
def pair(request):
    """(JAX model, port model with the same weights) for MHA and GQA."""
    jm = _jax_model(request.param)
    return jm, _bridge(jm)


def _workload(seed=7, n=16, vocab=97):
    wl = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = [int(t) for t in wl.integers(1, vocab, int(wl.integers(3, 25)))]
        out.append((p, int(wl.integers(2, 11))))
    return out


# ------------------------------------------------------------ weight bridge


def test_bridge_copies_every_parameter(pair):
    jm, pm = pair
    arrays = functionalize(jm).param_values()
    own = dict(pm.named_parameters())
    assert sorted(own) == sorted(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(own[name].detach().numpy(),
                                      np.asarray(a))


def test_params_from_numpy_keeps_names_shapes_dtypes():
    arrays = {"a.weight": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": np.array([1, 2], np.int32)}
    out = params_from_numpy(arrays, device="cpu")
    assert out["a.weight"].dtype == torch.float32
    assert out["b"].dtype == torch.int32
    np.testing.assert_array_equal(out["a.weight"].numpy(), arrays["a.weight"])


def test_load_params_rejects_mismatched_dicts(pair):
    jm, pm = pair
    arrays = {k: np.asarray(v)
              for k, v in functionalize(jm).param_values().items()}
    with pytest.raises(KeyError):
        load_params(pm, {k: v for k, v in arrays.items() if k != "norm.weight"})
    bad = dict(arrays)
    bad["norm.weight"] = np.ones(3, np.float32)
    with pytest.raises(ValueError):
        load_params(pm, bad)


def test_llama_config_rules_match_jax():
    for kw in (dict(hidden_size=4096), dict(hidden_size=768),
               dict(hidden_size=96, num_heads=6, num_kv_heads=2)):
        ours, ref = LlamaConfig(**kw), JaxLlamaConfig(**kw)
        assert ours.ffn_hidden == ref.ffn_hidden
        assert ours.num_kv_heads == ref.num_kv_heads


def test_rope_tables_match_jax():
    from paddle_tpu.models.llama import _rope_tables
    from paddle_tpu_torch.models import rope_tables

    cos, sin = rope_tables(64, 16, 1e4, device="cpu")
    jcos, jsin = _rope_tables(64, 16, 1e4)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)


def test_seeded_init_is_reproducible_and_scaled():
    cfg = LlamaConfig(num_kv_heads=1, **SIZES)
    a, b = Llama(cfg, device="cpu", seed=3), Llama(cfg, device="cpu", seed=3)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    w = a.layers[0].self_attn.q_proj.weight
    assert tuple(w.shape) == (32, 32)          # JAX [in, out] layout
    assert 0.01 < float(w.detach().std()) < 0.03
    assert torch.equal(a.norm.weight, torch.ones(32))


# ------------------------------------------------------- per-call logits


@pytest.mark.parametrize("attn_impl", ["auto", "reference"])
def test_step_logits_and_pools_match_jax_runner(pair, attn_impl):
    """Two prefill chunks of one sequence (the second at start_pos > 0,
    crossing a page boundary), then batched decode steps beside a dead
    slot: every call's logits match the JAX runner's, and so do the
    pages the calls wrote."""
    jm, pm = pair
    bs, P = 8, 8
    jr = JaxLlamaRunner(jm, block_size=bs, max_model_len=64,
                        attn_impl="reference")
    pr = LlamaRunner(pm, block_size=bs, max_model_len=64,
                     attn_impl=attn_impl)
    n_kv, d = pr.n_kv_heads, pr.head_dim
    jpool = JaxKVCachePool(2, 1 + P, bs, n_kv, d)
    ppool = KVCachePool(2, 1 + P, bs, n_kv, d, device="cpu")
    table = [3, 1, 4, 2, 5, 0, 0, 0]
    toks = [int(t) for t in np.random.default_rng(1).integers(1, 97, 20)]
    jpools, ppools = jpool.pools, ppool.shards
    for start, end in ((0, 13), (13, 20)):
        jl, jpools = jr.prefill_chunk(toks[start:end], start, table, jpools)
        pl, ppools = pr.prefill_chunk(toks[start:end], start, table, ppools)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
    tables = np.asarray([table, [0] * P], np.int32)     # slot 1 is dead
    tok = int(np.argmax(np.asarray(jl)))
    for step in range(3):
        pos = np.asarray([20 + step, 0], np.int32)
        feed = np.asarray([tok, 0], np.int32)
        jl, jpools = jr.decode(feed, tables, pos, jpools)
        pl, ppools = pr.decode(feed, tables, pos, ppools)
        np.testing.assert_allclose(pl[0].numpy(), np.asarray(jl)[0],
                                   atol=LOGIT_ATOL, rtol=0)
        tok = int(np.argmax(np.asarray(jl)[0]))
    live = [1, 2, 3, 4, 5]
    for (jk, jv), (pk, pv) in zip(jpools, ppools[0]):
        np.testing.assert_allclose(pk[live].numpy(), np.asarray(jk)[live],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(pv[live].numpy(), np.asarray(jv)[live],
                                   atol=1e-5, rtol=0)


def test_auto_dispatch_runs_the_plain_kernels_on_cpu(pair):
    """On CPU tensors "auto" resolves as best_paged_impl says and the
    wrappers run their plain versions; "reference" runs neither."""
    import paddle_tpu_torch.ops.paged_attention as k2
    import paddle_tpu_torch.ops.ragged_paged_attention as k1

    _, pm = pair
    for impl, expect in (("auto", True), ("reference", False)):
        runner = LlamaRunner(pm, block_size=8, max_model_len=64,
                             attn_impl=impl)
        k1.COUNTS.reset()
        k2.COUNTS.reset()
        naive_generate(runner, [5, 6, 7, 8, 9], SamplingParams(max_tokens=3),
                       max_model_len=64)
        mha = runner.n_heads == runner.n_kv_heads
        assert (k1.COUNTS.plain_launches > 0) == expect
        assert (k2.COUNTS.plain_launches > 0) == (expect and mha)
        assert k1.COUNTS.kernel_launches == k2.COUNTS.kernel_launches == 0


# ------------------------------------------------------------ engine vs oracle


@pytest.mark.parametrize("budget", [None, 16])
def test_engine_matches_naive_with_preemption(pair, budget):
    """16 requests, mixed prompt/output lengths, a pool tight enough to
    force preemption, and (with a budget) chunked prefill: the engine's
    tokens equal naive sequential generation token for token, with the
    auditor armed and every page back on the free list."""
    _, pm = pair
    runner = LlamaRunner(pm, block_size=8, max_model_len=64)
    eng = ServingEngine(runner, num_blocks=10, max_batch_size=4,
                        max_model_len=64, max_prefill_tokens_per_step=budget)
    work = [(eng.add_request(p, SamplingParams(max_tokens=n)), p, n)
            for p, n in _workload()]
    outs = eng.run()
    assert len(outs) == 16
    assert eng.metrics.preemptions.value >= 1, "workload must preempt"
    if budget is not None:
        assert eng.metrics.prefill_chunks.value > 16
    for rid, p, n in work:
        assert outs[rid].output_tokens == naive_generate(
            runner, p, SamplingParams(max_tokens=n), max_model_len=64)
        assert outs[rid].finish_reason == "length"
    assert eng.pool.allocator.check_no_leaks()
    snap = eng.metrics.snapshot()
    assert snap["requests_finished"] == 16
    assert snap["tokens_generated"] == sum(n for _, n in _workload())


def test_engine_tokens_equal_jax_engine(pair):
    """The same weights and workload through both engines give the same
    greedy tokens (chunked prefill and preemption included)."""
    jm, pm = pair
    jr = JaxLlamaRunner(jm, block_size=8, max_model_len=64,
                        attn_impl="reference")
    jeng = JaxServingEngine(jr, num_blocks=10, max_batch_size=4,
                            max_model_len=64, max_prefill_tokens_per_step=16)
    peng = create_serving_engine(pm, device="cpu", block_size=8,
                                 max_model_len=64, num_blocks=10,
                                 max_batch_size=4,
                                 max_prefill_tokens_per_step=16)
    jids = [jeng.add_request(p, JaxSamplingParams(max_tokens=n))
            for p, n in _workload(seed=3)]
    pids = [peng.add_request(p, SamplingParams(max_tokens=n))
            for p, n in _workload(seed=3)]
    jouts, pouts = jeng.run(), peng.run()
    for a, b in zip(jids, pids):
        assert pouts[b].output_tokens == jouts[a].output_tokens
        assert pouts[b].finish_reason == jouts[a].finish_reason
    assert peng.metrics.preemptions.value == jeng.metrics.preemptions.value
    assert peng.pool.allocator.check_no_leaks()


def test_attention_byte_counters_match_jax(pair):
    jm, pm = pair
    jeng = JaxServingEngine(JaxLlamaRunner(jm, block_size=8, max_model_len=64,
                                           attn_impl="pallas"),
                            num_blocks=20, max_batch_size=2, max_model_len=64)
    peng = ServingEngine(LlamaRunner(pm, block_size=8, max_model_len=64),
                         num_blocks=20, max_batch_size=2, max_model_len=64)
    for eng, sp in ((jeng, JaxSamplingParams), (peng, SamplingParams)):
        eng.add_request(list(range(1, 30)), sp(max_tokens=3))
        eng.add_request([4, 5, 6], sp(max_tokens=4))
        eng.run()
    assert peng.runner.attn_kv_bytes_read == jeng.runner.attn_kv_bytes_read
    assert peng.runner.attn_kv_bytes_gather == \
        jeng.runner.attn_kv_bytes_gather
    assert peng.runner.attn_kv_bytes_read < peng.runner.attn_kv_bytes_gather


def test_stop_tokens_and_streaming(pair):
    _, pm = pair
    runner = LlamaRunner(pm, block_size=8, max_model_len=64)
    eng = ServingEngine(runner, num_blocks=20, max_batch_size=2,
                        max_model_len=64)
    ref = naive_generate(runner, [5, 6, 7], SamplingParams(max_tokens=8),
                         max_model_len=64)
    rid = eng.add_request([5, 6, 7], SamplingParams(
        max_tokens=8, stop_token_ids=(ref[2],)))
    events = []
    while eng.has_work():
        events.extend(eng.step())
    out = eng.outputs()[rid]
    stop_at = ref.index(ref[2])
    assert out.finish_reason == "stop"
    assert out.output_tokens == ref[:stop_at + 1]
    assert [e.token for e in events] == out.output_tokens
    assert [e.index for e in events] == list(range(stop_at + 1))
    assert events[-1].finished
    assert eng.pool.allocator.check_no_leaks()


# ------------------------------------------------------------- allocator


def test_allocator_alloc_free_deterministic():
    a = BlockAllocator(8)
    assert a.num_usable == 7          # page 0 is scratch
    assert a.alloc(3) == [1, 2, 3]    # lowest-id-first
    a.free([2])
    assert a.alloc(1) == [2]          # freed page reused deterministically
    a.free([1, 2, 3])
    assert a.check_no_leaks()


def test_allocator_exhaustion_and_double_free():
    a = BlockAllocator(4)
    pages = a.alloc(3)
    with pytest.raises(MemoryError):
        a.alloc(1)
    a.free(pages)
    with pytest.raises(ValueError):
        a.free([pages[0]])


def test_pool_sizing_and_scratch_padding():
    pool = KVCachePool(num_layers=2, num_blocks=8, block_size=4,
                       n_kv_heads=2, head_dim=8, device="cpu")
    assert pool.blocks_for_tokens(1) == 1
    assert pool.blocks_for_tokens(4) == 1
    assert pool.blocks_for_tokens(5) == 2
    assert pool.pad_table([3, 5], 4) == [3, 5, 0, 0]
    with pytest.raises(ValueError):
        pool.pad_table([1, 2, 3], 2)
    assert pool.page_bytes() == 2 * 2 * 4 * 2 * 8 * 4
    assert pool.memory_bytes() == 8 * pool.page_bytes()


# ------------------------------------------------------------- scheduler


def _sched(num_blocks=9, block_size=4, max_batch=2, max_pages=4):
    pool = KVCachePool(num_layers=1, num_blocks=num_blocks,
                       block_size=block_size, n_kv_heads=1, head_dim=8,
                       device="cpu")
    return FCFSScheduler(pool, max_batch, max_pages), pool


def test_admission_is_fcfs_with_head_of_line_blocking():
    sched, pool = _sched(num_blocks=5, max_batch=4)  # 4 usable pages
    big = Request(prompt_tokens=list(range(12)))     # needs 4 pages (12+1)
    small = Request(prompt_tokens=[1, 2])            # needs 1 page
    sched.add(big)
    sched.add(small)
    assert [r is big for r in sched.admit()] == [True]
    assert sched.admit() == []        # small must not jump the queue
    assert sched.queue_depth == 1
    sched.finish(big, "length")
    assert sched.admit() == [small]


def test_preemption_evicts_youngest_and_requeues_front():
    sched, pool = _sched(num_blocks=9, block_size=4, max_batch=2,
                         max_pages=8)
    a = Request(prompt_tokens=list(range(6)))
    b = Request(prompt_tokens=list(range(6)))
    sched.add(a)
    sched.add(b)
    assert sched.admit() == [a, b]
    for r in (a, b):
        r.kv.num_tokens = r.num_context
    assert pool.allocator.num_free == 4
    victims = []
    for _ in range(12):
        for r in sched.running_in_order():
            r.kv.num_tokens += 1
            r.output_tokens.append(0)
        victims = sched.reserve_decode()
        if victims:
            break
    assert victims == [b]                      # youngest evicted
    assert b.state is RequestState.WAITING
    assert b.num_preemptions == 1
    assert sched.waiting[0] is b               # queue-front recycle
    assert b.kv is None
    sched.finish(a, "length")
    assert sched.admit() == [b]                # b resumes, recomputed
    assert b.phase == "prefill"
    sched.finish(b, "length")
    assert pool.allocator.check_no_leaks()


def test_scheduler_rejects_unservable_config():
    pool = KVCachePool(num_layers=1, num_blocks=4, block_size=4,
                       n_kv_heads=1, head_dim=8, device="cpu")
    with pytest.raises(ValueError):
        FCFSScheduler(pool, max_batch_size=1, max_pages_per_seq=8)


def test_prefill_plan_spends_the_budget_oldest_first():
    pool = KVCachePool(num_layers=1, num_blocks=30, block_size=4,
                       n_kv_heads=1, head_dim=8, device="cpu")
    sched = FCFSScheduler(pool, 4, 10, max_prefill_tokens_per_step=10)
    a = Request(prompt_tokens=list(range(1, 8)))     # 7 tokens
    b = Request(prompt_tokens=list(range(1, 13)))    # 12 tokens
    sched.add(a)
    sched.add(b)
    sched.admit()
    plan = sched.prefill_plan()
    assert [(r is a, s, e) for r, s, e in plan] == [(True, 0, 7),
                                                    (False, 0, 3)]
    a.kv.num_tokens, b.kv.num_tokens = 7, 3
    a.phase = "decode"
    assert [(s, e) for _, s, e in sched.prefill_plan()] == [(3, 12)]
    assert sched.decode_ready() == [a]


# --------------------------------------------------------------- metrics


def test_histogram_percentiles_exact():
    h = Histogram("t")
    for v in [5.0, 1.0, 9.0, 3.0, 7.0]:
        h.observe(v)
    assert h.percentile(0) == 1.0
    assert h.percentile(50) == 5.0
    assert h.percentile(100) == 9.0
    assert h.count == 5 and h.mean == 5.0


def test_metrics_virtual_clock():
    t = [0.0]
    m = EngineMetrics(clock=lambda: t[0])
    m.mark_active()
    m.tokens_generated.inc(10)
    t[0] = 2.0
    m.mark_active()
    assert m.tokens_per_sec() == 5.0


# ------------------------------------------------------- failure handling


class _Faulty:
    """A runner that raises, or poisons logits with NaN, on chosen calls
    of one step kind; everything else goes to the wrapped runner."""

    def __init__(self, runner, target, error_calls=(), error_every=0,
                 nan_calls=(), nan_fraction=0.5):
        self._runner = runner
        self._target = target
        self._error_calls, self._error_every = set(error_calls), error_every
        self._nan_calls, self._nan_fraction = set(nan_calls), nan_fraction
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def _call(self, kind, fn, *args):
        if kind != self._target:
            return fn(*args)
        self.calls += 1
        if self.calls in self._error_calls or (
                self._error_every and self.calls % self._error_every == 0):
            raise RuntimeError("injected device error")
        logits, pools = fn(*args)
        if self.calls in self._nan_calls:
            logits = logits.clone()
            n = max(1, int(self._nan_fraction * logits.shape[-1]))
            logits[..., :n] = float("nan")
        return logits, pools

    def prefill_chunk(self, *args):
        return self._call("prefill", self._runner.prefill_chunk, *args)

    def decode(self, *args):
        return self._call("decode", self._runner.decode, *args)


@pytest.fixture(scope="module")
def gqa_runner():
    return LlamaRunner(_bridge(_jax_model(1)), block_size=8,
                       max_model_len=64)


def _engine(runner, **kw):
    kw.setdefault("num_blocks", 20)
    kw.setdefault("max_batch_size", 2)
    return ServingEngine(runner, max_model_len=64, retry_backoff_s=0.0,
                         sleep_fn=lambda s: None, **kw)


def test_timeout_expires_waiting_and_running(gqa_runner):
    t = [0.0]
    eng = _engine(gqa_runner, max_batch_size=1,
                  metrics=EngineMetrics(clock=lambda: t[0]))
    r1 = eng.add_request([1, 2, 3], SamplingParams(max_tokens=20,
                                                   timeout_s=5.0))
    r2 = eng.add_request([4, 5], SamplingParams(max_tokens=20,
                                                timeout_s=5.0))
    eng.step()
    t[0] = 6.0
    eng.step()
    outs = eng.outputs()
    assert outs[r1].finish_reason == outs[r2].finish_reason == "timeout"
    assert outs[r1].output_tokens and outs[r2].output_tokens == []
    assert outs[r2].ttft_s is None
    assert not eng.has_work()
    assert eng.pool.allocator.check_no_leaks()
    assert eng.metrics.requests_timed_out.value == 2


def test_abort_waiting_and_running_requests(gqa_runner):
    eng = _engine(gqa_runner, max_batch_size=1)
    r1 = eng.add_request([1, 2, 3], SamplingParams(max_tokens=20))
    r2 = eng.add_request([4, 5], SamplingParams(max_tokens=20))
    eng.step()
    assert eng.abort(r1) and eng.abort(r2)
    assert eng.abort(r1) is False
    assert eng.abort("no-such-request") is False
    assert {o.finish_reason for o in eng.outputs().values()} == {"aborted"}
    assert not eng.has_work()
    assert eng.pool.allocator.check_no_leaks()


def test_bounded_queue_policies(gqa_runner):
    eng = _engine(gqa_runner, max_queue_depth=2, shed_policy="reject")
    eng.add_request([1], SamplingParams(max_tokens=2))
    eng.add_request([2], SamplingParams(max_tokens=2))
    with pytest.raises(QueueFullError):
        eng.add_request([3], SamplingParams(max_tokens=2))
    assert len(eng.run()) == 2
    eng = _engine(gqa_runner, max_queue_depth=2, shed_policy="drop_oldest")
    ids = [eng.add_request([i + 1], SamplingParams(max_tokens=2))
           for i in range(3)]
    outs = eng.run()
    assert [outs[r].finish_reason for r in ids] == ["shed", "length",
                                                    "length"]
    assert eng.metrics.shed_requests.value == 1
    assert eng.pool.allocator.check_no_leaks()


def test_admission_watermark_paces_admission(gqa_runner):
    eng = _engine(gqa_runner, num_blocks=17, max_batch_size=8,
                  admission_watermark=0.5)
    for _ in range(6):
        eng.add_request(list(range(1, 12)), SamplingParams(max_tokens=5))
    eng.step()
    assert len(eng.scheduler.running) == 4      # 4 x 2 pages = watermark
    assert len(eng.run()) == 6
    assert eng.pool.allocator.check_no_leaks()


def test_decode_faults_retry_exactly(gqa_runner):
    """Every third decode call fails once: retries rewrite the same slots,
    so the tokens still equal the fault-free oracle."""
    faulty = _Faulty(gqa_runner, "decode", error_every=3)
    eng = _engine(faulty, num_blocks=10, max_batch_size=4,
                  max_step_retries=2)
    work = [(eng.add_request(p, SamplingParams(max_tokens=n)), p, n)
            for p, n in _workload(n=6)]
    outs = eng.run()
    assert eng.metrics.step_retries.value >= 1
    for rid, p, n in work:
        assert outs[rid].output_tokens == naive_generate(
            gqa_runner, p, SamplingParams(max_tokens=n), max_model_len=64)
    assert eng.pool.allocator.check_no_leaks()


def test_persistent_faults_quarantine_with_explicit_reason(gqa_runner):
    eng = _engine(_Faulty(gqa_runner, "decode", error_every=1),
                  max_batch_size=4, max_step_retries=1)
    ids = [eng.add_request([i + 1, i + 2], SamplingParams(max_tokens=4))
           for i in range(3)]
    outs = eng.run()
    for rid in ids:
        assert outs[rid].finish_reason == "error"
        assert len(outs[rid].output_tokens) == 1   # prefill token survived
    assert eng.metrics.requests_aborted.value == 3
    assert eng.pool.allocator.check_no_leaks()
    eng = _engine(_Faulty(gqa_runner, "prefill", error_every=1),
                  max_step_retries=2)
    rid = eng.add_request([7, 8, 9], SamplingParams(max_tokens=4))
    assert eng.run()[rid].finish_reason == "error"
    assert eng.metrics.step_retries.value == 2
    assert eng.pool.allocator.check_no_leaks()


@pytest.mark.parametrize("policy,fraction,reason", [
    ("abort", 0.5, "error"), ("greedy", 0.5, "length"),
    ("greedy", 1.0, "error"),
])
def test_nan_policy(gqa_runner, policy, fraction, reason):
    faulty = _Faulty(gqa_runner, "decode", nan_calls=(1,),
                     nan_fraction=fraction)
    eng = _engine(faulty, max_batch_size=1, nan_policy=policy)
    rid = eng.add_request([3, 4, 5], SamplingParams(max_tokens=4))
    out = eng.run()[rid]
    assert out.finish_reason == reason
    assert eng.metrics.nan_logit_events.value == 1
    assert eng.pool.allocator.check_no_leaks()


def test_auditor_catches_leaked_and_double_owned_pages(gqa_runner):
    eng = _engine(gqa_runner, audit=False)
    eng.add_request([1, 2, 3], SamplingParams(max_tokens=8))
    eng.add_request([4, 5, 6], SamplingParams(max_tokens=8))
    eng.step()
    audit_engine(eng)                            # consistent
    eng.pool.allocator.alloc(1)                  # a page nobody owns
    with pytest.raises(InvariantViolation, match="leak"):
        audit_engine(eng)


def test_auditor_catches_slot_corruption(gqa_runner):
    eng = _engine(gqa_runner, audit=False)
    eng.add_request([1, 2, 3], SamplingParams(max_tokens=8))
    eng.add_request([4, 5, 6], SamplingParams(max_tokens=8))
    eng.step()
    a, b = eng.scheduler.running
    b.slot = a.slot
    with pytest.raises(InvariantViolation, match="slot"):
        audit_engine(eng)


def test_sampling_params_validation():
    with pytest.raises(ValueError):
        SamplingParams(max_tokens=0)
    with pytest.raises(ValueError):
        SamplingParams(timeout_s=0.0)


def test_create_engine_and_runner_for(gqa_runner):
    model = _bridge(_jax_model(1))
    eng = create_engine(model, device="cpu", block_size=8, max_model_len=64,
                        num_blocks=20, max_batch_size=2)
    rid = eng.add_request([1, 2, 3], SamplingParams(max_tokens=4))
    assert eng.run()[rid].output_tokens == naive_generate(
        gqa_runner, [1, 2, 3], SamplingParams(max_tokens=4),
        max_model_len=64)
    # Llama and GPT have runners (GPT: tests/test_torch_gpt_serving.py)
    with pytest.raises(TypeError, match="supported: Llama, GPT"):
        runner_for(torch.nn.Linear(2, 2))
    with pytest.raises(ValueError, match="attn_impl"):
        LlamaRunner(model, attn_impl="flash")
