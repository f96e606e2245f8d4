"""Speculative decoding in the port against the JAX package, on the CPU.

Follows tests/test_serving_speculative.py and
tests/test_serving_spec_horizon.py on a small Llama (GQA) bridged from
JAX (and a small GPT for the packed planes):

  * `NgramProposer` (incremental and stateless, with its rebuild after a
    rollback, `propose_chain`) and `AdaptiveK` equal the JAX ones;
  * `runner.decode_multi_spec`'s packed [3, B, s, K+1] planes equal the
    JAX runner's on the same weights, pools and drafts, greedy and seeded;
  * the per-step verify path and the fused speculative horizon equal
    naive_generate and the JAX engine at zero, full and partial
    acceptance, greedy and seeded, with matching spec_* counters;
  * rejected tails roll their pages back, `reserve_speculation` shrinks a
    draft instead of preempting, `plan_spec_horizon` never preempts, the
    NaN policies hold on verify and fused steps;
  * `spec_draft_model="shadow:fp32"` serves token-exact with adaptive k,
    while `"shadow:int8"` raises naming ROADMAP item 8;
  * FaultInjector errors on verify and fused steps retry token-exact.

Every engine runs under the invariant auditor.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.serving import KVCachePool as JaxKVCachePool
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import runner_for as jax_runner_for
from paddle_tpu.serving.speculate import AdaptiveK as JaxAdaptiveK
from paddle_tpu.serving.speculate import NgramProposer as JaxNgramProposer
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.models import GPT, GPTConfig, Llama, LlamaConfig
from paddle_tpu_torch.serving import (
    FaultInjector, FCFSScheduler, KVCachePool, Request, SamplingParams,
    ServingEngine, naive_generate, runner_for,
)
from paddle_tpu_torch.serving.speculate import (
    AdaptiveK, DraftModelProposer, NgramProposer, shadow_runner,
)
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

MAX_LEN = 96
LLAMA = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=MAX_LEN)
GPT_SIZES = dict(vocab_size=89, hidden_size=32, num_layers=2, num_heads=2,
                 max_seq_len=MAX_LEN)


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


def _bridge(jm, pm):
    load_params(pm, {k: np.asarray(v) for k, v in
                     functionalize(jm).param_values().items()})
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(dropout=0.0, **LLAMA))
    jm.eval()
    return _bridge(jm, Llama(LlamaConfig(**LLAMA), device="cpu", seed=1))


@pytest.fixture(scope="module")
def gpt_pair():
    paddle.seed(1)
    jm = JaxGPT(JaxGPTConfig(dropout=0.0, **GPT_SIZES))
    jm.eval()
    return _bridge(jm, GPT(GPTConfig(**GPT_SIZES), device="cpu"))


def _periodic(seed, n=4, length=(12, 30)):
    """Prompts that repeat a random 3-6 token pattern (prompt lookup's
    regime, as bench.py's speculative rung)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pat = list(map(int, rng.integers(1, 97, int(rng.integers(3, 7)))))
        L = int(rng.integers(*length))
        out.append((pat * (L // len(pat) + 1))[:L])
    return out


# -------------------------------------------------------------- proposers

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ngram", [(3, 1), (2, 2), (4, 1)])
def test_ngram_proposer_equals_jax(seed, ngram):
    rng = np.random.default_rng(seed)
    ours, ref = NgramProposer(*ngram), JaxNgramProposer(*ngram)
    windowed = (NgramProposer(*ngram, scan_window=12),
                JaxNgramProposer(*ngram, scan_window=12))
    ctx = _periodic(seed, n=1, length=(8, 16))[0]
    for step in range(40):
        k = int(rng.integers(0, 6))
        assert ours.propose(ctx, k, request_id="r") == \
            ref.propose(ctx, k, request_id="r")
        assert ours.propose(ctx, k) == ref.propose(ctx, k)
        assert windowed[0].propose(ctx, k) == windowed[1].propose(ctx, k)
        assert ours.propose_chain(ctx, 3 * (k + 1) - 1, request_id="r") == \
            ref.propose_chain(ctx, 3 * (k + 1) - 1, request_id="r")
        if step % 9 == 8:               # a rollback rebuilds the index
            ctx = ctx[:-int(rng.integers(1, 5))]
        else:
            ctx = ctx + list(map(int, rng.integers(1, 97, int(
                rng.integers(1, 4)))))
    ours.release("r")
    assert "r" not in ours._index


def test_ngram_proposer_validation_equals_jax():
    for args in ((0, 1), (2, 3)):
        with pytest.raises(ValueError):
            NgramProposer(*args)
        with pytest.raises(ValueError):
            JaxNgramProposer(*args)
    with pytest.raises(ValueError):
        NgramProposer(scan_window=0)


def test_adaptive_k_equals_jax():
    rng = np.random.default_rng(0)
    ours, ref = AdaptiveK(4, alpha=0.5), JaxAdaptiveK(4, alpha=0.5)
    for _ in range(30):
        rid = f"r{int(rng.integers(0, 3))}"
        p = int(rng.integers(0, 5))
        a = int(rng.integers(0, p + 1))
        ours.update(rid, p, a)
        ref.update(rid, p, a)
        assert ours.k_for(rid) == ref.k_for(rid)
    ours.release("r0")
    assert ours.k_for("r0") == 4
    with pytest.raises(ValueError):
        AdaptiveK(-1)


# ----------------------------------------------------------------- runner

@pytest.mark.parametrize("sampling", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("model", ["llama", "gpt"])
def test_decode_multi_spec_planes_equal_jax(pair, gpt_pair, model, sampling):
    jm, pm = pair if model == "llama" else gpt_pair
    V = pm.cfg.vocab_size
    bs, P, B, s, K = 8, 6, 3, 3, 7
    jr = jax_runner_for(jm, bs, MAX_LEN, "reference")
    pr = runner_for(pm, bs, MAX_LEN)
    n_kv, d = pr.n_kv_heads, pr.head_dim
    jpools = JaxKVCachePool(2, 1 + B * P, bs, n_kv, d).pools
    ppools = KVCachePool(2, 1 + B * P, bs, n_kv, d, device="cpu").shards
    rng = np.random.default_rng(4)
    tables = np.arange(1, 1 + B * P, dtype=np.int32).reshape(B, P)
    lens = [13, 9, 20]
    greedy = []
    for b, L in enumerate(lens):
        toks = rng.integers(1, V, L).tolist()
        jl, jpools = jr.prefill_chunk(toks, 0, tables[b].tolist(), jpools)
        pr.prefill_chunk(toks, 0, tables[b].tolist(), ppools)
        greedy.append(int(np.argmax(np.asarray(jl))))
    # drafts: row 0 follows the model's greedy chain (full acceptance at
    # step 0), row 1 is garbage, row 2 carries 2 drafts a step
    chain, _ = jr.decode_multi(np.asarray(greedy, np.int32), tables,
                               np.asarray(lens, np.int32), jpools, 8)
    chain = np.asarray(chain)[0]
    drafts = np.full((B, s, K), -1, np.int32)
    drafts[0, 0, :4] = chain[0, :4]
    drafts[1] = rng.integers(1, V, (s, K))
    drafts[2, :, :2] = rng.integers(1, V, (s, 2))
    kw = dict(stop_ids=np.asarray([[-1], [-1], [int(chain[2, 1])]],
                                  np.int32),
              remaining=np.asarray([12, 5, 20], np.int32))
    if sampling:
        kw.update(seeds=np.asarray([3, 4, 5]), base_steps=np.asarray(
            [0, 2, 1], np.int32), temps=np.asarray([0.0, 0.8, 1.2],
                                                   np.float32),
            top_k=20, top_p=None)
    args = (np.asarray(greedy, np.int32), tables, np.asarray(lens, np.int32))
    jkw = dict(kw, seeds=np.asarray(kw["seeds"], np.int32)) if sampling \
        else kw
    ref, _ = jr.decode_multi_spec(*args, jpools, drafts, **jkw)
    got, _ = pr.decode_multi_spec(*args, ppools, drafts, **kw)
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape == (3, B, s, K + 1)
    np.testing.assert_array_equal(got[2].numpy(), ref[2])       # keep
    np.testing.assert_array_equal(got[1].numpy(), ref[1])       # finite
    kept = ref[2] != 0
    np.testing.assert_array_equal(got[0].numpy()[kept], ref[0][kept])
    assert ref[2, 0, 0].sum() >= 2          # row 0 accepted drafts


# ---------------------------------------------------------------- engines

class OracleProposer:
    """A proposer that knows each request's true continuation: "full"
    proposes it, "zero" proposes each true token + 1, "partial" the true
    chain with every third token off."""

    def __init__(self, streams, mode, vocab):
        self.streams, self.mode, self.vocab = streams, mode, vocab

    def _truth(self, context):
        for prompt, out in self.streams:
            n = len(context) - len(prompt)
            if n >= 0 and context[:len(prompt)] == prompt:
                return out[n:]
        return []

    def propose_chain(self, context, length, request_id=None):
        truth = list(self._truth(list(context)))[:length]
        if self.mode == "zero":
            return [(t + 1) % self.vocab for t in truth]
        if self.mode == "partial":
            return [(t + 1) % self.vocab if i % 3 == 2 else t
                    for i, t in enumerate(truth)]
        return truth

    propose = propose_chain


def _engines(pair, **kw):
    jm, pm = pair
    kw = {"num_blocks": 48, "max_batch_size": 3, "max_model_len": MAX_LEN,
          "max_prefill_tokens_per_step": 16, "num_speculative_tokens": 4,
          **kw}
    return (ServingEngine(runner_for(pm, 8, MAX_LEN), **kw),
            JaxServingEngine(jax_runner_for(jm, 8, MAX_LEN, "reference"),
                             **kw))


def _serve(eng, prompts, sps):
    ids = [eng.add_request(p, sp, f"r{i}")
           for i, (p, sp) in enumerate(zip(prompts, sps))]
    outs = eng.run()
    eng.release_prefix_cache()
    assert eng.pool.allocator.check_no_leaks()
    return [outs[i].output_tokens for i in ids]


def _sps(cls, seeded, n, max_tokens=14):
    if not seeded:
        return [cls(max_tokens=max_tokens) for _ in range(n)]
    return [cls(max_tokens=max_tokens, temperature=0.9, top_k=30,
                seed=7 + i) for i in range(n)]


SPEC_KEYS = ("spec_proposed_tokens", "spec_accepted_tokens",
             "spec_rollback_pages", "spec_fused_horizons",
             "spec_dead_positions", "decode_steps", "tokens_generated")


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("path", ["per_step", "fused"])
@pytest.mark.parametrize("mode", ["zero", "full", "partial"])
def test_speculative_engines_equal_naive_and_jax(pair, mode, path, seeded):
    prompts = _periodic(11)
    runner = runner_for(pair[1], 8, MAX_LEN)
    sps = _sps(SamplingParams, seeded, len(prompts))
    truth = [naive_generate(runner, p, sp, max_model_len=MAX_LEN,
                            fallback_seed=i)
             for i, (p, sp) in enumerate(zip(prompts, sps))]
    kw = (dict(decode_horizon=4, horizon_sampling=True,
               horizon_early_stop=True) if path == "fused" else {})
    ours, ref = _engines(pair, **kw)
    for eng in (ours, ref):
        eng.proposer = OracleProposer(list(zip(prompts, truth)), mode, 97)
        if path == "per_step":
            eng._spec_horizon_ready = lambda: False
    got = _serve(ours, prompts, sps)
    want = _serve(ref, prompts, _sps(JaxSamplingParams, seeded,
                                     len(prompts)))
    assert got == truth == want
    snap, jsnap = ours.metrics.snapshot(), ref.metrics.snapshot()
    for key in SPEC_KEYS:
        assert snap[key] == jsnap[key], key
    assert snap["spec_proposed_tokens"] > 0
    accepted = snap["spec_accepted_tokens"]
    if mode == "zero":
        assert accepted == 0
    elif mode == "full":
        assert accepted == snap["spec_proposed_tokens"]
    else:
        assert 0 < accepted < snap["spec_proposed_tokens"]
    assert (snap["spec_fused_horizons"] > 0) == (path == "fused")


@pytest.mark.parametrize("knobs", [
    dict(), dict(ragged_batch=True),
    dict(decode_horizon=8, pipelined=True, horizon_early_stop=True),
    dict(ragged_batch=True, enable_prefix_cache=True, pipelined=True,
         decode_horizon=4)],
    ids=["plain", "ragged", "horizon-pipelined", "all"])
def test_ngram_speculation_equals_naive_and_jax(pair, knobs):
    prompts = _periodic(12, n=5)
    runner = runner_for(pair[1], 8, MAX_LEN)
    sps = _sps(SamplingParams, False, len(prompts), max_tokens=20)
    ours, ref = _engines(pair, **knobs)
    got = _serve(ours, prompts, sps)
    assert got == _serve(ref, prompts, _sps(JaxSamplingParams, False,
                                            len(prompts), max_tokens=20))
    for p, sp, toks in zip(prompts, sps, got):
        assert toks == naive_generate(runner, p, sp, max_model_len=MAX_LEN)
    snap, jsnap = ours.metrics.snapshot(), ref.metrics.snapshot()
    for key in SPEC_KEYS:
        assert snap[key] == jsnap[key], key
    assert snap["spec_accepted_tokens"] > 0
    assert snap["steps_per_token"] < 1.0
    assert 0 < snap["spec_acceptance_rate"] <= 1.0


def test_create_serving_engine_serves_all_three_items(pair, gpt_pair):
    """The bridge serves Llama and GPT with the prefix cache, fused ragged
    steps and speculation on, token-equal to naive_generate and to the
    JAX engine on the same weights."""
    for jm, pm in (pair, gpt_pair):
        V = pm.cfg.vocab_size
        prompts = [[int(t) % V for t in p] for p in _periodic(13, n=4)]
        kw = dict(block_size=8, max_model_len=MAX_LEN, num_blocks=48,
                  max_batch_size=3, enable_prefix_cache=True,
                  ragged_batch=True, num_speculative_tokens=4,
                  max_prefill_tokens_per_step=16)
        eng = create_serving_engine(pm, device="cpu", **kw)
        from paddle_tpu.inference import create_serving_engine as jcse
        jeng = jcse(jm, attn_impl="reference", **kw)
        got = _serve(eng, prompts, _sps(SamplingParams, False, 4))
        assert got == _serve(jeng, prompts, _sps(JaxSamplingParams, False,
                                                 4))
        for p, toks in zip(prompts, got):
            assert toks == naive_generate(eng.runner, p, SamplingParams(
                max_tokens=14), max_model_len=MAX_LEN)
        assert eng.metrics.spec_proposed_tokens.value > 0


# ------------------------------------------- pages, budget, pool pressure

def test_rejected_tail_pages_roll_back(pair):
    prompts = _periodic(14, n=1, length=(15, 16))
    runner = runner_for(pair[1], 4, MAX_LEN)
    sp = SamplingParams(max_tokens=12)
    truth = naive_generate(runner, prompts[0], sp, max_model_len=MAX_LEN)
    for per_step in (True, False):
        eng = ServingEngine(runner, num_blocks=40, max_batch_size=1,
                            max_model_len=MAX_LEN, num_speculative_tokens=6)
        eng.proposer = OracleProposer([(prompts[0], truth)], "zero", 97)
        if per_step:
            eng._spec_horizon_ready = lambda: False
        assert _serve(eng, prompts, [sp]) == [truth]
        assert eng.metrics.spec_rollback_pages.value > 0


def test_verify_spans_count_against_the_prefill_budget(pair):
    def proposed(budget):
        ours, _ = _engines(pair, max_prefill_tokens_per_step=budget,
                           max_batch_size=2)
        _serve(ours, _periodic(15, n=2), _sps(SamplingParams, False, 2))
        return ours.metrics.spec_proposed_tokens.value
    assert proposed(1) < proposed(None)


def test_scheduler_speculation_budget():
    pool = KVCachePool(1, 8, 4, 1, 8, device="cpu")
    s = FCFSScheduler(pool, 1, 4, max_prefill_tokens_per_step=8)
    assert (s.speculation_budget(5), s.speculation_budget(8),
            s.speculation_budget(11)) == (3, 0, 0)
    assert FCFSScheduler(pool, 1, 4).speculation_budget(100) is None


def test_reserve_speculation_degrades_instead_of_preempting():
    pool = KVCachePool(1, 4, 4, 1, 8, device="cpu")    # 3 usable pages
    sched = FCFSScheduler(pool, 1, 3)
    req = Request(prompt_tokens=[1] * 7,
                  sampling=SamplingParams(max_tokens=8))
    sched.add(req)
    assert sched.admit() == [req]              # holds blocks(8) = 2 pages
    req.phase = "decode"
    req.output_tokens = [5]
    req.kv.num_tokens = 7
    pool.allocator.alloc(1)                    # someone takes the last page
    prop = {req: [9, 9, 9, 9]}
    sched.reserve_speculation(prop)
    assert prop[req] == [] and len(req.kv.pages) == 2
    pool.allocator.free(sorted(pool.allocator.allocated_pages
                               - set(req.kv.pages)))
    prop = {req: [9, 9, 9, 9]}
    assert sched.reserve_speculation(prop) == 4
    assert prop[req] == [9, 9, 9, 9] and len(req.kv.pages) == 3


def test_plan_spec_horizon_trims_and_never_preempts():
    pool = KVCachePool(1, 7, 4, 1, 8, device="cpu")    # 6 usable pages
    sched = FCFSScheduler(pool, 2, 6)
    reqs = [Request(prompt_tokens=[1] * 7,
                    sampling=SamplingParams(max_tokens=30))
            for _ in range(2)]
    for r in reqs:
        sched.add(r)
    assert sched.admit() == reqs               # 2 pages each
    for r in reqs:
        r.phase, r.output_tokens, r.kv.num_tokens = "decode", [5], 7
    row_k = {r: 3 for r in reqs}
    s = sched.plan_spec_horizon(4, row_k, {r: 20 for r in reqs})
    assert s == 1 and sched.running == reqs
    assert sum(len(r.kv.pages) for r in reqs) <= 6
    assert all(0 <= row_k[r] <= 3 for r in reqs)


# ------------------------------------------------------- faults and NaNs

@pytest.mark.parametrize("path", ["per_step", "fused"])
def test_fault_injected_speculation_retries_token_exact(pair, path):
    prompts = _periodic(16, n=3)
    runner = runner_for(pair[1], 8, MAX_LEN)
    sps = _sps(SamplingParams, False, 3)
    truth = [naive_generate(runner, p, sp, max_model_len=MAX_LEN)
             for p, sp in zip(prompts, sps)]
    inj = FaultInjector(runner, error_every=3)
    kw = dict(decode_horizon=4) if path == "fused" else {}
    eng = ServingEngine(inj, num_blocks=48, max_batch_size=3,
                        max_model_len=MAX_LEN, num_speculative_tokens=4,
                        retry_backoff_s=0.0, **kw)
    if path == "per_step":
        eng._spec_horizon_ready = lambda: False
    assert _serve(eng, prompts, sps) == truth
    assert inj.injected["error"] > 0 and eng.metrics.step_retries.value > 0
    assert (eng.metrics.spec_fused_horizons.value > 0) == (path == "fused")


@pytest.mark.parametrize("path", ["per_step", "fused"])
@pytest.mark.parametrize("policy", ["abort", "greedy"])
def test_nan_on_speculative_steps(pair, path, policy):
    runner = runner_for(pair[1], 8, MAX_LEN)
    inj = FaultInjector(runner, nan_every=2, nan_fraction=0.5)
    kw = dict(decode_horizon=4) if path == "fused" else {}
    eng = ServingEngine(inj, num_blocks=48, max_batch_size=2,
                        max_model_len=MAX_LEN, num_speculative_tokens=3,
                        nan_policy=policy, **kw)
    if path == "per_step":
        eng._spec_horizon_ready = lambda: False
    rid = eng.add_request(_periodic(17, n=1)[0], SamplingParams(max_tokens=8))
    outs = eng.run()
    assert eng.metrics.nan_logit_events.value > 0
    assert outs[rid].finish_reason == ("error" if policy == "abort"
                                       else "length")
    assert eng.pool.allocator.check_no_leaks()


# ------------------------------------------------------------ draft model

def test_shadow_fp32_draft_serves_token_exact_with_adaptive_k(pair):
    prompts = _periodic(18, n=3)
    runner = runner_for(pair[1], 8, MAX_LEN)
    sps = _sps(SamplingParams, False, 3)
    eng = ServingEngine(runner, num_blocks=48, max_batch_size=3,
                        max_model_len=MAX_LEN, num_speculative_tokens=4,
                        spec_draft_model="shadow:fp32", spec_adaptive_k=True,
                        decode_horizon=4, spec_draft_blocks=40)
    assert isinstance(eng.proposer, DraftModelProposer)
    assert eng.proposer.runner is not runner
    assert eng.proposer.runner.params == runner.params
    got = _serve(eng, prompts, sps)
    assert got == [naive_generate(runner, p, sp, max_model_len=MAX_LEN)
                   for p, sp in zip(prompts, sps)]
    assert eng.metrics.spec_accepted_tokens.value > 0
    assert eng.proposer._seqs == {}            # released with the requests
    assert eng.proposer.pool.allocator.check_no_leaks()


@pytest.mark.parametrize("rung", ["shadow:int8", "shadow:int4", "shadow:fp8",
                                  "shadow"])
def test_quantized_shadows_raise_naming_item_8(pair, rung):
    """The quantized shadows are ported with the weight ladder (item 8):
    each rung ("shadow" alone is int8, as in JAX) drafts from weights on
    its rung, the target's params untouched, and the engine keeps the
    target's stream token for token."""
    runner = runner_for(pair[1], 8, MAX_LEN)
    eng = ServingEngine(runner, num_blocks=48, max_batch_size=3,
                        max_model_len=MAX_LEN, num_speculative_tokens=2,
                        spec_draft_model=rung)
    dt = rung.partition(":")[2] or "int8"
    assert eng.proposer.runner.weight_dtype == dt
    assert eng.proposer.runner._quantized_names
    assert runner.weight_dtype == "fp32"
    prompts, sps = _periodic(21, n=3), _sps(SamplingParams, False, 3)
    got = _serve(eng, prompts, sps)
    assert got == [naive_generate(runner, p, sp, max_model_len=MAX_LEN)
                   for p, sp in zip(prompts, sps)]
    assert eng.proposer.pool.allocator.check_no_leaks()


def test_shadow_runner_refuses_unknown_rungs(pair):
    runner = runner_for(pair[1], 8, MAX_LEN)
    with pytest.raises(ValueError):
        shadow_runner(runner, "int2")
    with pytest.raises(ValueError, match="shadow"):
        ServingEngine(runner, num_blocks=16, max_model_len=MAX_LEN,
                      num_speculative_tokens=2, spec_draft_model="other")
