"""Fused ragged steps (`ragged_batch`) in the port against the JAX package,
on the CPU.

Follows tests/test_serving_ragged.py on a small Llama (GQA) and a small
GPT (MHA), each bridged from JAX:

  * `runner.ragged_step` on one mixed launch (a prefill chunk at
    start_pos > 0 crossing a page boundary, a decode row, a 1 + k verify
    span and a dead slot) gives the JAX runner's logits within 1e-4 of
    max|logit|, at each span's last row and with `full_logits`, over
    fp32, int8 and fp8 pools (the JAX runner's ragged kernel in interpret
    mode against the port's plain K1 / K1-q);
  * the fused engine's tokens equal the unfused engine's, naive_generate's
    and the JAX fused engine's, also pipelined, with one runner call per
    step that has chunks and decode rows;
  * FaultInjector errors on `ragged_step` retry token-exact, NaN logits
    follow the NaN policy, and the pipelined commit of a fused launch
    survives a drain fault.

Every engine runs under the invariant auditor.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch.ops.paged_attention as k2
import paddle_tpu_torch.ops.ragged_paged_attention as k1
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.serving import KVCachePool as JaxKVCachePool
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import runner_for as jax_runner_for
from paddle_tpu_torch.models import GPT, GPTConfig, Llama, LlamaConfig
from paddle_tpu_torch.serving import (
    FaultInjector, InjectedDeviceError, KVCachePool, SamplingParams,
    ServingEngine, bucket_len, naive_generate, runner_for,
)
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

MAX_LEN = 96
LLAMA = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=MAX_LEN)
GPT_SIZES = dict(vocab_size=89, hidden_size=32, num_layers=2, num_heads=2,
                 max_seq_len=MAX_LEN)
KINDS = ["fp32", "int8", "fp8"]


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


def _bridge(jm, port_model):
    load_params(port_model, {k: np.asarray(v) for k, v in
                             functionalize(jm).param_values().items()})
    return jm, port_model


@pytest.fixture(scope="module", params=["llama", "gpt"])
def pair(request):
    paddle.seed(0)
    if request.param == "llama":
        jm = JaxLlama(JaxLlamaConfig(dropout=0.0, **LLAMA))
        jm.eval()
        return _bridge(jm, Llama(LlamaConfig(**LLAMA), device="cpu", seed=1))
    jm = JaxGPT(JaxGPTConfig(dropout=0.0, **GPT_SIZES))
    jm.eval()
    return _bridge(jm, GPT(GPTConfig(**GPT_SIZES), device="cpu"))


def _vocab(pair):
    return pair[1].cfg.vocab_size


# ---------------------------------------------------------------- runner

@pytest.mark.parametrize("full", [False, True], ids=["last", "full"])
@pytest.mark.parametrize("kv_dtype", KINDS)
def test_ragged_step_matches_jax_runner(pair, kv_dtype, full):
    jm, pm = pair
    bs, P = 8, 8
    jr = jax_runner_for(jm, bs, MAX_LEN, "ragged", kv_dtype)
    pr = runner_for(pm, bs, MAX_LEN, "ragged", kv_dtype)
    n_kv, d = pr.n_kv_heads, pr.head_dim
    jpools = JaxKVCachePool(2, 13, bs, n_kv, d, kv_dtype=kv_dtype).pools
    ppools = KVCachePool(2, 13, bs, n_kv, d, device="cpu",
                         kv_dtype=kv_dtype).shards
    rng = np.random.default_rng(2)
    seqs = [rng.integers(1, _vocab(pair), n).tolist() for n in (20, 11, 9)]
    tabs = [[3, 1, 4, 0, 0, 0, 0, 0], [2, 5, 0, 0, 0, 0, 0, 0],
            [6, 7, 0, 0, 0, 0, 0, 0]]
    # fill: sequence 0 up to 12 (its chunk [12, 20) rides the launch),
    # sequence 1 up to 10 (decode row at 10), sequence 2 up to 6 (verify
    # span [6, 9))
    for toks, table, upto in zip(seqs, tabs, (12, 10, 6)):
        _, jpools = jr.prefill_chunk(toks[:upto], 0, table, jpools)
        pr.prefill_chunk(toks[:upto], 0, table, ppools)
    spans = [(0, 12, 20), (1, 10, 11), (2, 6, 9)]       # slot 3 is dead
    B, T = 4, bucket_len(8)
    tokens = np.zeros((B, T), np.int32)
    starts = np.zeros((B,), np.int32)
    qlens = np.zeros((B,), np.int32)
    tables = np.zeros((B, P), np.int32)
    for sl, (i, start, end) in enumerate(spans):
        tokens[sl, :end - start] = seqs[i][start:end]
        starts[sl], qlens[sl] = start, end - start
        tables[sl] = tabs[i]
    jl, _ = jr.ragged_step(tokens, tables, starts, qlens, jpools,
                           full_logits=full)
    pl, _ = pr.ragged_step(tokens, tables, starts, qlens, ppools,
                           full_logits=full)
    jl = np.asarray(jl)
    assert tuple(pl.shape) == jl.shape == ((B, T, _vocab(pair)) if full
                                           else (B, _vocab(pair)))
    rows = ([(sl, t) for sl, (_, s, e) in enumerate(spans)
             for t in range(e - s)] if full else [(sl,) for sl in range(3)])
    ref = np.stack([jl[r] for r in rows])
    got = np.stack([pl.numpy()[r] for r in rows])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_ragged_step_launches_the_ragged_kernel_once_a_layer(pair):
    _, pm = pair
    pr = runner_for(pm, 8, MAX_LEN)
    pool = KVCachePool(2, 8, 8, pr.n_kv_heads, pr.head_dim, device="cpu")
    k1.COUNTS.reset()
    k2.COUNTS.reset()
    tokens = np.ones((3, 8), np.int32)
    tables = np.asarray([[1, 2], [3, 4], [0, 0]], np.int32)
    pr.ragged_step(tokens, tables, np.asarray([0, 5, 0], np.int32),
                   np.asarray([8, 1, 0], np.int32), pool.shards)
    assert k1.COUNTS.plain_launches == pm.cfg.num_layers
    assert k2.COUNTS.plain_launches == 0


# --------------------------------------------------------------- engines

def _work(pair, seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, _vocab(pair), int(rng.integers(3, 40))).tolist(),
             int(rng.integers(2, 12))) for _ in range(n)]


def _port(pair, kv_dtype="fp32", runner=None, **kw):
    kw = {"num_blocks": 48, "max_batch_size": 3, "max_model_len": MAX_LEN,
          "max_prefill_tokens_per_step": 16, **kw}
    return ServingEngine(runner or runner_for(pair[1], 8, MAX_LEN,
                                              kv_dtype=kv_dtype), **kw)


def _serve(eng, work, sp=SamplingParams):
    ids = [eng.add_request(p, sp(max_tokens=mt)) for p, mt in work]
    outs = eng.run()
    assert eng.pool.allocator.check_no_leaks()
    return [outs[i].output_tokens for i in ids]


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
@pytest.mark.parametrize("kv_dtype", KINDS)
def test_fused_engine_equals_unfused_naive_and_jax(pair, kv_dtype,
                                                   pipelined):
    jm, pm = pair
    work = _work(pair)
    fused = _port(pair, kv_dtype, ragged_batch=True, pipelined=pipelined)
    calls = []
    real = fused.runner.ragged_step
    fused.runner.ragged_step = lambda *a, **kw: calls.append(1) or real(
        *a, **kw)
    got = _serve(fused, work)
    assert calls, "no fused launch ran"
    assert got == _serve(_port(pair, kv_dtype), work)
    jeng = JaxServingEngine(
        jax_runner_for(jm, 8, MAX_LEN, "reference", kv_dtype),
        num_blocks=48, max_batch_size=3, max_model_len=MAX_LEN,
        max_prefill_tokens_per_step=16, ragged_batch=True,
        pipelined=pipelined)
    assert got == _serve(jeng, work, JaxSamplingParams)
    if kv_dtype != "int8":     # int8 scales follow the chunk breaks
        for (p, mt), toks in zip(work, got):
            assert toks == naive_generate(fused.runner, p, SamplingParams(
                max_tokens=mt), max_model_len=MAX_LEN)


def test_fused_step_is_one_runner_call(pair):
    """A step with chunks and decode rows makes one runner call (no
    prefill_chunk, no decode) and counts every chunk's tokens."""
    eng = _port(pair, ragged_batch=True)
    seen = []
    for name in ("prefill_chunk", "decode", "decode_multi", "ragged_step"):
        real = getattr(eng.runner, name)
        setattr(eng.runner, name,
                lambda *a, _n=name, _r=real, **kw: seen.append(_n)
                or _r(*a, **kw))
    work = _work(pair, seed=3)
    eng.add_request(*work[0][:1], SamplingParams(max_tokens=8))
    eng.step()                                  # alone: its own chunks
    while eng.scheduler.running[0].phase != "decode":
        eng.step()
    eng.add_request(work[1][0], SamplingParams(max_tokens=4))
    seen.clear()
    eng.step()
    assert seen == ["ragged_step"]
    eng.run()


def test_sampled_fused_engine_equals_the_unfused_engine(pair):
    work = _work(pair, seed=5)

    def sp(max_tokens):
        return SamplingParams(max_tokens=max_tokens, temperature=0.9,
                              top_k=20, seed=11)
    assert _serve(_port(pair, ragged_batch=True), work, sp) == \
        _serve(_port(pair), work, sp)


# ---------------------------------------------------------------- faults

def test_ragged_step_faults_retry_token_exact(pair):
    work = _work(pair, seed=7)
    ref = _serve(_port(pair, ragged_batch=True), work)
    inj = FaultInjector(runner_for(pair[1], 8, MAX_LEN), error_every=3)
    eng = _port(pair, runner=inj, ragged_batch=True, retry_backoff_s=0.0)
    assert _serve(eng, work) == ref
    assert inj.injected["error"] > 0 and eng.metrics.step_retries.value > 0
    assert inj.calls["decode"] > 0


def test_ragged_step_nan_policies(pair):
    work = _work(pair, seed=8, n=3)
    ref = _serve(_port(pair, ragged_batch=True), work)
    for policy in ("greedy", "abort"):
        inj = FaultInjector(runner_for(pair[1], 8, MAX_LEN), nan_calls=(2,),
                            nan_fraction=0.5)
        eng = _port(pair, runner=inj, ragged_batch=True, nan_policy=policy)
        ids = [eng.add_request(p, SamplingParams(max_tokens=mt))
               for p, mt in work]
        outs = eng.run()
        assert eng.pool.allocator.check_no_leaks()
        assert eng.metrics.nan_logit_events.value > 0
        reasons = {outs[i].finish_reason for i in ids}
        if policy == "abort":
            assert "error" in reasons
        else:
            assert "error" not in reasons
            # the greedy rescue argmaxes the finite half: tokens may part,
            # but every request still runs to its length
            assert [len(outs[i].output_tokens) for i in ids] == \
                [len(t) for t in ref]


def test_pipelined_fused_commit_reruns_after_a_drain_fault(pair,
                                                           monkeypatch):
    work = _work(pair, seed=9)
    ref = _serve(_port(pair, ragged_batch=True), work)
    eng = _port(pair, ragged_batch=True, pipelined=True, retry_backoff_s=0.0)
    real = engine_mod._to_host
    state = {"n": 0}

    def flaky(x):
        state["n"] += 1
        if state["n"] == 4:
            raise InjectedDeviceError("drain fault")
        return real(x)
    monkeypatch.setattr(engine_mod, "_to_host", flaky)
    assert _serve(eng, work) == ref
    assert eng.metrics.step_retries.value >= 1
