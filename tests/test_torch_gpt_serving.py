"""The port's GPT serving path (GPTRunner under create_serving_engine)
against the JAX package's, on the CPU.

A small GPT (vocab 89, hidden 32, 2 layers, 2 heads of 16, 96 positions)
is built in JAX; its weights cross to the port as numpy. Then:

  * the bridge (tests/test_serving_engine.py::
    test_gpt_runner_and_inference_bridge): create_serving_engine(GPT)
    gives a GPTRunner, and its tokens equal the port's naive_generate and
    the JAX engine's, on the gather path and on the kernels' path (the
    ragged kernel for prefill chunks, the paged-decode kernel for decode:
    their plain versions here, counted), with no leaked page;
  * runner steps against the JAX GPTRunner: two prefill chunks (the second
    at start_pos > 0 across a page boundary) and decode steps beside a
    dead slot, over fp32, int8 and fp8 pools, the logits of every call
    within 1e-4;
  * int8 and fp8 engines: tokens equal the JAX engine's over the same
    pools, launches of the quantized ragged kernel only, and the tokens
    agree with the fp32 twin's naive_generate on at least 99 % of them
    (fp8 and fp32 equal their own naive_generate);
  * a horizon engine (decode_horizon=4, pipelined, seeded sampling) equal
    to the per-step engine: the engine takes the GPT runner unchanged;
  * the path per bucket resolves as the JAX runner's; the JAX positional
    parameters; weight_dtype other than fp32 raises naming item 8.
"""

import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import create_serving_engine as jax_create_engine
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving.kv_cache import KVCachePool as JaxKVCachePool
from paddle_tpu.serving.model_runner import GPTRunner as JaxGPTRunner
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.models import GPT, GPTConfig
from paddle_tpu_torch.ops import paged_attention as k2
from paddle_tpu_torch.ops import ragged_paged_attention as k1
from paddle_tpu_torch.serving import (
    GPTRunner, KVCachePool, SamplingParams, naive_generate, runner_for,
)
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

SIZES = dict(vocab_size=89, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=96, dropout=0.0)
LOGIT_ATOL = 1e-4
ENGINE = dict(block_size=8, max_model_len=96, num_blocks=24,
              max_batch_size=4, max_prefill_tokens_per_step=16)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(1)
    jm = JaxGPT(JaxGPTConfig(**SIZES))
    jm.eval()
    model = GPT(GPTConfig(**SIZES), device="cpu")
    load_params(model, {k: np.asarray(v) for k, v in
                        functionalize(jm).param_values().items()})
    return jm, model


def _prompts(seed=3, n=4):
    r = np.random.default_rng(seed)
    return [r.integers(1, 89, int(r.integers(6, 30))).tolist()
            for _ in range(n)]


def _serve(eng, prompts, sp, **kw):
    ids = [eng.add_request(p, sp(max_tokens=8, **kw)) for p in prompts]
    outs = eng.run()
    return [outs[i].output_tokens for i in ids]


def _reset_counts():
    for c in (k1.COUNTS, k1.COUNTS_I8, k1.COUNTS_F8, k2.COUNTS):
        c.reset()


@pytest.mark.parametrize("attn_impl", ["reference", "auto"])
def test_gpt_runner_and_inference_bridge(pair, attn_impl):
    jm, model = pair
    prompts = _prompts()
    _reset_counts()
    eng = create_serving_engine(model, device="cpu", attn_impl=attn_impl,
                                **ENGINE)
    assert isinstance(eng.runner, GPTRunner)
    toks = _serve(eng, prompts, SamplingParams)
    assert eng.pool.allocator.check_no_leaks()
    for t, p in zip(toks, prompts):
        assert t == naive_generate(eng.runner, p, SamplingParams(max_tokens=8),
                                   max_model_len=96)
    jeng = jax_create_engine(jm, attn_impl=attn_impl, **ENGINE)
    assert toks == _serve(jeng, prompts, JaxSamplingParams)
    kernels = (k1.COUNTS.plain_launches, k2.COUNTS.plain_launches)
    if attn_impl == "auto":
        assert min(kernels) > 0
    else:
        assert kernels == (0, 0)
    assert k1.COUNTS_I8.plain_launches == k1.COUNTS_F8.plain_launches == 0


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("attn_impl", ["auto", "reference"])
def test_step_logits_match_jax_runner(pair, kv_dtype, attn_impl):
    jm, model = pair
    bs, P = 8, 8
    jr = JaxGPTRunner(jm, bs, 96, attn_impl, kv_dtype)
    pr = GPTRunner(model, bs, 96, attn_impl, kv_dtype)
    d = pr.head_dim
    jpools = JaxKVCachePool(2, 1 + P, bs, 2, d, kv_dtype=kv_dtype).pools
    ppools = KVCachePool(2, 1 + P, bs, 2, d, device="cpu",
                         kv_dtype=kv_dtype).shards
    table = [3, 1, 4, 2, 5, 0, 0, 0]
    toks = [int(t) for t in np.random.default_rng(1).integers(1, 89, 20)]
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


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_engines_equal_jax_and_agree_with_fp32(pair, kv_dtype):
    jm, model = pair
    prompts = _prompts(4)
    _reset_counts()
    eng = create_serving_engine(model, device="cpu", kv_dtype=kv_dtype,
                                **ENGINE)
    toks = _serve(eng, prompts, SamplingParams)
    assert eng.pool.allocator.check_no_leaks()
    counts = k1.COUNTS_I8 if kv_dtype == "int8" else k1.COUNTS_F8
    assert counts.plain_launches > 0
    assert k1.COUNTS.plain_launches == k2.COUNTS.plain_launches == 0
    jeng = jax_create_engine(jm, kv_dtype=kv_dtype, attn_impl="reference",
                             **ENGINE)
    assert toks == _serve(jeng, prompts, JaxSamplingParams)
    fp32 = GPTRunner(model, 8, 96)
    oracle = [naive_generate(fp32, p, SamplingParams(max_tokens=8),
                             max_model_len=96) for p in prompts]
    agree = sum(int(a == b) for t, o in zip(toks, oracle)
                for a, b in zip(t, o))
    assert agree / sum(map(len, oracle)) >= 0.99
    if kv_dtype == "fp8":
        assert toks == [naive_generate(eng.runner, p,
                                       SamplingParams(max_tokens=8),
                                       max_model_len=96) for p in prompts]


def test_horizon_engine_serves_gpt_as_the_per_step_engine(pair):
    _, model = pair
    prompts = _prompts(5)
    kw = dict(temperature=0.8, top_k=20, seed=7)
    per_step = create_serving_engine(model, device="cpu", **ENGINE)
    horizon = create_serving_engine(model, device="cpu", decode_horizon=4,
                                    pipelined=True, horizon_sampling=True,
                                    **ENGINE)
    assert _serve(horizon, prompts, SamplingParams, **kw) == \
        _serve(per_step, prompts, SamplingParams, **kw)
    assert horizon.pool.allocator.check_no_leaks()


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("attn_impl", ["pallas", "ragged", "reference"])
def test_attn_impl_resolves_as_the_jax_runner(pair, kv_dtype, attn_impl):
    """The JAX "auto" takes the gather path off the TPU; the port's "auto"
    takes the kernels on every device, as "pallas" does in both."""
    jm, model = pair
    jr = JaxGPTRunner(jm, 8, 96, attn_impl, kv_dtype)
    pr = GPTRunner(model, 8, 96, attn_impl, kv_dtype)
    auto = GPTRunner(model, 8, 96, "auto", kv_dtype)
    for bucket in (1, 8, 16):
        assert pr._attn_impl_for(bucket) == jr._attn_impl_for(bucket)
        if attn_impl == "pallas":
            assert auto._attn_impl_for(bucket) == pr._attn_impl_for(bucket)
    if attn_impl == "pallas":
        assert pr._attn_impl_for(1) == (
            "paged_decode" if kv_dtype == "fp32" else "ragged")


def test_runner_takes_the_jax_arguments(pair):
    jm, model = pair

    def positional(fn):
        return [p.name for p in inspect.signature(fn).parameters.values()
                if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]

    assert positional(GPTRunner) == positional(JaxGPTRunner)
    assert inspect.signature(GPTRunner).parameters["device"].kind \
        is inspect.Parameter.KEYWORD_ONLY
    args = (8, 32, "ragged", "fp8", "fp32", 128)
    jr, pr = JaxGPTRunner(jm, *args), runner_for(model, *args)
    assert type(pr) is GPTRunner
    assert (pr.block_size, pr.max_model_len, pr.attn_impl, pr.kv_dtype,
            pr.weight_group_size, pr.n_heads, pr.n_kv_heads, pr.head_dim,
            pr.vocab_size) == (jr.block_size, jr.max_model_len, jr.attn_impl,
                               jr.kv_dtype, jr.weight_group_size, jr.n_heads,
                               jr.n_kv_heads, jr.head_dim, jr.vocab_size)
    # the weight ladder (item 8): the same matrices quantized as the JAX
    # runner's, to the same codes
    for weight_dtype in ("int8", "int4", "fp8"):
        qr = GPTRunner(model, weight_dtype=weight_dtype, device="cpu")
        jq = JaxGPTRunner(jm, weight_dtype=weight_dtype)
        assert qr._quantized_names == jq._quantized_names
        assert qr.weight_bytes() == jq.weight_bytes()
        for name in sorted(jq.params):
            a = qr.params[name]
            a = a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a
            b = np.asarray(jq.params[name])
            b = b.view(np.uint8) if "float8" in str(b.dtype) else b
            np.testing.assert_array_equal(a.numpy(), b)
