"""The port's weight ladder (int8, int4 and fp8 serving weights) against
the JAX package's, on the CPU.

The same numpy weights go through both packages:

  * the quantizers: `_pack_int4` / `_unpack_int4`, the weight-only int8
    `_weight_quantize` (per channel and grouped) and `int4_quantize`
    give codes and scales BIT-EQUAL to the JAX ones; `int4_dequantize`
    equals the numpy oracle bit for bit; `int4_matmul` (the grouped
    epilogue) is within 1e-5 of the JAX `int4_matmul` and of
    x @ `int4_dequantize_reference`;
  * the byte formulas, and the runners' `weight_bytes`,
    `weight_bytes_fp32` and `weight_bytes_reduction_x` equal to the JAX
    runners' (Llama and GPT, every rung), with their codes and scales
    bit-equal to the JAX runners' params;
  * step logits within 1e-4 of the JAX runner's on every rung; the
    engine token-exact against its naive_generate and equal to the JAX
    engine; the JAX accuracy gates against the fp32 twin, teacher-forced
    as `tests/test_serving_weight_quant.py` forces them (greedy >= 0.99,
    top-5 >= 0.9 where the JAX runners reach it, every argmax in the
    other's top 5), with the three numbers equal to the JAX runners';
  * the reference's dtype quirk: under `create_serving_engine(dtype=
    bfloat16)` fp8 weights come back bf16 and int8 / int4 scales become
    bf16, with the reduction factors equal to JAX's;
  * the quantized shadow drafts ("shadow" = int8, "shadow:int4", ...)
    quantize what the JAX shadow quantizes and keep the target's stream;
  * the auditor's weight-ladder checks and the knobs' validation.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import create_serving_engine as \
    jax_create_serving_engine
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.quantization import int4 as jax_int4
from paddle_tpu.quantization import int8 as jax_int8
from paddle_tpu.serving import GPTRunner as JaxGPTRunner
from paddle_tpu.serving import LlamaRunner as JaxLlamaRunner
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving.speculate import shadow_runner as jax_shadow_runner
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.models import GPT, GPTConfig, Llama, LlamaConfig
from paddle_tpu_torch.quantization import int4, int8
from paddle_tpu_torch.serving import (
    GPTRunner, InvariantViolation, KVCachePool, LlamaRunner, SamplingParams,
    ServingEngine, audit_engine, create_engine, naive_generate,
)
from paddle_tpu_torch.serving.model_runner import SCALE_SUFFIX
from paddle_tpu_torch.serving.speculate import shadow_runner
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

GROUP = 16     # divides hidden 64 and ffn 128
LOGIT_ATOL = 1e-4
LLAMA = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=96, ffn_hidden=128, dropout=0.0)
GPT_SIZES = dict(vocab_size=89, hidden_size=32, num_layers=2, num_heads=2,
                 max_seq_len=96, dropout=0.0)
RUNGS = ["int8", "int4", "fp8"]


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    """A port tensor or a JAX array as numpy (fp8 and bf16 as their bit
    patterns, so bit-equality compares bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    if "float8" in str(a.dtype):
        return a.view(np.uint8)
    if "bfloat16" in str(a.dtype):
        return a.view(np.int16)
    return a


@pytest.fixture(scope="module")
def llama_pair():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(**LLAMA))
    jm.eval()
    model = Llama(LlamaConfig(**LLAMA), device="cpu", seed=1)
    load_params(model, {k: np.asarray(v) for k, v in
                        functionalize(jm).param_values().items()})
    return jm, model


@pytest.fixture(scope="module")
def gpt_pair():
    paddle.seed(1)
    jm = JaxGPT(JaxGPTConfig(**GPT_SIZES))
    jm.eval()
    model = GPT(GPTConfig(**GPT_SIZES), device="cpu")
    load_params(model, {k: np.asarray(v) for k, v in
                        functionalize(jm).param_values().items()})
    return jm, model


def _runners(pair, kind, weight_dtype, **kw):
    jm, model = pair
    jcls, pcls = ((JaxLlamaRunner, LlamaRunner) if kind == "llama"
                  else (JaxGPTRunner, GPTRunner))
    kw = dict(block_size=8, max_model_len=96, weight_dtype=weight_dtype,
              weight_group_size=GROUP, **kw)
    return jcls(jm, **kw), pcls(model, device="cpu", **kw)


def _prompts(vocab, seed=7, n=3):
    r = np.random.default_rng(seed)
    return [list(map(int, r.integers(1, vocab, int(r.integers(6, 14)))))
            for _ in range(n)]


# ------------------------------------------------------- the quantizers

def test_int4_pack_unpack_bit_equal_to_jax():
    q = np.random.default_rng(19).integers(-7, 8, (48, 10)).astype(np.int8)
    packed = int8._pack_int4(_t(q))
    assert packed.dtype == torch.int8 and tuple(packed.shape) == (24, 10)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jax_int8._pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(int8._unpack_int4(packed).numpy(), q)
    with pytest.raises(ValueError):
        int8._pack_int4(_t(q[:7]))             # an odd in-dim is loud


@pytest.mark.parametrize("algo,group", [("weight_only_int8", -1),
                                        ("weight_only_int8", 16),
                                        ("weight_only_int4", -1),
                                        ("weight_only_int4", 16)])
def test_weight_quantize_bit_equal_to_jax(algo, group):
    """Codes and scales of the weight-only quantizer, per channel and
    grouped, with an all-zero output channel (quantized to 0, not NaN)."""
    w = np.random.default_rng(3).standard_normal((64, 12)).astype(np.float32)
    w[:, 5] = 0.0
    q, s = int8._weight_quantize(_t(w), algo, group)
    jq, js = jax_int8._weight_quantize(jnp.asarray(w), algo, group)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="2-D"):
        int8._weight_quantize(torch.zeros(3, 4, 8))


@pytest.mark.parametrize("k,n,group", [(64, 12, 16), (80, 6, 64),
                                       (6, 10, 128), (256, 10, 128)])
def test_int4_quantize_bit_equal_to_jax(k, n, group):
    """Packed codes and [out, groups] scales bit-equal, a partial last
    group's scale from its real rows only."""
    w = np.random.default_rng(k).standard_normal((k, n)).astype(np.float32)
    codes, scale = int4.int4_quantize(_t(w), group)
    jc, js = jax_int4.int4_quantize(w, group)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        int4.int4_dequantize(codes, scale, group).numpy(),
        int4.int4_dequantize_reference(codes.numpy(), scale.numpy(), group))
    np.testing.assert_array_equal(
        int4.int4_dequantize_reference(codes.numpy(), scale.numpy(), group),
        jax_int4.int4_dequantize_reference(np.asarray(jc), np.asarray(js),
                                           group))


@pytest.mark.parametrize("k,group", [(64, 32), (80, 64), (6, 128),
                                     (128, 16)])
def test_int4_matmul_matches_jax_and_the_dequant_oracle(k, group):
    """The grouped epilogue (each group's partial product scaled before
    the groups are summed) within 1e-5 of the JAX int4_matmul and of
    x @ the numpy dequantized weight (fp32, summed in another order)."""
    r = np.random.default_rng(k + group)
    w = r.standard_normal((k, 10)).astype(np.float32)
    x = r.standard_normal((3, 5, k)).astype(np.float32)
    codes, scale = int4.int4_quantize(_t(w), group)
    out = int4.int4_matmul(_t(x), codes, scale, group)
    assert out.dtype == torch.float32 and tuple(out.shape) == (3, 5, 10)
    ref = x @ int4.int4_dequantize_reference(codes.numpy(), scale.numpy(),
                                             group)
    jout = np.asarray(jax_int4.int4_matmul(
        jnp.asarray(x), jnp.asarray(codes.numpy()),
        jnp.asarray(scale.numpy()), group))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)


def test_int4_loud_errors_and_byte_formula():
    with pytest.raises(ValueError, match="2-D"):
        int4.int4_quantize(torch.zeros(3, 4, 8))
    with pytest.raises(ValueError, match="group_size"):
        int4.int4_quantize(torch.zeros(8, 4), group_size=0)
    for k, n, g in ((256, 10, 128), (80, 6, 64), (6, 10, 128)):
        assert int4.int4_weight_bytes(k, n, g) == \
            jax_int4.int4_weight_bytes(k, n, g)
        codes, scale = int4.int4_quantize(torch.randn(k, n), g)
        assert codes.numel() + 4 * scale.numel() == \
            int4.int4_weight_bytes(k, n, g)


# ---------------------------------------------------------- the runners

@pytest.mark.parametrize("weight_dtype", ["fp32"] + RUNGS)
@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_runner_weights_and_bytes_equal_jax(llama_pair, gpt_pair, kind,
                                            weight_dtype):
    """The same matrices quantized, to the same codes and scales, and the
    same byte accounting as the JAX runner."""
    pair = llama_pair if kind == "llama" else gpt_pair
    jr, pr = _runners(pair, kind, weight_dtype)
    assert pr._quantized_names == jr._quantized_names
    assert sorted(pr.params) == sorted(jr.params)
    for name in sorted(pr._quantized_names):
        for key in (name, name + SCALE_SUFFIX):
            if key in jr.params:
                np.testing.assert_array_equal(_np(pr.params[key]),
                                              _np(jr.params[key]))
    assert pr.weight_bytes() == jr.weight_bytes()
    assert pr.weight_bytes_fp32() == jr.weight_bytes_fp32()
    assert pr.weight_bytes_reduction_x() == pytest.approx(
        jr.weight_bytes_reduction_x(), rel=1e-12)
    if weight_dtype == "fp32":
        assert pr.weight_bytes_reduction_x() == 1.0
        assert not any(k.endswith(SCALE_SUFFIX) for k in pr.params)
    assert pr.dtype == torch.float32


@pytest.mark.parametrize("weight_dtype", RUNGS)
@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_step_logits_match_jax_runner(llama_pair, gpt_pair, kind,
                                      weight_dtype):
    """Two prefill chunks (the second past a page boundary), then batched
    decode steps beside a dead slot: logits within 1e-4 of the JAX
    runner's through the dequantizing epilogues."""
    pair = llama_pair if kind == "llama" else gpt_pair
    jr, pr = _runners(pair, kind, weight_dtype, attn_impl="reference")
    from paddle_tpu.serving import KVCachePool as JaxKVCachePool
    P = 8
    jpools = JaxKVCachePool(2, 1 + P, 8, pr.n_kv_heads, pr.head_dim).pools
    ppools = KVCachePool(2, 1 + P, 8, pr.n_kv_heads, pr.head_dim,
                         device="cpu").shards
    table = [3, 1, 4, 2, 5, 0, 0, 0]
    toks = _prompts(pr.vocab_size, n=1, seed=11)[0] * 2
    n = len(toks)
    for start, end in ((0, 9), (9, n)):
        jl, jpools = jr.prefill_chunk(toks[start:end], start, table, jpools)
        pl, ppools = pr.prefill_chunk(toks[start:end], start, table, ppools)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
    tables = np.asarray([table, [0] * P], np.int32)
    tok = int(np.argmax(np.asarray(jl)))
    for step in range(3):
        pos = np.asarray([n + step, 0], np.int32)
        feed = np.asarray([tok, 0], np.int32)
        jl, jpools = jr.decode(feed, tables, pos, jpools)
        pl, ppools = pr.decode(feed, tables, pos, ppools)
        np.testing.assert_allclose(pl[0].numpy(), np.asarray(jl)[0],
                                   atol=LOGIT_ATOL, rtol=0)
        tok = int(np.argmax(np.asarray(jl)[0]))


def _teacher_forced(ref_runner, q_runner, steps=16):
    """`tests/test_serving_weight_quant.py::_teacher_forced` on either
    package's runners: the fp32 greedy stream replayed through both.
    Returns (mean top-5 overlap, greedy agreement, cross argmax-in-top-5
    share)."""
    from paddle_tpu.serving import KVCachePool as JaxKVCachePool

    def pool_for(r):
        if isinstance(r, (LlamaRunner, GPTRunner)):
            return KVCachePool(r.num_layers, 13, 8, r.n_kv_heads,
                               r.head_dim, r.dtype, device="cpu")
        return JaxKVCachePool(r.num_layers, 13, 8, r.n_kv_heads, r.head_dim,
                              r.dtype)

    def host(x):
        return x.float().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    p = list(np.random.default_rng(5).integers(1, 96, 20))
    pools, tbls = [], []
    for r in (ref_runner, q_runner):
        pool = pool_for(r)
        tbls.append(pool.pad_table(pool.allocator.alloc(12), 12))
        pools.append(pool.shards if isinstance(pool, KVCachePool)
                     else pool.pools)
    l_ref, pools[0] = ref_runner.prefill(p, tbls[0], pools[0])
    l_q, pools[1] = q_runner.prefill(p, tbls[1], pools[1])
    toks, overlaps, agree, cross = list(p), [], 0, 0
    for _ in range(steps):
        a, b = host(l_ref), host(l_q)
        t5a = set(np.argsort(a)[-5:].tolist())
        t5b = set(np.argsort(b)[-5:].tolist())
        overlaps.append(len(t5a & t5b) / 5.0)
        agree += int(np.argmax(a) == np.argmax(b))
        cross += int(int(np.argmax(a)) in t5b and int(np.argmax(b)) in t5a)
        tok = int(np.argmax(a))
        pos = np.asarray([len(toks)], np.int32)
        toks.append(tok)
        l_ref, pools[0] = ref_runner.decode(
            np.asarray([tok], np.int32),
            np.asarray(tbls[0], np.int32)[None], pos, pools[0])
        l_q, pools[1] = q_runner.decode(
            np.asarray([tok], np.int32),
            np.asarray(tbls[1], np.int32)[None], pos, pools[1])
        l_ref, l_q = l_ref[0], l_q[0]
    return float(np.mean(overlaps)), agree / steps, cross / steps


@pytest.mark.parametrize("weight_dtype", RUNGS)
def test_accuracy_gates_vs_fp32(llama_pair, weight_dtype):
    """The JAX package's gates against the fp32 twin, on the JAX test's
    own model: the port's three numbers equal the JAX runners' on the
    same weights; greedy >= 0.99 and every argmax in the other's top 5 on
    every rung; top-5 overlap >= 0.9 (the floor the JAX tests hold a
    96-token vocabulary to) on int8 and fp8. int4 reaches 0.8625 here in
    both packages: the reference misses its own floor on this jax
    (`tests/test_serving_weight_quant.py::test_int4_accuracy_gates_vs_
    fp32` fails too), so the port is held to the reference's number."""
    jm, model = llama_pair
    ref = LlamaRunner(model, 8, 96, device="cpu")
    q = LlamaRunner(model, 8, 96, weight_dtype=weight_dtype,
                    weight_group_size=GROUP, device="cpu")
    got = _teacher_forced(ref, q)
    want = _teacher_forced(
        JaxLlamaRunner(jm, block_size=8, max_model_len=96),
        JaxLlamaRunner(jm, block_size=8, max_model_len=96,
                       weight_dtype=weight_dtype, weight_group_size=GROUP))
    assert got == want
    top5, greedy, cross = got
    assert greedy >= 0.99
    assert cross == 1.0
    if weight_dtype != "int4":
        assert top5 >= 0.9


@pytest.mark.parametrize("weight_dtype", RUNGS)
@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_engine_is_token_exact_and_equals_jax(llama_pair, gpt_pair, kind,
                                              weight_dtype):
    """A quantized engine: token-exact against its naive_generate, equal to
    the JAX engine on the same weights, the gauge set."""
    pair = llama_pair if kind == "llama" else gpt_pair
    jr, pr = _runners(pair, kind, weight_dtype)
    prompts = _prompts(pr.vocab_size)
    kw = dict(num_blocks=64, max_batch_size=4, max_model_len=96,
              max_prefill_tokens_per_step=16)
    peng, jeng = ServingEngine(pr, **kw), JaxServingEngine(jr, **kw)
    pids = [peng.add_request(p, SamplingParams(max_tokens=8))
            for p in prompts]
    jids = [jeng.add_request(p, JaxSamplingParams(max_tokens=8))
            for p in prompts]
    pouts, jouts = peng.run(), jeng.run()
    got = [pouts[i].output_tokens for i in pids]
    assert got == [jouts[i].output_tokens for i in jids]
    assert got == [naive_generate(pr, p, SamplingParams(max_tokens=8))
                   for p in prompts]
    assert peng.metrics.snapshot()["weight_bytes_reduction_x"] == \
        pytest.approx(jeng.metrics.snapshot()["weight_bytes_reduction_x"])
    assert peng.pool.allocator.check_no_leaks()


# --------------------------------------------------- the dtype= quirk

@pytest.mark.parametrize("weight_dtype", ["fp32"] + RUNGS)
def test_bf16_cast_touches_the_ladder_as_jax_does(llama_pair, weight_dtype):
    """create_serving_engine(dtype=bfloat16) casts every floating param
    after the runner is built, the ladder's own included: fp8 weights come
    back bf16, int8 / int4 scales become bf16, codes stay int8; the
    runner's dtype, its pools and its reduction factors equal JAX's."""
    jm, model = llama_pair
    kw = dict(block_size=8, max_model_len=96, num_blocks=16,
              weight_dtype=weight_dtype, weight_group_size=GROUP)
    jeng = jax_create_serving_engine(jm, dtype=jnp.bfloat16, **kw)
    peng = create_serving_engine(model, dtype=torch.bfloat16, device="cpu",
                                 audit=False, **kw)
    assert peng.runner.dtype == torch.bfloat16
    assert peng.pool.pools[0][0].dtype == torch.bfloat16
    assert str(jeng.pool.pools[0][0].dtype) == "bfloat16"
    for name, v in peng.runner.params.items():
        jv = jeng.runner.params[name]
        assert str(v.dtype).split(".")[-1] == str(jv.dtype), name
        np.testing.assert_array_equal(_np(v), _np(jv))
    assert peng.runner.weight_bytes_reduction_x() == pytest.approx(
        jeng.runner.weight_bytes_reduction_x(), rel=1e-12)
    assert peng.metrics.snapshot()["weight_bytes_reduction_x"] == \
        pytest.approx(jeng.metrics.snapshot()["weight_bytes_reduction_x"])
    if weight_dtype in ("fp32", "fp8"):
        assert peng.runner.weight_bytes_reduction_x() == 2.0
    # the model itself is never cast
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ------------------------------------------------------------ shadows

@pytest.mark.parametrize("rung", ["shadow", "shadow:int8", "shadow:int4",
                                  "shadow:fp8"])
def test_quantized_shadow_drafts_keep_the_target_stream(llama_pair, rung):
    """A shadow on each rung ("shadow" = int8) quantizes the matrices the
    JAX shadow quantizes, to the same codes; it proposes, the fp32 target
    verifies: token-exact against the target's naive_generate with
    accepted drafts, the target's params untouched."""
    jm, model = llama_pair
    jt = JaxLlamaRunner(jm, block_size=8, max_model_len=96,
                        weight_group_size=GROUP)
    pt = LlamaRunner(model, 8, 96, weight_group_size=GROUP, device="cpu")
    dt = rung.partition(":")[2] or "int8"
    js, ps_ = jax_shadow_runner(jt, dt), shadow_runner(pt, dt)
    assert ps_.weight_dtype == js.weight_dtype == dt
    assert ps_._quantized_names == js._quantized_names
    for key in js.params:
        np.testing.assert_array_equal(_np(ps_.params[key]),
                                      _np(js.params[key]))
    eng = ServingEngine(pt, num_blocks=64, max_batch_size=4,
                        max_model_len=96, num_speculative_tokens=3,
                        spec_draft_model=rung)
    assert eng.proposer.runner.weight_dtype == dt
    assert not any(k.endswith(SCALE_SUFFIX) for k in pt.params)
    prompts = _prompts(96)
    ids = [eng.add_request(p, SamplingParams(max_tokens=8))
           for p in prompts]
    outs = eng.run()
    for rid, p in zip(ids, prompts):
        assert outs[rid].output_tokens == naive_generate(
            pt, p, SamplingParams(max_tokens=8))
    assert eng.metrics.spec_accepted_tokens.value > 0
    assert eng.proposer.pool.allocator.check_no_leaks()


def test_shadow_of_a_bf16_target_keeps_its_bf16_weights(llama_pair):
    """The JAX shadow quantizes the weights whose numpy dtype is a numpy
    floating type; bf16 is not one, so a bf16 target's shadow keeps its
    weights, here as there."""
    jm, model = llama_pair
    jeng = jax_create_serving_engine(jm, dtype=jnp.bfloat16, block_size=8,
                                     max_model_len=96, num_blocks=16)
    peng = create_serving_engine(model, dtype=torch.bfloat16, device="cpu",
                                 block_size=8, max_model_len=96,
                                 num_blocks=16)
    js = jax_shadow_runner(jeng.runner, "int8")
    ps_ = shadow_runner(peng.runner, "int8")
    assert ps_._quantized_names == js._quantized_names == frozenset()
    assert ps_.weight_dtype == js.weight_dtype == "int8"


# ------------------------------------------------- auditor, knobs

def test_auditor_checks_the_weight_ladder(llama_pair):
    """int4 scales of the wrong shape, codes that are not int8, and a
    scale beside an fp8 weight break the audit, as in JAX."""
    _, model = llama_pair
    r4 = LlamaRunner(model, 8, 96, weight_dtype="int4",
                     weight_group_size=GROUP, device="cpu")
    eng = ServingEngine(r4, num_blocks=16, max_batch_size=2,
                        max_model_len=96)
    audit_engine(eng)
    name = sorted(r4._quantized_names)[0]
    codes, good = r4.params[name], r4.params[name + SCALE_SUFFIX]
    try:
        r4.params[name + SCALE_SUFFIX] = good[:, :1]
        with pytest.raises(InvariantViolation, match="group"):
            audit_engine(eng)
        r4.params[name + SCALE_SUFFIX] = good
        r4.params[name] = codes.float()
        with pytest.raises(InvariantViolation, match="int8"):
            audit_engine(eng)
    finally:
        r4.params[name] = codes
        r4.params[name + SCALE_SUFFIX] = good
    audit_engine(eng)
    r8 = LlamaRunner(model, 8, 96, weight_dtype="fp8", device="cpu")
    eng8 = ServingEngine(r8, num_blocks=16, max_batch_size=2,
                         max_model_len=96)
    audit_engine(eng8)
    name = sorted(r8._quantized_names)[0]
    r8.params[name + SCALE_SUFFIX] = torch.ones(4)
    with pytest.raises(InvariantViolation, match="scale-free"):
        audit_engine(eng8)


def test_weight_knobs_are_validated_and_threaded(llama_pair):
    _, model = llama_pair
    with pytest.raises(ValueError, match="weight_dtype"):
        LlamaRunner(model, 8, 96, weight_dtype="int2", device="cpu")
    with pytest.raises(ValueError, match="weight_group_size"):
        LlamaRunner(model, 8, 96, weight_dtype="int4", weight_group_size=0,
                    device="cpu")
    with pytest.raises(ValueError, match="shadow weight_dtype"):
        shadow_runner(LlamaRunner(model, 8, 96, device="cpu"), "int2")
    eng = create_engine(model, num_blocks=16, block_size=8,
                        weight_dtype="int4", weight_group_size=GROUP,
                        device="cpu")
    assert (eng.runner.weight_dtype, eng.runner.weight_group_size) == \
        ("int4", GROUP)
    eng2 = create_serving_engine(model, device="cpu", num_blocks=16,
                                 block_size=8, weight_dtype="int4",
                                 weight_group_size=GROUP)
    assert eng2.runner.weight_group_size == GROUP
    assert eng2.metrics.snapshot()["weight_bytes_reduction_x"] >= 3.5
