"""The port's fp16 serving (`create_serving_engine(dtype=float16)`)
against the JAX package's, on the CPU.

The same numpy inputs, rounded to fp16 once, go through both packages:

  * the plain fp16 K1 (its span and decode forms, over fp16, int8 and
    fp8 pools) and the plain fp16 K2 against the Pallas kernels in
    interpret mode on the same fp16 operands. Both widen each tile to
    fp32, sum in fp32 and round the output to fp16 once, in other orders:
    each output within one fp16 ulp (rtol 2^-10; atol 2^-20 for the
    outputs whose fp32 sums cancel to near 0), rows past q_len exactly 0;
  * the fp16 runner's logits against the JAX fp16 runner's, teacher-
    forced as `tests/test_torch_bf16_serving.py` forces them: XLA and
    torch round fp16 matmuls, norms and residuals at other points, so the
    logits agree within 2^-8 of max|logit| (four fp16 ulps of the
    largest), and the greedy tokens wherever JAX's top-2 margin exceeds
    twice that; over fp16 (the "fp32" rung at the runner's dtype), int8
    and fp8 pools, GQA and MHA, Llama and GPT;
  * the fp16 runner's logits within 2^-6 of max|logit| of its fp32
    twin's (`chip_smoke.py`'s TWIN_TOL at fp16: bf16's rule of eight
    rounding steps, at fp16's 2^-12);
  * the fp16 engine (batched, chunked, with decode horizons) token-exact
    against the port's own naive_generate at fp16, through the fp16
    kernels' plain versions only, over fp16, int8, fp8 and mixed pools,
    and its greedy tokens equal to the JAX fp16 engine's on the same
    weights;
  * the KV write paths on fp16 rows (`quantized_page_write`, `fp8_round`,
    `fp8_page_write`) bit-equal to JAX's;
  * the weight ladder under dtype=float16 equal to JAX's cast (fp8 weights
    come back fp16, int8 / int4 scales become fp16) and its runners'
    logits within 2^-8 of the JAX fp16 runners', and `shadow_runner`
    of an fp16 target quantizing what the JAX shadow quantizes (fp16 is a
    numpy floating type; a bf16 target's shadow keeps its weights);
  * `PagedGPTGenerator` over an fp16-cast GPT giving JAX's tokens.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.models.generation as jgen
from paddle_tpu.inference import create_serving_engine as \
    jax_create_serving_engine
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.serving import KVCachePool as JaxKVCachePool
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import kv_cache as jax_kv
from paddle_tpu.serving.speculate import shadow_runner as jax_shadow_runner
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.models import GPT, GPTConfig, Llama, LlamaConfig
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.ops import paged_attention as k2
from paddle_tpu_torch.ops import ragged_paged_attention as k1
from paddle_tpu_torch.serving import (
    KVCachePool, SamplingParams, kv_cache, naive_generate,
)
from paddle_tpu_torch.serving.speculate import shadow_runner
from paddle_tpu_torch.weights import load_params

jax_k1 = importlib.import_module(
    "paddle_tpu.ops.pallas.ragged_paged_attention")
jax_k2 = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")

torch.set_num_threads(1)

ULP_RTOL, ULP_ATOL = 2.0 ** -10, 2.0 ** -20
LOGIT_TOL = 2.0 ** -8          # of max|logit|, against the JAX fp16 runner
TWIN_TOL = 2.0 ** -6           # of max|logit|, against the fp32 twin
LLAMA = dict(vocab_size=97, hidden_size=64, num_layers=2, max_seq_len=96,
             num_heads=4, dropout=0.0)
GPT_SIZES = dict(vocab_size=89, hidden_size=32, num_layers=2, num_heads=2,
                 max_seq_len=96, dropout=0.0)
POOL = {"fp16": torch.float16, "int8": torch.int8,
        "fp8": torch.float8_e4m3fn}
GROUP = 16     # int4 groups: divide hidden 64 and ffn 128


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


def _f16_exact(a):
    """fp32 values exactly representable in fp16 (rounded once)."""
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


def _np(x):
    """A port tensor or a JAX array as numpy: fp16 and the integer codes
    as they are, bf16 and fp8 widened to fp32 (exactly)."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            x = x.float()
        return x.detach().numpy()
    if str(x.dtype) in ("bfloat16", "float8_e4m3fn"):
        x = x.astype(jnp.float32)
    return np.asarray(x)


def _pools(rng, kind, nb, ps, n_kv, d):
    """(port k, port v, jax k, jax v, port scales, jax scales)."""
    k, v = (_f16_exact(rng.standard_normal((nb, ps, n_kv, d)))
            for _ in range(2))
    if kind == "fp16":
        return (torch.from_numpy(k).half(), torch.from_numpy(v).half(),
                jnp.asarray(k, jnp.float16), jnp.asarray(v, jnp.float16),
                {}, {})
    if kind == "fp8":
        kb, vb = (np.array(jnp.asarray(x).astype(jnp.float8_e4m3fn)
                           .view(jnp.uint8)) for x in (k, v))
        return (torch.from_numpy(kb).view(torch.float8_e4m3fn),
                torch.from_numpy(vb).view(torch.float8_e4m3fn),
                jnp.asarray(kb).view(jnp.float8_e4m3fn),
                jnp.asarray(vb).view(jnp.float8_e4m3fn), {}, {})
    codes = [rng.integers(-127, 128, (nb, ps, n_kv, d)).astype(np.int8)
             for _ in range(2)]
    scales = [(rng.random((nb, n_kv)) * 0.05 + 1e-3).astype(np.float32)
              for _ in range(2)]
    return (*(torch.from_numpy(c) for c in codes),
            *(jnp.asarray(c) for c in codes),
            dict(k_scale=torch.from_numpy(scales[0]),
                 v_scale=torch.from_numpy(scales[1])),
            dict(k_scale=jnp.asarray(scales[0]),
                 v_scale=jnp.asarray(scales[1])))


def _within_an_ulp(ours, ref):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=ULP_RTOL, atol=ULP_ATOL)


# ------------------------------------------------ the plain fp16 kernels

@pytest.mark.parametrize("kind", ["fp16", "int8", "fp8"])
@pytest.mark.parametrize("n_rep,T", [(1, 8), (4, 2), (1, 16), (4, 8)],
                         ids=["decode-mha", "decode-gqa", "span-mha",
                              "span-gqa"])
def test_plain_f16_k1_matches_the_pallas_kernel(kind, n_rep, T):
    """Both forms' shapes (G = n_rep * T at the decode threshold and above
    it) over the three pools an fp16 runner serves from: fp16 q and an
    fp16 output, chunks at offsets across page boundaries, a decode row
    and a dead slot."""
    rng = np.random.default_rng(n_rep * 10 + T)
    B, n_kv, d, ps, pages = 3, 2, 16, 8, 6
    nb = 1 + B * pages
    k, v, jk, jv, sc, jsc = _pools(rng, kind, nb, ps, n_kv, d)
    q = _f16_exact(rng.standard_normal((B, T, n_kv * n_rep, d)))
    tbl = rng.permutation(np.arange(1, nb)).reshape(B, pages).astype(
        np.int32)
    starts, qlens = [13, 30, 0], [T, 1, 0]
    assert k1.ragged_form(n_rep, T) == ("decode" if n_rep * T <= 8
                                        else "span")
    counts = k1.counts_for(torch.float16, POOL[kind])
    counts.reset()
    ours = k1.ragged_paged_attention(
        torch.from_numpy(q).half(), k, v, torch.from_numpy(tbl),
        torch.tensor(starts, dtype=torch.int32),
        torch.tensor(qlens, dtype=torch.int32), **sc)
    assert ours.dtype == torch.float16
    assert (counts.plain_launches, counts.kernel_launches) == (1, 0)
    ref = jax_k1.ragged_paged_attention(
        jnp.asarray(q, jnp.float16), jk, jv, jnp.asarray(tbl),
        jnp.asarray(starts, jnp.int32), jnp.asarray(qlens, jnp.int32),
        interpret=True, **jsc)
    assert str(ref.dtype) == "float16"
    _within_an_ulp(ours, ref)
    for b, n in enumerate(qlens):
        assert bool((ours[b, n:] == 0).all()), f"sequence {b}: rows >= {n}"


@pytest.mark.parametrize("ps", [1, 8])
@pytest.mark.parametrize("d", [8, 16, 64])
def test_plain_f16_k2_matches_the_pallas_kernel(ps, d):
    """One-token MHA decode on fp16 q and pools: positions on and off page
    boundaries, an fp16 output; the split twin (16-key splits) too."""
    rng = np.random.default_rng(ps * 100 + d)
    b, h, pages = 4, 3, 40 // ps + 1
    nb = 1 + b * pages
    k, v, jk, jv, _, _ = _pools(rng, "fp16", nb, ps, h, d)
    q = _f16_exact(rng.standard_normal((b, h, d)))
    tbl = rng.permutation(np.arange(1, nb)).reshape(b, pages).astype(
        np.int32)
    pos = np.asarray([0, ps - 1, 17, 39], np.int32)
    k2.COUNTS_F16.reset()
    ours = k2.paged_decode_attention(torch.from_numpy(q).half(), k, v,
                                     torch.from_numpy(tbl),
                                     torch.from_numpy(pos))
    assert ours.dtype == torch.float16
    assert k2.COUNTS_F16.plain_launches == 1
    ref = jax_k2.paged_decode_attention(jnp.asarray(q, jnp.float16), jk, jv,
                                        jnp.asarray(tbl), jnp.asarray(pos),
                                        interpret=True)
    assert str(ref.dtype) == "float16"
    _within_an_ulp(ours, ref)
    split = k2.paged_decode_split_reference(
        torch.from_numpy(q).half(), k, v, torch.from_numpy(tbl),
        torch.from_numpy(pos), keys_per_split=16)
    _within_an_ulp(split, ref)


# ------------------------------------------------------- KV write paths

def _rows(rng, B, T, n_kv, d, scale=1.0):
    return (rng.standard_normal((B, T, n_kv, d)) * scale).astype(np.float16)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantized_page_write_of_fp16_rows_equals_jax(scale):
    """fp16 K/V rows into an int8 pool over three steps (a page restarted
    at slot 0, scales growing): the abs-max at fp16 and the codes at fp32,
    bit-equal to JAX's codes and scales."""
    rng = np.random.default_rng(int(scale * 10))
    nb, ps, n_kv, d = 6, 4, 2, 8
    codes = np.zeros((nb, ps, n_kv, d), np.int8)
    scales = np.zeros((nb, n_kv), np.float32)
    pc, psc = torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy())
    jc, jsc = jnp.asarray(codes), jnp.asarray(scales)
    for step, (pages, offs) in enumerate((([[1, 1, 2]], [[0, 1, 0]]),
                                          ([[1, 2, 3]], [[2, 1, 0]]),
                                          ([[1, 1, 1]], [[3, 3, 0]]))):
        x = _rows(rng, 1, 3, n_kv, d, scale * (1 + step))
        wp, wo = np.asarray(pages, np.int32), np.asarray(offs, np.int32)
        kv_cache.quantized_page_write(pc, psc, torch.from_numpy(wp),
                                      torch.from_numpy(wo),
                                      torch.from_numpy(x))
        jc, jsc = jax_kv.quantized_page_write(jc, jsc, jnp.asarray(wp),
                                              jnp.asarray(wo),
                                              jnp.asarray(x))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(psc.numpy(), np.asarray(jsc))


def test_fp8_round_and_page_write_of_fp16_rows_equal_jax():
    """fp16 values (overflow past 464 and inf included) through fp8_round
    (the mixed pool's fp8 tenants) and fp8_page_write, bit-equal to the
    JAX casts from fp16."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 3, 2, 8)) * 200).astype(np.float16)
    x[0, 0, 0, :4] = [463.0, 465.0, np.inf, -np.inf]
    ours = kv_cache.fp8_round(torch.from_numpy(x))
    ref = np.asarray(jax_kv.fp8_round(jnp.asarray(x)))
    assert ours.dtype == torch.float16 and ref.dtype == np.float16
    np.testing.assert_array_equal(ours.numpy().view(np.uint16),
                                  ref.view(np.uint16))
    pool = torch.zeros((4, 4, 2, 8), dtype=torch.float8_e4m3fn)
    jpool = jnp.zeros((4, 4, 2, 8), jnp.float8_e4m3fn)
    wp = np.asarray([[1, 1, 2], [3, 3, 3]], np.int32)
    wo = np.asarray([[0, 1, 0], [1, 2, 3]], np.int32)
    kv_cache.fp8_page_write(pool, torch.from_numpy(wp), torch.from_numpy(wo),
                            torch.from_numpy(x))
    jpool = jax_kv.fp8_page_write(jpool, jnp.asarray(wp), jnp.asarray(wo),
                                  jnp.asarray(x))
    np.testing.assert_array_equal(pool.view(torch.uint8).numpy(),
                                  np.asarray(jpool.view(jnp.uint8)))


# ------------------------------------------------------------ runners

def _llama_pair(n_kv):
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(num_kv_heads=n_kv, **LLAMA))
    jm.eval()
    pm = Llama(LlamaConfig(num_kv_heads=n_kv, **LLAMA), device="cpu", seed=1)
    load_params(pm, {k: np.asarray(v) for k, v in
                     functionalize(jm).param_values().items()})
    return jm, pm


def _gpt_pair():
    paddle.seed(1)
    jm = JaxGPT(JaxGPTConfig(**GPT_SIZES))
    jm.eval()
    pm = GPT(GPTConfig(**GPT_SIZES), device="cpu")
    load_params(pm, {k: np.asarray(v) for k, v in
                     functionalize(jm).param_values().items()})
    return jm, pm


@pytest.fixture(scope="module")
def pairs():
    return {"gqa": _llama_pair(2), "mha": _llama_pair(4),
            "gpt": _gpt_pair()}


def _teacher_forced(jr, pr, steps=12):
    """Prefill one prompt and decode the JAX runner's greedy stream through
    both runners; yields (JAX logits, port logits) per step as fp32."""
    pools, tables = [], []
    for r, cls, kw in ((jr, JaxKVCachePool, {}),
                       (pr, KVCachePool, dict(device="cpu"))):
        pool = cls(r.num_layers, 13, 8, r.n_kv_heads, r.head_dim, r.dtype,
                   kv_dtype=r.kv_dtype, **kw)
        tables.append(pool.pad_table(pool.allocator.alloc(12), 12))
        pools.append(pool.shards if r is pr else pool.pools)
    p = list(map(int, np.random.default_rng(5).integers(1, jr.vocab_size,
                                                        20)))
    lj, pools[0] = jr.prefill(p, tables[0], pools[0])
    lp, pools[1] = pr.prefill(p, tables[1], pools[1])
    toks = list(p)
    for _ in range(steps):
        a = np.asarray(lj.astype(jnp.float32))
        yield a, lp.float().numpy()
        tok = int(np.argmax(a))
        pos = np.asarray([len(toks)], np.int32)
        toks.append(tok)
        lj, pools[0] = jr.decode(np.asarray([tok], np.int32),
                                 np.asarray(tables[0], np.int32)[None], pos,
                                 pools[0])
        lp, pools[1] = pr.decode(np.asarray([tok], np.int32),
                                 np.asarray(tables[1], np.int32)[None], pos,
                                 pools[1])
        lj, lp = lj[0], lp[0]


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("model", ["gqa", "mha", "gpt"])
def test_f16_runner_logits_match_the_jax_f16_runner(pairs, model, kv_dtype):
    """dtype=float16 through both bridges: fp16 params (codes stay), fp16
    pools on the "fp32" rung, the same dispatch (the JAX runner's kernels
    in interpret mode, the port's plain versions); teacher-forced logits
    finite and within LOGIT_TOL of max|logit|, greedy tokens equal where
    JAX's top-2 margin exceeds twice that."""
    jm, pm = pairs[model]
    kw = dict(block_size=8, max_model_len=96, num_blocks=16,
              attn_impl="pallas", kv_dtype=kv_dtype)
    jr = jax_create_serving_engine(jm, dtype=jnp.float16, **kw).runner
    pr = create_serving_engine(pm, dtype="float16", device="cpu",
                               **kw).runner
    assert pr.dtype == torch.float16 and str(jr.dtype) == "float16"
    for a, b in _teacher_forced(jr, pr):
        assert np.isfinite(b).all()
        scale = np.abs(a).max()
        assert np.abs(a - b).max() <= LOGIT_TOL * scale
        top2 = np.sort(a)[-2:]
        if top2[1] - top2[0] > 2 * LOGIT_TOL * scale:
            assert int(np.argmax(a)) == int(np.argmax(b))


@pytest.mark.parametrize("weight_dtype", ["int8", "int4", "fp8"])
@pytest.mark.parametrize("model", ["gqa", "gpt"])
def test_f16_ladder_runner_logits_match_the_jax_f16_runner(pairs, model,
                                                           weight_dtype):
    """The weight ladder under dtype=float16: `_mm` on fp16 activations
    with int8 codes and fp16 scales, int4 nibbles and fp16 group scales
    (`int4_matmul`), fp8 weights cast back to fp16; teacher-forced logits
    finite and within LOGIT_TOL of the JAX fp16 runner's."""
    jm, pm = pairs[model]
    kw = dict(block_size=8, max_model_len=96, num_blocks=16,
              attn_impl="pallas", weight_dtype=weight_dtype,
              weight_group_size=GROUP)
    jr = jax_create_serving_engine(jm, dtype=jnp.float16, **kw).runner
    pr = create_serving_engine(pm, dtype="float16", device="cpu",
                               **kw).runner
    for a, b in _teacher_forced(jr, pr, steps=6):
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() <= LOGIT_TOL * np.abs(a).max()


@pytest.mark.parametrize("model", ["gqa", "mha", "gpt"])
def test_f16_runner_stays_near_its_fp32_twin(pairs, model):
    """The same weights at fp32 and cast to fp16: logits within TWIN_TOL
    of max|logit| along the fp32 greedy stream."""
    _, pm = pairs[model]
    kw = dict(block_size=8, max_model_len=96, num_blocks=16, device="cpu")
    r32 = create_serving_engine(pm, **kw).runner
    r16 = create_serving_engine(pm, dtype=torch.float16, **kw).runner
    p = list(range(3, 23))
    pools = [KVCachePool(2, 13, 8, r.n_kv_heads, r.head_dim, r.dtype,
                         device="cpu").shards for r in (r32, r16)]
    assert pools[1][0][0][0].dtype == torch.float16
    table = list(range(1, 13))
    l32, _ = r32.prefill(p, table, pools[0])
    l16, _ = r16.prefill(p, table, pools[1])
    for step in range(8):
        a, b = l32.numpy(), l16.float().numpy()
        assert np.abs(a - b).max() <= TWIN_TOL * np.abs(a).max(), step
        tok = int(np.argmax(a))
        pos = np.asarray([len(p) + step], np.int32)
        l32 = r32.decode(np.asarray([tok], np.int32),
                         np.asarray(table, np.int32)[None], pos,
                         pools[0])[0][0]
        l16 = r16.decode(np.asarray([tok], np.int32),
                         np.asarray(table, np.int32)[None], pos,
                         pools[1])[0][0]


# ------------------------------------------------------------ engines

def _prompts(vocab, n=3, seed=3):
    r = np.random.default_rng(seed)
    return [list(map(int, r.integers(1, vocab - 10, int(r.integers(5, 30)))))
            for _ in range(n)]


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8", "mixed"])
@pytest.mark.parametrize("model", ["gqa", "mha", "gpt"])
def test_f16_engine_is_token_exact_against_naive_generate(pairs, model,
                                                          kv_dtype):
    """A batched fp16 engine (chunked prefill, decode horizons of 4) gives
    its own naive_generate's tokens, through the fp16 variants' plain
    versions only; on a mixed pool the second tenant is fp8."""
    _, pm = pairs[model]
    eng = create_serving_engine(pm, dtype=torch.float16, device="cpu",
                                block_size=8, max_model_len=96,
                                num_blocks=48, max_batch_size=3,
                                max_prefill_tokens_per_step=16,
                                decode_horizon=4, kv_dtype=kv_dtype)
    assert eng.runner.dtype == torch.float16
    pool_dtype = {"int8": torch.int8,
                  "fp8": torch.float8_e4m3fn}.get(kv_dtype, torch.float16)
    assert eng.pool.pools[0][0].dtype == pool_dtype
    variants = [k1.counts_for(torch.float16, pool_dtype)]
    if pool_dtype == torch.float16:
        variants.append(k2.COUNTS_F16)
    others = (k1.COUNTS, k1.COUNTS_I8, k1.COUNTS_F8, k2.COUNTS,
              k1.COUNTS_BF16, k1.COUNTS_BF16_I8, k1.COUNTS_BF16_F8,
              k2.COUNTS_BF16)
    for c in (*variants, *others):
        c.reset()
    prompts = _prompts(80)
    sps = [SamplingParams(max_tokens=9, kv_dtype="fp8"
                          if kv_dtype == "mixed" and i == 1 else None)
           for i in range(3)]
    ids = [eng.add_request(p, sp) for p, sp in zip(prompts, sps)]
    outs = eng.run()
    assert sum(c.plain_launches for c in variants) > 0
    assert all(c.plain_launches == 0 for c in others)
    assert eng.metrics.nan_logit_events.value == 0
    for rid, p, sp in zip(ids, prompts, sps):
        assert outs[rid].output_tokens == naive_generate(eng.runner, p, sp)
    assert eng.pool.allocator.check_no_leaks()


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("model", ["gqa", "mha", "gpt"])
def test_f16_engine_tokens_equal_the_jax_f16_engine(pairs, model, kv_dtype):
    """The same fp16-cast weights, prompts and knobs through both
    create_serving_engine(dtype=float16): the greedy tokens equal."""
    jm, pm = pairs[model]
    kw = dict(block_size=8, max_model_len=96, num_blocks=32,
              max_batch_size=3, max_prefill_tokens_per_step=16,
              kv_dtype=kv_dtype)
    peng = create_serving_engine(pm, dtype="float16", device="cpu", **kw)
    jeng = jax_create_serving_engine(jm, dtype=jnp.float16, **kw)
    prompts = _prompts(80, seed=7)
    pids = [peng.add_request(p, SamplingParams(max_tokens=6))
            for p in prompts]
    jids = [jeng.add_request(p, JaxSamplingParams(max_tokens=6))
            for p in prompts]
    pouts, jouts = peng.run(), jeng.run()
    assert [pouts[i].output_tokens for i in pids] == \
        [jouts[i].output_tokens for i in jids]


# ------------------------------------------- the weight ladder at fp16

@pytest.mark.parametrize("weight_dtype", ["fp32", "int8", "int4", "fp8"])
def test_f16_cast_touches_the_ladder_as_jax_does(pairs, weight_dtype):
    """create_serving_engine(dtype=float16) casts every floating param
    after the runner is built, the ladder's own included: fp8 weights come
    back fp16, int8 / int4 scales become fp16, codes stay int8; every
    param, the runner's dtype, its pools and its reduction factors equal
    JAX's."""
    jm, pm = pairs["gqa"]
    kw = dict(block_size=8, max_model_len=96, num_blocks=16,
              weight_dtype=weight_dtype, weight_group_size=GROUP)
    jeng = jax_create_serving_engine(jm, dtype=jnp.float16, **kw)
    peng = create_serving_engine(pm, dtype=torch.float16, device="cpu",
                                 audit=False, **kw)
    assert peng.runner.dtype == torch.float16
    assert peng.pool.pools[0][0].dtype == torch.float16
    assert str(jeng.pool.pools[0][0].dtype) == "float16"
    assert set(peng.runner.params) == set(jeng.runner.params)
    for name, v in peng.runner.params.items():
        jv = jeng.runner.params[name]
        assert str(v.dtype).split(".")[-1] == str(jv.dtype), name
        np.testing.assert_array_equal(_np(v), _np(jv), name)
    assert peng.runner.weight_bytes_reduction_x() == pytest.approx(
        jeng.runner.weight_bytes_reduction_x(), rel=1e-12)
    if weight_dtype in ("fp32", "fp8"):
        assert peng.runner.weight_bytes_reduction_x() == 2.0
    assert all(p.dtype == torch.float32 for p in pm.parameters())


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("weight_dtype", ["int8", "int4", "fp8"])
def test_the_auditor_refuses_the_cast_ladder_as_jax_does(pairs, dtype,
                                                         weight_dtype):
    """A reference quirk the port keeps: the auditor wants fp32 scales and
    float8 weights, and dtype= has cast them to the 16-bit dtype, so an
    audited engine on the cast ladder raises on its first step in both
    packages, naming the same tensors."""
    from paddle_tpu.serving.resilience import InvariantViolation as JaxIV
    from paddle_tpu_torch.serving import InvariantViolation
    jm, pm = pairs["gqa"]
    kw = dict(block_size=8, max_model_len=96, num_blocks=16, audit=True,
              weight_dtype=weight_dtype, weight_group_size=GROUP)
    flagged = []
    for eng, err, sp in (
            (jax_create_serving_engine(jm, dtype=getattr(jnp, dtype), **kw),
             JaxIV, JaxSamplingParams(max_tokens=2)),
            (create_serving_engine(pm, dtype=dtype, device="cpu", **kw),
             InvariantViolation, SamplingParams(max_tokens=2))):
        eng.add_request([1, 2, 3], sp)
        with pytest.raises(err) as info:
            eng.run()
        flagged.append(sorted(p.split()[0] for p in
                              str(info.value).split("; ")))
    assert flagged[0] == flagged[1] and len(flagged[0]) == 15


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_shadow_of_a_16_bit_target_quantizes_as_jax_does(pairs, dtype):
    """The JAX shadow quantizes the weights whose numpy dtype is a numpy
    floating type: float16 is one, so an fp16 target's shadow goes down
    the ladder to the same codes and scales; bfloat16 (ml_dtypes) is not,
    so a bf16 target's shadow keeps its weights, here as there."""
    jm, pm = pairs["gqa"]
    kw = dict(block_size=8, max_model_len=96, num_blocks=16)
    jeng = jax_create_serving_engine(jm, dtype=getattr(jnp, dtype), **kw)
    peng = create_serving_engine(pm, dtype=dtype, device="cpu", **kw)
    js = jax_shadow_runner(jeng.runner, "int8")
    ps_ = shadow_runner(peng.runner, "int8")
    assert ps_._quantized_names == js._quantized_names
    assert ps_.weight_dtype == js.weight_dtype == "int8"
    assert bool(ps_._quantized_names) == (dtype == "float16")
    for key in js.params:
        assert str(ps_.params[key].dtype).split(".")[-1] == \
            str(js.params[key].dtype), key
        np.testing.assert_array_equal(_np(ps_.params[key]),
                                      _np(js.params[key]), key)


def test_f16_shadow_draft_keeps_the_target_stream(pairs):
    """An fp16 target with its int8 shadow draft ("shadow") proposes and
    verifies: token-exact against the target's naive_generate, drafts
    accepted."""
    _, pm = pairs["gqa"]
    eng = create_serving_engine(pm, dtype="float16", device="cpu",
                                block_size=8, max_model_len=96,
                                num_blocks=64, max_batch_size=3,
                                num_speculative_tokens=3,
                                spec_draft_model="shadow")
    assert eng.proposer.runner._quantized_names
    prompts = _prompts(80, seed=11)
    ids = [eng.add_request(p, SamplingParams(max_tokens=8)) for p in prompts]
    outs = eng.run()
    for rid, p in zip(ids, prompts):
        assert outs[rid].output_tokens == naive_generate(
            eng.runner, p, SamplingParams(max_tokens=8))
    assert eng.metrics.spec_accepted_tokens.value > 0
    assert eng.proposer.pool.allocator.check_no_leaks()


# ------------------------------------------------- the paged generator

@pytest.mark.parametrize("num_beams", [1, 3])
def test_paged_generator_at_f16_gives_jax_tokens(num_beams):
    """PagedGPTGenerator over a GPT cast to fp16 (pools in wte's dtype, K2
    at fp16 through block_multihead_attention) gives the JAX generator's
    tokens on the same fp16 weights."""
    paddle.seed(2)
    sizes = dict(GPT_SIZES, hidden_size=64, num_heads=4)
    jm = JaxGPT(JaxGPTConfig(**sizes))
    jm.eval()
    pm = GPT(GPTConfig(**sizes), device="cpu")
    load_params(pm, {k: np.asarray(v) for k, v in
                     functionalize(jm).param_values().items()})
    jm.to(dtype="float16")
    pm.to(torch.float16)
    ids = np.random.default_rng(3).integers(0, 89, (3, 9))
    kw = dict(max_new_tokens=8, temperature=0.0, num_beams=num_beams)
    ref = np.asarray(jgen.PagedGPTGenerator(jm, block_size=16).generate(
        paddle.to_tensor(ids), **kw)._value)
    k2.COUNTS_F16.reset()
    got = gen.PagedGPTGenerator(pm, block_size=16).generate(
        torch.from_numpy(ids), **kw)
    assert k2.COUNTS_F16.plain_launches == sizes["num_layers"] * 7
    np.testing.assert_array_equal(got.numpy(), ref)
