"""The port's bf16 serving (`create_serving_engine(dtype=bfloat16)`)
against the JAX package's, on the CPU.

The same numpy inputs, rounded to bf16 once, go through both packages:

  * the plain bf16 K1 (its span and decode forms, over bf16, int8 and
    fp8 pools) and the plain bf16 K2 against the Pallas kernels in
    interpret mode on the same bf16 operands. Both widen each tile to
    fp32, sum in fp32 and round the output to bf16 once, in other orders:
    each output within one bf16 ulp (rtol 2^-7, atol 1e-6), rows past
    q_len exactly 0;
  * the bf16 runner's logits against the JAX bf16 runner's, teacher-
    forced as `tests/test_serving_weight_quant.py::_teacher_forced`
    forces the weight ladder: XLA and torch round bf16 matmuls, norms and
    residuals at other points, so the logits agree within 2^-5 of
    max|logit| (four bf16 ulps of the largest; measured about one), and
    the greedy tokens wherever JAX's top-2 margin exceeds twice that;
    over bf16, int8 and fp8 pools, GQA and MHA, Llama and GPT;
  * the bf16 engine (batched, chunked, with decode horizons) token-exact
    against the port's own naive_generate at bf16, through the bf16
    kernels' plain versions (their bf16 variants' counts);
  * the bf16 runner's logits within 2^-3 of max|logit| of its fp32
    twin's (bf16 weights and activations against fp32 ones: the chip
    smoke's 2-layer gate on the same rule).
"""

import importlib

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
from paddle_tpu.serving import KVCachePool as JaxKVCachePool
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.models import GPT, GPTConfig, Llama, LlamaConfig
from paddle_tpu_torch.ops import paged_attention as k2
from paddle_tpu_torch.ops import ragged_paged_attention as k1
from paddle_tpu_torch.serving import (
    KVCachePool, SamplingParams, naive_generate,
)
from paddle_tpu_torch.weights import load_params

jax_k1 = importlib.import_module(
    "paddle_tpu.ops.pallas.ragged_paged_attention")
jax_k2 = importlib.import_module("paddle_tpu.ops.pallas.paged_attention")

torch.set_num_threads(1)

ULP_RTOL, ULP_ATOL = 2.0 ** -7, 1e-6
LOGIT_TOL = 2.0 ** -5          # of max|logit|, against the JAX bf16 runner
TWIN_TOL = 2.0 ** -3           # of max|logit|, against the fp32 twin
LLAMA = dict(vocab_size=97, hidden_size=64, num_layers=2, max_seq_len=96,
             num_heads=4, dropout=0.0)
GPT_SIZES = dict(vocab_size=89, hidden_size=32, num_layers=2, num_heads=2,
                 max_seq_len=96, dropout=0.0)
POOL = {"bf16": torch.bfloat16, "int8": torch.int8,
        "fp8": torch.float8_e4m3fn}


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


def _bf16_exact(a):
    """fp32 values exactly representable in bf16 (rounded once)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16() \
        .float().numpy()


def _pools(rng, kind, nb, ps, n_kv, d):
    """(port k, port v, jax k, jax v, port scales, jax scales)."""
    k, v = (_bf16_exact(rng.standard_normal((nb, ps, n_kv, d)))
            for _ in range(2))
    if kind == "bf16":
        return (torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(),
                jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
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


# ------------------------------------------------ the plain bf16 kernels

@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("n_rep,T", [(1, 8), (4, 2), (1, 16), (4, 8)],
                         ids=["decode-mha", "decode-gqa", "span-mha",
                              "span-gqa"])
def test_plain_bf16_k1_matches_the_pallas_kernel(kind, n_rep, T):
    """Both forms' shapes (G = n_rep * T at the decode threshold and above
    it) over the three pools a bf16 runner serves from: bf16 q and a bf16
    output, chunks at offsets across page boundaries, a decode row and a
    dead slot."""
    rng = np.random.default_rng(n_rep * 10 + T)
    B, n_kv, d, ps, pages = 3, 2, 16, 8, 6
    nb = 1 + B * pages
    k, v, jk, jv, sc, jsc = _pools(rng, kind, nb, ps, n_kv, d)
    q = _bf16_exact(rng.standard_normal((B, T, n_kv * n_rep, d)))
    tbl = rng.permutation(np.arange(1, nb)).reshape(B, pages).astype(
        np.int32)
    starts, qlens = [13, 30, 0], [T, 1, 0]
    assert k1.ragged_form(n_rep, T) == ("decode" if n_rep * T <= 8
                                        else "span")
    counts = k1.counts_for(torch.bfloat16, POOL[kind])
    counts.reset()
    ours = k1.ragged_paged_attention(
        torch.from_numpy(q).bfloat16(), k, v, torch.from_numpy(tbl),
        torch.tensor(starts, dtype=torch.int32),
        torch.tensor(qlens, dtype=torch.int32), **sc)
    assert ours.dtype == torch.bfloat16
    assert (counts.plain_launches, counts.kernel_launches) == (1, 0)
    ref = jax_k1.ragged_paged_attention(
        jnp.asarray(q, jnp.bfloat16), jk, jv, jnp.asarray(tbl),
        jnp.asarray(starts, jnp.int32), jnp.asarray(qlens, jnp.int32),
        interpret=True, **jsc)
    assert str(ref.dtype) == "bfloat16"
    _within_an_ulp(ours, ref)
    for b, n in enumerate(qlens):
        assert bool((ours[b, n:] == 0).all()), f"sequence {b}: rows >= {n}"


@pytest.mark.parametrize("ps", [1, 8])
@pytest.mark.parametrize("d", [8, 16, 64])
def test_plain_bf16_k2_matches_the_pallas_kernel(ps, d):
    """One-token MHA decode on bf16 q and pools: positions on and off page
    boundaries, a bf16 output."""
    rng = np.random.default_rng(ps * 100 + d)
    b, h, pages = 4, 3, 40 // ps + 1
    nb = 1 + b * pages
    k, v, jk, jv, _, _ = _pools(rng, "bf16", nb, ps, h, d)
    q = _bf16_exact(rng.standard_normal((b, h, d)))
    tbl = rng.permutation(np.arange(1, nb)).reshape(b, pages).astype(
        np.int32)
    pos = np.asarray([0, ps - 1, 17, 39], np.int32)
    k2.COUNTS_BF16.reset()
    ours = k2.paged_decode_attention(torch.from_numpy(q).bfloat16(), k, v,
                                     torch.from_numpy(tbl),
                                     torch.from_numpy(pos))
    assert ours.dtype == torch.bfloat16
    assert k2.COUNTS_BF16.plain_launches == 1
    ref = jax_k2.paged_decode_attention(jnp.asarray(q, jnp.bfloat16), jk, jv,
                                        jnp.asarray(tbl), jnp.asarray(pos),
                                        interpret=True)
    _within_an_ulp(ours, ref)
    split = k2.paged_decode_split_reference(
        torch.from_numpy(q).bfloat16(), k, v, torch.from_numpy(tbl),
        torch.from_numpy(pos), keys_per_split=16)
    _within_an_ulp(split, ref)


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


def _engines(pair, dtype=torch.bfloat16, **kw):
    jm, pm = pair
    kw = dict(block_size=8, max_model_len=96, num_blocks=16, **kw)
    return (jax_create_serving_engine(jm, dtype=jnp.bfloat16, **kw),
            create_serving_engine(pm, dtype=dtype, device="cpu", **kw))


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
def test_bf16_runner_logits_match_the_jax_bf16_runner(pairs, model,
                                                      kv_dtype):
    """dtype=bfloat16 through both bridges: bf16 params (codes stay), bf16
    pools on the "fp32" rung, the same dispatch (the JAX runner's kernels
    in interpret mode, the port's plain versions); teacher-forced logits
    within LOGIT_TOL of max|logit|, greedy tokens equal where JAX's top-2
    margin exceeds twice that."""
    jeng, peng = _engines(pairs[model], attn_impl="pallas",
                          kv_dtype=kv_dtype)
    jr, pr = jeng.runner, peng.runner
    assert pr.dtype == torch.bfloat16 and str(jr.dtype) == "bfloat16"
    want = {"fp32": torch.bfloat16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}[kv_dtype]
    assert peng.pool.pools[0][0].dtype == want
    for a, b in _teacher_forced(jr, pr):
        scale = np.abs(a).max()
        assert np.abs(a - b).max() <= LOGIT_TOL * scale
        top2 = np.sort(a)[-2:]
        if top2[1] - top2[0] > 2 * LOGIT_TOL * scale:
            assert int(np.argmax(a)) == int(np.argmax(b))


@pytest.mark.parametrize("model", ["gqa", "mha", "gpt"])
def test_bf16_runner_stays_near_its_fp32_twin(pairs, model):
    """The same weights at fp32 and cast to bf16: logits within TWIN_TOL
    of max|logit| along the fp32 greedy stream."""
    _, pm = pairs[model]
    kw = dict(block_size=8, max_model_len=96, num_blocks=16, device="cpu")
    r32 = create_serving_engine(pm, **kw).runner
    r16 = create_serving_engine(pm, dtype="bfloat16", **kw).runner
    p = list(range(3, 23))
    pools = [KVCachePool(2, 13, 8, r.n_kv_heads, r.head_dim, r.dtype,
                         device="cpu").shards for r in (r32, r16)]
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

@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8", "mixed"])
@pytest.mark.parametrize("model", ["gqa", "mha", "gpt"])
def test_bf16_engine_is_token_exact_against_naive_generate(pairs, model,
                                                           kv_dtype):
    """A batched bf16 engine (chunked prefill, decode horizons of 4) gives
    its own naive_generate's tokens, through the bf16 variants' plain
    versions only; on a mixed pool the second tenant is fp8."""
    _, pm = pairs[model]
    eng = create_serving_engine(pm, dtype=torch.bfloat16, device="cpu",
                                block_size=8, max_model_len=96,
                                num_blocks=48, max_batch_size=3,
                                max_prefill_tokens_per_step=16,
                                decode_horizon=4, kv_dtype=kv_dtype)
    pool_dtype = {"int8": torch.int8,
                  "fp8": torch.float8_e4m3fn}.get(kv_dtype, torch.bfloat16)
    variants = [k1.counts_for(torch.bfloat16, pool_dtype)]
    if pool_dtype == torch.bfloat16:
        variants.append(k2.COUNTS_BF16)
    fp32 = (k1.COUNTS, k1.COUNTS_I8, k1.COUNTS_F8, k2.COUNTS)
    for c in (*variants, *fp32):
        c.reset()
    r = np.random.default_rng(3)
    prompts = [list(map(int, r.integers(1, 80, int(r.integers(5, 30)))))
               for _ in range(3)]
    sps = [SamplingParams(max_tokens=9, kv_dtype="fp8"
                          if kv_dtype == "mixed" and i == 1 else None)
           for i in range(3)]
    ids = [eng.add_request(p, sp) for p, sp in zip(prompts, sps)]
    outs = eng.run()
    assert sum(c.plain_launches for c in variants) > 0
    assert all(c.plain_launches == 0 for c in fp32)
    for rid, p, sp in zip(ids, prompts, sps):
        assert outs[rid].output_tokens == naive_generate(eng.runner, p, sp)
    assert eng.pool.allocator.check_no_leaks()
