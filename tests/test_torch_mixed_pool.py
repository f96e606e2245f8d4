"""The port's "mixed" KV pool (per-request fp32 / fp8 tenants in one pool
geometry) against the JAX package's, on the CPU: the port's
counterparts of `tests/test_serving_qcomm.py`'s mixed-tenancy tests.

  * `paged_attend`'s mixed write path (rows on fp8-tagged pages through
    `fp8_round`, the others verbatim) leaves pools bit-equal to the JAX
    one's and attends within 1e-5;
  * the pool's layout, tags, page bytes and reduction factor equal the
    JAX pool's; a fork carries the page and is tagged for its owner;
  * each tenant of a mixed engine equals its twin engine token for token:
    an fp8 tenant the native fp8 engine, an fp32 tenant the fp32 engine,
    and both equal the JAX mixed engine; an MHA fp8 tenant's logits (K2's
    plain version on the mixed pool) within 1e-5 of the native fp8 pool's
    (K1-q's): two orders of summation over the same values;
  * fp8 tenants never hit the prefix pages of fp32 tenants;
  * the auditor catches a flipped device tag bit; the intake refuses a
    tenant rung the pool cannot serve.
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
from paddle_tpu.serving.model_runner import paged_attend as jax_paged_attend
from paddle_tpu_torch.models import Llama, LlamaConfig
from paddle_tpu_torch.serving import (
    InvariantViolation, KVCachePool, LlamaRunner, SamplingParams,
    ServingEngine, audit_engine, naive_generate,
)
from paddle_tpu_torch.serving.kv_cache import SequenceKV
from paddle_tpu_torch.serving.model_runner import paged_attend
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

ATOL = 1e-5
SIZES = dict(vocab_size=97, hidden_size=64, num_layers=2, max_seq_len=96,
             dropout=0.0)


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


def _pair(n_kv):
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(num_heads=4, num_kv_heads=n_kv, **SIZES))
    jm.eval()
    model = Llama(LlamaConfig(num_heads=4, num_kv_heads=n_kv, **SIZES),
                  device="cpu", seed=1)
    load_params(model, {k: np.asarray(v) for k, v in
                        functionalize(jm).param_values().items()})
    return jm, model


@pytest.fixture(scope="module")
def gqa():
    return _pair(2)


@pytest.fixture(scope="module")
def mha():
    return _pair(4)


@pytest.fixture(scope="module")
def prompts():
    r = np.random.default_rng(7)
    return [list(map(int, r.integers(1, 97, int(r.integers(6, 24)))))
            for _ in range(3)]


def _engine(runner, cls=ServingEngine, **kw):
    return cls(runner, num_blocks=64, max_batch_size=4, max_model_len=96,
               max_prefill_tokens_per_step=16, **kw)


def _serve(eng, prompts, kv_dtypes, sp_cls=SamplingParams):
    ids = [eng.add_request(p, sp_cls(max_tokens=8, kv_dtype=d))
           for p, d in zip(prompts, kv_dtypes)]
    outs = eng.run()
    return [outs[i].output_tokens for i in ids]


# ------------------------------------------------------- the write path

def test_mixed_write_path_equals_jax():
    """Rows landing on fp8-tagged pages hold fp8_round of their value (an
    overflowing row becomes NaN as ml_dtypes casts it), the others their
    value bit for bit, as the JAX mixed branch writes them; the gather
    path attends within 1e-5."""
    rng = np.random.default_rng(4)
    P, ps, n_kv, d = 6, 4, 2, 8
    pool = KVCachePool(1, P, ps, n_kv, d, device="cpu", kv_dtype="mixed")
    jpool = JaxKVCachePool(1, P, ps, n_kv, d, kv_dtype="mixed")
    for p_ in (pool, jpool):
        p_.tag_pages([2, 3], "fp8")
        p_.tag_pages([1, 4], "fp32")
    q = rng.standard_normal((2, 4, 2 * n_kv, d)).astype(np.float32)
    kv = [rng.standard_normal((2, 4, n_kv, d)).astype(np.float32) * 50
          for _ in range(2)]
    kv[0][1, 2, 0, 0] = 900.0                  # past fp8's range: NaN
    wp = np.asarray([[1, 1, 2, 2], [3, 3, 4, 0]], np.int32)
    wo = np.asarray([[0, 1, 0, 1], [2, 3, 0, 0]], np.int32)
    tables = np.asarray([[1, 2], [3, 4]], np.int32)
    pos = np.asarray([0, 2], np.int32)
    ql = np.asarray([4, 3], np.int32)
    t = torch.from_numpy
    out, layer = paged_attend(t(q), t(kv[0]), t(kv[1]), pool.pools[0],
                              t(tables), t(wp).long(), t(wo).long(), t(pos),
                              t(ql), 2, "reference")
    jout, jlayer = jax_paged_attend(
        jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
        jpool.pools[0], jnp.asarray(tables), jnp.asarray(wp),
        jnp.asarray(wo), jnp.asarray(pos), jnp.asarray(ql), 2, "reference")
    for ours, ref in zip(layer, jlayer):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    live = np.isfinite(np.asarray(jout))
    assert (np.isfinite(out.numpy()) == live).all()
    np.testing.assert_allclose(out.numpy()[live], np.asarray(jout)[live],
                               atol=ATOL, rtol=ATOL)


def test_mixed_pool_layout_tags_and_bytes_equal_jax():
    pool = KVCachePool(3, 8, 4, 2, 8, device="cpu", kv_dtype="mixed")
    jpool = JaxKVCachePool(3, 8, 4, 2, 8, kv_dtype="mixed")
    assert [[(tuple(a.shape), str(a.dtype).split(".")[-1]) for a in layer]
            for layer in pool.pools] == \
        [[(tuple(a.shape), str(a.dtype)) for a in layer]
         for layer in jpool.pools]
    assert pool.native_kv_tag() == jpool.native_kv_tag() == "fp32"
    assert pool.page_bytes() == jpool.page_bytes()
    assert pool.kv_bytes_reduction_x() == jpool.kv_bytes_reduction_x()
    seqs = [SequenceKV(p_, kv_tag="fp8") for p_ in (pool, jpool)]
    for s in seqs:
        s.grow(9)
    assert seqs[0].pages == seqs[1].pages == [1, 2, 3]
    for layer, jlayer in zip(pool.pools, jpool.pools):
        assert layer[2].tolist() == np.asarray(jlayer[2]).tolist()
    # a copy-on-write fork: the page's bytes and tag bit move, and the
    # fork is tagged for its owner
    pool.allocator.incref(2)
    fp32_seq = SequenceKV(pool, kv_tag="fp32")
    fp32_seq.pages, fp32_seq.num_tokens = [2], 4
    assert fp32_seq.ensure_writable(0, 4) == 1
    new = fp32_seq.pages[0]
    assert pool.page_tag(new) == "fp32" and pool.page_tag(2) == "fp8"
    assert not bool(pool.pools[0][2][new]) and bool(pool.pools[0][2][2])
    seqs[0].release()
    fp32_seq.release()
    assert pool.allocator.check_no_leaks() and not pool.allocator._tags


# ----------------------------------------------------------- engines

@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
def test_mixed_tenants_equal_their_twin_engines(gqa, prompts, prefix):
    """fp8 tenants equal the native fp8 engine, fp32 tenants (explicit or
    by default) the fp32 engine, token for token, and every tenant the
    JAX mixed engine; under the armed auditor's tag bijection."""
    jm, pm = gqa
    dtypes = ["fp8", "fp32", None]
    kw = dict(enable_prefix_cache=True) if prefix else {}
    eng = _engine(LlamaRunner(pm, 8, 96, kv_dtype="mixed", device="cpu"),
                  **kw)
    got = _serve(eng, prompts, dtypes)
    twins = {d: LlamaRunner(pm, 8, 96, kv_dtype=d, device="cpu")
             for d in ("fp8", "fp32")}
    for toks, p, d in zip(got, prompts, dtypes):
        assert toks == naive_generate(twins[d or "fp32"], p,
                                      SamplingParams(max_tokens=8)), d
        assert toks == naive_generate(eng.runner, p, SamplingParams(
            max_tokens=8, kv_dtype=d)), d
    jeng = _engine(JaxLlamaRunner(jm, block_size=8, max_model_len=96,
                                  kv_dtype="mixed"), JaxServingEngine, **kw)
    assert got == _serve(jeng, prompts, dtypes, JaxSamplingParams)
    audit_engine(eng)
    eng.release_prefix_cache()
    assert eng.pool.allocator.check_no_leaks()
    assert not eng.pool.allocator._tags


def test_mha_fp8_tenant_logits_equal_the_native_fp8_pool(mha, prompts):
    """On MHA a mixed pool's decode takes K2 (here its plain version) where
    a native fp8 pool takes K1-q: the same values summed in two orders,
    logits within 1e-5 a step."""
    _, pm = mha
    mixed = LlamaRunner(pm, 8, 96, kv_dtype="mixed", device="cpu")
    native = LlamaRunner(pm, 8, 96, kv_dtype="fp8", device="cpu")
    assert mixed._attn_impl_for(1) == "paged_decode"
    assert native._attn_impl_for(1) == "ragged"
    pools, tables = [], []
    for r in (mixed, native):
        pool = KVCachePool(2, 13, 8, 4, 16, device="cpu", kv_dtype=r.kv_dtype)
        pages = pool.allocator.alloc(12)
        pool.tag_pages(pages, "fp8")
        tables.append(pool.pad_table(pages, 12))
        pools.append(pool.shards)
    p = prompts[2]
    lm, _ = mixed.prefill(p, tables[0], pools[0])
    ln, _ = native.prefill(p, tables[1], pools[1])
    np.testing.assert_allclose(lm.numpy(), ln.numpy(), atol=ATOL, rtol=0)
    tok = int(torch.argmax(ln))
    for step in range(4):
        pos = np.asarray([len(p) + step], np.int32)
        outs = [r.decode(np.asarray([tok], np.int32),
                         np.asarray(t, np.int32)[None], pos, pl)[0][0]
                for r, t, pl in zip((mixed, native), tables, pools)]
        np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(),
                                   atol=ATOL, rtol=0)
        tok = int(torch.argmax(outs[1]))


def test_mixed_tenants_never_share_prefix_pages(gqa):
    """Equal tokens at two precisions are different KV bytes: the tag
    seeds the prefix chain, so an fp8 tenant never hits an fp32 tenant's
    pages (and a second fp32 tenant does)."""
    _, pm = gqa
    eng = ServingEngine(LlamaRunner(pm, 8, 96, kv_dtype="mixed",
                                    device="cpu"),
                        num_blocks=64, max_batch_size=2, max_model_len=96,
                        enable_prefix_cache=True)
    shared = list(range(1, 20))
    for d in ("fp32", "fp8"):
        eng.add_request(shared, SamplingParams(max_tokens=4, kv_dtype=d))
        eng.run()
    assert eng.metrics.prefix_hit_tokens.value == 0
    eng.add_request(shared, SamplingParams(max_tokens=4, kv_dtype="fp32"))
    eng.run()
    assert eng.metrics.prefix_hit_tokens.value == 16
    eng.release_prefix_cache()
    assert eng.pool.allocator.check_no_leaks()


def test_mixed_pool_tag_bijection_audited(gqa, prompts):
    """A flipped device tag bit of an owned page trips the auditor, as a
    host tag that disagrees with its owner's does."""
    _, pm = gqa
    eng = ServingEngine(LlamaRunner(pm, 8, 96, kv_dtype="mixed",
                                    device="cpu"),
                        num_blocks=64, max_batch_size=2, max_model_len=96,
                        audit=True)
    eng.add_request(prompts[0], SamplingParams(max_tokens=6, kv_dtype="fp8"))
    eng.step()
    page = eng.scheduler.running[0].kv.pages[0]
    for layer in eng.pool.pools:
        layer[2][page] = False
    with pytest.raises(InvariantViolation, match="tag"):
        audit_engine(eng)
    for layer in eng.pool.pools:
        layer[2][page] = True
    audit_engine(eng)
    eng.pool.allocator._tags[page] = "fp32"
    with pytest.raises(InvariantViolation, match="tag"):
        audit_engine(eng)


def test_kv_dtype_validation_loud(gqa):
    """A homogeneous pool serves only its own rung (naming the mixed pool
    as the way to several); a mixed pool serves fp32 and fp8 tenants and
    refuses int8 ones; SamplingParams refuses unknown rungs."""
    _, pm = gqa
    eng = ServingEngine(LlamaRunner(pm, 8, 96, device="cpu"), num_blocks=16,
                        max_batch_size=2, max_model_len=96)
    with pytest.raises(ValueError, match="mixed"):
        eng.add_request([1, 2, 3], SamplingParams(max_tokens=2,
                                                  kv_dtype="fp8"))
    eng8 = ServingEngine(LlamaRunner(pm, 8, 96, kv_dtype="fp8",
                                     device="cpu"),
                         num_blocks=16, max_batch_size=2, max_model_len=96)
    with pytest.raises(ValueError, match="not servable"):
        eng8.add_request([1, 2, 3], SamplingParams(max_tokens=2,
                                                   kv_dtype="fp32"))
    eng8.add_request([1, 2, 3], SamplingParams(max_tokens=2, kv_dtype="fp8"))
    mixed = ServingEngine(LlamaRunner(pm, 8, 96, kv_dtype="mixed",
                                      device="cpu"),
                          num_blocks=16, max_batch_size=2, max_model_len=96)
    for d in ("fp32", "fp8"):
        mixed.add_request([1, 2, 3], SamplingParams(max_tokens=2, kv_dtype=d))
    with pytest.raises(ValueError, match="not servable"):
        mixed.add_request([1, 2, 3], SamplingParams(max_tokens=2,
                                                    kv_dtype="int8"))
    with pytest.raises(ValueError, match="kv_dtype"):
        SamplingParams(max_tokens=2, kv_dtype="fp16")
    assert mixed.metrics.snapshot()["kv_bytes_reduction_x"] == \
        pytest.approx(mixed.pool.kv_bytes_reduction_x())
