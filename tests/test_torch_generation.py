"""The port's GPT generators against the JAX package's, on the CPU.

A small GPT (vocab 89, hidden 64, 2 layers, 4 heads of 16, 64 positions)
is built in JAX and its weights cross to the port as numpy. Then:

  * `GPTGenerator` and `PagedGPTGenerator` against the JAX generators on
    the same weights and prompts, token for token: greedy, sampled with a
    seed, top-k, top-p, both, beam search (with a length penalty), and the
    eos contract (greedy and beams: rows that finished keep emitting eos);
    the JAX paged generator runs its paged-decode kernel in interpret mode
    (the JAX package's own choice on the CPU); a draw with no seed takes
    the default generator's next key in both packages;
  * the port's paged generator equal to its dense one (greedy and beams),
    a block size that does not divide max_len (the largest divisor below
    it), its K2 launches (one per layer per decode step, plain here), the
    gather path asked for (attn_impl="reference") equal to K2's;
  * `block_multihead_attention` against the JAX one (Pallas K2 in interpret
    mode) at a scalar and a per-sequence pos, and prefill over the gather
    path, within 1e-5; its dense reference as
    tests/test_parallel_generation.py pins it;
  * `_sample_shared_key` bit-equal to jax.random.categorical with one key
    over a [b, V] batch (the rows draw different noise), and the
    `core.random.Generator` equal to the JAX one (keys, state round trip);
  * what raises: a mesh, sharded pools, a switch-MoE block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.models.generation as jgen
from paddle_tpu.core import random as jrandom
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.models import GPT, GPTConfig
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.ops import paged_attention as k2
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

SIZES = dict(vocab_size=89, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=64)
NEW = 10


@pytest.fixture(scope="module")
def models():
    paddle.seed(31)
    jm = JaxGPT(JaxGPTConfig(**SIZES))
    jm.eval()
    params = {k: np.asarray(v)
              for k, v in functionalize(jm).param_values().items()}
    model = GPT(GPTConfig(**SIZES), device="cpu")
    load_params(model, params)
    prompts = np.random.default_rng(3).integers(0, 89, (3, 9))
    greedy = np.asarray(jgen.GPTGenerator(jm).generate(
        paddle.to_tensor(prompts), max_new_tokens=NEW,
        temperature=0.0)._value)
    # an eos that row 0 emits early, so the padding contract is exercised
    eos = int(greedy[0, prompts.shape[1] + 2])
    return dict(jax=jm, port=model, prompts=prompts, eos=eos)


CASES = {
    "greedy": dict(temperature=0.0),
    "sampled": dict(temperature=0.8, seed=3),
    "top_k": dict(temperature=1.0, top_k=5, seed=4),
    "top_p": dict(temperature=0.9, top_p=0.8, seed=5),
    "top_k_p": dict(temperature=1.3, top_k=12, top_p=0.7, seed=6),
    "beams": dict(num_beams=3, length_penalty=0.6),
    "eos": dict(temperature=0.0, eos=True),
    "eos_beams": dict(num_beams=3, eos=True),
}
KINDS = {"dense": (jgen.GPTGenerator, gen.GPTGenerator),
         "paged": (jgen.PagedGPTGenerator, gen.PagedGPTGenerator)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_generators_match_jax(models, kind, case):
    kw = dict(CASES[case])
    if kw.pop("eos", False):
        kw["eos_token_id"] = models["eos"]
    jax_cls, port_cls = KINDS[kind]
    ids = models["prompts"]
    ref = np.asarray(jax_cls(models["jax"]).generate(
        paddle.to_tensor(ids), max_new_tokens=NEW, **kw)._value)
    got = port_cls(models["port"]).generate(torch.from_numpy(ids),
                                            max_new_tokens=NEW, **kw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    if "eos_token_id" in kw:
        # after a row's first eos only eos (greedy row 0 emits one)
        for row in got.numpy()[:, ids.shape[1]:]:
            hits = np.nonzero(row == models["eos"])[0]
            if hits.size:
                assert (row[hits[0]:] == models["eos"]).all()
        assert case != "eos" or models["eos"] in got.numpy()[0, 9:]


def test_unseeded_draw_takes_the_default_generators_next_key(models):
    paddle.seed(11)
    prandom.seed(11)
    ids = models["prompts"][:2]
    ref = np.asarray(jgen.GPTGenerator(models["jax"]).generate(
        paddle.to_tensor(ids), max_new_tokens=6, temperature=1.0)._value)
    got = gen.GPTGenerator(models["port"]).generate(
        torch.from_numpy(ids), max_new_tokens=6, temperature=1.0)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert prandom.default_generator.offset == 1


@pytest.mark.parametrize("num_beams", [1, 3])
def test_paged_equals_dense(models, num_beams):
    ids = torch.from_numpy(models["prompts"])
    kw = dict(max_new_tokens=NEW, temperature=0.0, num_beams=num_beams)
    dense = gen.GPTGenerator(models["port"]).generate(ids, **kw)
    paged_gen = gen.PagedGPTGenerator(models["port"], block_size=16)
    k2.COUNTS.reset()
    paged = paged_gen.generate(ids, **kw)
    np.testing.assert_array_equal(paged.numpy(), dense.numpy())
    # K2 once per layer on every decode step (plain on the CPU)
    assert k2.COUNTS.plain_launches == SIZES["num_layers"] * (NEW - 1)
    assert k2.COUNTS.kernel_launches == 0
    ref = gen.PagedGPTGenerator(models["port"], block_size=16,
                                attn_impl="reference")
    k2.COUNTS.reset()
    np.testing.assert_array_equal(ref.generate(ids, **kw).numpy(),
                                  dense.numpy())
    assert k2.COUNTS.plain_launches == 0


def test_paged_block_size_non_divisible():
    paddle.seed(0)
    model = GPT(GPTConfig(**dict(SIZES, max_seq_len=48)), device="cpu")
    g = gen.PagedGPTGenerator(model, block_size=20)
    assert g.block_size == 16 and 48 % g.block_size == 0
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 89, (1, 6)))
    out = g.generate(ids, max_new_tokens=4, temperature=0.0)
    assert tuple(out.shape) == (1, 10)
    np.testing.assert_array_equal(out.numpy(), gen.GPTGenerator(
        model).generate(ids, max_new_tokens=4, temperature=0.0).numpy())


def _paged_operands(seed=0, b=3, L=32, h=2, d=16, bs=8, t=6):
    """A PagedKVCache of one layer holding t prefilled positions, in both
    packages, and the query of the next token."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(2))
    ours = gen.PagedKVCache(b, L, h, d, 1, torch.float32, block_size=bs,
                            device="cpu")
    ref = jgen.PagedKVCache(b, L, h, d, 1, jnp.float32, block_size=bs)
    kp = gen.paged_write_prefill(ours.pools[0][0], ours.block_table,
                                 torch.from_numpy(k), bs)
    vp = gen.paged_write_prefill(ours.pools[0][1], ours.block_table,
                                 torch.from_numpy(v), bs)
    jkp = jgen.paged_write_prefill(ref.pools[0][0], ref.block_table,
                                   jnp.asarray(k), bs)
    jvp = jgen.paged_write_prefill(ref.pools[0][1], ref.block_table,
                                   jnp.asarray(v), bs)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    return q, k, v, (kp, vp, ours.block_table), (jkp, jvp, ref.block_table)


@pytest.mark.parametrize("pos_kind", ["int", "0-d", "per-sequence"])
def test_block_multihead_attention_matches_jax(pos_kind):
    q, k, v, ours, ref = _paged_operands()
    b, _, h, d = q.shape
    # write the decode token at pos in both caches first
    tok = np.random.default_rng(1).standard_normal((b, h, d)).astype(
        np.float32)
    pos = {"int": 6, "0-d": torch.tensor(6),
           "per-sequence": torch.tensor([6, 3, 5], dtype=torch.int32)}[
               pos_kind]
    jpos = jnp.asarray(np.asarray(pos), jnp.int32)
    kp = gen.paged_write_token(ours[0], ours[2], torch.from_numpy(tok), pos,
                               8)
    jkp = jgen.paged_write_token(ref[0], ref[2], jnp.asarray(tok), jpos, 8)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    k2.COUNTS.reset()
    got = gen.block_multihead_attention(torch.from_numpy(q), kp, ours[1],
                                        ours[2], pos)
    assert k2.COUNTS.plain_launches == 1
    want = jgen.block_multihead_attention(jnp.asarray(q), jkp, ref[1],
                                          ref[2], jpos)
    assert tuple(got.shape) == (b, 1, h * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_block_multihead_attention_prefill_and_dense_reference():
    """t > 1 takes the gather path (as JAX); t == 1 at pos 4 over 5
    written positions equals dense attention over them
    (tests/test_parallel_generation.py::
    test_block_multihead_attention_functional)."""
    q, k, v, ours, ref = _paged_operands(t=5)
    qs = np.random.default_rng(2).standard_normal((3, 5, 2, 16)).astype(
        np.float32)
    k2.COUNTS.reset()
    got = gen.block_multihead_attention(torch.from_numpy(qs), *ours, 0)
    want = jgen.block_multihead_attention(jnp.asarray(qs), *ref, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert k2.COUNTS.plain_launches == 0
    out = gen.block_multihead_attention(torch.from_numpy(q), *ours, 4)
    s = np.einsum("bthd,bLhd->bhtL", q, k) / np.sqrt(16)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    dense = np.einsum("bhtL,bLhd->bthd", p, v).reshape(3, 1, 32)
    np.testing.assert_allclose(out.numpy(), dense, atol=1e-5)


def test_shared_key_sampler_equals_jax_categorical():
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((5, 89))).astype(np.float32)
    for seed in (0, 7, 123):
        jkey = jax.random.key(seed)
        ref = np.asarray(jax.random.categorical(jkey, jnp.asarray(logits)))
        got = gen._sample_shared_key(torch.from_numpy(logits),
                                     prandom.key(seed), 1.0, None, None)
        np.testing.assert_array_equal(got.numpy(), ref)
        # through JAX's own _sample with top-k / top-p
        ref = np.asarray(jgen._sample(jnp.asarray(logits), jkey, 0.7, 9,
                                      0.8))
        got = gen._sample_shared_key(torch.from_numpy(logits),
                                     prandom.key(seed), 0.7, 9, 0.8)
        np.testing.assert_array_equal(got.numpy(), ref)
    # one key over the batch: equal rows draw different noise
    same = np.zeros((64, 89), np.float32)
    draws = gen._sample_shared_key(torch.from_numpy(same), prandom.key(1),
                                   1.0, None, None)
    assert len(set(draws.tolist())) > 1


def test_generator_matches_jax_generator():
    ours, ref = prandom.Generator(5), jrandom.Generator(5)
    for _ in range(3):
        np.testing.assert_array_equal(
            ours.next_key().numpy(),
            np.asarray(jax.random.key_data(ref.next_key())))
    state = ours.get_state()
    assert state["offset"] == 3 and state["seed"] == 5
    a = ours.next_key()
    other = prandom.Generator(0)
    other.set_state(state)
    assert torch.equal(other.next_key(), a)
    prandom.set_rng_state(state)
    assert torch.equal(prandom.get_rng_state()["key"], state["key"])


def test_unported_generation_options_raise(models):
    with pytest.raises(NotImplementedError, match="item 10"):
        gen.GPTGenerator(models["port"], mesh=object())
    with pytest.raises(NotImplementedError, match="item 10"):
        gen.PagedKVCache(1, 16, 2, 8, 1, torch.float32, block_size=8,
                         sharding=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        gen._mlp({"mlp.gate": torch.zeros(4, 2)}, torch.zeros(1, 1, 4))
