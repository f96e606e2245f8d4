"""The port's quantized KV serving (int8 and fp8 pools, K1-q) against the
JAX package's, on the CPU.

The same numpy inputs go through the JAX functions and the port's:

  * `quantized_page_write` over a sequence of writes (decode appends,
    whole-page chunks, repeated page ids in one step, scale growth that
    requantizes resident codes, a slot-0 restart), one step at a time
    from the same pools: scales equal to rtol 1e-6, codes equal except
    +-1 where JAX's pre-round value lies within 1e-5 of a .5 tie (the two
    frameworks divide in another order). Page 0 (scratch) is left out:
    padded rows all write to its slot 0, so its content depends on the
    order of duplicate writes in both frameworks;
  * the same write applied twice in place leaves the pools bit-identical;
  * `fp8_round` / `fp8_page_write` bit-equal to ml_dtypes' cast,
    overflow to NaN included (torch's own cast saturates);
  * the plain K1-q against the Pallas kernel in interpret mode and its
    gather oracle at rtol = atol = 1e-5, over the int8 and fp8 sweeps of
    the JAX package's own tests;
  * runner step logits (atol 1e-4) and pools against the JAX
    `LlamaRunner(kv_dtype=...)`, dispatch, engines, byte accounting,
    gauges, the auditor's pool-layout invariant and the refusals.
"""

import importlib

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
from paddle_tpu.serving import kv_cache as jax_kvc
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.models import Llama, LlamaConfig
from paddle_tpu_torch.ops import ragged_paged_attention as k1
from paddle_tpu_torch.serving import (
    InvariantViolation, KVCachePool, LlamaRunner, SamplingParams,
    ServingEngine, audit_engine, naive_generate, runner_for,
)
from paddle_tpu_torch.serving import kv_cache as kvc
from paddle_tpu_torch.weights import load_params

jax_k1 = importlib.import_module(
    "paddle_tpu.ops.pallas.ragged_paged_attention")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# tiny shapes: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

ATOL = RTOL = 1e-5
LOGIT_ATOL = 1e-4
SIZES = dict(vocab_size=97, hidden_size=64, num_layers=2, max_seq_len=96)


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------- quantized_page_write


def _tie_ok(ours, ref, pre):
    """Codes equal, except +-1 where JAX's pre-round value lies within
    1e-5 of a .5 tie."""
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    tie = np.abs(np.abs(pre - np.trunc(pre)) - 0.5) < 1e-5
    bad = (diff > 1) | ((diff == 1) & ~tie)
    assert not bad.any(), f"{int(bad.sum())} codes differ off a .5 tie"


def _pre_round(codes, scales, new_scales, wp, wo, x):
    """JAX's values just before rounding: resident codes times the
    rescale ratio on touched pages, incoming rows over the new scale."""
    base = np.where(np.zeros_like(scales, bool), 0.0, scales)
    ratio = np.where(new_scales > 0, base / np.maximum(new_scales, 1e-30),
                     1.0).astype(np.float32)
    pre = codes.astype(np.float32) * ratio[:, None, :, None]
    s = new_scales[wp]                                       # [B, T, H]
    pre[wp, wo] = x / np.maximum(s, 1e-30)[..., None]
    return pre


def _write_steps(rng, H=2, d=8):
    """(write_page, write_off, x) of each step; ps = 4, pages 1..5."""
    steps = []
    for t in range(4):            # decode appends into page 2, growing
        steps.append(([[2]], [[t]], rng.standard_normal((1, 1, H, d))
                      * (1.0 + t)))
    steps.append(([[3, 3, 3, 3]], [[0, 1, 2, 3]],     # a whole-page chunk
                  rng.standard_normal((1, 4, H, d))))
    # a batch with repeated page ids, a padded row to scratch slot 0, and
    # a page (3) whose scale grows so its resident codes requantize
    steps.append(([[4, 4, 4, 0], [5, 5, 3, 3]], [[0, 1, 2, 0], [0, 1, 1, 2]],
                  rng.standard_normal((2, 4, H, d)) * [[[[1.0]]], [[[6.0]]]]))
    steps.append(([[2, 0]], [[0, 0]],                  # page 2 restarts
                  rng.standard_normal((1, 2, H, d)) * 0.01))
    steps.append(([[4]], [[3]], rng.standard_normal((1, 1, H, d)) * 9.0))
    return [(np.asarray(wp, np.int32), np.asarray(wo, np.int32),
             np.asarray(x, np.float32)) for wp, wo, x in steps]


def test_quantized_page_write_matches_jax_step_by_step():
    rng = np.random.default_rng(0)
    P, ps, H, d = 6, 4, 2, 8
    codes = np.zeros((P, ps, H, d), np.int8)
    scales = np.zeros((P, H), np.float32)
    for wp, wo, x in _write_steps(rng, H, d):
        jc, js = jax_kvc.quantized_page_write(
            jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(wp),
            jnp.asarray(wo), jnp.asarray(x))
        jc, js = np.asarray(jc), np.asarray(js)
        tc, ts = _t(codes.copy()), _t(scales.copy())
        out = kvc.quantized_page_write(tc, ts, _t(wp).long(), _t(wo).long(),
                                       _t(x))
        assert out[0] is tc and out[1] is ts          # written in place
        np.testing.assert_allclose(ts.numpy()[1:], js[1:], rtol=1e-6,
                                   atol=0)
        _tie_ok(tc.numpy()[1:], jc[1:],
                _pre_round(codes, scales, js, wp, wo, x)[1:])
        codes, scales = jc, js                        # the next step's input
    assert scales[2].max() < 0.01                     # page 2 restarted
    assert (codes[1] == 0).all() and (scales[1] == 0).all()  # untouched


def test_quantized_page_write_is_idempotent_in_place():
    rng = np.random.default_rng(1)
    codes = torch.zeros(6, 4, 2, 8, dtype=torch.int8)
    scales = torch.zeros(6, 2)
    for wp, wo, x in _write_steps(rng):
        args = (_t(wp).long(), _t(wo).long(), _t(x))
        kvc.quantized_page_write(codes, scales, *args)
        once = codes.clone(), scales.clone()
        kvc.quantized_page_write(codes, scales, *args)   # a retried step
        assert torch.equal(codes, once[0]) and torch.equal(scales, once[1])


def test_quantized_page_write_round_trip_within_scale():
    """Decode-style and chunk-style appends dequantize back within the
    page's scale (the JAX package's round-trip pin)."""
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((4, 2, 8)).astype(np.float32)
    codes = torch.zeros(5, 4, 2, 8, dtype=torch.int8)
    scales = torch.zeros(5, 2)
    for t in range(4):
        kvc.quantized_page_write(codes, scales, torch.tensor([[2]]),
                                 torch.tensor([[t]]), _t(vals[t][None, None]))
    kvc.quantized_page_write(codes, scales, torch.full((1, 4), 3),
                             torch.arange(4)[None], _t(vals[None]))
    for page in (2, 3):
        deq = codes[page].float() * scales[page][None, :, None]
        bound = scales[page][None, :, None] * 1.01 + 1e-7
        assert ((deq - _t(vals)).abs() <= bound).all(), f"page {page}"


# ---------------------------------------------------------------- fp8

FP8_VALUES = np.asarray(
    [0.0, -0.0, 1.0, -1.5, 448, -448, 460, 464, -464, 464.01, 470, -470,
     480, 1000, -1000, 1e6, np.inf, -np.inf, np.nan, 2.0 ** -6, 2.0 ** -7,
     2.0 ** -9, 3 * 2.0 ** -10, 2.0 ** -10, -(2.0 ** -9), 1e-9, 0.3, 17.3,
     -250.0], np.float32)


def _bits(a):
    return np.asarray(a).view(np.uint8)


def test_fp8_round_is_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([FP8_VALUES, (rng.standard_normal(4000)
                                     * 10.0 ** rng.uniform(-4, 3, 4000)
                                     ).astype(np.float32)])
    ours = kvc.fp8_round(_t(x)).numpy()
    ref = np.asarray(jax_kvc.fp8_round(jnp.asarray(x)))
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))
    # the overflow rule torch's own cast does not follow
    assert np.isnan(ours[np.abs(x) > 464]).all()
    assert (ours[np.abs(x) == 464] == np.sign(x[np.abs(x) == 464]) * 448).all()
    assert not np.isnan(torch.tensor([470.0]).to(torch.float8_e4m3fn)
                        .float().numpy()).any()


def test_fp8_page_write_is_bit_equal_to_jax_and_idempotent():
    x = FP8_VALUES[:28].reshape(1, 2, 2, 7)
    wp, wo = np.asarray([[1, 2]], np.int32), np.asarray([[0, 3]], np.int32)
    ref = jax_kvc.fp8_page_write(jnp.zeros((3, 4, 2, 7), jnp.float8_e4m3fn),
                                 jnp.asarray(wp), jnp.asarray(wo),
                                 jnp.asarray(x))
    pool = torch.zeros(3, 4, 2, 7, dtype=torch.float8_e4m3fn)
    out = kvc.fp8_page_write(pool, _t(wp).long(), _t(wo).long(), _t(x))
    assert out is pool
    np.testing.assert_array_equal(_bits(pool.view(torch.uint8)), _bits(ref))
    once = pool.clone()
    kvc.fp8_page_write(pool, _t(wp).long(), _t(wo).long(), _t(x))
    assert torch.equal(pool.view(torch.uint8), once.view(torch.uint8))


# --------------------------------------------------------- plain K1-q

def _int8_pools(rng, B=2, n_kv=2, d=16, ps=8, pages=6, n_rep=1, T=8):
    nb = 1 + B * pages
    kp = rng.integers(-127, 128, (nb, ps, n_kv, d)).astype(np.int8)
    vp = rng.integers(-127, 128, (nb, ps, n_kv, d)).astype(np.int8)
    ks = rng.uniform(1e-3, 5e-2, (nb, n_kv)).astype(np.float32)
    vs = rng.uniform(1e-3, 5e-2, (nb, n_kv)).astype(np.float32)
    tbl = rng.permutation(np.arange(1, nb)).reshape(B, pages).astype(np.int32)
    q = rng.standard_normal((B, T, n_kv * n_rep, d)).astype(np.float32)
    return q, kp, vp, ks, vs, tbl


def _fp8_pools(rng, B=2, n_kv=2, d=16, ps=8, pages=6, n_rep=1, T=8):
    """fp8 pools as raw bytes (the same bits on both sides)."""
    nb = 1 + B * pages
    kp, vp = (np.array(_bits(jnp.asarray(
        rng.standard_normal((nb, ps, n_kv, d)), jnp.float32).astype(
            jnp.float8_e4m3fn))) for _ in range(2))
    tbl = rng.permutation(np.arange(1, nb)).reshape(B, pages).astype(np.int32)
    q = rng.standard_normal((B, T, n_kv * n_rep, d)).astype(np.float32)
    return q, kp, vp, None, None, tbl


def _as_jax(pool):
    if pool.dtype == np.uint8:
        return jnp.asarray(pool.view(jnp.float8_e4m3fn))
    return jnp.asarray(pool)


def _as_torch(pool):
    if pool.dtype == np.uint8:
        return _t(pool).view(torch.float8_e4m3fn)
    return _t(pool)


def _port_k1(q, kp, vp, ks, vs, tbl, starts, qlens):
    return k1.ragged_paged_attention(
        _t(q), _as_torch(kp), _as_torch(vp), _t(tbl),
        torch.tensor(starts, dtype=torch.int32),
        torch.tensor(qlens, dtype=torch.int32),
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs)).numpy()


def _jax_k1(q, kp, vp, ks, vs, tbl, starts, qlens, interpret=True):
    args = (jnp.asarray(q), _as_jax(kp), _as_jax(vp), jnp.asarray(tbl),
            jnp.asarray(starts, jnp.int32), jnp.asarray(qlens, jnp.int32))
    kw = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                    v_scale=jnp.asarray(vs))
    if interpret:
        return np.asarray(jax_k1.ragged_paged_attention(*args, interpret=True,
                                                        **kw))
    return np.asarray(jax_k1.ragged_reference(*args, **kw))


def _check_k1(ops, starts, qlens):
    ours = _port_k1(*ops, starts, qlens)
    for interpret in (True, False):
        np.testing.assert_allclose(
            ours, _jax_k1(*ops, starts, qlens, interpret=interpret),
            rtol=RTOL, atol=ATOL)
    for b, ql in enumerate(qlens):
        assert (ours[b, ql:] == 0.0).all(), f"sequence {b}: rows >= {ql}"
    return ours


@pytest.mark.parametrize("q_len,start_pos", [
    (1, 0), (1, 7), (1, 8), (1, 37),        # decode at page boundaries
    (5, 0), (8, 0),                          # fresh prefill
    (3, 13), (8, 16), (6, 40),               # offset chunks
])
@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_plain_int8_matches_jax_kernel_sweep(q_len, start_pos, n_rep):
    rng = np.random.default_rng(q_len * 100 + start_pos)
    ops = _int8_pools(rng, n_rep=n_rep)
    k1.COUNTS_I8.reset()
    _check_k1(ops, [start_pos, max(0, start_pos - 2)],
              [q_len, max(1, q_len - 1)])
    assert k1.COUNTS_I8.plain_launches == 1
    assert k1.COUNTS_I8.kernel_launches == 0


@pytest.mark.parametrize("q_len,start_pos", [
    (1, 0), (1, 7), (1, 37), (8, 0), (3, 13), (6, 40),
])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_plain_fp8_matches_jax_kernel_sweep(q_len, start_pos, n_rep):
    rng = np.random.default_rng(q_len * 100 + start_pos + 7)
    ops = _fp8_pools(rng, n_rep=n_rep)
    k1.COUNTS_F8.reset()
    _check_k1(ops, [start_pos, max(0, start_pos - 2)],
              [q_len, max(1, q_len - 1)])
    assert k1.COUNTS_F8.plain_launches == 1
    assert k1.COUNTS_F8.kernel_launches == 0


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_plain_k1q_dead_slot_and_bucket_invariance(kind):
    """Mixed spans with a dead slot; the same spans in a 2x-wider padded
    bucket give bit-identical live rows and zero padded rows."""
    rng = np.random.default_rng(5)
    make = _int8_pools if kind == "int8" else _fp8_pools
    q, kp, vp, ks, vs, tbl = make(rng, B=3, n_rep=2, T=4)
    starts, qlens = [33, 8, 0], [1, 4, 0]
    tight = _check_k1((q, kp, vp, ks, vs, tbl), starts, qlens)
    assert (tight[2] == 0.0).all() and np.isfinite(tight).all()
    q_wide = np.concatenate(
        [q, rng.standard_normal(q.shape).astype(np.float32)], axis=1)
    wide = _check_k1((q_wide, kp, vp, ks, vs, tbl), starts, qlens)
    np.testing.assert_array_equal(tight[0, :1], wide[0, :1])
    np.testing.assert_array_equal(tight[1, :4], wide[1, :4])


def test_plain_int8_page_count_invariance():
    """3x more (dead) table pages change nothing."""
    rng = np.random.default_rng(6)
    q, kp, vp, ks, vs, tbl = _int8_pools(rng, pages=4)
    starts, qlens = [9, 21], [4, 1]
    out = _check_k1((q, kp, vp, ks, vs, tbl), starts, qlens)
    wide = np.concatenate([tbl, np.repeat(tbl[:, :1], 8, 1)], axis=1)
    np.testing.assert_array_equal(
        out, _port_k1(q, kp, vp, ks, vs, wide, starts, qlens))


def test_fp8_nan_codes_stay_nan():
    """A NaN code (0x7F) in a visible key poisons its rows, as the cast
    does in the JAX package; the dequantize does not hide it."""
    rng = np.random.default_rng(8)
    q, kp, vp, _, _, tbl = _fp8_pools(rng, B=1, pages=2)
    vp[tbl[0, 0], 3, 0, 5] = 0x7F
    ours = _port_k1(q, kp, vp, None, None, tbl, [4], [2])
    ref = _jax_k1(q, kp, vp, None, None, tbl, [4], [2], interpret=False)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    assert np.isnan(ours[0, :2, :2]).any()


def test_wrapper_refuses_mismatched_scales():
    rng = np.random.default_rng(9)
    q, kp, vp, ks, vs, tbl = _int8_pools(rng)
    z = torch.zeros(2, dtype=torch.int32)
    args = (_t(q), _t(kp), _t(vp), _t(tbl), z, z + 1)
    with pytest.raises(ValueError, match="int8 pools need"):
        k1.ragged_paged_attention(*args)
    with pytest.raises(ValueError, match="both"):
        k1.ragged_paged_attention(*args, k_scale=_t(ks))
    with pytest.raises(ValueError, match="one scale per page"):
        k1.ragged_paged_attention(*args, k_scale=_t(ks[:, :1]).contiguous(),
                                  v_scale=_t(vs[:, :1]).contiguous())
    with pytest.raises(ValueError, match="fp32 and fp8 pools take none"):
        k1.ragged_paged_attention(_t(q), _t(kp).float(), _t(vp).float(),
                                  _t(tbl), z, z + 1, k_scale=_t(ks),
                                  v_scale=_t(vs))
    with pytest.raises(TypeError, match="one dtype"):
        k1.ragged_paged_attention(_t(q), _t(kp), _t(vp).float(), _t(tbl), z,
                                  z + 1)


def test_wrapper_alignment_rules_for_codes_and_scales():
    """Scales are read one float at a time (4-byte alignment is enough),
    codes four bytes at a time: a code pool one byte off is refused on
    the CPU as on the card."""
    rng = np.random.default_rng(10)
    q, kp, vp, ks, vs, tbl = _int8_pools(rng)
    z = torch.zeros(2, dtype=torch.int32)

    def shifted(a, dtype):
        buf = torch.zeros(a.size + 1, dtype=dtype)
        buf[1:] = _t(a).reshape(-1)
        return buf[1:].view(a.shape)

    ref = _port_k1(q, kp, vp, ks, vs, tbl, [3, 9], [2, 1])
    out = k1.ragged_paged_attention(
        _t(q), _t(kp), _t(vp), _t(tbl), z + torch.tensor([3, 9]).int(),
        torch.tensor([2, 1]).int(), k_scale=shifted(ks, torch.float32),
        v_scale=shifted(vs, torch.float32))
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError, match="4-byte aligned"):
        k1.ragged_paged_attention(_t(q), shifted(kp, torch.int8), _t(vp),
                                  _t(tbl), z, z + 1, k_scale=_t(ks),
                                  v_scale=_t(vs))


# ------------------------------------------------------------- models

def _jax_model(n_kv):
    paddle.seed(0)
    model = JaxLlama(JaxLlamaConfig(num_heads=4, num_kv_heads=n_kv,
                                    dropout=0.0, **SIZES))
    model.eval()
    return model


def _bridge(jm):
    arrays = {k: np.asarray(v)
              for k, v in functionalize(jm).param_values().items()}
    model = Llama(LlamaConfig(num_heads=4, num_kv_heads=jm.cfg.num_kv_heads,
                              **SIZES), device="cpu", seed=1)
    load_params(model, arrays)
    return model


@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def pair(request):
    jm = _jax_model(request.param)
    return jm, _bridge(jm)


def _pool_numpy(layer):
    return [np.asarray(a.view(torch.uint8) if isinstance(a, torch.Tensor)
                       and a.dtype == torch.float8_e4m3fn else a)
            if isinstance(a, torch.Tensor) else _bits_or_array(a)
            for a in layer]


def _bits_or_array(a):
    a = np.asarray(a)
    return a.view(np.uint8) if "float8" in str(a.dtype) else a


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("attn_impl", ["ragged", "reference"])
def test_step_logits_and_pools_match_jax_runner(pair, kv_dtype, attn_impl):
    """Two prefill chunks of one sequence (the second at start_pos > 0,
    crossing a page boundary), then batched decode steps beside a dead
    slot: every call's logits match the JAX runner's (atol 1e-4) and so
    do the pools: fp8 bytes equal, int8 scales to rtol 1e-6 and codes
    within one step."""
    jm, pm = pair
    bs, P = 8, 8
    jr = JaxLlamaRunner(jm, block_size=bs, max_model_len=96,
                        attn_impl=attn_impl, kv_dtype=kv_dtype)
    pr = LlamaRunner(pm, block_size=bs, max_model_len=96,
                     attn_impl=attn_impl, kv_dtype=kv_dtype)
    n_kv, d = pr.n_kv_heads, pr.head_dim
    jpools = JaxKVCachePool(2, 1 + P, bs, n_kv, d, kv_dtype=kv_dtype).pools
    ppools = KVCachePool(2, 1 + P, bs, n_kv, d, device="cpu",
                         kv_dtype=kv_dtype).pools
    table = [3, 1, 4, 2, 5, 0, 0, 0]
    toks = [int(t) for t in np.random.default_rng(1).integers(1, 97, 20)]
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
    for jlayer, player in zip(jpools, ppools):
        ours, ref = _pool_numpy(player), _pool_numpy(jlayer)
        assert len(ours) == len(ref) == (4 if kv_dtype == "int8" else 2)
        for o, r in zip(ours[2:], ref[2:]):           # int8 scales
            np.testing.assert_allclose(o[live], r[live], rtol=1e-6, atol=0)
        for o, r in zip(ours[:2], ref[:2]):
            if kv_dtype == "fp8":
                np.testing.assert_array_equal(o[live], r[live])
            else:
                assert np.abs(o[live].astype(np.int32)
                              - r[live].astype(np.int32)).max() <= 1


@pytest.mark.parametrize("n_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("attn_impl", ["pallas", "ragged", "reference"])
def test_attn_impl_resolves_as_the_jax_runner(n_kv, kv_dtype, attn_impl):
    """Port and JAX runners pick the same path per bucket; int8 and fp8
    pools never reach the paged-decode kernel (MHA decode -> ragged)."""
    jm = _jax_model(n_kv)
    pm = _bridge(jm)
    jr = JaxLlamaRunner(jm, block_size=8, max_model_len=96,
                        attn_impl=attn_impl, kv_dtype=kv_dtype)
    pr = LlamaRunner(pm, block_size=8, max_model_len=96,
                     attn_impl=attn_impl, kv_dtype=kv_dtype)
    for bucket in (1, 8, 16):
        assert pr._attn_impl_for(bucket) == jr._attn_impl_for(bucket)
    if kv_dtype != "fp32" and attn_impl != "reference":
        assert pr._attn_impl_for(1) == "ragged"


def _prompts(seed=3, n=4):
    r = np.random.default_rng(seed)
    return [r.integers(1, 97, int(r.integers(6, 30))).tolist()
            for _ in range(n)]


def _serve(eng, prompts, sp, max_tokens=8):
    ids = [eng.add_request(p, sp(max_tokens=max_tokens)) for p in prompts]
    outs = eng.run()
    return [outs[i].output_tokens for i in ids]


def _jax_engine_tokens(jm, kv_dtype, prompts):
    jr = JaxLlamaRunner(jm, block_size=8, max_model_len=96,
                        attn_impl="reference", kv_dtype=kv_dtype)
    jeng = JaxServingEngine(jr, num_blocks=24, max_batch_size=4,
                            max_model_len=96, max_prefill_tokens_per_step=16)
    return _serve(jeng, prompts, JaxSamplingParams)


def _port_engine(pm, kv_dtype):
    return create_serving_engine(pm, device="cpu", kv_dtype=kv_dtype,
                                 block_size=8, max_model_len=96,
                                 num_blocks=24, max_batch_size=4,
                                 max_prefill_tokens_per_step=16)


def test_fp8_engine_equals_naive_and_the_jax_engine(pair):
    jm, pm = pair
    prompts = _prompts()
    for c in (k1.COUNTS, k1.COUNTS_I8, k1.COUNTS_F8):
        c.reset()
    eng = _port_engine(pm, "fp8")
    toks = _serve(eng, prompts, SamplingParams)
    assert k1.COUNTS_F8.plain_launches > 0
    assert k1.COUNTS.plain_launches == k1.COUNTS_I8.plain_launches == 0
    assert eng.pool.allocator.check_no_leaks()
    for t, p in zip(toks, prompts):
        assert t == naive_generate(eng.runner, p, SamplingParams(max_tokens=8),
                                   max_model_len=96)
    assert toks == _jax_engine_tokens(jm, "fp8", prompts)


def test_int8_engine_equals_the_jax_engine_and_agrees_with_fp32(pair):
    jm, pm = pair
    prompts = _prompts()
    eng = _port_engine(pm, "int8")
    toks = _serve(eng, prompts, SamplingParams)
    assert eng.pool.allocator.check_no_leaks()
    assert toks == _jax_engine_tokens(jm, "int8", prompts)
    fp32 = LlamaRunner(pm, block_size=8, max_model_len=96)
    oracle = [naive_generate(fp32, p, SamplingParams(max_tokens=8),
                             max_model_len=96) for p in prompts]
    agree = sum(int(a == b) for t, o in zip(toks, oracle)
                for a, b in zip(t, o))
    assert agree / sum(map(len, oracle)) >= 0.99


def test_int8_decode_retry_leaves_pools_bit_identical(pair):
    """A decode step run twice on the same pools (a retried step) writes
    the same codes and scales again."""
    _, pm = pair
    runner = LlamaRunner(pm, block_size=8, max_model_len=96, kv_dtype="int8")
    pool = KVCachePool(2, 6, 8, runner.n_kv_heads, runner.head_dim,
                       device="cpu", kv_dtype="int8")
    table = pool.pad_table(pool.allocator.alloc(3), 5)
    _, pools = runner.prefill(list(range(1, 12)), table, pool.pools)
    tables = np.asarray([table], np.int32)
    args = (np.asarray([5], np.int32), tables, np.asarray([11], np.int32))
    runner.decode(*args, pools)
    once = [tuple(a.clone() for a in layer) for layer in pools]
    runner.decode(*args, pools)
    for a, b in zip(once, pools):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ----------------------------------------------------- bytes and gauges

@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
def test_byte_formulas_and_gauges_match_jax(pair, kv_dtype):
    jm, pm = pair
    ours = KVCachePool(2, 10, 8, 2, 16, device="cpu", kv_dtype=kv_dtype)
    ref = JaxKVCachePool(2, 10, 8, 2, 16, kv_dtype=kv_dtype)
    for name in ("page_bytes", "unquantized_page_bytes",
                 "kv_bytes_reduction_x", "memory_bytes"):
        assert getattr(ours, name)() == getattr(ref, name)(), name
    want = {"fp32": 1.0, "fp8": 4.0}.get(kv_dtype)
    if want is None:
        assert ours.kv_bytes_reduction_x() >= 1.8
    else:
        assert ours.kv_bytes_reduction_x() == want
    pr = LlamaRunner(pm, block_size=8, max_model_len=96, kv_dtype=kv_dtype)
    jr = JaxLlamaRunner(jm, block_size=8, max_model_len=96,
                        kv_dtype=kv_dtype)
    assert pr._kv_page_bytes() == jr._kv_page_bytes()
    snap = ServingEngine(pr, num_blocks=16, max_batch_size=2,
                         max_model_len=96).metrics.snapshot()
    jsnap = JaxServingEngine(jr, num_blocks=16, max_batch_size=2,
                             max_model_len=96).metrics.snapshot()
    for key in ("kv_bytes_reduction_x", "sessions_per_pool_x"):
        assert snap[key] == jsnap[key] == ours.kv_bytes_reduction_x()


def test_pool_layouts():
    p8 = KVCachePool(2, 9, 8, 2, 16, device="cpu", kv_dtype="int8")
    for k, v, ks, vs in p8.pools:
        assert k.dtype == v.dtype == torch.int8
        assert tuple(k.shape) == (9, 8, 2, 16)
        assert ks.dtype == torch.float32 and tuple(vs.shape) == (9, 2)
    pf = KVCachePool(2, 9, 8, 2, 16, device="cpu", kv_dtype="fp8")
    for layer in pf.pools:
        assert len(layer) == 2
        assert layer[0].dtype == torch.float8_e4m3fn


# ------------------------------------------------------------ auditor

def _small_engine(kv_dtype):
    model = Llama(LlamaConfig(num_heads=4, num_kv_heads=2, **SIZES),
                  device="cpu", seed=0)
    eng = create_serving_engine(model, device="cpu", kv_dtype=kv_dtype,
                                block_size=8, max_model_len=96,
                                num_blocks=16, max_batch_size=2, audit=False)
    eng.add_request([1, 2, 3], SamplingParams(max_tokens=4))
    eng.step()
    audit_engine(eng)                                   # consistent
    return eng


def test_auditor_rejects_a_broken_scale_pool():
    eng = _small_engine("int8")
    k, v, ks, vs = eng.pool.pools[1]
    eng.pool.pools[1] = (k, v, ks[:, :1].contiguous(), vs)
    with pytest.raises(InvariantViolation, match="one scale per page"):
        audit_engine(eng)
    eng.pool.pools[1] = (k.float(), v, ks, vs)
    with pytest.raises(InvariantViolation, match="int8"):
        audit_engine(eng)


def test_auditor_rejects_scale_rows_on_an_fp8_pool():
    eng = _small_engine("fp8")
    k, v = eng.pool.pools[0]
    eng.pool.pools[0] = (k, v, torch.zeros(16, 2), torch.zeros(16, 2))
    with pytest.raises(InvariantViolation, match="entries"):
        audit_engine(eng)
    eng.pool.pools[0] = (k.float(), v)
    with pytest.raises(InvariantViolation, match="float8"):
        audit_engine(eng)


# ------------------------------------------------------------ refusals

def test_mixed_pools_and_quantized_weights_raise_naming_their_items():
    model = Llama(LlamaConfig(num_heads=4, num_kv_heads=2, **SIZES),
                  device="cpu", seed=0)
    for call in (lambda: KVCachePool(1, 4, 4, 1, 8, device="cpu",
                                     kv_dtype="mixed"),
                 lambda: runner_for(model, kv_dtype="mixed", device="cpu"),
                 lambda: runner_for(model, weight_dtype="int8",
                                    device="cpu"),
                 lambda: create_serving_engine(model, device="cpu",
                                               kv_dtype="mixed"),
                 lambda: create_serving_engine(model, device="cpu",
                                               weight_dtype="int8")):
        with pytest.raises(NotImplementedError, match="item 8"):
            call()
    with pytest.raises(ValueError, match="kv_dtype"):
        KVCachePool(1, 4, 4, 1, 8, device="cpu", kv_dtype="int4")


def test_request_kv_dtype_is_checked_at_intake():
    eng = _small_engine("fp8")
    eng.add_request([4, 5], SamplingParams(max_tokens=2, kv_dtype="fp8"))
    with pytest.raises(ValueError, match="not servable"):
        eng.add_request([4, 5], SamplingParams(max_tokens=2,
                                               kv_dtype="int8"))
    with pytest.raises(ValueError, match="kv_dtype"):
        SamplingParams(kv_dtype="bf16")
    assert JaxSamplingParams(kv_dtype="fp8").kv_dtype == "fp8"
