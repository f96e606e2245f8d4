"""The arithmetic of K1's fp16-q forms on the card, modelled in torch on
the CPU, against the JAX `ragged_paged_attention` (Pallas, interpret mode)
at fp16 and against the port's plain version.

The card's kernels (csrc/ragged_paged_attention_bf16.cu at H = kF16)
cannot run here, so this file states their arithmetic as plain torch and
holds it to the gates the card holds the kernels to (`chip_smoke.py`'s
`_vs_fp64` and `misround_share`: within twice the fp16 plain version's
error against the fp64 evaluation, misrounding at most 1/16 of the
outputs the plain version rounds to fp16(exact)), and within one fp16
ulp of the Pallas kernel (rtol 2^-10; atol 2^-20 for outputs whose fp32
sums cancel to near 0):

  * the span form (`span_model`): fp16 products summed in fp32 (q K^T on
    fp16-exact operands: an int8 code or an e4m3 value is exact in fp16),
    an online softmax over 32-key tiles, P times a power of two F before
    its split into three fp16 terms against V, acc in units of F and
    divided by it at the end: F = 2^14 over fp16 and fp8 pools; over int8
    pools, where the v scale is folded into P (l sums the unscaled P), F
    is chosen per row from w, the row's largest P vs so far at its running
    max (`p_factor`: F w in [2^13, 2^14)), and a row's acc moves to its
    new F by the exact ratio of two powers of two;
  * the decode form's split walk (`split_model`): the same arithmetic in
    16-key tiles, a walk a split of KEYS_PER_SPLIT keys, merged in split
    order, at key counts on and across split boundaries;
  * int8 scales at fp16's extremes (1e-6: P vs far below fp16's normal
    range; 1e2: above 2^14); at scales of 1e-3 and 1e-6 the same walk
    with F = 1 (P vs split as it is) misrounds past the gate: the reason
    for F; pages of scales 1e-6 and 1e2 in one tile misround past it
    with one F a tile, from the tile's largest v scale: the reason F is
    a row's;
  * the widening of the codes to fp16 (`codes16x4`): an int8 code as the
    fp16 with its biased byte under 2^10, less 1152; an e4m3 value cast.

Seeded numpy inputs at small widths: 2 kv heads, n_rep 1 or 2, d 64,
pages of 16.
"""

import importlib
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops import ragged_paged_attention as k1

jax_k1 = importlib.import_module(
    "paddle_tpu.ops.pallas.ragged_paged_attention")

torch.set_num_threads(1)

ULP_RTOL, ULP_ATOL = 2.0 ** -10, 2.0 ** -20
D, PS, N_KV = 64, 16, 2
TILE = 32          # the span form's keys a tile
DECODE_TILE = 16   # the decode form's
NEG_INF = -1e30
P_SCALE = 2.0 ** 14   # F over fp16 and fp8 pools


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


def _f16_exact(a):
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


def _operands(rng, kind, B, T, n_rep, pages, scale_range=(1e-3, 5.1e-2)):
    """(port operands, jax operands): fp16 q, pools of ``kind`` (int8
    codes with per-page scales drawn log-uniformly from ``scale_range``),
    a table of distinct pages."""
    nb = 1 + B * pages
    q = _f16_exact(rng.standard_normal((B, T, N_KV * n_rep, D)))
    tbl = rng.permutation(np.arange(1, nb)).reshape(B, pages).astype(np.int32)
    port = dict(q=torch.from_numpy(q).half(), table=torch.from_numpy(tbl))
    jax = dict(q=jnp.asarray(q, jnp.float16), table=jnp.asarray(tbl))
    if kind == "int8":
        codes = [rng.integers(-127, 128, (nb, PS, N_KV, D)).astype(np.int8)
                 for _ in range(2)]
        lo, hi = scale_range
        scales = [np.exp(rng.uniform(np.log(lo), np.log(hi), (nb, N_KV)))
                  .astype(np.float32) for _ in range(2)]
        port.update(k=torch.from_numpy(codes[0]), v=torch.from_numpy(codes[1]),
                    sc=dict(k_scale=torch.from_numpy(scales[0]),
                            v_scale=torch.from_numpy(scales[1])))
        jax.update(k=jnp.asarray(codes[0]), v=jnp.asarray(codes[1]),
                   sc=dict(k_scale=jnp.asarray(scales[0]),
                           v_scale=jnp.asarray(scales[1])))
        return port, jax
    k, v = (_f16_exact(rng.standard_normal((nb, PS, N_KV, D)))
            for _ in range(2))
    if kind == "fp16":
        port.update(k=torch.from_numpy(k).half(),
                    v=torch.from_numpy(v).half(), sc={})
        jax.update(k=jnp.asarray(k, jnp.float16),
                   v=jnp.asarray(v, jnp.float16), sc={})
        return port, jax
    kb, vb = (np.array(jnp.asarray(x).astype(jnp.float8_e4m3fn)
                       .view(jnp.uint8)) for x in (k, v))
    port.update(k=torch.from_numpy(kb).view(torch.float8_e4m3fn),
                v=torch.from_numpy(vb).view(torch.float8_e4m3fn), sc={})
    jax.update(k=jnp.asarray(kb).view(jnp.float8_e4m3fn),
               v=jnp.asarray(vb).view(jnp.float8_e4m3fn), sc={})
    return port, jax


def _gathered(port, kind):
    """Each sequence's K and V rows [B, L, n_kv, d] as the kernels hold
    them (fp16 values, e4m3 values and int8 codes are exact in fp32), and
    the int8 per-key scales [B, L, n_kv] (ones for the other pools)."""
    idx = port["table"].long()
    B, P = idx.shape
    L = P * PS
    k, v = (k1.dequantize_pages(pool, idx).reshape(B, L, N_KV, D)
            for pool in (port["k"], port["v"]))
    if kind == "int8":
        ks, vs = (port["sc"][n][idx].repeat_interleave(PS, dim=1)
                  for n in ("k_scale", "v_scale"))
    else:
        ks = vs = torch.ones(B, L, N_KV)
    return k, v, ks, vs


def _split_terms(x):
    """x in three fp16 terms: hi = fp16(x), mid = fp16(x - hi), lo =
    fp16(x - hi - mid)."""
    hi = x.half().float()
    mid = (x - hi).half().float()
    return hi, mid, (x - hi - mid).half().float()


def p_factor(w, F):
    """The kernel's p_factor: F with F w in [2^13, 2^14), or F kept where
    w is not positive and finite."""
    if not (w > 0.0 and math.isfinite(w)):
        return F
    _, e = math.frexp(w)             # w = m 2^e, m in [0.5, 1)
    return math.ldexp(1.0, 14 - e)


def _visible(start, qlen, T, L):
    t = torch.arange(T)
    return ((torch.arange(L)[None, None, :]
             <= (start[:, None] + t[None, :])[:, :, None])
            & (t[None, :, None] < qlen[:, None, None]))      # [B, T, L]


def _walk(qh, k, v, ks, vs, vis, scale, tile, kind, factor="row"):
    """The kernels' walk over one range of keys for one query head: fp32
    (m, l, acc) of its rows [T], from tiles of ``tile`` keys: S = q K^T on
    fp16-exact operands times the scale and the int8 k scale, an online
    softmax, P times the v scale and F in three fp16 terms against V (l
    sums the unscaled P), acc divided by F at the end. ``factor`` "row":
    the kernels' F a row (int8: from w, the row's largest P vs so far,
    moved to each tile's running max); "tile": one F a tile from the
    tile's largest v scale; None: F = 1, the split of P vs as it is."""
    T = qh.shape[0]
    m = torch.full((T,), NEG_INF)
    l = torch.zeros(T)
    acc = torch.zeros(T, D)
    kend = int(vis.any(dim=0).nonzero().max()) + 1 if vis.any() else 0
    F = torch.full((T,), P_SCALE if factor else 1.0)
    w = torch.zeros(T)
    for k0 in range(0, min(k.shape[0], kend), tile):
        sl = slice(k0, min(k0 + tile, kend))
        s = (qh @ k[sl].T) * scale * ks[sl][None, :]
        s = torch.where(vis[:, sl], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.max(dim=1).values)
        corr = torch.exp(m - m_new)
        p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                        torch.exp(s - m_new[:, None]))
        l = l * corr + p.sum(dim=1)
        acc = acc * corr[:, None]
        pv = p * vs[sl][None, :]
        if factor and kind == "int8":
            if factor == "tile":
                f = torch.full((T,), p_factor(float(vs[sl].max()),
                                              float(F[0])))
            else:
                w = torch.maximum(w * corr, pv.max(dim=1).values)
                f = torch.tensor([p_factor(float(x), float(y))
                                  for x, y in zip(w, F)])
            acc = acc * (f / F)[:, None]
            F = f
        hi, mid, lo = _split_terms(pv * F[:, None])
        acc = acc + (lo @ v[sl] + mid @ v[sl] + hi @ v[sl])
        m = m_new
    return m, l, acc / F[:, None]


def _model(port, kind, start, qlen, keys_per_split, tile, factor="row"):
    """Each query head's walks over splits of ``keys_per_split`` keys (one
    split: the span form), merged in split order: M = max m_s, out = sum
    exp(m_s - M) acc_s / sum exp(m_s - M) l_s; fp16 [B, T, n_q, d]."""
    q = port["q"].float()
    B, T, n_q, _ = q.shape
    n_rep = n_q // N_KV
    k, v, ks, vs = _gathered(port, kind)
    L = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    vis = _visible(start, qlen, T, L)
    out = torch.zeros(B, T, n_q, D)
    for b in range(B):
        for h in range(n_q):
            kvh = h // n_rep
            parts = [_walk(q[b, :, h], k[b, sl, kvh], v[b, sl, kvh],
                           ks[b, sl, kvh], vs[b, sl, kvh], vis[b, :, sl],
                           scale, tile, kind, factor)
                     for sl in (slice(s0, s0 + keys_per_split)
                                for s0 in range(0, L, keys_per_split))]
            M = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            den = torch.zeros(T)
            num = torch.zeros(T, D)
            for m, l, acc in parts:                       # in split order
                f = torch.exp(m - M)
                den = den + f * l
                num = num + f[:, None] * acc
            out[b, :, h] = num / den.clamp(min=1e-30)[:, None]
    return out.half()


def span_model(port, kind, start, qlen, factor="row"):
    """The span form's arithmetic (module docstring): one walk over every
    key in 32-key tiles."""
    L = port["table"].shape[1] * PS
    return _model(port, kind, start, qlen, L, TILE, factor)


def split_model(port, kind, start, qlen, keys_per_split=k1.KEYS_PER_SPLIT,
                factor="row"):
    """The decode form's split walk (module docstring): the span form's
    arithmetic in 16-key tiles, a walk a split of ``keys_per_split``
    keys, merged in split order."""
    return _model(port, kind, start, qlen, keys_per_split, DECODE_TILE,
                  factor)


def _gates(model_out, port, kind, start, qlen):
    """(the model's fp64 ratio, its misround share) against the plain
    version and its fp64 evaluation on the same operands."""
    st = torch.tensor(start, dtype=torch.int32)
    ql = torch.tensor(qlen, dtype=torch.int32)
    plain = k1.ragged_reference(port["q"], port["k"], port["v"],
                                port["table"], st, ql, **port["sc"])
    pools64 = ((port["k"].double(), port["v"].double()) if kind == "fp16"
               else (port["k"], port["v"]))
    exact = k1.ragged_reference(port["q"].double(), *pools64, port["table"],
                                st, ql, **port["sc"])
    _, _, ratio = CS._vs_fp64(model_out, plain, exact)
    return ratio, CS.misround_share(model_out, plain, exact)


def _held(model_out, port, jax_ops, kind, start, qlen, what):
    """The model's fp16 output within one ulp of the Pallas kernel's,
    within the card's fp16 gates against the fp64 evaluation, rows past
    q_len exactly 0."""
    ref = jax_k1.ragged_paged_attention(
        jax_ops["q"], jax_ops["k"], jax_ops["v"], jax_ops["table"],
        jnp.asarray(start, jnp.int32), jnp.asarray(qlen, jnp.int32),
        interpret=True, **jax_ops["sc"])
    np.testing.assert_allclose(model_out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=ULP_RTOL, atol=ULP_ATOL, err_msg=what)
    ratio, share = _gates(model_out, port, kind, start, qlen)
    assert ratio <= 2.0, (what, ratio)
    assert share <= CS.MISROUND_GATE, (what, share)
    for b, n in enumerate(qlen):
        assert bool((model_out[b, n:] == 0).all()), (what, b)


@pytest.mark.parametrize("kind", ["fp16", "int8", "fp8"])
@pytest.mark.parametrize("n_rep,T,start,qlen", [
    (1, 16, [13, 40, 0], [16, 9, 0]),          # chunks at offsets, a dead slot
    (2, 8, [100, 3, 57], [8, 1, 5]),           # GQA spans above the decode rows
    (1, 40, [0, 200, 290], [40, 33, 1]),       # across 32-key tiles, 300+ keys
], ids=["chunk", "gqa", "long"])
def test_span_model_within_the_f16_gates(kind, n_rep, T, start, qlen):
    rng = np.random.default_rng(sum(start) + 7 * T + n_rep)
    pages = -(-(max(start) + T) // PS) + 1
    port, jax_ops = _operands(rng, kind, len(start), T, n_rep, pages)
    out = span_model(port, kind, torch.tensor(start), torch.tensor(qlen))
    _held(out, port, jax_ops, kind, start, qlen, f"span {kind}")


@pytest.mark.parametrize("kind", ["fp16", "int8", "fp8"])
@pytest.mark.parametrize("n_rep,T", [(1, 1), (2, 4), (1, 8)],
                         ids=["mha-decode", "gqa", "verify"])
def test_split_model_within_the_f16_gates(kind, n_rep, T):
    """Key counts 1, 255, 256, 257 and 600 (splits of 256: on and across
    their boundaries), a row past q_len and a dead slot."""
    rng = np.random.default_rng(n_rep * 10 + T)
    keys = [1, 255, 256, 257, 600, 0]
    start = [max(n - T, 0) for n in keys]
    qlen = [min(T, n) if n else 0 for n in keys]
    qlen[3] = max(qlen[3] - 1, 1)              # a row past q_len
    pages = -(-(max(keys) + T) // PS) + 1
    port, jax_ops = _operands(rng, kind, len(keys), T, n_rep, pages)
    out = split_model(port, kind, torch.tensor(start), torch.tensor(qlen))
    _held(out, port, jax_ops, kind, start, qlen, f"split {kind}")


def _extreme(form, scales, seed):
    rng = np.random.default_rng(seed)
    T, start, qlen = (24, [5, 60], [24, 17]) if form == "span" \
        else (4, [255, 300], [4, 2])
    pages = -(-(max(start) + T) // PS) + 1
    port, jax_ops = _operands(rng, "int8", len(start), T, 2, pages,
                              scale_range=scales)
    model = span_model if form == "span" else split_model
    return model, port, jax_ops, start, qlen


@pytest.mark.parametrize("scales", [(1e-6, 1e-6), (1e2, 1e2), (1e-6, 1e2)],
                         ids=["small", "large", "spread"])
@pytest.mark.parametrize("form", ["span", "split"])
def test_int8_scales_at_their_extremes(scales, form):
    """int8 pages with scales at 1e-6 and 1e2 (and spread between): P vs
    F within 2^14 whatever the scale, the k scale on S's columns; the
    gates hold."""
    model, port, jax_ops, start, qlen = _extreme(
        form, scales, int(math.log10(scales[1]) + 10) + len(form))
    out = model(port, "int8", torch.tensor(start), torch.tensor(qlen))
    _held(out, port, jax_ops, "int8", start, qlen, f"int8 {form} {scales}")


@pytest.mark.parametrize("scale", [1e-6, 1e-3])
@pytest.mark.parametrize("form", ["span", "split"])
def test_without_the_factor_small_v_scales_leave_the_gates(form, scale):
    """The same walk with F = 1 at page scales of 1e-3 and 1e-6: P vs lies
    below fp16's normal range (2^-14) before its split, its terms keep a
    few bits, and more than MISROUND_GATE of the outputs round elsewhere
    than the plain version's fp16(exact); with F the share stays under
    the gate (by the CPU measurement the factor takes it from 7-65 % to
    under 0.1 %)."""
    model, port, _, start, qlen = _extreme(form, (scale, scale), 5)
    st, ql = torch.tensor(start), torch.tensor(qlen)
    _, share = _gates(model(port, "int8", st, ql, factor=None), port,
                      "int8", start, qlen)
    assert share > CS.MISROUND_GATE, share
    ratio, share = _gates(model(port, "int8", st, ql), port, "int8", start,
                          qlen)
    assert ratio <= 2.0 and share <= CS.MISROUND_GATE, (ratio, share)


@pytest.mark.parametrize("seed", range(4))
def test_far_apart_page_scales_in_one_tile_take_a_factor_a_row(seed):
    """int8 pages whose k and v scales are 1e-6 or 1e2, drawn per page and
    kv head (`chip_smoke.py`'s range case): a span tile of 32 keys holds
    two pages, and a row whose weight lies on the 1e-6 page beside a 1e2
    one keeps ~12 bits of P vs under one F a tile from the tile's largest
    v scale (2.7-8.4 % of the outputs misround on these seeds); with F a
    row from its largest P vs, the gates hold and the model is within an
    ulp of the Pallas kernel."""
    rng = np.random.default_rng(seed)
    T, start, qlen = 48, [5, 60, 140], [48, 30, 48]
    pages = -(-(max(start) + T) // PS) + 1
    port, jax_ops = _operands(rng, "int8", len(start), T, 1, pages)
    nb = port["k"].shape[0]
    for name in ("k_scale", "v_scale"):
        coin = rng.random((nb, N_KV)) < 0.5
        scales = np.where(coin, 1e-6, 1e2).astype(np.float32)
        port["sc"][name] = torch.from_numpy(scales)
        jax_ops["sc"][name] = jnp.asarray(scales)
    st, ql = torch.tensor(start), torch.tensor(qlen)
    _, share = _gates(span_model(port, "int8", st, ql, factor="tile"), port,
                      "int8", start, qlen)
    assert share > CS.MISROUND_GATE / 4, share
    _held(span_model(port, "int8", st, ql), port, jax_ops, "int8", start,
          qlen, f"int8 span, scales 1e-6 / 1e2, seed {seed}")


@pytest.mark.parametrize("w", [1e-30, 1e-6, 3.9e-3, 1.0, 127.0, 1e2,
                               4096.0, 6e4])
def test_p_factor_keeps_p_vs_f_under_2_to_14(w):
    """F is a power of two with F w in [2^13, 2^14): every P vs F of the
    row (P vs <= w) below 2^14, the largest in fp16's normal range with
    room for the two smaller terms; no positive weight keeps the row's
    F."""
    F = p_factor(w, 7.0)
    assert math.frexp(F)[0] == 0.5                       # a power of two
    assert 2.0 ** 13 <= F * w < 2.0 ** 14
    for dead in (0.0, float("nan"), float("inf")):
        assert p_factor(dead, 7.0) == 7.0


def test_int8_codes_and_e4m3_values_widen_to_fp16_exactly():
    """codes16x4 at fp16: the fp16 with the biased byte c + 128 under
    2^10 (bits 0x64 above it) less 1152 is c, for every int8 code; every
    e4m3 value converts to fp16 exactly (NaN stays NaN)."""
    c = np.arange(-128, 128)
    biased = (0x6400 | (c + 128)).astype(np.uint16).view(np.float16)
    widened = (biased - np.float16(1152.0)).astype(np.float16)
    np.testing.assert_array_equal(widened.astype(np.int32), c)
    e4m3 = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.float8_e4m3fn)
    as32, as16 = e4m3.float(), e4m3.half().float()
    nan = torch.isnan(as32)
    assert torch.equal(torch.isnan(as16), nan)
    assert torch.equal(as16[~nan], as32[~nan])
