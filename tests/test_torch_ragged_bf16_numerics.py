"""The arithmetic of K1's bf16-q forms on the card, modelled in torch on
the CPU, against the JAX `ragged_paged_attention` (Pallas, interpret mode)
at bf16 and against the port's plain version.

The card's kernels (csrc/ragged_paged_attention_bf16.cu) cannot run here,
so this file states their arithmetic as plain torch and holds it to the
gates the card holds the kernels to (`chip_smoke.py`'s `_vs_fp64` and
`misround_share`: within twice the bf16 plain version's error against the
fp64 evaluation, misrounding at most 1/16 of the outputs the plain
version rounds to bf16(exact)), and within one bf16 ulp of the Pallas
kernel (rtol 2^-7, atol 2^-14 for outputs that cancel to near 0):

  * the span form (`span_model`): bf16 products summed in fp32 (q K^T on
    bf16-exact operands, an int8 code or an e4m3 value exact in bf16), an
    online softmax over 32-key tiles, P in three bf16 terms against
    V, the int8 k scale on S's columns and the v scale folded into P
    before its split while l sums the unscaled P;
  * the decode form's split walk (`split_model`): each sequence's visible
    keys in splits of KEYS_PER_SPLIT keys, each split's fp32 (m, l, acc)
    by the span form's arithmetic in 16-key tiles, merged in split order,
    at key counts on and across split boundaries.

It also pins the wrapper's split count and workspace size against a
Python statement of the rule. Seeded numpy inputs at small widths: 2 kv
heads, n_rep 1 or 2, d 64, pages of 16.
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

# one bf16 ulp; and an absolute floor for outputs whose terms cancel to
# near 0: the model sums in another order than the Pallas kernel and
# splits P, so such an output can part by more than an ulp of its own
# small value, though by far less than 2^-14 of the unit-scale sum it
# cancels from
ULP_RTOL, ULP_ATOL = 2.0 ** -7, 2.0 ** -14
D, PS, N_KV = 64, 16, 2
TILE = 32          # the span form's keys a tile
DECODE_TILE = 16   # the decode form's
NEG_INF = -1e30


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


def _bf16_exact(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _operands(rng, kind, B, T, n_rep, pages, scale_range=(1e-3, 5.1e-2)):
    """(port operands, jax operands): bf16 q, pools of ``kind`` (int8
    codes with per-page scales drawn from ``scale_range``), a table of
    distinct pages."""
    nb = 1 + B * pages
    q = _bf16_exact(rng.standard_normal((B, T, N_KV * n_rep, D)))
    tbl = rng.permutation(np.arange(1, nb)).reshape(B, pages).astype(np.int32)
    port = dict(q=torch.from_numpy(q).bfloat16(), table=torch.from_numpy(tbl))
    jax = dict(q=jnp.asarray(q, jnp.bfloat16), table=jnp.asarray(tbl))
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
    k, v = (_bf16_exact(rng.standard_normal((nb, PS, N_KV, D)))
            for _ in range(2))
    if kind == "bf16":
        port.update(k=torch.from_numpy(k).bfloat16(),
                    v=torch.from_numpy(v).bfloat16(), sc={})
        jax.update(k=jnp.asarray(k, jnp.bfloat16),
                   v=jnp.asarray(v, jnp.bfloat16), sc={})
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
    them (bf16 values, e4m3 values and int8 codes are exact in fp32), and
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


def _split_terms(p):
    """P in three bf16 terms: hi = bf16(p), mid = bf16(p - hi), lo =
    bf16(p - hi - mid)."""
    hi = p.bfloat16().float()
    mid = (p - hi).bfloat16().float()
    return hi, mid, (p - hi - mid).bfloat16().float()


def _visible(start, qlen, T, L):
    t = torch.arange(T)
    return ((torch.arange(L)[None, None, :]
             <= (start[:, None] + t[None, :])[:, :, None])
            & (t[None, :, None] < qlen[:, None, None]))      # [B, T, L]


def _walk(qh, k, v, ks, vs, vis, scale, tile):
    """The kernels' walk over one range of keys for one query head: fp32
    (m, l, acc) of its rows [T], from tiles of ``tile`` keys: S = q K^T on
    bf16-exact operands (exact products, fp32 sums) times the scale and
    the int8 k scale, an online softmax, P times the v scale in three bf16
    terms against V (l sums the unscaled P)."""
    T = qh.shape[0]
    m = torch.full((T,), NEG_INF)
    l = torch.zeros(T)
    acc = torch.zeros(T, D)
    for k0 in range(0, k.shape[0], tile):
        sl = slice(k0, k0 + tile)
        s = (qh @ k[sl].T) * scale * ks[sl][None, :]
        s = torch.where(vis[:, sl], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.max(dim=1).values)
        corr = torch.exp(m - m_new)
        p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                        torch.exp(s - m_new[:, None]))
        l = l * corr + p.sum(dim=1)
        hi, mid, lo = _split_terms(p * vs[sl][None, :])
        acc = acc * corr[:, None] + (lo @ v[sl] + mid @ v[sl] + hi @ v[sl])
        m = m_new
    return m, l, acc


def _model(port, kind, start, qlen, keys_per_split, tile):
    """Each query head's walks over splits of ``keys_per_split`` keys (one
    split: the span form), merged in split order: M = max m_s, out = sum
    exp(m_s - M) acc_s / sum exp(m_s - M) l_s; bf16 [B, T, n_q, d]."""
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
                           scale, tile)
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
    return out.bfloat16()


def span_model(port, kind, start, qlen):
    """The span form's arithmetic (module docstring): one walk over every
    key in 32-key tiles."""
    L = port["table"].shape[1] * PS
    return _model(port, kind, start, qlen, L, TILE)


def split_model(port, kind, start, qlen, keys_per_split=k1.KEYS_PER_SPLIT):
    """The decode form's split walk (module docstring): the span form's
    arithmetic in 16-key tiles, a walk a split of ``keys_per_split``
    keys, merged in split order."""
    return _model(port, kind, start, qlen, keys_per_split, DECODE_TILE)


def _held(model_out, port, jax_ops, kind, start, qlen, what):
    """The model's bf16 output within one ulp of the Pallas kernel's,
    within the card's bf16 gates against the fp64 evaluation, rows past
    q_len exactly 0."""
    st = torch.tensor(start, dtype=torch.int32)
    ql = torch.tensor(qlen, dtype=torch.int32)
    ref = jax_k1.ragged_paged_attention(
        jax_ops["q"], jax_ops["k"], jax_ops["v"], jax_ops["table"],
        jnp.asarray(start, jnp.int32), jnp.asarray(qlen, jnp.int32),
        interpret=True, **jax_ops["sc"])
    np.testing.assert_allclose(model_out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=ULP_RTOL, atol=ULP_ATOL, err_msg=what)
    plain = k1.ragged_reference(port["q"], port["k"], port["v"],
                                port["table"], st, ql, **port["sc"])
    pools64 = ((port["k"].double(), port["v"].double()) if kind == "bf16"
               else (port["k"], port["v"]))
    exact = k1.ragged_reference(port["q"].double(), *pools64, port["table"],
                                st, ql, **port["sc"])
    e_model, e_plain, ratio = CS._vs_fp64(model_out, plain, exact)
    assert ratio <= 2.0, (what, e_model, e_plain)
    share = CS.misround_share(model_out, plain, exact)
    assert share <= CS.MISROUND_GATE, (what, share)
    for b, n in enumerate(qlen):
        assert bool((model_out[b, n:] == 0).all()), (what, b)


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("n_rep,T,start,qlen", [
    (1, 16, [13, 40, 0], [16, 9, 0]),          # chunks at offsets, a dead slot
    (2, 8, [100, 3, 57], [8, 1, 5]),           # GQA spans above the decode rows
    (1, 40, [0, 200, 290], [40, 33, 1]),       # across 32-key tiles, 300+ keys
], ids=["chunk", "gqa", "long"])
def test_span_model_within_the_bf16_gates(kind, n_rep, T, start, qlen):
    rng = np.random.default_rng(sum(start) + 7 * T + n_rep)
    pages = -(-(max(start) + T) // PS) + 1
    port, jax_ops = _operands(rng, kind, len(start), T, n_rep, pages)
    st, ql = torch.tensor(start), torch.tensor(qlen)
    out = span_model(port, kind, st, ql)
    _held(out, port, jax_ops, kind, start, qlen, f"span {kind}")


@pytest.mark.parametrize("scales", [(1e-3, 1e-3), (1e3, 1e3), (1e-3, 1e3)],
                         ids=["small", "large", "spread"])
@pytest.mark.parametrize("form", ["span", "split"])
def test_int8_scales_at_their_extremes(scales, form):
    """int8 pages with scales at 1e-3 and 1e3 (and spread between): the
    score-side k scale and the v scale folded into P keep the gates."""
    rng = np.random.default_rng(int(scales[1]) + len(form))
    T, start, qlen = (24, [5, 60], [24, 17]) if form == "span" \
        else (4, [255, 300], [4, 2])
    pages = -(-(max(start) + T) // PS) + 1
    port, jax_ops = _operands(rng, "int8", len(start), T, 2, pages,
                              scale_range=scales)
    model = span_model if form == "span" else split_model
    out = model(port, "int8", torch.tensor(start), torch.tensor(qlen))
    _held(out, port, jax_ops, "int8", start, qlen, f"int8 {form} {scales}")


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("n_rep,T", [(1, 1), (2, 4), (1, 8)],
                         ids=["mha-decode", "gqa", "verify"])
def test_split_model_within_the_bf16_gates(kind, n_rep, T):
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


def test_split_merge_equals_one_walk_where_a_sequence_fits_one_split():
    """A sequence of at most KEYS_PER_SPLIT keys is one split: the merge
    of one state is that state (f = 1), so a split size above the table
    gives the same output bit for bit."""
    rng = np.random.default_rng(3)
    start, qlen = [0, 100, 250], [1, 1, 1]
    port, _ = _operands(rng, "bf16", 3, 1, 2, 17)
    a = split_model(port, "bf16", torch.tensor(start), torch.tensor(qlen))
    b = split_model(port, "bf16", torch.tensor(start), torch.tensor(qlen),
                    keys_per_split=17 * PS)
    assert torch.equal(a, b)


@pytest.mark.parametrize("P,ps", [(1, 16), (16, 16), (17, 16), (256, 16),
                                  (3, 5), (64, 1), (0, 16), (40, 32)])
def test_decode_splits_is_the_table_walk_over_the_split_size(P, ps):
    want = max(1, math.ceil(P * ps / 256))
    assert k1.KEYS_PER_SPLIT == 256
    assert k1.decode_splits(P, ps) == want


@pytest.mark.parametrize("B,n_kv,G,d,S", [(8, 8, 4, 128, 16),
                                          (8, 16, 8, 128, 2),
                                          (1, 32, 1, 256, 3),
                                          (4, 2, 8, 64, 1)])
def test_split_workspace_holds_acc_m_l_of_every_split_row(B, n_kv, G, d, S):
    """(acc [d], m, l) for each grouped row of each split of each (sequence,
    kv head); nothing where no walk can take two splits."""
    want = 0 if S == 1 else B * n_kv * S * G * (d + 2)
    assert k1.split_workspace_floats(B, n_kv, G, d, S) == want
