"""The port's masked flash forms (K3-m) against the JAX package's, on the
CPU.

The same seeded numpy inputs go through the JAX Pallas kernels in
interpret mode (`_flash_forward`, `_flash_backward`, and the public
`flash_attention` with its custom VJP) and through the port's plain
versions, which the wrappers run on CPU tensors. Every masking form:

  * a per-key bias (ERNIE's -1e4 soft padding, and a hard NEG_INF one);
  * a dense additive mask shared by the heads (mh = 1) and per head;
  * a bool mask with fully masked rows: exact zeros, zero gradient;
  * segment ids with causal, also with sq != sk;
  * a block mask implied by a dense mask, one that is not (the JAX
    kernel's 128-block granularity decides), a query shorter than a
    block, and the two cases where JAX ignores the block mask (lengths
    that do not tile its blocks, causal sq > sk).

Plain forward (o, lse) against the kernels at atol = rtol = 1e-5, plain
dq/dk/dv within 1e-4 * max|g|; the autograd.Function against jax.grad
through the public function. Then the entry points: flash_attn_unpadded
(per sequence, and against the JAX function), the four
flashmask_attention forms and window_size, sparse_attention with and
without key_padding_mask, scaled_dot_product_attention with an attn_mask
at seq 300 (where the JAX function pads to 128), and what the card-side
dispatch refuses (`on_card` patched).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.impl as jax_impl
import paddle_tpu.ops.pallas.flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import impl

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# tiny shapes: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

ATOL = RTOL = 1e-5
GRAD_TOL = 1e-4
NEG = np.float32(fa.NEG_INF)


def _qkv(rng, b, sq, sk, h, d):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, sq, h, d), f(b, sk, h, d), f(b, sk, h, d), f(b, sq, h, d)


def _valid(rng, b, s, lo):
    """[b, s] bool: each row's first lengths drawn from [lo, s] are real."""
    lens = rng.integers(lo, s + 1, b)
    return np.arange(s)[None, :] < lens[:, None]


# each form: (b, sq, sk, h, d, causal) and the function that draws its
# canonical masking operands (numpy) from a generator
def _kbias_soft(rng, b, sq, sk, h):
    return dict(kbias=((1.0 - _valid(rng, b, sk, sk * 3 // 4))
                       * -1e4).astype(np.float32))


def _kbias_hard(rng, b, sq, sk, h):
    return dict(kbias=np.where(_valid(rng, b, sk, sk // 2), 0.0, NEG)
                .astype(np.float32))


def _mask_shared(rng, b, sq, sk, h):
    return dict(mask=(rng.standard_normal((b, 1, sq, sk)) * 2)
                .astype(np.float32))


def _mask_per_head(rng, b, sq, sk, h):
    m = rng.standard_normal((b, h, sq, sk)).astype(np.float32)
    m[rng.random(m.shape) < 0.3] = NEG
    m[..., 0] = 0.0                              # no row is fully masked
    return dict(mask=m)


def _bool_dead_rows(rng, b, sq, sk, h):
    keep = rng.random((b, 1, sq, sk)) < 0.7
    keep[:, :, sq // 2:] = False                 # rows that see no key
    return dict(mask=np.where(keep, 0.0, NEG).astype(np.float32))


def _segments(rng, b, sq, sk, h):
    cut = lambda s, n: np.sort(rng.integers(1, s, (b, n)), 1)  # noqa: E731
    qseg = (np.arange(sq)[None, :, None] >= cut(sq, 3)[:, None, :]).sum(-1)
    kseg = (np.arange(sk)[None, :, None] >= cut(sk, 3)[:, None, :]).sum(-1)
    return dict(qseg=qseg.astype(np.int32), kseg=kseg.astype(np.int32))


def _block_implied(rng, b, sq, sk, h):
    """A dense mask that hides the (0, 1) and (1, 0) 128-blocks, and the
    block mask it implies."""
    m = _mask_shared(rng, b, sq, sk, h)["mask"]
    bm = np.array([[1, 0], [0, 1]], np.int32)
    m[:, :, :128, 128:] = NEG
    m[:, :, 128:, :128] = NEG
    return dict(mask=m, block_mask=bm)


def _block_only(rng, b, sq, sk, h):
    """A block mask no element mask implies: the kernel's granularity
    alone decides which pairs count."""
    nq, nk = sq // min(128, sq), sk // min(128, sk)
    bm = (rng.random((nq, nk)) < 0.6).astype(np.int32)
    bm[:, 0] = 1                                 # every row sees a block
    bm[-1, -1] = 0                               # and one block is dead
    return dict(block_mask=bm)


FORMS = {
    "kbias_soft_ernie": ((2, 128, 128, 2, 64, False), _kbias_soft),
    "kbias_hard_causal": ((2, 256, 256, 2, 32, True), _kbias_hard),
    "mask_mh1": ((2, 128, 128, 2, 32, False), _mask_shared),
    "mask_mhh_causal": ((1, 256, 256, 2, 64, True), _mask_per_head),
    "bool_dead_rows": ((1, 128, 128, 2, 32, False), _bool_dead_rows),
    "segments_causal": ((2, 256, 256, 2, 64, True), _segments),
    "segments_cross": ((2, 128, 256, 1, 32, True), _segments),
    "block_implied": ((1, 256, 256, 2, 32, False), _block_implied),
    "block_only": ((2, 256, 256, 1, 64, False), _block_only),
    "block_short_q": ((1, 64, 256, 2, 32, False), _block_only),
}
_OPERANDS = ("mask", "kbias", "qseg", "kseg", "block_mask")


def _form(name, seed):
    (b, sq, sk, h, d, causal), build = FORMS[name]
    rng = np.random.default_rng(seed)
    q, k, v, do = _qkv(rng, b, sq, sk, h, d)
    return q, k, v, do, causal, build(rng, b, sq, sk, h)


def _jax_ops(ops):
    return [None if ops.get(n) is None else jnp.asarray(ops[n])
            for n in _OPERANDS]


def _torch_ops(ops):
    return {n: torch.from_numpy(a) for n, a in ops.items()}


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_forward(q, k, v, ops, causal):
    scale = 1.0 / math.sqrt(q.shape[-1])
    bq, bk = fa.jax_blocks(q.shape[1], k.shape[1])
    o, lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *_jax_ops(ops),
        causal, scale, bq, bk, True, with_lse=True)
    b, sq, h, _ = q.shape
    return np.asarray(o), np.asarray(lse)[..., 0].reshape(b, h, sq), lse


def _assert_grads(ours, refs):
    for name, a, r in zip(("dq", "dk", "dv"), ours, refs):
        a, r = np.asarray(a), np.asarray(r)
        err = np.abs(a - r).max()
        assert err <= GRAD_TOL * max(np.abs(r).max(), 1e-30), (name, err)


@pytest.mark.parametrize("name", sorted(FORMS))
def test_plain_forward_matches_pallas_kernel(name):
    q, k, v, _, causal, ops = _form(name, 1)
    o_ref, lse_ref, _ = _jax_forward(q, k, v, ops, causal)
    o, lse = fa.flash_forward_reference(*_t(q, k, v), causal,
                                        **_torch_ops(ops))
    np.testing.assert_allclose(o.numpy(), o_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(FORMS))
def test_plain_backward_matches_pallas_kernels(name):
    q, k, v, do, causal, ops = _form(name, 2)
    o, lse, lse_lanes = _jax_forward(q, k, v, ops, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    bq, bk = fa.jax_blocks(q.shape[1], k.shape[1])
    ref = jfa._flash_backward(
        *(jnp.asarray(a) for a in (q, k, v, o, do)), lse_lanes,
        *_jax_ops(ops), causal, scale, bq, bk, True)
    ours = fa.flash_backward_reference(*_t(q, k, v, o, do, lse), causal,
                                       **_torch_ops(ops))
    _assert_grads(ours, ref)


def _public_ops(ops):
    """The masking operands as the public functions take them: the mask
    as given (kbias as its [b, 1, 1, sk] key-padding form), segment ids
    as a pair, the block mask."""
    kw = {}
    if "mask" in ops:
        kw["mask"] = ops["mask"]
    if "kbias" in ops:
        kw["mask"] = ops["kbias"][:, None, None, :]
    if "qseg" in ops:
        kw["segment_ids"] = (ops["qseg"], ops["kseg"])
    if "block_mask" in ops:
        kw["block_mask"] = ops["block_mask"]
    return kw


def _both_public(q, k, v, w, causal, kw):
    """(o, grads) of sum(o * w) through the JAX public flash_attention
    (interpret mode) and through the port's."""
    jkw = {n: (tuple(jnp.asarray(a) for a in x) if isinstance(x, tuple)
               else jnp.asarray(x)) for n, x in kw.items()}

    def jax_loss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, interpret=True,
                                **jkw)
        return jnp.sum(o * jnp.asarray(w)), o

    (_, jo), jg = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                     has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tkw = {n: (tuple(torch.from_numpy(a) for a in x) if isinstance(x, tuple)
               else torch.from_numpy(x)) for n, x in kw.items()}
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=causal, **tkw)
    grads = torch.autograd.grad((o * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    return (o.detach().numpy(), grads), (np.asarray(jo), jg)


@pytest.mark.parametrize("name", sorted(FORMS))
def test_autograd_function_matches_jax_grad_through_flash(name):
    q, k, v, w, causal, ops = _form(name, 3)
    fa.reset_counts()
    (o, grads), (jo, jgrads) = _both_public(q, k, v, w, causal,
                                            _public_ops(ops))
    np.testing.assert_allclose(o, jo, rtol=RTOL, atol=ATOL)
    _assert_grads(grads, jgrads)
    assert {n: (c.kernel_launches, c.plain_launches)
            for n, c in fa.counts_for(True).items()} == \
        dict.fromkeys(fa.counts_for(True), (0, 1))


def test_fully_masked_rows_are_exact_zeros_with_zero_gradient():
    """A bool mask (True = attend) whose second half of rows sees nothing:
    o and dq exactly 0 there, dk and dv untouched by those rows."""
    rng = np.random.default_rng(4)
    q, k, v, w = _qkv(rng, 1, 128, 128, 2, 32)
    keep = rng.random((1, 1, 128, 128)) < 0.7
    keep[:, :, 64:] = False
    (o, (dq, dk, dv)), (jo, jg) = _both_public(q, k, v, w, False,
                                               {"mask": keep})
    np.testing.assert_allclose(o, jo, rtol=RTOL, atol=ATOL)
    _assert_grads((dq, dk, dv), jg)
    assert (o[:, 64:] == 0).all() and (dq[:, 64:] == 0).all()
    assert np.isfinite(o).all() and torch.isfinite(dk).all()
    _, lse = fa.flash_forward_reference(
        *_t(q, k, v), False,
        mask=fa.canon_mask(torch.from_numpy(keep), 1, 2, 128, 128)[0])
    assert (lse[..., 64:] == NEG).all()


@pytest.mark.parametrize("case", ["untiled_192", "causal_sq_gt_sk"])
def test_block_mask_is_ignored_where_jax_ignores_it(case):
    """An all-dead block mask: where the JAX function takes `_reference`
    (lengths that do not tile 128, or causal sq > sk) it is ignored, so
    the port gives the dense result too."""
    sq, sk, causal = {"untiled_192": (192, 192, False),
                      "causal_sq_gt_sk": (256, 128, True)}[case]
    rng = np.random.default_rng(5)
    q, k, v, w = _qkv(rng, 1, sq, sk, 2, 32)
    bm = np.zeros((sq // min(128, sq), sk // min(128, sk)), np.int32)
    tq, tk, tv = _t(q, k, v)
    assert not fa.block_mask_applies(tq, tk, tv, causal)
    (o, grads), (jo, jg) = _both_public(q, k, v, w, causal,
                                        {"block_mask": bm})
    np.testing.assert_allclose(o, jo, rtol=RTOL, atol=ATOL)
    _assert_grads(grads, jg)
    dense = fa.flash_forward_reference(tq, tk, tv, causal)[0].numpy()
    np.testing.assert_allclose(o, dense, rtol=RTOL, atol=ATOL)
    assert np.abs(o).max() > 0


def test_block_mask_shape_off_the_grid_raises_as_in_jax():
    q = torch.zeros(1, 256, 2, 8)
    bm = np.ones((1, 2), np.int32)
    with pytest.raises(ValueError, match="tile grid"):
        fa.flash_attention(q, q, q, block_mask=bm)
    with pytest.raises(ValueError, match="tile grid"):
        jfa.flash_attention(jnp.zeros((1, 256, 2, 8)), jnp.zeros((1, 256, 2,
                                                                   8)),
                            jnp.zeros((1, 256, 2, 8)), block_mask=bm)


def test_mask_canonical_forms_match_jax():
    """_canon_mask and _canon_segments: bool to NEG_INF, rank 2 and 3,
    key padding to kbias, per-head masks kept per head."""
    rng = np.random.default_rng(6)
    b, h, sq, sk = 2, 3, 8, 12
    for m in (rng.random((sq, sk)) < 0.5, rng.standard_normal((b, sq, sk)),
              rng.standard_normal((b, 1, 1, sk)),
              rng.standard_normal((1, h, sq, sk)),
              rng.random((b, 1, sq, sk)) < 0.5):
        jm, jb = jfa._canon_mask(jnp.asarray(m), b, h, sq, sk)
        tm, tb = fa.canon_mask(torch.from_numpy(m), b, h, sq, sk)
        for ours, ref in ((tm, jm), (tb, jb)):
            assert (ours is None) == (ref is None)
            if ref is not None:
                assert ours.dtype == torch.float32
                np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    segs = rng.integers(0, 3, (b, sq))
    for ours, ref in zip(fa.canon_segments(torch.from_numpy(segs), b, sq, sq),
                         jfa._canon_segments(jnp.asarray(segs), b, sq, sq)):
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# ------------------------------------------------------------ entry points


def test_flash_attn_unpadded_per_sequence_and_against_jax():
    rng = np.random.default_rng(7)
    h, d, lens = 2, 32, [48, 80, 33]
    cu = np.cumsum([0] + lens).astype(np.int32)
    q, k, v = (rng.standard_normal((sum(lens), h, d)).astype(np.float32)
               for _ in range(3))
    ours = impl.flash_attn_unpadded(*_t(q, k, v, cu, cu), causal=True)
    ref = jax_impl.flash_attn_unpadded(
        *(jnp.asarray(a) for a in (q, k, v, cu, cu)), causal=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    for i in range(len(lens)):
        sl = slice(cu[i], cu[i + 1])
        seq = jfa._reference(*(jnp.asarray(a[sl])[None] for a in (q, k, v)),
                             True, 1 / math.sqrt(d))[0]
        np.testing.assert_allclose(ours[sl].numpy(), np.asarray(seq),
                                   rtol=RTOL, atol=ATOL, err_msg=str(i))
    # packed variants, and grads through the segment-id form
    qkv = np.stack([q, k, v], axis=1)
    np.testing.assert_allclose(
        impl.flash_attn_varlen_qkvpacked(*_t(qkv, cu, cu), causal=True)
        .numpy(), ours.numpy(), rtol=RTOL, atol=ATOL)
    tq = torch.from_numpy(q).requires_grad_()
    impl.flash_attn_unpadded(tq, *_t(k, v, cu, cu)).sum().backward()
    assert torch.isfinite(tq.grad).all() and tq.grad.abs().max() > 0
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*19"):
        impl.flash_attn_unpadded(*_t(q, k, v, cu, cu), dropout=0.1)
    with pytest.raises(ValueError, match="share a packing"):
        impl.flash_attn_unpadded(*_t(q, k[:-1], v[:-1], cu, cu), causal=True)


def test_flash_attn_packed_matches_jax():
    rng = np.random.default_rng(8)
    qkv = rng.standard_normal((1, 128, 3, 2, 32)).astype(np.float32)
    ours = impl.flash_attn_qkvpacked(torch.from_numpy(qkv), causal=True)
    ref = jax_impl.flash_attn_qkvpacked(jnp.asarray(qkv), causal=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _startend(rng, b, kh, s, n):
    lo = rng.integers(0, s + 1, (b, kh, s, 1))
    hi = np.maximum(lo, rng.integers(0, s + 1, (b, kh, s, 1)))
    cols = [lo, hi, np.minimum(lo, hi // 2), hi][:n] if n == 4 else \
        [lo, hi][:n]
    return np.concatenate(cols, axis=-1).astype(np.int32)


@pytest.mark.parametrize("form", [
    "causal_lts", "causal_lts_lte", "full_lts_ute", "full_4col",
    "causal_window", "full_window_pair"])
def test_flashmask_attention_matches_jax(form):
    rng = np.random.default_rng(9)
    b, s, h, d = 1, 128, 2, 32
    q, k, v, _ = _qkv(rng, b, s, s, h, d)
    causal = form.startswith("causal")
    idx, window = None, None
    if form == "causal_lts":
        idx = _startend(rng, b, 1, s, 1)
    elif form == "causal_lts_lte":
        idx = _startend(rng, b, h, s, 2)
    elif form == "full_lts_ute":
        idx = _startend(rng, b, 1, s, 2)
    elif form == "full_4col":
        idx = _startend(rng, b, h, s, 4)
    elif form == "causal_window":
        window = 16
    else:
        window = (8, 24)
    ours = impl.flashmask_attention(
        *_t(q, k, v), None if idx is None else torch.from_numpy(idx),
        causal=causal, window_size=window)
    ref = jax_impl.flashmask_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        None if idx is None else jnp.asarray(idx), causal=causal,
        window_size=window)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _csr(rng, b, h, M):
    """Per (b, h) row: a local window of 16 keys in the row's own
    128-block plus two global keys; the (0, 1) block stays empty."""
    offset = np.zeros((b, h, M + 1), np.int64)
    cols = []
    for bi in range(b):
        for hi in range(h):
            row_cols = []
            for r in range(M):
                blk = (r // 128) * 128
                c = {blk + (r - blk) // 16 * 16 + j for j in range(16)}
                c |= {int(x) for x in rng.integers(0, blk + 1, 2)}
                row_cols.append(sorted(c))
            offset[bi, hi, 1:] = np.cumsum([len(c) for c in row_cols])
            cols.append(np.concatenate(row_cols))
    nnz = max(len(c) for c in cols) + 5           # padded entries at the end
    columns = np.zeros((b * h, nnz), np.int64)
    for i, c in enumerate(cols):
        columns[i, :len(c)] = c
    return offset, columns.reshape(b, h, nnz)


@pytest.mark.parametrize("with_kpm", [False, True], ids=["plain", "kpm"])
def test_sparse_attention_matches_jax(with_kpm):
    rng = np.random.default_rng(10)
    b, h, M, d = 1, 2, 256, 32
    q, k, v = (rng.standard_normal((b, h, M, d)).astype(np.float32)
               for _ in range(3))
    offset, columns = _csr(rng, b, h, M)
    kpm = (_valid(rng, b, M, 200).astype(np.int64) if with_kpm else None)
    extra = {} if kpm is None else {"key_padding_mask": kpm}
    fa.reset_counts()
    ours = impl.sparse_attention(
        *_t(q, k, v, offset, columns),
        **{n: torch.from_numpy(a) for n, a in extra.items()})
    ref = jax_impl.sparse_attention(
        *(jnp.asarray(a) for a in (q, k, v, offset, columns)),
        **{n: jnp.asarray(a) for n, a in extra.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert fa.counts_for(True)["flash_forward"].plain_launches == 1


def test_sdpa_mask_at_seq_300_matches_jax_pad_to_128(monkeypatch):
    """At seq 300 the JAX function pads to 384 and masks the padded keys
    (its kernel tiles 128); the port's kernels take 300 as it is."""
    rng = np.random.default_rng(11)
    q, k, v, _ = _qkv(rng, 2, 300, 300, 2, 32)
    mask = np.where(rng.random((2, 1, 1, 300)) > 0.2, 0.0, -1e30) \
        .astype(np.float32)
    seen = []
    orig = jfa.flash_attention

    def spy(*a, **kw):
        seen.append(tuple(a[0].shape))
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(jax_impl, "_flash_enabled", lambda: True)
    monkeypatch.setattr(jfa, "flash_attention", spy)
    ref = jax_impl.scaled_dot_product_attention(
        *(jnp.asarray(a) for a in (q, k, v, mask)))
    assert seen == [(2, 384, 2, 32)]
    before = fa.counts_for(True)["flash_forward"].plain_launches
    ours = impl.scaled_dot_product_attention(*_t(q, k, v, mask))
    assert fa.counts_for(True)["flash_forward"].plain_launches == before + 1
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_ops_of_the_ernie_path_match_jax():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    w, bias = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    t, j = torch.from_numpy, jnp.asarray
    pairs = [(impl.gelu(t(x)), jax_impl.gelu(j(x))),
             (impl.gelu(t(x), approximate=True),
              jax_impl.gelu(j(x), approximate=True)),
             (impl.tanh(t(x)), jax_impl.tanh(j(x))),
             (impl.layer_norm(t(x), t(w), t(bias)),
              jax_impl.layer_norm(j(x), j(w), j(bias))),
             (impl.layer_norm(t(x), epsilon=1e-3),
              jax_impl.layer_norm(j(x), epsilon=1e-3))]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    x2 = x.reshape(2, 5, 4, 4)
    np.testing.assert_allclose(
        impl.layer_norm(t(x2), t(w), t(bias), begin_norm_axis=2).numpy(),
        np.asarray(jax_impl.layer_norm(j(x2), j(w), j(bias),
                                       begin_norm_axis=2)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_modes(mode):
    """The draw differs from jax.random (a torch.Generator stream), so the
    kept share and the scaling are checked, and inference against JAX."""
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(0)
    y = impl.dropout(x, gen, p=0.25, training=True, mode=mode)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    scale = 1 / 0.75 if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(y[y != 0].numpy(), scale, rtol=1e-6)
    again = impl.dropout(x, torch.Generator().manual_seed(0), p=0.25,
                         training=True, mode=mode)
    assert torch.equal(y, again)
    ref = jax_impl.dropout(jnp.ones((200, 500)), jax.random.key(0), p=0.25,
                           training=False, mode=mode)
    np.testing.assert_allclose(
        impl.dropout(x, gen, p=0.25, training=False, mode=mode).numpy(),
        np.asarray(ref))
    assert impl.dropout(x, gen, p=0.0) is x


# ------------------------------------------------------------ on the card


@pytest.fixture
def on_the_card(monkeypatch):
    """The dispatch as it runs on CUDA tensors, checked before any launch
    (the kernels themselves are tests/test_torch_cuda.py's)."""
    monkeypatch.setattr(fa, "on_card", lambda t: True)


@pytest.mark.parametrize("shape", [(8, 8), (2, 8, 8), (1, 1, 1, 1, 8),
                                   (3, 1, 8, 8)],
                         ids=["rank2", "rank3", "rank5", "batch3"])
def test_masks_the_kernels_do_not_take_raise_on_the_card(on_the_card,
                                                         shape):
    q = torch.zeros(2, 8, 2, 8)
    with pytest.raises(ValueError, match="K3-m.*FLAGS_use_flash_attention"):
        impl.scaled_dot_product_attention(q, q, q,
                                          attn_mask=torch.zeros(shape))


def test_masked_wrappers_refuse_before_any_launch_on_the_card(on_the_card):
    q = torch.zeros(1, 8, 2, 12)
    with pytest.raises(ValueError, match="d % 8 == 0"):
        fa.flash_forward(q, q, q, kbias=torch.zeros(1, 8))
    q = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="kbias"):
        fa.flash_forward(q, q, q, kbias=torch.zeros(1, 9))
    with pytest.raises(ValueError, match="mask"):
        fa.flash_forward(q, q, q, mask=torch.zeros(1, 3, 8, 8))
    with pytest.raises(ValueError, match="come together"):
        fa.flash_forward(q, q, q, qseg=torch.zeros(1, 8, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        fa.flash_forward(q, q, q, qseg=torch.zeros(1, 8),
                         kseg=torch.zeros(1, 8))
    with pytest.raises(TypeError, match="fp32"):
        fa.flash_forward(q, q, q, kbias=torch.zeros(1, 8,
                                                    dtype=torch.float64))
    with pytest.raises(ValueError, match="does not tile"):
        fa.flash_forward(torch.zeros(1, 192, 2, 8), q, q,
                         block_mask=torch.ones(1, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_forward(q, q, q,
                         mask=torch.zeros(1, 1, 8, 8).transpose(2, 3))
