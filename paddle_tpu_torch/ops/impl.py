"""Plain PyTorch ops of the training paths (the part of
paddle_tpu/ops/impl.py that the dense Llama and ERNIE forwards and their
losses use), and the flash attention family over the K3 kernels.

Same signatures and semantics as the JAX functions of the same names:
layouts [b, s, h, d] for attention and rotary embeddings, [in, out] for
linear weights, fp32 statistics in rms_norm and layer_norm, and
cross-entropy means over the valid labels only. `dropout` draws from an
explicit torch.Generator where the JAX one takes a jax.random key: the
two streams differ.

`scaled_dot_product_attention` dispatches as the JAX function does, with
one difference on the card: where the JAX package quietly falls back to
its dense O(s^2) path, the port raises on CUDA tensors. With
FLAGS_use_flash_attention on, an attn_mask that broadcasts to
[b, 1|h, sq, sk] (or none) and shapes the flash kernels take, it runs
`ops.flash_attention` (the CUDA kernels on CUDA tensors, their plain
versions on CPU tensors); the kernels take any length, so the JAX
package's pad-to-128 branch has no counterpart. With the flag off (the
caller's explicit choice) it runs the dense path on either device.
`dropout_p` is ignored on every path, as it is in the JAX package.

AMP: every op here first casts its floating tensor inputs under its JAX op
name (`amp.state.cast_inputs`, the cast of the JAX registry's dispatch),
then computes as the JAX function does in the dtypes it was given: the
norms take fp32 statistics and cast back to x's dtype before the gain,
rotary_embedding computes with fp32 tables and returns q's dtype, and
mixed dtypes promote as jnp promotes them (bf16 with fp32 is fp32).
Outside auto_cast nothing is cast.

The rest of the flash family lowers onto the same kernels as in JAX:
`flash_attn_unpadded` (cu_seqlens -> segment ids), `flash_attn`,
`flash_attn_qkvpacked`, `flash_attn_varlen_qkvpacked`,
`flashmask_attention` (row ranges and windows -> an additive mask) and
`sparse_attention` (CSR -> an additive mask and a block mask).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.amp.state import cast_inputs
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.utils.flags import flag

NEG_INF = -1e30
_FRAMEWORK_ITEM = "ROADMAP.md 'Still to port' item 12 (the framework)"
_DROPOUT_ITEM = ("attention dropout is not in the flash kernels: ROADMAP.md "
                 "'Still to port' item 19 (attention dropout); train with "
                 "dropout=0.0")


def repeat_interleave(x, repeats, axis=None):
    (x,) = cast_inputs("repeat_interleave", x)
    return torch.repeat_interleave(x, repeats, dim=axis)


def swiglu(x, y=None):
    """silu(x) * y; with y None, x is split in two halves along its last
    axis (the fused swiglu op)."""
    x, y = cast_inputs("swiglu", x, y)
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y


def embedding(x, weight, padding_idx=None):
    (weight,) = cast_inputs("embedding", weight)
    out = F.embedding(x, weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return out


def tanh(x):
    (x,) = cast_inputs("tanh", x)
    return torch.tanh(x)


def gelu(x, approximate=False):
    """jax.nn.gelu: the tanh form with ``approximate``, else the erf form."""
    (x,) = cast_inputs("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def dropout(x, generator=None, p=0.5, training=True,
            mode="upscale_in_train"):
    """Paddle's dropout: in training each element is kept with probability
    1 - p (a uniform draw from ``generator`` below 1 - p, as
    jax.random.bernoulli draws) and scaled by 1 / (1 - p) in
    upscale_in_train; in inference x as it is, or x * (1 - p) in
    downscale_in_infer."""
    (x,) = cast_inputs("dropout", x)
    if p == 0.0:
        return x
    keep = 1.0 - p
    if not training:
        if mode == "downscale_in_infer":
            return (x * keep).to(x.dtype)
        return x
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    if mode == "upscale_in_train":
        x = x / keep
    return torch.where(kept, x, torch.zeros_like(x)).to(x.dtype)


def layer_norm(x, weight=None, bias=None, epsilon=1e-5, begin_norm_axis=-1):
    """Normalize over the trailing dims from begin_norm_axis with fp32
    statistics (mean, biased variance), cast back to x's dtype, then times
    weight plus bias, both shaped as those dims."""
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    if begin_norm_axis < 0:
        begin_norm_axis += x.dim()
    shape = tuple(x.shape[begin_norm_axis:])
    out = F.layer_norm(x.float(), shape, eps=epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def linear(x, weight, bias=None):
    """x @ weight (+ bias) with weight in the [in, out] layout."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def rms_norm(x, weight=None, epsilon=1e-6):
    """x / rms(x) with the statistics in fp32, cast back to x's dtype, then
    times weight."""
    x, weight = cast_inputs("rms_norm", x, weight)
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def matmul(x, y, transpose_x=False, transpose_y=False):
    """x @ y, either operand transposed over its last two axes first (the
    JAX `matmul` op; the tied heads of Llama and ERNIE call it)."""
    x, y = cast_inputs("matmul", x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def rotary_embedding(q, k, cos, sin, position_ids=None):
    """Rotate-half RoPE. q, k: [b, s, h, d]; cos, sin: [s, d] rows for
    positions 0..s-1, or, with integer ``position_ids`` [b, s], the table
    rows those ids name (the JAX `take`). The tables stay fp32 unless the
    AMP state casts them (O2), so q * cos promotes to fp32 and the result
    is cast back to q's dtype."""
    q, k, cos, sin = cast_inputs("rotary_embedding", q, k, cos, sin)
    if position_ids is not None:
        ids = torch.as_tensor(position_ids, device=cos.device).long()
        cos = cos[ids][:, :, None, :]
        sin = sin[ids][:, :, None, :]
    else:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    q_out = q * cos + _rotate_half(q) * sin
    k_out = k * cos + _rotate_half(k) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def _dense_attention(q, k, v, attn_mask, is_causal, scale):
    """The dense path: [b, h, sq, sk] scores, softmax probabilities in q's
    dtype, and rows with no visible key set to 0 (the flash kernels'
    masked-row semantics)."""
    sq, sk = q.shape[1], k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores,
                                 torch.full_like(scores, NEG_INF))
        else:
            scores = scores + attn_mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if is_causal or attn_mask is not None:
        row_live = (scores > NEG_INF * 0.5).any(dim=-1, keepdim=True)
        probs = torch.where(row_live, probs, torch.zeros_like(probs))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _mask_broadcasts(attn_mask, b, h, sq, sk) -> bool:
    """The JAX function's shape-only classification of an attn_mask the
    kernels take: rank 4, broadcastable to [b, 1|h, sq, sk]."""
    ms = tuple(attn_mask.shape)
    return (len(ms) == 4 and ms[0] in (1, b) and ms[1] in (1, h)
            and ms[2] in (1, sq) and ms[3] in (1, sk))


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, scale=None, *,
                                 cast_mask=True):
    """Attention over [b, s, h, d] operands (paddle's flash-attn layout).
    See the module docstring for the dispatch. Under AMP q, k, v and a
    floating attn_mask are cast as the op's inputs; ``cast_mask=False``
    leaves the mask as it is, as the JAX registry leaves a mask passed as
    a plain array and not a Tensor (ERNIE's additive key mask: it reaches
    the kernels in fp32 at every AMP level)."""
    q, k, v = cast_inputs("scaled_dot_product_attention", q, k, v)
    if cast_mask:
        (attn_mask,) = cast_inputs("scaled_dot_product_attention",
                                   attn_mask)
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if flag("FLAGS_use_flash_attention"):
        mask_ok = attn_mask is None or _mask_broadcasts(attn_mask, b, h, sq,
                                                        sk)
        if mask_ok and fa.flash_attention_ok(q, k, v):
            return fa.flash_attention(q, k, v, causal=is_causal, scale=scale,
                                      mask=attn_mask)
        if fa.on_card(q):
            if not mask_ok:
                raise ValueError(
                    f"scaled_dot_product_attention: the masked flash "
                    f"kernels (K3-m) take an attn_mask broadcastable to "
                    f"[b, 1|h, sq, sk] = [{b}, 1|{h}, {sq}, {sk}], got "
                    f"{tuple(attn_mask.shape)}; set_flags("
                    "{'FLAGS_use_flash_attention': False}) asks for the "
                    "dense path")
            raise ValueError(
                f"scaled_dot_product_attention: the flash kernels do not "
                f"take q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                f"{tuple(v.shape)} (head dim % 8 == 0 and <= 256, matching "
                "batch and heads); set_flags({'FLAGS_use_flash_attention': "
                "False}) asks for the dense path")
    return _dense_attention(q, k, v, attn_mask, is_causal, scale)


def flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False):
    """Varlen (packed) attention: q, k, v [total, h, d] hold several
    sequences one after another, cu_seqlens_* int [n + 1] their
    boundaries. The boundaries become per-token segment ids
    (searchsorted, side right) and the kernels attend only within a
    segment; with `causal`, q and k must share a packing. No padding: the
    kernels take any length."""
    q, k, v = cast_inputs("flash_attn_unpadded", q, k, v)
    tq, _, d = q.shape
    tk = k.shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if dropout:
        raise NotImplementedError(f"flash_attn_unpadded: {_DROPOUT_ITEM}")
    if causal and tq != tk:
        raise ValueError(
            "flash_attn_unpadded(causal=True) requires q and k to share a "
            f"packing (got {tq} vs {tk} total tokens): global causal over "
            "mismatched packings is not per-sequence causal")

    def segments(cu, n):
        cu = torch.as_tensor(cu, device=q.device).long()
        tokens = torch.arange(n, device=q.device)
        return torch.searchsorted(cu, tokens, right=True).int()[None]

    out = fa.flash_attention(
        q[None], k[None], v[None], causal=causal, scale=scale,
        segment_ids=(segments(cu_seqlens_q, tq), segments(cu_seqlens_k, tk)))
    return out[0]


def flash_attn(q, k, v, dropout=0.0, causal=False):
    """The base dense form: scaled_dot_product_attention's dispatch."""
    return scaled_dot_product_attention(q, k, v, dropout_p=dropout,
                                        is_causal=causal)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False):
    """Packed [b, s, 3, h, d] form."""
    return flash_attn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                      dropout=dropout, causal=causal)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q=None, max_seqlen_k=None,
                                scale=None, dropout=0.0, causal=False):
    """Packed varlen [total, 3, h, d] form over flash_attn_unpadded."""
    return flash_attn_unpadded(
        qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens_q, cu_seqlens_k,
        max_seqlen_q=max_seqlen_q, max_seqlen_k=max_seqlen_k, scale=scale,
        dropout=dropout, causal=causal)


def flashmask_attention(q, k, v, startend_row_indices=None, dropout=0.0,
                        causal=False, window_size=None):
    """FlashMask column-sparse masks: startend_row_indices int [b, 1|h, sk,
    {1, 2, 4}] gives each key column its masked row ranges (LTS; LTS, LTE;
    LTS, UTE; LTS, LTE, UTS, UTE), and window_size a sliding window. They
    expand to an additive NEG_INF mask [b, 1|h, sq, sk] that the kernels
    read tile by tile, as in the JAX package."""
    q, k, v = cast_inputs("flashmask_attention", q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    if dropout:
        raise NotImplementedError(f"flashmask_attention: {_DROPOUT_ITEM}")
    if startend_row_indices is None and window_size is None:
        return fa.flash_attention(q, k, v, causal=causal, scale=scale)
    i = torch.arange(sq, device=q.device)[None, None, :, None]   # row
    j = torch.arange(sk, device=q.device)[None, None, None, :]   # column
    masked = torch.zeros((1, 1, sq, sk), dtype=torch.bool, device=q.device)
    if startend_row_indices is not None:
        idx = torch.as_tensor(startend_row_indices, device=q.device).long()
        n = idx.shape[-1]

        def col(c):                                  # [b, kh, 1, sk]
            return idx[..., c][:, :, None, :]

        if causal:
            lts = col(0)
            lte = col(1) if n >= 2 else torch.full_like(lts, sq)
            masked = (i >= lts) & (i < lte)
        elif n == 2:
            lts, ute = col(0), col(1)
            masked = ((i > j) & (i >= lts)) | ((i < j) & (i < ute))
        elif n == 4:
            lts, lte, uts, ute = col(0), col(1), col(2), col(3)
            masked = (((i > j) & (i >= lts) & (i < lte))
                      | ((i < j) & (i >= uts) & (i < ute)))
        else:
            raise ValueError(f"startend_row_indices last dim {n} invalid "
                             f"for causal={causal}")
    if window_size is not None:
        w = ((window_size, window_size) if isinstance(window_size, int)
             else tuple(window_size))
        outside = (j < i - w[0]) if causal else ((j < i - w[0])
                                                | (j > i + w[1]))
        masked = masked | outside
    mask = torch.zeros(masked.shape, dtype=torch.float32,
                       device=q.device).masked_fill_(masked, NEG_INF)
    return fa.flash_attention(q, k, v, causal=causal, scale=scale, mask=mask)


def sparse_attention(q, k, v, offset, columns, key_padding_mask=None,
                     attn_mask=None):
    """CSR-pattern sparse attention over [b, h, M, d] operands: offset
    [b, h, M + 1] and columns [b, h, nnz] name each row's allowed keys.
    The pattern (with key_padding_mask [b, M], 1 = keep, and an additive or
    bool attn_mask composed in) becomes an additive NEG_INF mask read tile
    by tile and a block mask at the JAX kernel's 128-blocks (the whole
    length when M % 128 != 0), so dead blocks are skipped."""
    q, k, v, key_padding_mask, attn_mask = cast_inputs(
        "sparse_attention", q, k, v, key_padding_mask, attn_mask)
    b, h, M, _ = q.shape
    dev = q.device
    flat_off = torch.as_tensor(offset, device=dev).long().reshape(b * h,
                                                                 M + 1)
    flat_col = torch.as_tensor(columns, device=dev).long().reshape(b * h, -1)
    nnz = flat_col.shape[1]
    pos = torch.arange(nnz, device=dev).expand(b * h, nnz).contiguous()
    # the row of each CSR entry: the last r with offset[r] <= entry; the
    # entries past offset[-1] are padding and keep nothing
    rows = torch.searchsorted(flat_off, pos, right=True) - 1
    valid = pos < flat_off[:, -1:]
    bh = torch.arange(b * h, device=dev)[:, None].expand(b * h, nnz)
    keep = torch.zeros(b * h, M, M, dtype=torch.bool, device=dev)
    keep[bh[valid], rows[valid], flat_col[valid]] = True
    keep = keep.reshape(b, h, M, M)
    if key_padding_mask is not None:
        kpm = torch.as_tensor(key_padding_mask, device=dev)
        if kpm.dtype != torch.bool:
            kpm = kpm > 0
        keep = keep & kpm[:, None, None, :]
    mask = torch.zeros(keep.shape, dtype=torch.float32,
                       device=dev).masked_fill_(~keep, NEG_INF)
    if attn_mask is not None:
        am = torch.as_tensor(attn_mask, device=dev)
        if am.dtype == torch.bool:
            am = torch.zeros(am.shape, dtype=torch.float32,
                             device=dev).masked_fill_(~am, NEG_INF)
        mask = mask + am.float()
    keep = keep & (mask > NEG_INF * 0.5)
    block = fa.JAX_BLOCK if M % fa.JAX_BLOCK == 0 else M
    nb = M // block
    block_mask = keep.reshape(b * h, nb, block, nb, block).any(4).any(2) \
        .any(0).int()
    out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=False, mask=mask,
                             block_mask=block_mask)
    return out.transpose(1, 2)


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100):
    """Per-example loss -log_softmax(logits)[label], 0 where label ==
    ignore_index; the label may carry a trailing axis of 1."""
    if soft_label:
        raise NotImplementedError(f"soft_label: {_FRAMEWORK_ITEM}")
    (logits,) = cast_inputs("softmax_with_cross_entropy", logits)
    return _softmax_with_cross_entropy(logits, label, axis, ignore_index)


def _softmax_with_cross_entropy(logits, label, axis, ignore_index):
    axis = axis % logits.dim()
    logp = torch.log_softmax(logits, dim=axis)
    lab = label.squeeze(axis) if label.dim() == logits.dim() else label
    lab = lab.long()
    picked = torch.gather(logp, axis, lab.clamp_min(0).unsqueeze(axis))
    loss = -picked
    return torch.where((lab == ignore_index).unsqueeze(axis),
                       torch.zeros_like(loss), loss)


def cross_entropy(logits, label, soft_label=False, axis=-1,
                  ignore_index=-100, reduction="mean", weight=None,
                  label_smoothing=0.0):
    """Hard-label cross-entropy; the mean divides by the count of labels
    that are not ignore_index."""
    if soft_label or weight is not None or label_smoothing > 0.0:
        raise NotImplementedError(
            f"cross_entropy(soft_label / weight / label_smoothing): "
            f"{_FRAMEWORK_ITEM}")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    (logits,) = cast_inputs("cross_entropy", logits)
    loss = _softmax_with_cross_entropy(logits, label, axis, ignore_index)
    if reduction == "mean":
        axis = axis % logits.dim()
        lab = label.squeeze(axis) if label.dim() == logits.dim() else label
        valid = (lab != ignore_index).to(logits.dtype).sum()
        return loss.sum() / valid.clamp_min(1e-8)
    if reduction == "sum":
        return loss.sum()
    return loss
