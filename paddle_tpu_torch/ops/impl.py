"""Plain PyTorch ops of the training path (the part of
paddle_tpu/ops/impl.py that the dense Llama forward and its loss use).

Same signatures and semantics as the JAX functions of the same names:
layouts [b, s, h, d] for attention and rotary embeddings, [in, out] for
linear weights, fp32 statistics in rms_norm, and cross-entropy means over
the valid labels only.

`scaled_dot_product_attention` dispatches as the JAX function does, with
one difference on the card: where the JAX package quietly falls back to
its dense O(s^2) path, the port raises on CUDA tensors. With
FLAGS_use_flash_attention on, no attn_mask and shapes the flash kernels
take, it runs `ops.flash_attention` (the CUDA kernels on CUDA tensors,
their plain versions on CPU tensors). With the flag off (the caller's
explicit choice) it runs the dense path on either device. `dropout_p` is
ignored on every path, as it is in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.utils.flags import flag

NEG_INF = -1e30
_FRAMEWORK_ITEM = "ROADMAP.md 'Still to port' item 12 (the framework)"


def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def swiglu(x, y=None):
    """silu(x) * y; with y None, x is split in two halves along its last
    axis (the fused swiglu op)."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y


def embedding(x, weight, padding_idx=None):
    out = F.embedding(x, weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return out


def linear(x, weight, bias=None):
    """x @ weight (+ bias) with weight in the [in, out] layout."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def rms_norm(x, weight=None, epsilon=1e-6):
    """x / rms(x) with the statistics in fp32, cast back to x's dtype, then
    times weight."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rotary_embedding(q, k, cos, sin):
    """Rotate-half RoPE at positions 0..s-1. q, k: [b, s, h, d]; cos, sin:
    [s, d]."""
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


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, scale=None):
    """Attention over [b, s, h, d] operands (paddle's flash-attn layout).
    See the module docstring for the dispatch."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if flag("FLAGS_use_flash_attention"):
        if attn_mask is None and fa.flash_attention_ok(q, k, v):
            return fa.flash_attention(q, k, v, causal=is_causal, scale=scale)
        if fa.on_card(q):
            if attn_mask is not None:
                raise NotImplementedError(
                    f"scaled_dot_product_attention(attn_mask=...) on CUDA: "
                    f"{fa.MASKED_FORMS}; set_flags("
                    "{'FLAGS_use_flash_attention': False}) asks for the "
                    "dense path")
            raise ValueError(
                f"scaled_dot_product_attention: the flash kernels do not "
                f"take q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                f"{tuple(v.shape)} (head dim % 8 == 0 and <= 256, matching "
                "batch and heads); set_flags({'FLAGS_use_flash_attention': "
                "False}) asks for the dense path")
    return _dense_attention(q, k, v, attn_mask, is_causal, scale)


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100):
    """Per-example loss -log_softmax(logits)[label], 0 where label ==
    ignore_index; the label may carry a trailing axis of 1."""
    if soft_label:
        raise NotImplementedError(f"soft_label: {_FRAMEWORK_ITEM}")
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
    loss = softmax_with_cross_entropy(logits, label, axis=axis,
                                      ignore_index=ignore_index)
    if reduction == "mean":
        axis = axis % logits.dim()
        lab = label.squeeze(axis) if label.dim() == logits.dim() else label
        valid = (lab != ignore_index).to(logits.dtype).sum()
        return loss.sum() / valid.clamp_min(1e-8)
    if reduction == "sum":
        return loss.sum()
    return loss
