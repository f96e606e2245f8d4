"""Flash attention, forward and backward: the training path's dense
attention kernels (K3a, K3b-dq, K3b-dkv).

Counterpart of paddle_tpu/ops/pallas/flash_attention.py for the dense
forms (no additive mask, kv bias, segment ids or block mask), causal or
not. Layout [b, s, h, d] for q, k, v and o; causal masking is bottom-right
aligned (query i sees keys j <= i + sk - sq), so with sq > sk the first
rows see no key and come out as exact zeros with zero gradient. The
forward writes the per-row log-sum-exp as fp32 [b, h, sq] (the JAX
kernel's trailing LSE_LANES broadcast is a TPU layout detail, dropped
here).

  flash_attention           the entry point: FlashAttention.apply
  FlashAttention            torch.autograd.Function tying the forward
                            kernel (with LSE) to the two backward kernels,
                            as the custom VJP `_flash` ties them in JAX
  flash_forward             wrapper of K3a -> (o, lse)
  flash_backward            wrappers of K3b-dq and K3b-dkv -> (dq, dk, dv);
                            delta = rowsum(dO * O) is plain torch before
                            the two launches, as in JAX
  flash_forward_reference   plain PyTorch versions with the kernels' exact
  flash_backward_reference  contract (masked-row guard, 1e-30 clamps);
                            the backward is flash_backward_dq_reference and
                            flash_backward_dkv_reference over one delta
  flash_attention_ok        the kernels' shape gate

On CUDA tensors the wrappers launch the hand-written kernels in
csrc/flash_attention.cu or raise; on CPU tensors they run the plain
versions. `COUNTS` holds one LaunchCounts per kernel.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.ops._build import (
    LaunchCounts, check, library, require_launchable,
)

NEG_INF = -1e30
# scores at or below this are hard-masked and give p = 0 exactly
MASKED_BELOW = NEG_INF * 0.5
# the widest head the kernels take (two instantiations: d <= 128, <= 256)
MAX_HEAD_DIM = 256
MASKED_FORMS = ("the masked flash forms are not ported yet: ROADMAP.md "
                "'Still to port' item 2a (K3-m)")

COUNTS = {"flash_forward": LaunchCounts(),
          "flash_backward_dq": LaunchCounts(),
          "flash_backward_dkv": LaunchCounts()}


def flash_attention_ok(q, k, v) -> bool:
    """Whether the kernels take these operands: [b, s, h, d] with matching
    batch, heads and head dim, v shaped as k, any sq, sk >= 1, and d a
    multiple of 8 up to 256."""
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        return False
    b, sq, h, d = q.shape
    return (k.shape[0] == b and k.shape[2] == h and k.shape[3] == d
            and sq >= 1 and k.shape[1] >= 1 and d % 8 == 0
            and d <= MAX_HEAD_DIM)


def on_card(t) -> bool:
    """Whether ``t`` lies on the card, where only the kernels run (the one
    place the wrappers and the SDPA dispatch read a tensor's device)."""
    return t.device.type == "cuda"


def _scale(q, scale):
    return float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _scores(q, k, causal, scale):
    """[b, h, sq, sk] fp32 scaled scores, NEG_INF where the causal mask
    hides a key."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(
            sk - sq)
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def _guarded_exp(s, m):
    """exp(s - m), but exactly 0 where s is hard-masked (on a row that sees
    no key, m is NEG_INF too and the exp would be 1)."""
    return torch.where(s <= MASKED_BELOW, torch.zeros_like(s),
                       torch.exp(s - m))


def flash_forward_reference(q, k, v, causal=True, scale=None):
    """Plain version of K3a: (o [b, sq, h, d] in q's dtype, lse [b, h, sq]
    fp32), o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30))."""
    scale = _scale(q, scale)
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = _guarded_exp(s, m)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / den
    lse = (m + torch.log(den)).squeeze(-1)
    return o.transpose(1, 2).to(q.dtype).contiguous(), lse


def _backward_p_ds(q, k, v, do, lse, delta, causal, scale):
    """P recomputed from lse, and dS = P * (dO V^T - delta)."""
    s = _scores(q, k, causal, scale)
    p = _guarded_exp(s, lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.float()[..., None])


def flash_backward_dq_reference(q, k, v, do, lse, delta, causal=True,
                                scale=None):
    """Plain version of K3b-dq: dq = scale * dS K, [b, sq, h, d]."""
    scale = _scale(q, scale)
    _, ds = _backward_p_ds(q, k, v, do, lse, delta, causal, scale)
    return (scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
            ).to(q.dtype)


def flash_backward_dkv_reference(q, k, v, do, lse, delta, causal=True,
                                 scale=None):
    """Plain version of K3b-dkv: (dk = scale * dS^T Q, dv = P^T dO),
    [b, sk, h, d] each."""
    scale = _scale(q, scale)
    p, ds = _backward_p_ds(q, k, v, do, lse, delta, causal, scale)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def backward_delta(o, do):
    """delta = rowsum(dO * O) as fp32 [b, h, sq], the per-row term both
    backward kernels read (plain torch, as in JAX)."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()


def flash_backward_reference(q, k, v, o, do, lse, causal=True, scale=None):
    """Plain version of K3b: (dq, dk, dv) in the [b, s, h, d] layout, with P
    recomputed from lse and delta = rowsum(dO * O)."""
    delta = backward_delta(o, do)
    dq = flash_backward_dq_reference(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_backward_dkv_reference(q, k, v, do, lse, delta, causal,
                                          scale)
    return dq, dk, dv


def _check_operands(name, tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices "
                         f"{sorted(map(str, devices))}")
    dev = next(iter(devices))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    # the same operand rules on both devices, so a CPU run refuses what
    # the kernel would refuse
    require_launchable(name, tensors, ())
    return dev


def _require_kernel_shapes(q, k, v):
    if not flash_attention_ok(q, k, v):
        raise ValueError(
            f"the CUDA flash kernels take q [b, sq, h, d] and k, v [b, sk, "
            f"h, d] with d % 8 == 0 and d <= {MAX_HEAD_DIM}; got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")


def flash_forward(q, k, v, causal=True, scale=None):
    """K3a: (o, lse) of dense attention over [b, s, h, d] operands."""
    dev = _check_operands("flash_forward", (q, k, v))
    scale = _scale(q, scale)
    if not on_card(q):
        COUNTS["flash_forward"].plain_launches += 1
        return flash_forward_reference(q, k, v, causal, scale)
    _require_kernel_shapes(q, k, v)
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=dev)
    err = library().flash_attention_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, sq, k.shape[1], d, scale, int(causal),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "flash_forward")
    COUNTS["flash_forward"].kernel_launches += 1
    return o, lse


def flash_backward(q, k, v, o, do, lse, causal=True, scale=None):
    """K3b-dq and K3b-dkv: (dq, dk, dv) given the forward's o and lse and
    the output gradient do."""
    dev = _check_operands("flash_backward", (q, k, v, o, do, lse))
    scale = _scale(q, scale)
    if not on_card(q):
        COUNTS["flash_backward_dq"].plain_launches += 1
        COUNTS["flash_backward_dkv"].plain_launches += 1
        return flash_backward_reference(q, k, v, o, do, lse, causal, scale)
    _require_kernel_shapes(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"flash_backward: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} and lse {tuple(lse.shape)} do "
                         f"not match q {tuple(q.shape)}")
    delta = backward_delta(o, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = library()
    err = lib.flash_attention_bwd_dq_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq, sk, d,
        scale, int(causal), stream)
    check(err, "flash_backward_dq")
    COUNTS["flash_backward_dq"].kernel_launches += 1
    err = lib.flash_attention_bwd_dkv_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
        h, sq, sk, d, scale, int(causal), stream)
    check(err, "flash_backward_dkv")
    COUNTS["flash_backward_dkv"].kernel_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v); the backward recomputes P from the saved
    per-row lse (K3b) instead of keeping the [sq, sk] probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, do.contiguous(), lse,
                                    ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, scale=None, mask=None,
                    segment_ids=None, block_mask=None):
    """Dense flash attention over [b, s, h, d] operands, differentiable
    through the kernels. The masked forms raise NotImplementedError."""
    for name, arg in (("mask", mask), ("segment_ids", segment_ids),
                      ("block_mask", block_mask)):
        if arg is not None:
            raise NotImplementedError(f"flash_attention({name}=...): "
                                      f"{MASKED_FORMS}")
    return FlashAttention.apply(q, k, v, bool(causal), _scale(q, scale))
