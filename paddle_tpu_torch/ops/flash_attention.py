"""Flash attention, forward and backward: the training path's attention
kernels (K3a, K3b-dq, K3b-dkv), dense and masked (K3-m).

Counterpart of paddle_tpu/ops/pallas/flash_attention.py. Layout
[b, s, h, d] for q, k, v and o; causal masking is bottom-right aligned
(query i sees keys j <= i + sk - sq), so with sq > sk the first rows see
no key and come out as exact zeros with zero gradient. The forward writes
the per-row log-sum-exp as fp32 [b, h, sq] (the JAX kernel's trailing
LSE_LANES broadcast is a TPU layout detail, dropped here).

Four masking operands compose with causal, as in the JAX kernels
(`_tile_scores`, `_extra_inputs_specs`), each optional:

  mask        fp32 [b, 1|h, sq, sk], added to the scaled scores
  kbias       fp32 [b, sk], a per-key bias added at every query row (the
              O(s) form of a key-padding mask)
  qseg, kseg  int32 [b, sq] and [b, sk]: a pair attends iff the ids match
  block_mask  int32 [sq // bq, sk // bk] with bq = min(128, sq) and
              bk = min(128, sk), the JAX kernel's tiles: a 0 names a dead
              block, whose pairs are skipped whole

A hard-masked score (<= -5e29) gives p = 0 exactly, so a row with no
visible key comes out as zeros with zero gradient.

  flash_attention           the entry point: canonicalizes the masks as
                            the JAX function does (`canon_mask`,
                            `canon_segments`, the block mask only where
                            the JAX kernel path would apply it), then
                            FlashAttention.apply
  FlashAttention            torch.autograd.Function tying the forward
                            kernel (with LSE) to the two backward kernels,
                            as the custom VJP `_flash` ties them in JAX;
                            the masks get no gradient (JAX: zero
                            cotangents)
  flash_forward             wrapper of K3a -> (o, lse)
  flash_backward            wrappers of K3b-dq and K3b-dkv -> (dq, dk, dv);
                            delta = rowsum(dO * O) is plain torch before
                            the two launches, as in JAX, and at fp16 so
                            are `ds_scales`
  flash_forward_reference   plain PyTorch versions with the kernels' exact
  flash_backward_reference  contract (masked-row guard, 1e-30 clamps);
                            the backward is flash_backward_dq_reference and
                            flash_backward_dkv_reference over one delta
  launch_forward,           the bare launches (no checks, no counts), for
  launch_backward_dq,       timing the kernels
  launch_backward_dkv
  flash_attention_ok        the kernels' shape gate
  tf32_split                the kernels' 3xTF32 operand split (flash and
                            the ragged span form),
                            mirrored on the CPU (the plain versions compute
                            in fp32, or fp64 for fp64 operands)

Operand dtypes: q, k, v (and o, do) are all fp32, all bf16 or all fp16
(AMP); lse and delta are fp32 either way, and so are the mask and the
per-key bias. bf16 and fp16 operands launch the 16-bit instantiations of
the three kernels (`*_bf16`, `*_f16` entry points): products on the
16-bit tensor cores with fp32 accumulators, the softmax, lse and delta in
fp32, o, dq, dk and dv rounded to the operands' type once at the end, as
the JAX kernels upcast each 16-bit tile to fp32 and write their outputs
in the input dtype. At fp16 an output that passes 65504 is inf, as the
JAX kernels' and the plain versions' cast makes it (`GradScaler` reads
that inf to skip the step); the kernels keep dS within fp16's range by a
power-of-two factor per accumulator row that `ds_scales` chooses from a
bound of the row's |dS| (csrc/flash_common.cuh). The plain versions
compute in fp32 and cast the outputs to the input dtype. Mixed operand
dtypes raise.

On CUDA tensors the wrappers launch the hand-written kernels in
csrc/flash_attention.cu or raise; on CPU tensors they run the plain
versions. At bf16 and fp16 the three entry points take, for d <= 128, the
wgmma kernels of csrc/flash_attention_wgmma.cu (TMA rings, warp
specialisation), and for wider heads the mma.sync kernels beside the fp32
ones; `kernel_variant` names the one a launch takes. `COUNTS` holds one
LaunchCounts per kernel for each form, keyed by (masked, operand dtype):
masked is a call with any masking operand, and the dtype fp32, bf16 or
fp16; each launch is also counted under its variant (`form_launches`).
`counts_for` looks a form up and `reset_counts` sets them all to 0, so a
run can tell which instantiation ran.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from paddle_tpu_torch.ops._build import (
    HALF_DTYPES, LaunchCounts, check, library, refuse_interpret,
    require_launchable,
)

NEG_INF = -1e30
# scores at or below this are hard-masked and give p = 0 exactly
MASKED_BELOW = NEG_INF * 0.5
# the widest head the kernels take (instantiations for d <= 64, <= 128,
# <= 256)
MAX_HEAD_DIM = 256
# the JAX kernel's tile, the granularity of its block mask
JAX_BLOCK = 128
# the widest head of the bf16 and fp16 kernels on wgmma
WGMMA_MAX_HEAD_DIM = 128

_KERNELS = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
# the operand dtypes the kernels take, and each one's entry-point suffix
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
COUNTS = {(masked, dtype): {name: LaunchCounts() for name in _KERNELS}
          for masked in (False, True) for dtype in _SUFFIX}


def counts_for(masked: bool, dtype=torch.float32) -> dict:
    """The LaunchCounts of one form: dense or masked, by operand dtype
    (fp32, bf16 or fp16; the plain versions' fp64 calls count with
    fp32)."""
    return COUNTS[(bool(masked), dtype if dtype in HALF_DTYPES
                   else torch.float32)]


def kernel_variant(name: str, dtype, d: int) -> str:
    """The kernel a launch of ``name`` (one of the three flash kernels)
    takes on the card for operands of ``dtype`` and head dim ``d``, as the
    entry points in csrc/flash_attention.cu choose it: "wgmma" for the bf16
    and fp16 forward, dq and dk/dv at d <= WGMMA_MAX_HEAD_DIM
    (flash_attention_wgmma.cu), "mma" for every other (mma.sync: 3xTF32 at
    fp32, bf16 or fp16 above)."""
    if name not in _KERNELS:
        raise ValueError(f"kernel_variant: {name!r} is none of {_KERNELS}")
    if dtype in HALF_DTYPES and d <= WGMMA_MAX_HEAD_DIM:
        return "wgmma"
    return "mma"


def reset_counts() -> None:
    """Every form's counts to 0."""
    for group in COUNTS.values():
        for counts in group.values():
            counts.reset()


class Masks(NamedTuple):
    """The kernels' masking operands in canonical form (None = absent)."""
    mask: Optional[torch.Tensor] = None         # fp32 [b, 1|h, sq, sk]
    kbias: Optional[torch.Tensor] = None        # fp32 [b, sk]
    qseg: Optional[torch.Tensor] = None         # int32 [b, sq]
    kseg: Optional[torch.Tensor] = None         # int32 [b, sk]
    block_mask: Optional[torch.Tensor] = None   # int32 [sq // bq, sk // bk]

    def given(self) -> bool:
        return any(t is not None for t in self)


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


def jax_blocks(sq: int, sk: int, block_q: int = JAX_BLOCK,
               block_k: int = JAX_BLOCK):
    """(bq, bk): the rows and keys of one block of the JAX kernel's grid
    of ``block_q`` x ``block_k`` tiles, by which a block mask is indexed."""
    return min(block_q, sq), min(block_k, sk)


def _scale(q, scale):
    return float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _block_live(block_mask, sq, sk, block_q=JAX_BLOCK, block_k=JAX_BLOCK):
    """[sq, sk] bool: the pairs of the live blocks of ``block_mask``."""
    bq, bk = jax_blocks(sq, sk, block_q, block_k)
    return (block_mask != 0).repeat_interleave(bq, 0).repeat_interleave(bk, 1)


def _on_kernel_grid(block_mask, sq, sk, block_q, block_k):
    """``block_mask`` of the ``block_q`` x ``block_k`` grid restated on the
    kernels' grid (`jax_blocks(sq, sk)`), where the shapes tile it and
    each of its blocks is all live or all dead; else None. Both grids are
    cut to their common divisor rows and keys first (at most
    (sq / 8) x (sk / 8) entries, not [sq, sk] pairs)."""
    bq, bk = jax_blocks(sq, sk, block_q, block_k)
    cq, ck = jax_blocks(sq, sk)
    if sq % cq or sk % ck:
        return None
    gq, gk = math.gcd(bq, cq), math.gcd(bk, ck)
    fine = block_mask.repeat_interleave(bq // gq, 0).repeat_interleave(
        bk // gk, 1)
    groups = fine.reshape(sq // cq, cq // gq, sk // ck, ck // gk)
    if not bool((groups == groups[:, :1, :, :1]).all()):
        return None
    return groups[:, 0, :, 0].contiguous()


def _compute_dtype(q):
    """What the plain versions compute in: fp32, or fp64 for fp64 operands
    (the accuracy reference of the kernels' checks)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _scores(q, k, causal, scale, m: Masks = Masks()):
    """[b, h, sq, sk] fp32 scores as `_tile_scores` forms them: q.k * scale
    plus the mask and the per-key bias; NEG_INF where segments differ,
    the causal mask hides a key or the block mask names a dead block."""
    dt = _compute_dtype(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt)) * scale
    if m.mask is not None:
        s = s + m.mask.to(dt)
    if m.kbias is not None:
        s = s + m.kbias.to(dt)[:, None, None, :]
    neg = torch.full_like(s, NEG_INF)
    if m.qseg is not None:
        same = m.qseg[:, None, :, None] == m.kseg[:, None, None, :]
        s = torch.where(same, s, neg)
    sq, sk = s.shape[-2], s.shape[-1]
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(
            sk - sq)
        s = torch.where(keep, s, neg)
    if m.block_mask is not None:
        s = torch.where(_block_live(m.block_mask, sq, sk), s, neg)
    return s


def tf32_split(x):
    """The tensor-core kernels' operand split (3xTF32) of ``x`` in fp32, as
    `split` in csrc/tf32_mma.cuh forms it: big = x rounded to tf32's
    10 mantissa bits, to nearest with ties away from zero, and small = x -
    big rounded the same way, both fp32 with their low 13 mantissa bits
    zero; big + small is x within 2^-22 |x|. The kernels form a * b as
    small_a big_b + big_a small_b + big_a big_b; the plain versions do not
    use this, it pins the split on the CPU."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    big = rna(x.float())
    return big, rna(x.float() - big)


def _guarded_exp(s, m):
    """exp(s - m), but exactly 0 where s is hard-masked (on a row that sees
    no key, m is NEG_INF too and the exp would be 1)."""
    return torch.where(s <= MASKED_BELOW, torch.zeros_like(s),
                       torch.exp(s - m))


def flash_forward_reference(q, k, v, causal=True, scale=None, *, mask=None,
                            kbias=None, qseg=None, kseg=None,
                            block_mask=None):
    """Plain version of K3a: (o [b, sq, h, d] in q's dtype, lse [b, h, sq]
    fp32), o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)), the
    running max starting at NEG_INF as in the kernels."""
    scale = _scale(q, scale)
    s = _scores(q, k, causal, scale, Masks(mask, kbias, qseg, kseg,
                                           block_mask))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = _guarded_exp(s, m)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.to(p.dtype)) / den
    lse = (m + torch.log(den)).squeeze(-1)
    return o.transpose(1, 2).to(q.dtype).contiguous(), lse


def _backward_p_ds(q, k, v, do, lse, delta, causal, scale, masks):
    """P recomputed from lse, and dS = P * (dO V^T - delta)."""
    s = _scores(q, k, causal, scale, masks)
    dt = s.dtype
    p = _guarded_exp(s, lse.to(dt)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(dt), v.to(dt))
    return p, p * (dp - delta.to(dt)[..., None])


def flash_backward_dq_reference(q, k, v, do, lse, delta, causal=True,
                                scale=None, *, mask=None, kbias=None,
                                qseg=None, kseg=None, block_mask=None):
    """Plain version of K3b-dq: dq = scale * dS K, [b, sq, h, d]."""
    scale = _scale(q, scale)
    _, ds = _backward_p_ds(q, k, v, do, lse, delta, causal, scale,
                           Masks(mask, kbias, qseg, kseg, block_mask))
    return (scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.to(ds.dtype))
            ).to(q.dtype)


def flash_backward_dkv_reference(q, k, v, do, lse, delta, causal=True,
                                 scale=None, *, mask=None, kbias=None,
                                 qseg=None, kseg=None, block_mask=None):
    """Plain version of K3b-dkv: (dk = scale * dS^T Q, dv = P^T dO),
    [b, sk, h, d] each."""
    scale = _scale(q, scale)
    p, ds = _backward_p_ds(q, k, v, do, lse, delta, causal, scale,
                           Masks(mask, kbias, qseg, kseg, block_mask))
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.to(ds.dtype))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.to(p.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


# the fp16 backward's dS times its row's factor stays below this
# (`ds_scales`): the split's hi term is finite (fp16's largest is 65504)
# and the bound is at most 2x loose on top of its own looseness
DS_TOP = 2.0 ** 15
# the factors' range: 2^+-100 (a row whose bound is 0 takes the largest)
DS_SCALE_EXP = 100


def _pow2_under(bound):
    """The power of two f with bound * f in [DS_TOP / 2, DS_TOP), within
    2^+-DS_SCALE_EXP; 2^DS_SCALE_EXP where the bound is 0."""
    _, e = torch.frexp(bound)          # bound = m 2^e, m in [0.5, 1)
    e = torch.where(bound > 0, int(math.log2(DS_TOP)) - e,
                    torch.full_like(e, DS_SCALE_EXP))
    return torch.ldexp(torch.ones_like(bound),
                       e.clamp(-DS_SCALE_EXP, DS_SCALE_EXP))


def ds_scales(v, do, scale):
    """The fp16 backward's factors of dS (csrc/flash_common.cuh): fp32
    powers of two, ([b, h, sq] per query row for dq, [b, h, sk] per key for
    dk/dv), each bringing a bound of its row's |dS| under DS_TOP. With
    |dP_ij| = |dO_i . V_j| <= |dO_i| |V_j| and |delta_i| = |dO_i . O_i| <=
    |dO_i| max_j |V_j| (O_i is a convex combination of the V_j), |dS_ij| =
    scale P_ij |dP_ij - delta_i| is at most 2 scale |dO_i| max_j |V_j| in
    query row i and scale max_i |dO_i| (|V_j| + max_j |V_j|) in key j.
    Plain torch over dO and V, before the launches, as delta is."""
    norm = torch.linalg.vector_norm
    vn = norm(v, dim=-1, dtype=torch.float32).transpose(1, 2)    # [b, h, sk]
    dn = norm(do, dim=-1, dtype=torch.float32).transpose(1, 2)   # [b, h, sq]
    vmax = vn.amax(dim=-1, keepdim=True)
    dmax = dn.amax(dim=-1, keepdim=True)
    return (_pow2_under(2 * scale * dn * vmax).contiguous(),
            _pow2_under(scale * dmax * (vn + vmax)).contiguous())


def backward_delta(o, do):
    """delta = rowsum(dO * O) as fp32 [b, h, sq], the per-row term both
    backward kernels read (plain torch, as in JAX)."""
    dt = _compute_dtype(o)
    return (o.to(dt) * do.to(dt)).sum(dim=-1).transpose(1, 2).contiguous()


def flash_backward_reference(q, k, v, o, do, lse, causal=True, scale=None,
                             **masks):
    """Plain version of K3b: (dq, dk, dv) in the [b, s, h, d] layout, with P
    recomputed from lse and delta = rowsum(dO * O)."""
    delta = backward_delta(o, do)
    dq = flash_backward_dq_reference(q, k, v, do, lse, delta, causal, scale,
                                     **masks)
    dk, dv = flash_backward_dkv_reference(q, k, v, do, lse, delta, causal,
                                          scale, **masks)
    return dq, dk, dv


def _check_operands(name, tensors, masks: Masks, lse=()):
    """``tensors`` are the attention operands (q, k, v, and o, do), all
    fp32, all bf16 or all fp16; ``lse`` the fp32 row operands."""
    given = [t for t in (*tensors, *lse, *masks) if t is not None]
    devices = {t.device for t in given}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices "
                         f"{sorted(map(str, devices))}")
    dev = next(iter(devices))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    # the same operand rules on both devices, so a CPU run refuses what
    # the kernel would refuse; the masks are read one element at a time
    ints = [t for t in (masks.qseg, masks.kseg, masks.block_mask)
            if t is not None]
    floats = [t for t in (masks.mask, masks.kbias) if t is not None]
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= set(_SUFFIX):
        raise TypeError(f"{name}: q, k, v (and o, do) must all be fp32, all "
                        f"bf16 or all fp16, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if tensors[0].dtype in HALF_DTYPES:
        require_launchable(name, lse, ints, scales=floats, halves=tensors)
    else:
        require_launchable(name, (*tensors, *lse), ints, scales=floats)
    return dev


def _check_mask_shapes(name, q, k, m: Masks):
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    if m.mask is not None and (m.mask.dim() != 4 or tuple(m.mask.shape) not in
                               ((b, 1, sq, sk), (b, h, sq, sk))):
        raise ValueError(f"{name}: mask {tuple(m.mask.shape)} is not "
                         f"[{b}, 1|{h}, {sq}, {sk}]")
    if m.kbias is not None and tuple(m.kbias.shape) != (b, sk):
        raise ValueError(f"{name}: kbias {tuple(m.kbias.shape)} is not "
                         f"[{b}, {sk}]")
    if (m.qseg is None) != (m.kseg is None):
        raise ValueError(f"{name}: qseg and kseg come together")
    if m.qseg is not None and (tuple(m.qseg.shape) != (b, sq)
                               or tuple(m.kseg.shape) != (b, sk)):
        raise ValueError(f"{name}: segment ids {tuple(m.qseg.shape)} / "
                         f"{tuple(m.kseg.shape)} are not [{b}, {sq}] / "
                         f"[{b}, {sk}]")
    if m.block_mask is not None:
        bq, bk = jax_blocks(sq, sk)
        if sq % bq or sk % bk or tuple(m.block_mask.shape) != (sq // bq,
                                                                sk // bk):
            raise ValueError(
                f"{name}: block_mask {tuple(m.block_mask.shape)} does not "
                f"tile sq={sq}, sk={sk} in blocks of {bq} x {bk}")


def _require_kernel_shapes(q, k, v):
    if not flash_attention_ok(q, k, v):
        raise ValueError(
            f"the CUDA flash kernels take q [b, sq, h, d] and k, v [b, sk, "
            f"h, d] with d % 8 == 0 and d <= {MAX_HEAD_DIM}; got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")


def _mask_args(q, k, m: Masks):
    """The masking operands' C arguments after the tensors, and the sizes
    (mh, bq, bk) after d."""
    ptrs = [t.data_ptr() if t is not None else None for t in m]
    mh = m.mask.shape[1] if m.mask is not None else 1
    return ptrs, (mh, *jax_blocks(q.shape[1], k.shape[1]))


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def _entry(name, q):
    """The entry point of kernel ``name`` for q's dtype."""
    return getattr(library(), f"{name}_{_SUFFIX[q.dtype]}")


def launch_forward(q, k, v, o, lse, causal, scale, masks=Masks()):
    """K3a into o and lse; the caller has checked the operands."""
    b, sq, h, d = q.shape
    ptrs, sizes = _mask_args(q, k, masks)
    check(_entry("flash_attention_fwd", q)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *ptrs, b, h, sq, k.shape[1], d, *sizes, scale,
        int(causal), _stream(q)), "flash_forward")


def _ds_arg(q, ds_scale):
    """The fp16 entry points' ds_scale argument (none at fp32 and bf16)."""
    return (ds_scale.data_ptr(),) if q.dtype == torch.float16 else ()


def launch_backward_dq(q, k, v, do, lse, delta, dq, causal, scale,
                       masks=Masks(), ds_scale=None):
    """K3b-dq into dq; the caller has checked the operands (and at fp16
    given `ds_scales(v, do, scale)[0]` as ds_scale)."""
    b, sq, h, d = q.shape
    ptrs, sizes = _mask_args(q, k, masks)
    check(_entry("flash_attention_bwd_dq", q)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *_ds_arg(q, ds_scale),
        dq.data_ptr(), *ptrs, b, h, sq, k.shape[1], d, *sizes, scale,
        int(causal), _stream(q)), "flash_backward_dq")


def launch_backward_dkv(q, k, v, do, lse, delta, dk, dv, causal, scale,
                        masks=Masks(), ds_scale=None):
    """K3b-dkv into dk and dv; the caller has checked the operands (and at
    fp16 given `ds_scales(v, do, scale)[1]` as ds_scale)."""
    b, sq, h, d = q.shape
    ptrs, sizes = _mask_args(q, k, masks)
    check(_entry("flash_attention_bwd_dkv", q)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *_ds_arg(q, ds_scale),
        dk.data_ptr(), dv.data_ptr(), *ptrs, b, h, sq, k.shape[1], d,
        *sizes, scale, int(causal), _stream(q)), "flash_backward_dkv")


def flash_forward(q, k, v, causal=True, scale=None, *, mask=None,
                  kbias=None, qseg=None, kseg=None, block_mask=None):
    """K3a: (o, lse) of attention over [b, s, h, d] operands, with the
    masking operands in canonical form (see the module docstring)."""
    m = Masks(mask, kbias, qseg, kseg, block_mask)
    dev = _check_operands("flash_forward", (q, k, v), m)
    _check_mask_shapes("flash_forward", q, k, m)
    scale = _scale(q, scale)
    counts = counts_for(m.given(), q.dtype)["flash_forward"]
    if not on_card(q):
        counts.plain_launches += 1
        return flash_forward_reference(q, k, v, causal, scale, **m._asdict())
    _require_kernel_shapes(q, k, v)
    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=dev)
    launch_forward(q, k, v, o, lse, causal, scale, m)
    counts.count_kernel(kernel_variant("flash_forward", q.dtype, q.shape[3]))
    return o, lse


def flash_backward(q, k, v, o, do, lse, causal=True, scale=None, *,
                   mask=None, kbias=None, qseg=None, kseg=None,
                   block_mask=None):
    """K3b-dq and K3b-dkv: (dq, dk, dv) given the forward's o and lse, the
    output gradient do and the forward's masking operands."""
    m = Masks(mask, kbias, qseg, kseg, block_mask)
    _check_operands("flash_backward", (q, k, v, o, do), m, lse=(lse,))
    _check_mask_shapes("flash_backward", q, k, m)
    scale = _scale(q, scale)
    counts = counts_for(m.given(), q.dtype)
    if not on_card(q):
        counts["flash_backward_dq"].plain_launches += 1
        counts["flash_backward_dkv"].plain_launches += 1
        return flash_backward_reference(q, k, v, o, do, lse, causal, scale,
                                        **m._asdict())
    _require_kernel_shapes(q, k, v)
    b, sq, h, _ = q.shape
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"flash_backward: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} and lse {tuple(lse.shape)} do "
                         f"not match q {tuple(q.shape)}")
    delta = backward_delta(o, do)
    row_scale = key_scale = None
    if q.dtype == torch.float16:
        row_scale, key_scale = ds_scales(v, do, scale)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    d = q.shape[3]
    launch_backward_dq(q, k, v, do, lse, delta, dq, causal, scale, m,
                       row_scale)
    counts["flash_backward_dq"].count_kernel(
        kernel_variant("flash_backward_dq", q.dtype, d))
    launch_backward_dkv(q, k, v, do, lse, delta, dk, dv, causal, scale, m,
                        key_scale)
    counts["flash_backward_dkv"].count_kernel(
        kernel_variant("flash_backward_dkv", q.dtype, d))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v); the backward recomputes P from the saved
    per-row lse (K3b) instead of keeping the [sq, sk] probabilities. The
    masking operands are constants: they get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, kbias, qseg, kseg, block_mask, causal,
                scale):
        m = Masks(mask, kbias, qseg, kseg, block_mask)
        o, lse = flash_forward(q, k, v, causal, scale, **m._asdict())
        ctx.save_for_backward(q, k, v, o, lse, *m)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, *m = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, do.contiguous(), lse,
                                    ctx.causal, ctx.scale,
                                    **Masks(*m)._asdict())
        return dq, dk, dv, None, None, None, None, None, None, None


def canon_mask(mask, b, h, sq, sk, device=None):
    """The JAX `_canon_mask`: a bool (True = attend) or additive float
    mask broadcastable to [b, 1|h, sq, sk] -> (mask, kbias). Key-padding
    forms [*, *, 1, sk] lower to kbias fp32 [b, sk] (O(s) memory) with
    mask None; anything with a per-query axis becomes fp32 [b, 1|h, sq,
    sk] with kbias None. Bool False becomes NEG_INF."""
    mask = torch.as_tensor(mask, device=device)
    if mask.dtype == torch.bool:
        mask = torch.zeros(mask.shape, dtype=torch.float32,
                           device=mask.device).masked_fill_(~mask, NEG_INF)
    if mask.dim() == 2:          # [sq|1, sk]
        mask = mask[None, None]
    elif mask.dim() == 3:        # [b, sq|1, sk]
        mask = mask[:, None]
    if mask.dim() != 4:
        raise ValueError(f"attn mask rank {mask.dim()} not supported")
    if mask.shape[1] == 1 and mask.shape[2] == 1:
        return None, mask[:, 0, 0, :].float().expand(b, sk).contiguous()
    mh = 1 if mask.shape[1] == 1 else h
    return mask.float().expand(b, mh, sq, sk).contiguous(), None


def canon_segments(segment_ids, b, sq, sk, device=None):
    """The JAX `_canon_segments`: int [b, s] ids (self-attention) or a
    (q_seg, kv_seg) pair -> int32 ([b, sq], [b, sk])."""
    if isinstance(segment_ids, (tuple, list)):
        qseg, kseg = segment_ids
    else:
        qseg = kseg = segment_ids
    qseg, kseg = (torch.as_tensor(t, device=device).to(torch.int32)
                  .contiguous() for t in (qseg, kseg))
    if tuple(qseg.shape) != (b, sq) or tuple(kseg.shape) != (b, sk):
        raise ValueError(
            f"segment_ids shapes {tuple(qseg.shape)}/{tuple(kseg.shape)} "
            f"don't match q/kv sequences ({b},{sq})/({b},{sk})")
    return qseg, kseg


def block_mask_applies(q, k, v, causal, block_q=JAX_BLOCK,
                       block_k=JAX_BLOCK) -> bool:
    """Whether the JAX `flash_attention` would take its kernel path, the
    only one that reads a block mask: the shapes tile its ``block_q`` x
    ``block_k`` blocks (or are shorter than one), d % 8 == 0, and not
    causal with sq > sk. On its `_reference` path the block mask is
    ignored; so it is here."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    bq, bk = jax_blocks(sq, sk, block_q, block_k)
    return (not (causal and sq > sk) and sq % bq == 0 and sk % bk == 0
            and d % 8 == 0 and k.shape[0] == b and k.shape[2:] == q.shape[2:]
            and tuple(v.shape) == tuple(k.shape))


def canonical_masks(q, k, v, causal, mask=None, segment_ids=None,
                    block_mask=None, block_q=JAX_BLOCK,
                    block_k=JAX_BLOCK) -> Masks:
    """The JAX function's masking arguments as the kernels take them:
    `canon_mask`, `canon_segments`, and the block mask checked against
    the JAX tile grid of ``block_q`` x ``block_k`` blocks (a shape off it
    raises) and dropped where the JAX function would ignore it
    (`block_mask_applies`). The kernels read a block mask at the default
    128-blocks (or blocks as long as the sequence). One on another grid
    is restated on theirs where each of their blocks is all live or all
    dead (`_on_kernel_grid`); else it becomes NEG_INF on its dead blocks'
    pairs in the additive mask, which hides those pairs exactly as a dead
    block does (p = 0), at a cost: a dense fp32 [b, 1, sq, sk] mask
    (4 b sq sk bytes, 512 MiB at b 8, s 4096) and the dense-mask form of
    the kernels, which computes the dead pairs instead of skipping their
    blocks."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    kbias = qseg = kseg = None
    if mask is not None:
        mask, kbias = canon_mask(mask, b, h, sq, sk, q.device)
    if segment_ids is not None:
        qseg, kseg = canon_segments(segment_ids, b, sq, sk, q.device)
    if block_mask is not None:
        bq, bk = jax_blocks(sq, sk, block_q, block_k)
        block_mask = torch.as_tensor(block_mask, device=q.device).to(
            torch.int32).contiguous()
        if tuple(block_mask.shape) != (sq // bq, sk // bk):
            raise ValueError(
                f"block_mask {tuple(block_mask.shape)} != tile grid "
                f"({sq // bq}, {sk // bk})")
        if not block_mask_applies(q, k, v, causal, block_q, block_k):
            block_mask = None
        elif (bq, bk) != jax_blocks(sq, sk):
            regrid = _on_kernel_grid(block_mask, sq, sk, block_q, block_k)
            if regrid is None:
                dead = torch.where(
                    _block_live(block_mask, sq, sk, block_q, block_k), 0.0,
                    NEG_INF).to(device=q.device, dtype=torch.float32)
                mask = (dead.expand(b, 1, sq, sk) if mask is None
                        else mask + dead).contiguous()
            block_mask = regrid
    return Masks(mask, kbias, qseg, kseg, block_mask)


def flash_attention(q, k, v, causal=True, scale=None, mask=None,
                    segment_ids=None, block_mask=None, block_q=JAX_BLOCK,
                    block_k=JAX_BLOCK, interpret=None):
    """Flash attention over [b, s, h, d] operands, differentiable through
    the kernels, with the JAX function's masking arguments:

    mask: bool (True = attend) or additive float, broadcastable to
    [b, 1|h, sq, sk]; key-padding forms ([*, *, 1, sk]) lower to the
    per-key bias. segment_ids: int [b, s] or (q_seg [b, sq], kv_seg
    [b, sk]). block_mask: int/bool [sq // bq, sk // bk] block liveness at
    the JAX kernel's blocks of ``block_q`` x ``block_k`` (`jax_blocks`);
    a shape that does not match raises, and it is ignored where the JAX
    function ignores it (`block_mask_applies`). The block sizes set that
    grid and nothing else: the kernels keep their own tiles. A mask on
    another grid than the kernels' 128-blocks is restated on theirs where
    it can be; where it cannot (a 128-block part live, part dead) it costs
    a dense fp32 [b, 1, sq, sk] mask (512 MiB at b 8, s 4096) and the
    dense-mask kernels, which compute the dead pairs (`canonical_masks`).
    ``interpret`` is the JAX flag (`_build.refuse_interpret`). Strided
    views of q, k, v (a packed qkv's slices) are made contiguous first:
    the kernels read whole rows."""
    refuse_interpret("flash_attention", interpret, q)
    q, k, v = (t.contiguous() for t in (q, k, v))
    m = canonical_masks(q, k, v, causal, mask, segment_ids, block_mask,
                        block_q, block_k)
    return FlashAttention.apply(q, k, v, *m, bool(causal), _scale(q, scale))
