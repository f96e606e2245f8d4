"""The port's CUDA kernels and its serving path on an NVIDIA card.

Every test here needs the card and skips without one. Run them on the
card, from the root of a checkout, without the JAX test configuration
(this file imports neither jax nor the JAX package):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors at max |kernel - plain| <= 1e-4 (fp32, summed in another order),
with rows past q_len and dead slots exactly 0 (the ragged kernel over fp32
pools, K1, and over int8 and float8_e4m3fn pools, K1-q); a small engine
on the card must equal its own naive_generate token for token, through
the kernels (an int8 or fp8 engine through K1-q alone).
The ragged kernel's two forms (the span form on the tensor cores, the
decode form for G = n_rep * T <= 8) are held, over the three pool types,
against its plain version evaluated in fp64, and so is the paged-decode
kernel (K2), whose output must also not depend on the rest of the batch
(bit for bit) and whose call must not synchronise with the host. The flash kernels (K3a,
K3b-dq, K3b-dkv) hold o and lse within 1e-4 and
each gradient within 1e-4 * max|plain gradient|, dense and in every
masked form (K3-m: per-key bias, a dense mask shared or per head, a bool
mask with rows that see nothing, segment ids, a block mask), with fully
masked rows exactly 0; a small Llama and a small padded ERNIE trained
through them must match the same models trained on the dense path. At
the Llama trainer's and the ERNIE shapes, the backward kernels' dq, dk
and dv against the plain versions evaluated in fp64 must stay within
twice the fp32 plain versions' own error (fp32-class products on the
tensor cores); the forward's o and lse, and the ragged kernel's output,
are held so in every form the plain-version tests cover, with a floor of
FP64_FLOOR * max|exact| under the fp32 error: where the fp32 plain
version is exact (one key: o = v) the kernel's split products still
round at 2^-22.

The flash kernels' bf16 instantiations (AMP) hold o, lse, dq, dk and dv
against the plain versions evaluated in fp64 on the same bf16 operands
within twice the bf16 plain versions' own error, dense and in every masked
form, and misround at most 1/16 of the outputs the plain versions round to
bf16(exact) (which sees the P and dS products' inner precision), at head
dims 40 to 256 and at 4096 x 4096; the forward, dq and dk/dv launch their
wgmma kernels for d <= 128 and their mma.sync kernels above (the profiler's
kernel names); the bf16 autograd path launches only them; AdamW's multi-tensor step
(grouped, in chunks) equals its update over each parameter alone within
1e-6 (fp32 and bf16 parameters with master copies); a small Llama's O1 /
O2 step through them is held against the dense path at bf16 tolerances.
Their fp16 instantiations (fp16 AMP) pass the same sweep at fp16, keep
fp16's range (dO scaled as GradScaler scales it, below fp16's normal
range, and outputs past 65504: finite exactly where the plain version is),
launch the fp16 kernels by head dim, and the fp16 autograd path launches
only them.

The decode kinds run as CUDA graphs on the card: a replayed decode step
and horizon (greedy and seeded) must equal the eager call on the same
inputs and pools bit for bit, logits, tokens and pools, over fp32, int8
and fp8 pools, crediting the eager call's launch counts on every replay;
a horizon engine with every knob on must give the per-step engine's
streams token for token, with the sampler's tokens on the card equal to
the same function's on the CPU.

The serving extras: a fused ragged launch (a chunk beside decode rows
and a dead slot) matches K1's plain version and the gather path; a
replayed speculative horizon equals its eager call bit for bit; a
copy-on-write fork leaves the source page's bytes unchanged, over the
three pool types.

The bf16 serving kernels: K1's bf16 forms (bf16 q over bf16, int8 and
fp8 pools, both forms, head dims 8 to 256, decode walks across the split
walk's 256-key splits, int8 page scales of 1e-3 and 1e3) and K2-bf16
(split sizes, page sizes, batch invariance) within twice their bf16 plain
versions' error against fp64 and misrounding at most 1/16; K1's bf16
decode form batch-invariant bit for bit, and its graph replay equal to
its eager launches; a mixed (q, pool) pair raises;
a bf16 engine launches only the bf16 variants, token-exact against its
naive_generate with one slot, its horizon engine equal to it.

The fp16 serving kernels: the same sweeps at fp16 (K1-fp16 over fp16
pools, K1-q with fp16 q over int8 / fp8 pools, K2-fp16) within twice
their fp16 plain versions' error against fp64 and misrounding at most
1/16; K1's fp16 range cases (int8 page scales of 1e-6 and 1e2, large
|q.k|) finite exactly where the plain version is, within twice its error;
the decode form batch-invariant and its graph replay equal to its eager
launches; each fp16 form launches its own fp16 kernel (by name) and no
bf16 one; an fp16 engine launches only the fp16 variants, token-exact
against its naive_generate with one slot.

The GPT family: a GPT engine launches K1 for its prefill chunks and K2
once a layer for each decode step and no plain version, token-exact
against its naive_generate; PagedGPTGenerator launches K2 from its scalar
pos and gives the dense generator's tokens, and a head dim K2 does not
tile raises on the card unless the gather path is asked for; a greedy
token step of either generator copies nothing from the host and waits on
no stream; a scheduled GPT O1 step launches the bf16 flash kernels on wgmma only.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch.ops.flash_attention as fa
import paddle_tpu_torch.ops.paged_attention as k2
import paddle_tpu_torch.ops.ragged_paged_attention as k1
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    ErnieConfig, ErnieForPretraining, Llama, LlamaConfig,
    ernie_pretrain_loss_fn, llama_loss_fn,
)
from paddle_tpu_torch.ops import impl
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
from paddle_tpu_torch.serving import (
    LlamaRunner, SamplingParams, ServingEngine, naive_generate,
)
from paddle_tpu_torch.utils.flags import flag, set_flags

pytestmark = pytest.mark.cuda

TOL = 1e-4
# the least error against fp64 a gate asks of a kernel, relative to the
# largest exact value: a few fp32 ulp, the 3xTF32 split's own rounding
FP64_FLOOR = 2.0 ** -21


def _fp32_class(kern, plain, exact, what):
    """The kernel's error against the fp64 evaluation within twice the
    fp32 plain version's own (with the FP64_FLOOR floor)."""
    e_kernel = (kern.double() - exact).abs().max().item()
    e_plain = (plain.double() - exact).abs().max().item()
    floor = FP64_FLOOR * exact.abs().max().item()
    assert e_kernel <= 2 * max(e_plain, floor), (what, e_kernel, e_plain)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _operands(gen, B, T, n_kv, n_rep, d, ps, pages):
    nb = 1 + B * pages
    kp = torch.randn(nb, ps, n_kv, d, device="cuda", generator=gen)
    vp = torch.randn(nb, ps, n_kv, d, device="cuda", generator=gen)
    perm = torch.randperm(nb - 1, device="cuda", generator=gen) + 1
    table = perm.reshape(B, pages).int()
    q = torch.randn(B, T, n_kv * n_rep, d, device="cuda", generator=gen)
    return q, kp, vp, table


@pytest.mark.parametrize("d", [8, 64, 128, 136, 256])
@pytest.mark.parametrize("n_kv,n_rep,ps", [(2, 1, 16), (2, 4, 8), (1, 3, 1)])
def test_ragged_kernel_matches_plain(gen, d, n_kv, n_rep, ps):
    T = 16
    starts, qlens = [0, 5, 30, 3], [16, 1, 9, 0]
    pages = (T + max(starts)) // ps + 2
    q, kp, vp, table = _operands(gen, 4, T, n_kv, n_rep, d, ps, pages)
    table[3] = 0                                   # dead slot: all scratch
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    ql = torch.tensor(qlens, dtype=torch.int32, device="cuda")
    k1.COUNTS.reset()
    out = k1.ragged_paged_attention(q, kp, vp, table, st, ql)
    assert k1.COUNTS.kernel_launches == 1 and k1.COUNTS.plain_launches == 0
    ref = k1.ragged_reference(q, kp, vp, table, st, ql)
    assert (out - ref).abs().max().item() <= TOL
    for b, n in enumerate(qlens):
        assert bool((out[b, n:] == 0).all()), f"sequence {b}: rows >= {n}"


@pytest.mark.parametrize("d", [8, 64, 128, 256])
@pytest.mark.parametrize("ps", [1, 16])
def test_paged_decode_kernel_matches_plain(gen, d, ps):
    b, h, pages = 6, 4, 40 // ps + 1
    q, kp, vp, table = _operands(gen, b, 1, h, 1, d, ps, pages)
    table[5] = 0                                   # dead slot: all scratch
    pos = torch.tensor([0, ps - 1, ps, 17, 39, 0], dtype=torch.int32,
                       device="cuda")
    k2.COUNTS.reset()
    out = k2.paged_decode_attention(q[:, 0], kp, vp, table, pos)
    assert k2.COUNTS.kernel_launches == 1 and k2.COUNTS.plain_launches == 0
    ref = k2.paged_decode_reference(q[:, 0], kp, vp, table, pos)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= TOL


@pytest.mark.parametrize("keys_per_split", [k2.SPLIT_TILE,
                                            k2.KEYS_PER_SPLIT])
# d = 96: a 48 KiB ring, where the kernel's static shared memory needs the
# opt-in above the default limit
@pytest.mark.parametrize("d", [8, 64, 96, 128, 256])
@pytest.mark.parametrize("ps", [1, 8, 16, 32])
def test_paged_decode_kernel_is_fp32_class_against_fp64(gen, monkeypatch,
                                                        keys_per_split, d,
                                                        ps):
    """K2 over a 640-key table: positions on and off split and page
    boundaries up to the table's last key and past it (capped), a dead
    slot; against the plain version in fp64 and in fp32, at the wrapper's
    split size and at one tile a split (every walk cut many times)."""
    monkeypatch.setattr(k2, "KEYS_PER_SPLIT", keys_per_split)
    cap = 640
    pages = cap // ps
    pos_list = [0, keys_per_split - 1, keys_per_split, 301, cap - 1,
                cap + 77, 0]
    b, h = len(pos_list), 2
    q, kp, vp, table = _operands(gen, b, 1, h, 1, d, ps, pages)
    table[-1] = 0                                  # dead slot: all scratch
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    k2.COUNTS.reset()
    out = k2.paged_decode_attention(q[:, 0], kp, vp, table, pos)
    assert k2.COUNTS.kernel_launches == 1 and k2.COUNTS.plain_launches == 0
    ref = k2.paged_decode_reference(q[:, 0], kp, vp, table, pos)
    exact = k2.paged_decode_reference(q[:, 0].double(), kp.double(),
                                      vp.double(), table, pos)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= TOL
    _fp32_class(out, ref, exact, f"K2 d={d} ps={ps} ks={keys_per_split}")


def test_paged_decode_kernel_is_batch_invariant(gen):
    """A sequence's output alone equals, bit for bit, its output inside a
    batch of 8 with longer and shorter neighbours (a 4096-key table)."""
    h, d, ps, pages = 4, 128, 16, 256
    pos_list = [300, 4095, 0, 129, 2047, 16, 3000, 127]
    q, kp, vp, table = _operands(gen, len(pos_list), 1, h, 1, d, ps, pages)
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    out = k2.paged_decode_attention(q[:, 0], kp, vp, table, pos)
    for i in range(len(pos_list)):
        alone = k2.paged_decode_attention(q[i:i + 1, 0], kp, vp,
                                          table[i:i + 1], pos[i:i + 1])
        assert torch.equal(alone[0], out[i]), f"sequence {i}"


def test_paged_decode_kernel_never_syncs_with_the_host(gen):
    """The wrapper sizes everything from the shapes: no read of pos."""
    q, kp, vp, table = _operands(gen, 4, 1, 2, 1, 128, 16, 20)
    pos = torch.tensor([3, 300, 17, 0], dtype=torch.int32, device="cuda")
    k2.paged_decode_attention(q[:, 0], kp, vp, table, pos)   # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            out = k2.paged_decode_attention(q[:, 0], kp, vp, table, pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref = k2.paged_decode_reference(q[:, 0], kp, vp, table, pos)
    assert (out - ref).abs().max().item() <= TOL


def _quantize(gen, kp, vp, kind):
    """fp32 pools -> (k, v, k_scale, v_scale) int8 codes with random
    per-page, per-kv-head scales, or float8_e4m3fn pools and no scales."""
    if kind == "fp8":
        return (kp.to(torch.float8_e4m3fn), vp.to(torch.float8_e4m3fn),
                None, None)
    codes = [torch.randint(-127, 128, kp.shape, device="cuda", generator=gen,
                           dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(kp.shape[0], kp.shape[2], device="cuda",
                         generator=gen) * 0.05 + 1e-3 for _ in range(2)]
    return (*codes, *scales)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("ps", [8, 16])
def test_quantized_ragged_kernel_matches_plain(gen, kind, d, n_rep, ps):
    T = 16
    starts, qlens = [0, 5, 30, 3], [16, 1, 9, 0]
    pages = (T + max(starts)) // ps + 2
    q, kp, vp, table = _operands(gen, 4, T, 2, n_rep, d, ps, pages)
    table[3] = 0                                   # dead slot: all scratch
    kq, vq, ks, vs = _quantize(gen, kp, vp, kind)
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    ql = torch.tensor(qlens, dtype=torch.int32, device="cuda")
    counts = k1.COUNTS_I8 if kind == "int8" else k1.COUNTS_F8
    counts.reset()
    out = k1.ragged_paged_attention(q, kq, vq, table, st, ql, k_scale=ks,
                                    v_scale=vs)
    assert counts.kernel_launches == 1 and counts.plain_launches == 0
    ref = k1.ragged_reference(q, kq, vq, table, st, ql, k_scale=ks,
                              v_scale=vs)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= TOL
    for b, n in enumerate(qlens):
        assert bool((out[b, n:] == 0).all()), f"sequence {b}: rows >= {n}"


def _as_fp64(kind, kp, vp):
    """The pools as the fp64 evaluation reads them: fp32, bf16 and fp16
    pools widened, 1-byte codes as they are (their scales widen inside the
    plain version)."""
    return ((kp.double(), vp.double()) if kind in ("fp32", "bf16", "fp16")
            else (kp, vp))


@pytest.mark.parametrize("kind", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
def test_ragged_kernel_forms_are_fp32_class_against_fp64(gen, kind, d, ps,
                                                         n_rep):
    """Both forms of K1 / K1-q: spans with G = n_rep * T at the decode
    threshold (decode form), one row above it and at a longer span (span
    form), four sequences with a dead slot and rows past q_len (exact
    zeros), against the plain version in fp64 and in fp32."""
    counts = {"fp32": k1.COUNTS, "int8": k1.COUNTS_I8,
              "fp8": k1.COUNTS_F8}[kind]
    T_dec = k1.DECODE_ROWS // n_rep
    for T, form in ((T_dec, "decode"), (T_dec + 1, "span"), (37, "span")):
        assert k1.ragged_form(n_rep, T) == form
        starts, qlens = [0, 5, 70, 3], [T, 1, max(1, T - 2), 0]
        pages = (T + max(starts)) // ps + 2
        q, kp, vp, table = _operands(gen, 4, T, 2, n_rep, d, ps, pages)
        table[3] = 0                               # dead slot: all scratch
        k, v, ks, vs = ((kp, vp, None, None) if kind == "fp32"
                        else _quantize(gen, kp, vp, kind))
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        ql = torch.tensor(qlens, dtype=torch.int32, device="cuda")
        counts.reset()
        out = k1.ragged_paged_attention(q, k, v, table, st, ql, k_scale=ks,
                                        v_scale=vs)
        assert counts.form_launches == {form: 1}
        assert counts.plain_launches == 0
        plain = k1.ragged_reference(q, k, v, table, st, ql, k_scale=ks,
                                    v_scale=vs)
        exact = k1.ragged_reference(q.double(), *_as_fp64(kind, k, v),
                                    table, st, ql, k_scale=ks, v_scale=vs)
        assert exact.dtype == torch.float64
        assert torch.isfinite(out).all()
        assert (out - plain).abs().max().item() <= TOL, (T, form)
        _fp32_class(out, plain, exact, (T, form))
        for b, n in enumerate(qlens):
            assert bool((out[b, n:] == 0).all()), f"sequence {b}: rows >= {n}"


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("n_kv", [4, 2], ids=["mha", "gqa"])
def test_quantized_engine_on_the_card_runs_the_k1q_kernel(gen, kv_dtype,
                                                          n_kv):
    """int8 / fp8 pools: every attention call is K1-q (MHA decode too),
    never a plain version, K1 or K2; the fp8 engine equals its own
    naive_generate token for token."""
    cfg = LlamaConfig(vocab_size=211, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=n_kv, max_seq_len=128)
    runner = LlamaRunner(Llama(cfg, device="cuda", seed=0), block_size=16,
                         kv_dtype=kv_dtype)
    eng = ServingEngine(runner, num_blocks=24, max_batch_size=4,
                        max_prefill_tokens_per_step=32, audit=True)
    rng = np.random.default_rng(0)
    work = [(rng.integers(1, 211, int(rng.integers(5, 70))).tolist(),
             int(rng.integers(2, 12))) for _ in range(8)]
    counts = k1.COUNTS_I8 if kv_dtype == "int8" else k1.COUNTS_F8
    every = (k1.COUNTS, k1.COUNTS_I8, k1.COUNTS_F8, k2.COUNTS)
    for c in every:
        c.reset()
    ids = [eng.add_request(p, SamplingParams(max_tokens=n)) for p, n in work]
    outs = eng.run()
    m = eng.metrics
    calls = m.prefill_chunks.value + m.batch_occupancy.count
    assert counts.kernel_launches == cfg.num_layers * calls
    # decode steps (G = n_rep <= 8) take the decode form, chunks the span
    # form
    assert counts.form_launches.get("span", 0) > 0
    assert counts.form_launches.get("decode", 0) > 0
    assert sum(c.plain_launches for c in every) == 0
    assert k1.COUNTS.kernel_launches == k2.COUNTS.kernel_launches == 0
    assert eng.pool.allocator.check_no_leaks()
    if kv_dtype == "fp8":
        for rid, (p, n) in zip(ids, work):
            assert outs[rid].output_tokens == naive_generate(
                runner, p, SamplingParams(max_tokens=n))


def test_kernels_refuse_what_they_cannot_tile(gen):
    q, kp, vp, table = _operands(gen, 1, 8, 1, 1, 264, 4, 2)
    z = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        k1.ragged_paged_attention(q, kp, vp, table, z, z + 1)
    with pytest.raises(TypeError, match="fp32"):
        k2.paged_decode_attention(q[:, 0].double(), kp.double(),
                                  vp.double(), table, z)


@pytest.mark.parametrize("n_kv", [4, 2], ids=["mha", "gqa"])
def test_engine_on_the_card_matches_naive_through_the_kernels(gen, n_kv):
    cfg = LlamaConfig(vocab_size=211, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=n_kv, max_seq_len=128)
    runner = LlamaRunner(Llama(cfg, device="cuda", seed=0), block_size=16)
    eng = ServingEngine(runner, num_blocks=24, max_batch_size=4,
                        max_prefill_tokens_per_step=32, audit=True)
    rng = np.random.default_rng(0)
    work = [(rng.integers(1, 211, int(rng.integers(5, 70))).tolist(),
             int(rng.integers(2, 12))) for _ in range(8)]
    for counts in (k1.COUNTS, k2.COUNTS):
        counts.reset()
    ids = [eng.add_request(p, SamplingParams(max_tokens=n)) for p, n in work]
    outs = eng.run()
    assert k1.COUNTS.kernel_launches > 0
    assert (k2.COUNTS.kernel_launches > 0) == (n_kv == cfg.num_heads)
    assert k1.COUNTS.plain_launches == k2.COUNTS.plain_launches == 0
    for rid, (p, n) in zip(ids, work):
        assert outs[rid].output_tokens == naive_generate(
            runner, p, SamplingParams(max_tokens=n))
    assert eng.pool.allocator.check_no_leaks()


def _grad_bound(ref, dv_ref, sk):
    # with one key the softmax is constant: the exact dq and dk are 0 and
    # both sides are rounding noise, so they are held to dv's scale
    scale = ref.abs().max().item()
    return 1e-4 * (max(scale, dv_ref.abs().max().item()) if sk == 1
                   else scale)


@pytest.mark.parametrize("d", [8, 16, 64, 120, 128, 136, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sq,sk", [(1, 1), (63, 63), (100, 100), (257, 257),
                                   (4096, 4096), (65, 200), (200, 65)])
def test_flash_kernels_match_plain(gen, d, causal, sq, sk):
    q = torch.randn(2, sq, 3, d, device="cuda", generator=gen)
    k, v = (torch.randn(2, sk, 3, d, device="cuda", generator=gen)
            for _ in range(2))
    do = torch.randn(2, sq, 3, d, device="cuda", generator=gen)
    fa.reset_counts()
    o, lse = fa.flash_forward(q, k, v, causal)
    grads = fa.flash_backward(q, k, v, o, do, lse, causal)
    dense = fa.counts_for(False)
    assert {n: (c.kernel_launches, c.plain_launches)
            for n, c in dense.items()} == dict.fromkeys(dense, (1, 0))
    ro, rlse = fa.flash_forward_reference(q, k, v, causal)
    refs = fa.flash_backward_reference(q, k, v, ro, do, rlse, causal)
    torch.cuda.synchronize()
    assert (o - ro).abs().max().item() <= TOL
    assert (lse - rlse).abs().max().item() <= TOL
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert torch.isfinite(g).all(), name
        assert (g - r).abs().max().item() <= _grad_bound(r, refs[2], sk), name
    if causal and sq > sk:          # rows that see no key
        dead = sq - sk
        assert (o[:, :dead] == 0).all() and (grads[0][:, :dead] == 0).all()


@pytest.mark.parametrize("shape", ["llama", "ernie"])
def test_backward_kernels_are_fp32_class_against_fp64(gen, shape):
    """dq, dk and dv of the backward kernels (3xTF32 products) against the
    plain versions evaluated in fp64, at the Llama trainer's shape (causal)
    and the ERNIE shape with a key-padding bias: within twice the fp32 plain
    versions' own error (TF32 products would be ~1000 times off)."""
    b, s, h, d, causal = ((1, 4096, 32, 128, True) if shape == "llama"
                          else (16, 512, 12, 64, False))
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   for _ in range(4))
    kbias = None
    if shape == "ernie":
        lens = torch.randint(s * 85 // 100, s + 1, (b, 1), device="cuda",
                             generator=gen)
        kbias = (torch.arange(s, device="cuda")[None, :] >= lens).float() \
            * -1e4
    o, lse = fa.flash_forward(q, k, v, causal, kbias=kbias)
    kern = fa.flash_backward(q, k, v, o, do, lse, causal, kbias=kbias)
    plain = fa.flash_backward_reference(q, k, v, o, do, lse, causal,
                                        kbias=kbias)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, lse64 = fa.flash_forward_reference(q64, k64, v64, causal,
                                            kbias=kbias)
    exact = fa.flash_backward_reference(q64, k64, v64, o64, do64, lse64,
                                        causal, kbias=kbias)
    for name, g, p, r in zip(("dq", "dk", "dv"), kern, plain, exact):
        assert (g - p).abs().max().item() <= TOL * p.abs().max().item(), name
        e_kernel = (g.double() - r).abs().max().item()
        e_plain = (p.double() - r).abs().max().item()
        assert e_kernel <= 2 * e_plain, (name, e_kernel, e_plain)


def _forward_vs_fp64(q, k, v, causal, o, lse, what, **ops):
    """The forward's o and lse against the plain version in fp64 (lse on
    the rows that see a key: a hard-masked row's -1e30 is no number to
    hold), within twice the fp32 plain version's error."""
    ro, rlse = fa.flash_forward_reference(q, k, v, causal, **ops)
    o64, lse64 = fa.flash_forward_reference(q.double(), k.double(),
                                            v.double(), causal, **ops)
    assert o64.dtype == lse64.dtype == torch.float64
    _fp32_class(o, ro, o64, ("o",) + what)
    seen = lse64 > fa.MASKED_BELOW
    if seen.any():
        _fp32_class(lse[seen], rlse[seen], lse64[seen], ("lse",) + what)


@pytest.mark.parametrize("d", [8, 16, 64, 120, 128, 136, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sq,sk", [(1, 1), (63, 63), (100, 100), (257, 257),
                                   (4096, 4096), (65, 200), (200, 65)])
def test_forward_kernel_is_fp32_class_against_fp64(gen, d, causal, sq, sk):
    """K3a (3xTF32 products, Q split once) in test_flash_kernels_match_
    plain's forms against the plain version in fp64."""
    q = torch.randn(2, sq, 3, d, device="cuda", generator=gen)
    k, v = (torch.randn(2, sk, 3, d, device="cuda", generator=gen)
            for _ in range(2))
    o, lse = fa.flash_forward(q, k, v, causal)
    _forward_vs_fp64(q, k, v, causal, o, lse, (d, causal, sq, sk))


@pytest.mark.parametrize("seed", range(8))
def test_forward_lse_against_fp64_at_the_trainer_shape_across_seeds(gen,
                                                                    seed):
    """`chip_smoke.py`'s check_vs_fp64 forward case (fp32 K3a, q/k/v
    [1,4096,32,128] causal) on streams of its own: o and lse within twice
    the fp32 plain version's error against fp64 by the smoke's own ratio
    (`fp64_ratio`, no floor)."""
    cs = _chip_smoke()
    gen.manual_seed(seed)
    q, k, v = (torch.randn(1, 4096, 32, 128, device="cuda", generator=gen)
               for _ in range(3))
    o, lse = fa.flash_forward(q, k, v, True)
    ro, rlse = fa.flash_forward_reference(q, k, v, True)
    o64, lse64 = fa.flash_forward_reference(q.double(), k.double(),
                                            v.double(), True)
    ratio = {"o": cs.fp64_ratio(o, ro, o64),
             "lse": cs.fp64_ratio(lse, rlse, lse64)}
    print(f"seed {seed}: o {ratio['o']:.3f}x, lse {ratio['lse']:.3f}x")
    assert ratio["o"] <= 2.0 and ratio["lse"] <= 2.0, (seed, ratio)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sq,sk", [(63, 63), (200, 200), (257, 257),
                                   (4096, 4096), (65, 200), (200, 65)])
@pytest.mark.parametrize("form", ["kbias_soft", "kbias_hard", "mask_mh1",
                                  "mask_mhh", "bool_dead_rows", "segments"])
def test_masked_forward_kernel_is_fp32_class_against_fp64(gen, form, d,
                                                          causal, sq, sk):
    """K3a-m in test_masked_flash_kernels_match_plain's forms against the
    plain version in fp64."""
    q = torch.randn(2, sq, 3, d, device="cuda", generator=gen)
    k, v = (torch.randn(2, sk, 3, d, device="cuda", generator=gen)
            for _ in range(2))
    ops = _masked_operands(gen, form, 2, sq, sk, 3)
    fa.reset_counts()
    o, lse = fa.flash_forward(q, k, v, causal, **ops)
    assert fa.counts_for(True)["flash_forward"].kernel_launches == 1
    _forward_vs_fp64(q, k, v, causal, o, lse, (form, d, causal, sq, sk),
                     **ops)


def test_flash_kernels_refuse_what_they_cannot_take(gen):
    for d in (12, 264):
        q = torch.zeros(1, 8, 2, d, device="cuda")
        with pytest.raises(ValueError, match="d % 8 == 0"):
            fa.flash_forward(q, q, q)
        with pytest.raises(ValueError, match="FLAGS_use_flash_attention"):
            impl.scaled_dot_product_attention(q, q, q, is_causal=True)
    q = torch.zeros(1, 8, 2, 8, device="cuda")
    with pytest.raises(ValueError, match="K3-m"):
        impl.scaled_dot_product_attention(
            q, q, q, attn_mask=torch.zeros(8, 8, device="cuda"))
    with pytest.raises(ValueError, match="kbias"):
        fa.flash_forward(q, q, q, kbias=torch.zeros(1, 9, device="cuda"))


def _masked_operands(gen, form, b, sq, sk, h):
    """Canonical masking operands of one form on the card."""
    dev = "cuda"
    if form == "kbias_soft":
        lens = torch.randint(1, sk + 1, (b,), device=dev, generator=gen)
        pad = torch.arange(sk, device=dev)[None, :] >= lens[:, None]
        return dict(kbias=pad.float() * -1e4)
    if form == "kbias_hard":
        pad = torch.rand(b, sk, device=dev, generator=gen) < 0.3
        return dict(kbias=torch.zeros(b, sk, device=dev).masked_fill_(
            pad, fa.NEG_INF))
    if form in ("mask_mh1", "mask_mhh"):
        mh = 1 if form == "mask_mh1" else h
        m = torch.randn(b, mh, sq, sk, device=dev, generator=gen) * 2
        hide = torch.rand(m.shape, device=dev, generator=gen) < 0.3
        return dict(mask=m.masked_fill_(hide, fa.NEG_INF))
    if form == "bool_dead_rows":
        keep = torch.rand(b, 1, sq, sk, device=dev, generator=gen) < 0.7
        keep[:, :, sq // 2:] = False
        # one query row lowers to a per-key bias, more to a dense mask
        mask, kbias = fa.canon_mask(keep, b, h, sq, sk)
        return dict(mask=mask, kbias=kbias)
    if form == "segments":
        qseg = (torch.arange(sq, device=dev) * 3 // sq).repeat(b, 1)
        kseg = (torch.arange(sk, device=dev) * 3 // sk).repeat(b, 1)
        return dict(qseg=qseg.int(), kseg=kseg.int())
    bq, bk = fa.jax_blocks(sq, sk)                       # block mask
    bm = (torch.rand(sq // bq, sk // bk, device=dev, generator=gen) < 0.6)
    bm[:, 0] = True
    bm[-1, -1] = False
    return dict(block_mask=bm.int())


def _check_masked(gen, form, d, causal, sq, sk, b=2, h=3):
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen)
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen)
            for _ in range(2))
    do = torch.randn(b, sq, h, d, device="cuda", generator=gen)
    ops = _masked_operands(gen, form, b, sq, sk, h)
    fa.reset_counts()
    o, lse = fa.flash_forward(q, k, v, causal, **ops)
    grads = fa.flash_backward(q, k, v, o, do, lse, causal, **ops)
    assert {n: (c.kernel_launches, c.plain_launches)
            for n, c in fa.counts_for(True).items()} == \
        dict.fromkeys(fa.counts_for(True), (1, 0))
    assert all(c.kernel_launches == 0 for c in fa.counts_for(False).values())
    ro, rlse = fa.flash_forward_reference(q, k, v, causal, **ops)
    refs = fa.flash_backward_reference(q, k, v, ro, do, rlse, causal, **ops)
    torch.cuda.synchronize()
    assert (o - ro).abs().max().item() <= TOL
    assert (lse - rlse).abs().max().item() <= TOL
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert torch.isfinite(g).all(), name
        assert (g - r).abs().max().item() <= _grad_bound(r, refs[2], sk), name
    if form == "bool_dead_rows":
        assert (o[:, sq // 2:] == 0).all()
        assert (grads[0][:, sq // 2:] == 0).all()


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sq,sk", [(63, 63), (200, 200), (257, 257),
                                   (4096, 4096), (65, 200), (200, 65)])
@pytest.mark.parametrize("form", ["kbias_soft", "kbias_hard", "mask_mh1",
                                  "mask_mhh", "bool_dead_rows", "segments"])
def test_masked_flash_kernels_match_plain(gen, form, d, causal, sq, sk):
    _check_masked(gen, form, d, causal, sq, sk)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sq,sk", [(256, 256), (100, 384), (384, 100)])
def test_block_masked_flash_kernels_match_plain(gen, d, causal, sq, sk):
    _check_masked(gen, "block_mask", d, causal, sq, sk)


def test_small_ernie_through_the_masked_kernels_matches_the_dense_path(
        gen):
    cfg = ErnieConfig(vocab_size=301, hidden_size=256, num_layers=2,
                      num_heads=4, max_position=200, dropout=0.0)
    ids = torch.randint(5, 301, (3, 200), device="cuda", generator=gen)
    att = (torch.arange(200, device="cuda")[None, :]
           < torch.tensor([[200], [171], [77]], device="cuda")).long()
    labels = torch.where(att > 0, ids, -100)
    sop = torch.tensor([0, 1, 1], device="cuda")

    def once(use_flash):
        model = ErnieForPretraining(cfg, device="cuda", seed=4)
        old = flag("FLAGS_use_flash_attention")
        set_flags({"FLAGS_use_flash_attention": use_flash})
        try:
            loss = ernie_pretrain_loss_fn(model(ids, None, att), labels, sop)
            loss.backward()
        finally:
            set_flags({"FLAGS_use_flash_attention": old})
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    fa.reset_counts()
    loss_k, grads_k = once(True)
    assert all(c.kernel_launches == 2 and c.plain_launches == 0
               for c in fa.counts_for(True).values())
    loss_d, grads_d = once(False)
    assert abs(loss_k - loss_d) <= 1e-5 * abs(loss_d)
    for name, g in grads_k.items():
        ref = grads_d[name]
        assert (g - ref).abs().max().item() <= \
            1e-3 * ref.abs().max().item(), name


def _train_once(cfg, ids, labels, use_flash):
    model = Llama(cfg, device="cuda", seed=3)
    old = flag("FLAGS_use_flash_attention")
    set_flags({"FLAGS_use_flash_attention": use_flash})
    try:
        loss = llama_loss_fn(model(ids), labels)
        loss.backward()
    finally:
        set_flags({"FLAGS_use_flash_attention": old})
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("n_kv", [4, 2], ids=["mha", "gqa"])
def test_small_llama_through_the_kernels_matches_the_dense_path(gen, n_kv):
    cfg = LlamaConfig(vocab_size=211, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=n_kv, max_seq_len=256)
    toks = torch.randint(0, 211, (2, 201), device="cuda", generator=gen)
    ids, labels = toks[:, :-1], toks[:, 1:]
    fa.reset_counts()
    loss_k, grads_k = _train_once(cfg, ids, labels, True)
    assert all(c.kernel_launches == 2 and c.plain_launches == 0
               for c in fa.counts_for(False).values())
    loss_d, grads_d = _train_once(cfg, ids, labels, False)
    assert abs(loss_k - loss_d) <= 1e-5 * abs(loss_d)
    for name, g in grads_k.items():
        ref = grads_d[name]
        assert (g - ref).abs().max().item() <= \
            1e-3 * ref.abs().max().item(), name
    # and a few AdamW steps through the kernels bring the loss down
    model = Llama(cfg, device="cuda", seed=3)
    step = TrainStep(model, llama_loss_fn, AdamW(
        learning_rate=1e-3, parameters=model.named_parameters(),
        grad_clip=ClipGradByGlobalNorm(1.0)))
    losses = [step(ids, labels).item() for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ------------------------------------------------- bf16 (AMP) flash kernels

BF16_FORMS = ["dense", "kbias_soft", "kbias_hard", "mask_mh1", "mask_mhh",
              "bool_dead_rows", "segments", "block_mask"]


def _bf16_operands(gen, b, sq, sk, h, d, dtype=torch.bfloat16):
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen)
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen)
            for _ in range(2))
    do = torch.randn(b, sq, h, d, device="cuda", generator=gen)
    return tuple(t.to(dtype) for t in (q, k, v, do))


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bf16_class(kern, plain, exact, what):
    """The bf16 kernel's error against the fp64 evaluation on the same bf16
    inputs within twice the bf16 plain version's own (fp32 compute, the
    outputs rounded to bf16 once), with `chip_smoke.py`'s floor
    (`_vs_fp64`)."""
    e_kernel, e_plain, ratio = _chip_smoke()._vs_fp64(kern, plain, exact)
    assert ratio <= 2.0, (what, e_kernel, e_plain)


def _bf16_misround(kern, plain, exact, what):
    """Of the bf16 outputs the plain version rounds to bf16(exact), the
    kernel rounds at most MISROUND_GATE elsewhere (`chip_smoke.py`'s
    `misround_share`: the max error cannot see an inner error under half a
    bf16 ulp, this share can)."""
    cs = _chip_smoke()
    share = cs.misround_share(kern, plain, exact)
    assert share <= cs.MISROUND_GATE, (what, share)


def _bf16_vs_fp64(gen, form, d, causal, sq, sk, b=2, h=3,
                  dtype=torch.bfloat16):
    """The bf16 (or fp16) kernels on one case against fp64 (see the sweep
    below)."""
    q, k, v, do = _bf16_operands(gen, b, sq, sk, h, d, dtype)
    ops = {} if form == "dense" else _masked_operands(gen, form, b, sq, sk, h)
    # (a bool mask over one key lowers to a per-key bias: mask is None)
    ops = {n: t for n, t in ops.items() if t is not None}
    counts = fa.counts_for(bool(ops), dtype)
    fa.reset_counts()
    o, lse = fa.flash_forward(q, k, v, causal, **ops)
    grads = fa.flash_backward(q, k, v, o, do, lse, causal, **ops)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert all(g.dtype == dtype for g in grads)
    assert {n: (c.kernel_launches, c.plain_launches)
            for n, c in counts.items()} == dict.fromkeys(counts, (1, 0))
    assert all(c.kernel_launches == 0 for c in (*fa.counts_for(False).values(),
                                                *fa.counts_for(True).values()))
    ro, rlse = fa.flash_forward_reference(q, k, v, causal, **ops)
    plain = fa.flash_backward_reference(q, k, v, o, do, lse, causal, **ops)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, lse64 = fa.flash_forward_reference(q64, k64, v64, causal, **ops)
    exact = fa.flash_backward_reference(q64, k64, v64, o64, do64, lse64,
                                        causal, **ops)
    what = (form, d, causal, sq, sk)
    _bf16_class(o, ro, o64, ("o",) + what)
    _bf16_misround(o, ro, o64, ("o",) + what)
    seen = lse64 > fa.MASKED_BELOW
    if seen.any():
        _bf16_class(lse[seen], rlse[seen], lse64[seen], ("lse",) + what)
    for name, g, p, r in zip(("dq", "dk", "dv"), grads, plain, exact):
        assert torch.isfinite(g).all(), (name,) + what
        _bf16_class(g, p, r, (name,) + what)
        _bf16_misround(g, p, r, (name,) + what)
    if form == "bool_dead_rows":
        assert (o[:, sq // 2:] == 0).all()
        assert (grads[0][:, sq // 2:] == 0).all()


# d <= 128 runs the three kernels on wgmma (d = 40 and 96: TMA's
# zero-filled columns past d, K padded to 16), d = 256 the mma.sync kernels
@pytest.mark.parametrize("d", [40, 64, 96, 128, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sq,sk", [(1, 1), (63, 63), (257, 257),
                                   (1000, 1000), (65, 200), (200, 65),
                                   (256, 256), (100, 384)])
@pytest.mark.parametrize("form", BF16_FORMS)
def test_bf16_flash_kernels_against_fp64(gen, form, d, causal, sq, sk):
    """K3a, K3b-dq and K3b-dkv at bf16, dense and in every masked form:
    o, lse, dq, dk and dv against the plain versions evaluated in fp64 on
    the same bf16 operands, within twice the bf16 plain versions' error,
    and o, dq, dk and dv misrounded at most 1/16 of the time."""
    if form == "block_mask" and (sq % min(128, sq) or sk % min(128, sk)):
        pytest.skip("a block mask tiles only lengths on the 128-blocks")
    _bf16_vs_fp64(gen, form, d, causal, sq, sk)


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_flash_kernels_against_fp64_at_4096(gen, d):
    """The sweep's gates at 4096 x 4096, causal, b h = 1 x 2: the deepest
    rings (64 key tiles of the forward, 128 query tiles of dk/dv)."""
    _bf16_vs_fp64(gen, "dense", d, True, 4096, 4096, b=1, h=2)


def _launched_kernels(fn, times=2):
    """The names of the CUDA kernels ``fn`` launches (torch.profiler), run
    ``times`` times in one profile: the tracer can lose a kernel while it
    requests an activity buffer (on the card it dropped one flash kernel
    now and then), so each kernel gets two chances to be recorded."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(times):
            fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("d", [40, 64, 96, 128, 256])
def test_bf16_head_dims_launch_their_kernel_variant(gen, d):
    """At bf16 the forward, dq and dk/dv launch their wgmma kernels for
    d <= 128 and the mma.sync kernels above, as `kernel_variant` names them
    and the counts record them (two runs: `_launched_kernels`)."""
    q, k, v, do = _bf16_operands(gen, 1, 200, 200, 2, d)
    fa.reset_counts()

    def run():
        o, lse = fa.flash_forward(q, k, v, True)
        fa.flash_backward(q, k, v, o, do, lse, True)

    names = " ".join(_launched_kernels(run))
    wgmma = d <= fa.WGMMA_MAX_HEAD_DIM
    for kernel in ("flash_fwd_bf16", "flash_bwd_dq_bf16",
                   "flash_bwd_dkv_bf16"):
        assert (f"{kernel}_wgmma_kernel" in names) == wgmma, (d, names)
        assert (f"{kernel}_kernel" in names) != wgmma, (d, names)
    for name, c in fa.counts_for(False, torch.bfloat16).items():
        variant = fa.kernel_variant(name, torch.bfloat16, d)
        assert variant == ("wgmma" if wgmma else "mma")
        assert c.form_launches == {variant: 2}, (name, c.form_launches)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_bf16_autograd_launches_only_the_bf16_kernels(gen, masked):
    q, k, v, do = _bf16_operands(gen, 2, 200, 200, 4, 64)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    mask = None
    if masked:
        mask = ((torch.arange(200, device="cuda") >= 170).float()
                * -1e4)[None, None, None, :].expand(2, 1, 1, 200)
    fa.reset_counts()
    o = fa.flash_attention(q, k, v, causal=not masked, mask=mask)
    torch.autograd.grad(o, (q, k, v), do)
    ran = fa.counts_for(masked, torch.bfloat16)
    for group in fa.COUNTS.values():
        want = (1, 0) if group is ran else (0, 0)
        assert {n: (c.kernel_launches, c.plain_launches)
                for n, c in group.items()} == dict.fromkeys(group, want)


def test_bf16_kernels_refuse_mixed_dtypes(gen):
    """One dtype for q, k, v: bf16 beside fp32 or fp16 raises (all-fp16
    operands launch the fp16 kernels: the fp16 tests below)."""
    q, k, v, _ = _bf16_operands(gen, 1, 16, 16, 2, 64)
    with pytest.raises(TypeError, match="all be fp32, all bf16 or all fp16"):
        fa.flash_forward(q, k.float(), v)
    with pytest.raises(TypeError, match="all be fp32, all bf16 or all fp16"):
        fa.flash_forward(q.half(), k, v.half())


# ------------------------------------------------------ fp16 (fp16 AMP)

# the fp16 kernels: the sweep of the bf16 ones at fp16, and fp16's range
@pytest.mark.parametrize("d", [40, 64, 96, 128, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sq,sk", [(1, 1), (63, 63), (257, 257),
                                   (1000, 1000), (65, 200), (200, 65),
                                   (256, 256), (100, 384)])
@pytest.mark.parametrize("form", BF16_FORMS)
def test_f16_flash_kernels_against_fp64(gen, form, d, causal, sq, sk):
    """K3a, K3b-dq and K3b-dkv at fp16, dense and in every masked form: o,
    lse, dq, dk and dv against the plain versions evaluated in fp64 on
    the same fp16 operands, within twice the fp16 plain versions' error,
    and o, dq, dk and dv misrounded at most 1/16 of the time."""
    if form == "block_mask" and (sq % min(128, sq) or sk % min(128, sk)):
        pytest.skip("a block mask tiles only lengths on the 128-blocks")
    _bf16_vs_fp64(gen, form, d, causal, sq, sk, dtype=torch.float16)


@pytest.mark.parametrize("d", [64, 128])
def test_f16_flash_kernels_against_fp64_at_4096(gen, d):
    """The fp16 sweep's gates at 4096 x 4096, causal: the long columns
    where P's subnormal low term moved dV's rounding before P took its
    2^14 scale."""
    _bf16_vs_fp64(gen, "dense", d, True, 4096, 4096, b=1, h=2,
                  dtype=torch.float16)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", range(3), ids=["dS_past_65504",
                                                "dO_subnormal", "overflow"])
def test_f16_flash_kernels_keep_fp16s_range(gen, case, d):
    """`chip_smoke.py`'s RANGE_CASES: dO scaled as GradScaler scales it
    (|dS| past 65504), below fp16's normal range, and outputs past 65504:
    finite exactly where the plain version is (inf where its cast is),
    and its gates on the finite outputs (`check_half`)."""
    cs = _chip_smoke()
    label, do_scale, v_scale = cs.RANGE_CASES[case]
    cs.check_half(gen, label, 1, 1000, 1000, 4, d, True,
                  dtype=torch.float16, do_scale=do_scale, v_scale=v_scale)


@pytest.mark.parametrize("d", [40, 64, 96, 128, 256])
def test_f16_head_dims_launch_their_kernel_variant(gen, d):
    """At fp16 the forward, dq and dk/dv launch their fp16 wgmma kernels
    for d <= 128 and their fp16 mma.sync kernels above, as
    `kernel_variant` names them and the counts record them (two runs:
    `_launched_kernels`); no bf16 kernel."""
    q, k, v, do = _bf16_operands(gen, 1, 200, 200, 2, d, torch.float16)
    fa.reset_counts()

    def run():
        o, lse = fa.flash_forward(q, k, v, True)
        fa.flash_backward(q, k, v, o, do, lse, True)

    names = " ".join(n for n in _launched_kernels(run) if "flash_" in n)
    wgmma = d <= fa.WGMMA_MAX_HEAD_DIM
    assert "bf16" not in names, names
    for kernel in ("flash_fwd_f16", "flash_bwd_dq_f16", "flash_bwd_dkv_f16"):
        assert (f"{kernel}_wgmma_kernel" in names) == wgmma, (d, names)
        assert (f"{kernel}_kernel" in names) != wgmma, (d, names)
    for name, c in fa.counts_for(False, torch.float16).items():
        variant = fa.kernel_variant(name, torch.float16, d)
        assert variant == ("wgmma" if wgmma else "mma")
        assert c.form_launches == {variant: 2}, (name, c.form_launches)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_f16_autograd_launches_only_the_f16_kernels(gen, masked):
    """flash_attention's autograd path on fp16 operands launches the fp16
    forward, dq and dk/dv once each and nothing else; its gradients are
    finite."""
    q, k, v, do = _bf16_operands(gen, 2, 200, 200, 4, 64, torch.float16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    mask = None
    if masked:
        mask = ((torch.arange(200, device="cuda") >= 170).float()
                * -1e4)[None, None, None, :].expand(2, 1, 1, 200)
    fa.reset_counts()
    o = fa.flash_attention(q, k, v, causal=not masked, mask=mask)
    grads = torch.autograd.grad(o, (q, k, v), do)
    assert o.dtype == torch.float16
    assert all(g.dtype == torch.float16 and torch.isfinite(g).all()
               for g in grads)
    ran = fa.counts_for(masked, torch.float16)
    for group in fa.COUNTS.values():
        want = (1, 0) if group is ran else (0, 0)
        assert {n: (c.kernel_launches, c.plain_launches)
                for n, c in group.items()} == dict.fromkeys(group, want)


def test_foreach_adamw_equals_the_per_parameter_update(gen):
    """AdamW.step (multi-tensor, grouped by decay and dtype, in chunks)
    against its update over each parameter alone (`_update([p], ...)`) on
    the same fp32 and bf16 (master) parameters, gradients and clip, over 5
    steps: within 1e-6."""
    shapes = [(64, 48), (48,), (7, 5, 3), (256, 128)]
    dtypes = [torch.float32, torch.bfloat16, torch.float32, torch.bfloat16]

    def params():
        g = torch.Generator(device="cuda")
        g.manual_seed(1)
        return [(f"p{i}" + ("_norm" if i == 1 else ""),
                 torch.randn(s, device="cuda", generator=g).to(dt))
                for i, (s, dt) in enumerate(zip(shapes, dtypes))]

    def make(ps):
        return AdamW(1e-3, parameters=ps, weight_decay=0.1,
                     grad_clip=ClipGradByGlobalNorm(1.0),
                     apply_decay_param_fun=lambda n: "norm" not in n)

    a, b = params(), params()
    opt_a, opt_b = make(a), make(b)
    for step in range(1, 6):
        for (_, pa), (_, pb) in zip(a, b):
            g = torch.randn(pa.shape, device="cuda", generator=gen) \
                * 10.0 ** -step
            # two copies: the clip scales each optimizer's in place
            pa.grad, pb.grad = g.to(pa.dtype).clone(), g.to(pb.dtype).clone()
        opt_a.step()
        opt_b._grad_clip.clip_([p.grad for _, p in b])
        opt_b._step_i += 1
        for _, p in b:
            opt_b._update([p], [p.grad], opt_b._lr, opt_b._decay_for(p),
                          opt_b._step_i)
        for (name, pa), (_, pb) in zip(a, b):
            sa, sb = opt_a.state[pa], opt_b.state[pb]
            assert set(sa) == set(sb)
            for key in sa:
                torch.testing.assert_close(sa[key], sb[key], rtol=1e-6,
                                           atol=1e-6, msg=(name, key))
            torch.testing.assert_close(pa.float(), pb.float(), rtol=1e-6,
                                       atol=1e-6, msg=name)
            if "master" in sa:
                assert torch.equal(pa, sa["master"].to(pa.dtype))


def _amp_llama_once(cfg, ids, labels, use_flash, level):
    from paddle_tpu_torch import amp
    model = Llama(cfg, device="cuda", seed=3)
    if level == "O2":
        amp.decorate(model, level="O2")
    old = flag("FLAGS_use_flash_attention")
    set_flags({"FLAGS_use_flash_attention": use_flash})
    try:
        with amp.auto_cast(level=level):
            logits = model(ids)
        loss = llama_loss_fn(logits, labels)
        loss.backward()
    finally:
        set_flags({"FLAGS_use_flash_attention": old})
    return loss.float().item(), {n: p.grad.float()
                                 for n, p in model.named_parameters()}


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_small_llama_amp_through_the_bf16_kernels_matches_dense(gen, level):
    """A bf16 AMP step of a small Llama through the bf16 kernels against the
    same step on the dense path (bf16 probabilities there, fp32 P in the
    kernels): loss within 2e-2 relative, gradients within 5e-2 of max;
    then AdamW steps through the kernels bring the loss down."""
    from paddle_tpu_torch import amp
    cfg = LlamaConfig(vocab_size=211, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=256)
    toks = torch.randint(0, 211, (2, 201), device="cuda", generator=gen)
    ids, labels = toks[:, :-1], toks[:, 1:]
    fa.reset_counts()
    loss_k, grads_k = _amp_llama_once(cfg, ids, labels, True, level)
    assert all(c.kernel_launches == 2 and c.plain_launches == 0
               for c in fa.counts_for(False, torch.bfloat16).values())
    assert all(c.kernel_launches == 0 for c in fa.counts_for(False).values())
    loss_d, grads_d = _amp_llama_once(cfg, ids, labels, False, level)
    assert abs(loss_k - loss_d) <= 2e-2 * abs(loss_d)
    for name, g in grads_k.items():
        ref = grads_d[name]
        assert (g - ref).abs().max().item() <= \
            5e-2 * ref.abs().max().item(), name
    model = Llama(cfg, device="cuda", seed=3)
    if level == "O2":
        amp.decorate(model, level="O2")
    step = TrainStep(model, llama_loss_fn, AdamW(
        learning_rate=1e-3, parameters=model.named_parameters(),
        grad_clip=ClipGradByGlobalNorm(1.0)), amp_level=level)
    losses = [step(ids, labels).float().item() for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ---------------------------------------------- CUDA graphs and horizons

GRAPH_CFG = dict(vocab_size=211, hidden_size=256, num_layers=2, num_heads=4,
                 num_kv_heads=4, max_seq_len=128)


def _prefilled_pools(runner, prompt, P=8):
    from paddle_tpu_torch.serving import KVCachePool
    pool = KVCachePool(runner.num_layers, P + 2, runner.block_size,
                       runner.n_kv_heads, runner.head_dim, device="cuda",
                       kv_dtype=runner.kv_dtype)
    table = pool.pad_table(pool.allocator.alloc(P), P)
    runner.prefill(prompt, table, pool.shards)
    return pool.shards, np.asarray([table, [0] * P], np.int32)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
def test_graph_replay_equals_eager_bitwise(gen, kv_dtype):
    model = Llama(LlamaConfig(**GRAPH_CFG), device="cuda", seed=0)
    runner = LlamaRunner(model, block_size=16, kv_dtype=kv_dtype)
    prompt = np.random.default_rng(0).integers(1, 211, 40).tolist()
    pools_g, tabs = _prefilled_pools(runner, prompt)
    pools_e, _ = _prefilled_pools(runner, prompt)
    ext = dict(seeds=np.asarray([3, 0]), base_steps=np.asarray([1, 0]),
               temps=np.asarray([0.8, 0.0], np.float32), top_k=20,
               top_p=0.9, stop_ids=np.asarray([[-1], [-1]]),
               remaining=[30, 1], early_stop=True)
    every = (k1.COUNTS, k1.COUNTS_I8, k1.COUNTS_F8, k2.COUNTS)
    calls = [("decode", (np.asarray([5 + i, 0]), tabs,
                         np.asarray([40 + i, 0])), (), {}) for i in range(3)]
    calls += [("decode_multi", (np.asarray([3, 0]), tabs,
                                np.asarray([43 + 8 * i, 0])), (8,), kw)
              for i, kw in enumerate(({}, {}, ext, ext))]
    # the first graphed call of a kind runs for real and captures it, the
    # later ones replay
    for kind, args, n, kw in calls:
        before = [c.kernel_launches for c in every]
        runner.graphs = False
        out_e, _ = getattr(runner, kind)(*args, pools_e, *n, **kw)
        out_e = out_e.clone()
        mid = [c.kernel_launches for c in every]
        runner.graphs = True
        out_g, _ = getattr(runner, kind)(*args, pools_g, *n, **kw)
        torch.cuda.synchronize()
        after = [c.kernel_launches for c in every]
        assert [b - a for a, b in zip(mid, after)] == \
            [b - a for a, b in zip(before, mid)]
        assert torch.equal(out_g, out_e), (kind, kv_dtype)
    assert sum(c.plain_launches for c in every) == 0
    assert [c["kind"] for c in runner.captures] == [
        "decode", "decode_multi", "decode_multi_x"]
    for a, b in zip(pools_e[0], pools_g[0]):
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.uint8) if x.element_size() == 1
                               else x, y.view(torch.uint8)
                               if y.element_size() == 1 else y)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
def test_horizon_engine_equals_per_step_engine_on_the_card(gen, kv_dtype):
    model = Llama(LlamaConfig(**GRAPH_CFG), device="cuda", seed=0)
    rng = np.random.default_rng(1)
    work = []
    for i in range(6):
        p = rng.integers(1, 211, int(rng.integers(5, 40))).tolist()
        sp = (SamplingParams(max_tokens=24) if i < 3 else SamplingParams(
            max_tokens=24, temperature=0.7, top_k=50, top_p=0.9, seed=i,
            stop_token_ids=(int(rng.integers(1, 211)),)))
        work.append((p, sp))
    streams = []
    for knobs in ({}, dict(decode_horizon=8, pipelined=True,
                           horizon_sampling=True, horizon_early_stop=True)):
        runner = LlamaRunner(model, block_size=16, kv_dtype=kv_dtype)
        runner.graphs = bool(knobs)
        eng = ServingEngine(runner, num_blocks=40, max_batch_size=4,
                            max_prefill_tokens_per_step=32, audit=True,
                            **knobs)
        ids = [eng.add_request(p, sp) for p, sp in work]
        outs = eng.run()
        streams.append([outs[i].output_tokens for i in ids])
        assert eng.pool.allocator.check_no_leaks()
        if knobs:
            assert eng.metrics.decode_horizon_steps.value > 0
    assert streams[0] == streams[1]


def test_sampler_on_the_card_equals_the_cpu(gen):
    from paddle_tpu_torch.serving.model_runner import PagedModelRunner
    rng = np.random.default_rng(2)
    logits = torch.from_numpy((rng.standard_normal((64, 32000)) * 3).astype(
        np.float32))
    seeds = torch.arange(64, dtype=torch.int64) % 8
    steps = torch.arange(64, dtype=torch.int64) % 32
    temps = torch.tensor([0.3, 0.7, 1.0, 1.5] * 16)
    for top_k, top_p in ((None, None), (1, None), (50, None), (None, 0.9),
                         (8, 0.9)):
        cpu = PagedModelRunner._sampled_rows(logits, seeds, steps, temps,
                                             top_k, top_p)
        card = PagedModelRunner._sampled_rows(
            logits.cuda(), seeds.cuda(), steps.cuda(), temps.cuda(), top_k,
            top_p)
        assert torch.equal(card.cpu(), cpu), (top_k, top_p)


# ------------------------------------------------------------------- GPT

GPT_SIZES = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
                 max_seq_len=128)


def _gpt(**kw):
    from paddle_tpu_torch.models import GPT, GPTConfig
    return GPT(GPTConfig(**{**GPT_SIZES, **kw}), device="cuda", seed=3)


def _serving_counts():
    return {"K1": k1.COUNTS, "K1-q int8": k1.COUNTS_I8,
            "K1-q fp8": k1.COUNTS_F8, "K2": k2.COUNTS}


def test_gpt_runner_launches_k1_for_prefill_and_k2_for_decode(gen):
    """A GPT engine on the card: prefill chunks through K1, decode steps
    through K2 once a layer each, no plain launch; its tokens equal its
    naive_generate (one slot: naive_generate's row counts)."""
    from paddle_tpu_torch.inference import create_serving_engine
    model = _gpt()
    eng = create_serving_engine(model, block_size=16, max_model_len=128,
                                num_blocks=32, max_batch_size=1,
                                max_prefill_tokens_per_step=32)
    eng.runner.graphs = False
    for c in _serving_counts().values():
        c.reset()
    sp = SamplingParams(max_tokens=8)
    prompt = list(range(1, 50))
    rid = eng.add_request(prompt, sp)
    out = eng.run()[rid].output_tokens
    chunks = int(eng.metrics.prefill_chunks.value)
    decodes = eng.metrics.batch_occupancy.count
    got = {n: (c.kernel_launches, c.plain_launches)
           for n, c in _serving_counts().items()}
    assert got == {"K1": (2 * chunks, 0), "K1-q int8": (0, 0),
                   "K1-q fp8": (0, 0), "K2": (2 * decodes, 0)}
    assert chunks == 2 and decodes == 7
    assert out == naive_generate(eng.runner, prompt, sp, max_model_len=128)
    assert eng.pool.allocator.check_no_leaks()


def test_paged_gpt_generator_launches_k2_from_a_scalar_pos(gen):
    from paddle_tpu_torch.models.generation import (
        GPTGenerator, PagedGPTGenerator, block_multihead_attention,
    )
    model = _gpt()
    ids = torch.randint(1, 97, (3, 20), device="cuda", generator=gen)
    k2.COUNTS.reset()
    out = PagedGPTGenerator(model, block_size=16).generate(
        ids, max_new_tokens=6, temperature=0.0)
    assert (k2.COUNTS.kernel_launches, k2.COUNTS.plain_launches) == (10, 0)
    dense = GPTGenerator(model).generate(ids, max_new_tokens=6,
                                         temperature=0.0)
    assert torch.equal(out, dense)
    # a head dim K2 does not tile raises on the card unless asked for the
    # gather path
    q = torch.randn(2, 1, 2, 12, device="cuda", generator=gen)
    pool = torch.randn(4, 8, 2, 12, device="cuda", generator=gen)
    table = torch.arange(4, dtype=torch.int32, device="cuda").reshape(2, 2)
    with pytest.raises(ValueError, match="head_dim 12"):
        block_multihead_attention(q, pool, pool, table, 5)
    ref = block_multihead_attention(q, pool, pool, table, 5,
                                    attn_impl="reference")
    assert ref.shape == (2, 1, 24)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_generator_token_steps_copy_nothing_from_the_host(gen, paged):
    """`generate`'s loop body (the key's fold_in, then `_decode_call`),
    greedy: no host-to-device copy and no stream wait, so the host runs
    ahead of the card (the step's positions are made on the device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.models.generation import (
        GPTGenerator, PagedGPTGenerator,
    )
    model = _gpt()
    g = PagedGPTGenerator(model, block_size=16) if paged else \
        GPTGenerator(model)
    ids = torch.randint(1, 97, (3, 20), device="cuda", generator=gen)
    logits, state = g._prefill_call(ids, g._make_state(3))
    tok = torch.argmax(logits, dim=-1)
    key = prandom.key(0).to("cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            key = prandom.fold_in(key, i)
            tok, state = g._decode_call(tok, state, 20 + i, key, 0.0, None,
                                        None)
    torch.cuda.synchronize()
    events = prof.key_averages()
    assert [e.key for e in events if e.device_type == DeviceType.CUDA
            and "HtoD" in e.key] == []
    assert [e.key for e in events if e.key == "cudaStreamSynchronize"] == []


def test_gpt_o1_step_launches_the_wgmma_flash_route_only(gen):
    from paddle_tpu_torch.models import gpt_loss_fn
    from paddle_tpu_torch.optimizer import lr
    model = _gpt()
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, 4, 1e-4), 1, 0.0,
                            1e-3)
    opt = AdamW(learning_rate=sched, parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, gpt_loss_fn, opt, amp_level="O1")
    toks = torch.randint(0, 97, (2, 129), device="cuda", generator=gen)
    fa.reset_counts()
    losses = []
    for _ in range(3):
        losses.append(step(toks[:, :-1], toks[:, 1:]).float().item())
        sched.step()
    for (masked, dtype), group in fa.COUNTS.items():
        for name, c in group.items():
            want = 6 if (not masked and dtype == torch.bfloat16) else 0
            assert (c.kernel_launches, c.plain_launches) == (want, 0), \
                (masked, dtype, name)
            if want:
                assert c.form_launches == {"wgmma": want}
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# ------------------------------- prefix cache, fused steps, speculation

def _spec_pools(runner, prompts, P=8):
    """A pool holding each prompt prefilled in its own table row."""
    from paddle_tpu_torch.serving import KVCachePool
    pool = KVCachePool(runner.num_layers, 1 + len(prompts) * P,
                       runner.block_size, runner.n_kv_heads, runner.head_dim,
                       device="cuda", kv_dtype=runner.kv_dtype)
    tables = []
    for p in prompts:
        tables.append(pool.pad_table(pool.allocator.alloc(P), P))
        runner.prefill(p, tables[-1], pool.shards)
    return pool, np.asarray(tables, np.int32)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
def test_fused_ragged_launch_matches_plain(gen, kv_dtype):
    """One fused launch (a 32-row chunk at start_pos 40 beside decode rows
    and a dead slot): K1 / K1-q against its plain version on the same
    tensors, and the runner's fused logits against its gather path."""
    model = Llama(LlamaConfig(**GRAPH_CFG), device="cuda", seed=0)
    runner = LlamaRunner(model, block_size=16, kv_dtype=kv_dtype)
    ref = LlamaRunner(model, block_size=16, attn_impl="reference",
                      kv_dtype=kv_dtype)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 211, n).tolist() for n in (40, 17, 30)]
    pool, tables = _spec_pools(runner, prompts)
    pool_r, _ = _spec_pools(ref, prompts)
    B, T = 4, 32
    tokens = np.zeros((B, T), np.int32)
    tokens[0] = rng.integers(1, 211, T)
    tokens[1:3, 0] = [7, 9]
    starts = np.asarray([40, 17, 30, 0], np.int32)
    qlens = np.asarray([T, 1, 1, 0], np.int32)
    tabs = np.concatenate([tables, np.zeros((1, 8), np.int32)])
    k1_counts = {"fp32": k1.COUNTS, "int8": k1.COUNTS_I8,
                 "fp8": k1.COUNTS_F8}[kv_dtype]
    k1_counts.reset()
    got, _ = runner.ragged_step(tokens, tabs, starts, qlens, pool.shards,
                                full_logits=True)
    want, _ = ref.ragged_step(tokens, tabs, starts, qlens, pool_r.shards,
                              full_logits=True)
    assert k1_counts.form_launches == {"span": GRAPH_CFG["num_layers"]}
    rows = [(0, t) for t in range(T)] + [(1, 0), (2, 0)]
    g = torch.stack([got[r] for r in rows])
    w = torch.stack([want[r] for r in rows])
    assert (g - w).abs().max().item() <= TOL * w.abs().max().item()
    # the kernel alone at the launch's operands
    layer = pool.pools[0]
    scales = {} if kv_dtype != "int8" else dict(k_scale=layer[2],
                                                v_scale=layer[3])
    q = torch.randn(B, T, 4, 64, device="cuda", generator=gen)
    ops = (q, layer[0], layer[1], torch.from_numpy(tabs).cuda(),
           torch.from_numpy(starts).cuda(), torch.from_numpy(qlens).cuda())
    out = k1.ragged_paged_attention(*ops, **scales)
    plain = k1.ragged_reference(*ops, **scales)
    assert (out - plain).abs().max().item() <= TOL
    assert torch.equal(out[3], torch.zeros_like(out[3]))    # dead slot
    assert torch.equal(out[1, 1:], torch.zeros_like(out[1, 1:]))


@pytest.mark.parametrize("sampling", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
def test_speculative_horizon_graph_replay_equals_eager(gen, kv_dtype,
                                                       sampling):
    model = Llama(LlamaConfig(**GRAPH_CFG), device="cuda", seed=0)
    runner = LlamaRunner(model, block_size=16, kv_dtype=kv_dtype)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 211, n).tolist() for n in (40, 23)]
    pool_g, tables = _spec_pools(runner, prompts)
    pool_e, _ = _spec_pools(runner, prompts)
    B, s, K = 2, 4, 7
    kw = dict(stop_ids=np.asarray([[-1], [5]], np.int32),
              remaining=np.asarray([30, 12], np.int32))
    if sampling:
        kw.update(seeds=np.asarray([3, 4]), base_steps=np.asarray([0, 2]),
                  temps=np.asarray([0.8, 0.0], np.float32), top_k=20,
                  top_p=None)
    every = (k1.COUNTS, k1.COUNTS_I8, k1.COUNTS_F8, k2.COUNTS)
    for i in range(3):          # capture, then two replays
        drafts = np.full((B, s, K), -1, np.int32)
        drafts[0, :, :3] = rng.integers(1, 211, (s, 3))
        drafts[1, :, :5] = rng.integers(1, 211, (s, 5))
        args = (np.asarray([3 + i, 4 + i]), tables,
                np.asarray([40 + 16 * i, 23 + 16 * i]))
        before = [c.kernel_launches for c in every]
        runner.graphs = False
        out_e, _ = runner.decode_multi_spec(*args, pool_e.shards, drafts,
                                            **kw)
        out_e = out_e.clone()
        mid = [c.kernel_launches for c in every]
        runner.graphs = True
        out_g, _ = runner.decode_multi_spec(*args, pool_g.shards, drafts,
                                            **kw)
        torch.cuda.synchronize()
        after = [c.kernel_launches for c in every]
        assert [b - a for a, b in zip(mid, after)] == \
            [b - a for a, b in zip(before, mid)]
        assert torch.equal(out_g, out_e), (i, kv_dtype)
    assert sum(c.plain_launches for c in every) == 0
    assert [c["kind"] for c in runner.captures] == ["decode_multi_spec"]
    for a, b in zip(pool_e.pools, pool_g.pools):
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
def test_copy_page_leaves_the_source_unchanged(gen, kv_dtype):
    """A copy-on-write fork on the card: the source page's bytes (codes
    and scale rows on int8) are the same before and after, and the fork
    equals them."""
    from paddle_tpu_torch.serving import KVCachePool, SequenceKV
    model = Llama(LlamaConfig(**GRAPH_CFG), device="cuda", seed=0)
    runner = LlamaRunner(model, block_size=16, kv_dtype=kv_dtype)
    pool = KVCachePool(runner.num_layers, 8, 16, runner.n_kv_heads,
                       runner.head_dim, device="cuda", kv_dtype=kv_dtype)
    cache = pool.enable_prefix_cache()
    prompt = np.random.default_rng(4).integers(1, 211, 20).tolist()
    a = SequenceKV(pool)
    a.grow(len(prompt) + 1)
    runner.prefill(prompt, pool.pad_table(a.pages, 4), pool.shards)
    a.num_tokens = len(prompt)
    cache.register_seq(a, prompt)
    b = SequenceKV(pool)
    matched = cache.match(prompt)
    cache.acquire(matched)
    b.adopt_prefix(matched, 16)
    src = b.pages[0]

    def page_bytes(p):
        return [t.view(torch.uint8)[p].clone() for layer in pool.pools
                for t in layer]
    before = page_bytes(src)
    assert b.ensure_writable(0, 16) == 1
    torch.cuda.synchronize()
    for x, y, z in zip(before, page_bytes(src), page_bytes(b.pages[0])):
        assert torch.equal(x, y) and torch.equal(x, z)
    b.release()
    a.release()
    cache.clear()
    assert pool.allocator.check_no_leaks()


# ------------------------------------------- bf16 serving kernels (K1, K2)

# the pools a bf16 or an fp16 runner serves from, by name: its own dtype's,
# int8 and fp8
BF16_POOLS = {"bf16": torch.bfloat16, "int8": torch.int8,
              "fp8": torch.float8_e4m3fn}
F16_POOLS = {"fp16": torch.float16, "int8": torch.int8,
             "fp8": torch.float8_e4m3fn}
HALF_NAMES = {torch.bfloat16: "bf16", torch.float16: "fp16"}


def _half_pools(gen, kind, kp, vp):
    """fp32 pools -> what a 16-bit runner serves from: pools of its dtype
    (kind "bf16" or "fp16"), or the int8 / fp8 pools of `_quantize`."""
    if kind in ("bf16", "fp16"):
        dt = {**BF16_POOLS, **F16_POOLS}[kind]
        return kp.to(dt), vp.to(dt), None, None
    return _quantize(gen, kp, vp, kind)


def _half_ragged_forms(gen, kind, d, ps, n_rep, half, big):
    """Both forms of K1 on 16-bit q (``half``) over ``kind`` pools: the
    spans of the fp32 test above, and decode-form walks of 255, 257 and
    4096 keys (on and across the split walk's 256-key splits; int8 pages
    there with scales of 1e-3 and ``big``), also at decode steps (T = 1;
    at n_rep 1 the one-row walk), a 16-bit output held against the plain
    version (fp32 compute, one rounding) and its fp64 evaluation on the
    same operands within the 16-bit gates, with rows past q_len and the
    dead slot exactly 0. A decode launch at d <= SPLIT_MAX_HEAD_DIM over
    a table of more than one split counts as "decode_split"."""
    pools = {"bf16": BF16_POOLS, "fp16": F16_POOLS}[HALF_NAMES[half]]
    counts = k1.counts_for(half, pools[kind])
    T_dec = k1.DECODE_ROWS // n_rep
    short = ([0, 5, 70, 3], lambda T: [T, 1, max(1, T - 2), 0])
    long = ([255 - T_dec, 257 - T_dec, 4096 - T_dec, 3],
            lambda T: [T, T, T, 0])
    # decode steps (T = 1) on and across the splits; at n_rep 1 one row a
    # kv head: the one-row walk
    one = ([254, 256, 4095, 3], lambda T: [1, 1, 1, 0])
    for T, form, (starts, lens) in ((T_dec, "decode", short),
                                    (T_dec + 1, "span", short),
                                    (37, "span", short),
                                    (T_dec, "decode", long),
                                    (1, "decode", one)):
        qlens = lens(T)
        pages = (T + max(starts)) // ps + 2
        q, kp, vp, table = _operands(gen, 4, T, 2, n_rep, d, ps, pages)
        q = q.to(half)
        table[3] = 0                               # dead slot: all scratch
        k, v, ks, vs = _half_pools(gen, kind, kp, vp)
        if ks is not None and starts is not short[0]:
            ks, vs = (torch.where(torch.rand(t.shape, device="cuda",
                                             generator=gen) < 0.5, 1e-3,
                                  big).float() for t in (ks, vs))
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        ql = torch.tensor(qlens, dtype=torch.int32, device="cuda")
        counts.reset()
        out = k1.ragged_paged_attention(q, k, v, table, st, ql, k_scale=ks,
                                        v_scale=vs)
        if form == "decode" and d <= k1.SPLIT_MAX_HEAD_DIM \
                and k1.decode_splits(pages, ps) > 1:
            form = "decode_split"
        assert counts.form_launches == {form: 1}
        assert counts.plain_launches == 0
        assert out.dtype == half and torch.isfinite(out).all()
        plain = k1.ragged_reference(q, k, v, table, st, ql, k_scale=ks,
                                    v_scale=vs)
        exact = k1.ragged_reference(q.double(), *_as_fp64(kind, k, v),
                                    table, st, ql, k_scale=ks, v_scale=vs)
        _bf16_class(out, plain, exact, (kind, d, T, form))
        _bf16_misround(out, plain, exact, (kind, d, T, form))
        for b, n in enumerate(qlens):
            assert bool((out[b, n:] == 0).all()), f"sequence {b}: rows >= {n}"


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("d", [8, 64, 128, 136, 256])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
def test_bf16_ragged_kernel_forms_against_fp64(gen, kind, d, ps, n_rep):
    """Both forms of K1 on bf16 q, over bf16 pools (K1-bf16) and int8 /
    fp8 pools (K1-q) (`_half_ragged_forms`, int8 scales of 1e-3 and 1e3
    on the long walks)."""
    _half_ragged_forms(gen, kind, d, ps, n_rep, torch.bfloat16, 1e3)


def _half_paged_decode(monkeypatch, gen, keys_per_split, d, ps, half):
    """K2 at 16-bit (``half``) over the fp32 test's 640-key table: q and
    pools of that dtype, an output of it within the 16-bit gates against
    the plain version and its fp64 evaluation on the same operands; the
    dead slot's output 0."""
    monkeypatch.setattr(k2, "KEYS_PER_SPLIT", keys_per_split)
    cap = 640
    pages = cap // ps
    pos_list = [0, keys_per_split - 1, keys_per_split, 301, cap - 1,
                cap + 77, 0]
    b, h = len(pos_list), 2
    q, kp, vp, table = _operands(gen, b, 1, h, 1, d, ps, pages)
    q, kp, vp = (t.to(half) for t in (q, kp, vp))
    table[-1] = 0                                  # dead slot: all scratch
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    counts = k2.counts_for(half)
    counts.reset()
    out = k2.paged_decode_attention(q[:, 0], kp, vp, table, pos)
    assert counts.kernel_launches == 1 and counts.plain_launches == 0
    assert out.dtype == half and torch.isfinite(out).all()
    plain = k2.paged_decode_reference(q[:, 0], kp, vp, table, pos)
    exact = k2.paged_decode_reference(q[:, 0].double(), kp.double(),
                                      vp.double(), table, pos)
    what = f"K2-{HALF_NAMES[half]} d={d} ps={ps} ks={keys_per_split}"
    _bf16_class(out, plain, exact, what)
    _bf16_misround(out, plain, exact, what)


@pytest.mark.parametrize("keys_per_split", [k2.SPLIT_TILE,
                                            k2.KEYS_PER_SPLIT])
@pytest.mark.parametrize("d", [8, 64, 96, 128, 256])
@pytest.mark.parametrize("ps", [1, 8, 16, 32])
def test_bf16_paged_decode_kernel_against_fp64(gen, monkeypatch,
                                               keys_per_split, d, ps):
    """K2-bf16 (`_half_paged_decode`)."""
    _half_paged_decode(monkeypatch, gen, keys_per_split, d, ps,
                       torch.bfloat16)


def test_bf16_paged_decode_kernel_is_batch_invariant(gen):
    """As the fp32 kernel: a sequence's bf16 output alone equals its output
    inside the batch, bit for bit."""
    h, d, ps, pages = 4, 128, 16, 256
    pos_list = [300, 4095, 0, 129, 2047, 16, 3000, 127]
    q, kp, vp, table = _operands(gen, len(pos_list), 1, h, 1, d, ps, pages)
    q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    out = k2.paged_decode_attention(q[:, 0], kp, vp, table, pos)
    for i in range(len(pos_list)):
        alone = k2.paged_decode_attention(q[i:i + 1, 0], kp, vp,
                                          table[i:i + 1], pos[i:i + 1])
        assert torch.equal(alone[0], out[i]), f"sequence {i}"


@pytest.mark.parametrize("n_rep", [1, 4], ids=["mha", "gqa4"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_bf16_ragged_decode_form_is_batch_invariant(gen, kind, n_rep):
    """As K2: the bf16-q decode form's split walk (on the tensor cores at
    GQA-4, the one-row walk at MHA) gives each sequence's rows alone what
    it gives them inside the batch, bit for bit, at walks on and across
    its 256-key splits."""
    h, d, ps, pages = 2, 128, 16, 256
    pos_list = [300, 4095, 0, 255, 256, 16, 3000, 127]
    q, kp, vp, table = _operands(gen, len(pos_list), 1, h, n_rep, d, ps,
                                 pages)
    q = q.to(torch.bfloat16)
    k, v, ks, vs = _half_pools(gen, kind, kp, vp)
    st = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    ql = torch.ones_like(st)
    counts = k1.counts_for(torch.bfloat16, BF16_POOLS[kind])
    counts.reset()
    out = k1.ragged_paged_attention(q, k, v, table, st, ql, k_scale=ks,
                                    v_scale=vs)
    assert counts.form_launches == {"decode_split": 1}
    for i in range(len(pos_list)):
        alone = k1.ragged_paged_attention(q[i:i + 1], k, v, table[i:i + 1],
                                          st[i:i + 1], ql[i:i + 1],
                                          k_scale=ks, v_scale=vs)
        assert torch.equal(alone[0], out[i]), f"sequence {i}"


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_bf16_ragged_decode_form_graph_replay_equals_eager(gen, kind):
    """Two chained bf16-q decode-form launches captured in one CUDA graph
    (the workspace and tickets made by the warm-up on the capture stream)
    replay to the eager launches' output bit for bit (`chip_smoke.py`'s
    check_ragged_graph, at 8 query heads over 2 kv heads)."""
    _chip_smoke().check_ragged_graph(gen, kind, n_q=8, n_kv=2)


def test_serving_kernels_refuse_mixed_dtypes(gen):
    """bf16 q over fp32 pools (and fp32 q over bf16 pools) is no variant:
    the wrappers raise, they never cast."""
    q, kp, vp, table = _operands(gen, 1, 8, 2, 1, 64, 4, 4)
    z = torch.zeros(1, dtype=torch.int32, device="cuda")
    bq, bk, bv = (t.to(torch.bfloat16) for t in (q, kp, vp))
    for args in ((bq, kp, vp), (q, bk, bv)):
        with pytest.raises(TypeError):
            k1.ragged_paged_attention(*args, table, z, z + 1)
        with pytest.raises(TypeError):
            k2.paged_decode_attention(args[0][:, 0], *args[1:], table, z)


def _half_engine(kv_dtype, n_kv, half):
    """create_serving_engine(dtype=half) on the card: pools of that dtype
    (the "fp32" rung at the runner's dtype) or int8 / fp8 ones, every
    attention call through a kernel of q's dtype (K2 of that dtype for MHA
    decode over 16-bit pools), no kernel of another dtype and no plain
    version; a one-slot engine (cuBLAS rounds a row differently at every
    row count) token-exact against its naive_generate, with the horizon
    engine's streams equal to it."""
    from paddle_tpu_torch.inference import create_serving_engine
    cfg = LlamaConfig(vocab_size=211, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=n_kv, max_seq_len=128)
    model = Llama(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    work = [(rng.integers(1, 211, int(rng.integers(5, 70))).tolist(),
             int(rng.integers(2, 12))) for _ in range(4)]
    pool = {"fp32": half, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}[kv_dtype]
    mine = (k1.counts_for(half, pool), k2.counts_for(half))
    others = [c for c in (*k1._VARIANTS.values(), *k2._VARIANTS.values())
              if c[0] not in mine]
    streams = []
    for knobs in ({}, dict(decode_horizon=4)):
        eng = create_serving_engine(
            model, dtype=half, kv_dtype=kv_dtype, block_size=16,
            num_blocks=24, max_batch_size=1, max_prefill_tokens_per_step=32,
            audit=True, **knobs)
        assert eng.runner.dtype == half
        assert eng.pool.pools[0][0].dtype == pool
        for counts, _ in (*others, *((c, None) for c in mine)):
            counts.reset()
        ids = [eng.add_request(p, SamplingParams(max_tokens=n))
               for p, n in work]
        outs = eng.run()
        assert mine[0].kernel_launches > 0 and mine[0].plain_launches == 0
        mha_decode = n_kv == cfg.num_heads and kv_dtype == "fp32"
        assert (mine[1].kernel_launches > 0) == mha_decode
        assert all(c.kernel_launches == c.plain_launches == 0
                   for c, _ in others)
        streams.append([outs[rid].output_tokens for rid in ids])
        assert eng.pool.allocator.check_no_leaks()
    assert streams[0] == streams[1]
    assert streams[0] == [naive_generate(eng.runner, p,
                                         SamplingParams(max_tokens=n))
                          for p, n in work]


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("n_kv", [4, 2], ids=["mha", "gqa"])
def test_bf16_engine_on_the_card_runs_the_bf16_kernels(gen, kv_dtype, n_kv):
    """`_half_engine` at dtype=bfloat16."""
    _half_engine(kv_dtype, n_kv, torch.bfloat16)


# ------------------------------------------- fp16 serving kernels (K1, K2)

@pytest.mark.parametrize("kind", ["fp16", "int8", "fp8"])
@pytest.mark.parametrize("d", [8, 64, 128, 136, 256])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
def test_f16_ragged_kernel_forms_against_fp64(gen, kind, d, ps, n_rep):
    """`_half_ragged_forms` at fp16: K1-fp16 over fp16 pools and K1-q with
    fp16 q over int8 / fp8 pools, int8 scales of 1e-3 and 1e2 on the long
    walks (1e3 would take codes past fp16's 65504: the range cases
    below)."""
    _half_ragged_forms(gen, kind, d, ps, n_rep, torch.float16, 1e2)


@pytest.mark.parametrize("case", ["int8", "int8-overflow", "fp16",
                                  "int8-k-large"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("n_rep,T", [(1, 1), (4, 2), (1, 300), (4, 64)],
                         ids=["mha-decode", "gqa-decode", "span-mha",
                              "span-gqa"])
def test_f16_ragged_kernel_keeps_fp16s_range(gen, case, d, n_rep, T):
    """`chip_smoke.py`'s check_ragged_range: int8 pages whose k and v
    scales are 1e-6 or 1e2 (P times the v scale far below and above
    fp16's normal range: the factor of P a row), k scales of 1e3 (scores
    of ~7e4), v scales of 1e3 (outputs past 65504), or fp16 q times 30
    (scores of +-100); the output finite exactly where the plain
    version's is, within twice its error against fp64 and misrounding at
    most 1/16."""
    _chip_smoke().check_ragged_range(gen, case, n_rep, T, d=d)


@pytest.mark.parametrize("keys_per_split", [k2.SPLIT_TILE,
                                            k2.KEYS_PER_SPLIT])
@pytest.mark.parametrize("d", [8, 64, 96, 128, 256])
@pytest.mark.parametrize("ps", [1, 8, 16, 32])
def test_f16_paged_decode_kernel_against_fp64(gen, monkeypatch,
                                              keys_per_split, d, ps):
    """K2-fp16 (`_half_paged_decode`)."""
    _half_paged_decode(monkeypatch, gen, keys_per_split, d, ps,
                       torch.float16)


@pytest.mark.parametrize("n_rep", [1, 4], ids=["mha", "gqa4"])
@pytest.mark.parametrize("kind", ["fp16", "int8", "fp8"])
def test_f16_ragged_decode_form_is_batch_invariant(gen, kind, n_rep):
    """`chip_smoke.py`'s check_ragged_invariance at fp16: each sequence's
    rows alone equal its rows inside the batch, bit for bit."""
    _chip_smoke().check_ragged_invariance(gen, kind, n_q=2 * n_rep, n_kv=2,
                                          half=torch.float16)


@pytest.mark.parametrize("kind", ["fp16", "int8", "fp8"])
def test_f16_ragged_decode_form_graph_replay_equals_eager(gen, kind):
    """`chip_smoke.py`'s check_ragged_graph at fp16."""
    _chip_smoke().check_ragged_graph(gen, kind, n_q=8, n_kv=2,
                                     half=torch.float16)


@pytest.mark.parametrize("kind", ["fp16", "int8", "fp8"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_f16_forms_launch_their_fp16_kernels(gen, kind, d):
    """Each K1 form on fp16 q launches its fp16 kernel (the span form's
    ragged_span_f16_kernel, the split walk's ragged_decode_split_f16_kernel
    and ragged_decode_row_f16_kernel at d <= 128; the tf32 span form and
    the unsplit decode form above, on fp16 q) and K2-fp16 its
    paged_decode_kernel<., __half>, never a bf16 one."""
    T_span, ps, pages = 37, 16, 20
    q, kp, vp, table = _operands(gen, 2, T_span, 2, 4, d, ps, pages)
    q = q.half()
    k, v, ks, vs = _half_pools(gen, kind, kp, vp)
    st = torch.tensor([0, 270], dtype=torch.int32, device="cuda")
    ql = torch.tensor([T_span, 1], dtype=torch.int32, device="cuda")
    one = torch.ones_like(ql)

    def run():
        k1.ragged_paged_attention(q, k, v, table, st, ql, k_scale=ks,
                                  v_scale=vs)                      # span
        k1.ragged_paged_attention(q[:, :2].contiguous(), k, v, table, st,
                                  one, k_scale=ks, v_scale=vs)     # decode
        k1.ragged_paged_attention(q[:, :1, :2].contiguous(), k, v, table,
                                  st, one, k_scale=ks, v_scale=vs)  # a row
        if kind == "fp16":
            k2.paged_decode_attention(q[:, 0, :2].contiguous(), k, v, table,
                                      st)

    names = " ".join(_launched_kernels(run))
    assert "bf16" not in names, names
    wide = d > k1.SPLIT_MAX_HEAD_DIM
    for kernel in ("ragged_span_f16_kernel", "ragged_decode_split_f16_kernel",
                   "ragged_decode_row_f16_kernel"):
        assert (kernel in names) != wide, (d, kernel, names)
    if wide:
        assert "ragged_span_kernel" in names and "__half" in names, names
    if kind == "fp16":
        assert "paged_decode_kernel" in names, names


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("n_kv", [4, 2], ids=["mha", "gqa"])
def test_f16_engine_on_the_card_runs_the_f16_kernels(gen, kv_dtype, n_kv):
    """`_half_engine` at dtype=float16."""
    _half_engine(kv_dtype, n_kv, torch.float16)


# ------------------------------------------------------ the host KV tier


def _card_pool(gen, kv_dtype):
    """A 2-layer CUDA pool of 12 pages of random bytes."""
    from paddle_tpu_torch.serving import KVCachePool
    pool = KVCachePool(2, 12, 16, 4, 64, kv_dtype=kv_dtype, device="cuda")
    for layer in pool.pools:
        for a in layer:
            b = a.view(torch.uint8)
            b.copy_(torch.randint(0, 256, b.shape, generator=gen,
                                  device="cuda", dtype=torch.int32))
            if a.dtype == torch.float8_e4m3fn:      # no NaN bit patterns
                a.view(torch.uint8).bitwise_and_(0xF6)
    return pool


def _page_in(pool, pages, slots):
    """An engine-style page-in: the slots staged on the tier's stream, the
    compute stream ordered after the copies, the pages scattered."""
    tier = pool.host_tier
    staged = []
    for s in slots:
        data = tier.read_slot(s)
        with tier.stream():
            copies = [tuple(a.to("cuda", non_blocking=True) for a in layer)
                      for layer in data]
        ev = tier.note_read(s)
        torch.cuda.current_stream().wait_event(ev)
        staged.append(copies)
    pool.write_pages(pages, [tuple(torch.stack([c[li][j] for c in staged])
                                   for j in range(len(layer)))
                             for li, layer in enumerate(pool.pools)])


@pytest.mark.parametrize("spill_async", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8", "mixed"])
def test_host_tier_round_trip_is_bit_exact_through_pinned_buffers(
        gen, kv_dtype, spill_async):
    """A spill of CUDA pages into the tier's pinned buffers and a page-in
    back restore every byte (codes and scale rows on int8, fp8 bytes, a
    mixed pool's tag bits); the buffers are pinned; the recorded CRC is
    the CRC of the device bytes read back."""
    pool = _card_pool(gen, kv_dtype)
    tier = pool.enable_host_tier(6, async_spill=spill_async)
    assert all(b.is_pinned() for layer in tier._bufs for b in layer)
    pages = [3, 4, 5, 9, 1]
    before = pool.read_pages(pages)
    slots = tier.spill_pages(pages)
    assert slots == [0, 1, 2, 3, 4]
    for layer in pool.pools:                     # clobber the pages
        for a in layer:
            a.view(torch.uint8)[pages] = 0
    _page_in(pool, pages, slots)
    after = pool.read_pages(pages)
    for b_layer, a_layer in zip(before, after):
        for b, a in zip(b_layer, a_layer):
            assert torch.equal(b.view(torch.uint8), a.view(torch.uint8))
    tier.sync()
    for j, s in enumerate(slots):
        host = [tuple(a[j:j + 1].contiguous() for a in layer)
                for layer in before]
        import zlib
        h = 0x9E3779B9
        for layer in host:
            for a in layer:
                h = zlib.crc32(a[0].view(torch.uint8).numpy().tobytes(), h)
        assert tier.slot_hash(s) == h
    assert tier.sync_spill_reads == (0 if spill_async else 1)


def test_slot_reused_under_an_inflight_pagein_reads_the_right_bytes(gen):
    """A slot freed while its page-in's host-to-device copy may still run
    and spilled into at once: the page-in reads the first tenant's bytes
    (the spill waits on the slot's read event on the tier's stream), and
    the slot then holds the second tenant's."""
    pool = _card_pool(gen, "fp32")
    tier = pool.enable_host_tier(1)
    first = pool.read_pages([2])
    slot, = tier.spill_pages([2])
    # keep the compute stream busy so nothing below has run yet
    big = torch.randn(4096, 4096, device="cuda", generator=gen)
    for _ in range(8):
        big = big @ big.T / 4096
    data = tier.read_slot(slot)
    with tier.stream():
        staged = [tuple(a.to("cuda", non_blocking=True) for a in layer)
                  for layer in data]
    tier.note_read(slot)
    tier.free_slots([slot])
    again, = tier.spill_pages([7])
    assert again == slot
    torch.cuda.synchronize()
    for layer, want in zip(staged, first):        # bytes: random bits
        for a, w in zip(layer, want):                # hold NaN patterns
            assert torch.equal(a.cpu().view(torch.uint8),
                               w[0].view(torch.uint8))
    second = pool.read_pages([7])
    tier.sync()
    for layer, want in zip(tier._bufs, second):
        for buf, w in zip(layer, want):
            assert torch.equal(buf[slot].view(torch.uint8),
                               w[0].view(torch.uint8))


def test_async_spill_engine_never_blocks_and_matches_the_sync_engine(gen):
    """A preempting Llama engine on the card with the tier: with
    spill_async no spill is waited for on the engine loop
    (sync_spill_reads 0) and no host reader joins a pending spill
    (blocking_joins 0); requests resume by page-in, through K1 / K2 and no
    plain version, and the tokens equal the sync-spill engine's (the same
    schedule, the same kernels)."""
    cfg = LlamaConfig(vocab_size=211, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=4, max_seq_len=256)
    runner = LlamaRunner(Llama(cfg, device="cuda", seed=0), block_size=16)
    rng = np.random.default_rng(3)
    work = [(rng.integers(1, 211, int(rng.integers(40, 90))).tolist(),
             int(rng.integers(24, 40))) for _ in range(6)]
    streams = {}
    for spill_async in (False, True):
        eng = ServingEngine(runner, num_blocks=24, max_batch_size=4,
                            max_prefill_tokens_per_step=64,
                            host_tier_pages=32, spill_async=spill_async)
        for counts in (k1.COUNTS, k2.COUNTS):
            counts.reset()
        ids = [eng.add_request(p, SamplingParams(max_tokens=n))
               for p, n in work]
        outs = eng.run()
        m, tier = eng.metrics.snapshot(), eng.pool.host_tier
        assert m["preemptions"] > 0 and m["offload_resumes"] > 0, m
        assert m["pagein_pages"] > 0
        assert k1.COUNTS.plain_launches == k2.COUNTS.plain_launches == 0
        assert k1.COUNTS.kernel_launches > 0 and k2.COUNTS.kernel_launches
        if spill_async:
            assert tier.sync_spill_reads == 0 and tier.blocking_joins == 0
        tier.sync()
        assert tier.used_count == 0
        assert eng.pool.allocator.check_no_leaks()
        streams[spill_async] = [outs[r].output_tokens for r in ids]
    assert streams[True] == streams[False]


# ------------------------------------------------ the serving tier

TIER_CFG = LlamaConfig(vocab_size=211, hidden_size=256, num_layers=2,
                       num_heads=4, num_kv_heads=4, max_seq_len=256)
TIER_KW = dict(block_size=16, num_blocks=48, max_batch_size=4,
               max_model_len=256, max_prefill_tokens_per_step=64,
               decode_horizon=8, audit=True, heartbeat_timeout_s=600.0)


def _tier_work(n=8, seed=5):
    rng = np.random.default_rng(seed)
    return [(f"w{i}", rng.integers(1, 211, int(rng.integers(40, 120)))
             .tolist(), SamplingParams(max_tokens=int(rng.integers(16, 40))))
            for i in range(n)]


def _serve(router, work):
    for rid, p, sp in work:
        router.submit(p, sp, request_id=rid)
    outs = router.drain(timeout_s=300)
    return {rid: outs[rid].output_tokens for rid, _, _ in work}


def test_tier_replicas_capture_concurrently_and_match_one_engine(gen,
                                                                monkeypatch):
    """Two replicas reach their first decode horizons together (a barrier
    before each runner's first capture), while a third thread drains
    device work through synchronising reads: both capture (one at a time,
    under the capture lock, in thread-local capture mode) and both give a
    single engine's streams; the replicas share the model's weights."""
    import threading

    from paddle_tpu_torch.inference import create_serving_router
    from paddle_tpu_torch.serving import model_runner as mr

    model = Llama(TIER_CFG, device="cuda", seed=0)
    work = _tier_work()
    single = ServingEngine(LlamaRunner(model, block_size=16),
                           **{k: v for k, v in TIER_KW.items()
                              if k != "heartbeat_timeout_s"})
    for rid, p, sp in work:
        single.add_request(p, sp, request_id=rid)
    ref = {rid: o.output_tokens for rid, o in single.run().items()}
    barrier = threading.Barrier(2, timeout=60)
    spans, first = [], set()
    graphed, capture = mr.PagedModelRunner._graphed, mr.capture_step

    def _graphed(self, kind, shape_key, body, host, pools):
        if id(self) not in first:
            first.add(id(self))
            barrier.wait()
        return graphed(self, kind, shape_key, body, host, pools)

    def capture_step(*args, **kw):
        t0 = __import__("time").perf_counter()
        try:
            return capture(*args, **kw)
        finally:
            spans.append((t0, __import__("time").perf_counter()))

    monkeypatch.setattr(mr.PagedModelRunner, "_graphed", _graphed)
    monkeypatch.setattr(mr, "capture_step", capture_step)
    stop = threading.Event()

    def busy():
        x = torch.randn(512, 512, device="cuda")
        while not stop.is_set():
            (x @ x).sum().item()

    noise = threading.Thread(target=busy, daemon=True)
    noise.start()
    for counts in (k1.COUNTS, k2.COUNTS):
        counts.reset()
    router = create_serving_router(model, replicas=2, device="cuda",
                                   policy="round_robin", **TIER_KW)
    try:
        got = _serve(router, work)
        runners = [rep.engine.runner for rep in router._replicas]
        assert all(r.captures for r in runners)
        name = "embed_tokens.weight"
        assert runners[0].params[name].data_ptr() == \
            runners[1].params[name].data_ptr() == \
            dict(model.named_parameters())[name].data_ptr()
        assert router.metrics.snapshot()["replica_restarts"] == 0
    finally:
        stop.set()
        noise.join(30)
        router.shutdown()
    assert got == ref
    assert k1.COUNTS.plain_launches == k2.COUNTS.plain_launches == 0
    assert k2.COUNTS.kernel_launches > 0
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), spans


def test_tier_rolling_restart_releases_each_replicas_memory(gen):
    """After rolling_restart every old engine, runner and host tier is
    collected, the card's allocated memory is within one replica's pools
    and graph pools of its value before, and the host tiers' pinned bytes
    are what they were; the streams equal the first run's."""
    import gc
    import weakref

    from paddle_tpu_torch.inference import create_serving_router

    model = Llama(TIER_CFG, device="cuda", seed=0)
    work = _tier_work(seed=7)
    router = create_serving_router(model, replicas=2, device="cuda",
                                   host_tier_pages=32, **TIER_KW)
    try:
        first = _serve(router, work)
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        one = max(rep.engine.pool.memory_bytes() + sum(
            c["pool_bytes"] for c in rep.engine.runner.captures)
            for rep in router._replicas)
        pinned = [b.numel() * b.element_size()
                  for rep in router._replicas
                  for layer in rep.engine.pool.host_tier._bufs
                  for b in layer]
        old = [weakref.ref(o) for rep in router._replicas
               for o in (rep.engine, rep.engine.runner,
                         rep.engine.pool.host_tier)]
        assert router.rolling_restart() == 2
        again = _serve(router, [(f"r{rid}", p, sp) for rid, p, sp in work])
        gc.collect()
        torch.cuda.synchronize()
        assert all(r() is None for r in old)
        assert torch.cuda.memory_allocated() <= before + one
        assert [b.numel() * b.element_size() for rep in router._replicas
                for layer in rep.engine.pool.host_tier._bufs
                for b in layer] == pinned
    finally:
        router.shutdown()
    assert {f"r{rid}": t for rid, t in first.items()} == again


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_tier_handoff_pages_arrive_bit_identical(gen, kv_dtype):
    """A prefill-role engine's staged pages, gathered on the card before
    the spill, equal the decode engine's pages after its page-in fence,
    bit for bit (int8 codes and scale rows included); no handoff
    recomputes, and the fp32 streams equal naive_generate's."""
    model = Llama(TIER_CFG, device="cuda", seed=0)
    kw = {k: v for k, v in TIER_KW.items() if k != "heartbeat_timeout_s"}
    runner = LlamaRunner(model, block_size=16, kv_dtype=kv_dtype)
    pre = ServingEngine(runner, role="prefill", host_tier_pages=64, **kw)
    dec = ServingEngine(LlamaRunner(model, block_size=16, kv_dtype=kv_dtype),
                        role="decode", host_tier_pages=64, **kw)
    sent = {}
    stage = pre._stage

    def _stage(req):
        covered = min(req.kv.num_tokens, req.num_context - 1)
        pages = req.kv.pages[:pre.pool.blocks_for_tokens(covered)]
        sent[req.request_id] = pre.pool.gather_pages(pages)
        stage(req)

    pre._stage = _stage
    work = _tier_work(n=4, seed=9)
    for rid, p, sp in work:
        pre.add_request(p, sp, request_id=rid)
    for _ in range(200):
        pre.step()
        if len(pre.handoff_ready()) == len(work):
            break
    for rid in pre.handoff_ready():
        dec.import_handoff(*pre.extract_handoff(rid))
    fence = dec._fence_pagein
    checked = []

    def _fence(admitted):
        fence(admitted)
        for req in admitted:
            want = sent.pop(req.request_id)
            got = dec.pool.gather_pages(req.kv.pages[:want[0][0].shape[0]])
            for a_layer, b_layer in zip(want, got):
                for a, b in zip(a_layer, b_layer):
                    assert torch.equal(a.view(torch.uint8),
                                       b.view(torch.uint8))
            checked.append(want[0][0].shape[0])

    dec._fence_pagein = _fence
    outs = dec.run()
    assert not sent and sum(checked) == dec.metrics.handoff_pages_in.value
    assert dec.metrics.handoff_recompute_fallbacks.value == 0
    assert len(checked) == len(work)
    if kv_dtype == "fp32":
        for rid, p, sp in work:
            assert outs[rid].output_tokens == naive_generate(
                runner, p, sp, max_model_len=256)


def test_capture_warmup_never_runs_beside_another_runners_replay(gen):
    """Every graph captured on the shared capture stream uses that
    stream's K2 ticket buffer when it replays (on the compute stream), and
    every capture's warm-up runs K2 for real on the capture stream with
    the same tickets: the two must never run at once, or the split walk's
    last-split merges read half-written partials. One thread replays a
    captured chain of K2 calls while another captures fresh chains, each
    warm-up a chain over other inputs, both keeping the card busy: every
    replay equals the eager chain bit for bit, and the tickets are left
    zero."""
    import threading

    from paddle_tpu_torch.serving import model_runner as mr

    dev = torch.device("cuda")
    b, h, d, ps, P = 8, 32, 128, 16, 64        # 1024 keys: 4 splits
    pools = tuple(torch.randn(b * P + 1, ps, h, d, device=dev, generator=gen)
                  for _ in range(2))
    tables = (np.arange(b * P, dtype=np.int32).reshape(b, P) + 1)
    pos = np.full(b, P * ps - 1, dtype=np.int32)

    def host(seed):
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((b, h, d)).astype(np.float32), tables,
                pos - rng.integers(0, 300, b).astype(np.int32))

    def chain(pools, q, t, p):       # 48 K2 calls in a row, each fed back
        out = q
        for _ in range(48):
            out = k2.paged_decode_attention(out, pools[0], pools[1], t, p)
        return out

    hb = host(0)
    ref = chain(pools, *(torch.from_numpy(a).to(dev) for a in hb)).clone()
    replayed, _ = mr.capture_step(chain, hb, pools, dev, mr._CudaGraph(
        mr._capture_stream(dev)))
    outs, stop, errors = [], threading.Event(), []

    def replays():
        try:
            while not stop.is_set():
                outs.append(replayed.replay(hb).clone())
        except BaseException as e:          # reported by the main thread
            errors.append(e)

    t = threading.Thread(target=replays, daemon=True)
    t.start()
    try:
        for i in range(40):
            with mr._CAPTURE_LOCK:
                mr.capture_step(chain, host(i + 1), pools, dev,
                                mr._CudaGraph(mr._capture_stream(dev)))
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive() and not errors, errors
    torch.cuda.synchronize()
    assert len(outs) > 40
    bad = sum(not torch.equal(o, ref) for o in outs)
    assert bad == 0, f"{bad} of {len(outs)} replays differ from the eager call"
    tickets = k2._tickets(dev, mr._capture_stream(dev), b * h)
    assert int(tickets.count_nonzero()) == 0


# ------------------------------------------- tensor-parallel serving

def _card_mesh(tp):
    from paddle_tpu_torch.serving import serving_mesh
    return serving_mesh(1, tp, devices=[torch.device("cuda", 0)] * tp)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("width", [4096, 130])
@pytest.mark.parametrize("chunk", [4, 128])
def test_qcomm_on_the_card_bit_equals_numpy(gen, tp, width, chunk):
    """quantized_psum / quantized_allgather over card tensors equal the
    numpy references bit for bit (the references need no card)."""
    from paddle_tpu_torch.quantization import qcomm
    parts = [torch.randn(8, width, device="cuda", generator=gen)
             * 10.0 ** (i - 1) for i in range(tp)]
    host = [p.cpu().numpy() for p in parts]
    for fn, ref in ((qcomm.quantized_psum,
                     qcomm.quantized_allreduce_reference),
                    (qcomm.quantized_allgather,
                     qcomm.quantized_allgather_reference)):
        want = ref(host, chunk=chunk)
        for got in fn(parts, chunk=chunk):
            assert got.is_cuda
            np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("comm_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_decode_graph_replay_equals_eager(gen, tp, comm_dtype):
    """A sharded runner's decode kinds are one capture each on the one
    card: replays equal the eager calls bit for bit over every shard's
    pools, each shard's K2 launched in sequence on the capture stream's
    tickets (left zero)."""
    from paddle_tpu_torch.serving import KVCachePool
    import paddle_tpu_torch.serving.model_runner as mr
    model = Llama(LlamaConfig(**GRAPH_CFG), device="cuda", seed=0)
    runner = LlamaRunner(model, block_size=16).shard(
        _card_mesh(tp), comm_dtype=comm_dtype)
    prompt = np.random.default_rng(0).integers(1, 211, 40).tolist()

    def prefilled():
        pool = KVCachePool(runner.num_layers, 10, 16, runner.n_kv_heads,
                           runner.head_dim, mesh=runner.mesh, device="cuda")
        table = pool.pad_table(pool.allocator.alloc(8), 8)
        runner.prefill(prompt, table, pool.shards)
        return pool, np.asarray([table, [0] * 8], np.int32)

    (pool_g, tabs), (pool_e, _) = prefilled(), prefilled()
    before = k2.COUNTS.kernel_launches
    calls = [("decode", (np.asarray([5 + i, 0]), tabs,
                         np.asarray([40 + i, 0])), ()) for i in range(3)]
    calls += [("decode_multi", (np.asarray([3, 0]), tabs,
                                np.asarray([43 + 8 * i, 0])), (8,))
              for i in range(2)]
    for kind, args, n in calls:
        runner.graphs = False
        out_e, _ = getattr(runner, kind)(*args, pool_e.shards, *n)
        out_e = out_e.clone()
        runner.graphs = True
        out_g, _ = getattr(runner, kind)(*args, pool_g.shards, *n)
        torch.cuda.synchronize()
        assert torch.equal(out_g, out_e), (kind, tp, comm_dtype)
    # K2 once a layer a shard on every decode step of both runs
    steps = 2 * (3 + 2 * 8)
    assert k2.COUNTS.kernel_launches - before == \
        runner.num_layers * tp * steps
    assert [c["kind"] for c in runner.captures] == ["decode",
                                                    "decode_multi"]
    for a, b in zip(pool_e.gather_pages(list(range(10))),
                    pool_g.gather_pages(list(range(10)))):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    dev = torch.device("cuda", torch.cuda.current_device())
    tickets = k2._tickets(dev, mr._capture_stream(dev), 1)
    assert int(tickets.count_nonzero()) == 0
