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

The decode kinds run as CUDA graphs on the card: a replayed decode step
and horizon (greedy and seeded) must equal the eager call on the same
inputs and pools bit for bit, logits, tokens and pools, over fp32, int8
and fp8 pools, crediting the eager call's launch counts on every replay;
a horizon engine with every knob on must give the per-step engine's
streams token for token, with the sampler's tokens on the card equal to
the same function's on the CPU.

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
    """The pools as the fp64 evaluation reads them: fp32 pools widened,
    1-byte codes as they are (their scales widen inside the plain
    version)."""
    return (kp.double(), vp.double()) if kind == "fp32" else (kp, vp)


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


def _bf16_operands(gen, b, sq, sk, h, d):
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen)
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen)
            for _ in range(2))
    do = torch.randn(b, sq, h, d, device="cuda", generator=gen)
    return tuple(t.to(torch.bfloat16) for t in (q, k, v, do))


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


def _bf16_vs_fp64(gen, form, d, causal, sq, sk, b=2, h=3):
    """The bf16 kernels on one case against fp64 (see the sweep below)."""
    q, k, v, do = _bf16_operands(gen, b, sq, sk, h, d)
    ops = {} if form == "dense" else _masked_operands(gen, form, b, sq, sk, h)
    # (a bool mask over one key lowers to a per-key bias: mask is None)
    ops = {n: t for n, t in ops.items() if t is not None}
    counts = fa.counts_for(bool(ops), torch.bfloat16)
    fa.reset_counts()
    o, lse = fa.flash_forward(q, k, v, causal, **ops)
    grads = fa.flash_backward(q, k, v, o, do, lse, causal, **ops)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert all(g.dtype == torch.bfloat16 for g in grads)
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


def _launched_kernels(fn):
    """The names of the CUDA kernels ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("d", [40, 64, 96, 128, 256])
def test_bf16_head_dims_launch_their_kernel_variant(gen, d):
    """At bf16 the forward, dq and dk/dv launch their wgmma kernels for
    d <= 128 and the mma.sync kernels above, as `kernel_variant` names them
    and the counts record them."""
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
        assert c.form_launches == {variant: 1}, (name, c.form_launches)


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
    q, k, v, _ = _bf16_operands(gen, 1, 16, 16, 2, 64)
    with pytest.raises(TypeError, match="all be fp32 or all bf16"):
        fa.flash_forward(q, k.float(), v)
    with pytest.raises(TypeError, match="all be fp32 or all bf16"):
        fa.flash_forward(q.half(), k.half(), v.half())


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
    runner.prefill(prompt, table, pool.pools)
    return pool.pools, np.asarray([table, [0] * P], np.int32)


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
    for a, b in zip(pools_e, pools_g):
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
