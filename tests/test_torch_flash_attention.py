"""The port's flash attention (K3a, K3b-dq, K3b-dkv) against the JAX
package's, on the CPU.

The same seeded numpy inputs go through the JAX Pallas kernels in
interpret mode (`_flash_forward`, `_flash_backward`, the custom VJP
`_flash`) and through the port's plain versions, which the wrappers run
on CPU tensors:

  * plain forward (o, lse) and plain backward (dq, dk, dv) against the
    Pallas kernels at atol = rtol = 1e-5 (fp32, summed in another order);
  * the autograd.Function's gradients against jax.grad through `_flash`
    at 1e-4 (two more sums of fp32 products in between);
  * sq > sk causal (rows that see no key) against the JAX `_reference`,
    with exact zeros and zero gradient on those rows;
  * the port's scaled_dot_product_attention against the JAX one, with
    FLAGS_use_flash_attention on (flash and dense paths) and off;
  * what the port refuses: masking operands of the wrong shape
    everywhere, and on the card (`on_card` patched) a mask or a shape the
    kernels do not take. The masked forms themselves are pinned in
    tests/test_torch_flash_masked.py.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.impl as jax_impl
import paddle_tpu.ops.pallas.flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import impl
from paddle_tpu_torch.utils.flags import flag, set_flags

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# tiny shapes: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

ATOL = RTOL = 1e-5
GRAD_TOL = 1e-4
# (b, sq, sk, h, d): the two square shapes, and a cross-length one whose
# causal offset sk - sq is a whole tile
SHAPES = [(1, 256, 256, 2, 64), (2, 128, 128, 4, 16), (1, 128, 256, 2, 32)]


def _qkv(seed, b, sq, sk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, do


def _jax_forward(q, k, v, causal):
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None,
        None, None, causal, scale, 128, 128, True, with_lse=True)
    b, sq, h, _ = q.shape
    # lse is value-broadcast over its trailing lanes: lane 0 is the row's
    return np.asarray(o), np.asarray(lse)[..., 0].reshape(b, h, sq), lse


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_forward_matches_pallas_kernel(shape, causal):
    q, k, v, _ = _qkv(1, *shape)
    o_ref, lse_ref, _ = _jax_forward(q, k, v, causal)
    o, lse = fa.flash_forward_reference(*_t(q, k, v), causal)
    np.testing.assert_allclose(o.numpy(), o_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_pallas_kernels(shape, causal):
    q, k, v, do = _qkv(2, *shape)
    o, lse, lse_lanes = _jax_forward(q, k, v, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    ref = jfa._flash_backward(
        *(jnp.asarray(a) for a in (q, k, v, o, do)), lse_lanes, None, None,
        None, None, None, causal, scale, 128, 128, True)
    ours = fa.flash_backward_reference(*_t(q, k, v, o, do, lse), causal)
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_autograd_function_matches_jax_grad_through_flash(shape, causal):
    q, k, v, w = _qkv(3, *shape)
    scale = 1.0 / math.sqrt(q.shape[-1])

    def jax_loss(q, k, v):
        o = jfa._flash(q, k, v, None, None, None, None, None, causal, scale,
                       128, 128, True)
        return jnp.sum(o * jnp.asarray(w))

    jax_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad((o * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    np.testing.assert_allclose(
        o.detach().numpy(), np.asarray(jfa._reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale)),
        rtol=GRAD_TOL, atol=GRAD_TOL)
    for name, a, r in zip(("dq", "dk", "dv"), grads, jax_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_rows_that_see_no_key_are_zero_with_zero_gradient():
    """sq > sk causal: the first sq - sk rows see no key. JAX sends this
    shape to `_reference`; the port's kernels (and plain versions) take
    it, and must give exact zeros there, with zero gradient."""
    q, k, v, w = _qkv(4, 1, 96, 40, 2, 16)
    scale = 1.0 / math.sqrt(16)
    ref = np.asarray(jfa._reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), True, scale))
    jax_dq = np.asarray(jax.grad(lambda q: jnp.sum(jfa._reference(
        q, jnp.asarray(k), jnp.asarray(v), True, scale) * w))(
            jnp.asarray(q)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=True)
    (dq,) = torch.autograd.grad((o * torch.from_numpy(w)).sum(), (tq,))
    np.testing.assert_allclose(o.detach().numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dq.numpy(), jax_dq, rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    dead = 96 - 40
    assert (o[:, :dead] == 0).all() and (dq[:, :dead] == 0).all()
    assert torch.isfinite(o).all() and torch.isfinite(dq).all()
    _, lse = fa.flash_forward_reference(*_t(q, k, v), True)
    assert (lse[..., :dead] == np.float32(fa.NEG_INF)).all()


def test_gate_follows_the_kernels():
    z = torch.zeros
    assert fa.flash_attention_ok(z(1, 5, 2, 8), z(1, 7, 2, 8), z(1, 7, 2, 8))
    assert fa.flash_attention_ok(z(2, 1, 3, 256), z(2, 1, 3, 256),
                                 z(2, 1, 3, 256))
    for q, k in [((1, 4, 2, 12), (1, 4, 2, 12)),      # d % 8
                 ((1, 4, 2, 264), (1, 4, 2, 264)),    # d > 256
                 ((1, 4, 2, 8), (1, 4, 1, 8)),        # heads differ
                 ((1, 4, 2, 8), (2, 4, 2, 8)),        # batch differs
                 ((1, 0, 2, 8), (1, 4, 2, 8))]:       # empty
        assert not fa.flash_attention_ok(z(q), z(k), z(k))


def test_cpu_tensors_count_plain_launches_only():
    fa.reset_counts()
    q, k, v, _ = (t.requires_grad_() for t in _t(*_qkv(5, 1, 16, 16, 2, 8)))
    fa.flash_attention(q, k, v).sum().backward()
    assert {n: (c.kernel_launches, c.plain_launches)
            for n, c in fa.counts_for(False).items()} == {
        "flash_forward": (0, 1), "flash_backward_dq": (0, 1),
        "flash_backward_dkv": (0, 1)}


@pytest.mark.parametrize("arg", ["mask", "segment_ids", "block_mask"])
def test_masked_forms_raise_naming_roadmap(arg):
    """The masked forms are ported (K3-m); what still raises is a masking
    operand the kernels cannot take: a rank-5 mask, segment ids of another
    length, a block mask off the JAX tile grid."""
    q = torch.zeros(1, 8, 2, 8)
    bad = {"mask": torch.zeros(1, 1, 1, 8, 8),
           "segment_ids": torch.zeros(1, 9, dtype=torch.int32),
           "block_mask": torch.ones(2, 1, dtype=torch.int32)}[arg]
    match = {"mask": "rank 5", "segment_ids": "segment_ids shapes",
             "block_mask": "tile grid"}[arg]
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, q, q, **{arg: bad})


def _sdpa_pair(q, k, v, **kw):
    ours = impl.scaled_dot_product_attention(*_t(q, k, v), **kw)
    jkw = {key: (jnp.asarray(val.numpy()) if torch.is_tensor(val) else val)
           for key, val in kw.items()}
    ref = jax_impl.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    return ours.numpy(), np.asarray(ref)


@pytest.mark.parametrize("use_flash", [True, False], ids=["flag_on",
                                                          "flag_off"])
@pytest.mark.parametrize("case", ["causal", "full", "cross", "d12", "mask"])
def test_sdpa_matches_jax(use_flash, case):
    """With the flag on, kernel shapes take the flash path (the plain
    versions here), the mask included, and the rest the dense path, which
    the JAX package takes on the CPU for every case; with the flag off,
    every case is dense."""
    shape = {"cross": (1, 20, 36, 2, 16), "d12": (2, 24, 24, 2, 12)}.get(
        case, (2, 24, 24, 2, 16))
    q, k, v, _ = _qkv(6, *shape)
    kw = {"is_causal": case != "full"}
    if case == "mask":
        keep = np.random.default_rng(7).random((2, 1, 24, 24)) < 0.8
        kw["attn_mask"] = torch.from_numpy(keep)
    flash_taken = use_flash and case in ("causal", "full", "cross", "mask")

    def plain():
        return (fa.counts_for(False)["flash_forward"].plain_launches
                + fa.counts_for(True)["flash_forward"].plain_launches)

    before = plain()
    old = flag("FLAGS_use_flash_attention")
    set_flags({"FLAGS_use_flash_attention": use_flash})
    try:
        ours, ref = _sdpa_pair(q, k, v, **kw)
    finally:
        set_flags({"FLAGS_use_flash_attention": old})
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    assert plain() - before == int(flash_taken)


def test_sdpa_ignores_dropout_as_the_jax_package_does():
    q, k, v, _ = _qkv(8, 1, 16, 16, 2, 8)
    ours, ref = _sdpa_pair(q, k, v, is_causal=True, dropout_p=0.5)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ours, impl.scaled_dot_product_attention(*_t(q, k, v),
                                                is_causal=True).numpy())


@pytest.fixture
def on_the_card(monkeypatch):
    """The dispatch as it runs on CUDA tensors, checked before any launch
    (the kernels themselves are tests/test_torch_cuda.py's)."""
    monkeypatch.setattr(fa, "on_card", lambda t: True)


@pytest.mark.parametrize("d", [12, 264])
def test_no_quiet_dense_path_on_the_card(on_the_card, d):
    q = torch.zeros(1, 8, 2, d)
    with pytest.raises(ValueError, match="FLAGS_use_flash_attention"):
        impl.scaled_dot_product_attention(q, q, q, is_causal=True)
    with pytest.raises(ValueError, match="d % 8 == 0"):
        fa.flash_forward(q, q, q)
    with pytest.raises(ValueError, match="d % 8 == 0"):
        fa.flash_backward(q, q, q, q, q, torch.zeros(1, 2, 8))


def test_mask_on_the_card_raises_naming_the_flag(on_the_card):
    """A mask the K3-m kernels do not take (here rank 2, which the JAX
    package sends to its dense path) raises on the card."""
    q = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="K3-m.*FLAGS_use_flash_attention"):
        impl.scaled_dot_product_attention(
            q, q, q, attn_mask=torch.ones(8, 8, dtype=torch.bool))


def test_flag_off_takes_the_dense_path_on_the_card(on_the_card):
    q, k, v, _ = _qkv(9, 1, 8, 8, 2, 12)
    old = flag("FLAGS_use_flash_attention")
    set_flags({"FLAGS_use_flash_attention": False})
    try:
        ours, ref = _sdpa_pair(q, k, v, is_causal=True)
    finally:
        set_flags({"FLAGS_use_flash_attention": old})
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_operands_the_kernels_cannot_read_are_refused_on_both_devices():
    q = torch.zeros(1, 8, 2, 8)
    with pytest.raises(TypeError, match="fp32"):
        fa.flash_forward(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_forward(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="several devices"):
        fa.flash_forward(q, q, q.to("meta"))


def test_unknown_flag_is_refused():
    with pytest.raises(KeyError, match="FLAGS_no_such_flag"):
        set_flags({"FLAGS_no_such_flag": True})


# ------------------------------------------- the backward kernels' 3xTF32


def _low_bits(t):
    return t.view(torch.int32) & 0x1FFF


@pytest.mark.parametrize("magnitude", [1e-30, 1e-3, 1.0, 1e3, 1e30])
def test_tf32_split_reproduces_fp32(magnitude):
    """big and small are tf32 (low 13 mantissa bits zero), big is x to
    within half a tf32 ulp, and big + small is x within 2^-22 |x|."""
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        4096).astype(np.float32)) * magnitude
    big, small = fa.tf32_split(x)
    assert (_low_bits(big) == 0).all() and (_low_bits(small) == 0).all()
    x64 = x.double()
    assert ((big.double() - x64).abs() <= 2.0 ** -11 * x64.abs()).all()
    assert ((big.double() + small.double() - x64).abs()
            <= 2.0 ** -22 * x64.abs()).all()


def test_tf32_split_rounds_to_nearest_with_ties_away_from_zero():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -20,
                      1 + 3 * 2 ** -11, 1 + 2 ** -12 + 2 ** -23],
                     dtype=torch.float32)
    big, small = fa.tf32_split(x)
    assert big.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -9,
                            1.0]
    # residuals of up to 11 significant bits are kept whole; 2^-12 +
    # 2^-23 has 12, a tie, rounded away to 2^-12 + 2^-22
    assert small.tolist() == [-2 ** -11, 2 ** -11, 2 ** -11 - 2 ** -20,
                              -2 ** -11, 2 ** -12 + 2 ** -22]


def test_one_byte_pool_values_are_exact_in_tf32():
    """The ragged span form multiplies 1-byte pools' values unsplit (two
    products a k-step, not three): every int8 code and every finite e4m3
    value is its own big half under the 3xTF32 split, with a zero small
    half."""
    codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8).float()
    e4m3 = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.float8_e4m3fn).float()
    e4m3 = e4m3[torch.isfinite(e4m3)]
    assert e4m3.numel() == 254                  # all but the two NaNs
    for x in (codes, e4m3):
        big, small = fa.tf32_split(x)
        assert torch.equal(big, x) and (small == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d", [64, 128])
def test_three_products_of_split_tiles_are_fp32_class(d, seed):
    """q k^T of 64-row tiles as the kernels form it (each tf32 x tf32
    product exact in fp32, sums in fp32, the small products first) stays
    within twice the error of the fp32 product against fp64: the bound the
    card's gate (chip_smoke.py::check_vs_fp64) assumes. One TF32 product
    is about a thousand times further off."""
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32))
            for _ in range(2))
    (qb, qs), (kb, ks) = fa.tf32_split(q), fa.tf32_split(k)
    three = (qs @ kb.T + qb @ ks.T) + qb @ kb.T
    exact = q.double() @ k.double().T

    def err(t):
        return (t.double() - exact).abs().max().item()

    assert err(three) <= 2 * err(q @ k.T)
    assert err(qb @ kb.T) >= 100 * err(q @ k.T)


def test_plain_versions_compute_in_fp64_for_fp64_operands():
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(12, 1, 40, 56, 2, 16))
    kbias = torch.zeros(1, 56).index_fill_(1, torch.arange(50, 56), -1e4)
    o, lse = fa.flash_forward_reference(q, k, v, True, kbias=kbias)
    grads = fa.flash_backward_reference(q, k, v, o, do, lse, True,
                                        kbias=kbias)
    o64, lse64 = fa.flash_forward_reference(q.double(), k.double(),
                                            v.double(), True, kbias=kbias)
    assert o64.dtype == lse64.dtype == torch.float64
    grads64 = fa.flash_backward_reference(
        q.double(), k.double(), v.double(), o64, do.double(), lse64, True,
        kbias=kbias)
    np.testing.assert_allclose(o.numpy(), o64.numpy(), rtol=RTOL, atol=ATOL)
    for name, g, g64 in zip(("dq", "dk", "dv"), grads, grads64):
        assert g64.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), g64.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        assert not torch.equal(g.double(), g64), name


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sq,sk", [(1, 1), (7, 7), (5, 13), (13, 5), (1, 9),
                                   (9, 1), (64, 200), (200, 64)])
def test_flash_work_counts_the_visible_pairs(sq, sk, causal):
    """chip_smoke.py's bound of the flash kernels counts the pairs the
    kernels compute: every pair, or under the bottom-right-aligned causal
    mask key j <= i + sk - sq of row i, for any sq and sk."""
    cs = _chip_smoke()
    i, j = np.meshgrid(np.arange(sq), np.arange(sk), indexing="ij")
    pairs = int((j <= i + sk - sq).sum()) if causal else sq * sk
    assert cs.visible_pairs(sq, sk, causal) == pairs
    b, h, d = 2, 3, 16
    work = cs.flash_work(b, sq, sk, h, d, causal, kbias=True)
    q_bytes, k_bytes, row_bytes = 4 * b * sq * h * d, 4 * b * sk * h * d, \
        4 * b * h * sq
    assert work == {
        "flash_forward": (2 * q_bytes + 2 * k_bytes + row_bytes + 4 * b * sk,
                          4 * d * b * h * pairs),
        "flash_backward_dq": (3 * q_bytes + 2 * k_bytes + 2 * row_bytes
                              + 4 * b * sk, 6 * d * b * h * pairs),
        "flash_backward_dkv": (2 * q_bytes + 4 * k_bytes + 2 * row_bytes
                               + 4 * b * sk, 8 * d * b * h * pairs)}


_HASH = "_ZN51_GLOBAL__N__4af27cb8_18_flash_attention_cu_6928a1a2"
_ARGS = "EEEvPKfS2_S2_S2_S2_S2_PfNS_4DimsE"


def _entry(name, maxd):
    return f"{_HASH}{len(name)}{name}ILi{maxd}{_ARGS}"


FLASH_KERNEL_NAMES = ["flash_fwd_kernel", "flash_bwd_dq_kernel",
                      "flash_bwd_dkv_kernel", "flash_fwd_bf16_kernel",
                      "flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel",
                      "flash_fwd_bf16_wgmma_kernel",
                      "flash_bwd_dq_bf16_wgmma_kernel",
                      "flash_bwd_dkv_bf16_wgmma_kernel",
                      "flash_fwd_f16_kernel", "flash_bwd_dq_f16_kernel",
                      "flash_bwd_dkv_f16_kernel",
                      "flash_fwd_f16_wgmma_kernel",
                      "flash_bwd_dq_f16_wgmma_kernel",
                      "flash_bwd_dkv_f16_wgmma_kernel"]


@pytest.mark.parametrize("name", FLASH_KERNEL_NAMES)
@pytest.mark.parametrize("maxd", [64, 128, 256])
def test_smoke_names_kernels_from_their_mangled_entries(name, maxd):
    """chip_smoke.py's build report finds each kernel's name after the
    digits of the anonymous namespace's hash, and its instantiation."""
    assert _chip_smoke()._kernel_label(_entry(name, maxd)) == \
        f"{name}<{maxd}>"


@pytest.mark.parametrize("name", FLASH_KERNEL_NAMES)
def test_smoke_names_kernels_after_a_hash_ending_in_a_length(name):
    """A namespace hash whose last digits equal the length of the span
    from there to the end of the kernel's name (a build on the card drew
    one for flash_fwd_kernel) must not pass for the kernel's name."""
    tail = f"_18_flash_attention_cu_6928a1a2{len(name)}{name}"
    entry = (f"_ZN51_GLOBAL__N__4af27c{len(tail)}{tail}ILi128{_ARGS}")
    assert _chip_smoke()._kernel_label(entry) == f"{name}<128>"


@pytest.mark.parametrize("name", FLASH_KERNEL_NAMES)
def test_smoke_profiles_group_each_flash_kernel_as_its_own(name):
    """The profiles of chip_smoke.py count each flash kernel, the wgmma
    ones included, under its own group (K3a, K3b-dq or K3b-dkv, -bf16 for
    the bf16 kernels, -fp16 for the fp16 ones), never under "other"."""
    kernel = ("K3a" if "_fwd_" in name else
              "K3b-dq" if "_dq_" in name else "K3b-dkv")
    want = kernel + ("-bf16" if "bf16" in name else
                     "-fp16" if "_f16_" in name else "")
    group = _chip_smoke()._kernel_group(_entry(name, 128))
    assert group.split()[0] == want, (name, group)


_RAGGED_HASH = ("_ZN58_GLOBAL__N__f6e2226a_25_ragged_paged_attention_cu_"
                "769a5bd4")


def _span_entry(maxd, kv):
    name = "ragged_span_kernel"
    return f"{_RAGGED_HASH}{len(name)}{name}ILi{maxd}ELi{kv}EEEvNS_6RaggedE"


@pytest.mark.parametrize("maxd", [128, 256])
@pytest.mark.parametrize("kv", [0, 1, 2])
def test_smoke_names_the_ragged_span_instantiations(maxd, kv):
    assert _chip_smoke()._kernel_label(_span_entry(maxd, kv)) == \
        f"ragged_span_kernel<{maxd},{kv}>"


_RAGGED_BF16_HASH = ("_ZN63_GLOBAL__N__a1b9b748_30_ragged_paged_attention_"
                     "bf16_cu_02800a36")


def _typed_span_entry(maxd, kv, qt):
    """The span form's entry with its third template argument, q's type
    (float, __nv_bfloat16 for a bf16 runner's q, __half for an fp16
    runner's)."""
    name = "ragged_span_kernel"
    t = {"f32": "f", "bf16": "13__nv_bfloat16", "f16": "6__half"}[qt]
    return (f"{_RAGGED_HASH}{len(name)}{name}ILi{maxd}ELi{kv}E{t}EEvNS_6"
            "RaggedE")


@pytest.mark.parametrize("maxd", [128, 256])
@pytest.mark.parametrize("kv,qt", [(0, "f32"), (1, "f32"), (2, "f32"),
                                   (3, "bf16"), (1, "bf16"), (2, "bf16"),
                                   (4, "f16"), (1, "f16"), (2, "f16")])
def test_smoke_names_the_typed_ragged_span_instantiations(maxd, kv, qt):
    """Each (pool type, q type) instantiation of the span form, as the
    build report must find it among TENSOR_CORE_INSTANTIATIONS; bf16 (fp16)
    q at d <= 128 takes the wgmma span form, ragged_span_bf16_kernel<pool
    type> (ragged_span_f16_kernel<pool type>), in its place."""
    cs = _chip_smoke()
    label = cs._kernel_label(_typed_span_entry(maxd, kv, qt))
    assert label == f"ragged_span_kernel<{maxd},{kv},{qt}>"
    if qt != "f32" and maxd == 128:
        assert label not in cs.TENSOR_CORE_INSTANTIATIONS
        name = f"ragged_span_{qt}_kernel"
        label = cs._kernel_label(
            f"{_RAGGED_BF16_HASH}{len(name)}{name}ILi{kv}EEEvN6ragged6RaggedE")
        assert label == f"ragged_span_{qt}_kernel<{kv}>"
        assert label.startswith(cs.HGMMA_KERNELS)
    assert label in cs.TENSOR_CORE_INSTANTIATIONS


# True: every instantiation holds its tensor-core products; False: one
# mma.sync instantiation holds none; a wgmma instantiation with HMMA but
# no HGMMA; a wgmma instantiation missing from the build; a wgmma
# instantiation that spills
@pytest.mark.parametrize("case", [True, False, "wgmma_hmma_only",
                                  "wgmma_missing", "wgmma_spills"])
def test_smoke_build_report_requires_tensor_core_products(monkeypatch,
                                                          case):
    """The build report passes when the SASS of every instantiation of the
    tensor-core kernels (the three flash kernels at fp32, bf16 and fp16,
    the bf16 and fp16 wgmma kernels, the ragged span forms) holds its
    tensor-core products (HMMA; HGMMA in the wgmma kernels and the 16-bit-q
    span forms), and fails the smoke when one holds none, when a wgmma
    kernel holds only HMMA, when one is missing, or when ptxas reports
    spills in a wgmma kernel."""
    import re
    import subprocess
    from types import SimpleNamespace

    cs = _chip_smoke()

    def entry(label):
        name, args = re.fullmatch(r"(\w+)<([\w,]+)>", label).groups()
        if name == "ragged_span_kernel":
            maxd, kv, qt = args.split(",")
            return _typed_span_entry(int(maxd), int(kv), qt)
        return _entry(name, int(args))

    labels = list(cs.TENSOR_CORE_INSTANTIATIONS)
    wgmma = [lb for lb in labels if lb.startswith(cs.WGMMA_KERNELS)]
    assert len(wgmma) == 12      # bf16 and fp16, three kernels, d 64 / 128
    hg_labels = [lb for lb in labels if lb.startswith(cs.HGMMA_KERNELS)]
    if case == "wgmma_missing":
        labels.remove(wgmma[-1])
    spill = {lb: 0 for lb in labels}
    if case == "wgmma_spills":
        spill[wgmma[2]] = 24
    log = "\n".join(f"ptxas info    : Compiling entry function "
                    f"'{entry(lb)}' for 'sm_90a'\n    0 bytes stack frame, "
                    f"{spill[lb]} bytes spill stores, {spill[lb]} bytes spill "
                    f"loads\nptxas info    : Used 200 registers"
                    for lb in labels)
    hmma = "\tHMMA.1688.F32.TF32 R0, R4, R8, R0\n"
    hgmma = "\tHGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24\n"
    sass = "".join(
        f"\tFunction : {entry(lb)}\n"
        + (hgmma if lb in hg_labels and case != "wgmma_hmma_only" else hmma)
        for lb in labels)
    if case is False:
        sass = sass.replace(hmma, "\tFADD\n", 1)
    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, stdout=sass))
    monkeypatch.setattr(cs, "log", lambda msg: None)
    build = SimpleNamespace(log=log, path=Path("libkernels.so"))
    if case is True:
        cs.build_report(build)
        # an instantiation missing from the build fails it as well
        cut = sass.split("\tFunction : ")
        monkeypatch.setattr(cs.subprocess, "run", lambda *a, **k:
                            subprocess.CompletedProcess(
                                a, 0, stdout="\tFunction : ".join(cut[:-1])))
        with pytest.raises(AssertionError, match="missing"):
            cs.build_report(build)
    else:
        with pytest.raises(AssertionError, match="spills" if case ==
                           "wgmma_spills" else "tensor-core"):
            cs.build_report(build)
