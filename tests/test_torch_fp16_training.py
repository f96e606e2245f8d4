"""The port's fp16 AMP training against the JAX package's, on the CPU.

fp16 with dynamic loss scaling is the classic Paddle AMP recipe; the JAX
package trains in it through `amp.auto_cast(dtype="float16")`,
`amp.decorate(level="O2", dtype="float16")`, `GradScaler` and
`TrainStep(amp_dtype="float16")`, its Pallas flash kernels casting each
fp16 tile to fp32 and writing their outputs in fp16. Here:

  * the plain fp16 flash versions (fp32 compute, outputs cast to fp16)
    against the Pallas kernels in interpret mode on the same fp16
    operands: dense, with a per-key bias, segment ids and an additive
    mask, causal and full, with dO at x1, x2^15 and x2^-15 of a small
    gradient (2^-3 unit normals; at x2^15 the values are 4x too, so
    causal |dS| passes fp16's 65504 while the outputs stay finite); o,
    lse, dq, dk and
    dv finite where JAX's are, within 1e-2 of max|x|; and an overflow
    case (x2^15, values 64x): dq and dk inf at the positions where JAX's
    are, with JAX's signs; on the same operands the fp16 kernels' dS
    factors (`ds_scales`) keep every row's scaled |dS| under 2^15;
  * `TrainStep(amp_dtype="float16")` at O1 and O2 (after
    `amp.decorate(level="O2", dtype="float16")`: fp16 parameters with fp32
    masters in AdamW) on a small Llama, ERNIE and GPT against the JAX
    TrainStep: the step-1 loss (rtol 1e-2) and every gradient (within
    5e-2 of its max|g|), then the losses of 3 AdamW steps; each flash
    kernel's fp16 form once a layer, plain on the CPU;
  * an eager fp16 O2 loop with `GradScaler` against the JAX one on the
    same small Llama: an initial scale whose first step overflows (the
    step skipped, the scale backed off), then steps that grow it; the
    losses, the scales, the skips and the parameters after each step.

The models run at seq 128 (one Pallas tile: the JAX dispatch takes the
kernel at multiples of 128 only), 2 layers, hidden 64, so each JAX run
takes seconds in interpret mode; the flash versions at seq 64. Tolerances are fp16-scale across
frameworks that round fp16 intermediates at other points.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.ops.impl as jax_impl
import paddle_tpu.ops.pallas.flash_attention as jfa
from paddle_tpu.autograd.engine import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models import ernie as jax_ernie
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import llama_loss_fn as jax_llama_loss_fn
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.utils.flags import set_flags as jax_set_flags
from paddle_tpu_torch import amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    GPT, ErnieConfig, ErnieForPretraining, GPTConfig, Llama, LlamaConfig,
    ernie_pretrain_loss_fn, gpt_loss_fn, llama_loss_fn, mask_tokens,
)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
from paddle_tpu_torch.weights import load_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the models are tiny: intra-op threads only contend with the other workers
torch.set_num_threads(1)

SEQ, LR, WD, CLIP, STEPS = 128, 3e-3, 0.01, 1.0, 3
SIZES = {
    "llama": dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, max_seq_len=SEQ),
    "ernie": dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                  max_position=SEQ, dropout=0.0),
    "gpt": dict(vocab_size=89, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=SEQ),
}
# fp16-scale tolerances across the frameworks: a loss within LOSS_RTOL, a
# gradient within GRAD_TOL * max|g| of the JAX one; a flash output within
# FLASH_TOL * max|x|
LOSS_RTOL, GRAD_TOL, FLASH_TOL = 1e-2, 5e-2, 1e-2
F16 = "float16"


@contextlib.contextmanager
def _jax_flash_in_interpret_mode(calls):
    """The JAX dispatch gate opened and the kernel call spied into
    interpret mode, so the JAX models run the Pallas kernels on the CPU."""
    orig = jfa.flash_attention

    def spy(q, k, v, **kw):
        calls.append(str(q.dtype))
        kw["interpret"] = True
        return orig(q, k, v, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_impl, "_flash_enabled", lambda: True)
        mp.setattr(jfa, "flash_attention", spy)
        # set_flags moves the eager op cache to a new key, so the traces
        # see the opened gate, and the tests after them do not reuse them
        jax_set_flags({"FLAGS_use_flash_attention": True})
        try:
            yield
        finally:
            jax_set_flags({"FLAGS_use_flash_attention": True})


# ------------------------------------------- the plain fp16 flash versions

# (dO's factor over 2^-3 unit normals, v's factor)
SCALES = {"x1": (1.0, 1.0), "x2^15": (2.0 ** 15, 4.0),
          "x2^-15": (2.0 ** -15, 1.0)}
OVERFLOW = (2.0 ** 15, 64.0)
FORMS = ("dense", "kbias", "segments", "mask")


def _fp16_operands(seed, b, s, h, d, do_scale, v_scale):
    """q, k, v, dO as fp16 in both frameworks (bit-equal), from unit
    normals: v times v_scale, dO times 2^-3 * do_scale (dO finite)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                   for _ in range(4))
    arrays = [q, k, v * np.float32(v_scale),
              do * np.float32(2.0 ** -3 * do_scale)]
    ours = [torch.from_numpy(a).half() for a in arrays]
    ref = [jnp.asarray(a).astype(jnp.float16) for a in arrays]
    for t, r in zip(ours, ref):
        assert torch.isfinite(t).all()
        assert np.array_equal(t.float().numpy(), np.asarray(r, np.float32))
    return ours, ref


def _masking(form, seed, b, s, h):
    """The form's canonical masking operands as numpy (mask fp32 [b, 1, s,
    s], kbias fp32 [b, s], qseg / kseg int32 [b, s])."""
    rng = np.random.default_rng(seed + 1)
    if form == "kbias":
        kbias = np.zeros((b, s), np.float32)
        kbias[-1, s * 3 // 4:] = -1e4
        return {"kbias": kbias}
    if form == "segments":
        seg = (np.arange(s)[None, :] >= rng.integers(1, s, (b, 1))).astype(
            np.int32)
        return {"qseg": seg, "kseg": seg}
    if form == "mask":
        mask = rng.standard_normal((b, 1, s, s)).astype(np.float32)
        mask[rng.random(mask.shape) < 0.3] = fa.NEG_INF
        return {"mask": mask}
    return {}


def _flash_both(form, causal, do_scale, v_scale, seed=3, b=2, s=64, h=2,
                d=32):
    """{name: (ours, JAX's)} of o, lse, dq, dk and dv as float32 numpy:
    the plain fp16 versions and the Pallas kernels in interpret mode on
    the same operands; the backward from the JAX o and lse, so both read
    one delta."""
    (q, k, v, do), (jq, jk, jv, jdo) = _fp16_operands(seed, b, s, h, d,
                                                      do_scale, v_scale)
    ops = _masking(form, seed, b, s, h)
    jops = [None if ops.get(n) is None else jnp.asarray(ops[n])
            for n in ("mask", "kbias", "qseg", "kseg")]
    tops = {n: torch.from_numpy(a) for n, a in ops.items()}
    scale = 1.0 / math.sqrt(d)
    jo, jlse = jfa._flash_forward(jq, jk, jv, *jops, None, causal, scale, s,
                                  s, True, with_lse=True)
    jgrads = jfa._flash_backward(jq, jk, jv, jo, jdo, jlse, *jops, None,
                                 causal, scale, s, s, True)
    counts = fa.counts_for(bool(ops), torch.float16)
    fa.reset_counts()
    o, lse = fa.flash_forward(q, k, v, causal, **tops)
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    assert str(jo.dtype) == F16
    o_jax = torch.from_numpy(np.array(jo.astype(jnp.float32))).half()
    lse_jax = torch.from_numpy(np.array(jlse[..., 0].reshape(b, h, s)))
    grads = fa.flash_backward(q, k, v, o_jax, do, lse_jax, causal, **tops)
    assert {n: (c.kernel_launches, c.plain_launches)
            for n, c in counts.items()} == {"flash_forward": (0, 1),
                                            "flash_backward_dq": (0, 1),
                                            "flash_backward_dkv": (0, 1)}
    out = {"o": (o, jo), "lse": (lse, jlse[..., 0].reshape(b, h, s))}
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        assert g.dtype == torch.float16 and str(jg.dtype) == F16, name
        out[name] = (g, jg)
    return {n: (x.float().numpy(), np.asarray(r, np.float32))
            for n, (x, r) in out.items()}


def _assert_close_where_finite(name, ours, ref):
    """ours finite exactly where ref is (inf of ref's sign elsewhere), and
    within FLASH_TOL * max|ref| on the finite ones."""
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(ours), fin, err_msg=name)
    np.testing.assert_array_equal(ours[~fin], ref[~fin], err_msg=name)
    if fin.any():
        err = np.abs(ours[fin] - ref[fin]).max()
        assert err <= FLASH_TOL * np.abs(ref[fin]).max(), (name, err)


@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("form", FORMS)
def test_plain_fp16_versions_match_pallas_kernels(form, causal, scale):
    """The plain fp16 versions against the Pallas kernels on fp16
    operands: every output finite where JAX's is (at these scales all
    are), within 1e-2 of max|x|."""
    for name, (ours, ref) in _flash_both(form, causal,
                                         *SCALES[scale]).items():
        assert np.isfinite(ref).all(), name
        _assert_close_where_finite(name, ours, ref)


@pytest.mark.parametrize("form", ["dense", "kbias"])
def test_plain_fp16_versions_overflow_where_pallas_does(form):
    """Outputs past fp16's 65504 are inf (the fp32 result's cast), at the
    positions and with the signs of JAX's; o, lse and dv stay finite."""
    got = _flash_both(form, True, *OVERFLOW)
    assert sum(int((~np.isfinite(got[n][1])).sum()) for n in ("dq", "dk")) \
        > 10
    for name, (ours, ref) in got.items():
        if name in ("o", "lse", "dv"):
            assert np.isfinite(ref).all(), name
        _assert_close_where_finite(name, ours, ref)


@pytest.mark.parametrize("scale", sorted(SCALES) + ["overflow"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ds_scales_keep_every_row_under_fp16s_top(causal, scale):
    """The fp16 kernels' dS factors (`ds_scales`, computed on the card
    before the launches): powers of two, and dS of each query row times its
    row's factor, and of each key times its key's, below DS_TOP = 2^15 on
    the operands of the flash cases above (the fp32 dS of the plain
    versions' own arithmetic)."""
    do_scale, v_scale = SCALES.get(scale, OVERFLOW)
    (q, k, v, do), _ = _fp16_operands(3, 2, 64, 2, 32, do_scale, v_scale)
    d_scale = 1.0 / math.sqrt(32)
    o, lse = fa.flash_forward(q, k, v, causal)
    delta = fa.backward_delta(o, do)
    _, ds = fa._backward_p_ds(q, k, v, do, lse, delta, causal, d_scale,
                              fa.Masks())
    rows, keys = fa.ds_scales(v, do, d_scale)
    assert rows.shape == (2, 2, 64) and keys.shape == (2, 2, 64)
    for f in (rows, keys):
        assert f.dtype == torch.float32
        np.testing.assert_array_equal(np.log2(f.numpy()),
                                      np.round(np.log2(f.numpy())))
    assert (ds.abs() * rows[..., None]).max() < fa.DS_TOP
    assert (ds.abs() * keys[..., None, :]).max() < fa.DS_TOP


# ------------------------------------------ TrainStep at fp16 against JAX

def _batch(which, seed=0):
    """Inputs then labels of one batch of 2 x SEQ."""
    rng = np.random.default_rng(seed)
    if which != "ernie":
        toks = rng.integers(0, SIZES[which]["vocab_size"], (2, SEQ + 1))
        return (toks[:, :-1],), (toks[:, 1:],)
    vocab = SIZES["ernie"]["vocab_size"]
    ids, labels = mask_tokens(rng.integers(5, vocab, (2, SEQ)), vocab, rng)
    att = np.ones((2, SEQ), np.int64)
    att[1, 100:] = 0
    labels = np.where(att > 0, labels, -100)
    types = rng.integers(0, 2, (2, SEQ))
    return (ids, types, att), (labels, rng.integers(0, 2, (2,)))


def _jax_model(which):
    paddle.seed(5)
    if which == "llama":
        return JaxLlama(JaxLlamaConfig(**SIZES["llama"]))
    if which == "gpt":
        return JaxGPT(JaxGPTConfig(**SIZES["gpt"]))
    return jax_ernie.ErnieForPretraining(
        jax_ernie.ErnieConfig(**SIZES["ernie"]))


def _port_model(which, params):
    if which == "llama":
        model = Llama(LlamaConfig(**SIZES["llama"]), device="cpu")
    elif which == "gpt":
        model = GPT(GPTConfig(**SIZES["gpt"]), device="cpu")
    else:
        model = ErnieForPretraining(ErnieConfig(**SIZES["ernie"]),
                                    device="cpu")
    load_params(model, params)
    return model


LOSS_FNS = {"llama": (jax_llama_loss_fn, llama_loss_fn),
            "gpt": (jax_gpt_loss_fn, gpt_loss_fn),
            "ernie": (jax_ernie.ernie_pretrain_loss_fn,
                      ernie_pretrain_loss_fn)}


def _jax_step_loss(which, func, params, level):
    """The JAX TrainStep's loss of the batch as a function of params."""
    inputs, labels = _batch(which)
    with jamp.auto_cast(level=level, dtype=F16):
        out, _ = func.apply(params, func.buffer_values(), None, True,
                            *(jnp.asarray(a) for a in inputs))
    with no_grad():
        wrapped = (tuple(Tensor._wrap(o) for o in out)
                   if isinstance(out, tuple) else Tensor._wrap(out))
        loss = LOSS_FNS[which][0](wrapped, *(Tensor._wrap(jnp.asarray(a))
                                             for a in labels))
    return loss._value


def _as_f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module", params=[(w, lv) for w in ("llama", "ernie",
                                                          "gpt")
                                        for lv in ("O1", "O2")],
                ids=lambda p: "-".join(p))
def jax_fp16(request):
    """The JAX side at fp16: the initial fp32 params, the step-1 loss and
    gradients (of the fp16 params after decorate at O2) and the losses of
    STEPS TrainSteps."""
    which, level = request.param
    calls = []
    with _jax_flash_in_interpret_mode(calls):
        model = _jax_model(which)
        params = {k: np.asarray(v) for k, v in
                  functionalize(model).param_values().items()}
        if level == "O2":
            jamp.decorate(model, level="O2", dtype=F16)
        func = functionalize(model)
        loss, grads = jax.value_and_grad(
            lambda p: _jax_step_loss(which, func, p, level))(
                func.param_values())
        opt = JaxAdamW(learning_rate=LR, weight_decay=WD,
                       parameters=model.parameters(), grad_clip=JaxClip(CLIP))
        step = JaxTrainStep(model, LOSS_FNS[which][0], opt,
                            n_inputs=len(_batch(which)[0]), amp_level=level,
                            amp_dtype=F16)
        batch = [paddle.to_tensor(a) for part in _batch(which) for a in part]
        losses = [float(_as_f32(step(*batch)._value)) for _ in range(STEPS)]
    assert calls and set(calls) == {F16}, \
        "the JAX model did not reach the flash kernel at fp16"
    return dict(which=which, level=level, params=params,
                loss=float(_as_f32(loss)), loss_dtype=str(loss.dtype),
                grads={k: (str(g.dtype), _as_f32(g))
                       for k, g in grads.items()},
                losses=losses)


def _port_fp16(jax_run):
    """The port's model of the JAX run's params, decorated at O2."""
    model = _port_model(jax_run["which"], jax_run["params"])
    if jax_run["level"] == "O2":
        amp.decorate(model, level="O2", dtype=F16)
    return model


def test_fp16_step1_loss_and_every_gradient_match_jax(jax_fp16):
    which, level = jax_fp16["which"], jax_fp16["level"]
    model = _port_fp16(jax_fp16)
    inputs, labels = _batch(which)
    counts = fa.counts_for(which == "ernie", torch.float16)
    fa.reset_counts()
    with amp.auto_cast(level=level, dtype=F16):
        out = model(*(torch.from_numpy(a) for a in inputs))
    loss = LOSS_FNS[which][1](out, *(torch.from_numpy(a) for a in labels))
    loss.backward()
    assert str(loss.dtype).replace("torch.", "") == jax_fp16["loss_dtype"]
    np.testing.assert_allclose(loss.float().item(), jax_fp16["loss"],
                               rtol=LOSS_RTOL)
    grads = dict(model.named_parameters())
    assert set(grads) == set(jax_fp16["grads"])
    for name, (dtype, ref) in jax_fp16["grads"].items():
        got = grads[name].grad
        assert str(got.dtype).replace("torch.", "") == dtype, name
        assert torch.isfinite(got).all(), name
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (name, err)
    # the fp16 flash path, once per layer, plain on the CPU
    layers = SIZES[which]["num_layers"]
    assert {n: (c.kernel_launches, c.plain_launches)
            for n, c in counts.items()} == dict.fromkeys(counts, (0, layers))


def test_fp16_trainstep_losses_match_jax(jax_fp16):
    which, level = jax_fp16["which"], jax_fp16["level"]
    model = _port_fp16(jax_fp16)
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(CLIP))
    inputs, labels = _batch(which)
    step = TrainStep(model, LOSS_FNS[which][1], opt, n_inputs=len(inputs),
                     amp_level=level, amp_dtype=F16)
    losses = [step(*inputs, *labels).float().item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jax_fp16["losses"], rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    want = torch.float16 if level == "O2" else torch.float32
    for p in model.parameters():
        assert p.dtype == want
        if level == "O2":
            assert torch.equal(p, opt.state[p]["master"].half())
        else:
            assert "master" not in opt.state[p]


# ----------------------------------------- an eager fp16 O2 GradScaler loop

# the first step's scaled gradients overflow fp16 (the step is skipped and
# the scale backed off by 2^-30); then a good step every time, the scale
# doubling every second one
SCALER = dict(init_loss_scaling=2.0 ** 40, decr_ratio=2.0 ** -30,
              incr_ratio=2.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
SCALER_STEPS = 4


def _jax_scaler_run(params):
    """The eager JAX loop: (losses, scales, skipped, params after)."""
    calls = []
    with _jax_flash_in_interpret_mode(calls):
        model = _jax_model("llama")
        load_jax = functionalize(model)
        assert set(load_jax.param_values()) == set(params)
        jamp.decorate(model, level="O2", dtype=F16)
        opt = JaxAdamW(learning_rate=LR, weight_decay=WD,
                       parameters=model.parameters())
        scaler = jamp.GradScaler(**SCALER)
        (ids,), (labels,) = _batch("llama")
        losses, scales, skipped = [], [], []
        for _ in range(SCALER_STEPS):
            with jamp.auto_cast(level="O2", dtype=F16):
                out = model(paddle.to_tensor(ids))
            loss = jax_llama_loss_fn(out, paddle.to_tensor(labels))
            scaler.scale(loss).backward()
            scaler.unscale_(opt)
            skipped.append(scaler._found_inf)
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            losses.append(float(_as_f32(loss._value)))
            scales.append(scaler.get_scale())
        after = {k: _as_f32(v) for k, v in
                 functionalize(model).param_values().items()}
    assert calls and set(calls) == {F16}
    return losses, scales, skipped, after


def test_fp16_o2_grad_scaler_loop_matches_jax():
    """The port's eager fp16 O2 loop (auto_cast, scaler.scale(loss)
    .backward(), unscale_, step, update) against the JAX one on the same
    weights and batch: the same skipped step and scales, the losses at
    rtol 1e-2, the fp16 parameters within twice the rates of the steps of
    the JAX ones (AdamW moves a parameter up to about its rate a step, in
    either direction where a gradient is near 0), and each parameter its
    fp32 master's cast."""
    jax_model = _jax_model("llama")
    params = {k: np.asarray(v) for k, v in
              functionalize(jax_model).param_values().items()}
    ref_losses, ref_scales, ref_skipped, ref_after = _jax_scaler_run(params)
    model = _port_model("llama", params)
    amp.decorate(model, level="O2", dtype=F16)
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.named_parameters())
    scaler = amp.GradScaler(**SCALER)
    (ids,), (labels,) = (tuple(torch.from_numpy(a) for a in part)
                         for part in _batch("llama"))
    losses, scales, skipped = [], [], []
    for _ in range(SCALER_STEPS):
        with amp.auto_cast(level="O2", dtype=F16):
            out = model(ids)
        loss = llama_loss_fn(out, labels)
        scaler.scale(loss).backward()
        scaler.unscale_(opt)
        skipped.append(scaler._found_inf)
        scaler.step(opt)
        scaler.update()
        opt.zero_grad(set_to_none=True)
        losses.append(loss.float().item())
        scales.append(scaler.get_scale())
    assert skipped == ref_skipped == [True] + [False] * (SCALER_STEPS - 1)
    assert scales == ref_scales == [2.0 ** 10, 2.0 ** 10, 2.0 ** 11,
                                    2.0 ** 11]
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[1]
    for name, p in model.named_parameters():
        assert p.dtype == torch.float16
        assert torch.equal(p, opt.state[p]["master"].half())
        np.testing.assert_allclose(p.float().detach().numpy(),
                                   ref_after[name], rtol=0,
                                   atol=2 * LR * SCALER_STEPS, err_msg=name)
