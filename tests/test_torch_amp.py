"""The port's bf16 AMP against the JAX package's, on the CPU.

A small Llama (vocab 256, hidden 64, 2 layers, 4 heads over 2 kv heads,
seq 128) and a small padded ERNIE (vocab 128, hidden 64, 2 layers, seq
128, dropout 0) are built in JAX; the JAX TrainStep runs their attention
through the Pallas flash kernels in interpret mode (the gate opened and
the kernel call spied into interpret mode, as tests/test_torch_training.py
does), the port's kernels run their plain versions (CPU tensors). Then:

  * `current_cast_dtype` equals the JAX one for every name of both lists
    (and a few on neither), at O1 and O2, with and without custom lists;
  * the dtype flow: every op of the models' forwards and losses that the
    port runs through `ops.impl` takes and gives the dtypes the JAX
    registry's dispatch records for it, at O1 and O2 (exact); so does
    every op a short program dispatches through the port's registry
    (`_C_ops`, the Tensor operators) against the JAX registry's;
  * the O1 TrainStep against the JAX TrainStep(amp_level="O1"): the step-1
    loss and every gradient, and the losses of 4 AdamW steps, for Llama
    and for ERNIE (n_inputs=3); a JAX O1 run resumes in the port;
  * O2 after `amp.decorate`: AdamW's master-weight update against the JAX
    `_update` on the same arrays (master within 1e-6, the bf16 parameter
    its master's cast), 3 O2 steps against the JAX ones, and a JAX O2 run
    (bf16 parameters, fp32 masters) resumed in the port through the state
    bridge;
  * GradScaler against the JAX one on the same gradients (scale, unscale_,
    the step skipped on inf / nan, back-off, growth, double unscale_);
  * the plain bf16 flash versions against the Pallas kernels in interpret
    mode on the same bf16 operands, dense and with a key-padding bias;
  * the port's counterparts of tests/test_llama.py::test_trainstep_loss_
    decreases (O1) and tests/test_misc_coverage.py::test_amp_decorate_o2,
    test_grad_scaler_fp16_flow and test_inf_grad_skips_step.

Tolerances across the frameworks are bf16-scale: XLA-CPU and torch round
bf16 intermediates at other points (XLA may keep fp32 inside a fused
elementwise chain; torch's bf16 sums accumulate in fp32), and a loss near
5 has a bf16 ulp of 2^-5. Within the port the pins are exact.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch
import paddle_tpu.amp as jamp
import paddle_tpu.ops.impl as jax_impl
import paddle_tpu.ops.pallas.flash_attention as jfa
from paddle_tpu.amp import state as jax_amp_state
from paddle_tpu.autograd.engine import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models import ernie as jax_ernie
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import llama_loss_fn as jax_llama_loss_fn
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu.optimizer import SGD as JaxSGD
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.utils.flags import set_flags as jax_set_flags
from paddle_tpu_torch import amp
from paddle_tpu_torch.amp import state
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    ErnieConfig, ErnieForPretraining, Llama, LlamaConfig,
    ernie_pretrain_loss_fn, llama_loss_fn, mask_tokens,
)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import impl
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
from paddle_tpu_torch.weights import (
    load_params, optimizer_state_from_numpy, optimizer_state_to_numpy,
    params_to_numpy,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the models are tiny: intra-op threads only contend with the other workers
torch.set_num_threads(1)

LLAMA = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=128)
ERNIE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             max_position=128, dropout=0.0)
SEQ, LR, WD, CLIP, STEPS, RESUME_AT = 128, 3e-3, 0.01, 1.0, 4, 2
# bf16-scale tolerances across the frameworks: a loss within LOSS_RTOL
# (about two bf16 ulp near 5), a gradient within GRAD_TOL * max|g| of the
# JAX one. Measured on this configuration: the Llama losses equal, the
# ERNIE ones within 1.6e-4; gradients within 0.9e-2 (Llama) and 2.8e-2
# (ERNIE) of max|g|
LOSS_RTOL, GRAD_TOL = 1.5e-2, 6e-2


def _dt(dtype) -> str:
    """A dtype's name in either framework ('float32', 'bfloat16')."""
    return str(dtype).replace("torch.", "") if dtype is not None else "None"


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


# ------------------------------------------------------ the cast lists

NAMES = sorted(state.WHITE_LIST | state.BLACK_LIST) + [
    "add", "reshape", "rotary_embedding", "embedding", "swiglu", "my_op"]
CUSTOM = {"none": ((), ()),
          "custom": (("add", "my_op", "layer_norm"), ("matmul", "reshape"))}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("custom", sorted(CUSTOM))
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("name", NAMES)
def test_current_cast_dtype_equals_jax(name, level, custom, dtype):
    white, black = CUSTOM[custom]
    kw = dict(custom_white_list=white, custom_black_list=black, level=level,
              dtype=dtype)
    with jamp.auto_cast(**kw):
        ref = jax_amp_state.current_cast_dtype(name)
    with amp.auto_cast(**kw):
        ours = state.current_cast_dtype(name)
    assert _dt(ours) == _dt(None if ref is None else np.dtype(ref))
    assert state.current_cast_dtype(name) is None
    assert jax_amp_state.current_cast_dtype(name) is None


def test_cast_inputs_casts_fp32_and_leaves_bf16_and_ints():
    """The registry's cast touches numpy's floating types only: bf16 stays
    bf16 even for a black-listed op, integers and None pass."""
    f, b, i = (torch.zeros(2, dtype=dt) for dt in (torch.float32,
                                                   torch.bfloat16,
                                                   torch.int64))
    with amp.auto_cast(level="O2"):
        got = state.cast_inputs("rms_norm", f, b, i, None)
        assert [t.dtype for t in got[:3]] == [torch.float32, torch.bfloat16,
                                              torch.int64]
        assert got[3] is None
        got = state.cast_inputs("add", f.double(), f.half())
        assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16]
    assert state.cast_inputs("linear", f)[0] is f


# ------------------------------------------------------- the dtype flow

# the JAX ops the port runs through ops.impl under the same names
TRACKED = ("embedding", "rms_norm", "layer_norm", "linear", "matmul",
           "rotary_embedding", "repeat_interleave",
           "scaled_dot_product_attention", "swiglu", "gelu", "tanh",
           "dropout", "cross_entropy")


def _jax_float_dtypes(obj):
    if isinstance(obj, Tensor):
        obj = obj._value
    if isinstance(obj, (list, tuple)):
        return [d for e in obj for d in _jax_float_dtypes(e)]
    if hasattr(obj, "dtype") and hasattr(obj, "shape") and \
            jnp.issubdtype(obj.dtype, jnp.floating):
        return [_dt(obj.dtype)]
    return []


@contextlib.contextmanager
def _jax_trace(log):
    """Record (op, floating input dtypes, output dtypes) of every tracked
    JAX dispatch (inputs before the AMP cast, as the op is called)."""
    def before(name, args, kwargs):
        if name in TRACKED:
            log.append([name, _jax_float_dtypes(list(args) +
                                                list(kwargs.values())), None])

    def after(name, outs):
        if name in TRACKED:
            open_ = [e for e in log if e[0] == name and e[2] is None]
            open_[-1][2] = [_dt(o.dtype) for o in outs]

    jax_registry.TRACE_HOOK[0], jax_registry.CHECK_HOOK[0] = before, after
    try:
        yield
    finally:
        jax_registry.TRACE_HOOK[0] = jax_registry.CHECK_HOOK[0] = None


@contextlib.contextmanager
def _port_trace(log, monkeypatch):
    """The same record of the port's ops.impl calls."""
    def floats(obj):
        if isinstance(obj, torch.Tensor):
            return [_dt(obj.dtype)] if obj.is_floating_point() else []
        if isinstance(obj, (list, tuple)):
            return [d for e in obj for d in floats(e)]
        return []

    for name in TRACKED:
        fn = getattr(impl, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            entry = [_name, floats(list(args) + list(kwargs.values())), None]
            log.append(entry)
            out = _fn(*args, **kwargs)
            entry[2] = floats(out if isinstance(out, tuple) else [out])
            return out

        monkeypatch.setattr(impl, name, wrapped)
    yield


def _llama_inputs(seed=0):
    toks = np.random.default_rng(seed).integers(0, 256, (2, SEQ + 1))
    return toks[:, :-1], toks[:, 1:]


def _ernie_batch(seed=0):
    """child_ernie's batch at a small size: masked ids, a padded row, -100
    labels on pads, random token types and SOP labels."""
    rng = np.random.default_rng(seed)
    base = rng.integers(5, ERNIE["vocab_size"], (2, SEQ))
    ids, labels = mask_tokens(base, ERNIE["vocab_size"], rng)
    att = np.ones((2, SEQ), np.int64)
    att[1, 100:] = 0
    labels = np.where(att > 0, labels, -100)
    types = rng.integers(0, 2, (2, SEQ))
    sop = rng.integers(0, 2, (2,))
    return ids, types, att, labels, sop


def _jax_model(which):
    paddle.seed(5)
    if which == "llama":
        return JaxLlama(JaxLlamaConfig(**LLAMA))
    return jax_ernie.ErnieForPretraining(jax_ernie.ErnieConfig(**ERNIE))


def _port_model(which, params):
    model = (Llama(LlamaConfig(**LLAMA), device="cpu") if which == "llama"
             else ErnieForPretraining(ErnieConfig(**ERNIE), device="cpu"))
    load_params(model, params)
    return model


def _forward_and_loss(which, model, wrap, loss_fn, level,
                      dtype="bfloat16"):
    """The TrainStep's forward (under auto_cast) and loss (outside)."""
    ctx = jamp if wrap is paddle.to_tensor else amp
    if which == "llama":
        ids, labels = _llama_inputs()
        with ctx.auto_cast(level=level, dtype=dtype):
            out = model(wrap(ids))
        return loss_fn(out, wrap(labels))
    ids, types, att, labels, sop = _ernie_batch()
    with ctx.auto_cast(level=level, dtype=dtype):
        out = model(wrap(ids), wrap(types), wrap(att))
    return loss_fn(out, wrap(labels), wrap(sop))


def _registry_program(P):
    """Registry ops on Tensors, the same code for either package: white-,
    black- and unlisted ops, the operators (`+`, `*`, `[]`), a list input,
    integer inputs and an fp16 input."""
    rng = np.random.default_rng(0)
    x = P.to_tensor(rng.standard_normal((4, 6)).astype(np.float32))
    w = P.to_tensor(rng.standard_normal((6, 6)).astype(np.float32))
    y = P.to_tensor(rng.standard_normal((4, 6)).astype(np.float16))
    ids = P.to_tensor(np.array([[0, 2], [5, 1]]))
    lab = P.to_tensor(np.array([1, 0, 5, 2]))
    c = P._C_ops
    h = c.matmul(x, w)
    h = c.exp(c.tanh(h)) + x
    h = c.relu(h) * 2.0
    p = c.softmax(h, axis=-1)
    m = c.mean(c.concat([p, y], axis=0), axis=0)
    z = c.multiply(y, y)
    r = c.rms_norm(z) + c.layer_norm(x, epsilon=1e-5)
    e = c.embedding(ids, w)
    q = c.reshape(e, [-1])[3]
    loss = c.cross_entropy(c.linear(r, w), lab) + c.sum(m) + q
    return c.scaled_dot_product_attention(
        c.reshape(h, [1, 4, 1, 6]), c.reshape(x, [1, 4, 1, 6]),
        c.reshape(z, [1, 4, 1, 6])), loss


def _registry_flow(level, dtype):
    """The op-by-op dtype log of `_registry_program` under auto_cast from
    each package's registry hooks (inputs before the cast, outputs)."""
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.ops import registry

    def record(reg, log, floats):
        def before(name, args, kwargs):
            log.append([name, floats(list(args) + list(kwargs.values())),
                        None])

        def after(name, outs):
            [e for e in log if e[2] is None][-1][2] = [_dt(o.dtype)
                                                      for o in outs]

        reg.TRACE_HOOK[0], reg.CHECK_HOOK[0] = before, after

    def port_floats(obj):
        if isinstance(obj, paddle_tpu_torch.Tensor):
            obj = obj._value
        if isinstance(obj, (list, tuple)):
            return [d for e in obj for d in port_floats(e)]
        return [_dt(obj.dtype)] if isinstance(obj, torch.Tensor) and \
            obj.is_floating_point() else []

    saved = place._expected_place
    logs = []
    try:
        paddle_tpu_torch.set_device("cpu")
        for P, reg, floats, ctx in (
                (paddle, jax_registry, _jax_float_dtypes, jamp),
                (paddle_tpu_torch, registry, port_floats, amp)):
            log = []
            record(reg, log, floats)
            with ctx.auto_cast(level=level, dtype=dtype):
                out, loss = _registry_program(P)
            logs.append((log, _dt(out.dtype), _dt(loss.dtype)))
    finally:
        for reg in (jax_registry, registry):
            reg.TRACE_HOOK[0] = reg.CHECK_HOOK[0] = None
        place._expected_place = saved
    (ref, ref_out, ref_loss), (ours, out, loss) = logs
    assert len(ref) > 15
    assert ours == ref
    assert (out, loss) == (ref_out, ref_loss)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("which", ["llama", "ernie", "registry"])
def test_every_op_takes_and_gives_the_jax_dtypes(which, level, dtype,
                                                 monkeypatch):
    """At fp16 the cast differs from bf16's: fp16 is a numpy floating type,
    so an fp16 input to a black-listed op is cast to fp32, where a bf16
    one is left as it is. "registry": the ops dispatched through the
    port's registry (`_C_ops` and the Tensor operators) against the JAX
    registry's, every op of a short program logged by the hooks."""
    if which == "registry":
        _registry_flow(level, dtype)
        return
    jax_model = _jax_model(which)
    params = {k: np.asarray(v) for k, v in
              functionalize(jax_model).param_values().items()}
    model = _port_model(which, params)
    if level == "O2":
        jamp.decorate(jax_model, level="O2", dtype=dtype)
        amp.decorate(model, level="O2", dtype=dtype)
    jax_loss_fn = (jax_llama_loss_fn if which == "llama"
                   else jax_ernie.ernie_pretrain_loss_fn)
    port_loss_fn = (llama_loss_fn if which == "llama"
                    else ernie_pretrain_loss_fn)
    ref, ours = [], []
    with _jax_trace(ref):
        ref_loss = _forward_and_loss(which, jax_model, paddle.to_tensor,
                                     jax_loss_fn, level, dtype)
    with _port_trace(ours, monkeypatch):
        loss = _forward_and_loss(which, model, torch.from_numpy,
                                 port_loss_fn, level, dtype)
    assert len(ref) > 10
    assert ours == ref
    assert _dt(loss.dtype) == _dt(ref_loss._value.dtype)


# ------------------------------------------------ O1 against the JAX step

def _jax_step_loss(which, func, params, level):
    """The JAX TrainStep's loss of the batch as a function of params."""
    if which == "llama":
        ids, labels = _llama_inputs()
        inputs, labels = (ids,), (labels,)
        loss_fn = jax_llama_loss_fn
    else:
        ids, types, att, labels, sop = _ernie_batch()
        inputs, labels = (ids, types, att), (labels, sop)
        loss_fn = jax_ernie.ernie_pretrain_loss_fn
    with jamp.auto_cast(level=level, dtype="bfloat16"):
        out, _ = func.apply(params, func.buffer_values(), None, True,
                            *(jnp.asarray(a) for a in inputs))
    with no_grad():
        wrapped = (Tensor._wrap(out) if which == "llama"
                   else tuple(Tensor._wrap(o) for o in out))
        loss = loss_fn(wrapped, *(Tensor._wrap(jnp.asarray(a))
                                  for a in labels))
    return loss._value


def _batch(which):
    return _llama_inputs() if which == "llama" else _ernie_batch()


def _loss_fns(which):
    return ((jax_llama_loss_fn, llama_loss_fn, 1) if which == "llama"
            else (jax_ernie.ernie_pretrain_loss_fn, ernie_pretrain_loss_fn,
                  3))


@pytest.fixture(scope="module", params=["llama", "ernie"])
def jax_o1(request):
    """The JAX side at O1: initial params, step-1 loss and grads, the
    TrainStep's losses and its state after RESUME_AT steps."""
    which = request.param
    calls = []
    with _jax_flash_in_interpret_mode(calls):
        model = _jax_model(which)
        func = functionalize(model)
        params = func.param_values()
        loss, grads = jax.value_and_grad(
            lambda p: _jax_step_loss(which, func, p, "O1"))(params)
        opt = JaxAdamW(learning_rate=LR, weight_decay=WD,
                       parameters=model.parameters(), grad_clip=JaxClip(CLIP))
        jax_loss_fn, _, n_inputs = _loss_fns(which)
        step = JaxTrainStep(model, jax_loss_fn, opt, n_inputs=n_inputs,
                            amp_level="O1", amp_dtype="bfloat16")
        batch = [paddle.to_tensor(a) for a in _batch(which)]
        losses, resume = [], None
        for i in range(STEPS):
            if i == RESUME_AT:
                resume = (
                    {k: np.asarray(v) for k, v in step.params.items()},
                    {k: {m: np.asarray(a) for m, a in st.items()}
                     for k, st in step.opt_state.items()},
                    step._step_i)
            losses.append(float(step(*batch)._value.astype(jnp.float32)))
    assert calls and set(calls) == {"bfloat16"}, \
        "the JAX model did not reach the flash kernel at bf16"
    return dict(which=which, loss=float(loss.astype(jnp.float32)),
                loss_dtype=_dt(loss.dtype),
                params={k: np.asarray(v) for k, v in params.items()},
                grads={k: np.asarray(g) for k, g in grads.items()},
                losses=losses, resume=resume)


def _port_trainer(which, model, level="O1"):
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(CLIP))
    _, loss_fn, n_inputs = _loss_fns(which)
    return TrainStep(model, loss_fn, opt, n_inputs=n_inputs,
                     amp_level=level), opt


def test_o1_step1_loss_and_every_gradient_match_jax(jax_o1):
    which = jax_o1["which"]
    model = _port_model(which, jax_o1["params"])
    _, loss_fn, _ = _loss_fns(which)
    counts = fa.counts_for(which == "ernie", torch.bfloat16)
    fa.reset_counts()
    loss = _forward_and_loss(which, model, torch.from_numpy, loss_fn, "O1")
    loss.backward()
    assert _dt(loss.dtype) == jax_o1["loss_dtype"]
    np.testing.assert_allclose(loss.float().item(), jax_o1["loss"],
                               rtol=LOSS_RTOL)
    grads = dict(model.named_parameters())
    assert set(grads) == set(jax_o1["grads"])
    for name, ref in jax_o1["grads"].items():
        got = grads[name].grad
        assert got.dtype == torch.float32, name
        err = np.abs(got.numpy() - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (name, err)
    # the bf16 flash path, once per layer, plain on the CPU
    layers = (LLAMA if which == "llama" else ERNIE)["num_layers"]
    assert {n: c.plain_launches for n, c in counts.items()} == \
        dict.fromkeys(counts, layers)


def test_o1_adamw_losses_match_jax_trainstep(jax_o1):
    which = jax_o1["which"]
    model = _port_model(which, jax_o1["params"])
    step, opt = _port_trainer(which, model)
    batch = _batch(which)
    losses = [step(*batch).float().item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jax_o1["losses"], rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all("master" not in opt.state[p] for p in model.parameters())


def test_o1_jax_run_resumes_in_the_port(jax_o1):
    which = jax_o1["which"]
    params, opt_state, step_i = jax_o1["resume"]
    model = _port_model(which, params)
    step, opt = _port_trainer(which, model)
    optimizer_state_from_numpy(opt, model, opt_state, step_i)
    batch = _batch(which)
    losses = [step(*batch).float().item() for _ in range(STEPS - RESUME_AT)]
    np.testing.assert_allclose(losses, jax_o1["losses"][RESUME_AT:],
                               rtol=LOSS_RTOL)


# ------------------------------------------------------------------- O2

def test_o2_master_update_matches_jax_update_on_the_same_arrays():
    """A bf16 parameter's AdamW update from its fp32 master copy: the
    master within 1e-6 of the JAX one, the parameter its master's cast
    (bit for bit) and the JAX parameter's (within one bf16 ulp); step()
    and the same update over this parameter alone (`_update([p], ...)`)
    agree."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((64, 48)).astype(np.float32)
    p_bf = torch.from_numpy(p0).to(torch.bfloat16)
    ref = JaxAdamW(LR, parameters=None, weight_decay=0.1)
    jp = jnp.asarray(p_bf.float().numpy()).astype(jnp.bfloat16)
    st = ref._init_state(jp)
    assert set(st) == {"moment1", "moment2", "master"}
    ours = [p_bf.clone(), p_bf.clone()]
    opts = [AdamW(LR, parameters=[p], weight_decay=0.1) for p in ours]
    for step in range(1, 6):
        g = (rng.standard_normal(p0.shape) * 10.0 ** -step).astype(
            np.float32)
        g_bf = torch.from_numpy(g).to(torch.bfloat16)
        jp, st = ref._update(jp, jnp.asarray(g_bf.float().numpy()).astype(
            jnp.bfloat16), st, jnp.asarray(LR, jnp.float32), 0.1,
            jnp.asarray(step, jnp.int32))
        ours[0].grad = g_bf.clone()
        opts[0].step()
        opts[1]._step_i += 1
        opts[1]._update([ours[1]], [g_bf.clone()], LR, 0.1, step)
        for p, opt in zip(ours, opts):
            master = opt.state[p]["master"]
            assert master.dtype == torch.float32 and p.dtype == torch.bfloat16
            np.testing.assert_allclose(master.numpy(), np.asarray(
                st["master"]), rtol=1e-6, atol=1e-6)
            for key in ("moment1", "moment2"):
                np.testing.assert_allclose(opt.state[p][key].numpy(),
                                           np.asarray(st[key]), rtol=1e-6,
                                           atol=1e-12)
            assert torch.equal(p, master.to(torch.bfloat16))
            np.testing.assert_allclose(
                p.float().numpy(), np.asarray(jp.astype(jnp.float32)),
                rtol=2.0 ** -7)
        assert torch.equal(ours[0], ours[1])


@pytest.fixture(scope="module")
def jax_o2():
    """A JAX Llama after amp.decorate(level="O2") trained at O2: its bf16
    params, losses and its state (masters included) after RESUME_AT
    steps."""
    calls = []
    with _jax_flash_in_interpret_mode(calls):
        model = _jax_model("llama")
        params = {k: np.asarray(v) for k, v in
                  functionalize(model).param_values().items()}
        jamp.decorate(model, level="O2")
        opt = JaxAdamW(learning_rate=LR, weight_decay=WD,
                       parameters=model.parameters(), grad_clip=JaxClip(CLIP))
        step = JaxTrainStep(model, jax_llama_loss_fn, opt, amp_level="O2",
                            amp_dtype="bfloat16")
        batch = [paddle.to_tensor(a) for a in _llama_inputs()]
        losses, resume = [], None
        for i in range(STEPS):
            if i == RESUME_AT:
                resume = (
                    {k: np.asarray(v) for k, v in step.params.items()},
                    {k: {m: np.asarray(a) for m, a in st.items()}
                     for k, st in step.opt_state.items()},
                    step._step_i)
            losses.append(float(step(*batch)._value.astype(jnp.float32)))
    assert calls and set(calls) == {"bfloat16"}
    return dict(params=params, losses=losses, resume=resume)


def test_o2_steps_match_jax(jax_o2):
    model = _port_model("llama", jax_o2["params"])
    amp.decorate(model, level="O2")
    step, opt = _port_trainer("llama", model, "O2")
    batch = _llama_inputs()
    losses = [step(*batch).float().item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jax_o2["losses"], rtol=LOSS_RTOL)
    for p in model.parameters():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, opt.state[p]["master"].to(torch.bfloat16))


def test_o2_state_bridge_carries_the_masters(jax_o2):
    params, opt_state, step_i = jax_o2["resume"]
    assert all(a.dtype.name == "bfloat16" for a in params.values())
    assert all(set(st) == {"moment1", "moment2", "master"}
               for st in opt_state.values())
    model = Llama(LlamaConfig(**LLAMA), device="cpu")
    amp.decorate(model, level="O2")
    load_params(model, params)
    step, opt = _port_trainer("llama", model, "O2")
    optimizer_state_from_numpy(opt, model, opt_state, step_i)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(
            opt.state[p]["master"].numpy(), opt_state[name]["master"])
    batch = _llama_inputs()
    losses = [step(*batch).float().item() for _ in range(STEPS - RESUME_AT)]
    np.testing.assert_allclose(losses, jax_o2["losses"][RESUME_AT:],
                               rtol=LOSS_RTOL)
    state_np, n = optimizer_state_to_numpy(opt, model)
    assert n == STEPS and all(set(st) == {"moment1", "moment2", "master"}
                              for st in state_np.values())
    out = params_to_numpy(model)
    assert all(a.dtype.name == "bfloat16" for a in out.values())
    for name, p in model.named_parameters():
        assert torch.equal(p, opt.state[p]["master"].to(torch.bfloat16))
        np.testing.assert_array_equal(
            out[name].view(np.int16), p.view(torch.int16).numpy())


def test_bf16_arrays_are_refused_by_an_fp32_model():
    model = Llama(LlamaConfig(**LLAMA), device="cpu")
    params = params_to_numpy(model)
    name = next(iter(params))
    params[name] = np.asarray(jnp.asarray(params[name], jnp.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        load_params(model, params)


# ----------------------------------------------------------- GradScaler

# (gradient before scaling, what the step should do): finite steps grow
# the scale every 2, a non-finite one skips the step and halves it
SCALER_GRADS = [[1.0, -2.0], [0.5, 0.25], [np.inf, 1.0], [3.0, 1.0],
                [1.0, np.nan], [2.0, -1.0], [1.0, 1.0], [0.5, 0.5]]


def test_grad_scaler_matches_jax_on_the_same_gradients():
    kw = dict(init_loss_scaling=8.0, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
    jw = paddle.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    jw.trainable = True
    jopt = JaxSGD(learning_rate=0.1, parameters=[jw])
    jscaler = jamp.GradScaler(**kw)
    w = torch.ones(2, requires_grad=True)
    opt = torch.optim.SGD([w], lr=0.1)
    scaler = amp.GradScaler(**kw)
    loss = torch.tensor(1.5)
    assert scaler.scale(loss).item() == \
        float(jscaler.scale(paddle.to_tensor(np.float32(1.5))))
    scales = []
    for g in SCALER_GRADS:
        g = np.asarray(g, np.float32)
        jw.grad = paddle.to_tensor(g * np.float32(jscaler.get_scale()))
        w.grad = torch.from_numpy(g * np.float32(scaler.get_scale()))
        jscaler.unscale_(jopt)
        scaler.unscale_(opt)
        with pytest.raises(RuntimeError, match="already been called"):
            jscaler.unscale_(jopt)
        with pytest.raises(RuntimeError, match="already been called"):
            scaler.unscale_(opt)
        assert scaler._found_inf == jscaler._found_inf
        jscaler.step(jopt)
        jscaler.update()
        scaler.step(opt)
        scaler.update()
        assert scaler.get_scale() == jscaler.get_scale()
        assert scaler.state_dict() == jscaler.state_dict()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw._value),
                                   rtol=1e-6)
        scales.append(scaler.get_scale())
    # growth after two good steps, back-off on inf and on nan
    assert scales == [8.0, 16.0, 8.0, 8.0, 4.0, 4.0, 8.0, 8.0]


def test_disabled_grad_scaler_steps_as_it_is():
    w = torch.ones(2, requires_grad=True)
    opt = torch.optim.SGD([w], lr=0.1)
    scaler = amp.GradScaler(enable=False)
    loss = (w * 3).sum()
    assert scaler.scale(loss) is loss
    loss.backward()
    scaler.step(opt)
    np.testing.assert_allclose(w.detach().numpy(), 0.7, rtol=1e-6)
    assert not scaler.is_enable()


# ---------------------------------------------- plain bf16 flash versions

def _bf16_operands(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, s, h, d)).astype(np.float32)
              for _ in range(4)]
    ours = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    ref = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    for t, r in zip(ours, ref):
        assert np.array_equal(t.float().numpy(), np.asarray(r, np.float32))
    return ours, ref


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "kbias"])
def test_plain_bf16_versions_match_pallas_kernels(masked, causal):
    """The plain versions on bf16 operands (fp32 compute, outputs in bf16)
    against the Pallas kernels in interpret mode on the same operands: o,
    dq, dk, dv within one bf16 ulp (each rounds an fp32 result once), lse
    (fp32) within 1e-5."""
    b, s, h, d = 2, 128, 2, 64
    (q, k, v, do), (jq, jk, jv, jdo) = _bf16_operands(7, b, s, h, d)
    scale = 1.0 / math.sqrt(d)
    kbias = jkbias = None
    if masked:
        pad = np.zeros((b, s), np.float32)
        pad[1, 90:] = -1e4
        kbias, jkbias = torch.from_numpy(pad), jnp.asarray(pad)
    jo, jlse = jfa._flash_forward(jq, jk, jv, None, jkbias, None, None, None,
                                  causal, scale, 128, 128, True,
                                  with_lse=True)
    ref_grads = jfa._flash_backward(jq, jk, jv, jo, jdo, jlse, None, jkbias,
                                    None, None, None, causal, scale, 128,
                                    128, True)
    o, lse = fa.flash_forward(q, k, v, causal, kbias=kbias)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert str(jo.dtype) == "bfloat16"
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0].reshape(
        b, h, s), rtol=1e-5, atol=1e-5)
    # the backward from the same o, so both read one delta
    o = torch.from_numpy(np.asarray(jo.astype(jnp.float32))).to(
        torch.bfloat16)
    grads = fa.flash_backward(q, k, v, o, do, lse, causal, kbias=kbias)
    pairs = [("o", fa.flash_forward(q, k, v, causal, kbias=kbias)[0], jo)]
    pairs += list(zip(("dq", "dk", "dv"), grads, ref_grads))
    for name, ours, ref in pairs:
        assert ours.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(ours.float().numpy(), ref, rtol=2.0 ** -7,
                                   atol=1e-3 * np.abs(ref).max(),
                                   err_msg=name)


# ----------------------------------- counterparts of the JAX package's tests

def test_trainstep_loss_decreases_o1():
    """tests/test_llama.py::test_trainstep_loss_decreases, in the port."""
    torch.manual_seed(1)
    model = Llama(LlamaConfig(vocab_size=256, hidden_size=64, num_layers=2,
                              num_heads=4, num_kv_heads=2, max_seq_len=64),
                  device="cpu", seed=1)
    opt = AdamW(parameters=model.named_parameters(), learning_rate=3e-3)
    step = TrainStep(model, llama_loss_fn, opt, amp_level="O1",
                     amp_dtype="bfloat16")
    toks = torch.from_numpy(np.random.default_rng(23).integers(0, 256,
                                                               (2, 32)))
    losses = [step(toks, toks).float().item() for _ in range(6)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_amp_decorate_o2():
    """tests/test_misc_coverage.py::test_amp_decorate_o2, in the port."""
    net = torch.nn.Linear(4, 4)
    assert amp.decorate(net, level="O2", dtype="bfloat16") is net
    assert net.weight.dtype == torch.bfloat16
    other = torch.nn.Linear(4, 4)
    amp.decorate(other, level="O1")
    assert other.weight.dtype == torch.float32


def test_grad_scaler_fp16_flow():
    """tests/test_misc_coverage.py::test_grad_scaler_fp16_flow."""
    w = torch.ones(2, requires_grad=True)
    opt = torch.optim.SGD([w], lr=0.1)
    scaler = amp.GradScaler(init_loss_scaling=8.0)
    loss = (w * 3).sum()
    scaler.scale(loss).backward()
    scaler.step(opt)
    scaler.update()
    np.testing.assert_allclose(w.detach().numpy(), 1.0 - 0.3, rtol=1e-6)


def test_inf_grad_skips_step():
    """tests/test_misc_coverage.py::test_inf_grad_skips_step."""
    w = torch.ones(2, requires_grad=True)
    opt = torch.optim.SGD([w], lr=0.1)
    scaler = amp.GradScaler(init_loss_scaling=8.0)
    w.grad = torch.tensor([np.inf, 1.0])
    scaler.step(opt)
    scaler.update()
    np.testing.assert_allclose(w.detach().numpy(), 1.0)
    assert scaler.get_scale() < 8.0


def test_amp_entry_points_and_probes():
    assert amp.amp_guard is amp.auto_cast
    assert amp.is_bfloat16_supported() and amp.is_float16_supported()
    with amp.auto_cast(level="O1", dtype="float16"):
        assert state.current_cast_dtype("linear") == torch.float16
    with pytest.raises(ValueError, match="int8"):
        amp.auto_cast(dtype="int8")
    model = Llama(LlamaConfig(**LLAMA), device="cpu")
    opt = AdamW(parameters=model.named_parameters())
    # fp16 AMP trains (tests/test_torch_fp16_training.py); other dtypes
    # and levels are errors of the call
    assert TrainStep(model, llama_loss_fn, opt, amp_level="O2",
                     amp_dtype="float16").amp_dtype == "float16"
    with pytest.raises(ValueError, match="float16"):
        TrainStep(model, llama_loss_fn, opt, amp_level="O2",
                  amp_dtype="float32")
    with pytest.raises(ValueError, match="amp_level"):
        TrainStep(model, llama_loss_fn, opt, amp_level="O3",
                  amp_dtype="float16")
