"""The port's GPT family against the JAX package's, on the CPU.

A small GPT (vocab 89, hidden 64, 2 layers, 4 heads of 16, seq 128;
tied and untied heads) is built in JAX; its weights cross to
`paddle_tpu_torch.models.GPT` as numpy through `weights.load_params`, and
back through `params_to_numpy`. The JAX TrainStep runs its attention
through the Pallas flash kernels in interpret mode (the gate opened and
the kernel call spied into interpret mode, as tests/test_torch_training.py
does); the port's kernels run their plain versions here (CPU tensors).

  * logits of the eval forward within 1e-5 * max|logit|, tied and untied;
  * the step-1 loss at rtol 1e-5 and every gradient within 1e-4 * max|g|;
  * 3 TrainSteps of AdamW (weight decay, global-norm clip) under
    LinearWarmup(CosineAnnealingDecay), each package stepping its own
    scheduler after each step: the rates equal, the losses at rtol 1e-4,
    every parameter after the third step within 1e-2 of the summed rates
    of JAX's (AdamW moves a parameter up to about its rate a step; the
    biases start at 0, so a share of max|p| would not do; measured: 7e-6
    against the 6.0e-5 gate);
  * the O1 dtype flow: every op of the forward and the loss that the port
    runs through `ops.impl` takes and gives the dtypes the JAX registry's
    dispatch records, exactly, and the O1 loss's dtype; then an O1 step
    against the JAX O1 step, and 3 scheduled O2 steps (bf16 parameters,
    fp32 masters) against the JAX O2 TrainStep (bf16-scale tolerances, as
    tests/test_torch_amp.py);
  * the knobs that raise, each naming its ROADMAP item.
"""

import contextlib

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
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.utils.flags import set_flags as jax_set_flags
from paddle_tpu_torch import amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    GPT, GPT3_1_3B, GPTConfig, build_pipeline_train_step, gpt_loss_fn,
)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import impl
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr
from paddle_tpu_torch.weights import load_params, params_to_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_num_threads(1)

SIZES = dict(vocab_size=89, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=128)
SEQ, WD, CLIP, STEPS = 128, 0.01, 1.0, 3
# bf16-scale tolerances across the frameworks (tests/test_torch_amp.py)
LOSS_RTOL, GRAD_TOL = 1.5e-2, 6e-2
TRACKED = ("embedding", "layer_norm", "linear", "matmul",
           "scaled_dot_product_attention", "gelu", "dropout",
           "cross_entropy")


def _schedule(mod):
    """The GPT-3 shape of schedule at a small size: a linear warm-up from
    1e-3 to 3e-3 over 2 steps, then a cosine to 3e-4."""
    return mod.LinearWarmup(mod.CosineAnnealingDecay(3e-3, T_max=4,
                                                     eta_min=3e-4),
                            warmup_steps=2, start_lr=1e-3, end_lr=3e-3)


def _batch(seed=0):
    toks = np.random.default_rng(seed).integers(0, 89, (2, SEQ + 1))
    return toks[:, :-1], toks[:, 1:]


@contextlib.contextmanager
def _jax_flash_in_interpret_mode(calls):
    """The JAX dispatch gate opened and the kernel call spied into
    interpret mode, so the JAX model runs the Pallas kernels on the CPU."""
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


def _jax_model(tie=True, seed=21):
    paddle.seed(seed)
    return JaxGPT(JaxGPTConfig(tie_embeddings=tie, **SIZES))


def _numpy_params(jax_model):
    return {k: np.asarray(v)
            for k, v in functionalize(jax_model).param_values().items()}


def _port_model(params, tie=True):
    model = GPT(GPTConfig(tie_embeddings=tie, **SIZES), device="cpu")
    load_params(model, params)
    return model


def _jax_step_loss(func, params, level=None):
    ids, labels = _batch()
    ctx = (jamp.auto_cast(level=level, dtype="bfloat16") if level
           else contextlib.nullcontext())
    with ctx:
        out, _ = func.apply(params, func.buffer_values(), None, True,
                            jnp.asarray(ids))
    with no_grad():
        loss = jax_gpt_loss_fn(Tensor._wrap(out),
                               Tensor._wrap(jnp.asarray(labels)))
    return loss._value


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_logits_match_jax(tie):
    jm = _jax_model(tie)
    jm.eval()
    params = _numpy_params(jm)
    model = _port_model(params, tie)
    assert ("lm_head.weight" in params) is (not tie)
    ids, _ = _batch(1)
    ref = np.asarray(jm(paddle.to_tensor(ids))._value)
    got = model(torch.from_numpy(ids)).detach().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # and back: the port's parameters export as the JAX dict
    back = params_to_numpy(model)
    assert set(back) == set(params)
    assert all(np.array_equal(back[k], params[k]) for k in params)


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def jax_run(request):
    """The JAX side: initial params, step-1 loss and grads, and 3 scheduled
    AdamW TrainSteps (losses, rates, final params)."""
    tie = request.param
    calls = []
    with _jax_flash_in_interpret_mode(calls):
        model = _jax_model(tie)
        func = functionalize(model)
        params = func.param_values()
        loss, grads = jax.value_and_grad(
            lambda p: _jax_step_loss(func, p))(params)
        sched = _schedule(jlr)
        opt = JaxAdamW(learning_rate=sched, weight_decay=WD,
                       parameters=model.parameters(),
                       grad_clip=JaxClip(CLIP))
        step = JaxTrainStep(model, jax_gpt_loss_fn, opt)
        ids, labels = _batch()
        losses, rates = [], []
        for _ in range(STEPS):
            rates.append(opt.get_lr())
            losses.append(float(step(paddle.to_tensor(ids),
                                     paddle.to_tensor(labels))))
            sched.step()
        final = {k: np.asarray(v) for k, v in step.params.items()}
    assert calls, "the JAX model did not reach the flash kernel"
    return dict(tie=tie, params={k: np.asarray(v) for k, v in params.items()},
                loss=float(loss),
                grads={k: np.asarray(g) for k, g in grads.items()},
                losses=losses, rates=rates, final=final)


def test_step1_loss_and_every_gradient_match_jax(jax_run):
    model = _port_model(jax_run["params"], jax_run["tie"])
    ids, labels = (torch.from_numpy(a) for a in _batch())
    fa.reset_counts()
    loss = gpt_loss_fn(model(ids), labels)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_run["loss"], rtol=1e-5)
    grads = dict(model.named_parameters())
    assert set(grads) == set(jax_run["grads"])
    for name, ref in jax_run["grads"].items():
        err = np.abs(grads[name].grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)
    # one flash forward and backward per layer, plain on the CPU
    assert {n: c.plain_launches for n, c in fa.counts_for(False).items()} \
        == dict.fromkeys(fa.counts_for(False), SIZES["num_layers"])


def test_scheduled_adamw_steps_match_jax_trainstep(jax_run):
    model = _port_model(jax_run["params"], jax_run["tie"])
    sched = _schedule(lr)
    opt = AdamW(learning_rate=sched, weight_decay=WD,
                parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(CLIP))
    step = TrainStep(model, gpt_loss_fn, opt)
    ids, labels = _batch()
    losses, rates = [], []
    for _ in range(STEPS):
        rates.append(opt.get_lr())
        losses.append(step(ids, labels).item())
        sched.step()
    assert rates == jax_run["rates"]
    assert len(set(rates)) == STEPS
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]
    moved = 0.0
    for name, p in model.named_parameters():
        ref = jax_run["final"][name]
        err = np.abs(p.detach().numpy() - ref).max()
        assert err <= 1e-2 * sum(rates), (name, err)
        moved = max(moved, np.abs(ref - jax_run["params"][name]).max())
    assert moved > 1e-3


# ------------------------------------------------------------------- O1

def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "") if dtype is not None else "None"


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
    """(op, floating input dtypes, output dtypes) of every tracked JAX
    dispatch, inputs before the AMP cast."""
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


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_o1_every_op_takes_and_gives_the_jax_dtypes(tie, monkeypatch):
    jm = _jax_model(tie)
    model = _port_model(_numpy_params(jm), tie)
    ids, labels = _batch()
    ref, ours = [], []
    with _jax_trace(ref):
        with jamp.auto_cast(level="O1"):
            out = jm(paddle.to_tensor(ids))
        ref_loss = jax_gpt_loss_fn(out, paddle.to_tensor(labels))
    _port_trace(ours, monkeypatch)
    with amp.auto_cast(level="O1"):
        out = model(torch.from_numpy(ids))
    loss = gpt_loss_fn(out, torch.from_numpy(labels))
    assert len(ref) > 10
    assert ours == ref
    assert _dt(loss.dtype) == _dt(ref_loss._value.dtype)


def test_o1_step_matches_jax():
    calls = []
    with _jax_flash_in_interpret_mode(calls):
        jm = _jax_model()
        func = functionalize(jm)
        params = func.param_values()
        loss, grads = jax.value_and_grad(
            lambda p: _jax_step_loss(func, p, "O1"))(params)
    assert calls and set(calls) == {"bfloat16"}
    model = _port_model({k: np.asarray(v) for k, v in params.items()})
    ids, labels = (torch.from_numpy(a) for a in _batch())
    counts = fa.counts_for(False, torch.bfloat16)
    fa.reset_counts()
    with amp.auto_cast(level="O1"):
        out = model(ids)
    ours = gpt_loss_fn(out, labels)
    ours.backward()
    assert _dt(ours.dtype) == _dt(loss.dtype)
    np.testing.assert_allclose(ours.float().item(),
                               float(loss.astype(jnp.float32)),
                               rtol=LOSS_RTOL)
    for name, p in model.named_parameters():
        ref = np.asarray(grads[name])
        assert p.grad.dtype == torch.float32, name
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (name, err)
    assert {n: c.plain_launches for n, c in counts.items()} == \
        dict.fromkeys(counts, SIZES["num_layers"])


def test_scheduled_o2_steps_match_jax():
    """3 TrainSteps at O2 (after amp.decorate: bf16 parameters, fp32
    masters in AdamW) under the schedule, against the JAX O2 TrainStep:
    the losses at bf16 tolerance, each parameter its master's cast."""
    calls = []
    with _jax_flash_in_interpret_mode(calls):
        jm = _jax_model()
        params = _numpy_params(jm)
        jamp.decorate(jm, level="O2")
        sched = _schedule(jlr)
        opt = JaxAdamW(learning_rate=sched, weight_decay=WD,
                       parameters=jm.parameters(), grad_clip=JaxClip(CLIP))
        step = JaxTrainStep(jm, jax_gpt_loss_fn, opt, amp_level="O2",
                            amp_dtype="bfloat16")
        batch = [paddle.to_tensor(a) for a in _batch()]
        ref = []
        for _ in range(STEPS):
            ref.append(float(step(*batch)._value.astype(jnp.float32)))
            sched.step()
    assert calls and set(calls) == {"bfloat16"}
    model = _port_model(params)
    amp.decorate(model, level="O2")
    sched = _schedule(lr)
    opt = AdamW(learning_rate=sched, weight_decay=WD,
                parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(CLIP))
    step = TrainStep(model, gpt_loss_fn, opt, amp_level="O2")
    losses = []
    for _ in range(STEPS):
        losses.append(step(*_batch()).float().item())
        sched.step()
    np.testing.assert_allclose(losses, ref, rtol=LOSS_RTOL)
    for p in model.parameters():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, opt.state[p]["master"].to(torch.bfloat16))


# ------------------------------------------------------------ the knobs

@pytest.mark.parametrize("knob,value,item", [
    ("tensor_parallel", True, "item 13"),
    ("sequence_parallel", True, "item 13"),
    ("moe_every", 1, "item 13"),
])
def test_unported_gpt_knobs_raise_naming_their_items(knob, value, item):
    GPT(GPTConfig(**SIZES), device="cpu")      # the defaults build
    with pytest.raises(NotImplementedError, match=item):
        GPT(GPTConfig(**{**SIZES, knob: value}), device="cpu")


def test_pipeline_step_raises_naming_item_13():
    with pytest.raises(NotImplementedError, match="item 13"):
        build_pipeline_train_step(GPTConfig(**SIZES), mesh=object())


def test_config_fields_and_gpt3_widths_follow_jax():
    import dataclasses
    assert [f.name for f in dataclasses.fields(GPTConfig)] == \
        [f.name for f in dataclasses.fields(JaxGPTConfig)]
    assert GPTConfig(hidden_size=96).ffn_hidden == \
        JaxGPTConfig(hidden_size=96).ffn_hidden == 384
    c = GPT3_1_3B
    assert (c.vocab_size, c.hidden_size, c.num_layers, c.num_heads,
            c.ffn_hidden, c.max_seq_len, c.dropout, c.tie_embeddings) == \
        (50304, 2048, 24, 16, 8192, 1024, 0.0, True)
    # about 1.31 B parameters
    h, f, v, n = c.hidden_size, c.ffn_hidden, c.vocab_size, c.num_layers
    per_block = 4 * h + 3 * h * h + 3 * h + h * h + h + h * f + f + f * h + h
    total = v * h + c.max_seq_len * h + n * per_block + 2 * h
    assert 1.30e9 < total < 1.32e9
