"""The port's Llama training path against the JAX package's, on the CPU.

A small Llama (vocab 256, hidden 64, 2 layers, 4 heads, seq 128; MHA and
GQA with 2 kv heads) is built in JAX, and the JAX TrainStep runs its
attention through the Pallas flash kernels in interpret mode (the
dispatch gate is opened and the kernel call spied into interpret mode,
as tests/test_flash_masked.py does). The port's Llama takes the same
weights through the state bridge, and its kernels run their plain
versions here (CPU tensors). Then:

  * the step-1 loss at rtol 1e-5, and every step-1 gradient against
    jax.grad over functionalize(model).apply within 1e-4 * max|g|;
  * the losses of 4 AdamW steps (global-norm clip on) at rtol 1e-4;
  * a JAX run stopped after 2 steps resumes in the port through
    load_params and optimizer_state_from_numpy: the next 2 losses agree;
  * the AdamW and Adam updates against the JAX `_update` on the same
    arrays at 1e-6, the clip against the JAX `functional`, the
    cross-entropy against the JAX one;
  * what the port refuses: fp16 AMP, an unknown amp_level, a mesh, the
    JAX package's LRScheduler object (the port's own train), integer
    params (bf16 ones train with a master copy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.impl as jax_impl
import paddle_tpu.ops.pallas.flash_attention as jfa
from paddle_tpu.autograd.engine import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import llama_loss_fn as jax_llama_loss_fn
from paddle_tpu.optimizer import Adam as JaxAdam
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer.lr import StepDecay
from paddle_tpu.utils.flags import set_flags as jax_set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import Llama, LlamaConfig, llama_loss_fn
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import impl
from paddle_tpu_torch.optimizer import Adam, AdamW, ClipGradByGlobalNorm
from paddle_tpu_torch.weights import (
    load_params, optimizer_state_from_numpy, optimizer_state_to_numpy,
    params_to_numpy,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the model is tiny: intra-op threads only contend with the other workers
torch.set_num_threads(1)

SIZES = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=128)
SEQ = 128
LR, WD, CLIP = 3e-3, 0.01, 1.0
STEPS, RESUME_AT = 4, 2


def _batch(seed):
    toks = np.random.default_rng(seed).integers(0, 256, (2, SEQ + 1))
    return toks[:, :-1], toks[:, 1:]


def _jax_step_loss(func, params, ids, labels):
    """The JAX TrainStep's loss of one batch as a function of the params."""
    out, _ = func.apply(params, func.buffer_values(), None, True,
                        jnp.asarray(ids))
    with no_grad():
        loss = jax_llama_loss_fn(Tensor._wrap(out),
                                 Tensor._wrap(jnp.asarray(labels)))
    return loss._value


@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def jax_run(request):
    """The JAX side of one configuration: initial params, step-1 loss and
    grads, the TrainStep's losses, and its state after RESUME_AT steps."""
    n_kv = request.param
    calls = []
    orig = jfa.flash_attention

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        kw["interpret"] = True
        return orig(q, k, v, **kw)

    # set_flags moves the eager op cache to a new key, so the traces below
    # see the opened gate, and the tests after them do not reuse them
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_impl, "_flash_enabled", lambda: True)
        mp.setattr(jfa, "flash_attention", spy)
        jax_set_flags({"FLAGS_use_flash_attention": True})
        paddle.seed(10 + n_kv)
        model = JaxLlama(JaxLlamaConfig(num_kv_heads=n_kv, **SIZES))
        func = functionalize(model)
        params = func.param_values()
        ids, labels = _batch(n_kv)
        loss, grads = jax.value_and_grad(_jax_step_loss, argnums=1)(
            func, params, ids, labels)
        opt = JaxAdamW(learning_rate=LR, weight_decay=WD,
                       parameters=model.parameters(),
                       grad_clip=JaxClip(CLIP))
        step = JaxTrainStep(model, jax_llama_loss_fn, opt)
        losses, resume = [], None
        for i in range(STEPS):
            if i == RESUME_AT:
                resume = (
                    {k: np.asarray(v) for k, v in step.params.items()},
                    {k: {m: np.asarray(a) for m, a in st.items()}
                     for k, st in step.opt_state.items()},
                    step._step_i)
            losses.append(float(step(paddle.to_tensor(ids),
                                     paddle.to_tensor(labels))))
    jax_set_flags({"FLAGS_use_flash_attention": True})
    assert calls, "the JAX model did not reach the flash kernel"
    return dict(n_kv=n_kv, batch=(ids, labels),
                params={k: np.asarray(v) for k, v in params.items()},
                loss=float(loss),
                grads={k: np.asarray(g) for k, g in grads.items()},
                losses=losses, resume=resume)


def _port_model(run, params=None):
    model = Llama(LlamaConfig(num_kv_heads=run["n_kv"], **SIZES),
                  device="cpu")
    load_params(model, params if params is not None else run["params"])
    return model


def _port_trainer(model):
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(CLIP))
    return TrainStep(model, llama_loss_fn, opt), opt


def test_step1_loss_and_every_gradient_match_jax(jax_run):
    model = _port_model(jax_run)
    ids, labels = (torch.from_numpy(a) for a in jax_run["batch"])
    fa.reset_counts()
    loss = llama_loss_fn(model(ids), labels)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_run["loss"], rtol=1e-5)
    grads = dict(model.named_parameters())
    assert set(grads) == set(jax_run["grads"])
    for name, ref in jax_run["grads"].items():
        got = grads[name].grad.numpy()
        err = np.abs(got - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)
    # one flash forward and one backward per layer, all plain on the CPU
    assert {n: c.plain_launches for n, c in fa.counts_for(False).items()} == \
        dict.fromkeys(fa.counts_for(False), SIZES["num_layers"])
    assert all(c.kernel_launches == 0 for c in fa.counts_for(False).values())


def test_adamw_losses_match_jax_trainstep(jax_run):
    model = _port_model(jax_run)
    step, opt = _port_trainer(model)
    ids, labels = jax_run["batch"]
    losses = []
    for _ in range(STEPS):
        loss = step(ids, labels)
        assert loss.dim() == 0 and loss.device == model.lm_head.weight.device
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]
    assert opt._step_i == STEPS
    assert step.sync() is model
    assert all(p.grad is None for p in model.parameters())


def test_jax_run_resumes_in_the_port(jax_run):
    params, opt_state, step_i = jax_run["resume"]
    model = _port_model(jax_run, params)
    step, opt = _port_trainer(model)
    optimizer_state_from_numpy(opt, model, opt_state, step_i)
    ids, labels = jax_run["batch"]
    losses = [step(ids, labels).item() for _ in range(STEPS - RESUME_AT)]
    np.testing.assert_allclose(losses, jax_run["losses"][RESUME_AT:],
                               rtol=1e-4)
    state, n = optimizer_state_to_numpy(opt, model)
    assert n == STEPS and set(state) == set(opt_state)
    assert set(params_to_numpy(model)) == set(params)


def _jax_update(opt, p, g, st, step):
    return opt._update(jnp.asarray(p), jnp.asarray(g),
                       {k: jnp.asarray(v) for k, v in st.items()},
                       jnp.asarray(LR, jnp.float32), opt._weight_decay,
                       jnp.asarray(step, jnp.int32))


@pytest.mark.parametrize("kind", ["adamw", "adam"])
def test_update_matches_jax_update_on_the_same_arrays(kind):
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((64, 48)).astype(np.float32)
    tp = torch.from_numpy(p0.copy())
    if kind == "adamw":
        ours, ref = AdamW(LR, parameters=[tp], weight_decay=0.1), \
            JaxAdamW(LR, parameters=None, weight_decay=0.1)
    else:
        ours, ref = Adam(LR, parameters=[tp], weight_decay=0.05), \
            JaxAdam(LR, parameters=None, weight_decay=0.05)
    p = p0
    st = {"moment1": np.zeros_like(p0), "moment2": np.zeros_like(p0)}
    for step in range(1, 6):
        g = (rng.standard_normal(p0.shape) * 10.0 ** -step).astype(
            np.float32)
        new_p, new_st = _jax_update(ref, p, g, st, step)
        ours._update([tp], [torch.from_numpy(g)], LR, ours._decay_for(tp),
                     step)
        p = np.asarray(new_p)
        st = {k: np.asarray(v) for k, v in new_st.items()}
        np.testing.assert_allclose(tp.numpy(), p, rtol=1e-6, atol=1e-6)
        for key in ("moment1", "moment2"):
            np.testing.assert_allclose(ours.state[tp][key].numpy(), st[key],
                                       rtol=1e-6, atol=1e-12)


def test_apply_decay_param_fun_gets_the_flat_names():
    """The JAX functional path passes flat names; so does the port, given
    model.named_parameters() (or the names TrainStep adopts)."""
    model = Llama(LlamaConfig(**SIZES), device="cpu", seed=1)
    seen = []

    def no_norms(name):
        seen.append(name)
        return "norm" not in name

    params = params_to_numpy(model)
    rng = np.random.default_rng(1)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    ref_opt = JaxAdamW(LR, parameters=None, weight_decay=0.5,
                       apply_decay_param_fun=no_norms)
    ref_p, _ = ref_opt.apply_gradients(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: ref_opt._init_state(jnp.asarray(v)) for k, v in params.items()},
        jnp.asarray(LR, jnp.float32), jnp.asarray(1, jnp.int32))
    jax_seen, seen[:] = sorted(seen), []
    opt = AdamW(LR, parameters=model.parameters(), weight_decay=0.5,
                apply_decay_param_fun=no_norms)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[name])
    with pytest.raises(ValueError, match="named_parameters"):
        opt.step()
    opt.adopt_names(model)
    opt._step_i = 0
    opt.state.clear()
    opt.step()
    assert sorted(seen[-len(params):]) == jax_seen
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref_p[name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("clip_norm", [1e-3, 1.0, 1e6])
def test_global_norm_clip_matches_jax_functional(clip_norm):
    rng = np.random.default_rng(2)
    grads = {f"g{i}": rng.standard_normal(s).astype(np.float32)
             for i, s in enumerate([(7, 5), (13,), (3, 4, 2)])}
    ref = JaxClip(clip_norm).functional(
        {k: jnp.asarray(v) for k, v in grads.items()})
    ours = [torch.from_numpy(v.copy()) for v in grads.values()]
    ClipGradByGlobalNorm(clip_norm).clip_(ours)
    for (name, r), t in zip(ref.items(), ours):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((12, 9)).astype(np.float32)
    labels = rng.integers(0, 9, 12)
    labels[[1, 5, 6]] = -100                   # ignored rows
    ours = impl.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels), reduction=reduction)
    ref = jax_impl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 reduction=reduction)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_layer_ops_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
    y = rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32)
    cos, sin = (rng.standard_normal((6, 8)).astype(np.float32)
                for _ in range(2))
    t = torch.from_numpy
    j = jnp.asarray
    pairs = [
        (impl.rms_norm(t(x), t(w), 1e-5), jax_impl.rms_norm(j(x), j(w), 1e-5)),
        (impl.swiglu(t(x), t(y)), jax_impl.swiglu(j(x), j(y))),
        (impl.swiglu(t(x)), jax_impl.swiglu(j(x))),
        (impl.repeat_interleave(t(x), 2, axis=2),
         jax_impl.repeat_interleave(j(x), 2, axis=2)),
        *zip(impl.rotary_embedding(t(x), t(y), t(cos), t(sin)),
             jax_impl.rotary_embedding(j(x), j(y), j(cos), j(sin))),
    ]
    ids = rng.integers(0, 6, (2, 5))
    table = rng.standard_normal((6, 4)).astype(np.float32)
    pairs.append((impl.embedding(t(ids), t(table), padding_idx=2),
                  jax_impl.embedding(j(ids), j(table), padding_idx=2)))
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


def test_unported_training_options_raise():
    model = Llama(LlamaConfig(**SIZES), device="cpu")
    opt = AdamW(parameters=model.parameters())
    # bf16 AMP trains (tests/test_torch_amp.py); fp16 waits for the flash
    # kernels' fp16 instantiation, and an unknown level is an error
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*21"):
        TrainStep(model, llama_loss_fn, opt, amp_level="O1",
                  amp_dtype="float16")
    with pytest.raises(ValueError, match="amp_level"):
        TrainStep(model, llama_loss_fn, opt, amp_level="O3")
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*13"):
        TrainStep(model, llama_loss_fn, opt, mesh=object())
    # the port's own schedulers train (tests/test_torch_lr.py); the JAX
    # package's scheduler object is not one of them
    with pytest.raises(TypeError, match="LRScheduler"):
        AdamW(learning_rate=StepDecay(0.1, step_size=2),
              parameters=model.parameters())
    # a bf16 parameter trains with an fp32 master copy; an integer one is
    # refused
    bf16 = torch.zeros(3, dtype=torch.bfloat16)
    assert AdamW(parameters=[bf16])._state(bf16)["master"].dtype == \
        torch.float32
    with pytest.raises(TypeError, match="floating"):
        AdamW(parameters=[torch.zeros(3, dtype=torch.int32)])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        impl.cross_entropy(torch.zeros(2, 3), torch.zeros(2, 3),
                           soft_label=True)
