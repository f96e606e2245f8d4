"""The port's ERNIE pretraining path against the JAX package's, on the CPU.

A tiny ERNIE (vocab 128, hidden 64, 2 layers, 4 heads, seq 128, dropout
0) is built in JAX, and its attention runs through the Pallas flash
kernels in interpret mode (the dispatch gate is opened and the kernel
call spied into interpret mode, as tests/test_torch_training.py does):
the padded batch's [b, 1, 1, s] mask reaches them as the per-key bias.
The port's ERNIE takes the same weights through `load_params`, and its
masked kernels run their plain versions here (CPU tensors). Then:

  * the parameter names are the JAX ones and the decoder is tied
    (registered once, under the word embedding);
  * sequence, pooled, MLM and SOP outputs at 1e-4 with a padded mask;
  * the step-1 loss at rtol 1e-5 and every gradient within 1e-4 * max|g|;
  * 4 AdamW steps of TrainStep(n_inputs=3), decay kept off the biases and
    LayerNorms by name, against the JAX TrainStep at rtol 1e-4;
  * padding invariance, the fine-tune heads, dropout, mask_tokens, and
    what the port refuses.
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
from paddle_tpu.models import ernie as jax_ernie
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.utils.flags import set_flags as jax_set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    ErnieConfig, ErnieForPretraining, ErnieForSequenceClassification,
    ErnieForTokenClassification, ErnieModel, ernie_pretrain_loss_fn,
    mask_tokens,
)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import load_params, params_to_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# the model is tiny: intra-op threads only contend with the other workers
torch.set_num_threads(1)

SIZES = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             max_position=128, dropout=0.0)
B, SEQ = 2, 128
LR, WD, STEPS = 3e-3, 0.01, 4


def _decay(name):
    """AdamW's decay only on matrices: not on biases or LayerNorm gains."""
    return not (name.endswith("bias") or "layer_norm" in name
                or ".ln" in name)


def _batch(seed=0):
    """child_ernie's batch at a small size: masked ids, padded rows, -100
    labels on pads, random token types and SOP labels."""
    rng = np.random.default_rng(seed)
    base = rng.integers(5, SIZES["vocab_size"], (B, SEQ))
    ids, labels = mask_tokens(base, SIZES["vocab_size"], rng)
    att = np.ones((B, SEQ), np.int64)
    att[1, 100:] = 0
    labels = np.where(att > 0, labels, -100)
    types = rng.integers(0, 2, (B, SEQ))
    sop = rng.integers(0, 2, (B,))
    return ids, types, att, labels, sop


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side: initial params, eager outputs, step-1 loss and grads
    and the TrainStep's losses, all through the Pallas kernels."""
    calls = []
    orig = jfa.flash_attention

    def spy(q, k, v, **kw):
        calls.append(kw.get("mask") is not None)
        kw["interpret"] = True
        return orig(q, k, v, **kw)

    ids, types, att, labels, sop = _batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_impl, "_flash_enabled", lambda: True)
        mp.setattr(jfa, "flash_attention", spy)
        jax_set_flags({"FLAGS_use_flash_attention": True})
        paddle.seed(21)
        model = jax_ernie.ErnieForPretraining(jax_ernie.ErnieConfig(**SIZES))
        func = functionalize(model)
        params = func.param_values()
        inputs = [paddle.to_tensor(a) for a in (ids, types, att)]
        scores, rel = model(*inputs)
        seq, pooled = model.ernie(inputs[0], token_type_ids=inputs[1],
                                  attention_mask=inputs[2])
        outputs = {n: np.asarray(t._value) for n, t in (
            ("sequence", seq), ("pooled", pooled), ("mlm", scores),
            ("sop", rel))}

        def loss_of(p):
            out, _ = func.apply(p, func.buffer_values(), None, True,
                                *(jnp.asarray(a) for a in (ids, types, att)))
            with no_grad():
                loss = jax_ernie.ernie_pretrain_loss_fn(
                    tuple(Tensor._wrap(o) for o in out),
                    Tensor._wrap(jnp.asarray(labels)),
                    Tensor._wrap(jnp.asarray(sop)))
            return loss._value

        loss, grads = jax.value_and_grad(loss_of)(params)
        opt = JaxAdamW(learning_rate=LR, weight_decay=WD,
                       parameters=model.parameters(),
                       apply_decay_param_fun=_decay)
        step = JaxTrainStep(model, jax_ernie.ernie_pretrain_loss_fn, opt,
                            n_inputs=3)
        batch = [paddle.to_tensor(a) for a in (ids, types, att, labels, sop)]
        losses = [float(step(*batch)) for _ in range(STEPS)]
    jax_set_flags({"FLAGS_use_flash_attention": True})
    assert calls and all(calls), "the JAX attention missed the masked kernel"
    return dict(params={k: np.asarray(v) for k, v in params.items()},
                outputs=outputs, loss=float(loss),
                grads={k: np.asarray(g) for k, g in grads.items()},
                losses=losses)


def _port_model(run):
    model = ErnieForPretraining(ErnieConfig(**SIZES), device="cpu")
    load_params(model, run["params"])
    return model


def _inputs():
    return [torch.from_numpy(a) for a in _batch()]


def test_parameter_names_match_jax_and_the_decoder_is_tied(jax_run):
    model = ErnieForPretraining(ErnieConfig(**SIZES), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(jax_run["params"])
    assert len(names) == len(set(names))
    assert [n for n in names if "word_embeddings" in n] == \
        ["ernie.embeddings.word_embeddings.weight"]
    for name, p in model.named_parameters():
        assert tuple(p.shape) == jax_run["params"][name].shape, name


def test_forward_outputs_match_jax(jax_run):
    model = _port_model(jax_run)
    ids, types, att, _, _ = _inputs()
    fa.reset_counts()
    with torch.no_grad():
        scores, rel = model(ids, types, att)
        seq, pooled = model.ernie(ids, token_type_ids=types,
                                  attention_mask=att)
    ours = {"sequence": seq, "pooled": pooled, "mlm": scores, "sop": rel}
    for name, ref in jax_run["outputs"].items():
        np.testing.assert_allclose(ours[name].numpy(), ref, rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # every layer's attention took the masked kernels' plain version
    assert fa.counts_for(True)["flash_forward"].plain_launches == \
        2 * SIZES["num_layers"]


def test_step1_loss_and_every_gradient_match_jax(jax_run):
    model = _port_model(jax_run)
    ids, types, att, labels, sop = _inputs()
    fa.reset_counts()
    loss = ernie_pretrain_loss_fn(model(ids, types, att), labels, sop)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_run["loss"], rtol=1e-5)
    grads = dict(model.named_parameters())
    assert set(grads) == set(jax_run["grads"])
    for name, ref in jax_run["grads"].items():
        err = np.abs(grads[name].grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)
    n = SIZES["num_layers"]
    assert {k: c.plain_launches for k, c in fa.counts_for(True).items()} == \
        dict.fromkeys(fa.counts_for(True), n)
    assert all(c.plain_launches == c.kernel_launches == 0
               for c in fa.counts_for(False).values())


def test_adamw_losses_match_jax_trainstep(jax_run):
    model = _port_model(jax_run)
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.named_parameters(),
                apply_decay_param_fun=_decay)
    step = TrainStep(model, ernie_pretrain_loss_fn, opt, n_inputs=3)
    batch = _batch()
    losses = [step(*batch).item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]
    assert set(params_to_numpy(model)) == set(jax_run["params"])
    # the decay skipped exactly the biases and the LayerNorms
    decayed = {n for n in jax_run["params"] if opt._decay_for(
        dict(model.named_parameters())[n])}
    assert decayed == {n for n in jax_run["params"] if _decay(n)}
    assert "cls.decoder_bias" not in decayed


def test_padding_invariance():
    """Outputs at real positions do not depend on the pad tokens' ids
    (the JAX package's tests/test_ernie.py property)."""
    model = ErnieModel(ErnieConfig(**SIZES), device="cpu", seed=1).eval()
    rng = np.random.default_rng(1)
    real = rng.integers(5, 128, (1, 8))
    mask = torch.from_numpy(np.concatenate([np.ones((1, 8)),
                                            np.zeros((1, 4))], axis=1))
    outs = []
    for _ in range(2):
        ids = np.concatenate([real, rng.integers(5, 128, (1, 4))], axis=1)
        with torch.no_grad():
            outs.append(model(torch.from_numpy(ids), attention_mask=mask))
    np.testing.assert_allclose(outs[0][0][:, :8].numpy(),
                               outs[1][0][:, :8].numpy(), atol=2e-5)
    np.testing.assert_allclose(outs[0][1].numpy(), outs[1][1].numpy(),
                               atol=2e-5)


def test_finetune_heads_shapes():
    cfg = ErnieConfig(**SIZES)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128,
                                                             (2, 12)))
    seq_cls = ErnieForSequenceClassification(cfg, num_classes=3,
                                             device="cpu")
    assert tuple(seq_cls(ids).shape) == (2, 3)
    tok_cls = ErnieForTokenClassification(cfg, num_classes=5, device="cpu")
    assert tuple(tok_cls(ids).shape) == (2, 12, 5)
    ref = jax_ernie.ErnieForSequenceClassification(
        jax_ernie.ErnieConfig(**SIZES), num_classes=3)
    assert set(dict(seq_cls.named_parameters())) == \
        set(functionalize(ref).param_values())


def test_dropout_keeps_and_upscales_in_train_and_is_identity_in_eval():
    cfg = ErnieConfig(**{**SIZES, "dropout": 0.5})
    model = ErnieModel(cfg, device="cpu", seed=2)
    ids = torch.from_numpy(np.random.default_rng(2).integers(5, 128,
                                                             (2, 64)))
    emb = model.embeddings
    with torch.no_grad():
        x = emb.layer_norm(emb.word_embeddings(ids))
        y = emb.dropout(x)
        kept = y != 0
        assert abs(kept.float().mean().item() - 0.5) < 0.05
        torch.testing.assert_close(y[kept], 2 * x[kept], rtol=1e-6,
                                   atol=1e-6)
        train = [model(ids)[0] for _ in range(2)]
        assert not torch.equal(*train)
        model.eval()
        assert torch.equal(emb.dropout(x), x)
        torch.testing.assert_close(model(ids)[0], model(ids)[0], rtol=0,
                                   atol=0)


def test_mask_tokens_draws_as_jax():
    base = np.random.default_rng(0).integers(0, 1000, (32, 64))
    ours = mask_tokens(base, 1000, np.random.default_rng(3))
    ref = jax_ernie.mask_tokens(base, 1000, np.random.default_rng(3))
    for a, r in zip(ours, ref):
        np.testing.assert_array_equal(a, r)
    assert 0.10 < (ours[1] != -100).mean() < 0.20


@pytest.mark.parametrize("knob", ["tensor_parallel", "sequence_parallel"])
def test_parallel_configs_raise_naming_roadmap(knob):
    cfg = ErnieConfig(**SIZES, **{knob: True})
    for cls in (ErnieModel, ErnieForPretraining):
        with pytest.raises(NotImplementedError, match="ROADMAP.md.*13"):
            cls(cfg, device="cpu")
