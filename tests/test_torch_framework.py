"""The slice as a whole on the CPU: a LLaMA decoder layer and an ERNIE
encoder layer written with `_C_ops` on Tensors (tests/_framework_layers)
run in the JAX package and in the port on the same numpy weights and
inputs; outputs and every weight's gradient (of the same random-weighted
sum of the output) agree within 1e-4 of the largest magnitude. The
port's layers also equal its models' blocks (`LlamaBlock`, `ErnieBlock`)
on the same weights, the check the chip smoke makes at full width."""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import place
from paddle_tpu_torch.models.ernie import ErnieBlock, ErnieConfig
from paddle_tpu_torch.models.llama import LlamaBlock, LlamaConfig, \
    rope_tables

from _framework_layers import ernie_layer, llama_layer

torch.set_num_threads(1)

LLAMA = LlamaConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=4, ffn_hidden=64, rms_eps=1e-5)
ERNIE = ErnieConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=4, ffn_hidden=64, max_position=64,
                    dropout=0.0)
B, S = 2, 16


@pytest.fixture(autouse=True)
def _cpu():
    saved = place._expected_place
    tp.set_device("cpu")
    yield
    place._expected_place = saved


def _weights(module, seed):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(tuple(p.shape)) * 0.2
                + (1.0 if n.endswith("norm.weight") or n.startswith("ln")
                   and n.endswith("weight") else 0.0)).astype(np.float32)
            for n, p in module.named_parameters()}


def _run(api, layer, weights, x, extra):
    p = {n: api.to_tensor(w, stop_gradient=False)
         for n, w in weights.items()}
    out = layer(api, api.to_tensor(x), p, *extra(api))
    w = np.random.default_rng(9).standard_normal(out.shape).astype(
        np.float32)
    (out * api.to_tensor(w)).sum().backward()
    return out.numpy(), {n: t.grad.numpy() for n, t in p.items()}


def _close(a, b, tol=1e-4):
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


def _llama_case():
    block = LlamaBlock(LLAMA, torch.device("cpu"))
    weights = _weights(block, 1)
    x = np.random.default_rng(2).standard_normal((B, S, 32)).astype(
        np.float32)
    cos, sin = (t.numpy() for t in rope_tables(S, 8, LLAMA.rope_theta,
                                               device="cpu"))

    def extra(api):
        return (api.to_tensor(cos), api.to_tensor(sin), LLAMA.num_heads,
                LLAMA.rms_eps)

    return block, weights, x, extra, (llama_layer,)


def _ernie_case():
    block = ErnieBlock(ERNIE, torch.device("cpu"), None)
    weights = _weights(block, 3)
    x = np.random.default_rng(4).standard_normal((B, S, 32)).astype(
        np.float32)
    att = np.ones((B, S), np.float32)
    att[1, 11:] = 0
    mask = ((1.0 - att[:, None, None, :]) * -1e4).astype(np.float32)

    def extra(api):
        return api.to_tensor(mask), ERNIE.num_heads, block.ln1.epsilon

    return block, weights, x, extra, (ernie_layer,)


CASES = {"llama": _llama_case, "ernie": _ernie_case}


@pytest.mark.parametrize("which", list(CASES))
def test_layer_matches_the_jax_layer(which):
    _, weights, x, extra, (layer,) = CASES[which]()
    out, grads = _run(tp, layer, weights, x, extra)
    ref, ref_grads = _run(jp, layer, weights, x, extra)
    _close(out, ref)
    assert grads.keys() == ref_grads.keys()
    for n in grads:
        _close(grads[n], ref_grads[n])


@pytest.mark.parametrize("which", list(CASES))
def test_layer_matches_the_ports_block(which):
    block, weights, x, extra, (layer,) = CASES[which]()
    out, grads = _run(tp, layer, weights, x, extra)
    with torch.no_grad():
        for n, p in block.named_parameters():
            p.copy_(torch.from_numpy(weights[n]))
    xt = torch.from_numpy(x)
    ref = block(xt) if which == "llama" else block(
        xt, attn_mask=extra(tp)[0]._value)
    w = np.random.default_rng(9).standard_normal(out.shape).astype(
        np.float32)
    (ref * torch.from_numpy(w)).sum().backward()
    _close(out, ref.detach().numpy(), 1e-5)
    for n, p in block.named_parameters():
        _close(grads[n], p.grad.numpy(), 1e-5)
