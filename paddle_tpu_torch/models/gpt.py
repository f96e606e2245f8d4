"""GPT-style decoder-only transformer (pre-LN, learned positions, GELU).

Counterpart of paddle_tpu/models/gpt.py on one device. Parameters carry
the JAX package's flat names (``wte.weight``, ``wpe.weight``,
``blocks.{i}.ln1.*``, ``blocks.{i}.attn.qkv.*``, ``blocks.{i}.attn.out.*``,
``blocks.{i}.ln2.*``, ``blocks.{i}.mlp.fc1.*``, ``blocks.{i}.mlp.fc2.*``,
``ln_f.*`` and ``lm_head.weight`` when the head is untied) and its
``[in, out]`` linear layout, so ``functionalize(jax_gpt).param_values()``
loads here unchanged (``weights.load_params``). The fused QKV weight is
``[H, 3H]`` with its columns in ``(3, n_heads, head_dim)`` order.

Each block is x = x + attn(ln1(x)), x = x + mlp(ln2(x)); attention goes
through ``ops.impl.scaled_dot_product_attention(is_causal=True)``, hence
the flash kernels (K3) on the card; the MLP is fc2(gelu_tanh(fc1(x))).
The tied head is ``impl.matmul(x, wte.weight, transpose_y=True)``.

Weights are seeded random values on an explicit ``device`` (default
``"cuda"``) with the JAX initializers: N(0, 0.02) for the embeddings, qkv
and fc1; N(0, 0.02 / sqrt(2 * num_layers)) for attn.out and fc2;
Xavier-normal for an untied head; zero biases, unit LayerNorm gains (the
numbers differ from jax.random's). Dropout draws from the model's own
``torch.Generator``. Tensor parallelism, sequence parallelism, MoE blocks
and the pipeline step are not ported: they raise naming their ROADMAP
items.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.models.ernie import (
    Dropout, Embedding, LayerNorm, Linear, _seeded,
)
from paddle_tpu_torch.ops import impl

TP_ITEM = ("ROADMAP.md 'Still to port' item 10 (tensor-parallel "
           "serving)")
DIST_ITEM = "ROADMAP.md 'Still to port' item 13 (distributed training)"


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: Optional[int] = None
    max_seq_len: int = 1024
    dropout: float = 0.0
    dtype: str = "float32"             # unused, as in the JAX model
    tensor_parallel: bool = False
    sequence_parallel: bool = False
    moe_every: int = 0                 # every k-th block MoE (0 = off)
    moe_experts: int = 8
    tie_embeddings: bool = True

    def __post_init__(self):
        if self.ffn_hidden is None:
            self.ffn_hidden = 4 * self.hidden_size


# GPT-3 XL (Brown et al. 2020, Table 2.1: 24 layers, d_model 2048, 2048
# context) at 16 heads of 128, as Megatron-LM and PaddleFleetX's
# pretrain_gpt_1.3B config run it (the table's 24 heads do not divide
# 2048 into heads of 128), with the JAX package's 1024 positions and the
# 50304-row vocabulary (GPT-2's 50257 padded to a multiple of 128);
# about 1.31 B parameters
GPT3_1_3B = GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                      num_heads=16, ffn_hidden=8192, max_seq_len=1024,
                      dropout=0.0, tie_embeddings=True)


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device, gen):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        w_out = 0.02 / math.sqrt(2 * cfg.num_layers)
        self.qkv = Linear(h, 3 * h, device, std=0.02)
        self.out = Linear(h, h, device, std=w_out)
        self.drop = Dropout(cfg.dropout, gen)

    def forward(self, x):
        b, s, h = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        out = impl.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.drop(self.out(out.reshape(b, s, h)))


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device, gen):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_hidden
        w_out = 0.02 / math.sqrt(2 * cfg.num_layers)
        self.fc1 = Linear(h, f, device, std=0.02)
        self.fc2 = Linear(f, h, device, std=w_out)
        self.drop = Dropout(cfg.dropout, gen)

    def forward(self, x):
        return self.drop(self.fc2(impl.gelu(self.fc1(x), approximate=True)))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device, gen, use_moe: bool = False):
        super().__init__()
        if use_moe:
            raise NotImplementedError(
                f"GPTConfig(moe_every={cfg.moe_every}): switch-MoE blocks "
                f"are not ported yet: {DIST_ITEM}")
        self.ln1 = LayerNorm(cfg.hidden_size, device)
        self.attn = GPTAttention(cfg, device, gen)
        self.ln2 = LayerNorm(cfg.hidden_size, device)
        self.mlp = GPTMLP(cfg, device, gen)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class GPT(nn.Module):
    """The weights and dense forward of a GPT decoder, built on
    ``device`` from ``seed`` (see the module docstring)."""

    def __init__(self, cfg: GPTConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.tensor_parallel:
            raise NotImplementedError(
                f"GPTConfig(tensor_parallel=True) is not ported yet: "
                f"{TP_ITEM}")
        if cfg.sequence_parallel:
            raise NotImplementedError(
                f"GPTConfig(sequence_parallel=True) is not ported yet: "
                f"{DIST_ITEM}")
        dev = resolve_device(device)
        gen = _seeded(seed, dev)
        self.cfg = cfg
        h = cfg.hidden_size
        self.wte = Embedding(cfg.vocab_size, h, dev)
        self.wpe = Embedding(cfg.max_seq_len, h, dev)
        self.drop = Dropout(cfg.dropout, gen)
        self.blocks = nn.ModuleList([
            GPTBlock(cfg, dev, gen, use_moe=cfg.moe_every > 0
                     and (i + 1) % cfg.moe_every == 0)
            for i in range(cfg.num_layers)])
        self.ln_f = LayerNorm(h, dev)
        if not cfg.tie_embeddings:
            self.lm_head = llama.Linear(
                h, cfg.vocab_size, math.sqrt(2.0 / (h + cfg.vocab_size)),
                dev)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, Embedding):
                    mod.weight.normal_(0.0, 0.02, generator=gen)
                elif isinstance(mod, (Linear, llama.Linear)):
                    mod.weight.normal_(0.0, mod.std, generator=gen)

    def forward(self, input_ids):
        """input_ids [b, s] -> logits [b, s, vocab]."""
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_f(x)
        if self.cfg.tie_embeddings:
            return impl.matmul(x, self.wte.weight, transpose_y=True)
        return self.lm_head(x)

    def loss(self, logits, labels):
        """Next-token cross entropy (labels already shifted)."""
        return gpt_loss_fn(logits, labels)


def gpt_loss_fn(logits, labels):
    """Mean next-token cross-entropy over the flattened batch."""
    v = logits.shape[-1]
    return impl.cross_entropy(logits.reshape(-1, v), labels.reshape(-1))


def build_pipeline_train_step(cfg: GPTConfig, mesh, num_micro: int = 4,
                              lr: float = 1e-3, schedule: str = "gpipe",
                              v=None):
    """The JAX package's compiled pipeline-parallel step: not ported."""
    raise NotImplementedError(
        f"build_pipeline_train_step (pipeline parallelism) is not ported "
        f"yet: {DIST_ITEM}")
