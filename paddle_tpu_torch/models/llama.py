"""LLaMA-family decoder (RMSNorm + RoPE + GQA + SwiGLU).

Counterpart of paddle_tpu/models/llama.py. The serving runner reads the
model's parameters as one flat dict, so this module keeps exactly the
JAX package's parameter names (``embed_tokens.weight``,
``layers.{i}.self_attn.q_proj.weight``, ..., ``norm.weight``,
``lm_head.weight``) and its ``[in, out]`` linear layout: a weight dict
exported from the JAX model loads here unchanged (``weights.py``).

``Llama.forward`` is the dense forward of the JAX Layer, the training
path: embedding, pre-norm blocks (RMSNorm with fp32 statistics, q/k/v
projections, rotate-half RoPE at positions 0..s-1, GQA by
repeat_interleave of the kv heads, causal scaled_dot_product_attention
through the flash kernels, o_proj, SwiGLU MLP), the final norm and the
head (or the tied embedding). Serving goes through
``serving.model_runner.LlamaRunner`` over the paged pools instead.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.ops import impl


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None     # GQA; None = MHA
    ffn_hidden: Optional[int] = None       # None = LLaMA 2/3 * 4h rule
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    dropout: float = 0.0
    tensor_parallel: bool = False
    tie_embeddings: bool = False           # LLaMA keeps a separate head

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads={self.num_heads} is not a multiple "
                             f"of num_kv_heads={self.num_kv_heads}")
        if self.ffn_hidden is None:
            # LLaMA rule: 2/3 * 4h rounded to a multiple of 256
            f = int(2 * 4 * self.hidden_size / 3)
            self.ffn_hidden = 256 * ((f + 255) // 256)


# Meta's published LLaMA-2-7B widths (MHA: 32 query heads, 32 kv heads)
LLAMA2_7B = LlamaConfig(vocab_size=32000, hidden_size=4096, num_layers=32,
                        num_heads=32, num_kv_heads=32, ffn_hidden=11008,
                        max_seq_len=4096, rope_theta=1e4, rms_eps=1e-5)


def rope_tables(seq: int, dim: int, theta: float, device="cuda"):
    """[seq, dim] fp32 cos/sin on ``device`` with the rotate-half
    convention (the frequencies repeated over both halves), as the JAX
    package builds them."""
    device = resolve_device(device)
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    t = torch.arange(seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)                       # [seq, dim/2]
    emb = torch.cat([freqs, freqs], dim=-1)           # [seq, dim]
    return torch.cos(emb), torch.sin(emb)


class Linear(nn.Module):
    """Weight of a bias-free linear in the JAX package's [in, out] layout
    (the runner computes ``x @ weight``); ``std`` is its init scale."""

    def __init__(self, n_in: int, n_out: int, std: float, device):
        super().__init__()
        self.std = std
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device))

    def forward(self, x):
        return impl.linear(x, self.weight)


class RMSNorm(nn.Module):
    """RMSNorm with its gain initialised to ones: the JAX signature
    ``(hidden, eps=1e-6)``, ``device`` keyword-only after it."""

    def __init__(self, hidden: int, eps: float = 1e-6, *, device="cuda"):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden, device=device))

    def forward(self, x):
        return impl.rms_norm(x, self.weight, epsilon=self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        self.n_h, self.n_kv = cfg.num_heads, cfg.num_kv_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        h = cfg.hidden_size
        kv_out = cfg.num_kv_heads * (h // cfg.num_heads)
        wo = 0.02 / math.sqrt(2 * cfg.num_layers)
        self.q_proj = Linear(h, h, 0.02, device)
        self.k_proj = Linear(h, kv_out, 0.02, device)
        self.v_proj = Linear(h, kv_out, 0.02, device)
        self.o_proj = Linear(h, h, wo, device)

    def forward(self, x):
        b, s, h = x.shape
        d = self.head_dim
        q = self.q_proj(x).reshape(b, s, self.n_h, d)
        k = self.k_proj(x).reshape(b, s, self.n_kv, d)
        v = self.v_proj(x).reshape(b, s, self.n_kv, d)
        cos, sin = rope_tables(s, d, self.cfg.rope_theta, device=x.device)
        q, k = impl.rotary_embedding(q, k, cos, sin)
        if self.n_kv != self.n_h:
            # GQA: kv head j serves query heads j*rep .. j*rep + rep - 1
            rep = self.n_h // self.n_kv
            k = impl.repeat_interleave(k, rep, axis=2)
            v = impl.repeat_interleave(v, rep, axis=2)
        out = impl.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(b, s, h))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_hidden
        wo = 0.02 / math.sqrt(2 * cfg.num_layers)
        self.gate_proj = Linear(h, f, 0.02, device)
        self.up_proj = Linear(h, f, 0.02, device)
        self.down_proj = Linear(f, h, wo, device)

    def forward(self, x):
        return self.down_proj(impl.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps,
                                       device=device)
        self.self_attn = LlamaAttention(cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_eps, device=device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x):
        x = impl.add(x, self.self_attn(self.input_layernorm(x)))
        return impl.add(x, self.mlp(self.post_attention_layernorm(x)))


class Llama(nn.Module):
    """The weights of a Llama decoder, built on ``device`` with seeded
    random values: N(0, 0.02) for the embedding, the q/k/v/gate/up
    projections and the head; N(0, 0.02 / sqrt(2 * num_layers)) for
    o_proj and down_proj; ones for the norms (the JAX package's
    initializers; the numbers themselves differ from jax.random's)."""

    def __init__(self, cfg: LlamaConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.tensor_parallel:
            raise NotImplementedError(
                "tensor_parallel Llama (mp_layers) is not ported yet: "
                "ROADMAP.md 'Still to port' item 13 (distributed "
                "training); a serving runner shards through "
                "PagedModelRunner.shard(mesh)")
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed_tokens = nn.Module()
        self.embed_tokens.weight = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, device=dev))
        self.layers = nn.ModuleList([LlamaBlock(cfg, dev)
                                     for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device=dev)
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, 0.02, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            self.embed_tokens.weight.normal_(0.0, 0.02, generator=gen)
            for mod in self.modules():
                if isinstance(mod, Linear):
                    mod.weight.normal_(0.0, mod.std, generator=gen)

    def forward(self, input_ids):
        """input_ids [b, s] -> logits [b, s, vocab]."""
        x = impl.embedding(input_ids, self.embed_tokens.weight)
        for blk in self.layers:
            x = blk(x)
        x = self.norm(x)
        if self.cfg.tie_embeddings:
            return impl.matmul(x, self.embed_tokens.weight, transpose_y=True)
        return self.lm_head(x)


def llama_loss_fn(logits, labels):
    """Mean next-token cross-entropy over the flattened batch."""
    v = logits.shape[-1]
    return impl.cross_entropy(logits.reshape(-1, v), labels.reshape(-1))
