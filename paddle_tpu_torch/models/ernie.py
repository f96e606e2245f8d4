"""ERNIE/BERT-style bidirectional encoder family.

Counterpart of paddle_tpu/models/ernie.py: ERNIE-3.0-base pretraining
(masked LM + sentence-order prediction with the decoder tied to the word
embedding) and the two fine-tune heads. Parameters carry the JAX
package's flat names (``ernie.embeddings.word_embeddings.weight``,
``ernie.encoder.{i}.attn.qkv.weight``, ..., ``cls.decoder_bias``) and its
``[in, out]`` linear layout, so ``functionalize(jax_model).param_values()``
loads here unchanged (``weights.load_params``).

The encoder is post-LN: embeddings (word + position + token type) -> LN
-> dropout; each block x = ln1(x + attn(x)), x = ln2(x + fc2(gelu_tanh(
fc1(x)))); a tanh pooler over the first token. Attention is one fused
QKV projection, bidirectional, through
``ops.impl.scaled_dot_product_attention`` with the additive mask
``(1 - attention_mask) * -1e4`` of shape [b, 1, 1, s], which the flash
kernels take as a per-key bias (the K3-m kernels on the card). The mask
stays fp32 under AMP, as in the JAX model (a plain array there, which the
registry's cast does not touch).

Modules are built on an explicit ``device`` (default ``"cuda"``) with
seeded random weights: N(0, 0.02) for the embeddings and the encoder's
linears, Xavier-normal for the pooler and the heads, zero biases, unit
LayerNorm gains (the JAX package's initializers; the numbers differ from
jax.random's). Dropout draws from the model's own ``torch.Generator``,
seeded with the weights; its stream differs from the JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.ops import impl

_PARALLEL_ITEM = ("ROADMAP.md 'Still to port' item 13 (distributed "
                  "training)")


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: Optional[int] = None
    max_position: int = 2048
    type_vocab_size: int = 4
    dropout: float = 0.1
    pad_token_id: int = 0
    tensor_parallel: bool = False
    sequence_parallel: bool = False

    def __post_init__(self):
        if self.ffn_hidden is None:
            self.ffn_hidden = 4 * self.hidden_size


# ERNIE 3.0 base as the JAX package's bench runs it (bench.py::child_ernie,
# rung ernie:12:768:16:512:40000:30): max_position is the sequence length
# and dropout is off
ERNIE3_BASE = ErnieConfig(vocab_size=40000, hidden_size=768, num_layers=12,
                          num_heads=12, ffn_hidden=3072, max_position=512,
                          type_vocab_size=4, dropout=0.0)


class Linear(nn.Module):
    """x @ weight + bias with weight in the [in, out] layout; ``std`` is
    the weight's init scale (None: Xavier-normal, the JAX default)."""

    def __init__(self, n_in: int, n_out: int, device, std=None):
        super().__init__()
        self.std = std if std is not None else math.sqrt(2.0 / (n_in + n_out))
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x):
        return impl.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim, device=device))

    def forward(self, ids):
        return impl.embedding(ids, self.weight)


class LayerNorm(nn.Module):
    def __init__(self, hidden: int, device, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden, device=device))
        self.bias = nn.Parameter(torch.zeros(hidden, device=device))

    def forward(self, x):
        return impl.layer_norm(x, self.weight, self.bias, self.epsilon)


class Dropout(nn.Module):
    """Dropout drawing from a generator shared across the model."""

    def __init__(self, p: float, generator: torch.Generator):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return impl.dropout(x, self.generator, p=self.p,
                            training=self.training)


class ErnieEmbeddings(nn.Module):
    """word + position + token-type embeddings -> LN -> dropout."""

    def __init__(self, cfg: ErnieConfig, device, gen):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = Embedding(cfg.vocab_size, h, device)
        self.position_embeddings = Embedding(cfg.max_position, h, device)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, h,
                                               device)
        self.layer_norm = LayerNorm(h, device)
        self.dropout = Dropout(cfg.dropout, gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)
        x = self.word_embeddings(input_ids)
        x = impl.add(x, self.position_embeddings(position_ids))
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = impl.add(x, self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class ErnieAttention(nn.Module):
    """Bidirectional self-attention; fused QKV; optional additive mask."""

    def __init__(self, cfg: ErnieConfig, device, gen):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        self.qkv = Linear(h, 3 * h, device, std=0.02)
        self.out = Linear(h, h, device, std=0.02)
        self.drop = Dropout(cfg.dropout, gen)

    def forward(self, x, attn_mask=None):
        b, s, h = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        # the JAX model passes its mask as a plain array, which AMP does
        # not cast: the kernels see it in fp32 at every level
        out = impl.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                cast_mask=False)
        return self.drop(self.out(out.reshape(b, s, h)))


class ErnieBlock(nn.Module):
    """Post-LN encoder block (BERT/ERNIE convention)."""

    def __init__(self, cfg: ErnieConfig, device, gen):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_hidden
        self.attn = ErnieAttention(cfg, device, gen)
        self.ln1 = LayerNorm(h, device)
        self.fc1 = Linear(h, f, device, std=0.02)
        self.fc2 = Linear(f, h, device, std=0.02)
        self.ln2 = LayerNorm(h, device)
        self.drop = Dropout(cfg.dropout, gen)

    def forward(self, x, attn_mask=None):
        x = self.ln1(impl.add(x, self.attn(x, attn_mask=attn_mask)))
        return self.ln2(impl.add(x, self.drop(self.fc2(
            impl.gelu(self.fc1(x), approximate=True)))))


def _seeded(seed: int, device) -> torch.Generator:
    """The generator a model draws its weights and then its dropout from."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _init_weights(module: nn.Module, gen: torch.Generator) -> None:
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, Embedding):
                mod.weight.normal_(0.0, 0.02, generator=gen)
            elif isinstance(mod, Linear):
                mod.weight.normal_(0.0, mod.std, generator=gen)


def _refuse_parallel(cfg: ErnieConfig) -> None:
    if cfg.tensor_parallel or cfg.sequence_parallel:
        raise NotImplementedError(
            f"tensor_parallel / sequence_parallel ERNIE is not ported yet: "
            f"{_PARALLEL_ITEM}")


class ErnieModel(nn.Module):
    """Returns (sequence_output [b, s, h], pooled_output [b, h])."""

    def __init__(self, cfg: ErnieConfig, *, device="cuda", seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _refuse_parallel(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        own = generator is None
        gen = _seeded(seed, dev) if own else generator
        self.embeddings = ErnieEmbeddings(cfg, dev, gen)
        self.encoder = nn.ModuleList([ErnieBlock(cfg, dev, gen)
                                      for _ in range(cfg.num_layers)])
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, dev)
        if own:
            _init_weights(self, gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        """attention_mask: [b, s] with 1 = attend, 0 = padding; it becomes
        the additive [b, 1, 1, s] mask (1 - m) * -1e4."""
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        mask = None
        if attention_mask is not None:
            m = torch.as_tensor(attention_mask, device=x.device)
            mask = (1.0 - m[:, None, None, :].float()) * -1e4
        for blk in self.encoder:
            x = blk(x, attn_mask=mask)
        pooled = impl.tanh(self.pooler(impl.getitem(x, (slice(None), 0))))
        return x, pooled


class ErniePretrainingHeads(nn.Module):
    """MLM transform + decoder tied to the word embedding (passed at
    forward time, so it is registered once, under the embedding), and the
    sentence-order head."""

    def __init__(self, cfg: ErnieConfig, device):
        super().__init__()
        h = cfg.hidden_size
        self.transform = Linear(h, h, device)
        self.layer_norm = LayerNorm(h, device)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                     device=device))
        self.seq_relationship = Linear(h, 2, device)

    def forward(self, sequence_output, pooled_output, decoder_weight):
        x = self.layer_norm(impl.gelu(self.transform(sequence_output),
                                      approximate=True))
        scores = impl.add(impl.matmul(x, decoder_weight, transpose_y=True),
                          self.decoder_bias)
        return scores, self.seq_relationship(pooled_output)


class ErnieForPretraining(nn.Module):
    """MLM + sentence-order pretraining (the ERNIE-3.0-base recipe)."""

    def __init__(self, cfg: ErnieConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        _refuse_parallel(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        gen = _seeded(seed, dev)
        self.ernie = ErnieModel(cfg, device=dev, generator=gen)
        self.cls = ErniePretrainingHeads(cfg, dev)
        _init_weights(self, gen)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.ernie(input_ids, token_type_ids=token_type_ids,
                                 attention_mask=attention_mask)
        return self.cls(seq, pooled,
                        self.ernie.embeddings.word_embeddings.weight)


def ernie_pretrain_loss_fn(outputs, mlm_labels, sop_labels):
    """MLM cross-entropy (ignore_index=-100 on unmasked positions) plus the
    sentence-order cross-entropy: TrainStep's loss_fn(outputs, *labels)."""
    scores, rel = outputs
    v = scores.shape[-1]
    mlm = impl.cross_entropy(scores.reshape(-1, v), mlm_labels.reshape(-1),
                             ignore_index=-100)
    return mlm + impl.cross_entropy(rel, sop_labels)


class _ErnieClassifier(nn.Module):
    def __init__(self, cfg: ErnieConfig, num_classes, dropout, device, seed):
        super().__init__()
        _refuse_parallel(cfg)
        dev = resolve_device(device)
        gen = _seeded(seed, dev)
        self.ernie = ErnieModel(cfg, device=dev, generator=gen)
        self.dropout = Dropout(cfg.dropout if dropout is None else dropout,
                               gen)
        self.classifier = Linear(cfg.hidden_size, num_classes, dev)
        _init_weights(self, gen)


class ErnieForSequenceClassification(_ErnieClassifier):
    """logits [b, num_classes] from the pooled output."""

    def __init__(self, cfg: ErnieConfig, num_classes: int = 2,
                 dropout: Optional[float] = None, *, device="cuda",
                 seed: int = 0):
        super().__init__(cfg, num_classes, dropout, device, seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids=token_type_ids,
                               attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))


class ErnieForTokenClassification(_ErnieClassifier):
    """logits [b, s, num_classes] from the sequence output."""

    def __init__(self, cfg: ErnieConfig, num_classes: int = 2,
                 dropout: Optional[float] = None, *, device="cuda",
                 seed: int = 0):
        super().__init__(cfg, num_classes, dropout, device, seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, _ = self.ernie(input_ids, token_type_ids=token_type_ids,
                            attention_mask=attention_mask)
        return self.classifier(self.dropout(seq))


def mask_tokens(input_ids, vocab_size, rng, mask_token_id=3,
                mlm_prob=0.15, pad_token_id=0):
    """BERT/ERNIE masking on host numpy, the JAX package's draw for draw:
    of the non-pad tokens, ``mlm_prob`` are picked; 80 % of those become
    [MASK], 10 % a random id, 10 % stay. Returns (masked ids, labels with
    -100 where nothing was picked)."""
    ids = np.asarray(input_ids)
    labels = ids.copy()
    prob = rng.random(ids.shape)
    masked = (prob < mlm_prob) & (ids != pad_token_id)
    labels[~masked] = -100
    action = rng.random(ids.shape)
    ids = ids.copy()
    ids[masked & (action < 0.8)] = mask_token_id
    rand_ids = rng.integers(0, vocab_size, ids.shape)
    swap = masked & (action >= 0.8) & (action < 0.9)
    ids[swap] = rand_ids[swap]
    return ids, labels
