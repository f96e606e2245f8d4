"""A torch twin of the JAX package's StubPagedRunner (tests/_helpers.py),
importable without jax: replica child processes of the process-tier tests
build it through their factory spec."""

import numpy as np
import torch

VOCAB, BLOCK, MAXLEN = 31, 4, 40


class TorchStubRunner:
    """The JAX package's StubPagedRunner over the port's torch pools: each
    step writes its tokens through the block table (layer 0, head 0, dim
    0) IN PLACE, and the next-token logits are one-hot at a hash of the
    whole history gathered back from the pool, so a wrong page, a stale
    table or a page-in of the wrong bytes changes the tokens. ``pools``
    is the pool's shards, as the port's runners take it."""

    num_layers = 1
    n_heads = 1
    n_kv_heads = 1
    head_dim = 1
    dtype = torch.float32
    kv_dtype = "fp32"
    weight_dtype = "fp32"
    weight_group_size = 128
    device = torch.device("cpu")
    attn_kv_bytes_read = 0
    attn_kv_bytes_gather = 0

    def __init__(self, vocab_size=VOCAB, block_size=BLOCK,
                 max_model_len=MAXLEN):
        self.vocab_size = vocab_size
        self.block_size = block_size
        self.max_model_len = max_model_len

    def weight_bytes_reduction_x(self) -> float:
        return 1.0

    def _logits(self, history):
        h = 7
        for i, t in enumerate(history):
            h = (h * 131 + (i + 1) * (int(t) + 1)) % self.vocab_size
        row = torch.zeros(self.vocab_size)
        row[h] = 1.0
        return row

    def _history(self, k, table, n):
        return [float(k[int(table[i // self.block_size]),
                        i % self.block_size, 0, 0]) for i in range(n)]

    def prefill(self, tokens, table, pools):
        return self.prefill_chunk(tokens, 0, table, pools)

    def prefill_chunk(self, tokens, start_pos, table, pools):
        k = pools[0][0][0]
        for i, t in enumerate(tokens):
            p = start_pos + i
            k[int(table[p // self.block_size]), p % self.block_size,
              0, 0] = float(t)
        end = start_pos + len(tokens)
        return self._logits(self._history(k, table, end)), pools

    def decode(self, tokens, tables, pos, pools):
        k = pools[0][0][0]
        tokens, tables, pos = (np.asarray(a) for a in (tokens, tables, pos))
        out = torch.zeros(tokens.shape[0], self.vocab_size)
        for b in range(tokens.shape[0]):
            p = int(pos[b])
            k[int(tables[b, p // self.block_size]), p % self.block_size,
              0, 0] = float(tokens[b])
            out[b] = self._logits(self._history(k, tables[b], p + 1))
        return out, pools

