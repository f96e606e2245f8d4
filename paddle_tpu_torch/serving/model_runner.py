"""Model runners: paged-KV step functions for the serving engine.

Counterpart of paddle_tpu/serving/model_runner.py for fp32 Llama on one
device, over fp32, int8 or fp8 KV pools (``kv_dtype``). A runner adapts
a model's flat parameter dict into the step functions the engine calls
over the shared page pool:

  prefill(tokens, table_row, pools)                 -> (logits[V], pools)
  prefill_chunk(tokens, start_pos, table_row, pools) -> (logits[V], pools)
  decode(tokens[B], tables[B, P], pos[B], pools)     -> (logits[B, V], pools)

Every step writes this step's K/V through the block table, then attends
through one of three paths chosen per span bucket by `_attn_impl_for`:
the ragged paged-attention kernel (prefill chunks, GQA decode), the
single-token paged-decode kernel (MHA decode), or the gather + dense-mask
reference. "auto" resolves exactly as `best_paged_impl` says on every
device, except that int8 and fp8 pools never go to the paged-decode
kernel (it has no dequantize step): their MHA decode takes the ragged
kernel, as in the JAX package. On CUDA tensors the wrappers launch the
CUDA kernels, on CPU tensors they run their plain versions. A shape no
kernel tiles takes the gather path on the CPU and raises on CUDA unless
the caller asked for attn_impl="reference". Chunk lengths are padded to
power-of-2 buckets (`bucket_len`); padded positions write to the scratch
page and their logits are never read. Dead decode slots carry
all-scratch tables, so they self-neutralize without a mask.

Where the port departs from the JAX package:
  * in-place pools: JAX writes the pools functionally (`.at[].set`) and
    the runner returns new pools; here `paged_attend` writes them in
    place with `index_put_` and the steps still return `(logits, pools)`
    (the same list), so the call signatures stay the same. A retried
    step rewrites the same slots with the same values (an int8 write
    re-derives the same scales and codes), so retries stay idempotent;
  * dispatch: the JAX package's shape-keyed jit cache becomes plain
    method calls (PyTorch runs eagerly; CUDA graphs are later work).

The instrumented-pool counters (`attn_kv_bytes_read` /
`attn_kv_bytes_gather`) account the pool bytes each dispatch touches vs
what the gather path would read, host-side from the call's operands.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models.generation import (
    masked_cache_attention, paged_gather,
)
from paddle_tpu_torch.models.llama import Llama, rope_tables
from paddle_tpu_torch.ops.paged_attention import (
    best_paged_impl, paged_decode_attention,
)
from paddle_tpu_torch.ops.ragged_paged_attention import (
    attention_page_reads, dequantize_pages, ragged_attention_ok,
    ragged_paged_attention,
)
from paddle_tpu_torch.serving.kv_cache import (
    SCRATCH_PAGE, check_kv_dtype, fp8_page_write, quantized_page_write,
)

logger = logging.getLogger(__name__)


def bucket_len(t: int, minimum: int = 8) -> int:
    """Power-of-2 length bucket shared by every prefill path."""
    b = minimum
    while b < t:
        b *= 2
    return b


def paged_attend(q, k_new, v_new, layer_pools, tables, write_page,
                 write_off, pos_q, q_len, n_rep: int, impl: str):
    """Write this step's K/V through the block table, then attend.

    q: [B, T, n_h, d]; k_new/v_new: [B, T, n_kv, d]; layer_pools: one
    layer's pool tuple, written IN PLACE: fp32 or float8_e4m3fn (k_pool,
    v_pool) (fp8 appends are a pure cast, `fp8_page_write`), or int8
    (k_codes, v_codes, k_scale, v_scale) (`quantized_page_write`
    quantizes at append time; the attend paths dequantize with the
    per-page-per-head scales); tables: [B, P] int32; write_page/
    write_off: [B, T] int64; pos_q: [B] int32 context position of q row
    0; q_len: [B] int32 live rows per span. impl is the resolved
    attention path ("reference" | "paged_decode" | "ragged"). Returns
    ([B, T, n_h*d], layer_pools)."""
    k_pool, v_pool = layer_pools[:2]
    scales = (None, None)
    if len(layer_pools) == 4:
        scales = layer_pools[2:]
        quantized_page_write(k_pool, scales[0], write_page, write_off, k_new)
        quantized_page_write(v_pool, scales[1], write_page, write_off, v_new)
    elif k_pool.dtype == torch.float8_e4m3fn:
        fp8_page_write(k_pool, write_page, write_off, k_new)
        fp8_page_write(v_pool, write_page, write_off, v_new)
    else:
        k_pool[write_page, write_off] = k_new
        v_pool[write_page, write_off] = v_new
    B, T = q.shape[0], q.shape[1]
    if impl == "paged_decode":
        if k_pool.dtype != torch.float32:
            raise ValueError("paged_decode has no int8/fp8-pool path: "
                             "_attn_impl_for routes quantized pools to the "
                             "ragged kernel or the gather reference")
        out = paged_decode_attention(q[:, 0], k_pool, v_pool, tables, pos_q)
        return out.reshape(B, 1, -1), layer_pools
    if impl == "ragged":
        out = ragged_paged_attention(q, k_pool, v_pool, tables, pos_q, q_len,
                                     k_scale=scales[0], v_scale=scales[1])
        return out.reshape(B, T, -1), layer_pools
    if k_pool.dtype == torch.float32:
        kg = paged_gather(k_pool, tables)
        vg = paged_gather(v_pool, tables)
    else:   # dequantize the gathered pages with their page/head scales
        idx = tables.long()
        kg = dequantize_pages(k_pool, idx, scales[0]).flatten(1, 2)
        vg = dequantize_pages(v_pool, idx, scales[1]).flatten(1, 2)
    if n_rep > 1:  # GQA: repeat kv groups up to the query heads
        kg = kg.repeat_interleave(n_rep, dim=2)
        vg = vg.repeat_interleave(n_rep, dim=2)
    return masked_cache_attention(q, kg, vg, pos_q), layer_pools


def check_weight_dtype(weight_dtype: str) -> None:
    """Only fp32 weights are ported: the weight ladder raises."""
    if weight_dtype != "fp32":
        raise NotImplementedError(
            f"weight_dtype={weight_dtype!r}: only fp32 weights are ported; "
            "the weight ladder (int8, int4, fp8) is ROADMAP.md 'Still to "
            "port' item 8 (quantized serving)")


def check_weight_group_size(weight_group_size: int) -> None:
    """The JAX runners' default of 128 rows per weight scale is accepted;
    another value only matters to the weight ladder, which raises."""
    if weight_group_size != 128:
        raise NotImplementedError(
            f"weight_group_size={weight_group_size!r}: grouped weight "
            "scales belong to the weight ladder (int4, int8, fp8), "
            "ROADMAP.md 'Still to port' item 8 (quantized serving)")


class PagedModelRunner:
    """Shared runner chassis: write-index math, dispatch, byte counters.

    Subclasses set the architecture fields in __init__ and implement
    `_forward(tokens, positions, write_page, write_off, tables, pos_q,
    q_lens, pools) -> (logits[B, T, V], pools)`.
    """

    num_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int

    ATTN_IMPLS = ("auto", "pallas", "ragged", "reference")

    def __init__(self, params: Dict[str, torch.Tensor], block_size: int,
                 max_model_len: int, attn_impl: str = "auto",
                 kv_dtype: str = "fp32", weight_dtype: str = "fp32",
                 weight_group_size: int = 128):
        if attn_impl not in self.ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}; expected one of "
                             f"{self.ATTN_IMPLS}")
        check_kv_dtype(kv_dtype, type(self).__name__)
        check_weight_dtype(weight_dtype)
        check_weight_group_size(weight_group_size)
        self.weight_group_size = weight_group_size
        self.params = params
        self.block_size = block_size
        self.max_model_len = max_model_len
        self.attn_impl = attn_impl
        # the engine builds its pools with the runner's kv_dtype
        self.kv_dtype = kv_dtype
        self.device = next(iter(params.values())).device
        self.dtype = torch.float32
        self._impl_logged: set = set()
        # instrumented-pool counters: device bytes of KV pool the chosen
        # attention path touches vs what the gather path would have read
        self.attn_kv_bytes_read = 0.0
        self.attn_kv_bytes_gather = 0.0

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads

    # --------------------------------------------------------- dispatch

    def _attn_impl_for(self, q_len_bucket: int) -> str:
        """Resolve the attention path for one (padded) query-span length.
        "auto" and "pallas" take the kernel `best_paged_impl` names;
        "ragged" forces the ragged kernel; "reference" forces the gather
        path. Where no kernel tiles the shape, a CPU runner takes the
        gather path as the JAX package does, and a CUDA runner raises: on
        the card only an explicit "reference" runs the plain path. The
        chosen impl is logged once per bucket so a serve's dispatch is
        auditable."""
        if self.attn_impl == "reference":
            impl = "reference"
        elif self.attn_impl == "ragged":
            impl = ("ragged" if ragged_attention_ok(
                self.head_dim, self.n_heads, self.n_kv_heads) else None)
        else:
            impl = best_paged_impl(self.head_dim, self.n_heads,
                                   self.n_kv_heads, q_len_bucket)
        if self.kv_dtype in ("int8", "fp8") and impl == "paged_decode":
            # the paged-decode kernel has no dequantize step: int8 and fp8
            # pools take the ragged kernel, which dequantizes in its walk
            impl = ("ragged" if ragged_attention_ok(
                self.head_dim, self.n_heads, self.n_kv_heads) else None)
        if impl is None:
            if self.device.type == "cuda":
                raise ValueError(
                    f"attn_impl={self.attn_impl!r}: no CUDA attention kernel "
                    f"tiles head_dim {self.head_dim} with {self.n_heads} "
                    f"query / {self.n_kv_heads} kv heads (q_len bucket "
                    f"{q_len_bucket}); pass attn_impl='reference' to serve "
                    "this model through the plain gather path")
            impl = "reference"
        key = (q_len_bucket, impl)
        if key not in self._impl_logged:
            self._impl_logged.add(key)
            logger.info(
                "serving attention impl: %s (q_len bucket %d, heads %d/%d, "
                "head_dim %d, attn_impl=%s, device %s)", impl, q_len_bucket,
                self.n_heads, self.n_kv_heads, self.head_dim, self.attn_impl,
                self.device)
        return impl

    def _kv_page_bytes(self) -> int:
        """Device bytes ONE page costs this runner's attention per call:
        int8 pools count the code bytes PLUS the per-page-per-head scale
        bytes the dequantize reads, fp8 pools one byte per element."""
        data = self.block_size * self.n_kv_heads * self.head_dim
        if self.kv_dtype == "int8":
            return 2 * self.num_layers * (data + self.n_kv_heads * 4)
        if self.kv_dtype == "fp8":
            return 2 * self.num_layers * data
        return 2 * self.num_layers * data * self.dtype.itemsize

    def _account_attn(self, impl: str, starts, q_lens, table_width: int):
        """Bump the instrumented-pool counters for one step call: the
        kernels read only each span's live pages; the gather path reads
        every table entry of every slot."""
        per_page = self._kv_page_bytes()
        gather_pages = len(np.asarray(starts).reshape(-1)) * table_width
        if impl in ("paged_decode", "ragged"):
            pages = int(attention_page_reads(starts, q_lens,
                                             self.block_size).sum())
        else:
            pages = gather_pages
        self.attn_kv_bytes_read += pages * per_page
        self.attn_kv_bytes_gather += gather_pages * per_page

    def reset_attn_counters(self) -> None:
        self.attn_kv_bytes_read = 0.0
        self.attn_kv_bytes_gather = 0.0

    # ------------------------------------------------------------- steps

    def _stage(self, *host_arrays):
        """Copy host operands to the runner's device, one copy each."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in host_arrays)

    def _write_indices(self, positions, tables, valid):
        """positions/valid: [B, T]; tables: [B, P] -> page/off [B, T]
        int64. Invalid positions are redirected to the scratch page."""
        page = torch.gather(tables.long(), 1, positions // self.block_size)
        page = torch.where(valid, page, torch.full_like(page, SCRATCH_PAGE))
        return page, positions % self.block_size

    @torch.no_grad()
    def prefill(self, tokens: List[int], table_row: List[int], pools):
        """Run one sequence's (re-)prefill; returns (last_logits[V], pools)."""
        return self.prefill_chunk(tokens, 0, table_row, pools)

    @torch.no_grad()
    def prefill_chunk(self, tokens: List[int], start_pos: int,
                      table_row: List[int], pools):
        """Compute context positions [start_pos, start_pos + len(tokens))
        for one sequence, attending over everything the block table
        already holds. Returns the logits of the chunk's LAST position
        plus the (updated in place) pools."""
        t = len(tokens)
        tb = bucket_len(t)
        padded = np.zeros((1, tb), np.int64)
        padded[0, :t] = tokens
        self._account_attn(self._attn_impl_for(tb), np.asarray([start_pos]),
                           np.asarray([t]), len(table_row))
        toks, table, span = self._stage(
            padded, np.asarray(table_row, np.int32)[None],
            np.asarray([start_pos, t], np.int32))
        offs = torch.arange(tb, device=self.device)[None, :]      # [1, T]
        valid = offs < t
        positions = torch.where(valid, start_pos + offs,
                                torch.zeros_like(offs))
        page, off = self._write_indices(positions, table, valid)
        logits, pools = self._forward(toks, positions, page, off, table,
                                      span[:1], span[1:], pools)
        return logits[0, t - 1], pools

    @torch.no_grad()
    def decode(self, tokens, tables, pos, pools):
        """Batched decode step; tokens [B], tables [B, P], pos [B]."""
        pos_np = np.asarray(pos, np.int32)
        B = pos_np.shape[0]
        self._account_attn(self._attn_impl_for(1), pos_np,
                           np.ones_like(pos_np), np.asarray(tables).shape[1])
        toks, tabs, pos_t, ones = self._stage(
            np.asarray(tokens, np.int64)[:, None],
            np.asarray(tables, np.int32), pos_np, np.ones((B,), np.int32))
        positions = pos_t.long()[:, None]                          # [B, 1]
        page, off = self._write_indices(
            positions, tabs, torch.ones_like(positions, dtype=torch.bool))
        logits, pools = self._forward(toks, positions, page, off, tabs,
                                      pos_t, ones, pools)
        return logits[:, 0], pools

    def _forward(self, tokens, positions, write_page, write_off, tables,
                 pos_q, q_lens, pools):
        raise NotImplementedError


class LlamaRunner(PagedModelRunner):
    """Paged-step adapter for models.Llama (RMSNorm + RoPE + GQA +
    SwiGLU). The runner serves the model's own parameters (moved to
    ``device`` when they live elsewhere). The model's `x @ w` products are
    plain torch.matmul in full fp32. The positional parameters are the JAX
    runner's; ``device`` is keyword-only after them."""

    def __init__(self, model: Llama, block_size: int = 16,
                 max_model_len: int | None = None, attn_impl: str = "auto",
                 kv_dtype: str = "fp32", weight_dtype: str = "fp32",
                 weight_group_size: int = 128, *, device=None):
        cfg = model.cfg
        dev = resolve_device(device) if device is not None else None
        params = {k: (v.detach().to(dev) if dev is not None else v.detach())
                  for k, v in model.named_parameters()}
        super().__init__(params, block_size,
                         max_model_len or cfg.max_seq_len, attn_impl,
                         kv_dtype, weight_dtype, weight_group_size)
        self.cfg = cfg
        self.num_layers = cfg.num_layers
        self.n_heads = cfg.num_heads
        self.n_kv_heads = cfg.num_kv_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.vocab_size = cfg.vocab_size
        self._rope_cos, self._rope_sin = rope_tables(
            self.max_model_len, self.head_dim, cfg.rope_theta,
            device=self.device)                              # [L, d] fp32

    def _rope(self, x, cos, sin):
        # rotate-half convention of ops.rotary_embedding
        x1, x2 = x.chunk(2, dim=-1)
        rot = torch.cat([-x2, x1], dim=-1)
        return x * cos[:, :, None, :] + rot * sin[:, :, None, :]

    def _rms(self, x, w):
        var = x.pow(2).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.cfg.rms_eps) * w

    def _forward(self, tokens, positions, write_page, write_off, tables,
                 pos_q, q_lens, pools):
        cfg, p = self.cfg, self.params
        B, T = tokens.shape
        d = self.head_dim
        impl = self._attn_impl_for(T)
        x = F.embedding(tokens, p["embed_tokens.weight"])
        cos = self._rope_cos[positions]                      # [B, T, d]
        sin = self._rope_sin[positions]
        for i in range(cfg.num_layers):
            pre = f"layers.{i}."
            h = self._rms(x, p[pre + "input_layernorm.weight"])
            q = (h @ p[pre + "self_attn.q_proj.weight"]
                 ).reshape(B, T, self.n_heads, d)
            k = (h @ p[pre + "self_attn.k_proj.weight"]
                 ).reshape(B, T, self.n_kv_heads, d)
            v = (h @ p[pre + "self_attn.v_proj.weight"]
                 ).reshape(B, T, self.n_kv_heads, d)
            q = self._rope(q, cos, sin)
            k = self._rope(k, cos, sin)
            out, _ = paged_attend(q, k, v, pools[i], tables, write_page,
                                  write_off, pos_q, q_lens, self.n_rep, impl)
            x = x + out @ p[pre + "self_attn.o_proj.weight"]
            h = self._rms(x, p[pre + "post_attention_layernorm.weight"])
            gate = h @ p[pre + "mlp.gate_proj.weight"]
            up = h @ p[pre + "mlp.up_proj.weight"]
            x = x + (F.silu(gate) * up) @ p[pre + "mlp.down_proj.weight"]
        x = self._rms(x, p["norm.weight"])
        if cfg.tie_embeddings:
            return x @ p["embed_tokens.weight"].T, pools
        return x @ p["lm_head.weight"], pools


def runner_for(model, block_size: int = 16, max_model_len: int | None = None,
               attn_impl: str = "auto", kv_dtype: str = "fp32",
               weight_dtype: str = "fp32", weight_group_size: int = 128, *,
               device=None) -> PagedModelRunner:
    """Pick the runner for a supported model (Llama only so far)."""
    if isinstance(model, Llama):
        return LlamaRunner(model, block_size, max_model_len, attn_impl,
                           kv_dtype, weight_dtype, weight_group_size,
                           device=device)
    raise TypeError(
        f"no serving runner for {type(model).__name__}: the port serves "
        "paddle_tpu_torch.models.Llama; the GPT runner is ROADMAP.md "
        "'Still to port' item 3")
