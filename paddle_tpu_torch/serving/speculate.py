"""Draft proposal for speculative decoding.

Counterpart of paddle_tpu/serving/speculate.py. The engine's verify step
scores a request's fed token plus up to k draft tokens in one launch and
accepts the longest draft prefix the target model reproduces, so the
token stream never depends on WHAT is proposed, only on how many tokens
one step resolves. The proposers:

* ``NgramProposer``: prompt lookup. The trailing n-gram of the context is
  matched against its own history (longest n first, most recent
  occurrence) and the tokens that followed are proposed. With a request
  id it keeps an incremental suffix index per request (O(new tokens) a
  step); without one it scans, bounded by ``scan_window``.
  ``propose_chain`` builds the s * (k + 1) - 1 token continuation a fused
  speculative horizon slices per step.
* ``AdaptiveK``: a per-request EWMA of accepted / proposed that maps the
  acceptance rate to k in [0, k_max].
* ``DraftModelProposer``: a small runner (or a shadow of the target,
  ``shadow_runner``) over its own paged pool, proposing by a catch-up
  prefill and one greedy ``decode_multi`` chain (two host syncs a
  proposal).

``shadow_runner`` builds a shadow on any rung of the weight ladder
(``spec_draft_model="shadow"`` is int8, as in the JAX package).
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.serving.kv_cache import KVCachePool, require_fp8
from paddle_tpu_torch.serving.model_runner import WEIGHT_DTYPES

class NgramProposer:
    """Prompt-lookup draft proposer: match the context's trailing n-gram
    against its own history and propose the continuation.

    proposer = NgramProposer(max_ngram=3, min_ngram=1)
    draft = proposer.propose(context_tokens, max_k)   # [] when no match

    With a ``request_id`` the proposer keeps an incremental suffix index
    (n-gram -> latest start) that grows by the tokens appended since the
    last call. The index is advisory: a stale entry can only degrade
    proposals, never tokens, because verify re-derives every accepted
    token from the target model. Without a ``request_id`` the stateless
    scan runs, bounded by ``scan_window`` when set."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 scan_window: Optional[int] = None):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram({min_ngram}) <= max_ngram({max_ngram})")
        if scan_window is not None and scan_window < 1:
            raise ValueError(f"scan_window must be >= 1, got {scan_window}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.scan_window = scan_window
        # request_id -> {"len": indexed prefix length, "tail": the last
        # indexed tokens (divergence check), "maps": {n: {gram: j}}}
        self._index: Dict[str, dict] = {}

    # ------------------------------------------------ incremental index

    def _state(self, request_id: str) -> dict:
        st = self._index.get(request_id)
        if st is None:
            st = {"len": 0, "tail": [],
                  "maps": {n: {} for n in
                           range(self.min_ngram, self.max_ngram + 1)}}
            self._index[request_id] = st
        return st

    def _extend_index(self, st: dict, ctx: List[int]) -> None:
        """Index every n-gram start j with j + n <= len(ctx) - 1 (strictly
        before the final position, so the trailing suffix never matches
        itself); a later j overwrites an earlier one. A context that
        shrank or diverged from the indexed one (a rollback) rebuilds."""
        L = len(ctx)
        if L < st["len"] or st["tail"] != ctx[max(0, st["len"] - 8):
                                              st["len"]]:
            st["len"] = 0
            for m in st["maps"].values():
                m.clear()
        for n, grams in st["maps"].items():
            lo = max(0, st["len"] - n)      # starts not yet indexed
            for j in range(lo, L - n):
                grams[tuple(ctx[j:j + n])] = j
        st["len"] = L
        st["tail"] = ctx[max(0, L - 8):L]

    def release(self, request_id: str) -> None:
        """Drop a finished request's suffix index."""
        self._index.pop(request_id, None)

    # ---------------------------------------------------------- propose

    def propose(self, context: Sequence[int], max_k: int,
                request_id: Optional[str] = None) -> List[int]:
        """Up to ``max_k`` draft tokens continuing ``context``, or []."""
        if max_k <= 0:
            return []
        ctx = list(map(int, context))
        n_hi = min(self.max_ngram, len(ctx) - 1)
        if request_id is not None:
            st = self._state(request_id)
            self._extend_index(st, ctx)
            for n in range(n_hi, self.min_ngram - 1, -1):
                j = st["maps"][n].get(tuple(ctx[-n:]))
                if j is not None:
                    return ctx[j + n:j + n + max_k]
            return []
        lo_bound = (0 if self.scan_window is None
                    else max(0, len(ctx) - self.scan_window))
        for n in range(n_hi, self.min_ngram - 1, -1):
            suffix = ctx[-n:]
            # most recent earlier occurrence, ending before the suffix
            for j in range(len(ctx) - n - 1, lo_bound - 1, -1):
                if ctx[j:j + n] == suffix:
                    return ctx[j + n:j + n + max_k]
        return []

    def propose_chain(self, context: Sequence[int], length: int,
                      request_id: Optional[str] = None) -> List[int]:
        """An optimistic continuation of up to ``length`` tokens, sliced
        per step by a fused speculative horizon. One lookup ends at the
        context's edge, so the chain re-matches the suffix of context +
        drafts until it is long enough or the stream stops repeating; the
        extensions run the stateless scan, so the per-request index never
        learns drafted tokens."""
        if length <= 0:
            return []
        ctx = list(map(int, context))
        out = self.propose(ctx, length, request_id=request_id)
        while out and len(out) < length:
            more = self.propose(ctx + out, length - len(out))
            if not more:
                break
            out.extend(more)
        return out[:length]


class AdaptiveK:
    """Per-request acceptance-rate-adaptive draft length.

    k(req) = clamp(round(ewma_accept_rate * k_max), 0, k_max), the EWMA
    folding each verify outcome accepted / proposed in with weight
    ``alpha``. It starts at rate 1.0 (k_max); a run of rejections drives k
    to 0. Draft-only state: it shapes proposals, never tokens."""

    def __init__(self, k_max: int, alpha: float = 0.5):
        if k_max < 0:
            raise ValueError(f"k_max must be >= 0, got {k_max}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.k_max = k_max
        self.alpha = alpha
        self._ewma: Dict[str, float] = {}

    def k_for(self, request_id: str) -> int:
        rate = self._ewma.get(request_id, 1.0)
        return max(0, min(self.k_max, int(round(rate * self.k_max))))

    def update(self, request_id: str, proposed: int, accepted: int) -> None:
        """Fold one verify outcome in; nothing proposed says nothing."""
        if proposed <= 0:
            return
        rate = min(1.0, max(0.0, accepted / proposed))
        prev = self._ewma.get(request_id, 1.0)
        self._ewma[request_id] = (1.0 - self.alpha) * prev \
            + self.alpha * rate

    def release(self, request_id: str) -> None:
        self._ewma.pop(request_id, None)


def shadow_runner(target, weight_dtype: str = "int8"):
    """A weight-quantized shadow of ``target`` for the draft rung: the same
    weights and pool geometry, its own parameter dict, graph cache and
    capture log. On an fp32-weight target every 2-D non-embedding
    ``.weight`` goes down the weight ladder to ``weight_dtype`` ("int8",
    "int4" with the target's group size, "fp8"; "fp32" is the exact
    shadow, the upper bound of a draft's acceptance), the epilogue in
    `_mm`; embeddings and norms stay floating. The draft only proposes,
    so its quantization costs acceptance, never exactness.

    The JAX shadow picks the weights whose numpy dtype is a numpy floating
    type, which bf16 (ml_dtypes) is not and fp16 is: the shadow of a bf16
    target keeps its bf16 weights there, and so it does here, while an
    fp16 target's shadow goes down the ladder (the scales computed from
    the fp16 weights, as JAX's quantizers compute them)."""
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"unsupported shadow weight_dtype {weight_dtype!r}"
                         f"; expected one of {WEIGHT_DTYPES}")
    if weight_dtype == "fp8":
        require_fp8(f"shadow_runner(weight_dtype={weight_dtype!r})")
    r = copy.copy(target)
    r.params = dict(target.params)
    r._graph_cache = OrderedDict()
    r._impl_logged = set()
    r.captures = []
    r.reset_attn_counters()
    if weight_dtype != "fp32" and target.weight_dtype == "fp32":
        skip = ("embed", "wte", "wpe", "norm", "ln_")
        numpy_floats = (torch.float16, torch.float32, torch.float64)
        names = [name for name, v in r.params.items()
                 if name.endswith(".weight") and v.dim() == 2
                 and v.dtype in numpy_floats
                 and not any(k in name for k in skip)]
        r.weight_dtype = weight_dtype
        r._quantize_weights(names)
        if r.mesh is not None:     # the shards' views follow the new dict
            r.shard(r.mesh, data_axis=r.data_axis, model_axis=r.model_axis,
                    comm_dtype=r.comm_dtype)
    return r


class DraftModelProposer:
    """Model-based draft rung: a small runner (or a shadow of the target)
    with its OWN paged pool of the target's geometry, proposing greedy
    continuations.

    Per proposal: a catch-up ``prefill_chunk`` over the tokens appended
    since the last call (one host sync), then one greedy ``decode_multi``
    chain for the rest (one more); the chain's KV is rolled back at once,
    so the next catch-up starts from the request's real context. Pool
    pressure evicts the least recently proposed request's draft KV; when
    pages still do not fit, the proposal is [] (speculation off for that
    step)."""

    def __init__(self, runner, *, num_blocks: Optional[int] = None,
                 max_model_len: Optional[int] = None):
        self.runner = runner
        self.max_model_len = max_model_len or runner.max_model_len
        self.max_pages = -(-self.max_model_len // runner.block_size)
        self.pool = KVCachePool(
            runner.num_layers, (num_blocks or 4 * (self.max_pages + 1)),
            runner.block_size, runner.n_kv_heads, runner.head_dim,
            runner.dtype, mesh=getattr(runner, "mesh", None),
            model_axis=getattr(runner, "model_axis", "model"),
            kv_dtype=runner.kv_dtype, device=runner.device)
        # request_id -> {"tokens": covered by draft KV, "pages": [...]}
        self._seqs: Dict[str, dict] = {}
        self._lru: List[str] = []       # least recently proposed first

    # --------------------------------------------------- pool plumbing

    def _touch(self, request_id: str) -> None:
        if request_id in self._lru:
            self._lru.remove(request_id)
        self._lru.append(request_id)

    def release(self, request_id: str) -> None:
        st = self._seqs.pop(request_id, None)
        if st is not None and st["pages"]:
            self.pool.allocator.free(st["pages"])
        if request_id in self._lru:
            self._lru.remove(request_id)

    def _ensure_pages(self, st: dict, tokens: int, request_id: str) -> bool:
        """Grow st["pages"] to cover ``tokens``, evicting colder draft
        sequences under pressure. False when it still does not fit."""
        need = -(-tokens // self.runner.block_size) - len(st["pages"])
        if need <= 0:
            return True
        while not self.pool.allocator.can_alloc(need):
            victim = next((rid for rid in self._lru if rid != request_id),
                          None)
            if victim is None:
                return False
            self.release(victim)
        fresh = self.pool.allocator.alloc(need)
        self.pool.tag_pages(fresh, self.pool.native_kv_tag())
        st["pages"].extend(fresh)
        return True

    def _truncate(self, st: dict, num_tokens: int) -> None:
        """Roll draft KV coverage back to ``num_tokens``: free the whole
        pages past the boundary."""
        keep = -(-num_tokens // self.runner.block_size)
        if len(st["pages"]) > keep:
            self.pool.allocator.free(st["pages"][keep:])
            del st["pages"][keep:]
        del st["tokens"][num_tokens:]

    # ---------------------------------------------------------- propose

    def propose(self, context: Sequence[int], max_k: int,
                request_id: Optional[str] = None) -> List[int]:
        return self.propose_chain(context, max_k, request_id=request_id)

    def propose_chain(self, context: Sequence[int], length: int,
                      request_id: Optional[str] = None) -> List[int]:
        if length <= 0 or not context:
            return []
        rid = request_id or "_anon"
        ctx = list(map(int, context))
        length = min(length, self.max_model_len - len(ctx))
        if length <= 0:
            return []
        st = self._seqs.get(rid)
        if st is None:
            st = self._seqs[rid] = {"tokens": [], "pages": []}
        self._touch(rid)
        # catch up from the longest common prefix of draft KV and context,
        # leaving >= 1 token to compute: its logits start the chain
        common = 0
        for a, b in zip(st["tokens"], ctx):
            if a != b:
                break
            common += 1
        common = min(common, len(ctx) - 1)
        if common < len(st["tokens"]):
            self._truncate(st, common)
        if not self._ensure_pages(st, len(ctx) + length, rid):
            return []
        table = self.pool.pad_table(st["pages"], self.max_pages)
        covered = len(st["tokens"])
        try:
            try:
                logits, _ = self.runner.prefill_chunk(
                    ctx[covered:], covered, table, self.pool.shards)
                st["tokens"] = list(ctx)
                chain = [int(torch.argmax(logits))]
                if length > 1:
                    packed, _ = self.runner.decode_multi(
                        np.asarray([chain[0]], np.int32),
                        np.asarray(table, np.int32)[None],
                        np.asarray([len(ctx)], np.int32), self.pool.shards,
                        num_steps=length - 1)
                    chain.extend(int(t) for t in
                                 torch.as_tensor(packed)[0, 0].tolist())
            finally:
                # drop the chain's KV: the next catch-up reflects the
                # request's REAL tokens
                self._truncate(st, len(st["tokens"]))
        except Exception:
            # a failing draft model never fails the target stream: drop
            # this request's draft KV (its write state is unknown) and
            # propose nothing
            self.release(rid)
            return []
        return chain
