"""Paged KV-cache pool + block allocator for the serving engine.

Counterpart of paddle_tpu/serving/kv_cache.py. Per layer
a tuple of [num_blocks, block_size, n_kv_heads, head_dim] pools, block
tables of int32 page ids. Page 0 is RESERVED as scratch: dead batch
slots and padded prefill positions write there, so the allocator never
hands it out and no live sequence reads it.

Four storage rungs (``kv_dtype``), over the logical ``dtype`` (the
runner's: fp32, or bf16 / fp16 for a runner cast to it):
  "fp32"  (k_pool, v_pool) in ``dtype``;
  "int8"  (k_codes, v_codes, k_scale, v_scale): int8 codes and one fp32
          scale per page per kv head ([num_blocks, n_kv]), written by
          `quantized_page_write`;
  "fp8"   (k_pool, v_pool) float8_e4m3fn, written by `fp8_page_write`;
  "mixed" (k_pool, v_pool, tag) in ``dtype`` plus a bool tag plane per
          layer ([num_blocks], the planes kept equal): pages of tenants
          tagged "fp8" (per request, `SamplingParams.kv_dtype`) hold the
          values `fp8_round` gives, the others verbatim values.
Every page is tagged with its owner's kv-dtype at allocation
(`tag_pages`, `page_tag`; the tag dies with the page's last reference),
and a tenant's tag seeds its prefix chain (`chain_seed`), so tenants of
two precisions never share a page.

The pools live on the engine's device and are written IN PLACE by the
runner (the JAX package threads them functionally); see model_runner.
The fp8 casts apply ml_dtypes' overflow rule on every device (|x| > 464
and +-inf become NaN), where torch's own cast saturates to +-448.

The shared-prefix page cache (`PrefixCache`, `KVCachePool.
enable_prefix_cache`): full pages are keyed by a content-chain hash
(`page_content_hash`), refcounted, mapped into a new sequence's table at
admission, and forked before any write (`SequenceKV.ensure_writable`,
`KVCachePool.copy_page`). A fork copies in place on the current stream,
the stream the runner's steps and graph replays run on, so it is ordered
before the write that follows it.

The host tier (`HostKVTier`, `KVCachePool.enable_host_tier`): pinned host
page buffers laid out like the pool (one per layer per pool array), fed
by preemption spills and by `PrefixCache` eviction through
``evict_hook``; a resumed request's pages come back by copy, bit for bit
(`OffloadRecord`). On the card every copy runs on the tier's side stream,
ordered against the compute stream by events (`HostKVTier`). The
prefill / decode handoff of the serving tier moves a request's slots
between two engines' tiers as numpy arrays (`HostKVTier.export_slots`,
`import_slots`, CRC-checked at receive).

The host-wide KV store (`SharedKVStore`): one content-addressed page store
per host under every replica's tier (``enable_host_tier(store=,
owner=)``), its bytes in torch host tensors or in shared-memory segments
that replica processes map, its metadata refcounted by owner and indexed
by chain hash; a handoff between engines of one host moves slot
references.

A pool over a mesh (`KVCachePool(mesh=)`) holds each layer's arrays as
one tensor a model shard, split on the kv-head axis; every page that
leaves it (gathers, host-tier spills and page-ins, handoffs, the store)
keeps the logical layout of all heads.

A departure: the JAX `chain_seed` folds a tag in with Python's `hash` of a
tuple holding a string, which changes from one process to the next
(PYTHONHASHSEED); the port folds it in with a CRC-32 of the tag's name,
the same in every process.
"""

from __future__ import annotations

import contextlib
import threading
import zlib
from bisect import insort
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device

SCRATCH_PAGE = 0

# int8 symmetric quantization range of the quantized KV pools
KV_QMAX = 127.0

# the pool storage rungs of the JAX package
KV_DTYPES = ("fp32", "int8", "fp8", "mixed")

# the logical dtypes a pool stores on its "fp32" and "mixed" rungs: the
# runner's compute dtype, the dtypes the serving kernels take
POOL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# ml_dtypes' float32 -> float8_e4m3fn overflow rule: 464 is the tie
# between 448 (the largest finite value) and 480, which does not exist;
# above it the cast gives NaN, where torch's own cast saturates to 448
FP8_OVERFLOW = 464.0


def fp8_supported() -> bool:
    """Whether this torch build carries float8_e4m3fn."""
    return hasattr(torch, "float8_e4m3fn")


def require_fp8(context: str) -> None:
    """Loud gate for the fp8 rung: never a silent fp32 fallback."""
    if not fp8_supported():
        raise RuntimeError(
            f"{context}: this torch build has no float8_e4m3fn, so fp8 KV "
            "pages cannot be stored; serve with kv_dtype='int8' instead")


def _fp8_cast(x):
    """x -> float8_e4m3fn exactly as ml_dtypes casts float32: round to
    nearest even, |x| > 464 and +-inf to NaN of x's sign."""
    x = x.float()
    nan = torch.copysign(torch.full_like(x, float("nan")), x)
    return torch.where(x.abs() > FP8_OVERFLOW, nan, x).to(
        torch.float8_e4m3fn)


def fp8_round(x):
    """Round-trip through float8_e4m3fn: the exact value a native fp8
    page stores, represented at the input dtype. NaNs come back as the
    canonical quiet NaN of their sign, as ml_dtypes widens them (torch's
    widening keeps a payload)."""
    y = _fp8_cast(x).to(x.dtype)
    nan = torch.copysign(torch.full_like(y, float("nan")), y)
    return torch.where(torch.isnan(y), nan, y)


def fp8_page_write(pool, write_page, write_off, x):
    """Append rows into a float8_e4m3fn page pool IN PLACE: a pure
    per-element cast, no scales. Idempotent, so step retries stay exact.
    The scatter goes through a uint8 view of the pool (the same bytes).
    Returns the pool."""
    pool.view(torch.uint8)[write_page, write_off] = \
        _fp8_cast(x).view(torch.uint8)
    return pool


def quantized_page_write(codes, scales, write_page, write_off, x):
    """Append fp K/V rows into an int8 page pool IN PLACE.

    codes: [num_blocks, page_size, n_kv, d] int8; scales: [num_blocks,
    n_kv] fp32 (one scale per page per kv head); write_page/write_off:
    [B, T] integer; x: [B, T, n_kv, d] float. Returns (codes, scales).

    Scale lifecycle, as in the JAX package: a write that lands on slot 0
    of a page RESTARTS that page's scale (a recycled page must not keep
    its previous tenant's range), otherwise the scale is the running
    abs-max over everything written to the page so far. When a write
    grows a page's scale, the codes already resident in the page are
    requantized (round-half-even of code * old / new), so one (page,
    head) scale dequantizes every live code; pages whose scale did not
    grow keep their codes (the ratio is exactly 1). Re-running the same
    write on the written pools gives the same pools, which keeps engine
    step retries exact. Repeated page ids in one call are folded by a
    scatter-max, as the JAX `.at[pages].max` does."""
    H = codes.shape[2]
    pages = write_page.reshape(-1).long()                   # [N]
    offs = write_off.reshape(-1)
    amax = x.abs().amax(dim=-1).reshape(-1, H).float()      # [N, H]
    # slot-0 writes restart the page's scale
    starts = torch.zeros(codes.shape[0], dtype=torch.int32,
                         device=codes.device).scatter_reduce_(
        0, pages, (offs == 0).to(torch.int32), "amax", include_self=True)
    base = torch.where(starts[:, None] > 0, torch.zeros_like(scales),
                       scales)                              # [P, H]
    contrib = torch.zeros_like(scales).scatter_reduce_(
        0, pages[:, None].expand(-1, H), amax / KV_QMAX, "amax",
        include_self=True)
    new_scales = torch.maximum(base, contrib)
    # requantize the touched pages' resident codes to the grown scale
    # (ratio == 1 exactly where nothing grew; a restarted page's stale
    # codes go to 0 and are rewritten or dead)
    ratio = torch.where(new_scales > 0.0,
                        base / new_scales.clamp(min=1e-30),
                        torch.ones_like(new_scales))
    resc = torch.round(codes[pages].float()
                       * ratio[pages][:, None, :, None])
    codes[pages] = resc.to(torch.int8)
    # quantize the incoming rows at the new scale and write them through
    s = new_scales[write_page.long()]                       # [B, T, H]
    q = torch.round(x.float() / s.clamp(min=1e-30)[..., None])
    codes[write_page, write_off] = q.clamp(-KV_QMAX, KV_QMAX).to(torch.int8)
    scales.copy_(new_scales)
    return codes, scales


# seed of the per-page content hash chain: the chain makes page i's key
# depend on every token in pages 0..i, so equal hash == equal token prefix
_CHAIN_SEED = 0x5EED


def page_content_hash(prev_hash: int, page_tokens: Sequence[int]) -> int:
    """Hash key of one FULL page given its tokens and the previous page's
    chain hash. Tuple-of-int hashing is deterministic in CPython (ints
    hash to themselves), so equal prefixes always collide on purpose."""
    return hash((prev_hash,) + tuple(int(t) for t in page_tokens))


class BlockAllocator:
    """Deterministic refcounted free-list page allocator.

    Pages are handed out lowest-id-first (sorted free list) so a given
    request trace always produces the same block tables. Page 0 (scratch)
    is never allocatable. `alloc` hands a page out at refcount 1; a page
    shared through the prefix cache is `incref`ed per extra user (the
    cache holds one reference per registered page); `free` is decref-each,
    and a page returns to the free list when its count hits zero.
    Over-release raises (the double-free guard). Pages only the cache
    still holds are evictable (`num_evictable`): `alloc` reclaims them,
    least recently used first, when the free list runs short."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is scratch)")
        self.num_blocks = num_blocks
        self._free = list(range(1, num_blocks))  # ascending
        self._ref: Dict[int, int] = {}           # page -> refcount (>= 1)
        # page -> its owner's kv-dtype tag, stamped at allocation
        # (`KVCachePool.tag_pages`), gone with the last reference
        self._tags: Dict[int, str] = {}
        self.evictor: Optional["PrefixCache"] = None

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_usable(self) -> int:
        """Total allocatable pages (excludes the scratch page)."""
        return self.num_blocks - 1

    @property
    def num_evictable(self) -> int:
        """Cached pages only the prefix cache still references: they can
        be reclaimed on demand, so admission treats them as free."""
        return self.evictor.evictable_count() if self.evictor else 0

    @property
    def allocated_pages(self) -> frozenset:
        """Read-only view of the live pages (resilience.audit_engine)."""
        return frozenset(self._ref)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free) + self.num_evictable

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free) and self.evictor is not None:
            self.evictor.evict(n - len(self._free))
        if n > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: need {n} pages, {len(self._free)} free")
        pages, self._free = self._free[:n], self._free[n:]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, page: int) -> int:
        if page not in self._ref:
            raise ValueError(f"incref of unallocated page {page}")
        self._ref[page] += 1
        return self._ref[page]

    def decref(self, page: int) -> int:
        if page not in self._ref:
            raise ValueError(f"double free of page {page}")
        self._ref[page] -= 1
        rc = self._ref[page]
        if rc == 0:
            del self._ref[page]
            self._tags.pop(page, None)   # the tag dies with the last ref
            insort(self._free, page)   # keep sorted: allocation stays
        return rc                      # deterministic

    def free(self, pages: List[int]) -> None:
        for p in pages:
            self.decref(p)

    def check_no_leaks(self) -> bool:
        return not self._ref and len(self._free) == self.num_usable


class PrefixCache:
    """Hash-indexed cache of FULL, immutable KV pages.

    Keys are content-chain hashes: page i of a sequence is keyed by
    hash(chain(pages 0..i-1), tokens of page i), so a hit on page i
    certifies the entire token prefix matches (the automatic prefix
    caching contract of vLLM and SGLang, at page granularity).

    The cache holds ONE allocator reference per registered page, so a
    registered page survives its owning sequence at refcount 1 ("cached
    free"). Those pages are evictable in LRU order (a logical tick, never
    wall time) when the allocator runs dry; acquiring a page for a new
    match increfs it back above 1, which pins it. Cached content is never
    written: any page with refcount > 1 is forked before a write
    (`SequenceKV.ensure_writable`).

    ``evict_hook(page, chain_hash, reason)`` is called for every page
    leaving the index, reason "evict" (LRU reclaim) or "clear", while the
    page is still allocated and its content intact: the host tier demotes
    it there, and a later `match_tiered` finds it on the host."""

    def __init__(self, pool: "KVCachePool"):
        self.pool = pool
        self.block_size = pool.block_size
        self._index: Dict[int, int] = {}        # chain hash -> page id
        self._page_hash: Dict[int, int] = {}    # page id -> chain hash
        self._page_tick: Dict[int, int] = {}    # page id -> last-use tick
        self._tick = 0
        self.hit_pages = 0
        self.miss_pages = 0
        self.evictions = 0
        self.evict_hook: Optional[Callable[[int, int, str], None]] = None

    def __len__(self) -> int:
        return len(self._index)

    def pages(self) -> frozenset:
        return frozenset(self._page_hash)

    def _touch(self, page: int) -> None:
        self._tick += 1
        self._page_tick[page] = self._tick

    # ---------------------------------------------------------- matching

    def match(self, tokens: Sequence[int],
              tag: Optional[str] = None) -> List[Tuple[int, int]]:
        """Longest cached page-aligned prefix of ``tokens``, as (chain
        hash, page) pairs. Capped STRICTLY below len(tokens): at least one
        token is always left to compute, so admission always produces the
        logits it samples from. ``tag`` seeds the chain (`chain_seed`)."""
        limit = (len(tokens) - 1) // self.block_size
        out: List[Tuple[int, int]] = []
        prev = self.pool.chain_seed(tag)
        for i in range(limit):
            h = page_content_hash(
                prev, tokens[i * self.block_size:(i + 1) * self.block_size])
            page = self._index.get(h)
            if page is None:
                self.miss_pages += 1
                break
            out.append((h, page))
            prev = h
        self.hit_pages += len(out)
        return out

    def match_tiered(self, tokens: Sequence[int], tag: Optional[str] = None
                     ) -> Tuple[List[Tuple[int, int]], List[int]]:
        """`match` extended into the host tier: after the device index
        misses, the chain continues against the tier's demoted pages.
        Returns (device matches as `match` gives them, host chain hashes);
        the scheduler funds a fresh device page for each host hash and the
        engine pages it in before the step that reads it. The same strict
        cap as `match`."""
        matched = self.match(tokens, tag)
        tier = self.pool.host_tier
        host: List[int] = []
        if tier is not None and tier.prefix_count:
            limit = (len(tokens) - 1) // self.block_size
            prev = matched[-1][0] if matched else self.pool.chain_seed(tag)
            for i in range(len(matched), limit):
                h = page_content_hash(
                    prev,
                    tokens[i * self.block_size:(i + 1) * self.block_size])
                if not tier.has_prefix(h):
                    break
                host.append(h)
                prev = h
        return matched, host

    def acquire(self, matched: List[Tuple[int, int]]) -> None:
        """Pin a match for a sequence: one incref per page and an LRU
        touch. Runs before any further allocation, so eviction cannot
        reclaim the matched pages out from under the admission."""
        for _, page in matched:
            self.pool.allocator.incref(page)
            self._touch(page)

    def unacquire(self, matched: List[Tuple[int, int]]) -> None:
        """Roll `acquire` back (admission did not take the seat)."""
        for _, page in matched:
            self.pool.allocator.decref(page)

    # ------------------------------------------------------ registration

    def register_seq(self, kv: "SequenceKV", tokens: Sequence[int]) -> int:
        """Register every newly FULL page of ``kv`` (tokens = the owning
        request's context). A page whose hash is already cached is skipped
        (first writer wins; the duplicate stays private to its sequence).
        Returns the number of pages the sequence's chain advanced by."""
        full = kv.num_tokens // self.block_size
        added = 0
        while kv.registered_pages < full:
            i = kv.registered_pages
            prev = (kv.hash_chain[i - 1] if i
                    else self.pool.chain_seed(kv.kv_tag))
            h = page_content_hash(
                prev, tokens[i * self.block_size:(i + 1) * self.block_size])
            page = kv.pages[i]
            if h not in self._index:
                self._index[h] = page
                self._page_hash[page] = h
                self.pool.allocator.incref(page)   # the cache's own ref
                self._touch(page)
                self._drop_host_duplicate(h)
            kv.hash_chain.append(h)
            kv.registered_pages += 1
            added += 1
        return added

    def register_page(self, page: int, h: int) -> bool:
        """Index an already-written page under its chain hash, first
        writer wins as in `register_seq`: the re-entry of a page promoted
        from the host tier. Returns False if the hash is already indexed
        (the page then stays private)."""
        if h in self._index:
            return False
        self._index[h] = page
        self._page_hash[page] = h
        self.pool.allocator.incref(page)
        self._touch(page)
        self._drop_host_duplicate(h, promoted=True)
        return True

    def _drop_host_duplicate(self, h: int, promoted: bool = False) -> None:
        """Keep chain hashes device-live XOR host-resident (the auditor's
        tier invariant): a recomputed registration of a hash the host tier
        still holds drops the host copy."""
        tier = self.pool.host_tier
        if tier is not None:
            tier.drop_stale_prefix(h, promoted=promoted)

    # ---------------------------------------------------------- eviction

    def evictable_count(self) -> int:
        alloc = self.pool.allocator
        return sum(1 for p in self._page_hash if alloc.refcount(p) == 1)

    def evict(self, n: int) -> int:
        """Reclaim up to n cached-free pages (refcount 1: only the cache
        holds them), least recently used first."""
        alloc = self.pool.allocator
        victims = sorted((p for p in self._page_hash
                          if alloc.refcount(p) == 1),
                         key=lambda p: self._page_tick[p])[:n]
        for page in victims:
            if self.evict_hook is not None:
                # before the decref: the page is allocated and intact, so
                # the host tier can copy it out
                self.evict_hook(page, self._page_hash[page], "evict")
            self._unregister(page)
            alloc.decref(page)         # rc 1 -> 0: back to the free list
            self.evictions += 1
        return len(victims)

    def _unregister(self, page: int) -> None:
        h = self._page_hash.pop(page)
        del self._index[h]
        del self._page_tick[page]

    def clear(self) -> int:
        """Drop the whole index and the cache's references: cached-free
        pages return to the free list, pages still mapped by running
        sequences stay live. Fires evict_hook(page, hash, "clear") for
        every dropped page, as `evict` does. Returns the number of pages
        dropped."""
        pages = list(self._page_hash)
        for page in pages:
            if self.evict_hook is not None:
                self.evict_hook(page, self._page_hash[page], "clear")
            self._unregister(page)
            self.pool.allocator.decref(page)
        return len(pages)


@dataclass
class OffloadRecord:
    """One preempted sequence's host-resident KV state.

    ``slots[j]`` holds the host copy of the sequence's page index
    ``start_page + j``; token positions [0, covered_tokens) are restorable
    from the prefix cache's pages for [0, start_page) and these slots. The
    record rides `Request.offload` while the request waits with phase
    "offloaded"; admission connects it to the matched prefix (a page-in
    resume) or drops it (the recompute fallback)."""

    start_page: int                        # first page index the slots cover
    covered_tokens: int                    # positions [0, covered) restorable
    slots: List[int] = field(default_factory=list)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """The same storage viewed as bytes (the last dimension widened by the
    itemsize): pages move as opaque bytes, fp8 and bool planes included."""
    return t if t.dtype == torch.uint8 else t.view(torch.uint8)


# the integer type of a torch dtype numpy has no type for, by width
_NUMPY_VIEWS = {torch.bfloat16: torch.int16,
                torch.float8_e4m3fn: torch.uint8}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy, bit for bit (bf16 and fp8 as integers)."""
    view = _NUMPY_VIEWS.get(t.dtype)
    return (t.view(view) if view is not None else t).numpy()


def _from_numpy(arr, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of `_to_numpy` into ``dtype``: bytes are reinterpreted,
    never converted, so a payload lands bit for bit."""
    t = torch.from_numpy(np.require(arr, requirements=("C", "W")))
    view = _NUMPY_VIEWS.get(dtype)
    if view is not None:
        return t.to(view).view(dtype)
    return t.to(dtype)


def consecutive_runs(slots: Sequence[int]):
    """(position, first slot, length) of each run of consecutive slots."""
    out = []
    for j, s in enumerate(slots):
        if out and s == out[-1][1] + out[-1][2]:
            out[-1][2] += 1
        else:
            out.append([j, s, 1])
    return out


# the dtype names of a store layout (the JAX package's numpy names) and
# their torch dtypes: a layout maps by name, never through np.dtype, which
# knows bfloat16 and float8_e4m3fn only where ml_dtypes is imported
STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int8": torch.int8,
                "uint8": torch.uint8, "bool": torch.bool}
if fp8_supported():
    STORE_DTYPES["float8_e4m3fn"] = torch.float8_e4m3fn


def dtype_name(dt) -> str:
    """The layout name of a torch dtype or a dtype name ("float32", ...)."""
    name = dt if isinstance(dt, str) else str(dt).replace("torch.", "")
    if name not in STORE_DTYPES:
        raise ValueError(f"no store dtype named {name!r}; expected one of "
                         f"{sorted(STORE_DTYPES)}")
    return name


def _layout_bytes(shape, name: str) -> int:
    return (int(np.prod(shape, dtype=np.int64))
            * STORE_DTYPES[name].itemsize)


def _open_shm(name: str, tracked: bool = False):
    """Attach an existing shared_memory segment. ``tracked=False`` (a
    replica child) keeps the attaching process's resource tracker out of
    it: on Python < 3.13 an attach registers the segment, and the tracker
    unlinks it when that process dies, SIGKILL included, pulling the store
    out from under the router; only the owning router unlinks.
    ``tracked=True`` (a recovering router that will own and unlink the
    segment) keeps the registration, so unlink's unregister balances."""
    from multiprocessing import shared_memory

    if tracked:
        return shared_memory.SharedMemory(name=name)
    try:
        return shared_memory.SharedMemory(name=name, track=False)
    except TypeError:                      # python < 3.13
        seg = shared_memory.SharedMemory(name=name)
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(seg._name,  # noqa: SLF001
                                        "shared_memory")
        except Exception:                  # pragma: no cover
            pass
        return seg


def _segment_views(seg, full, name: str) -> torch.Tensor:
    """A [max_pages, *page_shape] tensor over a segment's bytes. The view
    owns the mapping from then on: it holds an export of it (through
    np.frombuffer; torch.frombuffer and np.ndarray(buffer=) let go of
    theirs), and the segment lets go of it, so the mapping lives exactly
    as long as a view of it does (never unmapped under one, never closed
    with a BufferError) and the segment keeps only its name and file."""
    nbytes = _layout_bytes(full, name)
    raw = torch.from_numpy(np.frombuffer(seg.buf, np.uint8, count=nbytes))
    seg._buf = seg._mmap = None            # noqa: SLF001 - the view owns it
    return raw.view(STORE_DTYPES[name]).view(full)


def _close_segments(segments, unlink: bool) -> None:
    """Close (and unlink) shared-memory segments whose mappings their views
    own (`_segment_views`): the file is closed and, with ``unlink``,
    removed; each mapping goes with its last view."""
    for seg in segments:
        seg.close()
        if unlink:
            try:
                seg.unlink()
            except FileNotFoundError:
                pass


class SharedKVStore:
    """Host-wide content-addressed KV page store: ONE store per host under
    every engine replica's host tier (`HostKVTier(store=...)`), owned by
    the router. The page bytes live in torch host tensors (the thread
    backend: every engine shares the router's address space; pinned when
    ``pin_memory``) or in `multiprocessing.shared_memory` segments
    (``use_shm``, the process backend) that replica children map, so page
    bytes never cross a socket between processes of one host.

    Two reference classes keep a slot alive, audited tier-wide
    (resilience.audit_store):

      owner refs   per-(slot, owner) counts. An owner is one engine
                   incarnation (the router's "r0o3", or a child's launcher
                   key) holding the slot in an OffloadRecord or a pending
                   page-in, or a transfer tag ("xfer:<rid>") while a
                   handoff is between two engines. `reap_owner` releases
                   all a dead replica held.
      index ref    the content index's single ref per indexed slot:
                   `index_prefix(chain_hash, slot)` publishes a full page
                   under its token-chain hash; a second publication of the
                   chain is a dedup (no copy), and `acquire_prefix` hands
                   any engine a ref on the one resident copy. LRU eviction
                   in tick order reclaims index-only slots when the free
                   list runs dry.

    A slot returns to the free list when both classes are at zero; its
    generation then bumps, so staged transfers and stale handoff references
    invalidate themselves. Content hashes are CRC-32 over the slot's bytes
    (the JAX package's order: equal bytes hash equally in both packages and
    in every process), re-checked by the auditor's rotating spot check and
    at every handoff adoption.

    The layout is the JAX package's: per layer, per pool array, (page
    shape, dtype name), names mapped to torch dtypes by name
    (`STORE_DTYPES`). Departures from the JAX store: before it creates its
    segments the store checks the free space of /dev/shm and raises
    OSError with the bytes needed and the bytes free (a segment larger
    than the free tmpfs space is created all the same, and the process
    dies of SIGBUS on its first write); and `close` unlinks even when a
    view of a mapping is still alive."""

    def __init__(self, layout, max_pages: int, *, use_shm: bool = False,
                 _attach: Optional[dict] = None, pin_memory: bool = False):
        if max_pages < 1:
            raise ValueError("SharedKVStore needs max_pages >= 1")
        self.layout = [tuple((tuple(int(d) for d in shape), dtype_name(dt))
                             for shape, dt in layer) for layer in layout]
        self.max_pages = int(max_pages)
        self.use_shm = bool(use_shm)
        self.pin_memory = bool(pin_memory)
        self._owns_segments = _attach is None
        # the views first, the segments after them: when the store dies
        # its views are freed before its segments close
        segments: List = []
        self.bufs = self._map_buffers(_attach, segments)
        self.byte_bufs = [tuple(_bytes(b) for b in layer)
                          for layer in self.bufs]
        self._segments = segments
        self._segment_names = [seg.name for seg in segments]
        self._lock = threading.RLock()
        self._free: List[int] = list(range(self.max_pages))
        # slot -> {owner: count}; an empty or missing dict: no owner refs
        self._owners: Dict[int, Dict[str, int]] = {}
        self._indexed: set = set()         # slots the prefix index pins
        self._hash: Dict[int, Optional[int]] = {}
        self._gen: Dict[int, int] = {}
        self._prefix: Dict[int, int] = {}        # chain hash -> slot
        self._prefix_slot: Dict[int, int] = {}   # slot -> chain hash
        self._tick = 0
        self._slot_tick: Dict[int, int] = {}
        # cumulative tier-wide accounting (stats(), the audit)
        self.published_pages = 0           # fresh pages indexed
        self.dedup_pages = 0               # publications skipped: resident
        self.prefix_hits = 0               # acquire_prefix successes
        self.evictions = 0                 # LRU index-only reclaims
        self.reaped_slots = 0              # freed by dead-owner reaping
        self.dropped_pages = 0             # allocs a full store refused

    # ------------------------------------------------------ construction

    @classmethod
    def layout_for(cls, num_layers: int, block_size: int, n_kv_heads: int,
                   head_dim: int, dtype="float32",
                   kv_dtype: str = "fp32") -> list:
        """The page layout of a pool geometry: the per-page slices of
        KVCachePool's layer tuples, as the JAX package lists them."""
        dt = dtype_name(dtype)
        page = (block_size, n_kv_heads, head_dim)
        if kv_dtype == "int8":
            layer = ((page, "int8"), (page, "int8"),
                     ((n_kv_heads,), "float32"), ((n_kv_heads,), "float32"))
        elif kv_dtype == "fp8":
            layer = ((page, "float8_e4m3fn"), (page, "float8_e4m3fn"))
        elif kv_dtype == "mixed":
            # pages in the logical dtype and the page's tag bit
            layer = ((page, dt), (page, dt), ((), "bool"))
        else:
            layer = ((page, dt), (page, dt))
        return [layer for _ in range(num_layers)]

    @classmethod
    def for_runner(cls, runner, max_pages: int, *, use_shm: bool = False
                   ) -> "SharedKVStore":
        """A store sized for a runner's pool geometry (the thread backend:
        every replica must share the model geometry, which the tiers
        check when they attach). A runner on the card gets pinned
        buffers (without shm)."""
        device = getattr(runner, "device", None)
        on_card = getattr(device, "type", device) == "cuda"
        return cls(cls.layout_for(
            runner.num_layers, runner.block_size, runner.n_kv_heads,
            runner.head_dim, runner.dtype,
            getattr(runner, "kv_dtype", "fp32")), max_pages,
            use_shm=use_shm, pin_memory=on_card and not use_shm)

    @classmethod
    def for_geometry(cls, geometry: dict, max_pages: int, *,
                     use_shm: bool = False) -> "SharedKVStore":
        """A store of a JSON-able geometry (the process backend, where the
        router holds no runner): {num_layers, block_size, n_kv_heads,
        head_dim, dtype?, kv_dtype?}."""
        return cls(cls.layout_for(
            int(geometry["num_layers"]), int(geometry["block_size"]),
            int(geometry["n_kv_heads"]), int(geometry["head_dim"]),
            geometry.get("dtype", "float32"),
            geometry.get("kv_dtype", "fp32")), max_pages, use_shm=use_shm)

    def _map_buffers(self, attach: Optional[dict], segments: List):
        fulls = [[((self.max_pages,) + shape, dt) for shape, dt in layer]
                 for layer in self.layout]
        if attach is None and self.use_shm:
            import shutil

            need = sum(max(1, _layout_bytes(full, dt))
                       for layer in fulls for full, dt in layer)
            free = shutil.disk_usage("/dev/shm").free
            if need > free:
                raise OSError(
                    f"SharedKVStore: {self.max_pages} pages need {need} "
                    f"bytes of /dev/shm, {free} bytes are free")
        names = iter(attach["segments"]) if attach is not None else None
        bufs = []
        for layer in fulls:
            arrs = []
            for full, dt in layer:
                if attach is not None:
                    # a reattach: this process owns the segments from now
                    # on (it unlinks them), so tracking stays balanced
                    seg = _open_shm(next(names), tracked=True)
                elif self.use_shm:
                    from multiprocessing import shared_memory

                    seg = shared_memory.SharedMemory(
                        create=True, size=max(1, _layout_bytes(full, dt)))
                else:
                    seg = None
                if seg is None:
                    arr = torch.zeros(full, dtype=STORE_DTYPES[dt],
                                      pin_memory=self.pin_memory)
                else:
                    segments.append(seg)
                    arr = _segment_views(seg, full, dt)
                    if attach is None:
                        arr.zero_()        # commit the pages now
                arrs.append(arr)
            bufs.append(tuple(arrs))
        return bufs

    def attach_spec(self) -> Optional[dict]:
        """What a replica child (or a recovering router) needs to map the
        same segment bytes: the segment names in layout order and the
        layout. None without shm."""
        if not self.use_shm:
            return None
        return {"max_pages": self.max_pages,
                "layout": [[[list(shape), dt] for shape, dt in layer]
                           for layer in self.layout],
                "segments": list(self._segment_names)}

    @classmethod
    def reattach(cls, spec: dict) -> "SharedKVStore":
        """Map an existing store's segments (router recovery: segments
        survive a router SIGKILL until unlinked) with EMPTY metadata;
        restore_index() then revives the journaled entries whose bytes
        still CRC-verify."""
        layout = [tuple((tuple(shape), dt) for shape, dt in layer)
                  for layer in spec["layout"]]
        store = cls(layout, int(spec["max_pages"]), use_shm=True,
                    _attach=spec)
        store._owns_segments = True        # the recovered router owns them
        return store

    @staticmethod
    def unlink_spec(spec: Optional[dict]) -> int:
        """Unlink a dead store's segments (recovery decided not to
        reattach). Returns the segments unlinked."""
        if not spec:
            return 0
        n = 0
        for name in spec.get("segments", ()):
            try:
                seg = _open_shm(name, tracked=True)
            except FileNotFoundError:
                continue
            _close_segments([seg], unlink=True)
            n += 1
        return n

    def close(self, unlink: Optional[bool] = None) -> None:
        """Drop the buffers and the segment mappings; the creating (or
        recovered) router also unlinks, so host memory is returned when
        the tier shuts down."""
        if unlink is None:
            unlink = self._owns_segments
        self.bufs, self.byte_bufs = [], []
        segments, self._segments = self._segments, []
        _close_segments(segments, unlink)

    # ------------------------------------------------------- accounting

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.max_pages - len(self._free)

    @property
    def prefix_count(self) -> int:
        return len(self._prefix)

    def page_bytes(self) -> int:
        return sum(_layout_bytes(shape, dt)
                   for layer in self.layout for shape, dt in layer)

    @property
    def bytes_used(self) -> int:
        return self.used_count * self.page_bytes()

    def refcount(self, slot: int) -> int:
        with self._lock:
            return (sum(self._owners.get(slot, {}).values())
                    + (1 if slot in self._indexed else 0))

    def owner_count(self, slot: int, owner: str) -> int:
        with self._lock:
            return self._owners.get(slot, {}).get(owner, 0)

    def owners_snapshot(self) -> Dict[int, Dict[str, int]]:
        with self._lock:
            return {s: dict(o) for s, o in self._owners.items() if o}

    def generation(self, slot: int) -> int:
        with self._lock:
            return self._gen.get(slot, 0)

    def slot_hash(self, slot: int) -> Optional[int]:
        with self._lock:
            return self._hash.get(slot)

    def set_hash(self, slot: int, h: int) -> None:
        with self._lock:
            self._hash[slot] = int(h)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "store_max_pages": float(self.max_pages),
                "store_free": float(len(self._free)),
                "store_used": float(self.max_pages - len(self._free)),
                "store_prefix_pages": float(len(self._prefix)),
                "store_published_pages": float(self.published_pages),
                "store_dedup_pages": float(self.dedup_pages),
                "store_prefix_hits": float(self.prefix_hits),
                "store_evictions": float(self.evictions),
                "store_reaped_slots": float(self.reaped_slots),
                "store_dropped_pages": float(self.dropped_pages),
                "store_bytes_used": float(self.bytes_used),
            }

    # ------------------------------------------------------- slot refs

    def _touch_locked(self, slot: int) -> None:
        self._tick += 1
        self._slot_tick[slot] = self._tick

    def alloc(self, n: int, owner: str) -> List[int]:
        """Up to n slots at one ``owner`` ref each, lowest id first. A dry
        free list first evicts LRU index-only slots; what still cannot be
        funded is dropped and counted, never an error."""
        with self._lock:
            if n > len(self._free):
                self._evict_locked(n - len(self._free))
            take = min(n, len(self._free))
            if take < n:
                self.dropped_pages += n - take
            slots, self._free = self._free[:take], self._free[take:]
            for s in slots:
                self._owners[s] = {owner: 1}
                self._hash[s] = None
                self._touch_locked(s)
            return slots

    def incref(self, slots: Sequence[int], owner: str) -> None:
        with self._lock:
            for s in slots:
                own = self._owners.setdefault(s, {})
                if not own and s not in self._indexed:
                    raise ValueError(f"incref of free store slot {s}")
                own[owner] = own.get(owner, 0) + 1

    def release(self, slots: Sequence[int], owner: str) -> None:
        """Drop one ``owner`` ref per listed slot; a slot left with no
        owner ref and no index ref is freed (its generation bumps).
        Over-release raises: the tier-wide double-free guard."""
        with self._lock:
            for s in slots:
                own = self._owners.get(s)
                if not own or own.get(owner, 0) <= 0:
                    raise ValueError(
                        f"release of store slot {s} not held by "
                        f"{owner!r}")
                own[owner] -= 1
                if own[owner] == 0:
                    del own[owner]
                self._maybe_free_locked(s)

    def retag(self, slots: Sequence[int], old_owner: str,
              new_owner: str) -> None:
        """Move one ref per slot from ``old_owner`` to ``new_owner`` at
        once: the slot-reference handoff's transfer of ownership (prefill
        engine -> "xfer:<rid>" -> decode engine); no byte moves."""
        with self._lock:
            for s in slots:
                own = self._owners.get(s)
                if not own or own.get(old_owner, 0) <= 0:
                    raise ValueError(
                        f"retag of store slot {s}: no ref held by "
                        f"{old_owner!r}")
                own[old_owner] -= 1
                if own[old_owner] == 0:
                    del own[old_owner]
                own[new_owner] = own.get(new_owner, 0) + 1

    def _maybe_free_locked(self, s: int) -> bool:
        if self._owners.get(s) or s in self._indexed:
            return False
        self._owners.pop(s, None)
        self._hash.pop(s, None)
        self._slot_tick.pop(s, None)
        self._gen[s] = self._gen.get(s, 0) + 1
        insort(self._free, s)
        return True

    def reap_owner(self, owner: str) -> int:
        """Release every ref a dead owner held (supervisor recovery, drain
        residue, abandoned transfer tags). Slots a sibling or the index
        still references survive; the rest are freed. Returns the slots
        freed."""
        with self._lock:
            freed = 0
            for s in list(self._owners):
                own = self._owners.get(s)
                if own and owner in own:
                    del own[owner]
                    if self._maybe_free_locked(s):
                        freed += 1
            self.reaped_slots += freed
            return freed

    # ---------------------------------------------------- content index

    def has_prefix(self, h: int) -> bool:
        with self._lock:
            return h in self._prefix

    def index_prefix(self, h: int, slot: int) -> bool:
        """Publish a written slot under its token-chain hash; the index
        takes its own ref, so the content outlives the publisher. False:
        the chain is already resident (a dedup; the first publication
        wins)."""
        with self._lock:
            if h in self._prefix:
                self.dedup_pages += 1
                return False
            self._prefix[h] = slot
            self._prefix_slot[slot] = h
            self._indexed.add(slot)
            self.published_pages += 1
            self._touch_locked(slot)
            return True

    def acquire_prefix(self, h: int, owner: str) -> Optional[int]:
        """One ``owner`` ref on the chain's resident slot for a page-in
        (the chain stays indexed and keeps serving every sibling). None on
        a miss (the recompute fallback applies)."""
        with self._lock:
            slot = self._prefix.get(h)
            if slot is None:
                return None
            own = self._owners.setdefault(slot, {})
            own[owner] = own.get(owner, 0) + 1
            self.prefix_hits += 1
            self._touch_locked(slot)
            return slot

    def drop_prefix(self, h: int) -> bool:
        """Remove a chain from the index and drop the index's ref (a
        recomputed device registration supersedes the store copy
        tier-wide). Engines holding page-in refs keep the bytes alive
        until their fences release them."""
        with self._lock:
            slot = self._prefix.pop(h, None)
            if slot is None:
                return False
            del self._prefix_slot[slot]
            self._indexed.discard(slot)
            self._maybe_free_locked(slot)
            return True

    def _evict_locked(self, n: int) -> int:
        """Reclaim up to n index-only slots (no owner refs), least
        recently used first by the tick."""
        victims = sorted((s for s in self._indexed
                          if not self._owners.get(s)),
                         key=lambda s: self._slot_tick.get(s, 0))[:n]
        for s in victims:
            h = self._prefix_slot.pop(s)
            del self._prefix[h]
            self._indexed.discard(s)
            self._maybe_free_locked(s)
            self.evictions += 1
        return len(victims)

    # ------------------------------------------------------ byte access

    def read_slot(self, slot: int) -> List[Tuple[torch.Tensor, ...]]:
        """Copies of one slot's per-layer page arrays."""
        return [tuple(buf[slot].clone() for buf in layer)
                for layer in self.bufs]

    def export_slots(self, slots: Sequence[int]
                     ) -> List[Tuple[np.ndarray, ...]]:
        """Stacked numpy copies of several slots (export_slots' layout of
        the tier: a dtype numpy lacks as the integer type of its width)."""
        idx = torch.as_tensor(list(slots), dtype=torch.long)
        return [tuple(_to_numpy(buf.index_select(0, idx)) for buf in layer)
                for layer in self.bufs]

    def content_hash(self, slot: int) -> int:
        """CRC-32 over the slot's bytes across every layer buffer, in the
        JAX package's order (HostKVTier records the same)."""
        h = 0x9E3779B9
        for layer in self.byte_bufs:
            for buf in layer:
                h = zlib.crc32(buf[slot].numpy(), h)
        return h

    def scrub(self) -> int:
        """Re-CRC every indexed slot and drop the entries whose bytes no
        longer match their recorded hash: corrupted content recomputes,
        never serves. Returns the entries dropped."""
        with self._lock:
            entries = list(self._prefix.items())
        dropped = 0
        for h, s in entries:
            rec = self.slot_hash(s)
            if rec is not None and self.content_hash(s) != rec:
                if self.drop_prefix(h):
                    dropped += 1
        return dropped

    # ------------------------------------------------ journal round trip

    def journal_state(self) -> dict:
        """The content index as a JSON-able record, journaled beside the
        replica snapshots so ServingRouter.recover can revive it over
        segments that survived a router SIGKILL. Only indexed slots ride
        along: owner refs belong to engines that died with the router."""
        with self._lock:
            return {"prefix": [
                [int(h), int(s), int(self._gen.get(s, 0)),
                 int(self._hash.get(s) or 0)]
                for h, s in self._prefix.items()]}

    def restore_index(self, state: Optional[dict]) -> int:
        """Revive journaled index entries on a reattached store. Each
        entry is CRC-verified against the bytes of the slot it names
        first: a slot whose bytes did not survive is skipped, and its
        content recomputes on demand. Returns the entries restored."""
        if not state:
            return 0
        restored = 0
        for h, s, g, crc in state.get("prefix", ()):
            s = int(s)
            if not 0 <= s < self.max_pages:
                continue
            if self.content_hash(s) != int(crc):
                continue                   # corrupt or stale: recompute
            with self._lock:
                if int(h) in self._prefix or s not in self._free:
                    continue
                self._free.remove(s)
                self._prefix[int(h)] = s
                self._prefix_slot[s] = int(h)
                self._indexed.add(s)
                self._hash[s] = int(crc)
                self._gen[s] = int(g)
                self._touch_locked(s)
            restored += 1
        return restored


class HostKVTier:
    """Host-RAM page tier under the device pool, in private-buffer mode.

    Host buffers mirror the pool layout exactly: one buffer per layer per
    pool array, [max_pages, *page_shape] in the pool's dtype (fp32 / 16-bit
    and fp8 pools (k, v); int8 pools the codes AND the scale rows; a mixed
    pool its tag bits too), so a page-in is bit-identical to the spilled
    page. On a CUDA pool the buffers are pinned (a failed pin raises; no
    pageable fallback), on the CPU plain. Slots go out lowest-id-first
    from a sorted free list, as the device allocator's pages do.

    Two populations share the buffers, each slot owned by one party (the
    auditor checks it): offload slots, owned by one waiting request's
    `OffloadRecord` (preemption spilled its exclusively owned pages), and
    prefix slots, owned by the tier's hash index (`PrefixCache` eviction
    demoted a full cached page through ``evict_hook``; a later tiered
    match promotes it onto a fresh device page). A full tier blocks
    nothing: a spill copies what fits and drops the rest
    (``host_tier_drops``), and those resumes recompute. Every spilled slot
    records a CRC-32 content hash over its bytes (`content_hash`, the JAX
    package's order, so equal bytes hash equally in both packages); the
    auditor spot-checks a rotating sample.

    The copies on the card. A spill gathers the pages into a fresh device
    tensor on the compute stream (the snapshot: the pool is written in
    place, later writes cannot reach it), records an event, and the
    tier's side stream copies slot runs into the pinned buffer after it;
    the gathered tensor is held for the side stream (``record_stream``).
    A sync spill waits for the copies; with ``async_spill`` a worker
    thread waits on the copies' event and hashes, so the engine loop never
    blocks on a spill. A page-in reads the pinned slot only through
    copies on the same side stream (the engine's `_stage_slots`), so it is
    ordered after the slot's spill without a join, and a later spill into
    a reused slot waits on the slot's last read event. Host readers of a
    slot's bytes (`slot_hash`, `read_slot` on the CPU, `sync`) join the
    slot's pending spill job first; `blocking_joins` counts the joins that
    waited. A worker job writes a slot's hash only while the slot keeps
    the generation it was spilled at, so a slot freed and reused under a
    pending job never takes the old tenant's hash.

    ``store`` (a `SharedKVStore`, or a replica child's
    `store_service.SharedKVStoreClient`) makes the tier a facade over the
    host-wide store, under this engine's ``owner`` tag: its capacity, its
    slots, their generations and hashes and the prefix index are the
    store's, and its buffers are the store's (shared-memory views under
    the process backend). Spills of registered fp32 pages and prefix
    demotions publish into the store's index (a chain already resident is
    a dedup: a ref, no copy), a promotion takes a ref on the one resident
    copy and leaves it indexed, and a handoff moves slot references
    (`retag_out`, `adopt_slots`) instead of bytes. The stream ordering is
    the private tier's; in store mode a slot a page-in still reads is
    released only once its read event has passed, since another engine may
    spill into it next. Shared-memory mappings are pageable, so a copy
    between them and the card is synchronous with the host (the side
    stream still orders it)."""

    def __init__(self, pool: "KVCachePool", max_pages: int, metrics=None,
                 async_spill: bool = False, store=None,
                 owner: str = "engine"):
        if store is None and max_pages < 1:
            raise ValueError("host tier needs max_pages >= 1 (omit the "
                             "tier entirely to disable offload)")
        self.pool = pool
        self.store = store
        self.owner = str(owner)
        if store is not None:
            self._validate_store_layout(pool, store)
            max_pages = store.max_pages
        self.max_pages = int(max_pages)
        self.metrics = metrics             # optional EngineMetrics mirror
        self.async_spill = bool(async_spill)
        self._executor = None
        self._pending: Dict[int, object] = {}     # slot -> Future
        # jobs of slots freed before they were joined: read once done (the
        # next spill or free, or sync()), so a failed copy raises on the
        # engine loop and is never lost
        self._orphans: List[object] = []
        self._lock = threading.Lock()             # _hash / _gen vs worker
        self.cuda = pool.device.type == "cuda"
        # private buffers (store mode reads the store's through `_bufs`,
        # so closing the store leaves no tier holding a view of it)
        self._own_bufs: List[Tuple[torch.Tensor, ...]] = []
        self._own_byte_bufs: List[Tuple[torch.Tensor, ...]] = []
        if store is None:
            self._own_bufs = [tuple(self._host_buffer(shape, dt)
                                    for shape, dt in layer)
                              for layer in pool.page_layout()]
            self._own_byte_bufs = [tuple(_bytes(b) for b in layer)
                                   for layer in self._own_bufs]
        # the side stream of every copy between the pool and the buffers,
        # and each slot's last read (a page-in's host-to-device copy)
        self._stream = (torch.cuda.Stream(pool.device) if self.cuda
                        else None)
        self._read_events: Dict[int, object] = {}
        # store mode: releases waiting for a page-in's read to end
        self._deferred: List[Tuple[object, List[int]]] = []
        if store is None:
            self._free: List[int] = list(range(self.max_pages))  # asc.
            self._hash: Dict[int, Optional[int]] = {}   # slot -> hash
            self._gen: Dict[int, int] = {}              # slot -> reuses
            self._prefix: Dict[int, int] = {}           # chain -> slot
            self._prefix_slot: Dict[int, int] = {}      # slot -> chain
        else:
            self._free = self._hash = self._gen = None
            self._prefix = self._prefix_slot = None
        # cumulative accounting (the engine mirrors it into its metrics)
        self.spilled_pages = 0
        self.paged_in_pages = 0
        self.dropped_pages = 0              # spills a full tier refused
        self.resumes = 0                    # page-in resumes served
        self.fallbacks = 0                  # records dropped to recompute
        self.store_hits = 0                 # pages acquired from the index
        self.store_dedups = 0               # copies skipped: chain resident
        self.store_published = 0            # pages this engine indexed
        self.sync_spill_reads = 0           # spills the loop waited for
        self.blocking_joins = 0             # joins that waited on a job

    @staticmethod
    def _validate_store_layout(pool: "KVCachePool", store) -> None:
        """A store serves only pools of the exact page geometry it was
        built for: a replica of another model geometry mapping the same
        segments would corrupt every sibling. Loud, at attach time."""
        want = [tuple((shape, dtype_name(dt)) for shape, dt in layer)
                for layer in pool.page_layout()]
        have = [tuple((tuple(shape), dtype_name(dt))
                      for shape, dt in layer) for layer in store.layout]
        if want != have:
            raise ValueError(
                "SharedKVStore layout mismatch: pool pages are "
                f"{want[0] if want else '?'} x {len(want)} layers but "
                f"the store was built for "
                f"{have[0] if have else '?'} x {len(have)} layers: "
                "every replica sharing a store must run the same model "
                "geometry and kv_dtype")

    @property
    def _bufs(self) -> List[Tuple[torch.Tensor, ...]]:
        """Per layer, the host buffer of each pool array."""
        return self.store.bufs if self.store is not None else self._own_bufs

    @property
    def _byte_bufs(self) -> List[Tuple[torch.Tensor, ...]]:
        """`_bufs` viewed as bytes."""
        return (self.store.byte_bufs if self.store is not None
                else self._own_byte_bufs)

    def _host_buffer(self, page_shape, dtype) -> torch.Tensor:
        shape = (self.max_pages,) + tuple(page_shape)
        if not self.cuda:
            return torch.zeros(shape, dtype=dtype)
        buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        if not buf.is_pinned():
            raise RuntimeError(
                f"HostKVTier: a {shape} {dtype} host buffer did not pin; "
                "the tier refuses pageable memory on a CUDA pool")
        return buf

    # ------------------------------------------------------- accounting

    @property
    def free_count(self) -> int:
        if self.store is not None:
            return self.store.free_count
        return len(self._free)

    @property
    def used_count(self) -> int:
        if self.store is not None:
            return self.store.used_count
        return len(self._hash)

    @property
    def prefix_count(self) -> int:
        if self.store is not None:
            return self.store.prefix_count
        return len(self._prefix)

    @property
    def bytes_used(self) -> int:
        """Host bytes the used slots hold: the device pool's per-page cost
        (code and scale bytes on int8)."""
        return self.used_count * self.pool.page_bytes()

    @property
    def capacity_bytes(self) -> int:
        return self.max_pages * self.pool.page_bytes()

    def generation(self, slot: int) -> int:
        """Reuse generation of a slot, bumped on every free: a staged
        page-in keyed by (slot, generation) never serves a later
        tenant's bytes."""
        if self.store is not None:
            return self.store.generation(slot)
        return self._gen.get(slot, 0)

    def slot_hash(self, slot: int) -> int:
        self._wait_slot(slot)
        if self.store is not None:
            return self.store.slot_hash(slot)
        return self._hash[slot]

    def stream(self):
        """The context of the tier's side stream (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def note_read(self, *slots: int):
        """Record the end of a page-in's read of ``slots`` on the side
        stream (a later spill into one of them waits for it); returns the
        event, None on the CPU."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        for s in slots:
            self._read_events[s] = ev
        return ev

    # ------------------------------------------ async spill worker plumbing

    def _ensure_executor(self):
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="kv-spill")
        return self._executor

    def _wait_slot(self, slot: int) -> None:
        """Join the pending spill job of one slot (a no-op without one).
        `blocking_joins` counts the joins that actually waited."""
        fut = self._pending.pop(slot, None)
        if fut is not None:
            if not fut.done():
                self.blocking_joins += 1
            fut.result()

    def _reap(self) -> None:
        """Read the finished jobs of freed slots (a failure raises here),
        and make the releases whose page-in reads have passed (store
        mode)."""
        done, running = [], []
        for fut in self._orphans:
            (done if fut.done() else running).append(fut)
        self._orphans = running
        for fut in done:
            fut.result()
        if self._deferred:
            later = []
            for ev, slots in self._deferred:
                if ev.query():
                    self.store.release(slots, self.owner)
                else:
                    later.append((ev, slots))
            self._deferred = later

    def sync(self) -> None:
        """Join every pending spill job (and, in store mode, every read a
        deferred release waits for): the fence the auditor runs before it
        trusts slot contents and hashes."""
        pending, self._pending = self._pending, {}
        orphans, self._orphans = self._orphans, []
        for fut in {id(f): f for f in (*pending.values(), *orphans)
                    }.values():
            fut.result()
        deferred, self._deferred = self._deferred, []
        for ev, slots in deferred:
            ev.synchronize()
            self.store.release(slots, self.owner)

    def _spill_job(self, slots: List[int], gens: List[int], gathered,
                   done, publish=()) -> None:
        """The bytes' half of a spill: on the CPU the copy from the
        gathered snapshot, on the card a wait on the side stream's copies;
        then each slot's hash, written only while the slot keeps the
        generation it was spilled at; then, in store mode, the chain
        hashes published into the store's index, strictly after the bytes
        landed, so a sibling never pages in a half-written slot."""
        if self.store is not None and gens is not None:
            live = [s for s, g in zip(slots, gens)
                    if self.store.generation(s) == g]
            if len(live) < len(slots):
                # a slot reaped meanwhile (its engine died) is neither
                # written here nor hashed nor published
                keep = set(live)
                gathered = [tuple(a[[j for j, s in enumerate(slots)
                                     if s in keep]] for a in layer)
                            for layer in gathered]
                publish = [(s, h) for s, h in publish if s in keep]
                slots = live
        if done is None:
            self._copy_runs(slots, gathered)
        else:
            done.synchronize()
        if self.store is not None:
            for s in slots:
                self.store.set_hash(s, self.content_hash(s))
            for s, h in publish:
                if self.store.index_prefix(h, s):
                    self.store_published += 1
            return
        for s, g in zip(slots, gens):
            h = self.content_hash(s)
            with self._lock:
                if self._gen.get(s, 0) == g and s in self._hash:
                    self._hash[s] = h

    def _copy_runs(self, slots, gathered) -> None:
        """Copy the gathered pages into their slots, one copy a run of
        consecutive slots a pool array (on the side stream, non-blocking,
        on the card)."""
        runs = consecutive_runs(slots)
        for layer_bufs, layer_data in zip(self._byte_bufs, gathered):
            for buf, data in zip(layer_bufs, layer_data):
                for j, s, n in runs:
                    buf[s:s + n].copy_(data[j:j + n], non_blocking=self.cuda)

    def content_hash(self, slot: int) -> int:
        """CRC-32 over the slot's bytes across every layer buffer, in the
        JAX package's order: recorded at spill time, re-checked by the
        auditor, the same in every process (and for the same bytes in
        both packages)."""
        h = 0x9E3779B9
        for layer in self._byte_bufs:
            for buf in layer:
                h = zlib.crc32(buf[slot].numpy(), h)
        return h

    # ------------------------------------------------------------ spill

    def _take_slots(self, n: int) -> List[int]:
        """Up to n fresh slots (the store's under this engine's owner tag
        in store mode), lowest id first."""
        if self.store is not None:
            return self.store.alloc(n, self.owner)
        slots = self._free[:n]
        del self._free[:n]
        return slots

    def spill_pages(self, device_pages: Sequence[int],
                    publish: Sequence[Tuple[int, int]] = ()) -> List[int]:
        """Copy device pages into host slots. Takes as many as fit; the
        overflow is dropped and counted, never an error. Returns the
        slots, aligned with the leading device_pages they hold.
        ``publish`` (store mode) maps positions in ``device_pages`` to
        chain hashes to index tier-wide once the bytes land; positions
        past the fitted prefix are dropped with their pages."""
        if tuple(publish) and self.store is None:
            raise ValueError("spill_pages(publish=...) needs a store-backed "
                             "tier (the private tier keeps its own index)")
        self._reap()
        slots = self._take_slots(len(device_pages))
        n = len(slots)
        dropped = len(device_pages) - n
        if dropped:
            self.dropped_pages += dropped
            if self.metrics is not None:
                self.metrics.host_tier_drops.inc(dropped)
        if n == 0:
            return []
        pub = [(slots[i], h) for i, h in publish if i < n]
        gathered = [tuple(_bytes(a) for a in layer)
                    for layer in self.pool.gather_pages(
                        list(device_pages)[:n])]
        if self.store is None:
            with self._lock:
                for s in slots:
                    self._hash[s] = None
            gens = [self.generation(s) for s in slots]
        else:
            # the store guards an async job's writes by generation (a
            # reaped slot is never written); a sync spill needs no guard
            gens = ([self.generation(s) for s in slots]
                    if self.async_spill else None)
        done = None
        if self.cuda:
            compute = torch.cuda.current_stream(self.pool.device)
            self._stream.wait_stream(compute)
            for s in slots:
                ev = self._read_events.pop(s, None)
                if ev is not None:
                    self._stream.wait_event(ev)
            with torch.cuda.stream(self._stream):
                self._copy_runs(slots, gathered)
                done = torch.cuda.Event()
                done.record(self._stream)
            for layer in gathered:
                for t in layer:
                    t.record_stream(self._stream)
        if self.async_spill:
            fut = self._ensure_executor().submit(self._spill_job, slots,
                                                 gens, gathered, done, pub)
            for s in slots:
                self._pending[s] = fut
        else:
            self.sync_spill_reads += 1
            self._spill_job(slots, gens, gathered, done, pub)
        self.spilled_pages += n
        if self.metrics is not None:
            self.metrics.offload_spill_pages.inc(n)
        return slots

    def spill_sequence(self, kv: "SequenceKV", covered_tokens: int,
                       include_registered: bool = False
                       ) -> Optional[OffloadRecord]:
        """Spill a preemption victim's exclusively owned pages (the ones
        release() sends back to the free list), covering token positions
        [registered_pages * block_size, covered_tokens). Leading
        registered pages stay on the device in the PrefixCache at
        refcount 1 and re-match at re-admission (or are demoted through
        evict_hook and re-match on the host). Returns None when nothing is
        spillable (the recompute path applies); a partial fit trims
        covered_tokens to the spilled page boundary.

        ``include_registered`` (the prefill / decode handoff) spills the
        whole range from page 0, shared pages included: the spill only
        reads them, and the record must be self-contained on a sibling
        whose prefix cache holds none of the sender's pages.

        Store mode adds content-addressed dedup on fp32 pools: a
        registered page whose chain is already resident tier-wide
        contributes a ref on the resident copy instead of a copy, and the
        registered pages spilled fresh are published once their bytes
        land. Other pools skip dedup and publication (int8 codes depend
        on the chunk history, so equal chains need not mean equal bytes:
        the record carries this sequence's own bytes) but use store
        slots."""
        bs = self.pool.block_size
        covered = min(int(covered_tokens), kv.num_tokens)
        start = 0 if include_registered else kv.registered_pages
        end = -(-covered // bs) if covered > 0 else 0
        if end <= start:
            return None
        cand = kv.pages[start:end]
        alloc = self.pool.allocator
        if not include_registered and any(alloc.refcount(p) != 1
                                          for p in cand):
            # a shared page past the registered range would break the
            # record's contiguity: declined, counted
            self.note_fallback()
            return None
        if self.store is None or self.pool.kv_dtype != "fp32":
            slots = self.spill_pages(cand)
        else:
            slots = self._spill_dedup(kv, start, cand)
        if not slots:
            return None
        if len(slots) < len(cand):
            covered = (start + len(slots)) * bs
        return OffloadRecord(start_page=start, covered_tokens=covered,
                             slots=slots)

    def _spill_dedup(self, kv: "SequenceKV", start: int,
                     cand: List[int]) -> List[int]:
        """Store-mode spill of ``cand`` (pages from index ``start``): refs
        on resident chains, fresh copies (published if registered) for
        the rest. A partial fit ends the slots at the first hole, and the
        refs past it are released, so the record stays contiguous."""
        slots: List[Optional[int]] = [None] * len(cand)
        fresh_pages: List[int] = []
        fresh_pos: List[int] = []
        publish: List[Tuple[int, int]] = []   # (fresh_pages idx, hash)
        for j, page in enumerate(cand):
            idx = start + j
            h = kv.hash_chain[idx] if idx < kv.registered_pages else None
            if h is not None:
                s = self.store.acquire_prefix(h, self.owner)
                if s is not None:
                    self._wait_slot(s)     # never reference a half-copy
                    slots[j] = s
                    self.store_dedups += 1
                    if self.metrics is not None:
                        self.metrics.store_dedup_pages.inc()
                    continue
                publish.append((len(fresh_pages), h))
            fresh_pages.append(page)
            fresh_pos.append(j)
        for j, s in zip(fresh_pos, self.spill_pages(fresh_pages,
                                                    publish=publish)):
            slots[j] = s
        k = 0
        while k < len(slots) and slots[k] is not None:
            k += 1
        tail = [s for s in slots[k:] if s is not None]
        if tail:
            self.store.release(tail, self.owner)
        return list(slots[:k])

    # -------------------------------------------- prefix demotion (hook)

    def on_evict(self, page: int, chain_hash: int, reason: str) -> bool:
        """PrefixCache.evict_hook target: demote a full cached page to the
        host before the device page is reclaimed, on LRU eviction and on
        clear() alike. Returns False when the tier is full (the page
        dies). Store mode publishes tier-wide: a chain already resident is
        a dedup (no copy), else the page spills into a slot the index
        alone owns once published."""
        if self.store is not None:
            if self.store.has_prefix(chain_hash):
                self.store_dedups += 1
                if self.metrics is not None:
                    self.metrics.store_dedup_pages.inc()
                return True
            slots = self.spill_pages([page], publish=[(0, chain_hash)])
            if not slots:
                return False
            s = slots[0]
            if self.async_spill:
                # the release is a second job on the same one-thread
                # executor, so it runs after the copy and publication;
                # the slot's pending future becomes it, so joiners wait
                # through both
                first = self._pending.get(s)

                def _release(s=s, first=first):
                    if first is not None:
                        first.result()
                    try:
                        self.store.release([s], self.owner)
                    except ValueError:     # pragma: no cover - reaped
                        pass
                self._pending[s] = self._ensure_executor().submit(_release)
            else:
                self.store.release([s], self.owner)
            return True
        if chain_hash in self._prefix:      # pragma: no cover - the index
            return False                    # is hash-unique
        slots = self.spill_pages([page])
        if not slots:
            return False
        self._prefix[chain_hash] = slots[0]
        self._prefix_slot[slots[0]] = chain_hash
        return True

    def has_prefix(self, h: int) -> bool:
        if self.store is not None:
            return self.store.has_prefix(h)
        return h in self._prefix

    def promote(self, h: int) -> Optional[int]:
        """Claim a demoted prefix page for re-promotion: the hash leaves
        the host index (device-live XOR host-resident) and the slot stays
        held until the engine's fence pages it in and frees it. Store
        mode: the hash stays indexed (the same bytes keep serving every
        sibling) and this engine takes a ref for its page-in; None when
        the entry raced away tier-wide (the caller recomputes)."""
        if self.store is not None:
            slot = self.store.acquire_prefix(h, self.owner)
            if slot is not None:
                self.store_hits += 1
                if self.metrics is not None:
                    self.metrics.store_hit_pages.inc()
            return slot
        slot = self._prefix.pop(h)
        del self._prefix_slot[slot]
        return slot

    def drop_stale_prefix(self, h: int, promoted: bool = False) -> None:
        """A recomputed registration of ``h`` supersedes the host copy:
        its slot is freed (a promoted one already left the index). Store
        mode drops the index entry tier-wide unless the registration was
        paged in from it (``promoted``); siblings' page-ins keep the bytes
        alive through their own refs."""
        if self.store is not None:
            if not promoted and self.store.has_prefix(h):
                self.store.drop_prefix(h)
            return
        if self.has_prefix(h):
            self.free_slots([self.promote(h)])

    # ---------------------------------------------------------- page-in

    def read_slots(self, first: int, n: int
                   ) -> List[Tuple[torch.Tensor, ...]]:
        """The pages of the n consecutive slots from ``first``: per layer a
        tuple of [n, *page_shape] arrays. On the CPU the slots' pending
        spill jobs are joined and the arrays are copies (a slot may be
        reused while they are held). On the card they are the slots
        themselves, for copies on the side stream only (`stream`): those
        run after the slots' spill copies, so no join is needed, and
        `note_read` marks their end for the slots' next spills."""
        if self.cuda:
            return [tuple(buf[first:first + n] for buf in layer)
                    for layer in self._bufs]
        for s in range(first, first + n):
            self._wait_slot(s)
        return [tuple(buf[first:first + n].clone() for buf in layer)
                for layer in self._bufs]

    def read_slot(self, slot: int) -> List[Tuple[torch.Tensor, ...]]:
        """One slot's per-layer page arrays, as `read_slots` gives them."""
        return [tuple(a[0] for a in layer)
                for layer in self.read_slots(slot, 1)]

    def export_slots(self, slots: Sequence[int]
                     ) -> List[Tuple[np.ndarray, ...]]:
        """Host copies of several slots in pool-array layout: per layer a
        tuple of [len(slots), *page_shape] numpy arrays (page bytes, and
        the scale rows on int8 pools), the handoff's payload. Pending
        spill jobs of the slots are joined first. A dtype numpy lacks
        travels as the integer type of its width (bf16 as int16, fp8 as
        uint8), bit for bit."""
        for s in slots:
            self._wait_slot(s)
        idx = torch.as_tensor(list(slots), dtype=torch.long)
        return [tuple(_to_numpy(buf.index_select(0, idx)) for buf in layer)
                for layer in self._bufs]

    def import_slots(self, layer_data, hashes: Sequence[int]
                     ) -> Optional[List[int]]:
        """Write a handoff's page payload (export_slots' layout) into
        fresh slots, the receiving half of the handoff. ``hashes`` are the
        sender's per-slot content hashes, re-verified against the bytes
        written: a mismatch frees the slots and raises ValueError, so a
        corrupted page is never served. Returns None when the tier cannot
        hold the whole payload (the caller recomputes: a partial import
        could not connect). Engines of one host sharing a store hand off
        by slot reference instead (`adopt_slots`)."""
        n = len(hashes)
        if n == 0:
            return []
        self._reap()
        if self.store is None and n > len(self._free):
            slots = None
        else:
            slots = self._take_slots(n)
            if len(slots) < n:
                if slots:
                    self.store.release(slots, self.owner)
                slots = None
        if slots is None:
            self.dropped_pages += n
            if self.metrics is not None:
                self.metrics.host_tier_drops.inc(n)
            return None
        for s in slots:
            # a page-in may still be reading a reused slot on the side
            # stream: the host write waits for that read to end
            ev = self._read_events.pop(s, None)
            if ev is not None:
                ev.synchronize()
        idx = torch.as_tensor(slots, dtype=torch.long)
        for layer_bufs, data in zip(self._bufs, layer_data):
            for buf, arr in zip(layer_bufs, data):
                buf.index_copy_(0, idx, _from_numpy(arr, buf.dtype))
        bad = []
        for j, s in enumerate(slots):
            h = self.content_hash(s)
            if self.store is not None:
                self.store.set_hash(s, h)
            else:
                with self._lock:
                    self._hash[s] = h
            if h != int(hashes[j]):
                bad.append(s)
        if bad:
            self.free_slots(slots)
            raise ValueError(
                f"handoff content-hash mismatch on {len(bad)} of {n} "
                f"pages (slots {bad}): page bytes corrupted in transfer; "
                "refusing to serve them")
        self.spilled_pages += n
        if self.metrics is not None:
            self.metrics.offload_spill_pages.inc(n)
        return slots

    # ------------------------------------ slot-reference transfer (store)

    def retag_out(self, slots: Sequence[int], to_owner: str) -> None:
        """Hand this engine's refs on ``slots`` to a transfer tag (the
        extract half of a slot-reference handoff): pending spill jobs are
        joined first, so the reference never names half-written bytes,
        then the store moves the refs; no byte is touched."""
        for s in slots:
            self._wait_slot(s)
        self.store.retag(list(slots), self.owner, to_owner)

    def adopt_slots(self, slots: Sequence[int], gens: Sequence[int],
                    hashes: Sequence[int], from_owner: str
                    ) -> Optional[List[int]]:
        """Accept a slot-reference handoff: each slot's generation must be
        current (a stale reference names recycled bytes: None, the
        recompute fallback) and its CRC must match the bytes in the store
        (a mismatch raises ValueError, never served); then the refs move
        from the transfer tag to this engine. No page byte moves."""
        slots = [int(s) for s in slots]
        stale = [s for s, g in zip(slots, gens)
                 if self.store.generation(s) != int(g)]
        if stale:
            self.store.release(slots, from_owner)
            self.note_fallback()
            return None
        bad = [s for s, h in zip(slots, hashes)
               if self.content_hash(s) != int(h)]
        if bad:
            self.store.release(slots, from_owner)
            raise ValueError(
                f"handoff content-hash mismatch on {len(bad)} of "
                f"{len(slots)} store slots ({bad}): segment bytes "
                "corrupted; refusing to serve them")
        self.store.retag(slots, from_owner, self.owner)
        return slots

    def free_slots(self, slots: Sequence[int]) -> None:
        """Return slots to the tier, bumping each slot's generation (a
        pending worker job of the slot then leaves its hash alone, and a
        staged page-in keyed by the old generation never resolves). Store
        mode releases this engine's refs (a slot is reclaimed when no
        sibling, transfer or index ref is left) after joining the slots'
        spill jobs; a slot a page-in still reads on the side stream is
        released once that read has passed."""
        if self.store is not None:
            self._reap()
            for s in slots:
                self._wait_slot(s)
            now, later = [], {}
            for s in slots:
                ev = self._read_events.pop(s, None)
                if ev is not None and not ev.query():
                    later.setdefault(id(ev), (ev, []))[1].append(s)
                else:
                    now.append(s)
            if now:
                self.store.release(now, self.owner)
            self._deferred.extend(later.values())
            return
        with self._lock:
            for s in slots:
                if s not in self._hash:
                    raise ValueError(f"double free of host slot {s}")
                del self._hash[s]
                fut = self._pending.pop(s, None)
                if fut is not None:
                    self._orphans.append(fut)
                h = self._prefix_slot.pop(s, None)
                if h is not None:               # dropped, never promoted
                    del self._prefix[h]
                self._gen[s] = self._gen.get(s, 0) + 1
                insort(self._free, s)

    def note_resume(self) -> None:
        self.resumes += 1
        if self.metrics is not None:
            self.metrics.offload_resumes.inc()

    def note_fallback(self) -> None:
        self.fallbacks += 1
        if self.metrics is not None:
            self.metrics.offload_recompute_fallbacks.inc()


def check_kv_dtype(kv_dtype: str, context: str) -> None:
    """Unknown rungs raise ValueError; the fp8 and mixed rungs need
    float8_e4m3fn (a mixed pool's fp8 tenants round through it)."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype={kv_dtype!r}; expected one of "
                         f"{KV_DTYPES}")
    if kv_dtype in ("fp8", "mixed"):
        require_fp8(f"{context}(kv_dtype={kv_dtype!r})")


class KVCachePool:
    """The device-side page pool: per-layer pool tuples + the allocator.

    The pools live on ``device`` ("cuda" unless the caller passes "cpu";
    keyword-only, after the JAX parameters). ``dtype`` is the logical
    (compute) dtype, fp32, bf16 or fp16 (`POOL_DTYPES`); ``kv_dtype`` the
    storage rung (module docstring). Block tables live host-side as python
    lists per sequence; `pad_table` builds the fixed-width operand.

    With a ``mesh`` (`parallel.mesh.Mesh`) the pools are born split on the
    kv-head axis over the mesh's ``model_axis``, on its devices (``device``
    is then the first shard's): each of the tp shards holds every page's
    slice of n_kv_heads / tp heads, in contiguous tensors of its own
    ([blocks, block, n_kv / tp, d], and [blocks, n_kv / tp] scale pools on
    an int8 pool; a mixed pool's tag plane, which has no head axis, is
    replicated on every shard). ``shards`` lists each shard's layer tuples,
    one shard on an unsharded pool: the runner's operand. ``pools`` is the
    JAX package's shape, the layer list of an unsharded pool (that one
    shard's list); a sharded pool has no such list and raises. The allocator,
    the block tables and the PrefixCache stay mesh-blind: one page id
    names the same page on every shard. Every byte that leaves the pool
    keeps the JAX logical layout, the shards joined on the head axis
    (`gather_pages`, `read_pages`, `write_pages`, `page_layout`), so a
    sharded pool's exported page is bit-equal to an unsharded pool's."""

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 n_kv_heads: int, head_dim: int, dtype=torch.float32,
                 mesh=None, model_axis: str = "model",
                 kv_dtype: str = "fp32", *, device="cuda"):
        if dtype not in POOL_DTYPES:
            raise ValueError(f"KVCachePool(dtype={dtype}); expected one of "
                             f"{POOL_DTYPES}")
        check_kv_dtype(kv_dtype, "KVCachePool")
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.kv_dtype = kv_dtype
        self.mesh = mesh
        self.model_axis = model_axis
        self.tp_size = 1
        if mesh is not None:
            self.tp_size = int(mesh.shape[model_axis])
            if n_kv_heads % self.tp_size:
                raise ValueError(
                    f"n_kv_heads={n_kv_heads} is not divisible by the "
                    f"model-axis degree {self.tp_size}: the paged pools "
                    "shard in whole kv-heads (GQA rule)")
            devices = mesh.axis_devices(model_axis)
        else:
            devices = [resolve_device(device)]
        self.device = devices[0]
        self.allocator = BlockAllocator(num_blocks)
        self.prefix_cache: Optional[PrefixCache] = None
        self.host_tier: Optional[HostKVTier] = None
        self.shards: List[List[Tuple[torch.Tensor, ...]]] = [
            self._shard_pools(dev) for dev in devices]

    @property
    def pools(self) -> List[Tuple[torch.Tensor, ...]]:
        """The layer tuples of an unsharded pool (the JAX package's
        ``pools``)."""
        if self.tp_size > 1:
            raise AttributeError(
                f"a pool sharded over {self.tp_size} shards holds its "
                "layers per shard: read `shards`")
        return self.shards[0]

    @pools.setter
    def pools(self, layers) -> None:
        if self.tp_size > 1:
            raise AttributeError(
                f"a pool sharded over {self.tp_size} shards holds its "
                "layers per shard: assign `shards`")
        self.shards = [layers]

    def _shard_pools(self, dev) -> List[Tuple[torch.Tensor, ...]]:
        """One shard's layer tuples on ``dev``, at n_kv_heads / tp heads."""
        heads = self.n_kv_heads // self.tp_size
        shape = (self.num_blocks, self.block_size, heads, self.head_dim)

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=dev)

        if self.kv_dtype == "int8":
            sshape = (self.num_blocks, heads)  # one scale a page a head
            return [(zeros(shape, torch.int8), zeros(shape, torch.int8),
                     zeros(sshape, torch.float32),
                     zeros(sshape, torch.float32))
                    for _ in range(self.num_layers)]
        if self.kv_dtype == "mixed":
            # storage in the logical dtype and a tag plane per layer (kept
            # equal; `tag_pages` sets them all), which steers the writes
            return [(zeros(shape, self.dtype), zeros(shape, self.dtype),
                     zeros((self.num_blocks,), torch.bool))
                    for _ in range(self.num_layers)]
        store = torch.float8_e4m3fn if self.kv_dtype == "fp8" else self.dtype
        return [(zeros(shape, store), zeros(shape, store))
                for _ in range(self.num_layers)]

    @staticmethod
    def _head_axis(j: int) -> Optional[int]:
        """The kv-head axis of a layer tuple's array j, counted on the
        [blocks, ...] pool arrays and on [n, ...] page stacks alike: 2 for
        K / V, 1 for int8 scales; None for a tag plane (no head axis)."""
        return {0: 2, 1: 2}.get(j, 1)

    def _is_tag(self, j: int) -> bool:
        return self.kv_dtype == "mixed" and j == 2

    def page_layout(self) -> List[Tuple[Tuple[tuple, torch.dtype], ...]]:
        """Per layer, each pool array's logical page shape (all kv heads)
        and storage dtype: the layout of every byte that leaves the pool."""
        out = []
        for layer in self.shards[0]:
            arrays = []
            for j, a in enumerate(layer):
                shape = list(a.shape[1:])
                if not self._is_tag(j):
                    shape[self._head_axis(j) - 1] *= self.tp_size
                arrays.append((tuple(shape), a.dtype))
            out.append(tuple(arrays))
        return out

    def native_kv_tag(self) -> str:
        """The kv_dtype tag a request gets when it does not ask for one:
        the pool's own rung, and "fp32" (its storage width) on a mixed
        pool, where "fp8" is the tenant's opt-in."""
        return "fp32" if self.kv_dtype == "mixed" else self.kv_dtype

    def chain_seed(self, tag: Optional[str]) -> int:
        """Prefix-chain seed of a kv-dtype tag: the native tag keeps the
        fixed seed, any other tag folds itself in, so pages of two
        precisions never share a chain (the JAX package's rule, with a
        CRC-32 of the tag where JAX takes a per-process `hash`)."""
        if tag is None or tag == self.native_kv_tag():
            return _CHAIN_SEED
        return page_content_hash(_CHAIN_SEED, (zlib.crc32(tag.encode()),))

    def tag_pages(self, pages: Sequence[int], tag: str) -> None:
        """Stamp freshly allocated pages with their owner's kv-dtype tag
        (the auditor's bijection reads the tags). On a mixed pool this
        also sets the pages' bit in every layer's tag plane (in place on
        the current stream), which steers the write path: fp8-tagged
        pages get the fp8 round trip."""
        if not pages:
            return
        for p in pages:
            self.allocator._tags[p] = tag
        if self.kv_dtype == "mixed":
            for shard in self.shards:
                idx = torch.tensor(list(pages), dtype=torch.long,
                                   device=shard[0][2].device)
                for layer in shard:
                    layer[2][idx] = tag == "fp8"

    def page_tag(self, page: int) -> Optional[str]:
        return self.allocator._tags.get(page)

    def enable_prefix_cache(self) -> PrefixCache:
        """Turn on shared-prefix page caching (idempotent)."""
        if self.prefix_cache is None:
            self.prefix_cache = PrefixCache(self)
            self.allocator.evictor = self.prefix_cache
            if self.host_tier is not None:
                self.prefix_cache.evict_hook = self.host_tier.on_evict
        return self.prefix_cache

    def enable_host_tier(self, max_pages: int, metrics=None,
                         async_spill: bool = False, store=None,
                         owner: str = "engine") -> HostKVTier:
        """Turn on the host-RAM tier (idempotent): preemption spills
        exclusively owned pages to host buffers, and prefix-cache eviction
        demotes cached pages through evict_hook instead of dropping them.
        ``async_spill`` moves the wait for a spill's copies onto a worker
        thread. ``store`` backs the tier with a host-wide SharedKVStore
        under this engine's ``owner`` tag instead of private buffers:
        spills publish tier-wide, admission matches every replica's
        demotions, and handoffs move slot references instead of bytes."""
        if self.host_tier is None:
            self.host_tier = HostKVTier(self, max_pages, metrics=metrics,
                                        async_spill=async_spill,
                                        store=store, owner=owner)
            if self.prefix_cache is not None:
                self.prefix_cache.evict_hook = self.host_tier.on_evict
        return self.host_tier

    def gather_pages(self, pages: Sequence[int]) -> List[Tuple]:
        """The named pages across every layer's pool arrays, gathered into
        fresh tensors on the pool's device (on the current stream, no
        sync): a snapshot later in-place writes of the pool cannot reach.
        Gathered as bytes, so fp8 and bool planes move like any page. A
        sharded pool's shards are joined on the head axis on the first
        shard's device: the logical layout."""
        got = []
        for shard in self.shards:
            idx = torch.tensor(list(pages), dtype=torch.long,
                               device=shard[0][0].device)
            got.append([tuple(_bytes(a).index_select(0, idx).view(a.dtype)
                              for a in layer) for layer in shard])
        if self.tp_size == 1:
            return got[0]
        return [tuple(got[0][li][j] if self._is_tag(j) else torch.cat(
                    [g[li][j].to(self.device) for g in got],
                    dim=self._head_axis(j))
                      for j in range(len(layer)))
                for li, layer in enumerate(got[0])]

    def read_pages(self, pages: Sequence[int]
                   ) -> List[Tuple[torch.Tensor, ...]]:
        """Host (CPU) copies of the named pages across every layer's pool
        arrays: one gather a pool array, then one blocking copy each."""
        return [tuple(a.cpu() for a in layer)
                for layer in self.gather_pages(pages)]

    def write_pages(self, pages: Sequence[int], layer_data) -> None:
        """Scatter page contents into the named pages, IN PLACE on the
        current stream: the fence half of a page-in. ``layer_data`` is in
        the logical layout (`page_layout`), per layer a tuple of
        [len(pages), *page_shape] tensors (staged on the device by the
        engine, or CPU tensors), cast to the pool array's dtype when they
        differ; a sharded pool takes each shard's head slice."""
        for s, shard in enumerate(self.shards):
            dev = shard[0][0].device
            idx = torch.tensor(list(pages), dtype=torch.long, device=dev)
            for layer, data in zip(shard, layer_data):
                for j, (a, d) in enumerate(zip(layer, data)):
                    d = torch.as_tensor(d)
                    if self.tp_size > 1 and not self._is_tag(j):
                        ax = self._head_axis(j)
                        n = a.shape[ax]
                        d = d.narrow(ax, s * n, n)
                    d = d.to(device=dev, dtype=a.dtype)
                    _bytes(a).index_copy_(0, idx, _bytes(d.contiguous()))

    def copy_page(self, src: int, dst: int) -> None:
        """Copy page ``src`` into page ``dst`` across every layer's pools
        of every shard, IN PLACE on the current stream: the data move
        behind a copy-on-write fork. Pages move as opaque bytes, so on an
        int8 pool the scale rows ([num_blocks, n_kv], page-indexed like
        the codes) travel with the codes, and on a mixed pool the tag bits
        (the fork is tagged again with its owner's tag right after)."""
        for shard in self.shards:
            for layer in shard:
                for t in layer:
                    v = t.view(torch.uint8)
                    v[dst].copy_(v[src])

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Pages needed to hold n_tokens KV entries."""
        return max(1, -(-n_tokens // self.block_size))

    def pad_table(self, pages: List[int], max_pages: int) -> List[int]:
        """Fixed-width table row; unused entries point at the scratch page
        (their keys are masked by position, never read)."""
        if len(pages) > max_pages:
            raise ValueError(f"sequence needs {len(pages)} pages > "
                             f"max_pages_per_seq={max_pages}")
        return list(pages) + [SCRATCH_PAGE] * (max_pages - len(pages))

    def utilization(self) -> float:
        a = self.allocator
        return 1.0 - a.num_free / a.num_usable

    def page_bytes(self) -> int:
        """Device bytes ONE page occupies across all layers and both
        pools: int8 code bytes PLUS scale bytes on an int8 pool, one byte
        per element on an fp8 pool, the logical dtype's itemsize
        otherwise, plus the page's tag bit on a mixed pool (counted as
        the JAX package counts it, one byte)."""
        per_kv = self.block_size * self.n_kv_heads * self.head_dim
        if self.kv_dtype == "int8":
            return 2 * self.num_layers * (per_kv + self.n_kv_heads * 4)
        if self.kv_dtype == "fp8":
            return 2 * self.num_layers * per_kv
        base = 2 * self.num_layers * per_kv * self.dtype.itemsize
        return base + 1 if self.kv_dtype == "mixed" else base

    def unquantized_page_bytes(self) -> int:
        """What the same page costs stored at the logical dtype."""
        return (2 * self.num_layers * self.block_size * self.n_kv_heads
                * self.head_dim * self.dtype.itemsize)

    def kv_bytes_reduction_x(self) -> float:
        """Per-page byte reduction against the unquantized pool, scale
        bytes counted (1.0 on fp32 pools): also the factor by which a
        fixed device-memory budget holds more pages, i.e. sessions."""
        return self.unquantized_page_bytes() / self.page_bytes()

    def memory_bytes(self) -> int:
        """Pool bytes as stored, across the whole mesh (sharding never
        changes it): codes plus scales on an int8 pool."""
        return self.num_blocks * self.page_bytes()

    def per_shard_memory_bytes(self) -> int:
        """Pool bytes ONE model shard holds: memory_bytes() // tp, as the
        JAX package counts it."""
        return self.memory_bytes() // self.tp_size


class SequenceKV:
    """Host-side per-sequence cache state: the owned pages and how many
    token positions are live. Appending crosses page boundaries lazily —
    `pages_short()` reports the deficit the scheduler must fund (or
    preempt to fund) before the next decode step.

    With the prefix cache on, the leading pages may be SHARED (mapped from
    the cache at admission); `registered_pages` / `hash_chain` track how
    far this sequence's full pages have been pushed into the cache, and
    `ensure_writable` forks any shared page before a write lands on it.
    ``kv_tag`` is the sequence's effective kv-dtype (the per-request
    override on a mixed pool, the pool's own rung otherwise): every page
    it allocates is tagged with it."""

    def __init__(self, pool: KVCachePool, kv_tag: Optional[str] = None):
        self.pool = pool
        self.kv_tag = kv_tag or pool.native_kv_tag()
        self.pages: List[int] = []
        self.num_tokens = 0
        self.registered_pages = 0          # leading pages already cached
        self.hash_chain: List[int] = []    # chain hash per registered page

    def adopt_prefix(self, matched: List[Tuple[int, int]],
                     block_size: int) -> None:
        """Map an ALREADY-ACQUIRED PrefixCache match as this sequence's
        leading pages: their KV is live, so prefill starts after them."""
        self.pages = [page for _, page in matched]
        self.hash_chain = [h for h, _ in matched]
        self.registered_pages = len(matched)
        self.num_tokens = len(matched) * block_size

    def pages_short(self, upcoming_tokens: int = 1) -> int:
        need = self.pool.blocks_for_tokens(self.num_tokens + upcoming_tokens)
        return max(0, need - len(self.pages))

    def grow(self, upcoming_tokens: int = 1) -> None:
        short = self.pages_short(upcoming_tokens)
        if short:
            fresh = self.pool.allocator.alloc(short)
            self.pages.extend(fresh)
            self.pool.tag_pages(fresh, self.kv_tag)   # tagged at alloc

    def truncate(self, num_tokens: int) -> int:
        """Roll back over-committed tail pages: keep the pages covering
        ``num_tokens`` live positions and decref the rest. A verify span's
        rejected tail and a decode horizon's pre-committed pages come back
        here; both were grown for the span and never registered or
        shared, so they go straight back to the free list. Refuses to drop
        a registered page (cached pages cannot be speculative). Returns
        the pages dropped."""
        keep = self.pool.blocks_for_tokens(max(num_tokens, 1))
        if keep < self.registered_pages:
            raise ValueError(
                f"truncate({num_tokens}) would drop registered page "
                f"{keep} < {self.registered_pages}: cached pages cannot be "
                "speculative")
        dropped = self.pages[keep:]
        if dropped:
            del self.pages[keep:]
            self.pool.allocator.free(dropped)
        self.num_tokens = num_tokens
        return len(dropped)

    def ensure_writable(self, start_tok: int, end_tok: int) -> int:
        """Copy-on-write guard for a write covering token positions
        [start_tok, end_tok): every touched page with refcount > 1 (shared
        with another sequence or held by the prefix cache) is forked: a
        fresh page, its K/V (and int8 scale rows) copied in place on the
        current stream, the table entry swapped, the old reference
        dropped. Returns the number of pages forked."""
        if end_tok <= start_tok:
            return 0
        alloc = self.pool.allocator
        bs = self.pool.block_size
        forked = 0
        for idx in range(start_tok // bs, (end_tok - 1) // bs + 1):
            page = self.pages[idx]
            if alloc.refcount(page) > 1:
                new = alloc.alloc(1)[0]
                self.pool.copy_page(page, new)
                self.pool.tag_pages([new], self.kv_tag)
                alloc.decref(page)
                self.pages[idx] = new
                # the fork is private and will diverge: it leaves this
                # sequence's registered chain
                if idx < self.registered_pages:
                    self.registered_pages = idx
                    del self.hash_chain[idx:]
                forked += 1
        return forked

    def release(self) -> None:
        if self.pages:
            self.pool.allocator.free(self.pages)   # decref each
        self.pages = []
        self.num_tokens = 0
        self.registered_pages = 0
        self.hash_chain = []
