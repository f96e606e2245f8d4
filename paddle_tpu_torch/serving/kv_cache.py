"""Paged KV-cache pool + block allocator for the serving engine.

Counterpart of paddle_tpu/serving/kv_cache.py for fp32 pools on one
device. Per layer a (k_pool, v_pool) pair of [num_blocks, block_size,
n_kv_heads, head_dim] tensors, block tables of int32 page ids. Page 0 is
RESERVED as scratch: dead batch slots and padded prefill positions write
there, so the allocator never hands it out and no live sequence reads it.

The pools live on the engine's device and are written IN PLACE by the
runner (the JAX package threads them functionally); see model_runner.
Not ported yet (ROADMAP.md 'Still to port'): the prefix cache with
copy-on-write (item 5), quantized and mixed pools (items 1, 8), the host
tier (item 9) and mesh-sharded pools (item 10).
"""

from __future__ import annotations

from bisect import insort
from typing import Dict, List

import torch

from paddle_tpu_torch.device import resolve_device

SCRATCH_PAGE = 0


class BlockAllocator:
    """Deterministic refcounted free-list page allocator.

    Pages are handed out lowest-id-first (sorted free list) so a given
    request trace always produces the same block tables. Page 0 (scratch)
    is never allocatable. `alloc` hands a page out at refcount 1; `free`
    is decref-each, and a page returns to the free list when its count
    hits zero. Over-release raises (the double-free guard)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is scratch)")
        self.num_blocks = num_blocks
        self._free = list(range(1, num_blocks))  # ascending
        self._ref: Dict[int, int] = {}           # page -> refcount (>= 1)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_usable(self) -> int:
        """Total allocatable pages (excludes the scratch page)."""
        return self.num_blocks - 1

    @property
    def allocated_pages(self) -> frozenset:
        """Read-only view of the live pages (resilience.audit_engine)."""
        return frozenset(self._ref)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: need {n} pages, {len(self._free)} free")
        pages, self._free = self._free[:n], self._free[n:]
        for p in pages:
            self._ref[p] = 1
        return pages

    def decref(self, page: int) -> int:
        if page not in self._ref:
            raise ValueError(f"double free of page {page}")
        self._ref[page] -= 1
        rc = self._ref[page]
        if rc == 0:
            del self._ref[page]
            insort(self._free, page)   # keep sorted: allocation stays
        return rc                      # deterministic

    def free(self, pages: List[int]) -> None:
        for p in pages:
            self.decref(p)

    def check_no_leaks(self) -> bool:
        return not self._ref and len(self._free) == self.num_usable


class KVCachePool:
    """The device-side page pool: per-layer (k, v) pools + the allocator.

    The pools live on ``device`` ("cuda" unless the caller passes "cpu").
    Block tables live host-side as python lists per sequence;
    `pad_table` builds the fixed-width operand."""

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 n_kv_heads: int, head_dim: int, dtype=torch.float32,
                 device="cuda"):
        if dtype != torch.float32:
            raise NotImplementedError(
                f"KVCachePool(dtype={dtype}): only fp32 pools are ported; "
                "quantized and fp8 pools are ROADMAP.md 'Still to port' "
                "item 8 (quantized serving)")
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.device = resolve_device(device)
        self.allocator = BlockAllocator(num_blocks)
        shape = (num_blocks, block_size, n_kv_heads, head_dim)
        self.pools = [(torch.zeros(shape, dtype=dtype, device=self.device),
                       torch.zeros(shape, dtype=dtype, device=self.device))
                      for _ in range(num_layers)]

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
        """Device bytes ONE page occupies across all layers and both pools."""
        return (2 * self.num_layers * self.block_size * self.n_kv_heads
                * self.head_dim * self.dtype.itemsize)

    def memory_bytes(self) -> int:
        return self.num_blocks * self.page_bytes()


class SequenceKV:
    """Host-side per-sequence cache state: the owned pages and how many
    token positions are live. Appending crosses page boundaries lazily —
    `pages_short()` reports the deficit the scheduler must fund (or
    preempt to fund) before the next decode step."""

    def __init__(self, pool: KVCachePool):
        self.pool = pool
        self.pages: List[int] = []
        self.num_tokens = 0

    def pages_short(self, upcoming_tokens: int = 1) -> int:
        need = self.pool.blocks_for_tokens(self.num_tokens + upcoming_tokens)
        return max(0, need - len(self.pages))

    def grow(self, upcoming_tokens: int = 1) -> None:
        short = self.pages_short(upcoming_tokens)
        if short:
            self.pages.extend(self.pool.allocator.alloc(short))

    def release(self) -> None:
        if self.pages:
            self.pool.allocator.free(self.pages)   # decref each
        self.pages = []
        self.num_tokens = 0
