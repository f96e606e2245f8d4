"""Paged KV-cache pool + block allocator for the serving engine.

Counterpart of paddle_tpu/serving/kv_cache.py for one device. Per layer
a tuple of [num_blocks, block_size, n_kv_heads, head_dim] pools, block
tables of int32 page ids. Page 0 is RESERVED as scratch: dead batch
slots and padded prefill positions write there, so the allocator never
hands it out and no live sequence reads it.

Three storage rungs (``kv_dtype``):
  "fp32"  (k_pool, v_pool) fp32;
  "int8"  (k_codes, v_codes, k_scale, v_scale): int8 codes and one fp32
          scale per page per kv head ([num_blocks, n_kv]), written by
          `quantized_page_write`;
  "fp8"   (k_pool, v_pool) float8_e4m3fn, written by `fp8_page_write`.

The pools live on the engine's device and are written IN PLACE by the
runner (the JAX package threads them functionally); see model_runner.
The fp8 casts apply ml_dtypes' overflow rule on every device (|x| > 464
and +-inf become NaN), where torch's own cast saturates to +-448.
Not ported yet (ROADMAP.md 'Still to port'): the prefix cache with
copy-on-write (item 5), the "mixed" pool with per-request tags (item 8),
the host tier (item 9) and mesh-sharded pools (item 10).
"""

from __future__ import annotations

from bisect import insort
from typing import Dict, List, Optional

import torch

from paddle_tpu_torch.device import resolve_device

SCRATCH_PAGE = 0

# int8 symmetric quantization range of the quantized KV pools
KV_QMAX = 127.0

# the pool storage rungs of the JAX package; "mixed" is not ported
KV_DTYPES = ("fp32", "int8", "fp8", "mixed")

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


def check_kv_dtype(kv_dtype: str, context: str) -> None:
    """Refuse a kv_dtype the port does not serve: unknown names raise
    ValueError, "mixed" NotImplementedError naming its ROADMAP item."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype={kv_dtype!r}; expected one of "
                         f"{KV_DTYPES}")
    if kv_dtype == "mixed":
        raise NotImplementedError(
            f"{context}(kv_dtype='mixed'): the mixed pool with per-request "
            "kv-dtype tags is not ported yet: ROADMAP.md 'Still to port' "
            "item 8 (quantized serving)")
    if kv_dtype == "fp8":
        require_fp8(f"{context}(kv_dtype='fp8')")


class KVCachePool:
    """The device-side page pool: per-layer pool tuples + the allocator.

    The pools live on ``device`` ("cuda" unless the caller passes "cpu";
    keyword-only, after the JAX parameters). ``dtype`` is the logical
    (compute) dtype, fp32; ``kv_dtype`` the storage rung (module
    docstring). ``mesh`` and ``model_axis`` sit in the JAX places; a mesh
    raises (sharded pools are ROADMAP.md item 10). Block tables live
    host-side as python lists per sequence; `pad_table` builds the
    fixed-width operand."""

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 n_kv_heads: int, head_dim: int, dtype=torch.float32,
                 mesh=None, model_axis: str = "model",
                 kv_dtype: str = "fp32", *, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "KVCachePool(mesh=...): pools sharded over a mesh's model "
                "axis are not ported yet: ROADMAP.md 'Still to port' item "
                "10 (tensor-parallel serving)")
        if dtype != torch.float32:
            raise NotImplementedError(
                f"KVCachePool(dtype={dtype}): only fp32 is ported as the "
                "logical dtype; lower-precision serving is ROADMAP.md "
                "'Still to port' item 8 (quantized serving)")
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
        self.device = resolve_device(device)
        self.allocator = BlockAllocator(num_blocks)
        shape = (num_blocks, block_size, n_kv_heads, head_dim)

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=self.device)

        if kv_dtype == "int8":
            sshape = (num_blocks, n_kv_heads)  # one scale per page per head
            self.pools = [(zeros(shape, torch.int8), zeros(shape, torch.int8),
                           zeros(sshape, torch.float32),
                           zeros(sshape, torch.float32))
                          for _ in range(num_layers)]
        else:
            store = torch.float8_e4m3fn if kv_dtype == "fp8" else dtype
            self.pools = [(zeros(shape, store), zeros(shape, store))
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
        """Device bytes ONE page occupies across all layers and both
        pools: int8 code bytes PLUS scale bytes on an int8 pool, one byte
        per element on an fp8 pool."""
        per_kv = self.block_size * self.n_kv_heads * self.head_dim
        if self.kv_dtype == "int8":
            return 2 * self.num_layers * (per_kv + self.n_kv_heads * 4)
        if self.kv_dtype == "fp8":
            return 2 * self.num_layers * per_kv
        return 2 * self.num_layers * per_kv * self.dtype.itemsize

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
        """Pool bytes as stored: codes plus scales on an int8 pool."""
        return self.num_blocks * self.page_bytes()


class SequenceKV:
    """Host-side per-sequence cache state: the owned pages and how many
    token positions are live. Appending crosses page boundaries lazily —
    `pages_short()` reports the deficit the scheduler must fund (or
    preempt to fund) before the next decode step."""

    def __init__(self, pool: KVCachePool, kv_tag: Optional[str] = None):
        if kv_tag is not None:
            raise NotImplementedError(
                f"SequenceKV(kv_tag={kv_tag!r}): per-sequence kv-dtype tags "
                "belong to the mixed pool, ROADMAP.md 'Still to port' item 8 "
                "(quantized serving)")
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

    def truncate(self, num_tokens: int) -> int:
        """Roll back over-committed tail pages: keep the pages covering
        ``num_tokens`` live positions and free the rest (a decode horizon's
        pre-committed pages, when non-finite logits cut it short). The
        dropped pages were grown for the horizon and never shared, so they
        go straight back to the free list. Returns the pages dropped."""
        keep = self.pool.blocks_for_tokens(max(num_tokens, 1))
        dropped = self.pages[keep:]
        if dropped:
            del self.pages[keep:]
            self.pool.allocator.free(dropped)
        self.num_tokens = num_tokens
        return len(dropped)

    def release(self) -> None:
        if self.pages:
            self.pool.allocator.free(self.pages)   # decref each
        self.pages = []
        self.num_tokens = 0
