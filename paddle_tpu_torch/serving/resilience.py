"""Failure vocabulary and the invariant auditor of the serving engine.

Counterpart of paddle_tpu/serving/resilience.py, limited to the state
this port has: one fp32, int8 or fp8 pool, no prefix cache, no host
tier, at most one in-flight launch (the pipelined loop). The fault
injector and snapshot/restore are
not ported yet (ROADMAP.md 'Still to port' item 15).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.serving.kv_cache import SCRATCH_PAGE


class QueueFullError(RuntimeError):
    """add_request rejected: bounded queue full under shed_policy='reject'."""


class InvariantViolation(AssertionError):
    """Engine state is internally inconsistent (leak / double-own / slot
    corruption). Raised by audit_engine; always a bug, never load."""


def audit_engine(engine) -> None:
    """Assert that page accounting, slot assignment and block tables are
    mutually consistent — the opt-in post-step check
    (ServingEngine(..., audit=True) or PADDLE_TPU_SERVING_AUDIT=1).

    A page's refcount equals the number of sequences mapping it, every
    allocated page has an owner (no leaks), a page appears at most once
    in one table, each running sequence holds the pages its live tokens
    need and no more than its context plus one upcoming token needs, and
    slots partition between running requests and the free list, and the
    pool's layer tuples have the layout of its kv_dtype. A member of the
    pipelined loop's in-flight launch may also hold the pages its
    undrained horizon was funded. Raises InvariantViolation listing every
    broken invariant. Host work only."""
    alloc = engine.pool.allocator
    sched = engine.scheduler
    problems = []
    inflight = getattr(engine, "_inflight", None)
    inflight_horizon = ({id(r): inflight.s for r, _ in inflight.batch}
                        if inflight is not None else {})

    # -- allocator self-consistency
    free_list = list(alloc._free)
    fset, aset = set(free_list), set(alloc._ref)
    if len(free_list) != len(fset):
        problems.append("duplicate pages in the free list")
    if fset & aset:
        problems.append(f"pages both free and allocated: {sorted(fset & aset)}")
    if SCRATCH_PAGE in (fset | aset):
        problems.append("scratch page entered the allocator")
    expected = set(range(1, alloc.num_blocks))
    if (fset | aset) != expected:
        problems.append(
            f"page accounting broken: lost={sorted(expected - fset - aset)} "
            f"foreign={sorted((fset | aset) - expected)}")

    # -- ownership: allocated pages == running sequences' pages
    owner_counts: dict = {}
    for req in sched.running:
        if req.kv is None:
            problems.append(f"{req.request_id} RUNNING without kv state")
            continue
        rid, pages = req.request_id, req.kv.pages
        if SCRATCH_PAGE in pages:
            problems.append(f"{rid} block table maps the scratch page")
        if len(set(pages)) != len(pages):
            problems.append(f"{rid} maps the same page twice")
        if req.kv.num_tokens > req.num_context:
            problems.append(f"{rid} kv covers {req.kv.num_tokens} tokens > "
                            f"context {req.num_context}")
        if req.phase not in ("prefill", "decode"):
            problems.append(f"{rid} unknown phase {req.phase!r}")
        elif (req.phase == "decode"
                and req.kv.num_tokens < req.num_context - 1):
            problems.append(f"{rid} decode-phase but kv covers only "
                            f"{req.kv.num_tokens} of {req.num_context} "
                            "context tokens")
        need = engine.pool.blocks_for_tokens(max(1, req.kv.num_tokens))
        if len(pages) < need:
            problems.append(f"{rid} under-provisioned: {len(pages)} pages "
                            f"< {need} needed for {req.kv.num_tokens} tokens")
        if len(pages) > engine.max_pages_per_seq:
            problems.append(f"{rid} holds {len(pages)} pages > "
                            "max_pages_per_seq")
        upcoming = 1 + inflight_horizon.get(id(req), 0)
        cap = engine.pool.blocks_for_tokens(req.num_context + upcoming)
        if len(pages) > cap:
            problems.append(f"{rid} holds {len(pages)} pages > {cap} needed "
                            f"for its context plus {upcoming} tokens "
                            "(horizon pages survived their step)")
        for p in pages:
            owner_counts[p] = owner_counts.get(p, 0) + 1
    if set(owner_counts) != aset:
        problems.append(
            f"page leak: allocated-but-unowned="
            f"{sorted(aset - set(owner_counts))} owned-but-not-allocated="
            f"{sorted(set(owner_counts) - aset)}")
    for p, n in owner_counts.items():
        if alloc._ref.get(p) != n:
            problems.append(f"page {p} refcount {alloc._ref.get(p)} != "
                            f"{n} owners")

    # -- slot accounting
    slots = [r.slot for r in sched.running]
    if any(s is None for s in slots):
        problems.append("RUNNING request without a slot")
    elif len(set(slots)) != len(slots):
        problems.append(f"slot assigned twice: {sorted(slots)}")
    else:
        sset, free_slots = set(slots), list(sched._free_slots)
        if (len(free_slots) != len(set(free_slots))
                or (sset | set(free_slots)) != set(range(sched.max_batch_size))
                or sset & set(free_slots)):
            problems.append(f"slot accounting broken: used={sorted(sset)} "
                            f"free={sorted(free_slots)}")

    # -- pool layout: an int8 pool's layer tuples carry int8 code pools
    #    and ONE fp32 scale per page per kv head; an fp8 pool stores
    #    float8 pages and carries NO scale rows (fp8 casts are scale-free);
    #    an fp32 pool the plain (k, v) pairs
    pool = engine.pool
    want_len = 4 if pool.kv_dtype == "int8" else 2
    want_dtype = {"int8": torch.int8,
                  "fp8": torch.float8_e4m3fn}.get(pool.kv_dtype,
                                                  torch.float32)
    for li, layer in enumerate(pool.pools):
        if len(layer) != want_len:
            problems.append(f"layer {li} pool tuple has {len(layer)} entries "
                            f"!= {want_len} for kv_dtype={pool.kv_dtype}")
            continue
        for nm, arr in zip("kv", layer[:2]):
            if arr.dtype != want_dtype:
                problems.append(f"layer {li} {nm}-pool dtype {arr.dtype} != "
                                f"{want_dtype} on a {pool.kv_dtype} pool")
        for nm, arr in zip("kv", layer[2:]):
            if (tuple(arr.shape) != (pool.num_blocks, pool.n_kv_heads)
                    or arr.dtype != torch.float32):
                problems.append(
                    f"layer {li} {nm}-scale pool {tuple(arr.shape)} "
                    f"{arr.dtype} != {(pool.num_blocks, pool.n_kv_heads)} "
                    "float32: one scale per page per kv head")

    # -- waiting requests hold no device resources
    for req in sched.waiting:
        if req.kv is not None or req.slot is not None:
            problems.append(f"{req.request_id} WAITING but holds kv/slot")

    if problems:
        raise InvariantViolation("; ".join(problems))
