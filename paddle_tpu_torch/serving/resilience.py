"""Failure vocabulary and the invariant auditor of the serving engine.

Counterpart of paddle_tpu/serving/resilience.py, limited to the state
this port has: one fp32 pool, no prefix cache, no host tier, no in-flight
launches. The fault injector and snapshot/restore are not ported yet
(ROADMAP.md 'Still to port' item 15).
"""

from __future__ import annotations

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
    slots partition between running requests and the free list. Raises
    InvariantViolation listing every broken invariant. Host work only."""
    alloc = engine.pool.allocator
    sched = engine.scheduler
    problems = []

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
        cap = engine.pool.blocks_for_tokens(req.num_context + 1)
        if len(pages) > cap:
            problems.append(f"{rid} holds {len(pages)} pages > {cap} needed "
                            "for its context plus one token")
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

    # -- waiting requests hold no device resources
    for req in sched.waiting:
        if req.kv is not None or req.slot is not None:
            problems.append(f"{req.request_id} WAITING but holds kv/slot")

    if problems:
        raise InvariantViolation("; ".join(problems))
