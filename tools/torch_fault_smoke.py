#!/usr/bin/env python3
"""Fault drills of the port's process tier: replica processes behind a
ServingRouter(backend="process"), drilled with real signals and wire
faults, each class ending with nothing lost or delivered twice and every
stream equal to naive_generate on the parent's copy of the same seeded
Llama. The process-tier and network classes of tools/fault_smoke.py
(its --procs and --net drills) in the port.

    python3 tools/torch_fault_smoke.py [--device cpu] [--faults a,b]
        [--requests 8] [--layers 2] [--hidden 64]

Classes:

    none                  baseline: 2 mixed replica processes
    replica_sigkill       SIGKILL a child mid-decode: waitpid or socket-EOF
                          detection, a fresh child restored from the
                          snapshot and the registry
    replica_sigstop       SIGSTOP a child: the step heartbeat trips, the
                          fence SIGKILLs the stopped process, a fresh one
                          takes over
    handoff               1 prefill + 1 decode child: KV pages cross the
                          wire as bytes with their CRCs and page in
    handoff_prefill_kill  the prefill child dies mid-stream; its staged
                          requests regenerate from the registry
    router_kill           the ROUTER runs in a child of this tool,
                          journaling; SIGKILLed mid-stream, then
                          ServingRouter.recover(journal) over replica
                          processes finishes the streams
    frame_corrupt         corrupted idempotent request frames are NAK'd
                          and retried; a corrupted step frame fences the
                          child and the supervisor respawns it
    rpc_delay             idempotent replies land after the FAST deadline:
                          retried, the late replies discarded by sequence
                          number, the slow child never fenced
    conn_reset            the command connection dies under a step:
                          respawn

With `--shared-kv [N]` (N store pages, default 64) the tool runs the
host-wide KV store's drill instead (tools/fault_smoke.py --shared-kv): two
thread replicas over ONE SharedKVStore, a session workload whose second
turns resume from the store after a rolling restart, and one fault at the
store's weakest moment:

    none                  baseline: turn 2 pages in from the store
    replica_kill          a replica dies during turn 2: the supervisor
                          reaps its store refs (index-owned pages survive)
    router_kill           the router dies during turn 2 over a shared-
                          memory store: recover() reattaches the segments
                          and revives the journaled index
    corrupt_slot          an indexed slot's bytes are corrupted: the
                          auditor's spot check trips, scrub() drops the
                          entry, the turn recomputes it

Prints one JSON line per class; exits 0 iff every class is ok. On the
card (the default device) the children launch the port's kernels; with
--device cpu the children get CUDA_VISIBLE_DEVICES="" and run the plain
versions.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PROC_FAULTS = ("none", "replica_sigkill", "replica_sigstop", "handoff",
               "handoff_prefill_kill")
NET_FAULTS = ("router_kill", "frame_corrupt", "rpc_delay", "conn_reset")
SHARED_KV_FAULTS = ("none", "replica_kill", "router_kill", "corrupt_slot")
VOCAB = 97


def _spec(args):
    return {"factory": "paddle_tpu_torch.serving.replica:"
                       "model_runner_factory",
            "factory_kw": {
                "model": "llama", "seed": 0, "block_size": args.block_size,
                "max_model_len": args.max_model_len, "device": args.device,
                "vocab_size": VOCAB, "hidden_size": args.hidden,
                "num_layers": args.layers,
                "num_heads": max(2, args.hidden // 16),
                "max_seq_len": args.max_model_len}}


def _runner(args):
    """The parent's copy of the children's runner (the same seed)."""
    from paddle_tpu_torch.serving.replica import model_runner_factory
    return model_runner_factory(0, **_spec(args)["factory_kw"])


def _child_env(args):
    env = dict(os.environ)
    if args.device == "cpu":
        env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return env


def _engine_kw(args):
    return dict(num_blocks=args.num_blocks, max_batch_size=args.max_batch,
                max_model_len=args.max_model_len, max_step_retries=2,
                retry_backoff_s=0.001, audit=True, enable_prefix_cache=True,
                max_prefill_tokens_per_step=args.chunk,
                snapshot_every_steps=2)


def _workload(args, seed=0):
    from paddle_tpu_torch.serving import SamplingParams
    rng = np.random.default_rng(seed)
    header = [int(t) for t in rng.integers(1, VOCAB, 9)]
    work = []
    for i in range(args.requests):
        prompt = [int(t) for t in rng.integers(1, VOCAB,
                                               int(rng.integers(4, 20)))]
        if i % 2:
            prompt[:min(len(header), len(prompt) - 1)] = \
                header[:len(prompt) - 1]
        work.append((f"f{i}", prompt, SamplingParams(
            max_tokens=int(rng.integers(3, args.max_tokens)),
            temperature=0.7 if i % 4 == 0 else 0.0,
            seed=1000 + i if i % 4 == 0 else None)))
    return work


def _wait_tokens(router, n, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while (router.metrics.tokens_delivered.value < n
           and time.monotonic() < deadline):
        time.sleep(0.005)


def _verdict(router, work, outs, runner, args, crashed):
    """The common part of a class's record: lost requests, leaks, oracle
    equality and the tier's counters."""
    from paddle_tpu_torch.serving import naive_generate
    rm = router.metrics.snapshot()
    agg = router.metrics_snapshot()["engines"]
    router.release_prefix_caches()
    leaks_ok = router.check_no_leaks()
    oracle_ok = all(
        rid in outs and outs[rid].output_tokens == naive_generate(
            runner, p, sp, max_model_len=args.max_model_len)
        for rid, p, sp in work)
    return {"no_unhandled_exception": crashed is None, "crash": crashed,
            "requests": len(work),
            "requests_lost": sum(rid not in outs for rid, _, _ in work),
            "oracle_token_equal": oracle_ok, "pages_leaked": not leaks_ok,
            "replica_crashes": rm["replica_crashes"],
            "replica_hangs": rm["replica_hangs"],
            "replica_restarts": rm["replica_restarts"],
            "duplicate_tokens_dropped": rm["duplicate_tokens_dropped"],
            "recovered_requests": rm["recovered_requests"],
            "handoffs": rm["handoffs"],
            "handoff_fallbacks": rm["handoff_fallbacks"],
            "handoff_pages_in": agg.get("handoff_pages_in", 0),
            "handoff_recompute_fallbacks":
                agg.get("handoff_recompute_fallbacks", 0)}


def _warm(router, n):
    """Each child's first steps (graph captures on the card) before the
    drill, so the signals hit steps and the heartbeat window is honest."""
    from paddle_tpu_torch.serving import SamplingParams
    rng = np.random.default_rng(99)
    for w in range(n):
        router.submit([int(t) for t in rng.integers(1, VOCAB, 8)],
                      SamplingParams(max_tokens=2), request_id=f"warm-{w}")
    router.drain(timeout_s=600.0)


def run_proc_class(fault, runner, args):
    from paddle_tpu_torch.serving import ServingRouter, audit_router
    split = fault in ("handoff", "handoff_prefill_kill")
    router = ServingRouter(
        _spec(args), replicas=2, backend="process",
        child_env=_child_env(args), rendezvous_timeout_s=300.0,
        command_timeout_s=300.0, prefill_replicas=1 if split else 0,
        host_tier_pages=64 if split else 0,
        heartbeat_timeout_s=args.heartbeat if fault == "replica_sigstop"
        else 600.0, poll_interval_s=0.1, **_engine_kw(args))
    work, outs, crashed = _workload(args), {}, None
    try:
        _warm(router, 4)
        for rid, p, sp in work:
            router.submit(p, sp, request_id=rid)
        if fault in ("replica_sigkill", "handoff_prefill_kill",
                     "replica_sigstop"):
            _wait_tokens(router, 1 if fault == "handoff_prefill_kill"
                         else len(work))
            sig = (signal.SIGSTOP if fault == "replica_sigstop"
                   else signal.SIGKILL)
            # replica 0 is the prefill replica in the split drill
            os.kill(router._replicas[0].engine.proc.pid, sig)
        outs = router.drain(timeout_s=600.0)
        audit_router(router)
    except Exception as e:      # the drill's failure, reported
        crashed = f"{type(e).__name__}: {e}"
        outs = router.outputs()
    try:
        rec = _verdict(router, work, outs, runner, args, crashed)
    finally:
        router.shutdown()
    ok = (crashed is None and not rec["pages_leaked"]
          and rec["oracle_token_equal"] and rec["requests_lost"] == 0
          and (fault in ("none", "handoff") or rec["replica_restarts"] >= 1)
          and (fault != "replica_sigstop" or rec["replica_hangs"] >= 1)
          and (not split or rec["handoffs"] >= 1)
          and (fault != "handoff"
               or rec["handoff_recompute_fallbacks"] == 0))
    return {"fault": f"procs_{fault}", "ok": ok, **rec}


def _run_net_child(args) -> int:
    """--net-child: a journaling router over replica processes in THIS
    process; it submits the workload and serves until the parent SIGKILLs
    it (no teardown runs: the journal is what survives)."""
    from paddle_tpu_torch.serving import ServingRouter
    router = ServingRouter(
        _spec(args), replicas=2, backend="process",
        child_env=_child_env(args), rendezvous_timeout_s=300.0,
        command_timeout_s=300.0, journal_path=args.net_child,
        journal_fsync="interval", heartbeat_timeout_s=600.0,
        poll_interval_s=0.05, **_engine_kw(args))
    for rid, p, sp in _workload(args):
        router.submit(p, sp, request_id=rid)
    time.sleep(600.0)           # the parent kills us long before
    return 0


def run_router_kill(runner, args):
    """SIGKILL the router's process mid-stream, kill its orphaned
    replica children as the host would, and recover the tier from its
    journal over fresh replica processes."""
    from paddle_tpu_torch.serving import (
        RouterJournal, ServingRouter, audit_router,
    )
    journal = str(Path(tempfile.mkdtemp(prefix="torch_fault_smoke_"))
                  / "wal.jsonl")
    cmd = [sys.executable, os.path.abspath(__file__), "--net-child",
           journal, *sys.argv[1:]]
    # its own process group: the router and its replica children die
    # together, as a host's crash would take them
    proc = subprocess.Popen(cmd, env=dict(os.environ), stdout=2,
                            start_new_session=True)
    work = _workload(args)
    bar = max(4, sum(sp.max_tokens for _, _, sp in work) // 3)
    delivered, router, outs, crashed, recovery_s = 0, None, {}, None, -1.0
    try:
        deadline = time.monotonic() + 600.0
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                state, _ = RouterJournal.replay(journal)
                delivered = sum(len(r["tokens"])
                                for r in state["reqs"].values())
                submitted = len(state["reqs"])
            except (OSError, ValueError):
                delivered = submitted = 0
            # every request journaled (a submit waits for the replica's
            # lock between steps), a third of the tokens delivered
            if submitted == len(work) and delivered >= bar:
                break
            time.sleep(0.02)
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        t0 = time.monotonic()
        router = ServingRouter.recover(
            _spec(args), journal, replicas=2, backend="process",
            child_env=_child_env(args), rendezvous_timeout_s=300.0,
            command_timeout_s=300.0, heartbeat_timeout_s=600.0,
            poll_interval_s=0.05, **_engine_kw(args))
        outs = router.drain(timeout_s=600.0)
        recovery_s = time.monotonic() - t0
        audit_router(router)
    except Exception as e:
        crashed = f"{type(e).__name__}: {e}"
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(30)
    if router is None:
        return {"fault": "net_router_kill", "ok": False, "crash": crashed}
    try:
        rec = _verdict(router, work, outs, runner, args, crashed)
    finally:
        router.shutdown()
    ok = (crashed is None and rec["oracle_token_equal"]
          and not rec["pages_leaked"] and rec["requests_lost"] == 0
          and delivered > 0 and rec["recovered_requests"] >= 1)
    return {"fault": "net_router_kill", "ok": ok,
            "tokens_delivered_before_kill": delivered,
            "recovery_s": round(recovery_s, 3), **rec}


def run_wire_class(fault, runner, args):
    """One wire fault class over replica processes: the per-RPC deadlines
    and the idempotent-retry / fail-fast split."""
    from paddle_tpu_torch.serving import (
        ServingRouter, WireFaultInjector, audit_router,
    )
    router = ServingRouter(
        _spec(args), replicas=2, backend="process",
        child_env=_child_env(args), rendezvous_timeout_s=300.0,
        command_timeout_s=300.0, rpc_fast_timeout_s=0.5,
        heartbeat_timeout_s=600.0, poll_interval_s=0.1, **_engine_kw(args))
    client = router._replicas[0].engine
    work, outs, crashed, retried = _workload(args), {}, None, True
    try:
        _warm(router, 4)
        if fault == "frame_corrupt":
            # idempotent frames: NAK'd and retried, nothing fenced
            client.wire_faults = WireFaultInjector(corrupt_every=2,
                                                   target="idempotent")
            for _ in range(4):
                client.ping()
            retried = (client.rpc_stats["naks"] >= 2
                       and client.rpc_stats["retries"] >= 2
                       and not client.dead)
            # then a step frame: fail fast, the supervisor respawns
            client.wire_faults = WireFaultInjector(corrupt_calls=[3],
                                                   target="step")
        elif fault == "rpc_delay":
            client.wire_faults = WireFaultInjector(
                delay_every=3, delay_s=1.0, target="idempotent")
        elif fault == "conn_reset":
            client.wire_faults = WireFaultInjector(reset_calls=[4],
                                                   target="step")
        for rid, p, sp in work:
            router.submit(p, sp, request_id=rid)
        if fault == "rpc_delay":
            # a caller on the idempotent path while the tier decodes
            for _ in range(9):
                router.metrics_snapshot()
                time.sleep(0.05)
            retried = (client.rpc_stats["deadline_trips"] >= 1
                       and client.rpc_stats["retries"] >= 1)
        outs = router.drain(timeout_s=600.0)
        audit_router(router)
    except Exception as e:
        crashed = f"{type(e).__name__}: {e}"
        outs = router.outputs()
    stats = dict(client.rpc_stats)
    try:
        rec = _verdict(router, work, outs, runner, args, crashed)
    finally:
        router.shutdown()
    escalates = fault in ("frame_corrupt", "conn_reset")
    ok = (crashed is None and not rec["pages_leaked"]
          and rec["oracle_token_equal"] and retried
          and rec["requests_lost"] == 0
          and (not escalates or rec["replica_restarts"] >= 1)
          and (fault != "rpc_delay" or rec["replica_restarts"] == 0))
    return {"fault": f"net_{fault}", "ok": ok, "rpc_stats": stats,
            "retry_path_exercised": retried, **rec}


def run_shared_kv_class(fault: str, runner, args) -> dict:
    """One fault class of the host-wide store (module docstring): 2 thread
    replicas over ONE SharedKVStore, the sessions' turn 1, a rolling
    restart (the draining replicas demote their caches into the store),
    then turn 2 with the class's fault."""
    from paddle_tpu_torch.serving import (
        InvariantViolation, SamplingParams, ServingRouter, audit_router,
        audit_store, naive_generate,
    )

    rng = np.random.default_rng(0)
    jp = (tempfile.mktemp(suffix=".jsonl") if fault == "router_kill"
          else None)
    rkw = dict(replicas=2, num_blocks=args.num_blocks,
               max_batch_size=args.max_batch,
               max_model_len=args.max_model_len, max_step_retries=2,
               retry_backoff_s=0.001, audit=True, enable_prefix_cache=True,
               max_prefill_tokens_per_step=args.chunk or None,
               heartbeat_timeout_s=args.heartbeat, poll_interval_s=0.05,
               shared_kv_pages=args.shared_kv, snapshot_every_steps=1)
    if jp is not None:
        rkw.update(journal_path=jp, journal_fsync="always",
                   shared_kv_shm=True)

    def factory(idx=0):
        return _runner(args)
    router = ServingRouter(factory, **rkw)
    header = [int(t) for t in rng.integers(1, VOCAB, 2 * args.block_size)]
    work, t2, outs1, recovery = [], [], {}, {}
    crashed = dead_owner = spec = None
    try:
        for i in range(args.requests):
            prompt = header + [int(t) for t in rng.integers(
                1, VOCAB, int(rng.integers(2, 8)))]
            sp = SamplingParams(max_tokens=int(rng.integers(
                3, args.max_tokens)), session_id=f"s{i}")
            work.append((router.submit(prompt, sp), prompt, sp))
        outs1 = router.drain(timeout_s=600.0)
        audit_router(router)
        router.rolling_restart()
        store = router.kv_store
        recovery["store_prefix_pages"] = store.prefix_count
        if fault == "corrupt_slot":
            victim = next(iter(store._prefix.values()))
            store.bufs[0][0][victim] += 1.0
            try:
                audit_store(store)
                recovery["spot_check_tripped"] = False
            except InvariantViolation:
                recovery["spot_check_tripped"] = True
            recovery["scrubbed"] = store.scrub()
        for i, (rid, p, sp) in enumerate(work):
            p2 = p + outs1[rid].output_tokens
            sp2 = SamplingParams(max_tokens=4, session_id=f"s{i}")
            t2.append((router.submit(p2, sp2), p2, sp2))
        if fault == "replica_kill":
            dead_owner = router._replicas[0].store_owner
            router.kill_replica(0)
        elif fault == "router_kill":
            for rep in router._replicas:
                rep.fenced = True
                rep.stop = True
                rep.wake.set()
            router.supervisor.stop()
            router._journal.close()
            for rep in router._replicas:
                rep.thread.join(60)
            spec = router.kv_store.attach_spec()
            dead = router
            t0 = time.perf_counter()
            router = ServingRouter.recover(
                factory, jp, **{k: v for k, v in rkw.items()
                                if k != "journal_path"})
            dead.kv_store.close(unlink=False)
            recovery["router_recovery_s"] = time.perf_counter() - t0
            recovery["store_index_revived"] = router.kv_store.prefix_count
        outs = router.drain(timeout_s=600.0)
        audit_router(router)
    except Exception as e:          # must never happen: the point
        crashed = f"{type(e).__name__}: {e}"
        outs = router.outputs()
    rm = router.metrics.snapshot()
    agg = router.metrics_snapshot()["engines"]
    owners = (router.kv_store.owners_snapshot()
              if router.kv_store is not None else {})
    reaped = all(dead_owner not in own for own in owners.values())
    router.release_prefix_caches()
    leaks_ok = router.check_no_leaks()
    oracle_ok = all(
        (outs.get(rid) or outs1.get(rid)) is not None
        and (outs.get(rid) or outs1.get(rid)).output_tokens
        == naive_generate(runner, p, sp, max_model_len=args.max_model_len)
        for rid, p, sp in work + t2)
    router.shutdown()
    if spec is not None:
        from paddle_tpu_torch.serving import SharedKVStore
        SharedKVStore.unlink_spec(spec)     # a no-op after the shutdown
    if jp is not None and os.path.exists(jp):
        os.unlink(jp)
    ok = (crashed is None and leaks_ok and oracle_ok and reaped
          and all(o.finish_reason for o in outs.values())
          and recovery.get("store_prefix_pages", 0) > 0
          and agg["store_hit_pages"] > 0
          and (fault != "replica_kill" or rm["replica_restarts"] >= 1)
          and (fault != "router_kill"
               or recovery.get("store_index_revived", 0) > 0)
          and (fault != "corrupt_slot"
               or (recovery.get("spot_check_tripped")
                   and recovery.get("scrubbed", 0) >= 1)))
    return {"fault": f"shared_kv_{fault}", "ok": ok,
            "requests": len(work) + len(t2),
            "no_unhandled_exception": crashed is None, "crash": crashed,
            "oracle_token_equal": oracle_ok, "pages_leaked": not leaks_ok,
            "dead_owner_reaped": reaped,
            "store_hit_pages": agg["store_hit_pages"],
            "store_dedup_pages": agg["store_dedup_pages"],
            "replica_restarts": rm["replica_restarts"], **recovery}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--faults", default=",".join(PROC_FAULTS + NET_FAULTS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=4)
    ap.add_argument("--num-blocks", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-model-len", type=int, default=64)
    ap.add_argument("--max-tokens", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--heartbeat", type=float, default=15.0,
                    help="the sigstop class's heartbeat, seconds")
    ap.add_argument("--shared-kv", type=int, nargs="?", const=64, default=0,
                    help="run the host-wide store's drill over N store "
                         "pages (default 64)")
    ap.add_argument("--net-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.net_child:
        return _run_net_child(args)
    if args.device == "cpu":
        import torch
        torch.set_num_threads(1)
    runner = _runner(args)
    ok = True
    faults = [f for f in args.faults.split(",") if f]
    if args.shared_kv and args.faults == ap.get_default("faults"):
        faults = list(SHARED_KV_FAULTS)
    for fault in faults:
        if args.shared_kv:
            if fault not in SHARED_KV_FAULTS:
                raise SystemExit(f"unknown store fault class {fault!r}; "
                                 f"expected one of {SHARED_KV_FAULTS}")
            rec = run_shared_kv_class(fault, runner, args)
        elif fault in PROC_FAULTS:
            rec = run_proc_class(fault, runner, args)
        elif fault == "router_kill":
            rec = run_router_kill(runner, args)
        elif fault in NET_FAULTS:
            rec = run_wire_class(fault, runner, args)
        else:
            raise SystemExit(f"unknown fault class {fault!r}; expected one "
                             f"of {PROC_FAULTS + NET_FAULTS}")
        ok &= bool(rec["ok"])
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
