"""The port's process tier on the CPU: ReplicaLauncher, EngineClient and
ServingRouter(backend="process") over replica CHILD processes.

Ports the cases of tests/test_serving_procs.py (its TCPStore cases belong
to the JAX package's own store; the port's rendezvous is
`torch.distributed.TCPStore`) and the process cases of
tests/test_serving_durability.py (RPC deadlines and the transient / fatal
split against a scripted replica on a socket pair, bounded shutdown, the
process rolling restart, a corrupted frame retried on a live child, journal
recovery over processes). Replica processes stream EXACTLY what one engine
streams (greedy and seeded temperature), a SIGKILLed or SIGSTOPped child
is respawned with nothing lost or repeated, the rendezvous fails loudly
naming the missing rank, the prefill -> decode handoff crosses the wire as
page bytes, and a small Llama built in every child by
`replica.model_runner_factory` streams what the port's single engine and
the JAX single engine stream on the same weights.

Children run `_torch_stub.TorchStubRunner` (this module's
`stub_runner_factory`, imported in each child through the spec's
sys_path: nothing at this module's top imports jax) or the seeded Llama, on the CPU
(`CUDA_VISIBLE_DEVICES=""`, `OMP_NUM_THREADS=1`), and every router and
child is shut down and joined in a `finally`.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from _step_gate import StepGate
from _torch_stub import TorchStubRunner
from paddle_tpu_torch.serving import (
    ReplicaGoneError, SamplingParams, ServingEngine, ServingRouter,
    WireFaultInjector, audit_router, naive_generate,
)
from paddle_tpu_torch.serving import wire
from paddle_tpu_torch.serving.launch import EngineClient, ReplicaLauncher

torch.set_num_threads(1)

VOCAB, BLOCK, MAXLEN = 31, 4, 64
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
STUB_SPEC = {"factory": "test_torch_procs:stub_runner_factory",
             "factory_kw": {"vocab_size": VOCAB, "block_size": BLOCK,
                            "max_model_len": MAXLEN},
             "sys_path": [TESTS_DIR]}
ENGINE_KW = dict(num_blocks=24, max_batch_size=4, max_model_len=MAXLEN,
                 enable_prefix_cache=True, max_prefill_tokens_per_step=8)
# the stub's pool geometry, for a process tier's host-wide store
STORE_GEOMETRY = {"num_layers": 1, "block_size": BLOCK, "n_kv_heads": 1,
                  "head_dim": 1}
# six test workers share eight cores: the rendezvous deadline leaves room
TIER_KW = dict(backend="process", heartbeat_timeout_s=60.0,
               poll_interval_s=0.05, rendezvous_timeout_s=120.0)


def stub_runner_factory(index=0, vocab_size=VOCAB, block_size=BLOCK,
                        max_model_len=MAXLEN):
    """The replica children's factory (`STUB_SPEC`): the stub is
    deterministic, so every process computes the same streams."""
    return TorchStubRunner(vocab_size, block_size, max_model_len)


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


@pytest.fixture()
def proc_env(_audit_every_engine):
    """The children's environment: the CPU, one thread, the auditor on."""
    return dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                PADDLE_TPU_SERVING_AUDIT="1")


def workload(n=10, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = list(map(int, rng.integers(1, VOCAB,
                                            int(rng.integers(4, 16)))))
        sp = SamplingParams(
            max_tokens=int(rng.integers(3, 8)),
            temperature=0.5 if i % 3 == 0 else 0.0,
            seed=100 + i if i % 3 == 0 else None)
        out.append((prompt, sp))
    return out


def oracle(prompt, sp):
    return naive_generate(stub_runner_factory(), prompt, sp,
                          max_model_len=MAXLEN)


def _exact(outs, rids, work):
    assert len(outs) >= len(rids)
    for rid, (p, sp) in zip(rids, work):
        assert outs[rid].output_tokens == oracle(p, sp), rid


def _wait_tokens(router, n, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while (router.metrics.tokens_delivered.value < n
           and time.monotonic() < deadline):
        time.sleep(0.002)


def _children(router):
    return [rep.engine.proc for rep in router._replicas]


def _assert_reaped(procs):
    for p in procs:
        p.wait(10)
        assert p.poll() is not None


# ------------------------------------------------- rendezvous and spec


class TestRendezvous:
    def test_timeout_names_missing_rank(self, monkeypatch, proc_env):
        """A rank that never publishes its port is NAMED in the timeout,
        with its liveness. Both children are inert stand-ins: rank 0's
        port is published by hand, rank 1 stays silent."""
        launcher = ReplicaLauncher(STUB_SPEC, ENGINE_KW,
                                   rendezvous_timeout_s=2.0, env=proc_env)
        procs = []

        def inert(rank):
            proc = subprocess.Popen(
                [sys.executable, "-c", "import time; time.sleep(60)"])
            procs.append(proc)
            key = f"{launcher.session}/r{rank}e{launcher._epoch}"
            launcher._epoch += 1
            if rank == 0:       # rank 0 "arrives"; rank 1 never does
                launcher.store.set(f"{key}/port", "1")
            return proc, key

        monkeypatch.setattr(launcher, "_spawn_proc", inert)
        try:
            with pytest.raises(TimeoutError) as ei:
                launcher.spawn_all(["mixed", "mixed"])
            msg = str(ei.value)
            assert "rank 1" in msg and "alive but silent" in msg
            assert "1/2 replicas arrived" in msg
            assert "rendezvous timeout" in msg
            _assert_reaped(procs)     # the failed fleet is killed
        finally:
            for p in procs:
                p.kill()
                p.wait(10)
            launcher.close()

    def test_death_during_rendezvous_reports_exit_code(self, monkeypatch,
                                                       proc_env):
        launcher = ReplicaLauncher(STUB_SPEC, ENGINE_KW,
                                   rendezvous_timeout_s=30.0, env=proc_env)

        def die(rank):
            proc = subprocess.Popen([sys.executable, "-c",
                                     "import sys; sys.exit(7)"])
            launcher._epoch += 1
            return proc, f"{launcher.session}/r{rank}edead"

        monkeypatch.setattr(launcher, "_spawn_proc", die)
        try:
            with pytest.raises(ReplicaGoneError, match="exit code 7"):
                launcher.spawn(0)
        finally:
            launcher.close()

    @pytest.mark.parametrize("bad", ["engine_kw", "factory_kw", "callable"])
    def test_non_serializable_spec_is_loud(self, bad):
        """What crosses the process boundary is JSON: an object in
        engine_kw or factory_kw, or a callable factory, is a TypeError
        before any child starts."""
        spec, kw = dict(STUB_SPEC), dict(ENGINE_KW)
        if bad == "engine_kw":
            kw["sleep_fn"] = lambda s: None
        elif bad == "factory_kw":
            spec["factory_kw"] = {"model": object()}
        else:
            spec = stub_runner_factory
        with pytest.raises(TypeError, match="JSON"):
            ReplicaLauncher(spec, kw)
        with pytest.raises(TypeError, match="JSON"):
            ServingRouter(spec, replicas=1, backend="process", **kw)

    def test_repo_pythonpath_comes_from_the_package(self, tmp_path):
        """Children import the tree this process imported, from any
        working directory: the package's root leads PYTHONPATH, once."""
        import paddle_tpu_torch
        from paddle_tpu_torch.serving.launch import _repo_pythonpath
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(paddle_tpu_torch.__file__)))
        env = _repo_pythonpath({"PYTHONPATH": os.pathsep.join(
            [str(tmp_path), root])})
        assert env["PYTHONPATH"].split(os.pathsep) == [root, str(tmp_path)]

    def test_create_serving_router_process_raises_type_error_as_jax(self):
        """The model bridge builds a callable factory, which cannot cross a
        process boundary: both frameworks raise TypeError for
        backend="process"; the JSON spec serves it (the classes below)."""
        import paddle_tpu as paddle
        from paddle_tpu.inference import \
            create_serving_router as jax_create_serving_router
        from paddle_tpu.models.llama import Llama as JaxLlama
        from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
        from paddle_tpu_torch.inference import create_serving_router
        from paddle_tpu_torch.models import Llama, LlamaConfig
        sizes = dict(vocab_size=64, hidden_size=32, num_layers=1,
                     num_heads=2, max_seq_len=32)
        kw = dict(backend="process", replicas=1, block_size=8,
                  max_model_len=32, num_blocks=8)
        paddle.seed(0)
        with pytest.raises(TypeError):
            jax_create_serving_router(JaxLlama(JaxLlamaConfig(**sizes)),
                                      **kw)
        with pytest.raises(TypeError, match="JSON spec"):
            create_serving_router(Llama(LlamaConfig(**sizes),
                                        device="cpu"), device="cpu", **kw)

    @pytest.mark.parametrize("knob,value", [
        ("shared_kv_pages", 8), ("shared_kv_shm", True),
        ("shared_kv_geometry", {"num_layers": 1})])
    def test_shared_kv_knobs_raise_naming_part_b2(self, knob, value):
        """The host-wide store's knobs are served (the store tests below
        and tests/test_torch_shared_kv.py); what raises is a combination
        the process backend cannot serve, before any child starts:
        shared_kv_pages without a geometry (ValueError, as in JAX),
        shared_kv_shm=False (its children could not map the store), and
        a geometry the store cannot be built from (KeyError, as in JAX).
        The knobs alone, without pages, build no store."""
        jax_router = pytest.importorskip("paddle_tpu.serving.router")
        kw = {knob: value}
        if knob == "shared_kv_pages":
            bad = [(kw, ValueError, "shared_kv_geometry")]
        elif knob == "shared_kv_shm":
            bad = [(dict(kw, shared_kv_pages=8, shared_kv_shm=False,
                         shared_kv_geometry=STORE_GEOMETRY), ValueError,
                    "shared memory")]
        else:
            bad = [(dict(kw, shared_kv_pages=8), KeyError, "block_size")]
        for given, exc, match in bad:
            with pytest.raises(exc, match=match):
                ServingRouter(STUB_SPEC, replicas=2, backend="process",
                              **given, **ENGINE_KW)
            if exc is not ValueError or "geometry" in match:
                # the JAX router raises the same type for it
                with pytest.raises(exc):
                    jax_router.ServingRouter(
                        STUB_SPEC, replicas=2, backend="process",
                        **given, **ENGINE_KW)


# ------------------------------- RPC deadlines, retries and shutdown


class _FakeProc:
    pid = 4242

    def __init__(self):
        self.rc = None

    def poll(self):
        return self.rc

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc


class _ScriptedReplica:
    """A fake replica on the far end of a socket pair: one scripted
    behaviour per received message ('reply', 'ignore', ('late', s),
    'nak'), then replies normally forever."""

    def __init__(self, script):
        self.client_sock, self._sock = socket.socketpair()
        self.script = list(script)
        self.received = []
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        try:
            while True:
                header, _ = wire.recv_msg(self._sock)
                self.received.append(header["cmd"])
                beh = self.script.pop(0) if self.script else "reply"
                if beh == "ignore":
                    continue
                if isinstance(beh, tuple) and beh[0] == "late":
                    time.sleep(beh[1])
                    beh = "reply"
                if beh == "nak":
                    wire.send_msg(self._sock,
                                  {"ok": False, "error": "wire_corrupt",
                                   "seq": None, "message": "nak"})
                    continue
                wire.send_msg(self._sock,
                              {"ok": True, "seq": header.get("seq"),
                               "events": []})
        except (ConnectionError, OSError):
            return

    def close(self):
        for sock in (self._sock, self.client_sock):
            try:
                sock.shutdown(socket.SHUT_RDWR)    # wakes the serve loop
            except OSError:
                pass
            sock.close()
        self.thread.join(10)
        assert not self.thread.is_alive()


def make_client(script, **kw):
    srv = _ScriptedReplica(script)
    kw.setdefault("command_timeout_s", 0.6)
    kw.setdefault("rpc_fast_timeout_s", 0.3)
    kw.setdefault("rpc_backoff_s", 0.01)
    client = EngineClient(_FakeProc(), srv.client_sock, 0, "test", **kw)
    return client, srv


class TestRpcDeadlines:
    def test_every_rpc_deadline_is_finite(self):
        """The deadline table gives every command of the replica's
        vocabulary a finite positive deadline, the fast class shorter."""
        client, srv = make_client([])
        cmds = ("init", "ping", "submit", "abort", "step", "flush",
                "snapshot", "inject", "extract", "handoff_extract",
                "handoff_inject", "stage_migration",
                "release_prefix_cache", "check_no_leaks", "metrics",
                "audit", "requests", "shutdown")
        for cmd in cmds:
            assert 0 < client._deadline_for(cmd) < float("inf"), cmd
        assert client._deadline_for("ping") < client._deadline_for("step")
        srv.close()

    def test_idempotent_timeout_retries_then_succeeds(self):
        client, srv = make_client(["ignore"])   # first ping swallowed
        client.ping()
        assert client.rpc_stats["retries"] == 1
        assert client.rpc_stats["deadline_trips"] == 1
        assert not client.dead
        srv.close()

    def test_late_reply_discarded_by_seq(self):
        """The first reply arrives after the deadline: the retry drops the
        stale reply by its sequence number and takes the fresh one."""
        client, srv = make_client([("late", 0.6)])
        client.ping()
        assert client.rpc_stats["retries"] == 1
        assert client.rpc_stats["stale_replies"] >= 1
        srv.close()

    @pytest.mark.parametrize("match", [r"rpc 'step'", "deadline"])
    def test_mutating_timeout_fails_fast_naming_rpc(self, match):
        client, srv = make_client(["ignore"])
        with pytest.raises(ReplicaGoneError, match=match):
            client.step()
        assert client.rpc_stats["retries"] == 0
        assert client.dead
        srv.close()

    def test_nak_retries_idempotent_but_kills_mutating(self):
        client, srv = make_client(["nak"])
        client.ping()                    # NAK -> transparent retry
        assert client.rpc_stats["naks"] == 1
        assert client.rpc_stats["retries"] == 1
        srv.close()
        client2, srv2 = make_client(["nak"])
        with pytest.raises(ReplicaGoneError, match="CRC"):
            client2.step()
        srv2.close()

    def test_retry_budget_exhausts_to_replica_gone(self):
        client, srv = make_client(["ignore"] * 10, rpc_max_retries=2)
        with pytest.raises(ReplicaGoneError, match="2 retries"):
            client.ping()
        assert client.dead
        srv.close()

    def test_fenced_client_refuses_every_call(self):
        client, srv = make_client([])
        client.kill()
        with pytest.raises(ReplicaGoneError, match="already fenced"):
            client.ping()
        srv.close()


class TestShutdownBounded:
    def test_shutdown_bounded_when_child_ignores_command(self):
        client, srv = make_client(["ignore", "ignore", "ignore"])
        t0 = time.monotonic()
        client.shutdown(timeout_s=0.5)
        assert time.monotonic() - t0 < 2.0
        assert client.dead
        srv.close()

    def test_shutdown_bounded_with_stuck_reader_holding_lock(self):
        client, srv = make_client([])
        client._io_lock.acquire()        # a reader parked in a recv
        try:
            t0 = time.monotonic()
            client.shutdown(timeout_s=0.5)
            assert time.monotonic() - t0 < 2.0
            assert client.dead
        finally:
            client._io_lock.release()
            srv.close()

    def test_kill_never_touches_the_lock(self):
        client, srv = make_client([])
        client._io_lock.acquire()
        try:
            t0 = time.monotonic()
            client.kill(timeout_s=0.5)
            assert time.monotonic() - t0 < 1.0
        finally:
            client._io_lock.release()
            srv.close()


# ------------------------------------------------ the process backend


def _router(proc_env, spec=STUB_SPEC, replicas=2, **kw):
    merged = dict(TIER_KW, child_env=proc_env, **ENGINE_KW)
    merged.update(kw)
    return ServingRouter(spec, replicas=replicas, **merged)


class TestProcessRouter:
    def test_cross_process_token_exact_greedy_and_seeded(self, proc_env):
        """Replica processes stream what one engine streams; both serve,
        nothing is dropped twice, the auditor runs inside each child, and
        the children leak nothing and exit at shutdown."""
        router = _router(proc_env)
        procs = _children(router)
        try:
            work = workload(10)
            rids = [router.submit(p, sp) for p, sp in work]
            assert all(r.startswith("req-p") for r in rids)
            outs = router.drain(timeout_s=120.0)
            audit_router(router)
            _exact(outs, rids, work)
            assert len({o.replica for o in outs.values()}) == 2
            rm = router.metrics.snapshot()
            assert rm["duplicate_tokens_dropped"] == 0
            assert rm["requests_completed"] == len(rids)
            snap = router.metrics_snapshot()
            assert snap["engines"]["tokens_generated"] == sum(
                len(o.output_tokens) for o in outs.values())
            assert len(snap["per_replica"]) == 2
            router.release_prefix_caches()
            assert router.check_no_leaks()
        finally:
            router.shutdown()
        _assert_reaped(procs)

    @pytest.mark.parametrize("how", ["sigkill", "kill_replica"])
    def test_killed_child_respawns_zero_loss_zero_dup(self, proc_env, how):
        """A SIGKILL of a child process mid-decode (or the router's drill
        kill, which SIGKILLs it too): the supervisor sees the corpse
        (waitpid or a dead socket), spawns a FRESH process and restores it
        from the snapshot and the registry: nothing lost or repeated."""
        router = _router(proc_env, snapshot_every_steps=2)
        first = _children(router)
        try:
            work = workload(10)
            rids = [router.submit(p, sp) for p, sp in work]
            _wait_tokens(router, 8)
            if how == "sigkill":
                os.kill(first[0].pid, signal.SIGKILL)
            else:
                assert router.kill_replica(0)
            outs = router.drain(timeout_s=120.0)
            _exact(outs, rids, work)
            assert len(outs) == len(rids)
            # the kill may land after replica 0 finished its share: the
            # waitpid probe then respawns it in the background
            deadline = time.monotonic() + 60
            while (router.metrics.snapshot()["replica_restarts"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert router.metrics.snapshot()["replica_restarts"] >= 1
            assert router._replicas[0].engine.proc.pid != first[0].pid
            assert first[0].wait(10) == -signal.SIGKILL
            audit_router(router)
        finally:
            router.shutdown()
        _assert_reaped(first + _children(router))

    def test_registry_backfill_without_snapshots(self, proc_env):
        """snapshot_every_steps=0: the registry alone regenerates every
        in-flight request of the killed child, token-exact."""
        router = _router(proc_env, snapshot_every_steps=0)
        try:
            work = workload(8)
            rids = [router.submit(p, sp) for p, sp in work]
            _wait_tokens(router, 6)
            os.kill(router._replicas[1].engine.proc.pid, signal.SIGKILL)
            outs = router.drain(timeout_s=120.0)
            audit_router(router)
            _exact(outs, rids, work)
        finally:
            router.shutdown()

    def test_sigstop_hang_detected_and_respawned(self, proc_env):
        """A stopped child makes no step progress: the heartbeat trips,
        the fence SIGKILLs the stopped process (never reused), and the
        respawned child finishes the work token-exact."""
        # the heartbeat far above a step here even with six test workers
        # on eight cores, the command deadline far above the heartbeat
        router = _router(proc_env, heartbeat_timeout_s=3.0,
                         poll_interval_s=0.1, snapshot_every_steps=2,
                         command_timeout_s=60.0)
        try:
            for w in range(4):          # warm both children
                router.submit([1 + w, 2, 3], SamplingParams(max_tokens=2),
                              request_id=f"warm-{w}")
            router.drain(timeout_s=60.0)
            # replica 0 steps only when the test lets it, so it certainly
            # holds unfinished work, between steps, when its child stops
            gate = StepGate(router._replicas[0])
            gate.close()
            work = workload(8, seed=3)
            rids = [router.submit(p, sp) for p, sp in work]

            def replica0(pred):
                with router._lock:
                    return [r for r in rids if router._reqs[r].owner_idx == 0
                            and pred(router._reqs[r])]
            assert replica0(lambda rec: True), "replica 0 got no request"
            while not replica0(lambda rec: rec.tokens):
                gate.step_once()
            assert replica0(lambda rec: not rec.done)
            stopped = router._replicas[0].engine.proc
            os.kill(stopped.pid, signal.SIGSTOP)
            gate.open()
            outs = router.drain(timeout_s=120.0)
            audit_router(router)
            _exact(outs, rids, work)
            rm = router.metrics.snapshot()
            assert rm["replica_hangs"] + rm["replica_crashes"] >= 1
            assert rm["replica_restarts"] >= 1
            assert stopped.wait(10) == -signal.SIGKILL
            assert router._replicas[0].engine.proc is not stopped
        finally:
            router.shutdown()

    def test_process_split_handoff_token_exact(self, proc_env):
        """One prefill and one decode PROCESS: the KV pages cross the wire
        as bytes and the decode child pages them in: token-exact, no
        recompute fallback."""
        router = _router(proc_env, prefill_replicas=1, host_tier_pages=64)
        try:
            assert [r.engine.role for r in router._replicas] == [
                "prefill", "decode"]
            work = workload(8)
            rids = [router.submit(p, sp) for p, sp in work]
            outs = router.drain(timeout_s=120.0)
            audit_router(router)
            _exact(outs, rids, work)
            rm = router.metrics.snapshot()
            agg = router.metrics_snapshot()["engines"]
            assert rm["handoffs"] >= 6 and rm["handoff_fallbacks"] == 0
            assert agg["handoff_pages_in"] > 0
            assert agg["handoff_recompute_fallbacks"] == 0
            assert agg["pagein_pages"] >= agg["handoff_pages_in"]
            assert agg["handoff_bytes_out"] > 0
            assert all(o.replicas[0] == 0 for o in outs.values())
        finally:
            router.shutdown()

    def test_process_rolling_restart_token_exact(self, proc_env):
        """rolling_restart over processes: each child is drained (bounded
        shutdown, reaped) and a fresh one spawned; every stream exact."""
        router = _router(proc_env, host_tier_pages=64)
        try:
            work = workload(8)
            rids = [router.submit(p, sp) for p, sp in work]
            _wait_tokens(router, 4)
            old = _children(router)
            assert router.rolling_restart(drain_timeout_s=60.0) == 2
            assert {p.pid for p in old}.isdisjoint(
                p.pid for p in _children(router))
            assert all(p.poll() is not None for p in old)
            outs = router.drain(timeout_s=120.0)
            audit_router(router)
            _exact(outs, rids, work)
            rm = router.metrics.snapshot()
            assert rm["replica_drains"] == 2
            assert rm["duplicate_tokens_dropped"] == 0
            router.release_prefix_caches()
            assert router.check_no_leaks()
        finally:
            router.shutdown()

    def test_wire_corrupt_idempotent_retries_on_live_process(self,
                                                             proc_env):
        """A corrupted idempotent request frame is CRC-rejected by the
        child, NAK'd and retried: the child is never fenced and traffic
        completes exact; a corrupted MUTATING frame fences it and the
        supervisor respawns."""
        router = _router(proc_env, rpc_fast_timeout_s=5.0)
        try:
            client = router._replicas[0].engine
            client.wire_faults = WireFaultInjector(corrupt_every=2,
                                                   target="idempotent")
            for _ in range(4):
                client.ping()
            assert client.rpc_stats["naks"] >= 2
            assert client.rpc_stats["retries"] >= 2
            assert not client.dead
            client.wire_faults = None
            work = workload(6, seed=8)
            rids = [router.submit(p, sp) for p, sp in work]
            outs = router.drain(timeout_s=120.0)
            audit_router(router)
            _exact(outs, rids, work)
            assert router.metrics.snapshot()["replica_restarts"] == 0
            client.wire_faults = WireFaultInjector(corrupt_calls=[1],
                                                   target="abort")
            with pytest.raises(ReplicaGoneError, match="CRC"):
                client.abort("nobody")
            assert client.dead
        finally:
            router.shutdown()

    def test_process_recover_from_journal(self, proc_env, tmp_path):
        """Router-crash recovery with PROCESS replicas: the dead router's
        children are killed, and recover() spawns a fresh fleet that
        restores the journaled snapshots and registry."""
        jp = str(tmp_path / "wal.jsonl")
        router = _router(proc_env, journal_path=jp, snapshot_every_steps=2)
        work = workload(8, seed=1)
        try:
            rids = [router.submit(p, sp) for p, sp in work]
            _wait_tokens(router, 6)
        finally:
            for rep in router._replicas:    # the crash
                rep.fenced = True
                rep.stop = True
                rep.wake.set()
            router.supervisor.stop()
            router._journal.close()
            for rep in router._replicas:
                rep.thread.join(30)
                rep.engine.kill()
        r2 = ServingRouter.recover(STUB_SPEC, jp, replicas=2,
                                   snapshot_every_steps=2,
                                   child_env=proc_env,
                                   **dict(TIER_KW, **ENGINE_KW))
        try:
            outs = r2.drain(timeout_s=120.0)
            audit_router(r2)
            assert len(outs) == len(rids)
            _exact(outs, rids, work)
            p, sp = workload(1, seed=9)[0]
            new = r2.submit(p, sp)
            assert new not in rids
            assert r2.drain(timeout_s=60.0)[new].output_tokens == \
                oracle(p, sp)
        finally:
            r2.shutdown()

    def test_drained_child_exits_and_restart_spawns_fresh(self, proc_env):
        router = _router(proc_env)
        try:
            old = router._replicas[0].engine.proc
            router.drain_replica(0)
            assert router._replicas[0].status == "drained"
            assert old.wait(10) is not None
            work = workload(6, seed=5)
            rids = [router.submit(p, sp) for p, sp in work]
            assert {router._reqs[r].owner_idx for r in rids} == {1}
            rep = router.restart_replica(0)
            assert rep.status == "live" and rep.engine.proc.pid != old.pid
            rids2 = [router.submit(p, sp) for p, sp in workload(6, seed=6)]
            outs = router.drain(timeout_s=120.0)
            _exact(outs, rids + rids2, work + workload(6, seed=6))
            audit_router(router)
        finally:
            router.shutdown()


class TestProcessStore:
    """The host-wide KV store under a process tier (the process drills of
    tests/test_serving_shared_kv.py, and chip_smoke.py's phase 46 (d) and
    (e) on the CPU): a shared-memory store the router owns, slot-reference
    handoffs, the reap of a SIGKILLed child's refs, and a router's loss
    recovered over the surviving segments."""

    def _split(self, proc_env, **kw):
        return _router(proc_env, prefill_replicas=1, shared_kv_pages=96,
                       shared_kv_geometry=STORE_GEOMETRY, **kw)

    def test_sigkilled_decode_child_refs_reaped_index_kept(self, proc_env):
        """The decode child, SIGSTOPped while it holds store refs and then
        SIGKILLed: the supervisor reaps its owner tag (the refs freed, the
        index untouched), a fresh child takes over, streams exact, the
        store's audit clean with the live owners, its segments intact."""
        from paddle_tpu_torch.serving import audit_store
        router = self._split(proc_env, snapshot_every_steps=2)
        first = _children(router)
        reaps = []
        orig = router._reap_store_owner

        def reap(rep):
            store = router.kv_store
            with store._lock:
                idx = dict(store._prefix)
                freed = orig(rep)
                reaps.append((rep.store_owner, freed, all(
                    store._prefix.get(h) == s for h, s in idx.items())))
            return freed
        router._reap_store_owner = reap
        try:
            store = router.kv_store
            names = store.attach_spec()["segments"]
            key = router._replicas[1].engine.key
            work = workload(12, seed=3)
            rids = [router.submit(p, sp) for p, sp in work]
            held = 0
            deadline = time.monotonic() + 60
            while not held and time.monotonic() < deadline:
                if any(key in o for o in store.owners_snapshot().values()):
                    os.kill(first[1].pid, signal.SIGSTOP)
                    held = sum(o.get(key, 0)
                               for o in store.owners_snapshot().values())
                    if not held:
                        os.kill(first[1].pid, signal.SIGCONT)
                time.sleep(0.001)
            assert held, "the decode child never held a store ref"
            os.kill(first[1].pid, signal.SIGKILL)
            outs = router.drain(timeout_s=120.0)
            _exact(outs, rids, work)
            audit_router(router)
            audit_store(store, {rep.store_owner for rep in router._replicas})
            assert [(o, kept) for o, _, kept in reaps] == [(key, True)]
            assert not any(key in o for o in
                           store.owners_snapshot().values())
            assert all(os.path.exists(f"/dev/shm/{n}") for n in names)
            assert router._replicas[1].engine.key != key
        finally:
            router.shutdown()
        _assert_reaped(first)

    def test_split_store_tier_recovers_over_its_segments(self, proc_env,
                                                         tmp_path):
        """A journaled split tier over the store, abandoned mid-stream (a
        router crash: its children killed, its metadata service gone, the
        segments left), one journaled index entry's bytes corrupted:
        recover() reattaches the same segments, revives every other
        journaled entry (CRC-checked) and drops the corrupted one; a
        handed-off request both restored children carry runs on one only
        (its journaled owner), and every stream is exact."""
        from paddle_tpu_torch.serving import SharedKVStore
        from paddle_tpu_torch.serving.journal import RouterJournal
        jp = str(tmp_path / "wal.jsonl")
        router = self._split(proc_env, journal_path=jp,
                             snapshot_every_steps=1)
        work = workload(10, seed=4)
        spec = router.kv_store.attach_spec()
        r2 = None
        try:
            rids = [router.submit(p, sp) for p, sp in work]
            deadline = time.monotonic() + 60
            while (router._replicas[1].steps_done < 2
                   and time.monotonic() < deadline):
                time.sleep(0.001)           # both children journaled
            for rep in router._replicas:        # the crash
                rep.fenced = True
                rep.stop = True
                rep.wake.set()
            router.supervisor.stop()
            for rep in router._replicas:
                rep.thread.join(30)
            router._journal.close()
            router._store_server.close()
            for rep in router._replicas:
                rep.engine.kill()
            store = router.kv_store
            state, _ = RouterJournal.replay(jp)
            entries = [e for e in state["store_idx"]["prefix"]
                       if store.content_hash(e[1]) == e[3]]
            assert entries
            store.bufs[0][0][entries[0][1]] += 1.0
            store.close(unlink=False)
            # the prefill child's snapshot taken before a handoff, the
            # decode child's after it: one request in both, journaled as
            # the decode child's (the window a slow prefill step leaves
            # open on the card)
            dup = next(r for r in state["snaps"][0]["requests"]
                       if not state["reqs"][r["request_id"]]["done"])
            state["reqs"][dup["request_id"]]["owner"] = 1
            state["snaps"][1]["requests"].append(dup)
            RouterJournal(jp, resume_state=state).close()
            revived = []
            real = SharedKVStore.restore_index

            def restore_index(st, idx):
                revived.append((real(st, idx), st.has_prefix(entries[0][0]),
                                list(st._segment_names)))
                return revived[-1][0]
            SharedKVStore.restore_index = restore_index
            try:
                r2 = ServingRouter.recover(
                    STUB_SPEC, jp, replicas=2, snapshot_every_steps=1,
                    child_env=proc_env, prefill_replicas=1,
                    shared_kv_pages=96, shared_kv_geometry=STORE_GEOMETRY,
                    **dict(TIER_KW, **ENGINE_KW))
            finally:
                SharedKVStore.restore_index = real
            assert revived == [(len(entries) - 1, False,
                                spec["segments"])]
            outs = r2.drain(timeout_s=120.0)
            audit_router(r2)
            _exact(outs, rids, work)
            assert r2.metrics.snapshot()["replica_crashes"] == 0
        finally:
            if r2 is not None:
                r2.shutdown()
            SharedKVStore.unlink_spec(spec)


# ------------------------------------------ a Llama in every child

SIZES = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=MAXLEN)


def test_model_runner_factory_llama_equals_single_engine_and_jax(proc_env):
    """`replica.model_runner_factory` builds the same seeded Llama in each
    child (device "cpu" through factory_kw): the process tier's greedy
    and seeded streams equal the port's single engine's on that Llama, and
    the greedy ones the JAX single engine's on the same weights."""
    import paddle_tpu as paddle  # noqa: F401
    from paddle_tpu.models.llama import Llama as JaxLlama
    from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from paddle_tpu.serving import LlamaRunner as JaxLlamaRunner
    from paddle_tpu.serving import SamplingParams as JaxSamplingParams
    from paddle_tpu.serving import ServingEngine as JaxServingEngine
    from paddle_tpu_torch.models import Llama, LlamaConfig
    from paddle_tpu_torch.serving import LlamaRunner
    from paddle_tpu_torch.serving.replica import model_runner_factory
    from paddle_tpu_torch.weights import params_to_numpy

    kw = dict(model="llama", seed=3, block_size=BLOCK, max_model_len=MAXLEN,
              device="cpu", **SIZES)
    spec = {"factory": "paddle_tpu_torch.serving.replica:"
                       "model_runner_factory", "factory_kw": kw}
    rng = np.random.default_rng(4)
    work = [(list(map(int, rng.integers(1, 97, int(rng.integers(4, 14))))),
             SamplingParams(max_tokens=6, temperature=0.7 if i % 2 else 0.0,
                            seed=i if i % 2 else None)) for i in range(8)]
    pm = Llama(LlamaConfig(**SIZES), device="cpu", seed=3)
    built = model_runner_factory(0, **kw)
    assert all(torch.equal(built.params[k], v)
               for k, v in LlamaRunner(pm, BLOCK, MAXLEN).params.items())
    single = ServingEngine(LlamaRunner(pm, BLOCK, MAXLEN), **ENGINE_KW)
    ids = [single.add_request(p, sp) for p, sp in work]
    souts = single.run()
    ref = [souts[i].output_tokens for i in ids]
    router = _router(proc_env, spec=spec)
    try:
        rids = [router.submit(p, sp) for p, sp in work]
        outs = router.drain(timeout_s=120.0)
        audit_router(router)
        assert [outs[r].output_tokens for r in rids] == ref
        assert len({outs[r].replica for r in rids}) == 2
    finally:
        router.shutdown()
    jm = JaxLlama(JaxLlamaConfig(dropout=0.0, **SIZES))
    jm.eval()
    jm.set_state_dict(params_to_numpy(pm))
    jeng = JaxServingEngine(JaxLlamaRunner(jm, BLOCK, MAXLEN), **ENGINE_KW)
    greedy = [(p, sp) for p, sp in work if sp.temperature == 0.0]
    jids = [jeng.add_request(p, JaxSamplingParams(max_tokens=6))
            for p, _ in greedy]
    jouts = jeng.run()
    assert [jouts[i].output_tokens for i in jids] == [
        r for r, (_, sp) in zip(ref, work) if sp.temperature == 0.0]
