"""Process-per-engine replica launcher and its client proxy.

Counterpart of paddle_tpu/serving/launch.py:

  ReplicaLauncher   hosts the rendezvous store
                    (`torch.distributed.TCPStore` on port 0: the OS picks,
                    children get the real port on their command line),
                    spawns `python -m paddle_tpu_torch.serving.replica`
                    children as FRESH interpreters (never a fork of a
                    parent that may hold a CUDA context), waits for each
                    child's published command port with a deadline (a
                    timeout names exactly which ranks never arrived and
                    which of them already died with what exit code), then
                    connects and initializes each engine over the wire.
  EngineClient      the parent-side proxy: the slice of the ServingEngine
                    surface the ServingRouter drives (add_request / abort
                    / step / flush / snapshot / inject / extract /
                    handoff / audit, and cached scheduler / pool shims),
                    one socket command per call, each with a finite
                    deadline. The cached stats (queue depth, running
                    count, allocator counters, has_work) are refreshed
                    from every reply and read LOCK-FREE by routing and
                    the supervisor's hang check.

A replica process that exits (SIGKILL, OOM, crash) or stops answering
surfaces as ReplicaGoneError, a ReplicaCrashError: it escapes the router
worker's step loop, fences the replica, and hands recovery to the
Supervisor (a fresh process, restore from the last snapshot, registry
backfill, a new epoch).

Children import this package from the directory `paddle_tpu_torch` was
imported from (`_repo_pythonpath`), whatever the working directory, and
their stdout goes to the parent's stderr: nothing a child prints can land
on the parent's stdout.
"""

from __future__ import annotations

import datetime
import itertools
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.serving.resilience import (
    QueueFullError, ReplicaGoneError,
)
from paddle_tpu_torch.serving.wire import (
    IDEMPOTENT_RPCS, WireCorruptionError, WireTimeoutError, encode_msg,
    events_from_wire, handoff_from_wire, handoff_to_wire, outputs_from_wire,
    recv_msg, sampling_to_dict, send_all, send_msg, state_from_wire,
    state_to_wire,
)

logger = logging.getLogger(__name__)

# RPC deadline classes: no EngineClient call runs with an unbounded
# timeout. FAST RPCs (health and stats reads) get a short deadline;
# everything that may sit behind device work or a graph capture in the
# child (step, submit, snapshot, handoff, ...) gets command_timeout_s, and
# init more headroom for a cold start
RPC_FAST = frozenset({"ping", "metrics", "audit", "check_no_leaks",
                      "requests"})


class _TransientRpcFailure(Exception):
    """An RPC attempt failed in a way that leaves the stream framed (a
    clean deadline trip, a CRC reject, the peer's NAK): retried for
    idempotent RPCs, escalated to ReplicaGoneError otherwise."""

    def __init__(self, why: str, elapsed: float):
        super().__init__(why)
        self.why = why
        self.elapsed = elapsed


def _repo_pythonpath(env: dict) -> dict:
    """Put the directory `paddle_tpu_torch` was imported from first on the
    child's PYTHONPATH, so the child imports this very tree from any
    working directory."""
    import paddle_tpu_torch

    root = os.path.dirname(os.path.dirname(
        os.path.abspath(paddle_tpu_torch.__file__)))
    parts = [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
    return env


# ----------------------------------------------------------- client shims


class _ReqShim:
    __slots__ = ("request_id", "arrival_index", "done")

    def __init__(self, request_id, arrival_index, done=False):
        self.request_id = request_id
        self.arrival_index = arrival_index
        self.done = done


class _SchedulerShim:
    """Lock-free cached view of the remote scheduler: what the router's
    load score (`queue_depth`, `len(running)`) and redistribution
    (`waiting` ids) read."""

    def __init__(self):
        self.queue_depth = 0
        self.running: Tuple[int, ...] = ()
        self.waiting: Tuple[_ReqShim, ...] = ()


class _AllocatorShim:
    def __init__(self, client):
        self._client = client
        self.num_free = 0
        self.num_evictable = 0
        self.num_usable = 1

    def check_no_leaks(self) -> bool:
        return self._client._call({"cmd": "check_no_leaks"})[0]["no_leaks"]


class _PoolShim:
    def __init__(self, client):
        self.block_size = 16
        self.allocator = _AllocatorShim(client)


class _MetricsShim:
    """Remote metrics with a last-good cache, and a never-block rule: the
    supervisor reads a replica's counters on its way into recovery, when a
    SIGSTOP'd replica's worker may sit in a long recv HOLDING the command
    lock. A busy lock, a dead replica or a failed fetch answer from the
    cache."""

    def __init__(self, client):
        self._client = client
        self._last: dict = {}

    def snapshot(self) -> dict:
        c = self._client
        if c.dead or not c._io_lock.acquire(blocking=False):
            return dict(self._last)
        c._io_lock.release()
        try:
            self._last = c._call({"cmd": "metrics"})[0]["snapshot"]
        except BaseException:           # a dead replica: serve the cache
            pass
        return dict(self._last)


class EngineClient:
    """ServingEngine facade over one replica process."""

    def __init__(self, proc: subprocess.Popen, sock: socket.socket,
                 rank: int, key: str, command_timeout_s: float = 120.0,
                 rpc_fast_timeout_s: float = 30.0,
                 rpc_max_retries: int = 2,
                 rpc_backoff_s: float = 0.05):
        self.proc = proc
        self.sock = sock
        self.rank = rank
        self.key = key
        self.command_timeout_s = command_timeout_s
        self.rpc_fast_timeout_s = rpc_fast_timeout_s
        self.rpc_max_retries = max(0, int(rpc_max_retries))
        self.rpc_backoff_s = rpc_backoff_s
        self.dead = False
        self._io_lock = threading.Lock()
        self._seq = itertools.count(1)
        self._ack_next: set = set()     # output ids to ack next command
        # the wire fault seam: a resilience.WireFaultInjector, consulted
        # once per RPC attempt
        self.wire_faults = None
        self.rpc_stats = {"retries": 0, "deadline_trips": 0,
                          "crc_rejects": 0, "naks": 0,
                          "stale_replies": 0}
        self._outputs: Dict[str, object] = {}
        self._requests: Dict[str, _ReqShim] = {}
        self.scheduler = _SchedulerShim()
        self.pool = _PoolShim(self)
        self.metrics = _MetricsShim(self)
        self.max_batch_size = 1
        self.role = "mixed"
        self._has_work = False
        self._handoffs: Tuple[str, ...] = ()

    # --------------------------------------------------------- plumbing

    def _gone(self, why: str) -> ReplicaGoneError:
        self.dead = True
        rc = self.proc.poll()
        detail = (f"exit code {rc}" if rc is not None
                  else "process alive but channel dead")
        return ReplicaGoneError(
            f"replica {self.key} (pid {self.proc.pid}) gone: {why} "
            f"[{detail}]")

    def _deadline_for(self, cmd: str) -> float:
        """The per-RPC deadline table: every call gets a FINITE deadline,
        short for health and stats reads, command_timeout_s for anything
        that may sit behind device work in the child, more for init."""
        if cmd in RPC_FAST:
            return min(self.rpc_fast_timeout_s, self.command_timeout_s)
        if cmd == "init":
            return max(self.command_timeout_s, 300.0)
        return self.command_timeout_s

    def _call(self, header: dict, bufs=(),
              timeout: Optional[float] = None):
        """One command round trip with an explicit deadline, serialized by
        _io_lock (the router's per-replica lock already serializes engine
        touches; this is the backstop for metrics and audit reads from
        other threads).

        Failures that leave the stream framed (a deadline that tripped
        before any reply byte, a CRC-rejected reply, the replica's NAK of
        a CRC-rejected request) RETRY with capped exponential backoff,
        but only for IDEMPOTENT_RPCS and only rpc_max_retries times.
        Everything else (mid-frame timeouts, EOF or reset, exhausted
        retries, any failure of a mutating RPC) raises ReplicaGoneError
        naming the RPC and the elapsed time, which fences the replica and
        hands recovery to the supervisor."""
        cmd = header["cmd"]
        if self.dead:
            raise ReplicaGoneError(f"replica {self.key} already fenced")
        deadline_s = float(timeout if timeout is not None
                           else self._deadline_for(cmd))
        attempts = 0
        backoff = self.rpc_backoff_s
        while True:
            try:
                reply, frames = self._attempt(cmd, header, bufs,
                                              deadline_s)
                break
            except _TransientRpcFailure as e:
                if (cmd not in IDEMPOTENT_RPCS
                        or attempts >= self.rpc_max_retries
                        or self.proc.poll() is not None):
                    raise self._gone(
                        f"rpc {cmd!r} failed after {e.elapsed:.2f}s "
                        f"(deadline {deadline_s:.1f}s, "
                        f"{attempts} retries): {e.why}") from e
                attempts += 1
                self.rpc_stats["retries"] += 1
                logger.debug("replica %s rpc %r transient (%s); "
                             "retry %d", self.key, cmd, e.why, attempts)
                time.sleep(min(backoff, 1.0))
                backoff *= 2
        self._apply(reply)
        if not reply.get("ok", False):
            err = reply.get("error", "unknown")
            if err == "queue_full":
                raise QueueFullError(reply.get("message", "queue full"))
            if err == "KeyError":
                raise KeyError(reply.get("message", ""))
            if err in ("ValueError", "handoff_corrupt"):
                raise ValueError(reply.get("message", ""))
            raise RuntimeError(f"replica {self.key} command "
                               f"{header['cmd']!r} failed: {reply}")
        return reply, frames

    def _attempt(self, cmd: str, header: dict, bufs,
                 deadline_s: float):
        """One send and receive-matching-seq attempt under _io_lock."""
        seq = next(self._seq)
        header = dict(header)
        header["seq"] = seq
        # ack the outputs folded from the previous reply so the replica
        # stops re-shipping them
        header["ack_outputs"] = sorted(self._ack_next)
        start = time.monotonic()
        with self._io_lock:
            try:
                act = (self.wire_faults.action(cmd)
                       if self.wire_faults is not None else None)
                self.sock.settimeout(deadline_s)
                if act == "reset":
                    # a simulated peer reset: the connection dies under
                    # the RPC, always fatal
                    try:
                        self.sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                if act == "drop":
                    pass                 # the bytes never leave the host
                elif act == "corrupt":
                    # flip one payload byte AFTER the 8-byte frame head:
                    # the length stays sane, the CRC must catch it
                    bad = bytearray(encode_msg(header, bufs))
                    bad[8] ^= 0xFF
                    send_all(self.sock, bytes(bad))
                elif act == "truncate":
                    blob = encode_msg(header, bufs)
                    send_all(self.sock, blob[:max(9, len(blob) // 2)])
                else:
                    send_msg(self.sock, header, bufs)
                if act == "delay":
                    # alive but slow: the reply lands after the deadline
                    time.sleep(self.wire_faults.delay_s)
                while True:
                    remaining = deadline_s - (time.monotonic() - start)
                    if remaining <= 0:
                        raise WireTimeoutError(
                            "deadline exhausted awaiting reply",
                            partial=False)
                    self.sock.settimeout(remaining)
                    reply, frames = recv_msg(self.sock)
                    if (reply.get("error") == "wire_corrupt"
                            and reply.get("seq") is None):
                        # the replica CRC-rejected OUR request
                        self.rpc_stats["naks"] += 1
                        raise _TransientRpcFailure(
                            "request frame corrupted (peer CRC "
                            "reject)", time.monotonic() - start)
                    if reply.get("seq") in (None, seq):
                        return reply, frames
                    # a timed-out attempt's reply arriving late: fold its
                    # stats and outputs, then keep waiting for ours
                    self.rpc_stats["stale_replies"] += 1
                    self._apply(reply)
            except WireTimeoutError as e:
                elapsed = time.monotonic() - start
                self.rpc_stats["deadline_trips"] += 1
                if e.partial:
                    raise self._gone(
                        f"rpc {cmd!r} deadline tripped MID-FRAME after "
                        f"{elapsed:.2f}s (deadline {deadline_s:.1f}s): "
                        "stream desynced") from e
                raise _TransientRpcFailure(
                    f"deadline exceeded ({deadline_s:.1f}s)",
                    elapsed) from e
            except WireCorruptionError as e:
                self.rpc_stats["crc_rejects"] += 1
                raise _TransientRpcFailure(
                    f"reply frame corrupted: {e}",
                    time.monotonic() - start) from e
            except (ConnectionError, socket.timeout, OSError) as e:
                raise self._gone(
                    f"rpc {cmd!r}: {type(e).__name__}: {e} after "
                    f"{time.monotonic() - start:.2f}s") from e

    def _apply(self, reply: dict) -> None:
        """Fold a reply's stats and fresh outputs into the cached view."""
        stats = reply.get("stats")
        if stats:
            sch = self.scheduler
            sch.queue_depth = int(stats["queue_depth"])
            sch.running = tuple(range(int(stats["running"])))
            sch.waiting = tuple(
                self._requests.get(rid) or _ReqShim(rid, -1)
                for rid in stats["waiting_ids"])
            al = self.pool.allocator
            al.num_free = int(stats["num_free"])
            al.num_evictable = int(stats["num_evictable"])
            al.num_usable = int(stats["num_usable"])
            self._has_work = bool(stats["has_work"])
            self._handoffs = tuple(stats.get("handoffs", ()))
        outs = reply.get("outputs")
        if outs:
            for rid, o in outputs_from_wire(outs).items():
                self._outputs[rid] = o
                shim = self._requests.get(rid)
                if shim is None:
                    shim = self._requests[rid] = _ReqShim(rid, -1)
                shim.done = True
        # the replica ships outputs until acked: ack what this reply
        # carried (a lost ack is simply repeated)
        self._ack_next = set(outs or ())

    # --------------------------------------------------- engine surface

    def init(self, spec: dict, engine_kw: dict,
             snapshot: Optional[dict] = None,
             init_timeout_s: Optional[float] = None,
             store: Optional[dict] = None) -> None:
        reply, _ = self._call(
            {"cmd": "init", "spec": spec, "engine_kw": engine_kw,
             "index": self.rank, "snapshot": snapshot, "store": store},
            timeout=init_timeout_s or max(self.command_timeout_s, 300.0))
        self.pool.block_size = int(reply["block_size"])
        self.max_batch_size = int(reply["max_batch_size"])
        self.role = reply.get("role", "mixed")
        for rid, info in reply.get("requests", {}).items():
            self._requests[rid] = _ReqShim(
                rid, int(info["arrival_index"]), bool(info["done"]))

    def add_request(self, prompt_tokens, sampling,
                    request_id: Optional[str] = None) -> str:
        reply, _ = self._call({
            "cmd": "submit",
            "prompt_tokens": [int(t) for t in prompt_tokens],
            "sampling": sampling_to_dict(sampling),
            "request_id": request_id})
        rid = reply["request_id"]
        self._requests[rid] = _ReqShim(rid, int(reply["arrival_index"]))
        return rid

    def abort(self, request_id: str, reason: str = "aborted") -> bool:
        reply, _ = self._call({"cmd": "abort", "request_id": request_id,
                               "reason": reason})
        return bool(reply["aborted"])

    def has_work(self) -> bool:
        # a LOCK-FREE cached read (the supervisor's hang check): a replica
        # blocked mid-step must not need a round trip here
        return self._has_work

    def step(self):
        reply, _ = self._call({"cmd": "step"})
        return events_from_wire(reply.get("events", ()))

    def flush(self):
        reply, _ = self._call({"cmd": "flush"})
        return events_from_wire(reply.get("events", ()))

    def snapshot(self) -> dict:
        return self._call({"cmd": "snapshot"})[0]["snapshot"]

    def inject_request(self, prompt_tokens, sampling=None, *,
                       request_id=None, output_tokens=(),
                       arrival_index=None, num_preemptions=0,
                       elapsed_s=0.0, first_token_elapsed_s=None) -> str:
        from paddle_tpu_torch.serving.scheduler import SamplingParams

        state = {
            "request_id": request_id,
            "prompt_tokens": [int(t) for t in prompt_tokens],
            "output_tokens": [int(t) for t in output_tokens],
            "sampling": sampling or SamplingParams(),
            "arrival_index": arrival_index,
            "num_preemptions": num_preemptions,
            "elapsed_s": elapsed_s,
            "first_token_elapsed_s": first_token_elapsed_s,
        }
        reply, _ = self._call({"cmd": "inject",
                               "state": state_to_wire(state)})
        rid = reply["request_id"]
        self._requests.setdefault(
            rid, _ReqShim(rid, arrival_index if arrival_index is not None
                          else -1))
        return rid

    def extract_request(self, request_id: str) -> dict:
        reply, _ = self._call({"cmd": "extract",
                               "request_id": request_id})
        self._requests.pop(request_id, None)
        return state_from_wire(reply["state"])

    def stage_migration(self, request_id: str) -> bool:
        """Park one RUNNING request in the replica's handoff buffer (a
        graceful drain): its pages spill to the child's host tier so
        extract_handoff can ship them to a sibling."""
        reply, _ = self._call({"cmd": "stage_migration",
                               "request_id": request_id})
        return bool(reply["staged"])

    def handoff_ready(self) -> List[str]:
        return list(self._handoffs)

    def extract_handoff(self, request_id: str):
        reply, frames = self._call({"cmd": "handoff_extract",
                                    "request_id": request_id})
        self._requests.pop(request_id, None)
        return (state_from_wire(reply["state"]),
                handoff_from_wire(reply, frames))

    def import_handoff(self, state: dict, payload) -> str:
        head, frames = handoff_to_wire(payload)
        head.update({"cmd": "handoff_inject",
                     "state": state_to_wire(state)})
        reply, _ = self._call(head, frames)
        rid = reply["request_id"]
        self._requests.setdefault(
            rid, _ReqShim(rid, int(state.get("arrival_index") or -1)))
        return rid

    def release_prefix_cache(self) -> int:
        return int(self._call(
            {"cmd": "release_prefix_cache"})[0]["released"])

    def remote_audit(self) -> Optional[str]:
        """audit_engine inside the replica process: the problem string, or
        None when clean (how audit_router reaches across the process
        boundary)."""
        return self._call({"cmd": "audit"})[0]["problems"]

    def ping(self) -> None:
        self._call({"cmd": "ping"})

    # --------------------------------------------------------- teardown

    def proc_dead(self) -> bool:
        """waitpid-style liveness probe (non-blocking)."""
        return self.proc.poll() is not None

    def shutdown(self, timeout_s: float = 5.0) -> None:
        """Graceful stop, bounded by timeout_s end to end even when the
        child ignores the command: the lock is taken WITH a deadline
        (another thread may sit in a recv on a half-closed socket), the
        remaining budget bounds the socket I/O, and kill() then always
        completes (SIGKILL needs no cooperation)."""
        start = time.monotonic()
        got = self._io_lock.acquire(timeout=timeout_s)
        if got:
            try:
                remaining = max(0.05, timeout_s
                                - (time.monotonic() - start))
                self.sock.settimeout(remaining)
                send_msg(self.sock, {"cmd": "shutdown",
                                     "seq": next(self._seq)})
                recv_msg(self.sock)      # best-effort goodbye
            except BaseException:
                pass
            finally:
                self._io_lock.release()
        self.kill(max(0.1, timeout_s - (time.monotonic() - start)))

    def kill(self, timeout_s: float = 5.0) -> None:
        """SIGKILL the replica process and reap it: also the fence of a
        SIGSTOP'd (hung) process, since SIGKILL applies to stopped
        processes. Never touches the command lock: closing the socket
        unblocks any reader still in a recv (it raises ReplicaGoneError
        there)."""
        self.dead = True
        try:
            if self.proc.poll() is None:
                self.proc.kill()
            self.proc.wait(timeout=timeout_s)
        except Exception:  # pragma: no cover
            pass
        try:
            self.sock.close()
        except OSError:  # pragma: no cover
            pass


# ------------------------------------------------------------- launcher


class ReplicaLauncher:
    """Spawns replica processes and rendezvouses them through one
    `torch.distributed.TCPStore` the launcher hosts.

    spec         {"factory": "module:callable", "factory_kw": {...},
                  "sys_path": [...]}, resolved INSIDE each child; the
                  factory is called as factory(rank, **factory_kw) (or
                  factory(**factory_kw) for index-blind ones)
    engine_kw    ServingEngine keywords, JSON-serializable (objects such
                  as tokenizers or metrics cannot cross a process
                  boundary: a loud TypeError here)
    env          the children's environment (default: this process's)
    store_spec   the host-wide KV store's attach ({"attach": segment
                  map, "addr": metadata service}) or None; each child's
                  init carries it with the child's key as its owner tag
    """

    def __init__(self, spec: dict, engine_kw: dict, *,
                 rendezvous_timeout_s: float = 120.0,
                 command_timeout_s: float = 120.0,
                 rpc_fast_timeout_s: float = 30.0,
                 rpc_max_retries: int = 2,
                 env: Optional[dict] = None,
                 store_spec: Optional[dict] = None):
        from torch.distributed import TCPStore

        try:
            self.spec = dict(spec)
            json.dumps(self.spec)
            self.engine_kw = json.loads(json.dumps(engine_kw))
        except TypeError as e:
            raise TypeError(
                "process-backend replica spec/engine_kw must be JSON-"
                f"serializable (they cross a process boundary): {e}"
            ) from e
        self.rendezvous_timeout_s = rendezvous_timeout_s
        self.command_timeout_s = command_timeout_s
        self.rpc_fast_timeout_s = rpc_fast_timeout_s
        self.rpc_max_retries = rpc_max_retries
        # the host-wide KV store's attach ({"attach", "addr"}); each child
        # gets it with its launcher key as its owner tag
        self.store_spec = store_spec
        self.session = f"serving-{uuid.uuid4().hex[:8]}"
        self._env = dict(env if env is not None else os.environ)
        _repo_pythonpath(self._env)
        self._epoch = 0
        self.store = TCPStore(
            "127.0.0.1", 0, is_master=True, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=rendezvous_timeout_s))

    # ------------------------------------------------------------ spawn

    def _spawn_proc(self, rank: int) -> Tuple[subprocess.Popen, str]:
        key = f"{self.session}/r{rank}e{self._epoch}"
        self._epoch += 1
        cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.replica",
               "--store-host", "127.0.0.1",
               "--store-port", str(self.store.port),
               "--key", key, "--session", self.session,
               "--connect-timeout", str(self.rendezvous_timeout_s)]
        # a fresh interpreter (never a fork of a CUDA parent); its stdout
        # goes to our stderr
        proc = subprocess.Popen(cmd, env=self._env, stdout=2)
        return proc, key

    def _published_port(self, key: str) -> Optional[int]:
        k = f"{key}/port"
        if not self.store.check([k]):
            return None
        return int(self.store.get(k))

    def _await_port(self, proc: subprocess.Popen, key: str,
                    deadline: float) -> int:
        while True:
            port = self._published_port(key)
            if port is not None:
                return port
            rc = proc.poll()
            if rc is not None:
                raise ReplicaGoneError(
                    f"replica {key} (pid {proc.pid}) died during "
                    f"rendezvous with exit code {rc}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"rendezvous timeout: replica {key} never published "
                    f"its command port within "
                    f"{self.rendezvous_timeout_s:.1f}s "
                    "(rendezvous_timeout_s; slow spawns may need more)")
            time.sleep(0.01)

    def _connect(self, port: int) -> socket.socket:
        sock = socket.create_connection(("127.0.0.1", port),
                                        timeout=self.rendezvous_timeout_s)
        sock.settimeout(None)
        return sock

    def spawn(self, rank: int, *, role: str = "mixed",
              snapshot: Optional[dict] = None,
              engine_kw: Optional[dict] = None) -> EngineClient:
        """Spawn, rendezvous and init ONE replica (the supervisor's
        respawn). `snapshot` restores the engine inside the child instead
        of building it fresh."""
        proc, key = self._spawn_proc(rank)
        deadline = time.monotonic() + self.rendezvous_timeout_s
        try:
            port = self._await_port(proc, key, deadline)
            sock = self._connect(port)
        except BaseException:
            _reap(proc)
            raise
        client = self._client(proc, sock, rank, key)
        kw = dict(engine_kw if engine_kw is not None else self.engine_kw)
        kw["role"] = role
        try:
            client.init(self.spec, kw, snapshot=snapshot,
                        store=self._store_for(key))
        except BaseException:
            client.kill()
            raise
        return client

    def _store_for(self, key: str) -> Optional[dict]:
        if self.store_spec is None:
            return None
        return {**self.store_spec, "owner": key}

    def _client(self, proc, sock, rank, key) -> EngineClient:
        return EngineClient(proc, sock, rank, key,
                            self.command_timeout_s,
                            rpc_fast_timeout_s=self.rpc_fast_timeout_s,
                            rpc_max_retries=self.rpc_max_retries)

    def spawn_all(self, roles: Sequence[str],
                  snapshots: Optional[Sequence[Optional[dict]]] = None
                  ) -> List[EngineClient]:
        """Spawn the initial fleet concurrently and rendezvous with ONE
        shared deadline; a timeout names EXACTLY which ranks are missing,
        and which of those already died with their exit codes.
        `snapshots[i]`, when given, restores replica i's engine inside its
        child (the router's journal recovery)."""
        procs = [self._spawn_proc(rank) for rank in range(len(roles))]
        deadline = time.monotonic() + self.rendezvous_timeout_s
        ports: Dict[int, int] = {}
        clients: List[EngineClient] = []
        try:
            while len(ports) < len(procs):
                progressed = False
                for rank, (proc, key) in enumerate(procs):
                    if rank in ports:
                        continue
                    port = self._published_port(key)
                    if port is not None:
                        ports[rank] = port
                        progressed = True
                if len(ports) == len(procs):
                    break
                if time.monotonic() > deadline:
                    missing = []
                    for rank, (proc, key) in enumerate(procs):
                        if rank in ports:
                            continue
                        rc = proc.poll()
                        missing.append(
                            f"rank {rank} ({key}, pid {proc.pid}: "
                            + ("alive but silent" if rc is None
                               else f"exited rc={rc}") + ")")
                    raise TimeoutError(
                        f"rendezvous timeout after "
                        f"{self.rendezvous_timeout_s:.1f}s: "
                        f"{len(ports)}/{len(procs)} replicas arrived; "
                        "missing: " + "; ".join(missing))
                if not progressed:
                    time.sleep(0.01)
            for rank, (proc, key) in enumerate(procs):
                clients.append(self._client(proc, self._connect(
                    ports[rank]), rank, key))
            for rank, (client, role) in enumerate(zip(clients, roles)):
                kw = dict(self.engine_kw)
                kw["role"] = role
                client.init(self.spec, kw,
                            snapshot=(snapshots[rank] if snapshots
                                      else None),
                            store=self._store_for(client.key))
            return clients
        except BaseException:
            for client in clients:
                client.kill()
            for proc, _ in procs:
                _reap(proc)
            raise

    def close(self) -> None:
        # the store's server thread ends with its last reference
        self.store = None


def _reap(proc: subprocess.Popen, timeout_s: float = 5.0) -> None:
    """SIGKILL a child if it is alive, and wait for it."""
    try:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=timeout_s)
    except Exception:  # pragma: no cover
        pass
