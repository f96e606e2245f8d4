"""Replica process entry point of the process tier: one OS process, one
ServingEngine, driven over a length-prefixed socket by the parent router.

Counterpart of paddle_tpu/serving/replica.py:

    python -m paddle_tpu_torch.serving.replica --store-host H \
        --store-port P --key SESSION/r0e0 [--connect-timeout 120]

Startup: the child connects to the parent's rendezvous store as a client
(`torch.distributed.TCPStore`, whose connect retries until
`--connect-timeout`), binds a loopback listener on an ephemeral port,
publishes it under `<key>/port`, bumps the `<session>/arrived` counter,
and accepts exactly one connection: the parent's command channel.

Commands (a JSON header and optional binary page frames, see wire.py):
init (build the runner through an importable factory, or
ServingEngine.restore from a snapshot; with a ``store`` field, attach the
router's host-wide KV store: map its shared-memory segments and connect
to its metadata service, `store_service.SharedKVStoreClient`), submit / abort / step / flush /
snapshot / inject / extract / handoff_extract / handoff_inject /
stage_migration / release_prefix_cache / check_no_leaks / metrics / audit
/ requests / ping / shutdown. Every reply carries a `stats` block (queue
depth, running count, waiting ids, allocator counters, staged handoffs)
and the finished outputs the parent has not acknowledged yet.

Failures are blunt: load errors (queue full, unknown request) travel back
as tagged error replies, anything else escapes the loop and ends the
process with a traceback on stderr. A dead process is the failure unit:
the parent sees the EOF (or the waitpid exit code, or a heartbeat timeout
for a SIGSTOP'd child) and the Supervisor respawns it.

The child logs to stderr only (the launcher also sends its stdout there),
so nothing a replica says can land on the parent's stdout. On the card
the kernel library is found by its hash under csrc/build/, where the
parent built it before spawning.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import socket
import sys
from typing import Optional

def resolve_factory(spec: dict):
    """Import `module:callable` (after prepending spec["sys_path"]): how a
    child rebuilds the parent's runner factory without pickling code."""
    for p in spec.get("sys_path", ()) or ():
        if p not in sys.path:
            sys.path.insert(0, p)
    mod_name, _, fn_name = spec["factory"].partition(":")
    if not fn_name:
        raise ValueError(
            f"factory spec {spec['factory']!r} must be 'module:callable'")
    mod = importlib.import_module(mod_name)
    return getattr(mod, fn_name)


def model_runner_factory(index: int = 0, *, model: str = "llama",
                         seed: int = 0, block_size: int = 16,
                         max_model_len: Optional[int] = None,
                         attn_impl: str = "auto", kv_dtype: str = "fp32",
                         weight_dtype: str = "fp32",
                         weight_group_size: int = 128,
                         device: str = "cuda", **cfg_kw):
    """The factory of real-model replicas: a Llama or GPT runner on
    ``device`` built from config keywords, its weights drawn from
    ``seed``. Every process that calls it with the same arguments on the
    same device holds identical weights, so a request moves between
    replicas token-exact without shipping parameters."""
    from paddle_tpu_torch.serving.model_runner import runner_for

    if model == "llama":
        from paddle_tpu_torch.models import Llama, LlamaConfig

        net = Llama(LlamaConfig(**cfg_kw), device=device, seed=seed)
    elif model == "gpt":
        from paddle_tpu_torch.models import GPT, GPTConfig

        net = GPT(GPTConfig(**cfg_kw), device=device, seed=seed)
    else:
        raise ValueError(f"model={model!r}; expected 'llama' or 'gpt'")
    net.eval()
    return runner_for(net, block_size=block_size,
                      max_model_len=max_model_len, attn_impl=attn_impl,
                      kv_dtype=kv_dtype, weight_dtype=weight_dtype,
                      weight_group_size=weight_group_size, device=device)


class ReplicaServer:
    """The child's command loop around one ServingEngine."""

    def __init__(self):
        self.engine = None
        self._kv_store = None       # the SharedKVStoreClient when attached
        self.steps = 0
        # finished outputs the parent has ACKED: outputs ride every reply
        # until acked in a later command header, so a reply lost to a
        # deadline or a CRC reject never loses a finished output
        self._acked = set()

    # ------------------------------------------------------------ state

    def _stats(self) -> dict:
        eng = self.engine
        a = eng.pool.allocator
        return {
            "queue_depth": eng.scheduler.queue_depth,
            "running": len(eng.scheduler.running),
            "waiting_ids": [r.request_id for r in eng.scheduler.waiting],
            "num_free": a.num_free,
            "num_evictable": a.num_evictable,
            "num_usable": a.num_usable,
            "has_work": eng.has_work(),
            "handoffs": eng.handoff_ready(),
            "steps": self.steps,
        }

    def _new_outputs(self) -> dict:
        from paddle_tpu_torch.serving.wire import outputs_to_wire

        fresh = {rid: o for rid, o in self.engine._outputs.items()
                 if rid not in self._acked}
        return outputs_to_wire(fresh)

    def _reply(self, **extra) -> dict:
        out = {"ok": True, "stats": self._stats(),
               "outputs": self._new_outputs()}
        out.update(extra)
        return out

    def _error(self, error: str, e: BaseException) -> dict:
        return {"ok": False, "error": error, "message": str(e),
                "stats": self._stats(), "outputs": self._new_outputs()}

    def _requests_view(self) -> dict:
        return {rid: {"done": r.done, "arrival_index": r.arrival_index}
                for rid, r in self.engine._requests.items()}

    # --------------------------------------------------------- commands

    def _init(self, header: dict) -> dict:
        from paddle_tpu_torch.serving.engine import ServingEngine

        spec = header["spec"]
        factory = resolve_factory(spec)
        try:
            runner = factory(int(header.get("index", 0)),
                             **spec.get("factory_kw", {}))
        except TypeError:           # index-blind factories are fine too
            runner = factory(**spec.get("factory_kw", {}))
        # the host-wide store's attach: map the router's segments and open
        # the metadata channel; this engine's host tier is then the store,
        # under this child's owner tag
        store_info = header.get("store")
        kv_store = kv_owner = None
        if store_info is not None:
            from paddle_tpu_torch.serving.store_service import (
                SharedKVStoreClient,
            )

            kv_store = SharedKVStoreClient(store_info["attach"],
                                           store_info["addr"])
            kv_owner = store_info.get("owner")
            self._kv_store = kv_store
        snap = header.get("snapshot")
        if snap is not None:
            self.engine = ServingEngine.restore(
                runner, snap, kv_store=kv_store, kv_store_owner=kv_owner)
        else:
            self.engine = ServingEngine(runner, kv_store=kv_store,
                                        kv_store_owner=kv_owner,
                                        **header["engine_kw"])
        return self._reply(
            block_size=self.engine.pool.block_size,
            max_batch_size=self.engine.max_batch_size,
            role=self.engine.role,
            requests=self._requests_view())

    def handle(self, header: dict, bufs):
        from paddle_tpu_torch.serving.resilience import (
            InvariantViolation, QueueFullError, audit_engine,
        )
        from paddle_tpu_torch.serving.wire import (
            events_to_wire, handoff_from_wire, handoff_to_wire,
            sampling_from_dict, state_from_wire, state_to_wire,
        )

        cmd = header["cmd"]
        self._acked.update(header.get("ack_outputs", ()))
        eng = self.engine
        if cmd == "init":
            return self._init(header)
        if cmd == "ping":
            return self._reply()
        if cmd == "submit":
            try:
                rid = eng.add_request(
                    header["prompt_tokens"],
                    sampling_from_dict(header["sampling"]),
                    request_id=header.get("request_id"))
            except QueueFullError as e:
                return self._error("queue_full", e)
            return self._reply(request_id=rid,
                               arrival_index=eng._requests[rid]
                               .arrival_index)
        if cmd == "abort":
            return self._reply(aborted=eng.abort(
                header["request_id"], header.get("reason", "aborted")))
        if cmd == "step":
            events = eng.step() if eng.has_work() else []
            if events or eng.has_work():
                self.steps += 1
            return self._reply(events=events_to_wire(events))
        if cmd == "flush":
            return self._reply(events=events_to_wire(eng.flush()))
        if cmd == "snapshot":
            return self._reply(snapshot=eng.snapshot())
        if cmd == "inject":
            state = state_from_wire(header["state"])
            rid = eng.inject_request(
                state["prompt_tokens"], state["sampling"],
                request_id=state["request_id"],
                output_tokens=state.get("output_tokens", ()),
                arrival_index=state.get("arrival_index"),
                num_preemptions=int(state.get("num_preemptions", 0)),
                elapsed_s=float(state.get("elapsed_s", 0.0)),
                first_token_elapsed_s=state.get("first_token_elapsed_s"))
            return self._reply(request_id=rid)
        if cmd == "extract":
            try:
                state = eng.extract_request(header["request_id"])
            except (KeyError, ValueError) as e:
                return self._error(type(e).__name__, e)
            return self._reply(state=state_to_wire(state))
        if cmd == "handoff_extract":
            try:
                state, payload = eng.extract_handoff(header["request_id"])
            except KeyError as e:
                return self._error("KeyError", e)
            head, frames = handoff_to_wire(payload)
            head.update(self._reply(state=state_to_wire(state)))
            return head, frames
        if cmd == "handoff_inject":
            try:
                rid = eng.import_handoff(state_from_wire(header["state"]),
                                         handoff_from_wire(header, bufs))
            except ValueError as e:     # a content-hash mismatch: loud
                return self._error("handoff_corrupt", e)
            return self._reply(request_id=rid)
        if cmd == "stage_migration":
            # a graceful drain parks one RUNNING request in the handoff
            # buffer so its pages ride to a sibling
            return self._reply(
                staged=eng.stage_migration(header["request_id"]))
        if cmd == "release_prefix_cache":
            return self._reply(released=eng.release_prefix_cache())
        if cmd == "check_no_leaks":
            return self._reply(no_leaks=eng.pool.allocator.check_no_leaks())
        if cmd == "metrics":
            return self._reply(snapshot=eng.metrics.snapshot())
        if cmd == "audit":
            try:
                audit_engine(eng)
            except InvariantViolation as e:
                return self._reply(problems=str(e))
            return self._reply(problems=None)
        if cmd == "requests":
            return self._reply(requests=self._requests_view())
        if cmd == "shutdown":
            return self._reply(bye=True)
        raise ValueError(f"unknown command {cmd!r}")

    def serve(self, conn: socket.socket) -> None:
        from paddle_tpu_torch.serving.wire import (
            WireCorruptionError, recv_msg, send_msg,
        )

        while True:
            try:
                header, bufs = recv_msg(conn)
            except WireCorruptionError as e:
                # the parent's request failed its CRC check: its bytes were
                # consumed, so the stream is still framed. NAK it (seq None
                # = "your current request"; the client retries idempotent
                # RPCs) and keep serving; never parse corrupted bytes
                send_msg(conn, {"ok": False, "error": "wire_corrupt",
                                "seq": None, "message": str(e)})
                continue
            out = self.handle(header, bufs)
            reply, frames = out if isinstance(out, tuple) else (out, ())
            # echo the sequence number: the client matches replies to
            # attempts with it, so a reply that arrives after its attempt's
            # deadline is folded as stale, never taken for a retry's answer
            reply.setdefault("seq", header.get("seq"))
            send_msg(conn, reply, frames)
            if header["cmd"] == "shutdown":
                return


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddle_tpu_torch.serving.replica")
    ap.add_argument("--store-host", required=True)
    ap.add_argument("--store-port", type=int, required=True)
    ap.add_argument("--key", required=True,
                    help="rendezvous key prefix, e.g. SESSION/r0e0")
    ap.add_argument("--session", default=None,
                    help="session prefix of the arrival counter")
    ap.add_argument("--connect-timeout", type=float, default=120.0)
    ap.add_argument("--accept-timeout", type=float, default=300.0)
    args = ap.parse_args(argv)

    from torch.distributed import TCPStore

    store = TCPStore(args.store_host, args.store_port, is_master=False,
                     timeout=datetime.timedelta(
                         seconds=args.connect_timeout))
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    port = lst.getsockname()[1]
    # the rendezvous: publish the command port, bump the arrival counter;
    # the parent waits on these with a deadline and names a missing rank
    store.set(f"{args.key}/port", str(port))
    if args.session:
        store.add(f"{args.session}/arrived", 1)
    lst.settimeout(args.accept_timeout)
    try:
        conn, _ = lst.accept()
    except socket.timeout:
        print(f"replica {args.key}: the parent never connected within "
              f"{args.accept_timeout:.0f}s", file=sys.stderr)
        return 3
    conn.settimeout(None)
    lst.close()
    ReplicaServer().serve(conn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
