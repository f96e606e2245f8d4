"""Cross-process access to the host-wide KV store (`SharedKVStore`).

Counterpart of paddle_tpu/serving/store_service.py, op for op and frame for
frame: a client of either package talks to a server of the other. The
store's page BYTES cross process boundaries for free: they live in
`multiprocessing.shared_memory` segments every replica child maps
read-write (`SharedKVStore.attach_spec` names them). Its METADATA (free
list, per-owner refcounts, the content index, generations) stays in one
process, the router's, and replica children reach it through this module:

  StoreServer          a thread in the router process serving small JSON
                       metadata ops ({op, args} -> {ok, result}) over
                       loopback sockets, framed by wire.py (a CRC per
                       frame); one handler thread per connection. Page
                       bytes never ride this channel.
  SharedKVStoreClient  the child's handle: tensors over the same segments
                       (the physical pages the router and every sibling
                       see) and the SharedKVStore metadata surface over
                       one socket, so `HostKVTier(store=client)` cannot
                       tell it from the store. `rpc_count` counts its
                       round trips.

The init command's ``store`` field ({"attach": spec, "addr": [h, p],
"owner": key}) is the attach; a child that exits drops its socket, and the
supervisor's reap releases whatever refs the dead owner held.
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import List, Optional, Tuple

import torch

from paddle_tpu_torch.serving.kv_cache import (
    _bytes, _open_shm, _segment_views, _to_numpy,
)
from paddle_tpu_torch.serving.wire import recv_msg, send_msg

logger = logging.getLogger(__name__)

# the metadata surface a store-backed HostKVTier uses; every op is a
# SharedKVStore method of the same name ("counts" reads three counts)
STORE_OPS = frozenset({
    "alloc", "release", "retag", "incref", "set_hash", "slot_hash",
    "generation", "has_prefix", "acquire_prefix", "drop_prefix",
    "index_prefix", "owner_count", "refcount", "reap_owner", "stats",
    "counts", "journal_state",
})


class StoreServer:
    """Serve one SharedKVStore's metadata ops to replica children."""

    def __init__(self, store, host: str = "127.0.0.1"):
        self.store = store
        self._lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lst.bind((host, 0))
        self._lst.listen(64)
        self.address: Tuple[str, int] = self._lst.getsockname()
        self._stop = False
        self._conns: List[socket.socket] = []
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="shared-kv-store")
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._lst.accept()
            except OSError:
                return                     # listener closed
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True,
                             name="shared-kv-store-conn").start()

    def _serve(self, conn: socket.socket) -> None:
        store = self.store
        try:
            while not self._stop:
                try:
                    header, _ = recv_msg(conn)
                except ConnectionError:
                    return                 # the child detached or died
                op = header.get("op")
                try:
                    if op not in STORE_OPS:
                        raise ValueError(f"unknown store op {op!r}")
                    if op == "counts":
                        result = {"free": store.free_count,
                                  "used": store.used_count,
                                  "prefix": store.prefix_count,
                                  "max_pages": store.max_pages}
                    else:
                        result = getattr(store, op)(
                            *header.get("args", ()))
                    send_msg(conn, {"ok": True, "result": result})
                except (ValueError, KeyError) as e:
                    send_msg(conn, {"ok": False,
                                    "error": type(e).__name__,
                                    "message": str(e)})
        except BaseException:              # pragma: no cover - teardown
            pass
        finally:
            try:
                conn.close()
            except OSError:                # pragma: no cover
                pass

    def close(self) -> None:
        self._stop = True
        try:
            self._lst.close()
        except OSError:                    # pragma: no cover
            pass
        for c in self._conns:
            try:
                c.close()
            except OSError:                # pragma: no cover
                pass


class SharedKVStoreClient:
    """A replica child's handle on the host-wide store: tensors over the
    shared-memory segments for the bytes, one socket for the metadata.
    It has no ``_lock`` on purpose: the auditor reads its absence as a
    remote handle and leaves the structural store audit to the router."""

    def __init__(self, attach: dict, addr, timeout_s: float = 30.0):
        self.max_pages = int(attach["max_pages"])
        self.layout = [tuple((tuple(shape), dt) for shape, dt in layer)
                       for layer in attach["layout"]]
        segments = []
        self.bufs = []
        names = iter(attach["segments"])
        for layer in self.layout:
            arrs = []
            for shape, dt in layer:
                seg = _open_shm(next(names))
                segments.append(seg)
                arrs.append(_segment_views(seg, (self.max_pages,) + shape,
                                           dt))
            self.bufs.append(tuple(arrs))
        self.byte_bufs = [tuple(_bytes(b) for b in layer)
                          for layer in self.bufs]
        # after the views: a dying client frees them before its segments
        self._segments = segments
        self.rpc_count = 0
        self._io_lock = threading.Lock()
        self._sock = socket.create_connection(tuple(addr),
                                              timeout=timeout_s)
        self._sock.settimeout(timeout_s)

    def _op(self, op: str, *args):
        with self._io_lock:
            self.rpc_count += 1
            send_msg(self._sock, {"op": op, "args": list(args)})
            reply, _ = recv_msg(self._sock)
        if not reply.get("ok"):
            err = reply.get("error", "RuntimeError")
            msg = reply.get("message", "")
            if err == "ValueError":
                raise ValueError(msg)
            if err == "KeyError":
                raise KeyError(msg)
            raise RuntimeError(f"store op {op!r} failed: {msg}")
        return reply.get("result")

    # ------------------------------------------------- metadata surface

    def alloc(self, n, owner):
        return list(self._op("alloc", int(n), str(owner)))

    def release(self, slots, owner):
        self._op("release", [int(s) for s in slots], str(owner))

    def retag(self, slots, old_owner, new_owner):
        self._op("retag", [int(s) for s in slots], str(old_owner),
                 str(new_owner))

    def incref(self, slots, owner):
        self._op("incref", [int(s) for s in slots], str(owner))

    def set_hash(self, slot, h):
        self._op("set_hash", int(slot), int(h))

    def slot_hash(self, slot) -> Optional[int]:
        return self._op("slot_hash", int(slot))

    def generation(self, slot) -> int:
        return int(self._op("generation", int(slot)))

    def has_prefix(self, h) -> bool:
        return bool(self._op("has_prefix", int(h)))

    def acquire_prefix(self, h, owner) -> Optional[int]:
        return self._op("acquire_prefix", int(h), str(owner))

    def drop_prefix(self, h) -> bool:
        return bool(self._op("drop_prefix", int(h)))

    def index_prefix(self, h, slot) -> bool:
        return bool(self._op("index_prefix", int(h), int(slot)))

    def owner_count(self, slot, owner) -> int:
        return int(self._op("owner_count", int(slot), str(owner)))

    def refcount(self, slot) -> int:
        return int(self._op("refcount", int(slot)))

    def reap_owner(self, owner) -> int:
        return int(self._op("reap_owner", str(owner)))

    def stats(self) -> dict:
        return dict(self._op("stats"))

    def journal_state(self) -> dict:
        return dict(self._op("journal_state"))

    @property
    def free_count(self) -> int:
        return int(self._op("counts")["free"])

    @property
    def used_count(self) -> int:
        return int(self._op("counts")["used"])

    @property
    def prefix_count(self) -> int:
        return int(self._op("counts")["prefix"])

    # ------------------------------------------------------ byte access
    # (the physical pages every sibling sees: direct segment views)

    def read_slot(self, slot):
        return [tuple(buf[slot].clone() for buf in layer)
                for layer in self.bufs]

    def export_slots(self, slots):
        idx = torch.as_tensor(list(slots), dtype=torch.long)
        return [tuple(_to_numpy(buf.index_select(0, idx)) for buf in layer)
                for layer in self.bufs]

    def content_hash(self, slot) -> int:
        import zlib

        h = 0x9E3779B9
        for layer in self.byte_bufs:
            for buf in layer:
                h = zlib.crc32(buf[slot].numpy(), h)
        return h

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:                    # pragma: no cover
            pass
        from paddle_tpu_torch.serving.kv_cache import _close_segments

        self.bufs, self.byte_bufs = [], []
        segments, self._segments = self._segments, []
        _close_segments(segments, unlink=False)
