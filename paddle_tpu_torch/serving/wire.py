"""Length-prefixed, CRC-checked socket protocol of the process tier.

Counterpart of paddle_tpu/serving/wire.py, byte for byte: the same frames
for the same header and buffers, so either side decodes the other's.

One message = one JSON header frame + `nbufs` raw binary frames. A frame
is a 4-byte little-endian length, a 4-byte little-endian CRC-32 of the
payload, then that many payload bytes. The header is a JSON object;
binary frames carry numpy arrays (the KV page bytes of a prefill ->
decode handoff: raw page bytes and scale rows ride the wire untouched,
which keeps the transfer bit-exact, int8 codes included). Each array's
dtype and shape ride the header under "bufs".

Corruption is detected, never parsed: every frame's payload is
CRC-checked at receive, and a failed check raises WireCorruptionError
only after the advertised payload bytes were consumed, so the stream
stays framed and the caller can NAK (replica side) or retry an
idempotent RPC (client side). A corrupted LENGTH prefix cannot be told
from data; MAX_FRAME_BYTES turns an insane length into a loud
ConnectionError instead of an allocation.

Every recv and send loops over partial I/O and retries EINTR, so a
SIGCHLD from a dying sibling replica never tears a frame. EOF mid-frame
raises ConnectionError (the caller treats it as peer death). A socket
timeout raises WireTimeoutError with `partial`: False means the deadline
tripped between messages (still framed: an idempotent RPC may retry),
True means mid-frame (desynced: only escalation is safe).

`send_msg` streams each buffer's bytes from the array itself and
`recv_msg` builds each array over the buffer it received into: a page
payload crosses each side once plus its CRC, where `encode_msg`'s one
blob (the bytes `send_msg` puts on the socket, for the fault injector)
would copy it twice more.

The payloads are the engine's own serialization surfaces: `snapshot()`
JSON, the `extract_request` / `inject_request` state dicts, TokenEvent /
RequestOutput dicts and the `extract_handoff` page payload. The
sampling helpers (`sampling_to_dict` / `sampling_from_dict`) are also the
JSON shape the engine's snapshot and the router's journal share.
"""

from __future__ import annotations

import errno
import json
import socket
import struct
import zlib
from dataclasses import asdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.serving.scheduler import SamplingParams

# one frame may carry a whole layer's stacked handoff pages; 1 GiB is far
# above any page payload and low enough to catch a corrupted length prefix
# before it turns into an allocation
MAX_FRAME_BYTES = 1 << 30

# RPCs a client may re-send after a deadline trip or a CRC reject: running
# them again inside the replica changes no engine state, and their replies
# carry no binary frames, so a retry never desyncs the stream. Everything
# else (step, submit, inject, handoff_*, ...) mutates and fails fast to
# the supervisor.
IDEMPOTENT_RPCS = frozenset(
    {"ping", "metrics", "audit", "check_no_leaks", "requests",
     "snapshot"})


class WireCorruptionError(ConnectionError):
    """A frame's payload failed its CRC-32 check. Raised only after the
    advertised payload bytes were consumed: the stream remains framed and
    the connection is still usable (NAK / idempotent retry)."""


class WireTimeoutError(ConnectionError):
    """A socket deadline tripped. `partial=False`: no byte of the message
    had been read, the stream is still framed and an idempotent RPC may
    retry. `partial=True`: the timeout hit mid-frame, the stream is
    desynced and only escalation (fence and respawn) is safe."""

    def __init__(self, msg: str, partial: bool):
        super().__init__(msg)
        self.partial = partial


def send_all(sock: socket.socket, data: bytes) -> None:
    """sendall with an explicit EINTR retry loop."""
    view = memoryview(data)
    while view:
        try:
            n = sock.send(view)
        except InterruptedError:
            continue
        except socket.timeout:
            raise WireTimeoutError("socket send timed out (peer not "
                                   "draining)", partial=True) from None
        except OSError as e:  # pragma: no cover - platform-dependent
            if e.errno == errno.EINTR:
                continue
            raise
        if n == 0:
            raise ConnectionError("socket closed mid-send")
        view = view[n:]


def recv_exact(sock: socket.socket, n: int,
               clean_start: bool = True) -> bytearray:
    """Read exactly n bytes into a fresh buffer, retrying partial recvs and
    EINTR. Raises ConnectionError on EOF (peer died), never returns short.
    A socket timeout raises WireTimeoutError, `partial` unless zero bytes
    were read AND the caller says this read began at a message boundary
    (`clean_start`)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            r = sock.recv_into(view[got:], n - got)
        except InterruptedError:
            continue
        except socket.timeout:
            raise WireTimeoutError(
                f"socket recv timed out ({got}/{n} bytes)",
                partial=got > 0 or not clean_start) from None
        except OSError as e:  # pragma: no cover - platform-dependent
            if e.errno == errno.EINTR:
                continue
            raise
        if r == 0:
            raise ConnectionError(
                f"socket closed mid-recv ({got}/{n} bytes)")
        got += r
    return buf


def _frame_head(payload) -> bytes:
    """The 8 bytes before a frame's payload: its length and CRC-32."""
    return struct.pack("<II", len(payload),
                       zlib.crc32(payload) & 0xFFFFFFFF)


def _frame(payload: bytes) -> bytes:
    return _frame_head(payload) + payload


def _raw(b: np.ndarray) -> memoryview:
    """An array's bytes in C order, without a copy when it is contiguous."""
    return memoryview(np.ascontiguousarray(b).reshape(-1).view(np.uint8))


def _header_frame(header: dict, bufs: Sequence[np.ndarray]) -> bytes:
    header = dict(header)
    header["bufs"] = [{"dtype": str(b.dtype), "shape": list(b.shape)}
                      for b in bufs]
    return _frame(json.dumps(header).encode())


def _recv_frame(sock: socket.socket, clean_start: bool = True) -> bytearray:
    head = recv_exact(sock, 8, clean_start=clean_start)
    n, crc = struct.unpack("<II", head)
    if n > MAX_FRAME_BYTES:
        raise ConnectionError(f"frame length {n} exceeds "
                              f"{MAX_FRAME_BYTES}: corrupted stream")
    payload = recv_exact(sock, n, clean_start=False) if n else bytearray()
    # checked AFTER the payload is consumed: the stream stays framed, so
    # the caller can NAK or retry without a resync
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise WireCorruptionError(
            f"frame CRC mismatch ({n} bytes): payload corrupted in "
            "transit")
    return payload


def encode_msg(header: dict, bufs: Sequence[np.ndarray] = ()) -> bytes:
    """One whole message (header frame + binary frames) as bytes: what
    send_msg puts on the socket, exposed so the wire fault injector can
    corrupt or truncate real framed bytes."""
    out = [_header_frame(header, bufs)]
    for b in bufs:
        out.append(_frame(_raw(b).tobytes()))
    return b"".join(out)


def send_msg(sock: socket.socket, header: dict,
             bufs: Sequence[np.ndarray] = ()) -> None:
    """Send one message: the JSON header and its binary frames, each
    buffer's bytes straight from its array."""
    send_all(sock, _header_frame(header, bufs))
    for b in bufs:
        raw = _raw(b)
        send_all(sock, _frame_head(raw))
        send_all(sock, raw)


def recv_msg(sock: socket.socket) -> Tuple[dict, List[np.ndarray]]:
    header = json.loads(_recv_frame(sock).decode())
    bufs = []
    corrupt: Optional[WireCorruptionError] = None
    for meta in header.pop("bufs", []):
        # consume EVERY advertised frame even when one fails its CRC: the
        # message must end framed, or the corruption would desync the next
        try:
            raw = _recv_frame(sock, clean_start=False)
        except WireCorruptionError as e:
            corrupt = e
            continue
        # the array owns the fresh buffer it was received into
        bufs.append(np.frombuffer(raw, dtype=np.dtype(meta["dtype"]))
                    .reshape(meta["shape"]))
    if corrupt is not None:
        raise corrupt
    return header, bufs


# ------------------------------------------------- payload (de)serializers


def sampling_to_dict(sampling) -> dict:
    """SamplingParams -> JSON-safe dict (the snapshot() shape)."""
    sp = asdict(sampling)
    sp["stop_token_ids"] = list(sp["stop_token_ids"])
    return sp


def sampling_from_dict(sp: dict) -> SamplingParams:
    sp = dict(sp)
    sp["stop_token_ids"] = tuple(sp.get("stop_token_ids", ()))
    return SamplingParams(**sp)


def state_to_wire(state: dict) -> dict:
    """An extract_request / registry state dict -> JSON-safe (its sampling
    field is a live SamplingParams)."""
    out = dict(state)
    out["sampling"] = sampling_to_dict(state["sampling"])
    return out


def state_from_wire(state: dict) -> dict:
    out = dict(state)
    out["sampling"] = sampling_from_dict(state["sampling"])
    return out


def events_to_wire(events) -> List[dict]:
    return [asdict(ev) for ev in events]


def events_from_wire(raw: Sequence[dict]):
    from paddle_tpu_torch.serving.engine import TokenEvent

    return [TokenEvent(**ev) for ev in raw]


def outputs_to_wire(outputs: Dict[str, object]) -> Dict[str, dict]:
    return {rid: asdict(o) for rid, o in outputs.items()}


def outputs_from_wire(raw: Dict[str, dict]):
    from paddle_tpu_torch.serving.engine import RequestOutput

    return {rid: RequestOutput(**o) for rid, o in raw.items()}


# ---------------------------------------------- handoff payload framing


def handoff_to_wire(payload: Optional[dict]
                    ) -> Tuple[dict, List[np.ndarray]]:
    """Flatten an extract_handoff page payload into (header, frames): per
    layer, per pool array, one stacked [n_slots, ...] binary frame (raw
    page bytes and scale rows in pool order), the per-slot content hashes
    in the header for the receiver's check. A slot-reference payload (the
    host-wide store's) serializes to the header alone."""
    if payload is None:
        return {"handoff": None}, []
    if payload.get("slot_refs") is not None:
        return {"handoff": {
            "start_page": payload["start_page"],
            "covered_tokens": payload["covered_tokens"],
            "slot_refs": [int(s) for s in payload["slot_refs"]],
            "gens": [int(g) for g in payload["gens"]],
            "hashes": [int(h) for h in payload["hashes"]],
            "xfer_owner": payload["xfer_owner"],
        }}, []
    bufs: List[np.ndarray] = []
    for layer in payload["layers"]:
        bufs.extend(layer)
    return {"handoff": {
        "start_page": payload["start_page"],
        "covered_tokens": payload["covered_tokens"],
        "hashes": [int(h) for h in payload["hashes"]],
        "arrays_per_layer": len(payload["layers"][0]),
        "num_layers": len(payload["layers"]),
    }}, bufs


def handoff_from_wire(header: dict,
                      bufs: Sequence[np.ndarray]) -> Optional[dict]:
    meta = header.get("handoff")
    if meta is None:
        return None
    if meta.get("slot_refs") is not None:
        return {"start_page": meta["start_page"],
                "covered_tokens": meta["covered_tokens"],
                "slot_refs": list(meta["slot_refs"]),
                "gens": list(meta["gens"]),
                "hashes": list(meta["hashes"]),
                "xfer_owner": meta["xfer_owner"]}
    per = meta["arrays_per_layer"]
    layers = [tuple(bufs[li * per + j] for j in range(per))
              for li in range(meta["num_layers"])]
    return {"start_page": meta["start_page"],
            "covered_tokens": meta["covered_tokens"],
            "hashes": list(meta["hashes"]),
            "layers": layers}
