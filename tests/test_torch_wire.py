"""The port's wire protocol against the JAX package's, on the CPU.

Ports the framing pins of tests/test_serving_procs.py (TestWire) and
tests/test_serving_durability.py (TestWireFraming, the fault injector's
unit pins), and holds the port's frames against the JAX package's: the
same header and buffers encode to the same bytes, a message either side
sends over a `socket.socketpair()` decodes on the other, a corrupted
header or buffer frame is rejected after its bytes are consumed (the next
message still parses), an insane length prefix is loud, a timeout is
clean between messages and partial inside one, `IDEMPOTENT_RPCS` is the
JAX set, and the handoff, state, event and output payloads round-trip and
serialize as the JAX ones do.
"""

import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest

from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import WireFaultInjector as JaxWireFaultInjector
from paddle_tpu.serving import wire as jax_wire
from paddle_tpu.serving.engine import RequestOutput as JaxRequestOutput
from paddle_tpu.serving.engine import TokenEvent as JaxTokenEvent
from paddle_tpu_torch.serving import SamplingParams, WireFaultInjector
from paddle_tpu_torch.serving import wire
from paddle_tpu_torch.serving.engine import RequestOutput, TokenEvent

MESSAGES = {
    "header only": ({"cmd": "ping", "seq": 3, "ack_outputs": []}, []),
    "nested header": ({"cmd": "submit", "prompt_tokens": [1, 2, 3],
                       "sampling": {"max_tokens": 4, "temperature": 0.5,
                                    "stop_token_ids": [7]},
                       "request_id": None, "ratio": 0.125}, []),
    "page frames": ({"cmd": "handoff_inject", "seq": 9}, [
        np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2),
        np.arange(-12, 12, dtype=np.int8).reshape(2, 3, 4),
        np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3),
        np.arange(8, dtype=np.int16), np.arange(5, dtype=np.uint8),
        np.arange(3, dtype=np.int64), np.zeros((0, 4), np.float32)]),
}


def _pair():
    a, b = socket.socketpair()
    return a, b


@pytest.mark.parametrize("case", sorted(MESSAGES))
def test_frames_are_bit_equal_to_jax(case):
    header, bufs = MESSAGES[case]
    assert wire.encode_msg(header, bufs) == jax_wire.encode_msg(header,
                                                                bufs)


@pytest.mark.parametrize("case", sorted(MESSAGES))
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_each_side_decodes_the_other(case, direction):
    header, bufs = MESSAGES[case]
    send, recv = ((wire, jax_wire) if direction == "port_to_jax"
                  else (jax_wire, wire))
    a, b = _pair()
    try:
        send.send_msg(a, header, bufs)
        send.send_msg(a, {"cmd": "after"})
        got, got_bufs = recv.recv_msg(b)
        assert got == header
        assert len(got_bufs) == len(bufs)
        for x, y in zip(got_bufs, bufs):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
        assert recv.recv_msg(b)[0] == {"cmd": "after"}
    finally:
        a.close()
        b.close()


def test_constants_equal_jax():
    assert wire.IDEMPOTENT_RPCS == jax_wire.IDEMPOTENT_RPCS
    assert wire.MAX_FRAME_BYTES == jax_wire.MAX_FRAME_BYTES
    assert issubclass(wire.WireCorruptionError, ConnectionError)
    assert issubclass(wire.WireTimeoutError, ConnectionError)


def test_recv_exact_survives_partial_writes():
    """A frame dribbled one byte at a time reassembles whole."""
    a, b = _pair()
    payload = struct.pack("<II", 5, zlib.crc32(b"hello")) + b"hello"

    def dribble():
        for i in range(len(payload)):
            a.sendall(payload[i:i + 1])
            time.sleep(0.001)

    t = threading.Thread(target=dribble)
    t.start()
    try:
        assert wire._recv_frame(b) == b"hello"
    finally:
        t.join(10)
        assert not t.is_alive()
        a.close()
        b.close()


def test_eof_mid_frame_raises_connection_error():
    a, b = _pair()
    a.sendall(struct.pack("<II", 100, 0) + b"short")
    a.close()
    with pytest.raises(ConnectionError):
        wire._recv_frame(b)
    b.close()


@pytest.mark.parametrize("where", ["header", "first buffer", "last buffer"])
def test_corrupted_frame_rejected_stream_stays_framed(where):
    """A flipped payload byte raises WireCorruptionError, and the NEXT
    message on the same socket still parses: the corrupted frame's bytes
    (and the rest of its message) were consumed. The JAX receiver rejects
    the same corrupted bytes the same way. (A corrupted header cannot say
    how many buffer frames follow it, so that case sends none, as the
    replies of idempotent RPCs, the only ones retried, carry none.)"""
    bufs = ([] if where == "header"
            else [np.zeros(8, np.int8), np.ones(8, np.int8)])
    blob = bytearray(wire.encode_msg({"cmd": "evil"}, bufs))
    head_len = 8 + struct.unpack("<I", bytes(blob[:4]))[0]
    at = {"header": 8, "first buffer": head_len + 8,
          "last buffer": len(blob) - 3}[where]
    blob[at] ^= 0xFF
    for side in (wire, jax_wire):
        a, b = _pair()
        try:
            a.sendall(bytes(blob))
            wire.send_msg(a, {"cmd": "good"})
            with pytest.raises(side.WireCorruptionError, match="CRC"):
                side.recv_msg(b)
            assert side.recv_msg(b)[0]["cmd"] == "good"
        finally:
            a.close()
            b.close()


def test_insane_length_prefix_is_loud_not_allocating():
    a, b = _pair()
    a.sendall(struct.pack("<II", wire.MAX_FRAME_BYTES + 1, 0))
    with pytest.raises(ConnectionError, match="exceeds"):
        wire._recv_frame(b)
    a.close()
    b.close()


def test_timeout_clean_vs_partial():
    a, b = _pair()
    b.settimeout(0.1)
    with pytest.raises(wire.WireTimeoutError) as ei:
        wire.recv_msg(b)
    assert ei.value.partial is False     # no byte read: retryable
    a.sendall(b"\x08\x00")               # half a frame header
    with pytest.raises(wire.WireTimeoutError) as ei:
        wire.recv_msg(b)
    assert ei.value.partial is True      # mid-frame: desynced
    a.close()
    b.close()


def test_send_timeout_is_partial():
    """A peer that never drains: the send deadline raises a partial
    WireTimeoutError (the stream may hold half a frame)."""
    a, b = _pair()
    a.settimeout(0.1)
    with pytest.raises(wire.WireTimeoutError) as ei:
        wire.send_all(a, b"x" * (64 << 20))
    assert ei.value.partial is True
    a.close()
    b.close()


# ------------------------------------------------------------ payloads


def _payload(kv="fp32", slots=2, layers=2):
    rng = np.random.default_rng(3)
    if kv == "int8":
        layer = lambda: (  # noqa: E731
            rng.integers(-128, 128, (slots, 4, 2, 8), dtype=np.int8),
            rng.integers(-128, 128, (slots, 4, 2, 8), dtype=np.int8),
            rng.random((slots, 2), dtype=np.float32),
            rng.random((slots, 2), dtype=np.float32))
    else:
        layer = lambda: (  # noqa: E731
            rng.standard_normal((slots, 4, 2, 8), dtype=np.float32),
            rng.standard_normal((slots, 4, 2, 8), dtype=np.float32))
    return {"start_page": 1, "covered_tokens": 9,
            "hashes": [int(h) for h in rng.integers(0, 2**32, slots)],
            "layers": [layer() for _ in range(layers)]}


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_handoff_payload_roundtrips_and_frames_as_jax(kv):
    payload = _payload(kv)
    header, bufs = wire.handoff_to_wire(payload)
    jheader, jbufs = jax_wire.handoff_to_wire(payload)
    assert header == jheader
    assert wire.encode_msg(header, bufs) == jax_wire.encode_msg(jheader,
                                                                jbufs)
    a, b = _pair()
    try:
        wire.send_msg(a, dict(header, cmd="handoff_inject"), bufs)
        got_header, got_bufs = wire.recv_msg(b)
    finally:
        a.close()
        b.close()
    back = wire.handoff_from_wire(got_header, got_bufs)
    assert back["start_page"] == 1 and back["covered_tokens"] == 9
    assert back["hashes"] == payload["hashes"]
    for la, lb in zip(back["layers"], payload["layers"]):
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert wire.handoff_from_wire(*wire.handoff_to_wire(None)) is None
    assert jax_wire.handoff_from_wire(
        *wire.handoff_to_wire(None)) is None


def test_slot_reference_payload_is_header_only_as_jax():
    payload = {"start_page": 0, "covered_tokens": 4, "slot_refs": [3, 5],
               "gens": [1, 2], "hashes": [11, 22], "xfer_owner": "x"}
    header, bufs = wire.handoff_to_wire(payload)
    assert bufs == [] and header == jax_wire.handoff_to_wire(payload)[0]
    assert wire.handoff_from_wire(header, []) == payload


def test_sampling_and_state_roundtrip_as_jax():
    sp = SamplingParams(max_tokens=7, temperature=0.3, top_k=5, seed=42,
                        stop_token_ids=(1, 2), session_id="s1")
    jsp = JaxSamplingParams(max_tokens=7, temperature=0.3, top_k=5,
                            seed=42, stop_token_ids=(1, 2),
                            session_id="s1")
    assert wire.sampling_from_dict(wire.sampling_to_dict(sp)) == sp
    assert wire.sampling_to_dict(sp) == jax_wire.sampling_to_dict(jsp)
    state = {"request_id": "r", "prompt_tokens": [1, 2],
             "output_tokens": [3], "sampling": sp, "arrival_index": 4,
             "num_preemptions": 0, "elapsed_s": 0.5,
             "first_token_elapsed_s": None}
    out = wire.state_to_wire(state)
    assert out == jax_wire.state_to_wire(dict(state, sampling=jsp))
    assert wire.state_from_wire(out) == state


def test_events_and_outputs_roundtrip_as_jax():
    evs = [TokenEvent("a", 5, 0), TokenEvent("a", 6, 1, True, "length")]
    jevs = [JaxTokenEvent("a", 5, 0), JaxTokenEvent("a", 6, 1, True,
                                                    "length")]
    raw = wire.events_to_wire(evs)
    assert raw == jax_wire.events_to_wire(jevs)
    assert wire.events_from_wire(raw) == evs
    outs = {"a": RequestOutput("a", [1], [5, 6], "length", 0, 0.1, 0.2)}
    jouts = {"a": JaxRequestOutput("a", [1], [5, 6], "length", 0, 0.1,
                                   0.2)}
    raw = wire.outputs_to_wire(outs)
    assert raw == jax_wire.outputs_to_wire(jouts)
    assert wire.outputs_from_wire(raw) == outs


# ------------------------------------------------ the wire fault injector

SCHEDULES = {
    "corrupt every 2, idempotent": dict(corrupt_every=2,
                                        target="idempotent"),
    "reset call 2 of step": dict(reset_calls=[2], target="step"),
    "drop call 1 of snapshot": dict(drop_calls=[1], target="snapshot"),
    "mutating, several classes": dict(drop_every=3, delay_calls=[2, 4],
                                      truncate_calls=[4], target="mutating"),
    "all, every class": dict(reset_calls=[5], truncate_every=4,
                             corrupt_calls=[2, 4], drop_calls=[3],
                             delay_every=6),
}
CMDS = ["ping", "step", "metrics", "submit", "snapshot", "step", "audit",
        "handoff_inject", "step", "requests", "flush", "ping", "snapshot",
        "step"]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_wire_fault_injector_schedules_equal_jax(name):
    """The same schedule over the same RPC sequence picks the same fault
    on the same attempt as the JAX injector, and counts the same."""
    inj = WireFaultInjector(**SCHEDULES[name])
    jinj = JaxWireFaultInjector(**SCHEDULES[name])
    assert [inj.action(c) for c in CMDS] == [jinj.action(c) for c in CMDS]
    assert inj.injected == jinj.injected and inj.calls == jinj.calls


def test_wire_fault_injector_targets():
    inj = WireFaultInjector(corrupt_every=2, target="idempotent")
    assert inj.action("step") is None          # not matched
    assert inj.action("ping") is None          # call 1
    assert inj.action("metrics") == "corrupt"  # call 2
    assert inj.injected["corrupt"] == 1
    inj2 = WireFaultInjector(reset_calls=[2], target="step")
    assert inj2.action("ping") is None
    assert inj2.action("step") is None         # step call 1
    assert inj2.action("step") == "reset"      # step call 2


@pytest.mark.parametrize("case", sorted(MESSAGES))
def test_send_msg_puts_encode_msg_bytes_on_the_socket(case):
    """send_msg streams the buffers from their arrays (a strided one
    through a contiguous copy): the bytes on the socket are encode_msg's,
    the ones the fault injector corrupts."""
    header, bufs = MESSAGES[case]
    bufs = list(bufs) + [np.arange(12, dtype=np.float32).reshape(3, 4)[:, 1::2]]
    a, b = _pair()
    try:
        wire.send_msg(a, header, bufs)
        a.shutdown(socket.SHUT_WR)
        got = bytearray()
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                break
            got += chunk
    finally:
        a.close()
        b.close()
    assert bytes(got) == jax_wire.encode_msg(header, bufs)


def test_process_tier_names_export_as_jax():
    import paddle_tpu.serving as jax_serving
    import paddle_tpu_torch.serving as serving
    for name in ("EngineClient", "ReplicaLauncher", "ReplicaGoneError",
                 "WireCorruptionError", "WireFaultInjector",
                 "WireTimeoutError"):
        assert name in jax_serving.__all__ and name in serving.__all__
        assert getattr(serving, name).__name__ == name
    assert issubclass(serving.ReplicaGoneError, serving.ReplicaCrashError)
