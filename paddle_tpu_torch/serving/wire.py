"""Payload serializers of the serving tier.

Counterpart of the payload half of paddle_tpu/serving/wire.py:
`sampling_to_dict` / `sampling_from_dict`, the JSON shape of a
SamplingParams that the engine's snapshot, the router's write-ahead
journal and its registry share. The framing of the JAX module (length
and CRC-32 prefixed frames, numpy buffers over a socket, the socket
codec, `WireFaultInjector`) carries the process backend's commands and
belongs to ROADMAP.md item 11 part B.
"""

from __future__ import annotations

from dataclasses import asdict

from paddle_tpu_torch.serving.scheduler import SamplingParams


def sampling_to_dict(sampling) -> dict:
    """SamplingParams -> JSON-safe dict (the snapshot() shape)."""
    sp = asdict(sampling)
    sp["stop_token_ids"] = list(sp["stop_token_ids"])
    return sp


def sampling_from_dict(sp: dict) -> SamplingParams:
    sp = dict(sp)
    sp["stop_token_ids"] = tuple(sp.get("stop_token_ids", ()))
    return SamplingParams(**sp)
