"""Places and device selection.

Counterpart of paddle_tpu/core/place.py. A Place names a backend and a
device index; the process keeps one expected place, where `to_tensor`
and the creation functions put their tensors. The port's default is the
card (`device.resolve_device`'s default): "gpu" names it, as "gpu:0" or
"cuda" do, and asking for it on a machine without CUDA raises when a
tensor is made there, never before (import stays free of CUDA). "cpu"
runs the plain PyTorch versions; `set_device("cpu")` is how a caller
asks for them. `set_device` takes any backend name, as JAX's does; a
Place of another backend ("tpu", ...) names no device of the port and
raises when a tensor is made there.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.device import resolve_device


class Place:
    """A (backend, device_id) pair."""

    backend: str = "cpu"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        """The torch.device this place names; the card's raises where
        torch.cuda.is_available() is False."""
        if self.backend == "cpu":
            return torch.device("cpu")
        if self.backend == "gpu":
            return resolve_device(torch.device("cuda", self.device_id))
        raise ValueError(f"the port runs on 'gpu' or 'cpu', got a place "
                         f"of backend {self.backend!r}")

    def __eq__(self, other):
        return (isinstance(other, Place) and self.backend == other.backend
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.backend, self.device_id))

    def __repr__(self):
        return f"Place({self.backend}:{self.device_id})"


class CPUPlace(Place):
    backend = "cpu"


class CUDAPlace(Place):
    backend = "gpu"


class TPUPlace(Place):
    backend = "tpu"


_CLASSES = {"cpu": CPUPlace, "gpu": CUDAPlace, "tpu": TPUPlace}
_expected_place: Place | None = None


def place_of(device) -> Place:
    """The Place of a torch.device (or of a device string)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return CUDAPlace(dev.index or 0)
    return CPUPlace(0)


def set_device(device: str) -> Place:
    """paddle.device.set_device: "cpu", "gpu", "gpu:0" ("cuda" is the same
    as "gpu")."""
    global _expected_place
    backend, _, idx = str(device).partition(":")
    if backend == "cuda":
        backend = "gpu"
    cls = _CLASSES.get(backend)
    if cls is None:
        place = Place(int(idx) if idx else 0)
        place.backend = backend
    else:
        place = cls(int(idx) if idx else 0)
    _expected_place = place
    return place


def get_device() -> str:
    p = expected_place()
    return f"{p.backend}:{p.device_id}"


def expected_place() -> Place:
    """The place tensors are made on: the card unless set_device chose
    another."""
    global _expected_place
    if _expected_place is None:
        _expected_place = CUDAPlace(0)
    return _expected_place


def expected_device() -> torch.device:
    """The torch.device of the expected place (raises without a card when
    that place is the card)."""
    return expected_place().torch_device()


def device_count(backend: str | None = None) -> int:
    """Devices of the backend (the expected place's by default): the
    cards for "gpu", one for "cpu"."""
    backend = backend or expected_place().backend
    if backend in ("gpu", "cuda"):
        return torch.cuda.device_count()
    return 1 if backend == "cpu" else 0
