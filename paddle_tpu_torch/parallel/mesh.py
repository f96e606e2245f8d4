"""The serving mesh: named axes over devices, and its two plain collectives.

Counterpart of paddle_tpu/parallel/mesh.py::serving_mesh and
replica_submeshes, over `Mesh`, a small counterpart of
`jax.sharding.Mesh`: ``axis_names``, ``shape`` (an ordered dict of axis
sizes, as JAX's), ``devices`` (a numpy object array of `torch.device`)
and equality.

The port is single-controller, as the JAX engine is: one process drives
every shard. A shard's weights and pool slices are tensors of their own,
and a collective is an explicit reduction over the shards' tensors
(`psum`, `all_gather`, and the quantized pair in
`quantization.qcomm`): every part goes to the axis's first shard's
device, is combined there in shard order, and the result goes back to
each shard's device. On one device those copies are no-ops.

Where the port departs from JAX:
  * one device may hold several shards: ``serving_mesh(1, 2,
    devices=[torch.device("cuda", 0)] * 2)`` runs a tp = 2 engine on one
    card, each shard's attention at its own head count (JAX's Mesh refuses
    repeated devices);
  * a mesh that mixes device types raises ValueError;
  * a mesh over distinct CUDA devices raises NotImplementedError: its
    collectives would cross cards (ROADMAP.md 'Still to port',
    item 26, "multi-card collectives").
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

MULTI_CARD_ITEM = ("ROADMAP.md 'Still to port' item 26 (multi-card "
                   "collectives)")


def _device(d) -> torch.device:
    """``d`` as a torch.device; a CUDA device without an index is card 0."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class Mesh:
    """Devices laid out on named axes: ``devices`` an array of any shape
    (or a nested sequence), one name per axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        names = tuple(str(a) for a in axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"mesh devices of shape {arr.shape} need "
                             f"{arr.ndim} axis names, got {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names repeat: {names}")
        flat = [_device(d) for d in arr.reshape(-1)]
        out = np.empty(len(flat), dtype=object)
        out[:] = flat
        self.devices = out.reshape(arr.shape)
        self.axis_names = names
        types = {d.type for d in flat}
        if len(types) > 1:
            raise ValueError(f"a mesh holds one device type, got "
                             f"{sorted(types)}")
        cards = {d.index for d in flat if d.type == "cuda"}
        if len(cards) > 1:
            raise NotImplementedError(
                f"a mesh over CUDA devices {sorted(cards)}: collectives "
                f"across cards are not ported yet: {MULTI_CARD_ITEM}. "
                "A mesh may hold several shards on one card")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: the
        shards of a runner sharded over ``axis``, in shard order."""
        idx = self.axis_names.index(axis)
        arr = np.moveaxis(self.devices, idx, 0)
        return [arr[i].reshape(-1)[0] for i in range(arr.shape[0])]

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.reshape(-1),
                                               other.devices.reshape(-1))))

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape,
                     tuple(str(d) for d in self.devices.reshape(-1))))

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        devs = sorted({str(d) for d in self.devices.reshape(-1)})
        return f"Mesh({axes}; {', '.join(devs)})"


def serving_mesh(data: int = 1, model: int = 1,
                 devices: Optional[Sequence] = None,
                 data_axis: str = "data",
                 model_axis: str = "model") -> Mesh:
    """Build the serving ``(data, model)`` mesh over the first data * model
    of ``devices``. Without ``devices`` the list is the cards'
    (``torch.cuda.device_count()`` of them), so on one card
    ``serving_mesh(model=2)`` raises "needs", as JAX does on one chip;
    pass ``devices=[torch.device("cuda", 0)] * 2`` to put two shards on
    it, or ``["cpu"] * 4`` on the CPU."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} "
                         f"model={model}")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = data * model
    if n > len(devices):
        raise ValueError(f"serving mesh ({data_axis}={data}, "
                         f"{model_axis}={model}) needs {n} devices, "
                         f"have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [_device(d) for d in list(devices)[:n]]
    return Mesh(arr.reshape(data, model), (data_axis, model_axis))


def replica_submeshes(mesh: Mesh, data_axis: str = "data",
                      model_axis: str = "model") -> List[Mesh]:
    """Split a serving ``(data, model)`` mesh into data-many ``(data=1,
    model)`` sub-meshes, one per engine replica, each keeping every other
    axis of the parent and a size-1 data axis (JAX's rule)."""
    names = list(mesh.axis_names)
    if data_axis not in names:
        raise ValueError(f"mesh axes {tuple(names)} have no "
                         f"{data_axis!r} axis to split replicas over")
    axis = names.index(data_axis)
    devs = np.moveaxis(mesh.devices, axis, 0)
    rest = (data_axis,) + tuple(n for n in names if n != data_axis)
    return [Mesh(devs[i][None, ...], rest) for i in range(devs.shape[0])]


# ------------------------------------------------ the plain collectives


def to_first(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every part on the first part's device (no copy where it lies)."""
    dev = parts[0].device
    return [p.to(dev) for p in parts]


def to_each(x: torch.Tensor, parts: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    """``x`` on each part's device: the result every shard receives."""
    return [x.to(p.device) for p in parts]


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The fp32 allreduce of the shards' partial sums: summed on the first
    shard's device in shard order, the sum returned to every shard."""
    first = to_first(parts)
    total = first[0]
    for p in first[1:]:
        total = total + p
    return to_each(total, parts)


def all_gather(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The tiled all-gather of the shards' last-axis slices, in shard order
    (JAX's ``all_gather(x, axis, axis=-1, tiled=True)``)."""
    return to_each(torch.cat(to_first(parts), dim=-1), parts)
