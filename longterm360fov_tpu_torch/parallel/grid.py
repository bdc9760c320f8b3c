"""Device grids of one process: the meshes of sequence, pipeline and tensor
parallelism (twin of ``jax.sharding.Mesh`` over local devices).

JAX runs one controller over a mesh of devices and splits a program over its
axes with ``shard_map`` or GSPMD. Here one process holds a grid of
``torch.device`` entries with JAX's axis names and shape, and runs each
shard's work on its entry's device, one shard after another: CUDA launches
return at once, so the shards of different cards overlap. A grid may name one
device more than once (the one card, or the CPU, as several shards), as the
serving mesh of :mod:`.serve` may.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["DeviceGrid", "local_devices", "device_list", "grid_of"]


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """The local devices of a run on ``device_type``: every visible card for
    "cuda", one device for the CPU (JAX's ``jax.devices()``)."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def device_list(devices: Optional[Sequence] = None, device_type: str = "cuda") -> List[torch.device]:
    """``devices`` as torch devices, or :func:`local_devices` of
    ``device_type`` when None."""
    if devices is None:
        return local_devices(device_type)
    return [torch.device(d) for d in devices]


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """Devices in an array of one axis a name, as a JAX ``Mesh``:
    ``devices`` (an object array of ``torch.device``), ``axis_names``,
    ``shape`` {name: size} in axis order."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def rows(self, axis: str) -> List[List[torch.device]]:
        """The grid as rows along ``axis``, the last axis: one list of
        devices for each index of the axes before it (one row for a 1-D
        grid)."""
        if self.axis_names[-1] != axis:
            raise ValueError(f"axis {axis!r} is not the last of {self.axis_names}")
        return [list(r) for r in self.devices.reshape(-1, self.devices.shape[-1])]


def grid_of(devices: Sequence[torch.device], shape: Tuple[int, ...], axis_names: Tuple[str, ...]) -> DeviceGrid:
    """The first ``prod(shape)`` of ``devices`` as a grid of ``shape``."""
    n = int(np.prod(shape))
    arr = np.empty(n, dtype=object)
    arr[:] = list(devices[:n])
    return DeviceGrid(arr.reshape(shape), tuple(axis_names))
