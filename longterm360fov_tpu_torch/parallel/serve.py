"""Data-parallel serving: concurrent viewers split over a list of devices
(twin of ``longterm360fov_tpu.parallel.serve``).

Predictions are viewer-local, so no collective is needed: one process
replicates the params once per device, splits the batch into equal
contiguous slices, launches each slice on its device through the unmodified
single-card serve path (the hand-written kernels included) and gathers the
results in order. JAX's mesh is a ``('data',)`` axis of local devices inside
one ``shard_map``; here the serving mesh is the device list itself, and it
may name one device more than once (four slices on one card, as the CPU
tests and the one-card run use it). CUDA launches return at once, so the
slices of different cards overlap.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import infer
from ..config import ExperimentConfig
from ..params import walk

__all__ = ["mesh_devices", "shard_slices", "replicate_params", "make_sharded_predict_fn"]


def mesh_devices(mesh) -> List[torch.device]:
    """The serving mesh's devices, in order (repeats allowed)."""
    devices = [torch.device(d) for d in mesh]
    if not devices:
        raise ValueError("the serving mesh names no device")
    return devices


def shard_slices(n: int, size: int) -> List[slice]:
    """``size`` equal contiguous row slices of a batch of ``n``, with JAX's
    error when ``size`` does not divide ``n``."""
    if n % size:
        raise ValueError(f"batch {n} not divisible by mesh data size {size}")
    per = n // size
    return [slice(i * per, (i + 1) * per) for i in range(size)]


def replicate_params(params, devices) -> Dict[torch.device, object]:
    """The params on each distinct device of ``devices`` (no copy where they
    already are)."""
    return {d: walk(params, lambda _, t: t.to(d)) for d in dict.fromkeys(devices)}


def take_rows(v, rows: slice):
    """Rows ``rows`` of a host array or a tensor, contiguous and 16-byte
    aligned (a view where it already is): the kernels' wrappers refuse
    strided or misaligned input."""
    if not isinstance(v, torch.Tensor):
        return np.ascontiguousarray(np.asarray(v)[rows])
    t = v[rows]
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def gather(parts, device: torch.device):
    """The slices' results (tensors, or tuples of tensors) concatenated in
    order on ``device``."""
    if isinstance(parts[0], tuple):
        return tuple(gather([p[i] for p in parts], device) for i in range(len(parts[0])))
    return torch.cat([p.to(device) for p in parts])


def make_sharded_predict_fn(
    params,
    cfg: ExperimentConfig,
    fam,
    mesh,
    *,
    impl: str = "fused",
    extras_fn: Optional[Callable] = None,
    **kw,
) -> Callable:
    """``infer.make_predict_fn``, sharded: ``serve(past, context=None)``
    splits the batch's leading (viewer) axis over the devices of ``mesh``
    (``past`` a (B, H_in, 3) array or tensor or a batch dict; B a multiple
    of the mesh's size), serves each slice on its device with ``fam``'s
    forward (``extras_fn`` in place of its ``batch_extras``) and returns the
    results in order on the mesh's first device. ``kw`` goes to
    ``make_predict_fn`` (``with_tiles`` and the tile grid)."""
    devices = mesh_devices(mesh)
    serves = {
        d: infer.make_predict_fn(p, cfg, device=d, impl=impl, fam=fam, extras_fn=extras_fn, **kw)
        for d, p in replicate_params(params, devices).items()
    }

    def sharded(past, context=None):
        batch = dict(past) if isinstance(past, dict) else {"past": past}
        if context is not None:
            batch["context"] = context
        batch = {k: v for k, v in batch.items() if v is not None}
        slices = shard_slices(len(batch["past"]), len(devices))
        parts = [serves[d]({k: take_rows(v, rows) for k, v in batch.items()}) for d, rows in zip(devices, slices)]
        return gather(parts, devices[0])

    return sharded
