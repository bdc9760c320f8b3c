"""Process groups over hosts and cards (twin of
``longterm360fov_tpu.parallel.multihost``).

JAX runs one controller over every local device and joins hosts with
``jax.distributed.initialize``; PyTorch runs one process per rank, joined by
``torch.distributed``. :func:`init_multihost` starts that process group from
what a launcher (``torchrun``, ``python -m torch.distributed.run``) puts in
the environment: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
and ``LOCAL_RANK`` (JAX reads ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``). Each rank computes on one
device, ``cuda:{LOCAL_RANK}`` unless the caller names another
(:func:`local_device`), and feeds only its contiguous rows of the global
batch (:func:`host_local_batch_slice`, :func:`global_batch`).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..params import tree_leaves, tree_unflatten

__all__ = [
    "init_multihost",
    "local_device",
    "host_local_batch_slice",
    "global_batch",
    "replicate_global",
]

DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def local_device(device=None) -> torch.device:
    """This rank's device: ``device``, or ``cuda:{LOCAL_RANK}`` (0 without a
    launcher). A CUDA device that torch cannot see raises and names it;
    nothing falls back to the CPU."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}, but torch sees no CUDA device")
        if device.index is not None and device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {device} (LOCAL_RANK {os.environ.get('LOCAL_RANK', 'unset')}), but torch sees "
                f"{torch.cuda.device_count()} CUDA device(s)"
            )
    return device


def init_multihost(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Start the default process group → True (also when one is already
    started); False, and nothing started, when single-process, so it is
    safe to call unconditionally at startup.

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK``, and
    ``init_method`` to ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``); a
    ``file://`` store needs no port. ``backend`` defaults to ``nccl`` for a
    CUDA ``device`` (default :func:`local_device`) and ``gloo`` for the CPU;
    ``gloo`` also takes CUDA tensors, for ``all_reduce`` and ``broadcast``,
    which is how two ranks share one card (NCCL refuses that). Every
    collective of the group fails after ``timeout`` rather than wait on a
    dead peer."""
    if dist.is_initialized():
        return True
    world = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and init_method is None:
        return False
    device = local_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend,
        init_method=init_method or "env://",
        world_size=world,
        rank=int(rank if rank is not None else os.environ["RANK"]),
        timeout=timeout,
    )
    return True


def host_local_batch_slice(n_global: int) -> slice:
    """This rank's contiguous rows of a globally batched array (all of them
    without a process group)."""
    if not dist.is_initialized():
        return slice(0, n_global)
    world, rank = dist.get_world_size(), dist.get_rank()
    per = n_global // world
    return slice(rank * per, (rank + 1) * per)


def global_batch(mesh, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """This rank's shard of the global batch (its rows, from
    :func:`host_local_batch_slice`) on the rank's device. JAX assembles one
    logically global array; a rank here holds only its own rows."""
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=mesh.device) for k, v in host_batch.items()}


def replicate_global(mesh, tree):
    """A params tree with rank 0's values on every rank, on the rank's
    device. JAX relies on every process drawing the same seeded init; the
    card's and the CPU's generators differ, so rank 0's values are
    broadcast."""
    return tree_unflatten(tree, mesh.broadcast([t.to(mesh.device) for t in tree_leaves(tree)]))
