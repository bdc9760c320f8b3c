"""Data-parallel training over ``torch.distributed`` (twin of
``longterm360fov_tpu.parallel.mesh``).

JAX shards the batch over a ``('data',)`` mesh of local devices inside one
``shard_map`` and averages the gradients with ``pmean``. Here each rank is a
process (``multihost.init_multihost``) that holds a replica of the train
state and its contiguous rows of the global batch, runs the single-card step
on them (``train.make_train_step``, the fused kernels included) and averages
the gradients with one ``all_reduce``: the collective is the only difference,
so world size 1 is bit-equal to the single-card step.

The mesh is a :class:`DataMesh` of the port's own, not ``DeviceMesh``: the
step needs only the group, the world size, the rank and this rank's device,
and world size 1 runs with no process group at all, where ``DeviceMesh``
would start one. The ranks exchange nothing but ``all_reduce`` and
``broadcast``, the two collectives gloo takes on CUDA tensors, so two ranks
can share one card over gloo (NCCL refuses two ranks on one GPU). The
gradients ride in one flat buffer per dtype, each in the dtype the single-card
step hands the optimizer, with the loss and the great-circle metric in the
f32 buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import train as train_mod
from ..config import ExperimentConfig
from ..draws import RankDraw
from ..params import tree_leaves, tree_unflatten
from . import grid, multihost

__all__ = ["DataMesh", "make_mesh", "shard_batch", "replicate_state", "make_sharded_train_step", "train_loop_dp"]


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The ``('data',)`` axis as this rank sees it: its device, the world
    size, its rank, and the process group (None: a world of one with no
    group, where nothing is exchanged)."""

    device: torch.device
    world: int = 1
    rank: int = 0
    group: Any = None
    axis_names: ClassVar[Tuple[str, ...]] = ("data",)

    def rows(self, n_global: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n_global``,
        which the world size must divide."""
        if n_global % self.world:
            raise ValueError(f"batch {n_global} not divisible by mesh data size {self.world}")
        per = n_global // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def draw(self, gen: torch.Generator) -> RankDraw:
        """The step's draws as this rank's rows of the global batch's."""
        return RankDraw(gen, self.rank, self.world, self.group)

    def _flat(self, tensors: List[torch.Tensor], fn, own: bool = False) -> List[torch.Tensor]:
        """Apply the in-place collective ``fn`` to one flat buffer per dtype
        of ``tensors`` and return them rebuilt, in order: views of the
        buffer, or with ``own`` tensors of their own (a view may start off
        the 16-byte alignment the kernels' wrappers require)."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
            buf = torch.cat([tensors[i].reshape(-1) for i in idx])
            fn(buf)
            for i, part in zip(idx, buf.split([tensors[i].numel() for i in idx])):
                out[i] = part.view(tensors[i].shape).clone() if own else part.view(tensors[i].shape)
        return out

    def broadcast(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Rank 0's values of ``tensors`` (on this rank's device), each a
        tensor of its own."""
        if self.group is None:
            return list(tensors)
        return self._flat(tensors, lambda buf: dist.broadcast(buf, group=self.group, group_src=0), own=True)

    def pmean(self, loss, gc_deg, grads):
        """``(loss, gc_deg, grads)`` averaged over the ranks (JAX's
        ``pmean``: the sum, then divided by the world size), the scalars in
        the f32 buffer beside the f32 gradients; the gradients are views of
        the reduced buffers, which only the optimizer reads."""
        if self.group is None:
            return loss, gc_deg, grads
        leaves = tree_leaves(grads)
        scalars = [torch.as_tensor(v, dtype=torch.float32, device=self.device).reshape(1) for v in (loss, gc_deg)]

        def mean(buf):
            dist.all_reduce(buf, group=self.group)
            buf /= self.world

        out = self._flat(leaves + scalars, mean)
        return out[-2][0], out[-1][0], tree_unflatten(grads, out[:-2])

    def barrier(self):
        """Wait for every rank (an ``all_reduce`` of one element, which both
        backends take on this rank's device)."""
        if self.group is not None:
            dist.all_reduce(torch.zeros(1, device=self.device), group=self.group)

    def slowest(self, seconds: float) -> float:
        """The largest of the ranks' ``seconds``."""
        if self.group is None:
            return seconds
        t = torch.tensor([seconds], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return float(t[0])


def make_mesh(device=None, *, model_parallel: int = 1, devices=None):
    """The ``('data',)`` mesh of this rank: every rank of the default group
    once ``multihost.init_multihost`` started one, else a world of one,
    computing on ``multihost.local_device(device)``.

    ``model_parallel`` > 1 gives tensor parallelism's ``('data', 'model')``
    grid (``grid.DeviceGrid``) over ``devices``, default the local devices of
    ``device``'s type (every visible card without one), in rows of
    ``model_parallel``, as JAX's ``make_mesh``."""
    if model_parallel > 1:
        kind = "cuda" if device is None else torch.device(device).type
        devices = grid.device_list(devices, kind)
        n = len(devices)
        if n % model_parallel:
            raise ValueError(f"{n} devices not divisible by mp={model_parallel}")
        return grid.grid_of(devices, (n // model_parallel, model_parallel), ("data", "model"))
    device = multihost.local_device(device)
    if not dist.is_initialized():
        return DataMesh(device)
    return DataMesh(device, dist.get_world_size(), dist.get_rank(), dist.group.WORLD)


def shard_batch(mesh: DataMesh, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global host batch, on the rank's device."""
    rows = mesh.rows(len(batch["past"]))
    return multihost.global_batch(mesh, {k: v[rows] for k, v in batch.items() if v is not None})


def replicate_state(mesh: DataMesh, state: train_mod.TrainState) -> train_mod.TrainState:
    """Rank 0's train state on every rank: the params, both Adam moments,
    the optimizer's count and the step, on the rank's device."""
    params, opt = tree_leaves(state.params), state.opt_state
    n = len(params)
    counts = torch.tensor([opt.count, state.step], dtype=torch.int64, device=mesh.device)
    leaves = mesh.broadcast([t.to(mesh.device) for t in params + opt.mu + opt.nu] + [counts])
    count, step = (int(v) for v in leaves[-1])
    return train_mod.TrainState(
        tree_unflatten(state.params, leaves[:n]),
        train_mod.AdamState(count, leaves[n:2 * n], leaves[2 * n:3 * n]),
        step,
        state.rng,
    )


def make_sharded_train_step(
    cfg: ExperimentConfig,
    apply_fn: Callable,
    optimizer: train_mod.Optimizer,
    mesh: DataMesh,
    extras_fn: Optional[Callable] = None,
    fused_tf_fn: Optional[Callable] = None,
    fused_ss_fn: Optional[Callable] = None,
    gc_metric: bool = True,
) -> Callable:
    """``step(state, batch) -> (state, metrics)`` with ``batch`` this rank's
    rows: the single-card step (``cfg.accum`` microbatches of the rank's
    rows, the fused routes) with the gradients averaged over the ranks."""
    return train_mod.make_train_step(
        cfg, apply_fn, optimizer, extras_fn=extras_fn, fused_tf_fn=fused_tf_fn,
        fused_ss_fn=fused_ss_fn, gc_metric=gc_metric, mesh=mesh,
    )


def train_loop_dp(
    cfg: ExperimentConfig,
    init_fn: Callable,
    apply_fn: Callable,
    data: Dict[str, np.ndarray],
    *,
    mesh: Optional[DataMesh] = None,
    device=None,
    eval_data=None,
    log_file: Optional[str] = None,
    tb_dir: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    state: Optional[train_mod.TrainState] = None,
    extras_fn: Optional[Callable] = None,
    fused_tf_fn: Optional[Callable] = None,
    fused_ss_fn: Optional[Callable] = None,
):
    """Data-parallel twin of ``train.train_loop`` → (state, history), the
    same on every rank. The global batch (``cfg.batch_size``) is rounded
    down to a multiple of the world size and split evenly over the ranks;
    every rank draws the same ``batch_iterator`` batches from ``cfg.seed``
    and takes its rows. ``mesh`` defaults to :func:`make_mesh` on
    ``device``; the state (fresh from ``init_fn`` or restored) becomes rank
    0's on every rank."""
    mesh = mesh or make_mesh(device)
    bs = (cfg.batch_size // mesh.world) * mesh.world
    if bs == 0:
        raise ValueError(f"batch_size {cfg.batch_size} < mesh size {mesh.world}")
    cfg = cfg.replace(batch_size=bs)
    if state is None:
        state = train_mod.init_state(cfg, init_fn, train_mod.make_optimizer(cfg), device=mesh.device)
    state = replicate_state(mesh, state)
    return train_mod.train_loop(
        cfg, init_fn, apply_fn, data, device=mesh.device, eval_data=eval_data, log_file=log_file,
        tb_dir=tb_dir, checkpoint_dir=checkpoint_dir, state=state, extras_fn=extras_fn,
        fused_tf_fn=fused_tf_fn, fused_ss_fn=fused_ss_fn, mesh=mesh,
    )
