"""Tensor parallelism over a ``('data', 'model')`` device grid (twin of
``longterm360fov_tpu.parallel.tp``).

JAX annotates each param with a sharding over the grid and jits the same
step: GSPMD partitions every product and inserts the collectives. PyTorch has
no GSPMD, so the port writes the partitioned products itself, with JAX's
specs (:func:`tp_param_shardings`):

* the LSTM gate weights ``w: (in, 4H)`` and biases ``(4H,)`` are
  column-parallel: each model shard computes its 4H/m columns of z·W + b,
  and the columns are gathered in order (``models.cell.tp_lstm_cell``); the
  cell update is replicated;
* the output projection ``w: (H, d)`` is row-parallel: the shards' partial
  products are summed in shard order (``models.cell.row_parallel``);
* the ``'data'`` axis splits the rows over the grid's rows.

:func:`apply_tp_shardings` places a tree so (each leaf's parts copied from
the one leaf by ``.to``, so autograd gathers the gradients), and
:func:`tp_apply` runs the seq2seq family's ``apply`` on it. GSPMD partitions
any family; the port's products cover the seq2seq family, and
:func:`tp_apply` refuses the others, naming them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from ..models import seq2seq
from ..models.cell import Shards
from ..params import walk
from .grid import DeviceGrid
from .serve import shard_slices

__all__ = ["PartitionSpec", "TPParams", "tp_param_shardings", "apply_tp_shardings", "tp_apply", "tp_apply_fn"]


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """A leaf's spec: the grid axis each of its dimensions is split over
    (None: not split); ``tuple(spec)`` is JAX's ``tuple(P(...))``."""

    axes: Tuple[Optional[str], ...] = ()

    def __iter__(self):
        return iter(self.axes)


def _spec_for(key: str, leaf) -> PartitionSpec:
    names = key.split(".")
    if "proj" in names or "out_proj" in names:
        if leaf.dim() == 2:
            return PartitionSpec(("model", None))  # row-parallel: the contraction split
        return PartitionSpec()  # the tiny (d,) bias, replicated
    if leaf.dim() == 2 and leaf.shape[-1] % 4 == 0:
        return PartitionSpec((None, "model"))  # column-parallel gate/attention weights
    if leaf.dim() == 1 and leaf.shape[0] % 4 == 0:
        return PartitionSpec(("model",))
    return PartitionSpec()


def _spec(key: str, leaf, mp: int) -> PartitionSpec:
    s = _spec_for(key, leaf)
    if any(name == "model" and leaf.shape[axis] % mp for axis, name in enumerate(s)):
        return PartitionSpec()  # the 'model' axis does not divide the dimension
    return s


def tp_param_shardings(params: Any, mesh: DeviceGrid) -> Any:
    """The tree of each leaf's :class:`PartitionSpec`, JAX's rules: ``proj``
    and ``out_proj`` 2-D leaves ``('model', None)``, other 2-D leaves whose
    last dim divides by 4 ``(None, 'model')``, 1-D leaves whose size divides
    by 4 ``('model',)``, the rest replicated; a spec is dropped where the
    ``'model'`` axis does not divide the dimension."""
    mp = mesh.shape["model"]
    return walk(params, lambda key, leaf: _spec(key, leaf, mp))


class TPParams(NamedTuple):
    """A tree placed by :func:`apply_tp_shardings`: ``rows[r]`` is the tree of
    the grid's row r, each leaf a ``models.cell.Shards`` over the row's
    model devices."""

    mesh: DeviceGrid
    rows: List[Any]


def apply_tp_shardings(params: Any, mesh: DeviceGrid) -> TPParams:
    """Place ``params`` as :func:`tp_param_shardings` says, on every row of
    the grid: a split leaf's parts each on its model shard's device, a
    replicated leaf on the row's first device."""
    mp, rows = mesh.shape["model"], []
    for devs in mesh.rows("model"):
        def place(key, leaf, devs=devs):
            spec = tuple(_spec(key, leaf, mp))
            if "model" not in spec:
                return Shards((leaf.to(devs[0]),), None)
            axis = spec.index("model")
            return Shards(tuple(p.to(d) for p, d in zip(leaf.chunk(mp, dim=axis), devs)), axis)

        rows.append(walk(params, place))
    return TPParams(mesh, rows)


def _family(tree) -> str:
    if "dec" in tree:
        return "transformer"
    return "cross_user" if "peer_encoder" in tree else "fusion" if "conv" in tree else "seq2seq"


def tp_apply(
    params: TPParams,
    cfg: seq2seq.Seq2SeqConfig,
    past_n: torch.Tensor,
    future_n: Optional[torch.Tensor] = None,
    *,
    rng: Optional[torch.Generator] = None,
    teacher_prob: float = 1.0,
    context: Optional[torch.Tensor] = None,
    coins: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``seq2seq.apply`` on a placed tree: each row of the grid takes its rows
    of the batch on its first device → (B, H_out, D) f32 on the device of
    ``past_n``. Scheduled sampling's coins are drawn for the whole batch
    first (from ``rng``, as ``apply`` draws them) and split with it."""
    family = _family(params.rows[0])
    if family != "seq2seq":
        raise ValueError(
            f"tensor parallelism takes the seq2seq family; the {family} family is not partitioned here "
            f"(GSPMD partitions any family in JAX)"
        )
    if future_n is not None and coins is None and rng is not None:
        coins = seq2seq.draw_coins(rng, teacher_prob, cfg.h_out, past_n.shape[0])
    home, outs = past_n.device, []
    for tree, devs, sl in zip(params.rows, params.mesh.rows("model"),
                              shard_slices(past_n.shape[0], len(params.rows))):
        d = devs[0]
        outs.append(seq2seq.apply(
            tree, cfg, past_n[sl].to(d), None if future_n is None else future_n[sl].to(d),
            context=None if context is None else context[sl].to(d),
            coins=None if coins is None else coins[:, sl].to(d),
        ).to(home))
    return torch.cat(outs)


def tp_apply_fn(mesh: DeviceGrid):
    """Drop-in seq2seq ``apply_fn`` for ``train.make_train_step`` with the
    params placed over ``mesh`` on every call (so the gradients are the
    unsharded leaves')."""

    def apply(params, cfg, past_n, future_n=None, *, rng=None, teacher_prob=1.0, context=None, coins=None):
        return tp_apply(apply_tp_shardings(params, mesh), cfg, past_n, future_n, rng=rng,
                        teacher_prob=teacher_prob, context=context, coins=coins)

    return apply
