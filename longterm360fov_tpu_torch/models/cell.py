"""LSTM cell: parameters and the plain implementation.

PyTorch twin of ``longterm360fov_tpu.models.cell``. The layout is the JAX
package's: one fused gate matrix ``W: (d_in + hidden, 4 * hidden)`` applied
to ``[x, h]``, gate order (i, f, g, o), and one bias ``(4 * hidden,)``.
(``torch.nn.LSTM`` keeps ``w_ih``/``w_hh`` and two biases instead;
``W = [w_ih.T; w_hh.T]`` and ``b = b_ih + b_hh``.)
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["LSTMParams", "LSTMState", "Shards", "init_lstm", "lstm_cell", "tp_lstm_cell", "column_parallel",
           "row_parallel", "get_cell_fn", "round_to", "mm"]


class LSTMParams(NamedTuple):
    w: torch.Tensor  # (d_in + hidden, 4*hidden) fused gate weights
    b: torch.Tensor  # (4*hidden,) fused gate bias


# carry = (h, c), each (batch, hidden)
LSTMState = Tuple[torch.Tensor, torch.Tensor]


def init_lstm(
    gen: torch.Generator, d_in: int, hidden: int, *,
    dtype=torch.float32, device,
) -> LSTMParams:
    """Glorot-uniform gate weights; forget-gate bias starts at 1.0.

    ``gen`` is a CPU generator; the draw is made on the CPU and moved to
    ``device``. The numbers differ from ``jax.random`` for the same seed:
    tests carry the JAX weights across with ``params.params_from_numpy``."""
    fan_in, fan_out = d_in + hidden, 4 * hidden
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = (torch.rand((fan_in, fan_out), generator=gen) * 2 - 1) * limit
    b = torch.zeros(4 * hidden)
    b[hidden : 2 * hidden] = 1.0  # forget gate
    return LSTMParams(
        w=w.to(device=device, dtype=dtype), b=b.to(device=device, dtype=dtype)
    )


def lstm_cell(
    params: LSTMParams, x: torch.Tensor, state: LSTMState,
    compute_dtype: torch.dtype = torch.float32,
) -> LSTMState:
    """One LSTM step. x: (B, D), state: ((B, H), (B, H)) → new state.

    Gates and cell update run in f32 whatever the parameter dtype, as the
    JAX cell's ``preferred_element_type=float32`` product does; h and c
    come back in their own dtypes. ``compute_dtype`` bf16 rounds both
    operands of the gate product (:func:`mm`), the serving kernels' bf16
    tier."""
    h, c = state
    gates = mm(torch.cat([x, h], dim=-1).float(), params.w.float(), compute_dtype) + params.b.float()
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


class Shards(NamedTuple):
    """A leaf of tensor parallelism (``parallel.tp.apply_tp_shardings``): its
    parts in model-shard order, each on its shard's device, split along
    ``axis``; ``axis`` None is the whole leaf, replicated, one part on the
    row's first device."""

    parts: Tuple[torch.Tensor, ...]
    axis: Optional[int]


def column_parallel(z: torch.Tensor, w: Shards, b: Shards) -> torch.Tensor:
    """``z @ W + b`` in f32 with W's columns split over the model shards: each
    shard computes its columns on its device, gathered in order onto the
    device of ``z`` (the whole product there where W is replicated)."""
    if w.axis is None:
        return z.float() @ w.parts[0].float() + b.parts[0].float()
    return torch.cat([(z.float().to(wp.device) @ wp.float() + bp.float()).to(z.device)
                      for wp, bp in zip(w.parts, b.parts)], dim=-1)


def row_parallel(h: torch.Tensor, w: Shards, b: Shards) -> torch.Tensor:
    """``h @ W + b`` in f32 with W's rows (the contraction) split over the
    model shards: each shard's partial product on its device, summed in
    shard order onto the device of ``h``, then the replicated bias."""
    if w.axis is None:
        return h.float() @ w.parts[0].float() + b.parts[0].float()
    k, acc = w.parts[0].shape[0], None
    for m, wp in enumerate(w.parts):
        part = (h[..., m * k:(m + 1) * k].float().to(wp.device) @ wp.float()).to(h.device)
        acc = part if acc is None else acc + part
    return acc + b.parts[0].float()


def tp_lstm_cell(params: LSTMParams, x: torch.Tensor, state: LSTMState) -> LSTMState:
    """:func:`lstm_cell` on a layer of :class:`Shards`: the gate product
    column-parallel (:func:`column_parallel`), the cell update replicated on
    the device of ``x`` (the tensor-parallel cell; f32 products)."""
    h, c = state
    gates = column_parallel(torch.cat([x, h], dim=-1), params.w, params.b)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def round_to(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` and held in f32: the bf16 tier's
    rounding of a product operand; f32 widens a bf16 ``x`` (exactly) and
    leaves an f32 one as it is."""
    return x.float() if compute_dtype == torch.float32 else x.to(compute_dtype).float()


def mm(x: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ w`` → f32; in the bf16 tier both operands rounded to bf16 and
    the product in f32 (each term exact, the sum in f32), as the JAX tiers'
    bf16 dot with ``preferred_element_type=float32``. In f32 a bf16 operand
    (a ``--bf16`` model's weight) is widened, as JAX's dot promotes it."""
    return round_to(x, compute_dtype) @ round_to(w, compute_dtype)


def get_cell_fn(name: str = "xla"):
    """Resolve a cell implementation by name, as the JAX ``get_cell_fn``:
    "xla" gives :func:`lstm_cell`, "pallas" the hand-written one-step kernel
    ``ops.fused_lstm.fused_lstm_cell`` (its plain version, ``lstm_cell``, on
    CPU tensors; no backward, as the TPU kernel has none)."""
    if name == "xla":
        return lstm_cell
    if name == "pallas":
        # imported here: ops.fused_lstm imports this module
        from ..ops.fused_lstm import fused_lstm_cell

        return fused_lstm_cell
    raise ValueError(f"unknown cell impl {name!r}")
