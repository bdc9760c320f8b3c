"""Seq2seq LSTM encoder–decoder for FoV trajectory prediction.

PyTorch twin of ``longterm360fov_tpu.models.seq2seq``: an LSTM encoder
consumes the observed (past) window; an LSTM decoder emits the future
horizon, autoregressively, teacher-forced or with scheduled sampling. The
scans of the JAX version are Python loops over time here; the serving hot
loop is one CUDA kernel (:func:`serve_fused`, ``ops.fused_lstm.fused_serve``),
the teacher-forced training forward and backward run on the kernels of
``ops.lstm_train`` (:func:`apply_fused_tf`), and the scheduled-sampling
decoder on those of ``ops.lstm_ss`` (:func:`apply_fused_ss`).
``cfg.cell`` picks the cell of the step loops (:func:`apply`, :func:`decode`,
:func:`decode_fused`'s encoder): "xla", ``cell.lstm_cell``, or "pallas", the
one-step kernel ``ops.fused_lstm.fused_lstm_cell``; the fused entries run
whole-sequence kernels and ignore it, as in JAX.

Params are a plain dict, the JAX pytree's structure:
``{"encoder": [LSTMParams], "decoder": [LSTMParams], "proj": {"w", "b"}}``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from .. import draws
from .cell import get_cell_fn, init_lstm

__all__ = [
    "Seq2SeqConfig",
    "init",
    "apply",
    "decode",
    "decode_fused",
    "draw_coins",
    "apply_fused_tf",
    "apply_fused_ss",
    "serve_fused",
]


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    """Static model hyperparameters. The field set, names and defaults are
    the JAX config's, so that ``ExperimentConfig.model_hash`` agrees across
    the two packages (see ``longterm360fov_tpu.models.seq2seq`` for what the
    family-specific fields mean)."""

    d: int = 3  # coordinate dim: 3 (xyz) or 2 (yaw, pitch)
    hidden: int = 128
    layers: int = 1  # encoder and decoder depth (stacked variant: >1)
    h_in: int = 10
    h_out: int = 10
    ctx_dim: int = 0  # per-viewer context appended to decoder inputs
    cell: str = "xla"  # "xla" or "pallas" (models.cell.get_cell_fn)
    param_dtype: str = "float32"
    peer_pool: str = "none"  # transformer family only
    peer_window: int = 0  # transformer family only
    peer_align: bool = False  # cross_user family only

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


Params = Dict[str, Any]


def init(gen: torch.Generator, cfg: Seq2SeqConfig, *, device) -> Params:
    """Initialize encoder/decoder stacks + output projection from a CPU
    generator, on ``device``."""
    dt = cfg.dtype
    enc, dec = [], []
    for l in range(cfg.layers):
        enc_in = cfg.d if l == 0 else cfg.hidden
        dec_in = (cfg.d + cfg.ctx_dim) if l == 0 else cfg.hidden
        enc.append(init_lstm(gen, enc_in, cfg.hidden, dtype=dt, device=device))
        dec.append(init_lstm(gen, dec_in, cfg.hidden, dtype=dt, device=device))
    limit = math.sqrt(6.0 / (cfg.hidden + cfg.d))
    proj_w = (torch.rand((cfg.hidden, cfg.d), generator=gen) * 2 - 1) * limit
    return {
        "encoder": enc,
        "decoder": dec,
        "proj": {
            "w": proj_w.to(device=device, dtype=dt),
            "b": torch.zeros(cfg.d, device=device, dtype=dt),
        },
    }


def _run(cell_fn, layer_params, states, x):
    new_states = []
    for p, st in zip(layer_params, states):
        st = cell_fn(p, x, st)
        new_states.append(st)
        x = st[0]
    return new_states, x


def _encode(params: Params, cfg: Seq2SeqConfig, past_n: torch.Tensor):
    """Encoder stack over the past window (B, H_in, D) → final per-layer
    (h, c) states, on the configured cell. The steps' inputs are the rows
    of a time-major copy, contiguous, as the kernel cell takes them."""
    cell_fn = get_cell_fn(cfg.cell)
    xs = past_n.to(cfg.dtype).transpose(0, 1).contiguous()  # (T, B, D)
    z = xs.new_zeros((xs.shape[1], cfg.hidden))
    states = [(z, z)] * cfg.layers
    for x in xs:
        states, _ = _run(cell_fn, params["encoder"], states, x)
    return states


def _project(params: Params, h: torch.Tensor) -> torch.Tensor:
    return h.float() @ params["proj"]["w"].float() + params["proj"]["b"].float()


def draw_coins(gen, teacher_prob: float, t_out: int, batch: int) -> torch.Tensor:
    """Scheduled-sampling coins (t_out, B, 1) f32 on the generator's device:
    1 (teacher input) with probability ``teacher_prob``, else 0. Drawn in one
    call from a ``torch.Generator``, or a data-parallel rank's rows of the
    global batch's coins (``draws.RankDraw``); ``jax.random`` draws per step
    from split keys, and the two give different numbers, so parity tests
    pass explicit coins."""
    return (draws.rand(gen, (t_out, batch, 1), dim=1) < teacher_prob).float()


def apply(
    params: Params,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    future_n: Optional[torch.Tensor] = None,
    *,
    rng: Optional[torch.Generator] = None,
    teacher_prob: float = 1.0,
    context: Optional[torch.Tensor] = None,
    coins: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full forward pass → normalized predictions (B, H_out, D) f32.

    Modes, as in the JAX ``apply``:
      * ``future_n`` None → autoregressive decode (inference);
      * ``future_n`` given → teacher forcing: the input at step t is the
        true position at t-1;
      * ``future_n`` and ``coins`` (H_out, B, 1) given → scheduled sampling
        with explicit draws: teacher input where ``coins > 0``, else the
        model's own previous output;
      * ``future_n`` and ``rng`` (a ``torch.Generator``) given → scheduled
        sampling with coins drawn by :func:`draw_coins` at ``teacher_prob``,
        then the explicit-coins mode.

    ``context``: optional (B, ctx_dim) vector appended to every decoder
    input, or (B, H_out, ctx_dim) where step t gets ``context[:, t]``.
    """
    cell_fn = get_cell_fn(cfg.cell)
    if future_n is not None and coins is None and rng is not None:
        coins = draw_coins(rng, teacher_prob, cfg.h_out, past_n.shape[0])
    dt = cfg.dtype
    states = _encode(params, cfg, past_n)
    y0 = past_n[:, -1].to(dt).contiguous()  # last observed position
    if context is not None:
        context = context.to(dt)
    teacher = None
    if future_n is not None:
        fut = future_n.to(dt).transpose(0, 1)
        # teacher input at step t is the TRUE position at t-1; time-major
        teacher = torch.cat([y0[None], fut[:-1]], dim=0)

    ys = []
    y = y0
    for t in range(cfg.h_out):
        if teacher is None:
            x = y
        elif coins is None:
            x = teacher[t]
        else:
            x = torch.where(coins[t] > 0, teacher[t], y)
        if context is not None:
            ctx_t = context[:, t] if context.dim() == 3 else context
            x = torch.cat([x, ctx_t], dim=-1)
        states, h = _run(cell_fn, params["decoder"], states, x)
        y = _project(params, h).to(dt)
        ys.append(y)
    return torch.stack(ys, dim=1).float()


def decode(
    params: Params,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    *,
    context: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pure autoregressive decode (the plain inference path)."""
    return apply(params, cfg, past_n, None, context=context)


def decode_fused(
    params: Params,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    *,
    context: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Autoregressive decode with the whole-horizon decode kernel
    (``ops.fused_lstm.fused_decode``): the encoder's step loop on the
    configured cell, then the T_out decoder steps in one launch from its
    final f32 states → (B, H_out, D). Numerics match :func:`decode`. Twin of
    the JAX ``decode_fused``, whose ``tile_b`` is a TPU tiling knob."""
    from ..ops.fused_lstm import fused_decode

    states = _encode(params, cfg, past_n)
    h0 = torch.stack([s[0] for s in states]).float()
    c0 = torch.stack([s[1] for s in states]).float()
    y0 = past_n[:, -1, :].float().contiguous()
    return fused_decode(
        params["decoder"], params["proj"]["w"], params["proj"]["b"], h0, c0, y0, cfg.h_out,
        context=None if context is None else context.float().contiguous(),
    )


def apply_fused_tf(
    params: Params,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    future_n: torch.Tensor,
    *,
    context: Optional[torch.Tensor] = None,
    residual_dtype: torch.dtype = torch.bfloat16,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Teacher-forced training forward on ``ops.lstm_train.lstm_seq_states``:
    the encoder and the teacher-forced decoder each run as one forward
    kernel, with the kernels' backward under autograd. Matches :func:`apply`
    in teacher-forcing mode up to residual rounding: the saved residuals
    default to bf16, as in JAX; ``residual_dtype=torch.float32`` gives exact
    gradient parity. As in JAX, the decoder starts from the encoder's final
    states read back from its residuals. A static ``context`` (B, ctx_dim)
    joins every step's decoder input.

    ``compute_dtype=torch.bfloat16`` runs both kernels in their bf16-compute
    tier (``train --train-compute bfloat16``).

    Raising: a per-step (B, H_out, ctx_dim) context, which is not a tier of
    this function (the cross_user ``peer_align`` tier builds its per-step
    context from the peers inside ``ops.lstm_align.aligned_ss_decode``:
    ``cross_user.apply_fused_tf``)."""
    if context is not None and context.dim() != 2:
        raise NotImplementedError(
            "seq2seq.apply_fused_tf takes a static (B, C) context; a per-step "
            "(B, H_out, C) context is the cross_user peer_align tier, whose kernels "
            "build it from the peer windows: call cross_user.apply_fused_tf with "
            "other_future_n"
        )
    # imported here: ops.lstm_train imports models.cell, whose package
    # imports this module
    from ..ops.lstm_train import lstm_seq_states

    batch = past_n.shape[0]
    z = past_n.new_zeros((cfg.layers, batch, cfg.hidden), dtype=torch.float32)
    _, hT, cT = lstm_seq_states(
        params["encoder"], past_n.float().contiguous(), z, z, residual_dtype,
        compute_dtype,
    )
    y0 = past_n[:, -1:].float()
    teacher_in = torch.cat([y0, future_n[:, :-1].float()], dim=1)
    if context is not None:
        ctx = context[:, None, :].float().expand(batch, teacher_in.shape[1], -1)
        teacher_in = torch.cat([teacher_in, ctx], dim=-1)
    hs_dec, _, _ = lstm_seq_states(
        params["decoder"], teacher_in.contiguous(), hT, cT, residual_dtype, compute_dtype
    )
    return _project(params, hs_dec).float()


def apply_fused_ss(
    params: Params,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    future_n: torch.Tensor,
    *,
    rng: Optional[torch.Generator] = None,
    teacher_prob: float = 1.0,
    context: Optional[torch.Tensor] = None,
    coins: Optional[torch.Tensor] = None,
    residual_dtype: torch.dtype = torch.bfloat16,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Scheduled-sampling training forward on the kernels: the encoder on
    ``ops.lstm_train.lstm_seq_states``, the decoder with its per-step
    teacher/model mixing and its backward on ``ops.lstm_ss.ss_decode``.
    Matches :func:`apply` given the same coins, up to residual rounding
    (bf16 residuals by default, as in JAX). The coins are ``coins``
    (H_out, B, 1), or drawn from ``rng`` at ``teacher_prob`` as
    :func:`apply` draws them."""
    from ..ops.lstm_ss import ss_decode
    from ..ops.lstm_train import lstm_seq_states

    batch = past_n.shape[0]
    z = past_n.new_zeros((cfg.layers, batch, cfg.hidden), dtype=torch.float32)
    _, hT, cT = lstm_seq_states(
        params["encoder"], past_n.float().contiguous(), z, z, residual_dtype,
        compute_dtype,
    )
    y0 = past_n[:, -1].float()
    fut_tm = future_n.float().transpose(0, 1)
    teacher_tm = torch.cat([y0[None], fut_tm[:-1]], dim=0)
    if coins is None:
        if rng is None:
            raise ValueError("apply_fused_ss needs rng or explicit coins")
        coins = draw_coins(rng, teacher_prob, cfg.h_out, batch)
    ctx = None if context is None else context.float().contiguous()
    return ss_decode(
        params["decoder"], params["proj"]["w"].float(), params["proj"]["b"].float(),
        hT, cT, y0.contiguous(), teacher_tm.contiguous(), (coins.float(), ctx),
        residual_dtype, compute_dtype,
    )


def serve_fused(
    params: Params,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    *,
    context: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Whole-request fused serve: encoder AND decoder in one kernel launch
    (``ops.fused_lstm.fused_serve``) on CUDA tensors, its plain version on
    CPU tensors. A static ``context`` (B, ctx_dim) joins the decoder's
    layer-0 input."""
    # imported here: ops.fused_lstm imports models.cell, whose package
    # imports this module
    from ..ops.fused_lstm import fused_serve

    return fused_serve(
        params["encoder"],
        params["decoder"],
        params["proj"]["w"],
        params["proj"]["b"],
        past_n,
        cfg.h_out,
        context=None if context is None else context.float().contiguous(),
        compute_dtype=compute_dtype,
    )
