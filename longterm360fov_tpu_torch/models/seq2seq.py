"""Seq2seq LSTM encoder–decoder for FoV trajectory prediction.

PyTorch twin of ``longterm360fov_tpu.models.seq2seq``: an LSTM encoder
consumes the observed (past) window; an LSTM decoder emits the future
horizon, autoregressively or teacher-forced. The scans of the JAX version
are Python loops over time here; the serving hot loop is one CUDA kernel
(:func:`serve_fused`, ``ops.fused_lstm.fused_serve``), and the teacher-forced
training forward and backward run on the kernels of ``ops.lstm_train``
(:func:`apply_fused_tf`).

Params are a plain dict, the JAX pytree's structure:
``{"encoder": [LSTMParams], "decoder": [LSTMParams], "proj": {"w", "b"}}``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from .cell import init_lstm, lstm_cell

__all__ = ["Seq2SeqConfig", "init", "apply", "decode", "apply_fused_tf", "serve_fused"]


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
    cell: str = "xla"  # JAX cell impl name; kept for the hash
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


def _run(layer_params, states, x):
    new_states = []
    for p, st in zip(layer_params, states):
        st = lstm_cell(p, x, st)
        new_states.append(st)
        x = st[0]
    return new_states, x


def _encode(params: Params, cfg: Seq2SeqConfig, past_n: torch.Tensor):
    """Encoder stack over the past window (B, H_in, D) → final per-layer
    (h, c) states."""
    xs = past_n.to(cfg.dtype)
    z = xs.new_zeros((xs.shape[0], cfg.hidden))
    states = [(z, z)] * cfg.layers
    for t in range(xs.shape[1]):
        states, _ = _run(params["encoder"], states, xs[:, t])
    return states


def _project(params: Params, h: torch.Tensor) -> torch.Tensor:
    return h.float() @ params["proj"]["w"].float() + params["proj"]["b"].float()


def apply(
    params: Params,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    future_n: Optional[torch.Tensor] = None,
    *,
    rng=None,
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
        model's own previous output.
    The rng-drawn scheduled-sampling mode raises: ``jax.random``'s draw
    cannot be reproduced in torch, so parity needs explicit ``coins``.

    ``context``: optional (B, ctx_dim) vector appended to every decoder
    input, or (B, H_out, ctx_dim) where step t gets ``context[:, t]``.
    """
    if future_n is not None and coins is None and rng is not None:
        raise NotImplementedError(
            "scheduled sampling with an rng draw is not ported; pass explicit "
            "coins (ROADMAP.md, slice 'scheduled sampling')"
        )
    dt = cfg.dtype
    states = _encode(params, cfg, past_n)
    y0 = past_n[:, -1].to(dt)  # last observed position
    if context is not None:
        context = context.to(dt)
    teacher = None
    if future_n is not None:
        fut = future_n.to(dt)
        # teacher input at step t is the TRUE position at t-1
        teacher = torch.cat([y0[:, None], fut[:, :-1]], dim=1)

    ys = []
    y = y0
    for t in range(cfg.h_out):
        if teacher is None:
            x = y
        elif coins is None:
            x = teacher[:, t]
        else:
            x = torch.where(coins[t] > 0, teacher[:, t], y)
        if context is not None:
            ctx_t = context[:, t] if context.dim() == 3 else context
            x = torch.cat([x, ctx_t], dim=-1)
        states, h = _run(params["decoder"], states, x)
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
    states read back from its residuals.

    Not ported yet, and raising: a ``context`` (ROADMAP.md, slice
    'cross_user') and bf16 ``compute_dtype`` (ROADMAP.md Queue 2, the
    lstm_seq_states bf16-compute tier)."""
    if context is not None:
        raise NotImplementedError(
            "apply_fused_tf: a decoder context is not ported yet "
            "(ROADMAP.md, slice 'cross_user')"
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
    hs_dec, _, _ = lstm_seq_states(
        params["decoder"], teacher_in, hT, cT, residual_dtype, compute_dtype
    )
    return _project(params, hs_dec).float()


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
    CPU tensors."""
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
        context=context,
        compute_dtype=compute_dtype,
    )
