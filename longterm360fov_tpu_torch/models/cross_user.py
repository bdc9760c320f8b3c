"""Cross-user conditioned seq2seq: other viewers' known futures as context.

PyTorch twin of ``longterm360fov_tpu.models.cross_user``. For an on-demand
video, other viewers have already watched the target's future time-span, so
their trajectories over it are known at serve time. A shared peer-encoder
LSTM (hidden ``cfg.ctx_dim``) consumes each peer's future window; the masked
mean of the final hidden states becomes a per-viewer context vector that
joins every decoder step's input through the seq2seq context hook. Absent
peers are masked, and an all-masked row is exactly the plain seq2seq model
with zero context.

Params are the seq2seq tree plus ``"peer_encoder"``, one ``LSTMParams``.

The time-aligned ``peer_align`` tier (preset ``stacked-ss-crossuser-10s``):
decoder step t conditions on the masked mean of the peer encoders' hidden
states at step t. Its plain path is :func:`encode_peers_aligned` +
:func:`apply`; its kernels are the lockstep-peer tier of
``ops.fused_lstm.fused_serve`` (:func:`serve_fused`) and
``ops.lstm_align.aligned_ss_decode`` (:func:`apply_fused_tf`,
:func:`apply_fused_ss`). Without peers, or with an explicit context, the
tier computes the JAX package's function, the static-context model, on the
static-context kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import seq2seq
from .cell import get_cell_fn, init_lstm
from .seq2seq import Seq2SeqConfig

__all__ = [
    "init",
    "apply",
    "apply_fused_tf",
    "apply_fused_ss",
    "serve_fused",
    "batch_extras",
    "encode_peers",
    "encode_peers_aligned",
]

def init(gen: torch.Generator, cfg: Seq2SeqConfig, *, device) -> Dict:
    """Seq2seq params + a peer encoder with hidden size ``cfg.ctx_dim``."""
    if cfg.ctx_dim <= 0:
        raise ValueError("cross_user model needs cfg.ctx_dim > 0")
    params = seq2seq.init(gen, cfg, device=device)
    params["peer_encoder"] = init_lstm(gen, cfg.d, cfg.ctx_dim, dtype=cfg.dtype, device=device)
    return params


def _masked_mean(h: torch.Tensor, other_mask: Optional[torch.Tensor], axis: int) -> torch.Tensor:
    if other_mask is None:
        return h.mean(dim=axis)
    shape = [1] * h.dim()
    shape[axis - 1], shape[axis] = other_mask.shape  # (.., B, K, ..)
    m = other_mask.to(h.dtype).reshape(shape)
    denom = torch.clamp(m.sum(dim=axis), min=1.0)
    return (h * m).sum(dim=axis) / denom


def encode_peers(
    params: Dict,
    cfg: Seq2SeqConfig,
    other_future_n: torch.Tensor,  # (B, K, T, D), target-anchor normalized
    other_mask: Optional[torch.Tensor],  # (B, K) 1.0 = peer present
    *,
    use_fused_seq=False,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """→ (B, ctx_dim) masked-mean peer embedding.

    ``use_fused_seq`` routes the (B·K)-row LSTM: ``True``/``"train"``
    through the differentiable training kernels (``ops.lstm_train.lstm_seq``,
    which save every step's residuals for the backward), ``"serve"`` through
    the inference-only encode kernel (``ops.fused_lstm.fused_encode``, final
    state only), ``False`` through a step loop of the configured cell
    (``cfg.cell``)."""
    b, k, t, d = other_future_n.shape
    flat = other_future_n.reshape(b * k, t, d).to(cfg.dtype)
    if use_fused_seq == "serve":
        from ..ops.fused_lstm import fused_encode

        h = fused_encode([params["peer_encoder"]], flat.float().contiguous(),
                         compute_dtype=compute_dtype)
    elif use_fused_seq:
        from ..ops.lstm_train import lstm_seq

        h = lstm_seq([params["peer_encoder"]], flat.float().contiguous())[:, -1, :]
    else:
        cell_fn = get_cell_fn(cfg.cell)
        z = flat.new_zeros((b * k, cfg.ctx_dim))
        state = (z, z)
        for x in flat.transpose(0, 1).contiguous():
            state = cell_fn(params["peer_encoder"], x, state)
        h = state[0]
    return _masked_mean(h.reshape(b, k, cfg.ctx_dim), other_mask, 1)


def encode_peers_aligned(
    params: Dict,
    cfg: Seq2SeqConfig,
    other_future_n: torch.Tensor,  # (B, K, T, D)
    other_mask: Optional[torch.Tensor],  # (B, K)
) -> torch.Tensor:
    """→ (B, T, ctx_dim) time-aligned peer context (``cfg.peer_align``):
    decoder step t gets the masked mean of the peer encoder's hidden state
    at step t, stepped on the configured cell (``cfg.cell``)."""
    cell_fn = get_cell_fn(cfg.cell)
    b, k, t, d = other_future_n.shape
    flat = other_future_n.reshape(b * k, t, d).to(cfg.dtype)
    z = flat.new_zeros((b * k, cfg.ctx_dim))
    state = (z, z)
    hs = []
    for x in flat.transpose(0, 1).contiguous():
        state = cell_fn(params["peer_encoder"], x, state)
        hs.append(state[0])
    hs = torch.stack(hs, dim=1).reshape(b, k, t, cfg.ctx_dim)
    return _masked_mean(hs, other_mask, 1)


def _peer_weights(other_mask: Optional[torch.Tensor], batch: int, k: int, device) -> torch.Tensor:
    """The lockstep tier's (B, K) mask weights: ``mask / max(Σ mask, 1)``,
    or ``1/K`` for every peer without a mask."""
    if other_mask is None:
        return torch.full((batch, k), 1.0 / k, device=device)
    m = other_mask.float()
    return (m / torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)).contiguous()


def _check_span(other_future_n: torch.Tensor, h_out: int, what: str):
    if other_future_n.shape[2] != h_out:
        raise ValueError(
            f"peer_align {what} requires peer windows spanning the decode horizon: got "
            f"span {other_future_n.shape[2]} != h_out {h_out}"
        )


def _apply_fused_aligned(
    params: Dict,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    future_n: torch.Tensor,
    *,
    other_future_n: torch.Tensor,
    other_mask: Optional[torch.Tensor],
    coins: torch.Tensor,
    residual_dtype: torch.dtype = torch.bfloat16,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Training forward of ``cfg.peer_align`` on the lockstep-peer kernels:
    the encoder on ``lstm_seq_states`` with f32 residuals (as in JAX), the K
    peer encoders and the decoder on ``ops.lstm_align.aligned_ss_decode``,
    whose residuals default to bf16, with explicit coins (H_out, B, 1). A
    peer span other than h_out raises."""
    from ..ops.lstm_align import aligned_ss_decode
    from ..ops.lstm_train import lstm_seq_states

    _check_span(other_future_n, future_n.shape[1], "training")
    batch, k, t_out, d = other_future_n.shape
    z = past_n.new_zeros((cfg.layers, batch, cfg.hidden), dtype=torch.float32)
    _, hT, cT = lstm_seq_states(params["encoder"], past_n.float().contiguous(), z, z,
                                torch.float32, compute_dtype)
    y0 = past_n[:, -1].float()
    teacher_tm = torch.cat([y0[None], future_n.float().transpose(0, 1)[:-1]], dim=0)
    # (B, K, T, D) → time-major (T, B, K·D), the JAX kernel's layout
    pxs_tm = other_future_n.float().permute(2, 0, 1, 3).reshape(t_out, batch, k * d)
    pwt = _peer_weights(other_mask, batch, k, past_n.device)
    return aligned_ss_decode(
        params["decoder"], params["proj"]["w"].float(), params["proj"]["b"].float(),
        params["peer_encoder"], hT, cT, y0.contiguous(), teacher_tm.contiguous(),
        pxs_tm.contiguous(), (coins.float(), pwt), residual_dtype, compute_dtype,
    )


def _context(params, cfg, past_n, other_future_n, other_mask, **encode_kw):
    if other_future_n is not None:
        return encode_peers(params, cfg, other_future_n, other_mask, **encode_kw)
    # the decoder's weights always carry context rows when ctx_dim > 0
    return past_n.new_zeros((past_n.shape[0], cfg.ctx_dim), dtype=cfg.dtype)


def apply(
    params: Dict,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    future_n: Optional[torch.Tensor] = None,
    *,
    rng: Optional[torch.Generator] = None,
    teacher_prob=1.0,
    other_future_n: Optional[torch.Tensor] = None,
    other_mask: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
    coins: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Forward pass; peers → context → seq2seq. With no peers (or all
    masked) the context is zeros, identical to plain seq2seq."""
    if context is None:
        if other_future_n is not None and cfg.peer_align:
            context = encode_peers_aligned(params, cfg, other_future_n, other_mask)
        else:
            context = _context(params, cfg, past_n, other_future_n, other_mask)
    return seq2seq.apply(
        params, cfg, past_n, future_n, rng=rng, teacher_prob=teacher_prob,
        context=context, coins=coins,
    )


def apply_fused_tf(
    params: Dict,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    future_n: torch.Tensor,
    *,
    other_future_n: Optional[torch.Tensor] = None,
    other_mask: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
    residual_dtype: torch.dtype = torch.bfloat16,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Teacher-forced forward entirely on the training kernels, the peer
    encoder included. Under ``peer_align`` with peers: scheduled sampling
    with every coin heads on the lockstep kernels."""
    if cfg.peer_align and other_future_n is not None and context is None:
        coins = past_n.new_ones((future_n.shape[1], past_n.shape[0], 1), dtype=torch.float32)
        return _apply_fused_aligned(params, cfg, past_n, future_n, other_future_n=other_future_n,
                                    other_mask=other_mask, coins=coins,
                                    residual_dtype=residual_dtype, compute_dtype=compute_dtype)
    if context is None:
        context = _context(params, cfg, past_n, other_future_n, other_mask, use_fused_seq=True)
    return seq2seq.apply_fused_tf(params, cfg, past_n, future_n, context=context,
                                  residual_dtype=residual_dtype, compute_dtype=compute_dtype)


def apply_fused_ss(
    params: Dict,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    future_n: torch.Tensor,
    *,
    rng: Optional[torch.Generator] = None,
    teacher_prob=1.0,
    other_future_n: Optional[torch.Tensor] = None,
    other_mask: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
    coins: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    residual_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Scheduled-sampling training forward on the kernels: the peer encoder
    on ``lstm_seq``, the encoder on ``lstm_seq_states``, the decoder on
    ``ss_decode``; under ``peer_align`` with peers, the encoder on
    ``lstm_seq_states`` and the peers and decoder on ``aligned_ss_decode``.
    The coins are ``coins`` (H_out, B, 1), or drawn from ``rng`` at
    ``teacher_prob`` as ``seq2seq.apply`` draws them."""
    if cfg.peer_align and other_future_n is not None and context is None:
        if coins is None:
            if rng is None:
                raise ValueError("apply_fused_ss needs rng or explicit coins")
            coins = seq2seq.draw_coins(rng, teacher_prob, cfg.h_out, past_n.shape[0])
        return _apply_fused_aligned(params, cfg, past_n, future_n, other_future_n=other_future_n,
                                    other_mask=other_mask, coins=coins,
                                    residual_dtype=residual_dtype, compute_dtype=compute_dtype)
    if context is None:
        context = _context(params, cfg, past_n, other_future_n, other_mask, use_fused_seq=True)
    return seq2seq.apply_fused_ss(
        params, cfg, past_n, future_n, rng=rng, teacher_prob=teacher_prob, context=context,
        coins=coins, residual_dtype=residual_dtype, compute_dtype=compute_dtype,
    )


def serve_fused(
    params: Dict,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    *,
    context: Optional[torch.Tensor] = None,
    other_future_n: Optional[torch.Tensor] = None,
    other_mask: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Whole-request fused serve with peer conditioning: the peers encode
    through the inference-only ``fused_encode`` kernel, then the
    ``fused_serve`` kernel runs with the resulting static context. Under
    ``peer_align`` with peers, the lockstep tier of ``fused_serve``: step
    t's context is the mask-weighted mean of the peer encoders' hidden
    states at step t; a peer span other than h_out raises."""
    if cfg.peer_align and other_future_n is not None and context is None:
        from ..ops.fused_lstm import fused_serve

        _check_span(other_future_n, cfg.h_out, "serving")
        batch, k = other_future_n.shape[:2]
        return fused_serve(
            params["encoder"], params["decoder"], params["proj"]["w"], params["proj"]["b"],
            past_n, cfg.h_out, peer_params=params["peer_encoder"],
            peer_xs=other_future_n.float().contiguous(),
            peer_w=_peer_weights(other_mask, batch, k, past_n.device),
            compute_dtype=compute_dtype,
        )
    if context is None:
        context = _context(params, cfg, past_n, other_future_n, other_mask,
                           use_fused_seq="serve", compute_dtype=compute_dtype)
    return seq2seq.serve_fused(params, cfg, past_n, context=context, compute_dtype=compute_dtype)


def batch_extras(batch: Dict, anchor: torch.Tensor) -> Dict:
    """Normalize peer futures into the target viewer's anchor frame, so that
    target and peers share one coordinate system."""
    of = batch.get("other_future")
    if of is None:
        return {}
    return {
        "other_future_n": of - anchor[:, None],  # (B,K,T,D) - (B,1,1,D)
        "other_mask": batch.get("other_mask"),
    }
