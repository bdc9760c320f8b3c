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

The time-aligned ``peer_align`` tier (preset ``stacked-ss-crossuser-10s``)
has its plain path here (:func:`encode_peers_aligned`, :func:`apply`); its
fused training and serving tiers raise, naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import seq2seq
from .cell import init_lstm, lstm_cell
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

_ALIGNED = (
    "the time-aligned peer_align tier of the cross_user family is not "
    "ported yet (ROADMAP.md Queue 2, fused_serve(peer_xs=...) and "
    "aligned_ss_decode; preset stacked-ss-crossuser-10s)"
)


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
    state only), ``False`` through a step loop of ``cell.lstm_cell``."""
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
        z = flat.new_zeros((b * k, cfg.ctx_dim))
        state = (z, z)
        for s in range(t):
            state = lstm_cell(params["peer_encoder"], flat[:, s], state)
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
    at step t."""
    b, k, t, d = other_future_n.shape
    flat = other_future_n.reshape(b * k, t, d).to(cfg.dtype)
    z = flat.new_zeros((b * k, cfg.ctx_dim))
    state = (z, z)
    hs = []
    for s in range(t):
        state = lstm_cell(params["peer_encoder"], flat[:, s], state)
        hs.append(state[0])
    hs = torch.stack(hs, dim=1).reshape(b, k, t, cfg.ctx_dim)
    return _masked_mean(hs, other_mask, 1)


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
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Teacher-forced forward entirely on the training kernels, the peer
    encoder included."""
    if cfg.peer_align:
        raise NotImplementedError(f"apply_fused_tf: {_ALIGNED}")
    if context is None:
        context = _context(params, cfg, past_n, other_future_n, other_mask, use_fused_seq=True)
    return seq2seq.apply_fused_tf(params, cfg, past_n, future_n, context=context,
                                  compute_dtype=compute_dtype)


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
    ``ss_decode``."""
    if cfg.peer_align:
        raise NotImplementedError(f"apply_fused_ss: {_ALIGNED}")
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
    ``fused_serve`` kernel runs with the resulting static context."""
    if cfg.peer_align and other_future_n is not None and context is None:
        raise NotImplementedError(f"serve_fused: {_ALIGNED}")
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
