"""Video-aware fusion seq2seq: per-window video features as the decoder's
context.

PyTorch twin of ``longterm360fov_tpu.models.fusion``. For on-demand video
the frames over the prediction horizon are known in advance, so per-window
video features (saliency and motion conv features from
``features.equirect``, pooled over the window's future span) are a
legitimate serve-time input. A trainable 2-layer MLP maps the feature
vector to the decoder's static context (B, ctx_dim), the hook cross_user
uses.

Two input modes per batch; ``maps`` takes precedence over ``features``, and
with neither the context is zeros:

* ``features`` (B, F): pre-extracted feature vectors → MLP → context;
* ``maps`` (B, Hm, Wm): per-window pooled saliency or motion maps → the
  trainable conv stack (``features.equirect.conv_features``) → MLP →
  context, so the conv filters learn with the trajectory model.

Serving with ``maps`` runs the conv stack on the fused conv+resize kernel
(``ops.conv_resize.fused_conv_resize``; :func:`serve_fused`). Training with
``maps`` runs it on ``conv_resize_reference`` (:func:`compute_map_features`),
on the card too: that is the JAX package's own design, since the kernel has
no backward there either, and it is a function of the JAX package in its
own right, not a fallback from the kernel. The serving path never reaches
the plain version on a CUDA tensor.

Params are the seq2seq tree plus ``"conv"`` {kernels, bias, head_w, head_b}
and ``"feat_proj"`` {w1, b1, w2, b2}.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..features.equirect import conv_features, init_conv_features
from . import seq2seq
from .seq2seq import Seq2SeqConfig

__all__ = [
    "init",
    "apply",
    "apply_fused_tf",
    "apply_fused_ss",
    "serve_fused",
    "batch_extras",
    "project_features",
    "compute_map_features",
    "FEATURE_DIM",
    "CONV_GRID",
]

# default per-window video-feature width: 2 x the conv feat_dim of 64 that
# extract-features writes
FEATURE_DIM = 128
CONV_GRID = (4, 8)  # coarse equirect pooling grid of the conv stack


def init(gen: torch.Generator, cfg: Seq2SeqConfig, *, device, feature_dim: int = FEATURE_DIM) -> Dict:
    """Seq2seq params + the feature → context MLP (Glorot-uniform, hidden
    max(ctx_dim, 64)) + the conv stack of the ``maps`` mode (4 channels)."""
    if cfg.ctx_dim <= 0:
        raise ValueError("fusion model needs cfg.ctx_dim > 0")
    params = seq2seq.init(gen, cfg, device=device)
    params["conv"] = init_conv_features(gen, channels=4, feat_dim=feature_dim, grid=CONV_GRID,
                                        device=device)
    hid = max(cfg.ctx_dim, 64)

    def uniform(shape, limit):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * limit).to(device=device, dtype=cfg.dtype)

    params["feat_proj"] = {
        "w1": uniform((feature_dim, hid), math.sqrt(6.0 / (feature_dim + hid))),
        "b1": torch.zeros(hid, device=device, dtype=cfg.dtype),
        "w2": uniform((hid, cfg.ctx_dim), math.sqrt(6.0 / (hid + cfg.ctx_dim))),
        "b2": torch.zeros(cfg.ctx_dim, device=device, dtype=cfg.dtype),
    }
    return params


def project_features(params: Dict, features: torch.Tensor) -> torch.Tensor:
    """(B, F) video features → (B, ctx_dim) f32 context."""
    p = params["feat_proj"]
    h = torch.relu(features.float() @ p["w1"].float() + p["b1"].float())
    return h @ p["w2"].float() + p["b2"].float()


def compute_map_features(params: Dict, maps: torch.Tensor) -> torch.Tensor:
    """(B, Hm, Wm) pooled saliency or motion maps → (B, F) features through
    the trainable conv stack on ``conv_resize_reference``: differentiable,
    as the JAX package trains it (its kernel has no backward)."""
    return conv_features(params["conv"], maps, grid=CONV_GRID, use_pallas=False)


def _context(params, cfg, past_n, features, maps, *, serving=False):
    """The decoder's static context: ``maps`` through the conv stack (the
    kernel when ``serving``), then the MLP; zeros without video input."""
    if maps is not None:
        features = (conv_features(params["conv"], maps, grid=CONV_GRID, use_pallas=True)
                    if serving else compute_map_features(params, maps))
    if features is not None:
        return project_features(params, features).to(cfg.dtype)
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
    features: Optional[torch.Tensor] = None,
    maps: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
    coins: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Forward pass (the modes of ``seq2seq.apply``) with the video context."""
    if context is None:
        context = _context(params, cfg, past_n, features, maps)
    return seq2seq.apply(params, cfg, past_n, future_n, rng=rng, teacher_prob=teacher_prob,
                         context=context, coins=coins)


def apply_fused_tf(
    params: Dict,
    cfg: Seq2SeqConfig,
    past_n: torch.Tensor,
    future_n: torch.Tensor,
    *,
    features: Optional[torch.Tensor] = None,
    maps: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
    residual_dtype: torch.dtype = torch.bfloat16,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Teacher-forced training forward on the ``lstm_seq_states`` kernels
    (``seq2seq.apply_fused_tf``) with the video context."""
    if context is None:
        context = _context(params, cfg, past_n, features, maps)
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
    features: Optional[torch.Tensor] = None,
    maps: Optional[torch.Tensor] = None,
    context: Optional[torch.Tensor] = None,
    coins: Optional[torch.Tensor] = None,
    residual_dtype: torch.dtype = torch.bfloat16,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Scheduled-sampling training forward: the encoder on
    ``lstm_seq_states``, the decoder on ``ss_decode`` with the video context
    (``seq2seq.apply_fused_ss``), whose gradient reaches ``feat_proj`` (and
    ``conv`` in the ``maps`` mode) through the context."""
    if context is None:
        context = _context(params, cfg, past_n, features, maps)
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
    features: Optional[torch.Tensor] = None,
    maps: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Whole-request serve with the video context: the MLP (and, for raw
    ``maps``, the conv stack on the fused conv+resize kernel) feeds the
    static-context ``fused_serve`` kernel."""
    if context is None:
        context = _context(params, cfg, past_n, features, maps, serving=True)
    return seq2seq.serve_fused(params, cfg, past_n, context=context, compute_dtype=compute_dtype)


def batch_extras(batch: Dict, anchor) -> Dict:
    """The batch's ``features`` and ``maps``, as they are: video context
    needs no re-anchoring."""
    return {k: batch[k] for k in ("features", "maps") if batch.get(k) is not None}
