"""Sliding-window extraction + per-window normalization.

PyTorch twin of ``longterm360fov_tpu.windows``. ``make_windows`` is host
numpy and copied as it is; ``normalize_window`` / ``denormalize_window``
run on tensors, on their device.

Normalization scheme ("anchor-centering"): each window is translated so
the LAST observed (input) frame sits at the origin, and
``denormalize_window`` adds the anchor back and re-projects onto the unit
sphere.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "WindowBatch",
    "make_windows",
    "normalize_window",
    "denormalize_window",
]


class WindowBatch(NamedTuple):
    """A packed batch of (past, future) trajectory windows.

    past:   (N, H_in,  D) observed trajectory, D=3 (xyz) or 2 (yaw,pitch)
    future: (N, H_out, D) ground-truth future trajectory
    """

    past: np.ndarray
    future: np.ndarray


def make_windows(
    trace: np.ndarray,
    h_in: int,
    h_out: int,
    stride: int = 1,
) -> WindowBatch:
    """Slice a (T, D) trace into overlapping (past, future) windows.

    Returns ``WindowBatch`` with N = floor((T - h_in - h_out) / stride) + 1
    windows. Uses ``sliding_window_view`` (a strided view — no copy until
    the final ``ascontiguousarray`` packs upload-ready arrays).
    """
    trace = np.asarray(trace)
    if trace.ndim != 2:
        raise ValueError(f"trace must be (T, D), got {trace.shape}")
    t, d = trace.shape
    span = h_in + h_out
    if t < span:
        raise ValueError(f"trace length {t} < window span {span}")
    # (T - span + 1, span, D) view, then subsample by stride.
    win = np.lib.stride_tricks.sliding_window_view(trace, span, axis=0)
    win = win.transpose(0, 2, 1)[::stride]
    past = np.ascontiguousarray(win[:, :h_in])
    future = np.ascontiguousarray(win[:, h_in:])
    return WindowBatch(past=past, future=future)


def normalize_window(past, future=None):
    """Anchor-center a window batch: subtract the last observed frame (the
    "anchor", shape (..., 1, D)) from past and future.

    Returns (past_n, future_n, anchor); ``future_n`` is None when
    ``future`` is None (inference-time usage).
    """
    anchor = past[..., -1:, :]
    past_n = past - anchor
    future_n = None if future is None else future - anchor
    return past_n, future_n, anchor


def denormalize_window(pred_n, anchor, *, to_sphere: bool = True):
    """Invert :func:`normalize_window` on predicted futures: add the anchor
    back and, if ``to_sphere``, re-project onto the unit sphere (xyz only).
    """
    pred = pred_n + anchor
    if to_sphere:
        n = torch.linalg.vector_norm(pred, dim=-1, keepdim=True)
        pred = pred / torch.clamp(n, min=1e-12)
    return pred
