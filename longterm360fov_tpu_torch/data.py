"""Packed-dataset assembly: TraceStore → train/test window arrays.

Copy of ``longterm360fov_tpu.data`` (host numpy). Splitting is by time
within each trace (train on the first fraction, test on the rest), so test
windows never overlap training frames. Outputs are allocated once at their
final size and each trace's windows are written straight into its slice by
the C library's ``native.window_fill``, as the JAX package's C extension
fills them. The packed npz is the one the JAX ``prepare-data`` writes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import native
from .traces import TraceStore

__all__ = ["windows_from_store", "save_packed", "load_packed"]


def _future_mean(
    per_frame: np.ndarray,  # (T_video, ...) per-frame payload
    lo: int,
    n_win: int,
    stride: int,
    h_in: int,
    h_out: int,
) -> np.ndarray:
    """Mean of ``per_frame`` over each window's future span, by prefix sums.
    Windows whose future starts past the payload's end get zeros."""
    t = len(per_frame)
    cs = np.concatenate(
        [np.zeros((1,) + per_frame.shape[1:], np.float64),
         np.cumsum(per_frame, axis=0, dtype=np.float64)]
    )
    a = lo + np.arange(n_win) * stride + h_in
    b = np.minimum(a + h_out, t)
    valid = a < t
    a_c = np.minimum(a, t)
    denom = np.maximum(b - a_c, 1).astype(np.float64)
    out = (cs[b] - cs[a_c]) / denom.reshape((-1,) + (1,) * (per_frame.ndim - 1))
    out[~valid] = 0.0
    return out.astype(np.float32)


def windows_from_store(
    store: TraceStore,
    h_in: int,
    h_out: int,
    *,
    stride: int = 1,
    train_frac: float = 0.8,
    n_other_users: int = 0,
    video_features: Optional[Dict[str, np.ndarray]] = None,
    video_maps: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Build (train, test) dicts of packed windows from every trace.

    With ``n_other_users`` > 0 each window also carries ``other_future``
    (K, H_out, 3), the same-span futures of K other viewers of the same
    video, zero-padded with a matching ``other_mask``. ``video_features``
    ({video: (T_video, F)}) adds ``features`` (F,), the mean over the
    window's future frames; ``video_maps`` ({video: (T_video, Hm, Wm)}) adds
    ``maps`` (Hm, Wm) the same way.
    """
    span = h_in + h_out
    # pass 1: segments and window counts per split
    jobs: Dict[bool, List] = {True: [], False: []}
    totals = {True: 0, False: 0}
    for tr in store.traces:
        t_total = len(tr)
        if t_total < span + 1:
            continue
        cut = int(t_total * train_frac)
        peers = store.others(tr, k=n_other_users) if n_other_users else []
        for is_train, (lo, hi) in ((True, (0, cut)), (False, (cut, t_total))):
            if hi - lo < span:
                continue
            n_win = (hi - lo - span) // stride + 1
            jobs[is_train].append((tr, peers, lo, hi, n_win, totals[is_train]))
            totals[is_train] += n_win

    feat_dim = None
    if video_features is not None:
        feat_dim = next(iter(video_features.values())).shape[-1]
    map_shape = None
    if video_maps is not None:
        map_shape = tuple(next(iter(video_maps.values())).shape[1:])

    def _build(job_list, total) -> Dict[str, np.ndarray]:
        if not total:
            return {}
        out = {
            "past": np.empty((total, h_in, 3), np.float32),
            "future": np.empty((total, h_out, 3), np.float32),
        }
        if n_other_users:
            out["other_future"] = np.zeros(
                (total, n_other_users, h_out, 3), np.float32
            )
            out["other_mask"] = np.zeros((total, n_other_users), np.float32)
        if feat_dim is not None:
            out["features"] = np.zeros((total, feat_dim), np.float32)
        if map_shape is not None:
            out["maps"] = np.zeros((total,) + map_shape, np.float32)
        for tr, peers, lo, hi, n, off in job_list:
            native.window_fill(
                tr.xyz[lo:hi], out["past"][off:off + n],
                out["future"][off:off + n], h_in, stride,
            )
            if map_shape is not None and tr.video in video_maps:
                out["maps"][off:off + n] = _future_mean(
                    np.asarray(video_maps[tr.video], np.float32),
                    lo, n, stride, h_in, h_out,
                )
            if feat_dim is not None and tr.video in video_features:
                out["features"][off:off + n] = _future_mean(
                    np.asarray(video_features[tr.video], np.float32),
                    lo, n, stride, h_in, h_out,
                )
            for k, peer in enumerate(peers):
                if len(peer) < hi:
                    continue
                m = min((hi - lo - span) // stride + 1, n)
                # (N, K, h_out, 3)[:, k] is strided: fill a contiguous
                # scratch, then one strided assign
                fut_k = np.empty((m, h_out, 3), np.float32)
                native.window_fill(peer.xyz[lo:hi], None, fut_k, h_in, stride)
                out["other_future"][off:off + m, k] = fut_k
                out["other_mask"][off:off + m, k] = 1.0
        return out

    return _build(jobs[True], totals[True]), _build(jobs[False], totals[False])


def save_packed(path: str, data: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **data)


def load_packed(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
