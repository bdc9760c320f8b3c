"""Head-orientation traces: parsing, resampling, synthetic data; host code.

Copy of ``longterm360fov_tpu.traces``: ``load_trace`` parses one log
(Python ``float``, float64), ``resample`` brings a trace to a fixed rate
along great circles (timestamps stay float64 through ``searchsorted``; the
fraction and the slerp are float32, as JAX computes them), ``TraceStore``
groups traces by video, and ``synthetic_store`` makes a stand-in dataset.
Quaternions and slerp go through the port's ``geometry`` on CPU float32
tensors, which rounds where the JAX functions round when they run op by op.

The JAX package computes the conversions between (yaw, pitch) and xyz in
float32 through XLA, whose CPU backend evaluates sin, cos and atan2 with the
C library's float32 functions (``sinf``, ``cosf``, ``atan2f``) and arcsin as
``2·atan2(x, 1 + sqrt((1 - x)(1 + x)))``, and it sums the squares of a
vector's norm with fused multiply-adds. numpy's float32 ufuncs round
differently in the last bit, so :func:`euler_to_xyz` and
:func:`xyz_to_euler` here call the same C functions and fuse the same
multiply-adds: the synthetic store is then the JAX package's, bit for bit.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import geometry

__all__ = [
    "Trace",
    "TraceStore",
    "euler_to_xyz",
    "xyz_to_euler",
    "quat_to_xyz",
    "load_trace",
    "resample",
    "synthetic_trace",
    "synthetic_store",
]

_EPS = np.float32(1e-12)


@functools.cache
def _libm_f32():
    """float32 sinf, cosf and atan2f of the C library, as numpy ufuncs."""
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fns = {}
    for name, nargs in (("sinf", 1), ("cosf", 1), ("atan2f", 2)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_float] * nargs
        fn.restype = ctypes.c_float
        fns[name] = np.frompyfunc(fn, nargs, 1)
    return fns


def _f32(name, *args):
    args = [np.asarray(a, np.float32) for a in args]
    return np.asarray(_libm_f32()[name](*args), np.float32)


def euler_to_xyz(yaw, pitch) -> np.ndarray:
    """(yaw, pitch) radians → float32 unit vectors (..., 3), computed in
    float32 as the JAX ``geometry.euler_to_xyz`` computes it."""
    cp = _f32("cosf", pitch)
    return np.stack(
        [cp * _f32("cosf", yaw), cp * _f32("sinf", yaw), _f32("sinf", pitch)],
        axis=-1,
    )


def _fma(x, y, z):
    """float32 x·y + z as one fused multiply-add: the float64 product of two
    float32 values is exact, and the float64 sum rounds to float32 (twice
    rounded, which differs from once only in rare halfway cases)."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


def xyz_to_euler(v) -> Tuple[np.ndarray, np.ndarray]:
    """Unit vectors (..., 3) → float32 (yaw, pitch) radians, re-projected
    onto the sphere first, as the JAX ``geometry.xyz_to_euler``."""
    v = np.asarray(v, np.float32)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    norm = np.sqrt(_fma(z, z, _fma(y, y, x * x)))[..., None]
    v = v / np.maximum(norm, _EPS)
    yaw = _f32("atan2f", v[..., 1], v[..., 0])
    x = np.clip(v[..., 2], np.float32(-1.0), np.float32(1.0))
    one = np.float32(1.0)
    pitch = np.float32(2.0) * _f32("atan2f", x, one + np.sqrt((one - x) * (one + x)))
    return yaw, pitch


def quat_to_xyz(q) -> np.ndarray:
    """Quaternions (..., 4) (w, x, y, z) → float32 unit vectors (..., 3),
    in float32 as the JAX ``geometry.quat_to_xyz`` computes them."""
    return geometry.quat_to_xyz(torch.from_numpy(np.array(q, np.float32))).numpy()


@dataclass
class Trace:
    """One viewer's head-orientation trajectory for one video.

    xyz: (T, 3) unit viewing-direction vectors at a fixed frame rate.
    rate_hz: sampling rate.
    """

    user: str
    video: str
    xyz: np.ndarray
    rate_hz: float

    @property
    def euler(self) -> Tuple[np.ndarray, np.ndarray]:
        """(yaw, pitch) arrays in radians, derived from xyz."""
        return xyz_to_euler(self.xyz)

    def __len__(self) -> int:
        return self.xyz.shape[0]


def load_trace(
    path: str,
    *,
    user: str | None = None,
    video: str | None = None,
    rate_hz: float = 10.0,
    fmt: str = "auto",
) -> Trace:
    """Parse one head-pose log file → fixed-rate :class:`Trace`.

    Layouts (``fmt``): ``"quat"`` ``t, qw, qx, qy, qz``; ``"euler"``
    ``t, yaw, pitch[, roll]`` in radians; ``"euler_deg"`` the same in
    degrees; ``"auto"`` picks by column count (5 or more → quat, else euler,
    in degrees when some |angle| > 2π). Commas or whitespace separate
    values; blank lines, '#' comments and non-numeric header rows are
    skipped. ``user`` defaults to the file's stem, ``video`` to its
    directory's name."""
    rows: List[List[float]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                rows.append([float(p) for p in line.replace(",", " ").split()])
            except ValueError:
                continue  # header row
    if not rows:
        raise ValueError(f"no numeric rows in {path}")
    arr = np.asarray(rows, dtype=np.float64)
    t = arr[:, 0]
    if fmt == "auto":
        if arr.shape[1] >= 5:
            fmt = "quat"
        else:
            fmt = "euler_deg" if np.abs(arr[:, 1:3]).max() > 2 * np.pi else "euler"
    if fmt == "quat":
        xyz = quat_to_xyz(arr[:, 1:5])
    elif fmt in ("euler", "euler_deg"):
        yaw, pitch = arr[:, 1], arr[:, 2]
        if fmt == "euler_deg":
            yaw, pitch = np.radians(yaw), np.radians(pitch)
        xyz = euler_to_xyz(yaw, pitch)
    else:
        raise ValueError(f"unknown trace format {fmt!r}")
    name = os.path.splitext(os.path.basename(path))[0]
    return Trace(
        user=user or name,
        video=video or os.path.basename(os.path.dirname(path)) or "video0",
        xyz=resample(t, xyz, rate_hz),
        rate_hz=rate_hz,
    )


def resample(t: np.ndarray, xyz: np.ndarray, rate_hz: float) -> np.ndarray:
    """Resample (T, 3) orientations at timestamps ``t`` to a fixed rate,
    float32. Timestamps are sorted (stably) and duplicates dropped (the
    first kept); between samples the orientation follows the great circle
    (slerp), never the chord."""
    t = np.asarray(t, dtype=np.float64)
    order = np.argsort(t, kind="stable")
    t, xyz = t[order], np.asarray(xyz)[order]
    keep = np.concatenate([[True], np.diff(t) > 0])
    t, xyz = t[keep], xyz[keep]
    if len(t) < 2:
        return xyz.astype(np.float32)
    new_t = np.arange(t[0], t[-1], 1.0 / rate_hz)
    idx = np.clip(np.searchsorted(t, new_t, side="right") - 1, 0, len(t) - 2)
    t0, t1 = t[idx], t[idx + 1]
    frac = (new_t - t0) / np.maximum(t1 - t0, 1e-12)
    xyz = torch.from_numpy(np.array(xyz, np.float32))
    idx = torch.from_numpy(idx)
    return geometry.slerp(xyz[idx], xyz[idx + 1], torch.from_numpy(frac.astype(np.float32))).numpy()


@dataclass
class TraceStore:
    """Groups traces by video so cross-user context can be built."""

    traces: List[Trace] = field(default_factory=list)
    _by_video: Dict[str, List[int]] = field(default_factory=dict)

    def add(self, trace: Trace) -> None:
        self._by_video.setdefault(trace.video, []).append(len(self.traces))
        self.traces.append(trace)

    def videos(self) -> List[str]:
        return sorted(self._by_video)

    def by_video(self, video: str) -> List[Trace]:
        return [self.traces[i] for i in self._by_video.get(video, [])]

    def others(self, trace: Trace, k: int | None = None) -> List[Trace]:
        """Other viewers of the same video (cross-user context), optionally
        truncated to the first k."""
        peers = [t for t in self.by_video(trace.video) if t.user != trace.user]
        return peers[:k] if k is not None else peers

    def __len__(self) -> int:
        return len(self.traces)


def synthetic_trace(
    key: int,
    n_frames: int = 600,
    rate_hz: float = 10.0,
    *,
    user: str = "synth",
    video: str = "synthvid",
) -> Trace:
    """Smooth random walk on the sphere, a stand-in head trace: a sum of
    low-frequency sinusoids in yaw/pitch with per-trace random phases and
    frequencies, plus small band-limited noise; deterministic in ``key``."""
    rng = np.random.default_rng(key)
    tt = np.arange(n_frames) / rate_hz
    yaw = np.zeros(n_frames)
    pitch = np.zeros(n_frames)
    for _ in range(3):
        yaw += rng.uniform(0.2, 1.5) * np.sin(
            2 * np.pi * rng.uniform(0.02, 0.15) * tt + rng.uniform(0, 2 * np.pi)
        )
        pitch += rng.uniform(0.05, 0.3) * np.sin(
            2 * np.pi * rng.uniform(0.02, 0.2) * tt + rng.uniform(0, 2 * np.pi)
        )
    # band-limited jitter: cumulative noise, strongly smoothed
    jitter = rng.normal(0, 0.002, (n_frames, 2)).cumsum(axis=0)
    yaw = yaw + jitter[:, 0]
    pitch = np.clip(pitch + jitter[:, 1], -1.3, 1.3)
    return Trace(user=user, video=video, xyz=euler_to_xyz(yaw, pitch), rate_hz=rate_hz)


def synthetic_store(
    n_users: int = 8,
    n_videos: int = 2,
    n_frames: int = 600,
    rate_hz: float = 10.0,
    seed: int = 0,
) -> TraceStore:
    """A TraceStore of synthetic viewers. Viewers of the same video share a
    common "attention" component plus a private walk, so cross-user
    conditioning genuinely helps."""
    store = TraceStore()
    for v in range(n_videos):
        shared = synthetic_trace(seed + 1000 * v, n_frames, rate_hz)
        s_yaw, s_pitch = shared.euler
        for u in range(n_users):
            private = synthetic_trace(seed + 1000 * v + u + 1, n_frames, rate_hz)
            p_yaw, p_pitch = private.euler
            # unwrap before mixing so the blend doesn't jump at ±pi
            yaw = 0.6 * np.unwrap(s_yaw) + 0.4 * np.unwrap(p_yaw)
            pitch = 0.6 * s_pitch + 0.4 * p_pitch
            store.add(
                Trace(
                    user=f"user{u}",
                    video=f"video{v}",
                    xyz=euler_to_xyz(yaw, pitch),
                    rate_hz=rate_hz,
                )
            )
    return store
