"""Spherical geometry for head-orientation traces.

PyTorch twin of ``longterm360fov_tpu.geometry``, same conventions:

* Quaternions are (w, x, y, z), unit-normalized, Hamilton convention.
* ``yaw``  = longitude in radians, range (-pi, pi], positive to the left.
* ``pitch`` = latitude in radians, range [-pi/2, pi/2], positive up.
* xyz frame: ``x = cos(pitch)·cos(yaw)``, ``y = cos(pitch)·sin(yaw)``,
  ``z = sin(pitch)``.  z is "up".

All functions are batched over arbitrary leading axes and run on the
device of their input.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "quat_normalize",
    "quat_to_euler",
    "quat_to_xyz",
    "euler_to_xyz",
    "euler_to_xyz_np",
    "xyz_to_euler",
    "normalize_sphere",
    "wrap_angle",
    "great_circle_rad",
    "great_circle_deg",
    "slerp",
]

_EPS = 1e-12


def wrap_angle(a):
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def _fma(a, b, c):
    """a·b + c rounded once, as XLA's CPU backend fuses a product into the
    sum that takes it: for float32 the float64 product of two float32
    values is exact and the float64 sum rounds to float32 (twice rounded,
    which differs from once only in rare halfway cases)."""
    if a.dtype == torch.float32:
        return (a.double() * b + c).float()
    return a * b + c


def _sqrt(x):
    """Correctly rounded square root: torch's vectorized float32 sqrt on the
    CPU is off by an ulp in about one case of 150, so float32 takes the
    float64 root (rounding it to float32 is exact)."""
    if x.dtype == torch.float32:
        return x.double().sqrt().float()
    return x.sqrt()


def _sphere(v):
    """:func:`normalize_sphere` with the squares summed as the JAX
    ``normalize_sphere`` sums them: ``jnp.linalg.norm`` is one compiled
    program, whose reduction fuses each square into the running sum."""
    x, y, z = v.unbind(-1)
    n = _sqrt(_fma(z, z, _fma(y, y, x * x)))[..., None]
    return v / torch.clamp(n, min=_EPS)


def _asin(x):
    """arcsin as XLA's CPU backend computes it:
    2·atan2(x, 1 + sqrt((1 - x)(1 + x)))."""
    return 2.0 * torch.atan2(x, 1.0 + _sqrt((1.0 - x) * (1.0 + x)))


def quat_normalize(q):
    """Normalize quaternions (..., 4) to unit norm (the squares summed as
    in :func:`_sphere`)."""
    w, x, y, z = q.unbind(-1)
    n = _sqrt(_fma(z, z, _fma(y, y, _fma(x, x, w * w))))[..., None]
    return q / torch.clamp(n, min=_EPS)


def quat_to_euler(q):
    """Quaternion (..., 4) (w, x, y, z) → (yaw, pitch, roll), each (...,):
    intrinsic Z-Y-X, pitch through a clamped asin.

    The quaternion functions and :func:`slerp` round where the JAX ones
    round when they run op by op, as the host ingest calls them: every
    product and sum alone, the norms and the cross product fused. Near
    gimbal lock a last-bit difference in an argument of atan2 grows a
    thousandfold, so the port's ingest matches JAX's to rounding."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    pitch = _asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    return yaw, pitch, roll


def quat_to_xyz(q):
    """Quaternion (..., 4) → viewing-direction unit vector (..., 3): the
    forward axis (1, 0, 0) rotated by q, with z flipped so that pitch is
    positive up; exact at the poles."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    vx = 1.0 - 2.0 * (y * y + z * z)
    vy = 2.0 * (x * y + w * z)
    vz = 2.0 * (x * z - w * y)
    return _sphere(torch.stack([vx, vy, -vz], dim=-1))


def euler_to_xyz(yaw, pitch):
    """(yaw, pitch) radians → unit vector (..., 3) on the sphere."""
    cp = torch.cos(pitch)
    return torch.stack(
        [cp * torch.cos(yaw), cp * torch.sin(yaw), torch.sin(pitch)], dim=-1
    )


def euler_to_xyz_np(yaw, pitch):
    """Host-side numpy twin of :func:`euler_to_xyz`, f32, for per-request
    paths that must not touch the device (the serving daemon's sessions)."""
    cp = np.cos(pitch)
    return np.stack(
        [cp * np.cos(yaw), cp * np.sin(yaw), np.sin(pitch)], axis=-1
    ).astype(np.float32)


def xyz_to_euler(v):
    """Unit vector (..., 3) → (yaw, pitch) radians; ``v`` is re-projected
    onto the sphere first, so raw model output is safe."""
    v = normalize_sphere(v)
    yaw = torch.atan2(v[..., 1], v[..., 0])
    pitch = torch.asin(torch.clamp(v[..., 2], -1.0, 1.0))
    return yaw, pitch


def normalize_sphere(v):
    """Project (..., 3) vectors back onto the unit sphere."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=_EPS)


def great_circle_rad(p, q):
    """Great-circle angle in radians between (..., 3) vectors, in the
    gradient-stable ``atan2(|p×q|, p·q)`` form with the JAX version's eps
    inside the square root."""
    p = normalize_sphere(p)
    q = normalize_sphere(q)
    p, q = torch.broadcast_tensors(p, q)  # linalg.cross needs equal ranks
    c = torch.linalg.cross(p, q, dim=-1)
    cross = torch.sqrt(torch.sum(c * c, dim=-1) + 1e-24)
    dot = torch.sum(p * q, dim=-1)
    return torch.atan2(cross, dot)


def great_circle_deg(p, q):
    """Great-circle angle in degrees — the headline eval metric."""
    return torch.rad2deg(great_circle_rad(p, q))


def slerp(p, q, t):
    """Spherical linear interpolation between unit vectors p, q (..., 3) at
    t in [0, 1] (a number or a (...,) tensor); normalized lerp where the
    angle's sine is under 1e-6. Rounded as :func:`quat_to_euler` says."""
    p = _sphere(p)
    q = _sphere(q)
    (px, py, pz), (qx, qy, qz) = p.unbind(-1), q.unbind(-1)
    cx, cy, cz = _fma(py, qz, -(pz * qy)), _fma(pz, qx, -(px * qz)), _fma(px, qy, -(py * qx))
    c2 = cx * cx, cy * cy, cz * cz
    cross = _sqrt((c2[0] + c2[1]) + c2[2] + 1e-24)
    omega = torch.atan2(cross, (px * qx + py * qy) + pz * qz)[..., None]
    so = torch.sin(omega)
    t = torch.as_tensor(t, dtype=omega.dtype, device=omega.device)
    if t.ndim:  # broadcast (...,) t over the vector axis
        t = t[..., None]
    small = so < 1e-6
    safe = torch.where(small, torch.ones_like(so), so)
    w_p = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * omega) / safe)
    w_q = torch.where(small, t, torch.sin(t * omega) / safe)
    return _sphere(w_p * p + w_q * q)
