"""Spherical geometry for head-orientation traces: the serve path's subset.

PyTorch twin of ``longterm360fov_tpu.geometry``, same conventions:

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
    "euler_to_xyz",
    "euler_to_xyz_np",
    "xyz_to_euler",
    "normalize_sphere",
    "wrap_angle",
    "great_circle_rad",
    "great_circle_deg",
]

_EPS = 1e-12


def wrap_angle(a):
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


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
