"""Training objectives and evaluation metrics.

PyTorch twin of ``longterm360fov_tpu.losses``: MSE on normalized
coordinates for training, the mean great-circle angle in degrees for
evaluation, and the spherical great-circle loss. Every function reduces over
arbitrary leading batch axes and runs on the device of its inputs; the
great-circle form is ``geometry.great_circle_rad``'s ``atan2(|p×q|, p·q)``,
whose gradient stays finite at zero error.
"""

from __future__ import annotations

import torch

from .geometry import great_circle_deg, great_circle_rad

__all__ = [
    "mse_loss",
    "great_circle_loss",
    "great_circle_deg_metric",
    "error_by_step",
    "combined_loss",
]


def mse_loss(pred, target, weights=None):
    """Mean squared error over all elements; optional per-sample weights
    broadcast over the trailing axes."""
    err = torch.square(pred - target)
    if weights is not None:
        err = err * weights[..., None, None]
    return torch.mean(err)


def great_circle_loss(pred_xyz, true_xyz):
    """Mean great-circle angle (radians): the differentiable spherical
    training loss. Inputs (..., 3); re-normalized internally."""
    return torch.mean(great_circle_rad(pred_xyz, true_xyz))


def great_circle_deg_metric(pred_xyz, true_xyz):
    """Mean great-circle error in degrees, the headline eval metric. Not
    meant for backprop (use :func:`great_circle_loss`)."""
    return torch.mean(great_circle_deg(pred_xyz, true_xyz))


def error_by_step(pred_xyz, true_xyz):
    """Per-horizon-step mean great-circle error curve in degrees:
    (N, H_out, 3) → (H_out,)."""
    deg = great_circle_deg(pred_xyz, true_xyz)  # (N, H_out)
    return torch.mean(deg, dim=tuple(range(deg.dim() - 1)))


def combined_loss(pred_n, true_n, pred_xyz, true_xyz, gc_weight: float = 0.0):
    """MSE on normalized coords plus an optional great-circle term;
    ``gc_weight=0`` is pure MSE."""
    loss = mse_loss(pred_n, true_n)
    if gc_weight:
        loss = loss + gc_weight * great_circle_loss(pred_xyz, true_xyz)
    return loss
