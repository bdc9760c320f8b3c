"""Non-learned baselines: persistence and truncated linear regression.

PyTorch twin of ``longterm360fov_tpu.baselines``: hold the last
orientation, or extrapolate a least-squares line through the recent past,
for every window at once, on the device of the input.
"""

from __future__ import annotations

import torch

from . import geometry

__all__ = ["persistence", "truncated_linreg"]


def persistence(past: torch.Tensor, h_out: int) -> torch.Tensor:
    """Repeat the last observed orientation for the whole horizon:
    (B, H_in, 3) → (B, h_out, 3)."""
    return past[:, -1:, :].expand(past.shape[0], h_out, 3)


def truncated_linreg(past: torch.Tensor, h_out: int, *, fit_len: int = 5) -> torch.Tensor:
    """Linear extrapolation of the last ``fit_len`` frames, per coordinate,
    re-projected onto the sphere: slope = cov(t, x) / var(t) over the time
    index, in closed form for all windows."""
    tail = past[:, -fit_len:, :]  # (B, L, 3)
    t = torch.arange(fit_len, dtype=tail.dtype, device=tail.device)
    tc = (t - t.mean())[None, :, None]  # (1, L, 1)
    x_mean = tail.mean(dim=1, keepdim=True)  # (B, 1, 3)
    slope = torch.sum(tc * (tail - x_mean), dim=1) / torch.sum(tc * tc)  # (B, 3)
    steps = torch.arange(1, h_out + 1, dtype=tail.dtype, device=tail.device)[None, :, None]
    pred = tail[:, -1, None, :] + steps * slope[:, None, :]
    return geometry.normalize_sphere(pred)
