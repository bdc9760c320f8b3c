"""Equirectangular video feature extraction.

PyTorch twin of ``longterm360fov_tpu.features.equirect``. Pipeline: decode
frames on the host (OpenCV when present, else raw .npy/.npz arrays) → move
them to the device → luminance, spectral-residual saliency, temporal motion
magnitude, and a conv feature stack over the fused conv+resize kernel
(``ops.conv_resize``). Per-frame outputs pool into compact feature vectors
the fusion model conditions on.

Every step is batched over the frames of a clip: one call for a whole clip,
no per-frame loop. A clip's intermediates live on the device at once
(luma 4·T·H·W bytes, each complex spectrum 8·T·H·W), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv_resize import conv_resize_reference, fused_conv_resize

__all__ = [
    "decode_frames",
    "luminance",
    "saliency_map",
    "motion_map",
    "init_conv_features",
    "conv_features",
    "extract_clip_features",
]


def decode_frames(
    path: str,
    *,
    max_frames: Optional[int] = None,
    stride: int = 1,
) -> np.ndarray:
    """Host-side decode → (T, H, W, 3) uint8.

    Accepts a video file (OpenCV, when importable) or .npy/.npz of frames
    (always available)."""
    if path.endswith((".npy", ".npz")):
        arr = np.load(path)
        if hasattr(arr, "files"):
            arr = arr[arr.files[0]]
        frames = arr[::stride]
        return frames[:max_frames] if max_frames else frames
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"OpenCV unavailable for video decode of {path}; "
            "pre-extract frames to .npy"
        ) from e
    cap = cv2.VideoCapture(path)
    out = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % stride == 0:
            out.append(frame[..., ::-1])  # BGR→RGB
            if max_frames and len(out) >= max_frames:
                break
        i += 1
    cap.release()
    return np.stack(out) if out else np.zeros((0, 0, 0, 3), np.uint8)


def luminance(frames: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) uint8/float → (T, H, W) float32 luma in [0, 1]: uint8
    is divided by 255, other types are taken as they are. Channel by
    channel, so a uint8 clip never exists as a (T, H, W, 3) f32 copy."""
    scale = 255.0 if frames.dtype == torch.uint8 else None

    def chan(c):
        f = frames[..., c].float()
        return f / scale if scale else f

    return 0.299 * chan(0) + 0.587 * chan(1) + 0.114 * chan(2)


def saliency_map(luma: torch.Tensor, *, blur: int = 3) -> torch.Tensor:
    """Spectral-residual saliency (Hou & Zhang 2007) per frame, batched:
    (T, H, W) → (T, H, W) in [0, 1]. The log-amplitude minus its box-blurred
    self, recombined with the phase, back through the inverse FFT, squared,
    smoothed and normalised by each frame's max."""
    spec = torch.fft.fft2(luma)
    log_amp = torch.log(spec.abs() + 1e-8)
    phase = torch.angle(spec)
    del spec
    box = torch.full((blur, blur), 1.0 / (blur * blur), device=luma.device, dtype=luma.dtype)
    avg = _conv2_same(log_amp, box)
    resid = log_amp - avg
    del log_amp, avg
    sal = torch.fft.ifft2(torch.polar(torch.exp(resid), phase)).abs() ** 2
    del resid, phase
    sal = _conv2_same(sal, torch.full((5, 5), 1.0 / 25.0, device=luma.device, dtype=luma.dtype))
    mx = sal.amax(dim=(-2, -1), keepdim=True)
    return sal / torch.clamp(mx, min=1e-12)


def motion_map(luma: torch.Tensor) -> torch.Tensor:
    """Temporal-difference motion magnitude, smoothed: (T, H, W) →
    (T, H, W); frame 0 is zeros."""
    diff = (luma[1:] - luma[:-1]).abs()
    diff = _conv2_same(diff, torch.full((5, 5), 1.0 / 25.0, device=luma.device, dtype=luma.dtype))
    return torch.cat([torch.zeros_like(luma[:1]), diff], dim=0)


def _conv2_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthless 2-D SAME conv (odd kernel) over trailing (H, W) of a
    (..., H, W) tensor."""
    batch_shape = x.shape[:-2]
    h, w = x.shape[-2:]
    kh, kw = kernel.shape
    out = F.conv2d(x.reshape(-1, 1, h, w), kernel[None, None], padding=(kh // 2, kw // 2))
    return out.reshape(*batch_shape, h, w)


def init_conv_features(
    gen: torch.Generator,
    *,
    channels: int = 8,
    ksize: int = 3,
    feat_dim: int = 64,
    grid: Tuple[int, int] = (8, 16),
    device,
) -> Dict[str, torch.Tensor]:
    """Trainable conv-stack params from a CPU generator, on ``device``:
    fused conv+resize filters (N(0, 1/K²)) and a Glorot-uniform linear head
    from pooled (C × grid) activations to ``feat_dim``. ``grid`` is static
    config: pass the same value to :func:`conv_features`. The numbers differ
    from ``jax.random``'s for the same seed."""
    kernels = torch.randn((channels, ksize, ksize), generator=gen) / math.sqrt(ksize * ksize)
    pooled = channels * grid[0] * grid[1]
    limit = math.sqrt(6.0 / (pooled + feat_dim))
    head_w = (torch.rand((pooled, feat_dim), generator=gen) * 2 - 1) * limit
    return {
        "kernels": kernels.to(device),
        "bias": torch.zeros(channels, device=device),
        "head_w": head_w.to(device),
        "head_b": torch.zeros(feat_dim, device=device),
    }


def conv_features(
    params: Dict[str, torch.Tensor],
    maps: torch.Tensor,  # (T, H, W) saliency or motion (or luma) maps
    *,
    grid: Tuple[int, int] = (8, 16),
    use_pallas: bool = True,
) -> torch.Tensor:
    """(T, H, W) → (T, feat_dim) per-frame feature vectors: resize to 4x the
    pooling grid and conv (``use_pallas``, the JAX name: the fused kernel's
    wrapper, ``ops.conv_resize.fused_conv_resize``; else its differentiable
    plain version), average-pool to the grid, linear head."""
    grid_h, grid_w = grid
    op = fused_conv_resize if use_pallas else conv_resize_reference
    feat = op(
        maps.float().contiguous(),
        (grid_h * 4, grid_w * 4),
        params["kernels"],
        params["bias"],
    )  # (T, C, 4g, 4g)
    t, c = feat.shape[:2]
    pooled = feat.reshape(t, c, grid_h, 4, grid_w, 4).mean(dim=(3, 5))
    return pooled.reshape(t, -1) @ params["head_w"] + params["head_b"]


def extract_clip_features(
    params: Dict[str, torch.Tensor],
    frames,  # (T, H, W, 3) array or tensor
    *,
    grid: Tuple[int, int] = (8, 16),
) -> torch.Tensor:
    """A clip's whole path: luma → saliency + motion → the conv stack on
    both maps (the fused kernel's wrapper), concatenated → (T, 2·feat_dim),
    on the device of ``params`` (a host array is moved there)."""
    frames = torch.as_tensor(frames, device=params["kernels"].device)
    luma = luminance(frames)
    f_sal = conv_features(params, saliency_map(luma), grid=grid)
    f_mot = conv_features(params, motion_map(luma), grid=grid)
    return torch.cat([f_sal, f_mot], dim=-1)
