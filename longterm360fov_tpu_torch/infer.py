"""Inference runtime: batched autoregressive decode + tile prefetch.

PyTorch twin of ``longterm360fov_tpu.infer``: many viewers' recent
head-pose windows go in, per-viewer predicted trajectories and prefetch tile
sets come out. normalize → encode → H_out-step decode → denormalize →
(tile mask) runs on the device of the params; the ``"fused"`` impl does the
encode and decode in one CUDA kernel launch, the ``"plain"`` impl step by
step in PyTorch.
"""

from __future__ import annotations

import math
import time
import types
from typing import Callable, Dict

import numpy as np
import torch

from . import geometry, windows
from .config import ExperimentConfig
from .models import get_family
from .params import params_device

__all__ = [
    "predict_xyz",
    "predict_batch",
    "predict_euler",
    "make_predict_fn",
    "tile_centers",
    "tiles_for_fov",
    "tile_of",
    "prefetch_accuracy",
    "stream_simulation",
]

IMPLS = ("fused", "plain")


def predict_xyz(params, cfg: ExperimentConfig, fam, batch: Dict, *, impl: str):
    """Shared serve core: ``batch`` {"past": (B, H_in, 3) raw xyz, and the
    family's extras: an optional per-viewer "context", or the cross_user
    "other_future" (B, K, H_out, 3) and "other_mask" (B, K)} of tensors →
    (B, H_out, 3) predicted unit vectors. The family's ``batch_extras``
    (else ``train.default_extras``) turns the extras into keyword arguments
    of the forward. ``impl`` is one of ``IMPLS``, as ``make_predict_fn`` and
    ``serving.make_serve_fn`` check."""
    from .train import default_extras

    past_n, _, anchor = windows.normalize_window(batch["past"])
    # the result keeps the input's strides (np.concatenate of (1, T, 3)
    # rows may give a column-major batch); the kernel reads rows in place
    past_n = past_n.contiguous()
    kwargs = (getattr(fam, "batch_extras", None) or default_extras)(batch, anchor)
    if impl == "fused":
        pred_n = fam.serve_fused(params, cfg.model, past_n, **kwargs)
    else:
        pred_n = fam.apply(params, cfg.model, past_n, None, **kwargs)
    return windows.denormalize_window(pred_n, anchor, to_sphere=True)


def default_extras_ref():
    from .train import default_extras

    return default_extras


def _forward(params, cfg: ExperimentConfig, apply_fn, batch, extras_fn=None, impl: str = "plain"):
    """Shared decode core of :func:`predict_batch` and :func:`predict_euler`:
    raw past windows (+ family extras) → predicted xyz on the sphere, through
    :func:`predict_xyz` with ``apply_fn`` as the plain forward, ``extras_fn``
    (else ``train.default_extras``) as the batch hook and, for ``"fused"``,
    the family's ``serve_fused``. ``batch`` is {"past": (B, H_in, 3), ...
    extras}, arrays or tensors, moved to the device of the params."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    device = params_device(params)
    fam = types.SimpleNamespace(
        apply=apply_fn, batch_extras=extras_fn or default_extras_ref(),
        serve_fused=getattr(get_family(cfg.model_family), "serve_fused", None),
    )
    batch = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in batch.items() if v is not None}
    return predict_xyz(params, cfg, fam, batch, impl=impl)


def _as_batch(past_or_batch, context=None):
    if isinstance(past_or_batch, dict):
        return past_or_batch
    b = {"past": past_or_batch}
    if context is not None:
        b["context"] = context
    return b


@torch.inference_mode()
def predict_batch(params, cfg: ExperimentConfig, apply_fn, past, context=None, extras_fn=None, *,
                  impl: str = "plain"):
    """(B, H_in, 3) raw xyz windows (or a batch dict with family extras)
    → (B, H_out, 3) predicted unit vectors, on the device of the params."""
    return _forward(params, cfg, apply_fn, _as_batch(past, context), extras_fn, impl)


@torch.inference_mode()
def predict_euler(params, cfg: ExperimentConfig, apply_fn, past, context=None, extras_fn=None, *,
                  impl: str = "plain"):
    """Raw past windows → predicted (yaw, pitch) each (B, H_out), radians —
    the reference's output format for the streaming server."""
    return geometry.xyz_to_euler(_forward(params, cfg, apply_fn, _as_batch(past, context), extras_fn, impl))


def make_predict_fn(
    params, cfg: ExperimentConfig, *, device, with_tiles: bool = False,
    tile_rows: int = 6, tile_cols: int = 12, fov_deg: float = 90.0,
    impl: str = "fused",
) -> Callable:
    """Close over params/config → ``serve(past, context=None)``.

    ``past`` is a (B, H_in, 3) array or tensor of raw xyz windows, or a
    batch dict with "past" and the family's extras (the cross_user
    "other_future" and "other_mask"); everything is moved to ``device``,
    where ``params`` must already be. Returns the (B, H_out, 3) predicted
    xyz, and with ``with_tiles`` also the (B, H_out, R*C) per-step prefetch
    mask."""
    device = torch.device(device)
    fam = get_family(cfg.model_family)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")

    @torch.inference_mode()
    def serve(past, context=None):
        batch = dict(past) if isinstance(past, dict) else {"past": past}
        if context is not None:
            batch["context"] = context
        batch = {
            k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in batch.items() if v is not None
        }
        xyz = predict_xyz(params, cfg, fam, batch, impl=impl)
        if not with_tiles:
            return xyz
        return xyz, tiles_for_fov(
            xyz, tile_rows=tile_rows, tile_cols=tile_cols, fov_deg=fov_deg
        )

    return serve


def tile_centers(tile_rows: int, tile_cols: int, *, device) -> torch.Tensor:
    """Unit-vector centers of an equirectangular tile grid, (R*C, 3).

    Row r spans pitch (pi/2 - r·pi/R ...), col c spans yaw; centers sit
    mid-tile."""
    r = torch.arange(tile_rows, dtype=torch.float32, device=device) + 0.5
    c = torch.arange(tile_cols, dtype=torch.float32, device=device) + 0.5
    pitch = math.pi / 2 - r / tile_rows * math.pi  # (R,) top→bottom
    yaw = -math.pi + c / tile_cols * 2 * math.pi  # (C,)
    yy, pp = torch.meshgrid(yaw, pitch, indexing="xy")  # (R, C)
    return geometry.euler_to_xyz(yy.reshape(-1), pp.reshape(-1))  # (R*C, 3)


def tiles_for_fov(
    pred_xyz: torch.Tensor,
    *,
    tile_rows: int = 6,
    tile_cols: int = 12,
    fov_deg: float = 90.0,
) -> torch.Tensor:
    """Prefetch mask: which tiles the predicted viewport may touch.

    pred_xyz: (..., 3) view directions → bool (..., R*C). A tile is
    fetched when its center lies within fov/2 + half the tile diagonal
    of the view direction."""
    centers = tile_centers(tile_rows, tile_cols, device=pred_xyz.device)
    ang = geometry.great_circle_deg(pred_xyz[..., None, :], centers)  # (..., M)
    tile_radius_deg = 0.5 * math.degrees(
        math.sqrt((math.pi / tile_rows) ** 2 + (2 * math.pi / tile_cols) ** 2)
    )
    return ang <= (fov_deg / 2.0 + tile_radius_deg)


def tile_of(
    xyz: torch.Tensor, *, tile_rows: int = 6, tile_cols: int = 12
) -> torch.Tensor:
    """Index of the tile containing each view direction (..., 3) → (...,)
    int64 in [0, rows*cols)."""
    yaw, pitch = geometry.xyz_to_euler(xyz)
    r = torch.clamp(
        ((math.pi / 2 - pitch) / math.pi * tile_rows).to(torch.int32),
        0, tile_rows - 1,
    )
    c = torch.clamp(
        ((yaw + math.pi) / (2 * math.pi) * tile_cols).to(torch.int32),
        0, tile_cols - 1,
    )
    return (r * tile_cols + c).long()


def prefetch_accuracy(
    pred_xyz: torch.Tensor,
    true_xyz: torch.Tensor,
    *,
    tile_rows: int = 6,
    tile_cols: int = 12,
    fov_deg: float = 90.0,
):
    """Serving-quality metrics for tile prefetch: (hit_rate,
    tiles_per_frame). hit_rate = fraction of frames whose TRUE
    viewport-center tile was in the predicted prefetch set;
    tiles_per_frame = mean prefetched tile count (bandwidth proxy)."""
    mask = tiles_for_fov(
        pred_xyz, tile_rows=tile_rows, tile_cols=tile_cols, fov_deg=fov_deg
    )  # (..., M)
    true_tile = tile_of(true_xyz, tile_rows=tile_rows, tile_cols=tile_cols)
    hit = torch.gather(mask, -1, true_tile[..., None])[..., 0]
    return hit.float().mean(), mask.sum(dim=-1).float().mean()


def stream_simulation(
    params,
    cfg: ExperimentConfig,
    traces_xyz,
    *,
    device,
    deadlines=(1, 10, 30),
    tile_rows: int = 6,
    tile_cols: int = 12,
    fov_deg: float = 90.0,
    impl: str = "fused",
    n_peers: int = 0,
):
    """Continuous streaming simulation, twin of the JAX
    ``infer.stream_simulation``: at every tick each viewer's last H_in
    frames go in, a fresh H_out-frame prediction comes out, and the server
    prefetches the union of its tiles over the horizon; for each download
    deadline δ (frames of lead time) it counts how often the tile the viewer
    looked at δ frames later was in that set.

    ``traces_xyz`` is a list of (T, 3) viewer traces, cut to the shortest.
    With ``n_peers`` = K > 0 each viewer's peers are the next K viewers'
    known futures (``torch.roll`` over the viewer axis, as ``jnp.roll``).
    The rates are :func:`_stream_counts`' counts rounded as JAX's are;
    ``predictions_per_sec`` is on the host clock. ``impl`` is one of
    ``IMPLS``; the CLI's ``stream-sim --impl`` defaults to "fused"."""
    deadlines = tuple(int(d) for d in deadlines)
    hits, tiles_sum, n_view, n_ticks, elapsed = _stream_counts(
        params, cfg, traces_xyz, device=device, deadlines=deadlines, tile_rows=tile_rows, tile_cols=tile_cols,
        fov_deg=fov_deg, impl=impl, n_peers=n_peers)
    n_pred = n_view * n_ticks
    return {
        "viewers": n_view,
        "ticks": n_ticks,
        "hit_rate_by_deadline": {str(dl): round(int(h) / n_pred, 4) for dl, h in zip(deadlines, hits)},
        "mean_tiles_per_frame": round(tiles_sum / n_ticks, 2),
        "predictions_per_sec": round(n_pred / elapsed, 1),
    }


def _stream_counts(params, cfg: ExperimentConfig, traces_xyz, *, device, deadlines, tile_rows, tile_cols, fov_deg,
                   impl, n_peers):
    """The ticks of :func:`stream_simulation`, unrounded → (hits per
    deadline, an int64 array; the tiles a frame summed over the ticks; the
    viewers; the ticks; the seconds they took). The trace stack is copied
    to ``device`` once; every tick (predict → ``tiles_for_fov`` → union over
    the horizon → ``tile_of`` → hit per deadline) runs there on device
    tensors, the counts accumulate there, and only they are read back. JAX
    runs the ticks as one compiled ``lax.scan``; here they are a host loop
    of launches. One tick runs untimed first (the kernels' libraries load);
    the seconds time the rest, synchronized at the end."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    device = torch.device(device)
    h_in, h_out = cfg.model.h_in, cfg.model.h_out
    t_total = min(len(t) for t in traces_xyz)
    stack = np.stack([np.asarray(t[:t_total], np.float32) for t in traces_xyz])  # (V, T, 3)
    n_view = stack.shape[0]

    max_d = max(deadlines)
    if n_peers:
        if n_peers >= n_view:
            raise ValueError(f"n_peers {n_peers} needs at least {n_peers + 1} viewers")
        max_d = max(max_d, h_out)  # peer futures span the horizon
    n_ticks = t_total - max_d - h_in
    if n_ticks <= 0:
        raise ValueError(
            f"traces too short: {t_total} frames < h_in {h_in} + max deadline {max_d} + 1"
        )
    serve = make_predict_fn(params, cfg, device=device, impl=impl)
    stack_d = torch.as_tensor(stack, device=device)
    dl_idx = torch.tensor([d - 1 for d in deadlines], device=device)
    kw = dict(tile_rows=tile_rows, tile_cols=tile_cols)

    def tick(t, hits, tiles):
        batch = {"past": stack_d[:, t - h_in:t].contiguous()}
        if n_peers:
            fut_all = stack_d[:, t:t + h_out]
            # (V, K, h_out, 3): viewer v's k-th peer is viewer v + k + 1
            batch["other_future"] = torch.stack([torch.roll(fut_all, -(k + 1), dims=0) for k in range(n_peers)], 1)
        mask = tiles_for_fov(serve(batch), fov_deg=fov_deg, **kw)  # (V, h_out, M)
        fetch = mask.any(dim=1)  # the union over the horizon: this tick's prefetch set
        tiles += mask.sum(dim=-1).float().mean()
        true_tile = tile_of(stack_d[:, t:t + max_d][:, dl_idx], **kw)  # (V, D): looked at δ frames later
        hits += torch.gather(fetch, 1, true_tile).sum(dim=0)

    with torch.inference_mode():
        tick(h_in, torch.zeros(len(deadlines), dtype=torch.int64, device=device),
             torch.zeros((), device=device))  # untimed: the kernels' libraries load
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        hits = torch.zeros(len(deadlines), dtype=torch.int64, device=device)
        tiles = torch.zeros((), device=device)
        t0 = time.perf_counter()
        for t in range(h_in, h_in + n_ticks):
            tick(t, hits, tiles)
        hits_h, tiles_sum = hits.cpu().numpy(), float(tiles)
    return hits_h, tiles_sum, n_view, n_ticks, max(time.perf_counter() - t0, 1e-9)
