"""Evaluation plots: the error-by-horizon curve, one viewer's trajectory, a
training curve.

Twin of ``longterm360fov_tpu.plots``. Every function writes a PNG through
matplotlib's headless Agg backend and returns its path. matplotlib is
imported inside the functions, so this module imports without it; where it
is absent, :func:`require_matplotlib` raises an ImportError that names it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .traces import xyz_to_euler

__all__ = ["require_matplotlib", "plot_error_by_step", "plot_trajectory", "plot_training_curve"]


def require_matplotlib():
    """``matplotlib.pyplot`` on the Agg backend; an ImportError naming the
    package where it is not installed."""
    try:
        import matplotlib  # noqa: PLC0415
    except ImportError as e:
        raise ImportError("the plots need the matplotlib package, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt  # noqa: PLC0415

    return plt


def plot_error_by_step(curves: Dict[str, Sequence[float]], path: str, *, rate_hz: float = 10.0) -> str:
    """Mean great-circle error against the prediction horizon, the paper's
    headline figure. curves: {model_name: (H_out,) degrees}."""
    plt = require_matplotlib()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name, curve in sorted(curves.items()):
        t = (np.arange(len(curve)) + 1) / rate_hz
        ax.plot(t, curve, label=name, linewidth=1.8)
    ax.set_xlabel("prediction horizon (s)")
    ax.set_ylabel("mean great-circle error (°)")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def plot_trajectory(past_xyz: np.ndarray, true_future_xyz: np.ndarray, pred_future_xyz: np.ndarray, path: str, *,
                    rate_hz: float = 10.0) -> str:
    """One viewer's yaw/pitch time series: observed, true future, predicted
    future."""
    plt = require_matplotlib()
    fig, axes = plt.subplots(2, 1, figsize=(8, 5), sharex=True)
    h_in = len(past_xyz)
    segs = {
        "observed": (np.arange(h_in), past_xyz, "k-"),
        "true": (h_in + np.arange(len(true_future_xyz)), true_future_xyz, "g-"),
        "predicted": (h_in + np.arange(len(pred_future_xyz)), pred_future_xyz, "r--"),
    }
    for label, (idx, xyz, style) in segs.items():
        yaw, pitch = xyz_to_euler(np.asarray(xyz))
        t = idx / rate_hz
        axes[0].plot(t, np.degrees(np.unwrap(yaw)), style, label=label)
        axes[1].plot(t, np.degrees(pitch), style, label=label)
    axes[0].set_ylabel("yaw (°)")
    axes[1].set_ylabel("pitch (°)")
    axes[1].set_xlabel("time (s)")
    for ax in axes:
        ax.grid(alpha=0.3)
    axes[0].legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def plot_training_curve(history: Sequence[dict], path: str, *, key: str = "loss") -> str:
    """Metric-vs-step curve from a train_loop history or JSONL records."""
    plt = require_matplotlib()
    steps = [h["step"] for h in history if key in h]
    vals = [h[key] for h in history if key in h]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(steps, vals, linewidth=1.5)
    ax.set_xlabel("step")
    ax.set_ylabel(key)
    ax.set_yscale("log" if key == "loss" else "linear")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path
