"""Evaluation: per-horizon-step great-circle error curves and comparisons.

PyTorch twin of ``longterm360fov_tpu.evaluate``: decode a test split
autoregressively and report the mean great-circle error in degrees per
future step. :func:`evaluate` decodes through ``infer.predict_xyz`` with an
explicit ``impl``: ``"fused"`` is the family's ``serve_fused`` (its serving
kernels on the card, their plain versions on the CPU), ``"plain"`` the step
loop, in the params' dtype: the impl of a bf16 model's in-loop evaluation,
as JAX's ``infer.predict_batch`` decodes it (``train.eval_impl``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import geometry, losses
from .config import ExperimentConfig
from .params import params_device

__all__ = ["evaluate", "evaluate_predictions", "comparison_table"]


def evaluate(
    params,
    cfg: ExperimentConfig,
    data: Dict[str, np.ndarray],
    *,
    impl: str,
    batch_size: Optional[int] = None,
) -> Dict:
    """Decode ``data`` {"past": (N, H_in, 3), "future": (N, H_out, 3), and
    any family extras ("context", "other_future", "other_mask")} in batches
    on the device of ``params`` and aggregate the error curve."""
    from . import infer
    from .models import get_family

    fam = get_family(cfg.model_family)
    device = params_device(params)
    n = len(data["past"])
    bs = min(batch_size or 512, n)
    sums = np.zeros(data["future"].shape[1], np.float64)
    with torch.inference_mode():
        for i in range(0, n, bs):
            batch = {
                k: torch.as_tensor(v[i:i + bs], device=device)
                for k, v in data.items() if k != "future" and v is not None
            }
            pred = infer.predict_xyz(params, cfg, fam, batch, impl=impl)
            fut = torch.as_tensor(data["future"][i:i + bs], device=device)
            deg = geometry.great_circle_deg(pred, fut).cpu().numpy()  # (b, H_out)
            sums += deg.sum(axis=0)
    curve = sums / max(n, 1)
    return {
        "mean_deg": float(curve.mean()),
        "final_step_deg": float(curve[-1]),
        "error_by_step_deg": curve.tolist(),
        "n_windows": n,
    }


def evaluate_predictions(pred_xyz, true_xyz) -> Dict:
    """Aggregate metrics for already-computed predictions (arrays or
    tensors, (N, H_out, 3))."""
    curve = losses.error_by_step(
        torch.as_tensor(pred_xyz), torch.as_tensor(true_xyz)
    ).cpu().numpy()
    return {
        "mean_deg": float(curve.mean()),
        "final_step_deg": float(curve[-1]),
        "error_by_step_deg": curve.tolist(),
    }


def comparison_table(results: Dict[str, Dict]) -> str:
    """Render {model_name: evaluate() result} as an aligned text table."""
    lines = [f"{'model':<28} {'mean °':>8} {'final °':>8}"]
    for name, r in sorted(results.items(), key=lambda kv: kv[1]["mean_deg"]):
        lines.append(
            f"{name:<28} {r['mean_deg']:>8.3f} {r['final_step_deg']:>8.3f}"
        )
    return "\n".join(lines)
