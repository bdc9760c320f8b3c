"""Public 360° head-trace dataset adapters.

Copy of ``longterm360fov_tpu.datasets``. Each adapter encodes a published
log layout as a :class:`FormatSpec` (``FORMATS``), overridable from the CLI
(``--dataset-format``); ``fmt="auto"`` sniffs the layout from a parsed file.

Layouts:
  * ``tsinghua``: Tsinghua / MMSys'17 (Wu et al.) style, per-user
    directories of per-video CSVs, rows ``playback_t, unix_t, qx, qy, qz,
    qw`` (xyzw quaternions);
  * ``quat_xyzw``: rows ``t, qx, qy, qz, qw``;
  * ``quat_wxyz``: rows ``t, qw, qx, qy, qz``;
  * ``euler_deg``: rows ``t, yaw_deg, pitch_deg[, roll_deg]``;
  * ``euler_rad``: the same in radians;
  * AVtrack360-style JSON logs (``.json``): samples of ``sec`` (or
    ``time``/``t``), ``yaw``, ``pitch`` and ``roll`` in degrees.

Text logs are parsed by the C library of :mod:`.native`; every adapter
produces a ``TraceStore`` (user and video from the directory layout)
resampled to a fixed rate.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Optional

import numpy as np

from .native import parse_trace_bytes
from .traces import Trace, TraceStore, euler_to_xyz, quat_to_xyz, resample

__all__ = [
    "FormatSpec",
    "FORMATS",
    "load_dataset",
    "sniff_format",
    "validate_file",
    "validate_dataset",
]


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    """Column layout of one trace-log family.

    kind: "quat" | "euler"
    t_col: timestamp column index
    cols: for quat — (w, x, y, z) column indices; for euler —
          (yaw, pitch) column indices
    degrees: euler only — values are degrees
    min_cols: minimum column count for a row to be accepted
    """

    kind: str
    t_col: int
    cols: tuple
    degrees: bool = False
    min_cols: int = 0


FORMATS: Dict[str, FormatSpec] = {
    # playback_t, unix_t, qx, qy, qz, qw
    "tsinghua": FormatSpec(kind="quat", t_col=0, cols=(5, 2, 3, 4), min_cols=6),
    # t, qx, qy, qz, qw
    "quat_xyzw": FormatSpec(kind="quat", t_col=0, cols=(4, 1, 2, 3), min_cols=5),
    # t, qw, qx, qy, qz
    "quat_wxyz": FormatSpec(kind="quat", t_col=0, cols=(1, 2, 3, 4), min_cols=5),
    # t, yaw_deg, pitch_deg[, roll]
    "euler_deg": FormatSpec(
        kind="euler", t_col=0, cols=(1, 2), degrees=True, min_cols=3
    ),
    "euler_rad": FormatSpec(kind="euler", t_col=0, cols=(1, 2), min_cols=3),
}


def sniff_format(arr: np.ndarray) -> str:
    """Best-effort layout guess from a parsed (rows, cols) sample."""
    ncol = arr.shape[1]
    if ncol >= 6:
        # 6+ columns: check unit-norm of cols 2-5 (tsinghua quat block)
        n = np.linalg.norm(arr[:, 2:6], axis=1)
        if np.allclose(n, 1.0, atol=0.05):
            return "tsinghua"
    if ncol == 5:
        n = np.linalg.norm(arr[:, 1:5], axis=1)
        if np.allclose(n, 1.0, atol=0.05):
            # wxyz vs xyzw: HMD sessions start near the calibrated
            # identity orientation (w ≈ ±1, vector part ≈ 0), so the
            # scalar slot dominates in the first rows
            head = arr[: min(10, len(arr))]
            w_first = np.mean(np.abs(head[:, 1]))
            w_last = np.mean(np.abs(head[:, 4]))
            return "quat_wxyz" if w_first >= w_last else "quat_xyzw"
    if ncol >= 3:
        return (
            "euler_deg"
            if np.abs(arr[:, 1:3]).max() > 2 * np.pi
            else "euler_rad"
        )
    raise ValueError(f"cannot sniff trace layout from shape {arr.shape}")


def _to_xyz(arr: np.ndarray, spec: FormatSpec) -> np.ndarray:
    if spec.kind == "quat":
        w, x, y, z = (arr[:, c] for c in spec.cols)
        return quat_to_xyz(np.stack([w, x, y, z], axis=-1))
    yaw, pitch = arr[:, spec.cols[0]], arr[:, spec.cols[1]]
    if spec.degrees:
        yaw, pitch = np.radians(yaw), np.radians(pitch)
    return euler_to_xyz(yaw, pitch)


def _load_json_trace(path: str) -> Optional[np.ndarray]:
    """AVtrack360-style JSON logs → (rows, 4) [t, yaw_deg, pitch_deg, roll].

    Layout (per the published AVtrack360 HMD dataset): a JSON object with
    per-video entries carrying a list of samples, each with ``sec`` (or
    ``time``) and head angles ``yaw``/``pitch``/``roll`` in degrees.
    Best-effort: accepts a top-level list of samples or {"data": [...]}.
    """
    import json as _json

    try:
        with open(path) as f:
            obj = _json.load(f)
    except (ValueError, OSError):
        return None
    if isinstance(obj, dict):
        for key in ("data", "samples", "filmedHeadData", "pitch_yaw_roll_data_hmd"):
            if key in obj and isinstance(obj[key], list):
                obj = obj[key]
                break
        else:
            return None
    if not isinstance(obj, list) or not obj:
        return None
    rows = []
    for s in obj:
        if not isinstance(s, dict):
            return None
        t = s.get("sec", s.get("time", s.get("t")))
        yaw = s.get("yaw")
        pitch = s.get("pitch")
        if t is None or yaw is None or pitch is None:
            return None
        rows.append([float(t), float(yaw), float(pitch), float(s.get("roll", 0.0))])
    return np.asarray(rows, np.float32)


def validate_file(
    path: str,
    fmt: str = "auto",
    *,
    rate_hz: float = 10.0,
    spec: Optional[FormatSpec] = None,
) -> Dict:
    """Strict single-file validation for ``inspect-traces --validate``: the
    adapters' layouts are pinned by fixtures only, so a run on real data
    must fail loudly and early instead of silently mis-parsing.

    Returns {"path", "fmt", "errors": [...], "warnings": [...], "rows"}.
    A file passes iff errors == []. Checks, in order:

    * parseable, ≥ 20 rows
    * timestamps strictly increasing; max gap ≤ 5× median dt
    * layout sniff is UNAMBIGUOUS (5-col quats: the wxyz-vs-xyzw
      scalar-slot margin must be clear; eulers: the value range must
      pin degrees vs radians)
    * quat layouts: EVERY row unit-norm within 2%
    * euler layouts: pitch within ±95° / ±(π/2+0.1)
    * resampling at rate_hz yields ≥ 20 unit-norm, finite samples
    """
    rep: Dict = {"path": path, "fmt": None, "errors": [], "warnings": []}
    err, warn = rep["errors"].append, rep["warnings"].append

    if path.endswith(".json"):
        arr = _load_json_trace(path)
        if arr is None:
            err("unparseable JSON trace")
            return rep
    else:
        try:
            with open(path, "rb") as f:
                arr = parse_trace_bytes(f.read())
        except (OSError, ValueError) as e:
            err(f"unparseable: {e}")
            return rep
    rep["rows"] = int(arr.shape[0])
    if arr.shape[0] < 20:
        err(f"only {arr.shape[0]} rows (<20): too short for windows")
        return rep

    s = spec or (FORMATS[fmt] if fmt != "auto" else None)
    if s is None:
        try:
            name = sniff_format(arr)
        except ValueError as e:
            err(str(e))
            return rep
        rep["fmt"] = name
        s = FORMATS[name]
        # ambiguity checks the permissive sniffer glosses over
        if name in ("quat_wxyz", "quat_xyzw"):
            head = arr[: min(10, len(arr))]
            w_first = float(np.mean(np.abs(head[:, 1])))
            w_last = float(np.mean(np.abs(head[:, 4])))
            lo, hi = sorted([w_first, w_last])
            if hi < 0.7 or (lo > 0.0 and hi / max(lo, 1e-9) < 1.5):
                err(
                    "ambiguous quaternion order: scalar slot not "
                    f"dominant in first rows (|col1|~{w_first:.2f}, "
                    f"|col4|~{w_last:.2f}); pass an explicit "
                    "--dataset-format quat_wxyz|quat_xyzw"
                )
        if name in ("euler_deg", "euler_rad"):
            span = float(np.abs(arr[:, 1:3]).max())
            if 1.6 < span <= 2 * np.pi:
                err(
                    f"ambiguous angle units: max |angle| {span:.2f} fits "
                    "both a wide radian range and a tiny degree range; "
                    "pass --dataset-format euler_deg|euler_rad"
                )
    else:
        rep["fmt"] = fmt if fmt != "auto" else "explicit"
        if arr.shape[1] < (s.min_cols or (max(s.cols) + 1)):
            err(
                f"{arr.shape[1]} columns < required "
                f"{s.min_cols or max(s.cols) + 1} for this layout"
            )
            return rep

    ts = arr[:, s.t_col].astype(np.float64)
    dts = np.diff(ts)
    if np.any(dts <= 0):
        n_bad = int(np.sum(dts <= 0))
        err(f"timestamps not strictly increasing ({n_bad} non-positive steps)")
    else:
        med = float(np.median(dts))
        if med <= 0:
            err("zero median timestep")
        elif float(dts.max()) > 5 * med:
            warn(
                f"gappy log: max dt {dts.max():.3f}s vs median {med:.3f}s "
                "(resampling will interpolate across the gap)"
            )
        rep["rate_hz"] = round(1.0 / med, 2) if med > 0 else None

    if s.kind == "quat":
        qn = np.linalg.norm(arr[:, list(s.cols)].astype(np.float64), axis=1)
        if not np.all(np.abs(qn - 1.0) < 0.02):
            err(
                f"non-unit quaternions: |q| in [{qn.min():.3f}, "
                f"{qn.max():.3f}] (tolerance 2%)"
            )
    else:
        pitch = arr[:, s.cols[1]].astype(np.float64)
        lim = 95.0 if s.degrees else np.pi / 2 + 0.1
        if float(np.abs(pitch).max()) > lim:
            err(
                f"pitch out of range: max |pitch| {np.abs(pitch).max():.2f} "
                f"> {lim:.2f} ({'deg' if s.degrees else 'rad'} layout)"
            )

    if not rep["errors"]:
        xyz = _to_xyz(arr.astype(np.float64), s)
        xyz = resample(ts, xyz, rate_hz)
        if len(xyz) < 20:
            err(f"resampled to {len(xyz)} samples (<20) at {rate_hz} Hz")
        elif not np.all(np.isfinite(xyz)):
            err("non-finite samples after conversion/resampling")
        else:
            norms = np.linalg.norm(xyz, axis=-1)
            if not np.all(np.abs(norms - 1.0) < 1e-3):
                err(
                    "resampled points leave the unit sphere: |xyz| in "
                    f"[{norms.min():.4f}, {norms.max():.4f}]"
                )
    return rep


def validate_dataset(
    root: str,
    fmt: str = "auto",
    *,
    rate_hz: float = 10.0,
    glob_pattern: str = "**/*.*",
    spec: Optional[FormatSpec] = None,
) -> Dict:
    """Validate every file under ``root``; also checks the directory has
    cross-user coverage (≥2 users sharing a video) so the cross_user
    presets are usable. Returns
    {"ok": bool, "files": [per-file reports], "dir_warnings": [...]}.
    """
    reports = []
    by_video: Dict[str, set] = {}
    for path in sorted(
        glob.glob(os.path.join(root, glob_pattern), recursive=True)
    ):
        if not os.path.isfile(path):
            continue
        rep = validate_file(path, fmt, rate_hz=rate_hz, spec=spec)
        reports.append(rep)
        if not rep["errors"]:
            stem = os.path.splitext(os.path.basename(path))[0]
            parent = os.path.basename(os.path.dirname(path))
            by_video.setdefault(stem, set()).add(parent)
    dir_warnings = []
    if not reports:
        dir_warnings.append(f"no files under {root}")
    elif all(r["errors"] for r in reports):
        pass  # per-file errors already explain everything
    elif by_video and max(len(u) for u in by_video.values()) < 2:
        dir_warnings.append(
            "no video is shared by ≥2 users (directory convention "
            "<user>/<video>.csv or <video>/<user>.csv) — cross-user "
            "presets will have zero peer context"
        )
    ok = bool(reports) and all(not r["errors"] for r in reports)
    return {"ok": ok, "files": reports, "dir_warnings": dir_warnings}


def load_dataset(
    root: str,
    fmt: str = "auto",
    *,
    rate_hz: float = 10.0,
    glob_pattern: str = "**/*.*",
    spec: Optional[FormatSpec] = None,
) -> TraceStore:
    """Walk a dataset directory into a TraceStore.

    Layout convention: ``root/<user>/<video>.csv`` OR
    ``root/<video>/<user>.csv`` — both map to (user, video) by using the
    directory name and file stem; cross-user grouping only needs the
    video key to be consistent, which either convention satisfies.
    """
    store = TraceStore()
    chosen = spec or (FORMATS[fmt] if fmt != "auto" else None)
    for path in sorted(
        glob.glob(os.path.join(root, glob_pattern), recursive=True)
    ):
        if not os.path.isfile(path):
            continue
        if path.endswith(".json"):
            arr = _load_json_trace(path)
            if arr is None:
                continue
        else:
            try:
                with open(path, "rb") as f:
                    arr = parse_trace_bytes(f.read())
            except (OSError, ValueError):
                continue
        if arr is None or arr.shape[0] < 2:
            continue
        s = chosen
        if s is None:
            try:
                s = FORMATS[sniff_format(arr)]
            except ValueError:
                continue
        if arr.shape[1] < (s.min_cols or (max(s.cols) + 1)):
            continue
        xyz = _to_xyz(arr.astype(np.float64), s)
        xyz = resample(arr[:, s.t_col].astype(np.float64), xyz, rate_hz)
        if len(xyz) < 2:
            continue
        stem = os.path.splitext(os.path.basename(path))[0]
        parent = os.path.basename(os.path.dirname(path))
        store.add(
            Trace(user=parent, video=stem, xyz=xyz, rate_hz=rate_hz)
        )
    return store
