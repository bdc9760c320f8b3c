"""Trace ingest of the port against the JAX package on the same files and
inputs: the quaternion functions and slerp of ``geometry``,
``traces.load_trace`` and ``resample``, ``datasets`` (``load_dataset`` on
every ``FORMATS`` layout and on AVtrack360 JSON, ``validate_file`` and
``validate_dataset``), the ``inspect-traces`` output in both modes, and the
``prepare-data --traces`` npz.

Inputs are seeded numpy arrays, or log files written to ``tmp_path``. The
JAX functions run op by op, as its ingest calls them; the port rounds where
they round (the norms and the cross product fused), so the windows agree to
about an ulp: every float comparison below is within 1e-6 absolute. The
largest readings on this suite's inputs: ``quat_to_xyz`` and
``quat_normalize`` bit-equal, ``quat_to_euler`` 2.4e-7 (angles near ±π),
the ingested traces 1.2e-7, and ``slerp`` 9.5e-7 between endpoints 174°
apart, where an ulp of sin(ω) is divided by sin(ω) ≈ 0.1 (the sines are
torch's and the C library's, each within an ulp)."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import json

import numpy as np
import pytest
import torch

from longterm360fov_tpu import cli as jax_cli
from longterm360fov_tpu import datasets as jax_datasets
from longterm360fov_tpu import geometry as jax_geometry
from longterm360fov_tpu import traces as jax_traces
from longterm360fov_tpu_torch import cli, datasets, geometry, traces

TOL = 1e-6


def _quats(n, seed):
    """Seeded unit-ish quaternions (w, x, y, z), a tenth of them near gimbal
    lock (pitch ±90°), where atan2's arguments are small."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    lock = rng.random(n) < 0.1
    s = np.sqrt(0.5)
    q[lock] = np.array([s, 0.0, s, 0.0]) + rng.normal(scale=1e-3, size=(lock.sum(), 4))
    return (q * rng.uniform(0.5, 2.0, (n, 1))).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def test_quaternion_functions_match_jax():
    q = _quats(20000, 0)
    np.testing.assert_allclose(geometry.quat_normalize(_t(q)).numpy(), jax_geometry.quat_normalize(q), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(geometry.quat_to_xyz(_t(q)).numpy(), jax_geometry.quat_to_xyz(q), rtol=0, atol=TOL)
    for ours, ref in zip(geometry.quat_to_euler(_t(q)), jax_geometry.quat_to_euler(q)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    # batched over leading axes
    assert geometry.quat_to_xyz(_t(q.reshape(4, 5000, 4))).shape == (4, 5000, 3)
    assert all(a.shape == (4, 5000) for a in geometry.quat_to_euler(_t(q.reshape(4, 5000, 4))))


@pytest.mark.parametrize("t_kind", ["scalar", "per-row"])
def test_slerp_matches_jax(t_kind):
    rng = np.random.default_rng(1)
    p = np.asarray(jax_geometry.quat_to_xyz(_quats(5000, 2)))
    q = p + rng.normal(scale=rng.choice([1e-8, 1e-4, 0.1, 2.0], (5000, 1)), size=(5000, 3)).astype(np.float32)
    q[:10] = p[:10]  # identical endpoints: the lerp branch
    t = np.float32(0.37) if t_kind == "scalar" else rng.uniform(size=5000).astype(np.float32)
    ours = geometry.slerp(_t(p), _t(q), t if t_kind == "scalar" else _t(t)).numpy()
    np.testing.assert_allclose(ours, jax_geometry.slerp(p, q, t), rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, atol=1e-6)


def test_resample_matches_jax():
    rng = np.random.default_rng(3)
    t = np.cumsum(rng.uniform(0.02, 0.05, 400))
    t[50] = t[49]  # a duplicate timestamp: the first is kept
    order = rng.permutation(400)  # out of order: sorted stably
    xyz = np.asarray(jax_geometry.quat_to_xyz(_quats(400, 4)))
    ours = traces.resample(t[order], xyz[order], 10.0)
    ref = jax_traces.resample(t[order], xyz[order], 10.0)
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)
    # fewer than two distinct timestamps: the samples as they are, float32
    np.testing.assert_array_equal(traces.resample([1.0, 1.0], xyz[:2], 10.0),
                                  jax_traces.resample([1.0, 1.0], xyz[:2], 10.0))


def _walk(rng, n, hz=30.0):
    """A head path: jittered timestamps about ``hz``, yaw and pitch in
    radians (a smooth random walk)."""
    t = np.arange(n) / hz + rng.uniform(-0.003, 0.003, n)
    yaw = np.cumsum(rng.normal(0, 0.02, n)) + rng.uniform(-np.pi, np.pi)
    pitch = np.clip(np.cumsum(rng.normal(0, 0.01, n)), -1.3, 1.3)
    return t, yaw, pitch


def _wxyz(yaw, pitch):
    cy, sy, cp, sp = np.cos(yaw / 2), np.sin(yaw / 2), np.cos(pitch / 2), np.sin(pitch / 2)
    return np.stack([cy * cp, -sy * sp, cy * sp, sy * cp], -1)  # yaw about z, then pitch


def _rows(fmt, t, yaw, pitch):
    q = _wxyz(yaw, pitch)
    cols = {
        "tsinghua": [t, 1.5e9 + t, q[:, 1], q[:, 2], q[:, 3], q[:, 0]],
        "quat_xyzw": [t, q[:, 1], q[:, 2], q[:, 3], q[:, 0]],
        "quat_wxyz": [t, q[:, 0], q[:, 1], q[:, 2], q[:, 3]],
        "euler_deg": [t, np.degrees(yaw), np.degrees(pitch), np.zeros_like(t)],
        "euler_rad": [t, yaw, pitch, np.zeros_like(t)],
    }[fmt]
    return np.column_stack(cols)


def write_dataset(root, fmt, users=3, videos=2, n=200, seed=0):
    """``root/userU/videoV`` logs of ``fmt`` (a FORMATS layout, or "json":
    AVtrack360 samples in degrees); a header row on the CSVs."""
    rng = np.random.default_rng(seed)
    for u in range(users):
        d = root / f"user{u}"
        d.mkdir(parents=True, exist_ok=True)
        for v in range(videos):
            t, yaw, pitch = _walk(rng, n)
            if fmt == "json":
                samples = [{"sec": float(a), "yaw": float(np.degrees(b)), "pitch": float(np.degrees(c)),
                            "roll": 0.0} for a, b, c in zip(t, yaw, pitch)]
                (d / f"video{v}.json").write_text(json.dumps({"data": samples}))
            else:
                np.savetxt(d / f"video{v}.csv", _rows(fmt, t, yaw, pitch), fmt="%.7f", delimiter=",",
                           header="t,a,b,c,d,e", comments="")
    return root


def _same_store(ours, ref):
    assert [(t.user, t.video, t.rate_hz, len(t)) for t in ours.traces] == \
        [(t.user, t.video, t.rate_hz, len(t)) for t in ref.traces]
    assert ours.videos() == ref.videos()
    for a, b in zip(ours.traces, ref.traces):
        assert a.xyz.dtype == b.xyz.dtype == np.float32
        np.testing.assert_allclose(a.xyz, b.xyz, rtol=0, atol=TOL)


LAYOUTS = sorted(jax_datasets.FORMATS) + ["json"]


@pytest.mark.parametrize("fmt", LAYOUTS)
@pytest.mark.parametrize("pinned", [False, True], ids=["sniffed", "pinned"])
def test_load_dataset_matches_jax(fmt, pinned, tmp_path):
    root = write_dataset(tmp_path, fmt, seed=LAYOUTS.index(fmt))
    arg = fmt if pinned and fmt != "json" else "auto"
    ours = datasets.load_dataset(str(root), arg, rate_hz=10.0)
    ref = jax_datasets.load_dataset(str(root), arg, rate_hz=10.0)
    assert len(ref) == 6
    _same_store(ours, ref)


@pytest.mark.parametrize("fmt", ["quat", "euler", "euler_deg", "auto"])
def test_load_trace_matches_jax(fmt, tmp_path):
    rng = np.random.default_rng(5)
    t, yaw, pitch = _walk(rng, 150)
    layout = {"quat": "quat_wxyz", "euler": "euler_rad", "euler_deg": "euler_deg", "auto": "quat_wxyz"}[fmt]
    path = tmp_path / "vid" / "viewer.csv"
    path.parent.mkdir()
    np.savetxt(path, _rows(layout, t, yaw, pitch), fmt="%.7f", header="# a comment", comments="")
    ours = traces.load_trace(str(path), rate_hz=10.0, fmt=fmt)
    ref = jax_traces.load_trace(str(path), rate_hz=10.0, fmt=fmt)
    assert (ours.user, ours.video, ours.rate_hz) == (ref.user, ref.video, ref.rate_hz) == ("viewer", "vid", 10.0)
    np.testing.assert_allclose(ours.xyz, ref.xyz, rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="unknown trace format"):
        traces.load_trace(str(path), fmt="yaw")


def _validation_cases(root):
    """Directories the strict validation must judge as JAX's does: clean
    layouts, and each failure tests/test_datasets.py names."""
    cases = {}
    for fmt in sorted(jax_datasets.FORMATS):
        cases[f"clean-{fmt}"] = (write_dataset(root / fmt, fmt, users=2, videos=1, n=120), "auto")
    d = root / "nonunit" / "user0"
    d.mkdir(parents=True)
    (d / "bad.csv").write_text("\n".join(f"{i * 0.1},1.5,0.0,0.0,0.1" for i in range(40)))
    cases["non-unit"] = (root / "nonunit", "quat_wxyz")
    d = root / "repeat" / "user0"
    d.mkdir(parents=True)
    (d / "vid.csv").write_text("\n".join(f"{i * 0.1 if i != 10 else 0.9},1,0,0,0" for i in range(40)))
    cases["repeated-time"] = (root / "repeat", "quat_wxyz")
    d = root / "order" / "user0"
    d.mkdir(parents=True)
    (d / "vid.csv").write_text("\n".join(f"{i * 0.1},0.5,0.5,0.5,0.5" for i in range(40)))
    cases["ambiguous-order"] = (root / "order", "auto")
    d = root / "units" / "user0"
    d.mkdir(parents=True)
    (d / "vid.csv").write_text("\n".join(f"{i * 0.1},{3.0 - 0.01 * i},0.3,0.0" for i in range(40)))
    cases["ambiguous-units"] = (root / "units", "auto")
    d = root / "gappy" / "user0"
    d.mkdir(parents=True)
    t = np.r_[np.arange(30) * 0.1, 10.0 + np.arange(30) * 0.1]
    (d / "vid.csv").write_text("\n".join(f"{a},{0.02 * i},0.1,0.0" for i, a in enumerate(t)))
    (d / "short.csv").write_text("0,1,0,0,0\n0.1,1,0,0,0\n")
    (d / "broken.json").write_text("{not json")
    cases["gappy-short-broken"] = (root / "gappy", "euler_rad")
    return cases


def test_validate_reports_match_jax(tmp_path):
    for name, (root, fmt) in _validation_cases(tmp_path).items():
        ours = datasets.validate_dataset(str(root), fmt, rate_hz=10.0)
        ref = jax_datasets.validate_dataset(str(root), fmt, rate_hz=10.0)
        assert (ours["ok"], ours["dir_warnings"]) == (ref["ok"], ref["dir_warnings"]), name
        assert len(ours["files"]) == len(ref["files"]) > 0
        for a, b in zip(ours["files"], ref["files"]):
            assert a == b, name  # path, fmt, rows, rate_hz, errors, warnings
            assert datasets.validate_file(a["path"], fmt, rate_hz=10.0) == \
                jax_datasets.validate_file(b["path"], fmt, rate_hz=10.0)


def _cli_out(main, argv, capsys):
    code = 0
    try:
        main(argv)
    except SystemExit as e:
        code = e.code
    return capsys.readouterr().out, code


@pytest.mark.parametrize("mode", ["preview", "preview-limit", "validate", "validate-failing", "validate-pinned"])
def test_inspect_traces_prints_what_jax_prints(mode, tmp_path, capsys):
    root = write_dataset(tmp_path / "logs", "tsinghua", users=2, videos=2, n=120)
    write_dataset(tmp_path / "logs", "euler_deg", users=1, videos=1, n=60, seed=9)  # user0/video0 as euler
    (tmp_path / "logs" / "user1" / "notes.txt").write_text("not a log\n")
    if mode == "validate-failing":
        (tmp_path / "logs" / "user0" / "flat.csv").write_text("\n".join("0.0,9,9,9,9" for _ in range(40)))
    argv = ["inspect-traces", "--traces", str(root)] + {
        "preview": [], "preview-limit": ["--limit", "2"], "validate": ["--validate"],
        "validate-failing": ["--validate"], "validate-pinned": ["--validate", "--dataset-format", "euler_deg",
                                                                "--rate", "5"],
    }[mode]
    ours = _cli_out(cli.main, argv, capsys)
    ref = _cli_out(jax_cli.main, argv, capsys)
    assert ours[0].splitlines() == ref[0].splitlines() and ours[1] == ref[1]
    if mode == "validate-failing":
        assert ours[1] == 2 and "VALIDATION FAILED" in ours[0]


def test_prepare_data_traces_matches_jax(tmp_path, capsys):
    """The npz of ``prepare-data --traces`` (K = 2 peer futures, stride 2)
    against JAX's: the same keys, shapes and masks, windows within 1e-6."""
    root = write_dataset(tmp_path / "logs", "tsinghua", users=3, videos=2, n=400)
    argv = ["prepare-data", "--traces", str(root), "--h-in", "10", "--h-out", "8", "--stride", "2",
            "--n-other-users", "2"]
    cli.main([*argv, "--out", str(tmp_path / "ours.npz")])
    jax_cli.main([*argv, "--out", str(tmp_path / "ref.npz")])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split("→")[0] == out[1].split("→")[0]  # the same window counts
    for name in ("", "_test"):
        with np.load(tmp_path / f"ours{name}.npz") as a, np.load(tmp_path / f"ref{name}.npz") as b:
            assert sorted(a.files) == sorted(b.files) == ["future", "other_future", "other_mask", "past"]
            np.testing.assert_array_equal(a["other_mask"], b["other_mask"])
            for k in ("past", "future", "other_future"):
                assert a[k].shape == b[k].shape and a[k].dtype == np.float32
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=TOL)


def test_prepare_data_without_parseable_traces_exits(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no parseable traces"):
        cli.main(["prepare-data", "--traces", str(tmp_path / "empty"), "--out", str(tmp_path / "w.npz")])


def test_jax_euler_path_is_the_port_euler_path():
    """``datasets._to_xyz`` of an euler layout goes through the libm float32
    twin of ``euler_to_xyz`` in both packages: bit-equal."""
    rng = np.random.default_rng(7)
    arr = np.column_stack([np.arange(50.0), rng.uniform(-180, 180, 50), rng.uniform(-80, 80, 50)])
    spec = datasets.FORMATS["euler_deg"]
    np.testing.assert_array_equal(datasets._to_xyz(arr, spec),
                                  np.asarray(jax_datasets._to_xyz(arr, jax_datasets.FORMATS["euler_deg"])))
