"""The port's ``export`` and ``predict`` against the JAX CLI's on the CPU:
the export npz (keys, shapes and bytes) both ways, ``predict``'s JSONL on
the same npz for ``lstm-xyz-10``, ``stacked-ss-crossuser`` (its K = 4 peers,
``--peers 2`` and ``--peer-group``, the gather tier) and ``transformer-30
--peer-group`` (the shared tier), the refusals, and the
f32 peer context's block chooser over every K the bf16 tier takes.

The JSONL rounds angles to 1e-3 degrees: pitch is held within 2e-3 degrees
(one unit of that rounding and the f32 gap); yaw through the great-circle
angle between the two predicted directions, because yaw alone is
ill-conditioned near the poles; the prefetch tiles equal but for tiles whose
centre sits within 5e-3 degrees of the field of view's edge."""

import json
import math
import threading

import jax
import numpy as np
import pytest
import torch

from longterm360fov_tpu import cli as jax_cli
from longterm360fov_tpu import config as jax_config
from longterm360fov_tpu import serving as jax_serving
from longterm360fov_tpu.models import get_family as jax_get_family
from longterm360fov_tpu_torch import cli, serving
from longterm360fov_tpu_torch import train as TR
from longterm360fov_tpu_torch.checkpoint import Checkpointer
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models import get_family
from longterm360fov_tpu_torch.ops import fused_lstm
from longterm360fov_tpu_torch.params import params_from_numpy

SMALL = ["--h-in", "10", "--h-out", "10"]
PITCH_TOL_DEG = 2e-3
ANGLE_TOL_DEG = 2e-3
EDGE_TOL_DEG = 5e-3


def _jax_params(preset, flags, seed=0):
    args = jax_cli._build_parser().parse_args(["export", "--preset", preset, "--ckpt-dir", "x", "--out", "y",
                                               *flags])
    cfg = jax_cli._preset_cfg(args)
    return cfg, jax_get_family(cfg.model_family).init(jax.random.PRNGKey(seed), cfg.model)


def _jax_export(params, path):
    flat = {k: np.asarray(v) for k, v in jax_serving.flat_param_items(params)}
    np.savez(path, **flat)
    return flat


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """{name: (npz path, flags)}: JAX-initialised params of each preset the
    predict tests run, written as the JAX ``export`` writes them."""
    root = tmp_path_factory.mktemp("npz")
    out = {}
    for name, preset, flags in (("lstm", "lstm-xyz-10", []), ("crossuser", "stacked-ss-crossuser", SMALL),
                                ("transformer", "transformer-30", SMALL)):
        _, params = _jax_params(preset, flags)
        path = str(root / f"{name}.npz")
        _jax_export(params, path)
        out[name] = (preset, path, flags)
    return out


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _xyz(yaw_deg, pitch_deg):
    y, p = np.radians(np.asarray(yaw_deg, np.float64)), np.radians(np.asarray(pitch_deg, np.float64))
    return np.stack([np.cos(p) * np.cos(y), np.cos(p) * np.sin(y), np.sin(p)], -1)


def _tile_edge_gap(row):
    """Per tile, the least distance (degrees) over the horizon between the
    row's predicted direction and the prefetch threshold of that tile."""
    rows, cols = (int(v) for v in row["grid"].split("x"))
    r = np.arange(rows) + 0.5
    c = np.arange(cols) + 0.5
    pitch = np.pi / 2 - r / rows * np.pi
    yaw = -np.pi + c / cols * 2 * np.pi
    yy, pp = np.meshgrid(yaw, pitch, indexing="xy")
    centers = _xyz(np.degrees(yy.reshape(-1)), np.degrees(pp.reshape(-1)))
    d = _xyz(row["yaw_deg"], row["pitch_deg"])
    ang = np.degrees(np.arccos(np.clip(d @ centers.T, -1.0, 1.0)))  # (T, M)
    thr = 45.0 + 0.5 * math.degrees(math.hypot(math.pi / rows, 2 * math.pi / cols))
    return np.abs(ang - thr).min(axis=0)


def _same_predictions(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for key in a:
            if key not in ("yaw_deg", "pitch_deg", "prefetch_tiles"):
                assert a[key] == b[key], key
        assert np.abs(np.subtract(a["pitch_deg"], b["pitch_deg"])).max() <= PITCH_TOL_DEG
        cos = np.clip((_xyz(a["yaw_deg"], a["pitch_deg"]) * _xyz(b["yaw_deg"], b["pitch_deg"])).sum(-1), -1, 1)
        assert np.degrees(np.arccos(cos)).max() <= ANGLE_TOL_DEG
        if "prefetch_tiles" in a:
            differ = set(a["prefetch_tiles"]) ^ set(b["prefetch_tiles"])
            gap = _tile_edge_gap(a)
            assert all(gap[t] < EDGE_TOL_DEG for t in differ), (differ, a["prefetch_tiles"])


@pytest.mark.parametrize("name,flags", [
    ("lstm", ["--tiles"]),
    ("lstm", ["--at-frame", "300", "--impl", "xla"]),
    ("crossuser", ["--tiles", "--at-frame", "400"]),
    ("crossuser", ["--peers", "2", "--at-frame", "400"]),
    ("crossuser", ["--peer-group", "--at-frame", "400", "--tiles"]),  # the gather tier
    ("transformer", ["--peer-group", "--at-frame", "200", "--tiles"]),
])
def test_predict_jsonl_equals_jax(exported, name, flags, tmp_path):
    preset, npz, shape = exported[name]
    argv = ["predict", "--preset", preset, "--params", npz, *shape, *flags]
    jax_cli.main([*argv, "--out", str(tmp_path / "jax.jsonl")])
    cli.main([*argv, "--out", str(tmp_path / "ours.jsonl"), "--device", "cpu"])
    ours, ref = _rows(tmp_path / "ours.jsonl"), _rows(tmp_path / "jax.jsonl")
    _same_predictions(ours, ref)
    if name == "crossuser":
        assert {r["peers_used"] for r in ours} <= ({0, 1, 2} if "2" in flags else set(range(5)))
        assert all(r["peers_used"] > 0 for r in ours)
    if name == "transformer":
        assert all(r["peers_used"] > 0 for r in ours)


def test_export_of_a_port_checkpoint_equals_jax_flat_items(tmp_path, capsys):
    """A port checkpoint whose params came from JAX: the port's ``export``
    writes JAX's flat_param_items, key for key, shape and bytes, and its
    message."""
    jcfg, jparams = _jax_params("stacked-ss-crossuser", SMALL, seed=3)
    cfg = get_preset("stacked-ss-crossuser", model_h_in=10, model_h_out=10)
    assert cfg.model_hash() == jcfg.model_hash()
    fam = get_family(cfg.model_family)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    fresh = TR.init_state(cfg, fam.init, TR.make_optimizer(cfg), device="cpu")
    ck = str(tmp_path / "ck")
    Checkpointer(ck, cfg).save(TR.TrainState(tparams, TR.make_optimizer(cfg).init(tparams), 7, fresh.rng))
    out = str(tmp_path / "ours.npz")
    cli.main(["export", "--preset", "stacked-ss-crossuser", *SMALL, "--ckpt-dir", ck, "--out", out])
    ref = {k: np.asarray(v) for k, v in jax_serving.flat_param_items(jparams)}
    msg = capsys.readouterr().out.strip()
    assert msg == f"exported {len(ref)} arrays ({sum(a.nbytes for a in ref.values()) / 1e6:.2f} MB) → {out}"
    with np.load(out) as got:
        assert list(got.files) == list(ref)
        for k, a in ref.items():
            assert got[k].shape == a.shape and got[k].dtype == a.dtype
            assert got[k].tobytes() == a.tobytes()
    # a directory without a checkpoint raises
    with pytest.raises(FileNotFoundError):
        cli.main(["export", "--preset", "stacked-ss-crossuser", *SMALL, "--ckpt-dir", str(tmp_path / "none"),
                  "--out", out])


def test_exported_npz_crosses_both_ways(exported, tmp_path):
    """A JAX-exported npz loads in the port bit for bit, and the port's
    export of those params loads in JAX's load_exported_params bit for bit."""
    preset, npz, flags = exported["transformer"]
    args = cli._build_parser().parse_args(["predict", "--preset", preset, "--params", npz, *flags])
    cfg = cli._preset_cfg(args)
    fam = get_family(cfg.model_family)
    ours = serving.load_exported_params(npz, cfg, fam, device="cpu")
    with np.load(npz) as z:
        for k, t in serving.flat_param_items(ours):
            assert t.numpy().tobytes() == z[k].tobytes()
    fresh = TR.init_state(cfg, fam.init, TR.make_optimizer(cfg), device="cpu")
    ck = str(tmp_path / "ck")
    Checkpointer(ck, cfg).save(TR.TrainState(ours, TR.make_optimizer(cfg).init(ours), 1, fresh.rng))
    out = str(tmp_path / "port.npz")
    cli.main(["export", "--preset", preset, *flags, "--ckpt-dir", ck, "--out", out])
    jcfg = jax_cli._preset_cfg(jax_cli._build_parser().parse_args(["export", "--preset", preset, "--ckpt-dir", ck,
                                                                   "--out", out, *flags]))
    back = jax_serving.load_exported_params(out, jcfg, jax_get_family(jcfg.model_family))
    with np.load(npz) as z:
        for k, leaf in jax_serving.flat_param_items(back):
            assert np.asarray(leaf).tobytes() == z[k].tobytes()


@pytest.mark.parametrize("argv", [
    ["--preset", "lstm-xyz-10", "--peer-group", "--at-frame", "200"],
    ["--preset", "transformer-30", "--peer-group"],
    ["--preset", "transformer-30", "--peer-group", "--at-frame", "200", "--peers", "0"],
    ["--preset", "lstm-xyz-10", "--at-frame", "5"],
])
def test_predict_refusals_match_jax(exported, argv):
    _, npz, _ = exported["lstm"]
    with pytest.raises(SystemExit) as ref:
        jax_cli.main(["predict", "--params", npz, *argv])
    with pytest.raises(SystemExit) as ours:
        cli.main(["predict", "--params", npz, *argv, "--device", "cpu"])
    assert str(ours.value) == str(ref.value)


def test_predict_traces_names_its_slice(exported, tmp_path):
    """predict --traces (slice C-3, ported): on a directory of quaternion
    logs of two viewers of one video, the port's rows equal JAX's, K = 1
    peer each; on a directory with no log both refuse alike."""
    preset, npz, flags = exported["crossuser"]
    rng = np.random.default_rng(8)
    for u in range(2):
        (tmp_path / "logs" / f"user{u}").mkdir(parents=True)
        t = np.arange(300) / 30.0 + rng.uniform(-0.003, 0.003, 300)
        yaw = np.cumsum(rng.normal(0, 0.02, 300))
        np.savetxt(tmp_path / "logs" / f"user{u}" / "video0.csv",
                   np.column_stack([t, np.cos(yaw / 2), 0 * t, 0 * t, np.sin(yaw / 2)]), fmt="%.7f", delimiter=",")
    argv = ["predict", "--preset", preset, "--params", npz, *flags, "--traces", str(tmp_path / "logs"),
            "--at-frame", "50", "--tiles"]
    jax_cli.main([*argv, "--out", str(tmp_path / "jax.jsonl")])
    cli.main([*argv, "--out", str(tmp_path / "ours.jsonl"), "--device", "cpu"])
    ours = _rows(tmp_path / "ours.jsonl")
    _same_predictions(ours, _rows(tmp_path / "jax.jsonl"))
    assert [(r["user"], r["video"], r["peers_used"]) for r in ours] == [("user0", "video0", 1), ("user1", "video0", 1)]
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit) as ref:
        jax_cli.main(["predict", "--preset", "lstm-xyz-10", "--params", exported["lstm"][1], "--traces",
                      str(tmp_path / "empty")])
    with pytest.raises(SystemExit) as got:
        cli.main(["predict", "--preset", "lstm-xyz-10", "--params", exported["lstm"][1], "--traces",
                  str(tmp_path / "empty"), "--device", "cpu"])
    assert str(got.value) == str(ref.value) == "no trace long enough for a full input window"


@pytest.mark.parametrize("cmd,extra", [
    ("predict", ["--params", "p.npz"]), ("serve-daemon", ["--params", "p.npz"]), ("serve-bench", []),
    ("train", []), ("eval", ["--ckpt-dir", "ck"]), ("extract-features", ["--frames-dir", "d", "--out", "o"]),
])
def test_computing_subcommands_default_to_the_card(cmd, extra):
    argv = [cmd, *extra] + ([] if cmd in ("serve-bench", "extract-features") else ["--preset", "lstm-xyz-10"])
    assert cli._build_parser().parse_args(argv).device == "cuda"


@pytest.mark.skipif("torch.cuda.is_available()", reason="checks the no-card case")
def test_predict_and_daemon_refuse_the_default_device_without_a_card(exported):
    _, npz, _ = exported["lstm"]
    for cmd in ("predict", "serve-daemon"):
        with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
            cli.main([cmd, "--preset", "lstm-xyz-10", "--params", npz])


def test_serve_daemon_refuses_what_is_not_ported_and_bad_warmups(exported, monkeypatch, capsys):
    """--data-parallel is ported (slice P-1): on --device cpu the mesh is the
    one CPU device, so the batcher's divisor is 1, and the daemon answers;
    bad --grouped-warmup values exit with JAX's message."""
    _, npz, _ = exported["lstm"]
    base = ["serve-daemon", "--preset", "lstm-xyz-10", "--params", npz, "--device", "cpu"]
    seen = {}
    serve_forever = serving.FovServer.serve_forever

    def serve_and_ask(server, *a, **k):
        def ask():
            c = serving.FovClient(*server.server_address, timeout=60.0)
            seen["reply"], seen["divisor"] = c.predict([[1.0, 0.0, 0.0]] * 10), server.batcher.divisor
            c.close()
            server.shutdown()

        threading.Thread(target=ask, daemon=True).start()
        serve_forever(server, *a, **k)

    monkeypatch.setattr(serving.FovServer, "serve_forever", serve_and_ask)
    cli.main([*base, "--data-parallel", "--port", "0", "--max-batch", "4"])
    assert json.loads(capsys.readouterr().out.splitlines()[0])["max_batch"] == 4
    assert seen["divisor"] == 1 and len(seen["reply"]["yaw"]) == 10
    with pytest.raises(SystemExit) as ours:
        cli.main([*base, "--grouped-warmup", "8x0"])
    with pytest.raises(SystemExit) as ref:
        jax_cli.main(["serve-daemon", "--preset", "lstm-xyz-10", "--params", npz, "--grouped-warmup", "8x0"])
    assert str(ours.value) == str(ref.value)


def test_peer_tf32_rows_takes_k_1_to_256():
    """The f32 peer context takes every K the bf16 tier takes (1..256) at
    the presets' C = 128, and refuses past it by a ValueError that names
    the shape."""
    for k in range(1, 257):
        geo = fused_lstm.peer_tf32_rows(128, k, 3)
        assert geo.rows_v * k <= geo.rp <= 256 and geo.smem <= fused_lstm._SMEM_LIMIT
        assert fused_lstm.peer_tc_rows(128, k, 3).rows_v >= 1
    with pytest.raises(ValueError, match="K = 257 peers is more than it takes"):
        fused_lstm.peer_tf32_rows(128, 257, 3)


def test_jax_presets_and_port_presets_agree_on_the_predict_shapes():
    for preset, flags in (("lstm-xyz-10", []), ("stacked-ss-crossuser", SMALL), ("transformer-30", SMALL)):
        ours = cli._preset_cfg(cli._build_parser().parse_args(["predict", "--preset", preset, "--params", "p",
                                                               *flags, "--peers", "3"]))
        ref = jax_cli._preset_cfg(jax_cli._build_parser().parse_args(["predict", "--preset", preset, "--params",
                                                                      "p", *flags, "--peers", "3"]))
        assert (ours.model_hash(), ours.n_other_users) == (ref.model_hash(), ref.n_other_users)
        assert isinstance(ref, jax_config.ExperimentConfig)


@pytest.mark.parametrize("preset,impl", [("lstm-xyz-10", "plain"), ("lstm-xyz-10", "fused"),
                                         ("stacked-ss-crossuser", "plain"), ("stacked-ss-crossuser", "fused")])
def test_predict_batch_and_euler_equal_jax(preset, impl):
    """``infer.predict_batch`` and ``predict_euler`` against JAX's on the
    same weights and windows (the cross_user peers through the family's
    ``batch_extras``), in both of the port's impls."""
    from longterm360fov_tpu import infer as jax_infer
    from longterm360fov_tpu_torch import infer

    flags = SMALL if preset != "lstm-xyz-10" else []
    jcfg, jparams = _jax_params(preset, flags, seed=4)
    cfg = cli._preset_cfg(cli._build_parser().parse_args(["predict", "--preset", preset, "--params", "p", *flags]))
    jfam, fam = jax_get_family(jcfg.model_family), get_family(cfg.model_family)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(4)
    past = rng.normal(size=(6, cfg.model.h_in, 3)).astype(np.float32)
    past /= np.linalg.norm(past, axis=-1, keepdims=True)
    batch = {"past": past}
    if cfg.model_family == "cross_user":
        fut = rng.normal(size=(6, cfg.n_other_users, cfg.model.h_out, 3)).astype(np.float32)
        batch.update(other_future=fut / np.linalg.norm(fut, axis=-1, keepdims=True),
                     other_mask=(rng.random((6, cfg.n_other_users)) < 0.7).astype(np.float32))
    extras, jextras = getattr(fam, "batch_extras", None), getattr(jfam, "batch_extras", None)
    ref = np.asarray(jax_infer.predict_batch(jparams, jcfg, jfam.apply, dict(batch), None, jextras))
    got = infer.predict_batch(tparams, cfg, fam.apply, dict(batch), None, extras, impl=impl)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    jyaw, jpitch = jax_infer.predict_euler(jparams, jcfg, jfam.apply, dict(batch), None, jextras)
    yaw, pitch = infer.predict_euler(tparams, cfg, fam.apply, dict(batch), None, extras, impl=impl)
    np.testing.assert_allclose(pitch.numpy(), np.asarray(jpitch), atol=1e-5)
    gap = np.abs(np.angle(np.exp(1j * (yaw.numpy().astype(np.float64) - np.asarray(jyaw, np.float64)))))
    assert gap.max() <= 1e-4  # yaw, compared modulo 2π
