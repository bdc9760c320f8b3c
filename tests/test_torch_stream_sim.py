"""The simulations of the port against the JAX package: ``infer.stream_simulation``
on the same params and viewers (seq2seq, and cross_user with K = 0 and
K = 2 peers), its refusals, and the ``stream-sim`` and ``serve`` subcommands
end to end, each side on its own checkpoint of the same params (orbax for
JAX, ``state.pt`` for the port).

Hit rates are counts over viewers x ticks (or windows x horizon) rounded to
4 places: the two sides may be one hit apart per deadline, 1 / count plus
the rounding (every reading so far was equal). Tiles per frame are equal at
their rounding to 2 places."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import jax
import numpy as np
import pytest
import torch

from longterm360fov_tpu import checkpoint as jax_checkpoint
from longterm360fov_tpu import cli as jax_cli
from longterm360fov_tpu import infer as jax_infer
from longterm360fov_tpu import train as jax_train
from longterm360fov_tpu import traces as jax_traces
from longterm360fov_tpu.config import get_preset as jax_get_preset
from longterm360fov_tpu.models import get_family as jax_get_family
from longterm360fov_tpu_torch import cli, infer
from longterm360fov_tpu_torch import train as TR
from longterm360fov_tpu_torch.checkpoint import Checkpointer
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models import get_family
from longterm360fov_tpu_torch.params import params_from_numpy

ROUNDING = 1e-4  # the rates' rounding to 4 places
SMALL = dict(model_h_in=10, model_h_out=10, model_hidden=32)


def _viewers(n_users=5, n_frames=120, seed=1):
    store = jax_traces.synthetic_store(n_users=n_users, n_videos=1, n_frames=n_frames, seed=seed)
    return [t.xyz for t in store.traces]


def _same_sim(ours, ref):
    assert (ours["viewers"], ours["ticks"]) == (ref["viewers"], ref["ticks"])
    assert ours["hit_rate_by_deadline"].keys() == ref["hit_rate_by_deadline"].keys()
    tol = 1.0 / (ref["viewers"] * ref["ticks"]) + ROUNDING
    for dl, rate in ref["hit_rate_by_deadline"].items():
        assert abs(ours["hit_rate_by_deadline"][dl] - rate) <= tol, (dl, ours, ref)
    assert ours["mean_tiles_per_frame"] == ref["mean_tiles_per_frame"]
    assert ours["predictions_per_sec"] > 0


@pytest.mark.parametrize("preset,k", [("seq2seq-tf-30", 0), ("stacked-ss-crossuser", 0),
                                      ("stacked-ss-crossuser", 2)])
def test_stream_simulation_matches_jax(preset, k):
    jcfg = jax_get_preset(preset, **SMALL)
    fam = jax_get_family(jcfg.model_family)
    jparams = fam.init(jax.random.PRNGKey(3), jcfg.model)
    xyz = _viewers()
    kw = dict(deadlines=(1, 4, 10), n_peers=k, fov_deg=80.0, tile_rows=5, tile_cols=10)
    ref = jax_infer.stream_simulation(jparams, jcfg, fam.apply, xyz, extras_fn=getattr(fam, "batch_extras", None),
                                      **kw)
    cfg = get_preset(preset, **SMALL)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    for impl in ("fused", "plain"):
        ours = infer.stream_simulation(params, cfg, xyz, device="cpu", impl=impl, **kw)
        _same_sim(ours, ref)
    # with peers the horizon sets the ticks: 120 - max(10, h_out) - h_in
    assert ours["ticks"] == 100 and ours["viewers"] == 5


def test_stream_counts_add_up_over_tick_ranges():
    """The simulation's raw counts over two cuts of the traces (ticks
    [h_in, m) and [m, end)) add up to the whole run's, and its rates are
    those counts rounded: what a reference split over processes relies
    on."""
    cfg = get_preset("stacked-ss-crossuser", **SMALL)
    params = get_family(cfg.model_family).init(torch.Generator().manual_seed(5), cfg.model, device="cpu")
    xyz = np.stack(_viewers(n_frames=90, seed=3))
    kw = dict(device="cpu", deadlines=(1, 4, 10), tile_rows=6, tile_cols=12, fov_deg=90.0, impl="fused", n_peers=2)
    hits, tiles, n_view, n_ticks, _ = infer._stream_counts(params, cfg, list(xyz), **kw)
    h_in, ahead, mid = 10, 10, 40  # ticks [10, 40) and [40, 70)
    first = infer._stream_counts(params, cfg, list(xyz[:, :mid + ahead]), **kw)
    second = infer._stream_counts(params, cfg, list(xyz[:, mid - h_in:]), **kw)
    assert (n_view, n_ticks, first[3], second[3]) == (5, 70, 30, 40)
    np.testing.assert_array_equal(first[0] + second[0], hits)
    assert first[1] + second[1] == pytest.approx(tiles, rel=1e-6)
    res = infer.stream_simulation(params, cfg, list(xyz), **{k: v for k, v in kw.items()})
    assert res["hit_rate_by_deadline"] == {str(d): round(int(h) / (n_view * n_ticks), 4)
                                           for d, h in zip((1, 4, 10), hits)}
    assert res["mean_tiles_per_frame"] == round(tiles / n_ticks, 2)


def test_stream_simulation_refusals():
    cfg = get_preset("stacked-ss-crossuser", **SMALL)
    params = get_family(cfg.model_family).init(torch.Generator().manual_seed(0), cfg.model, device="cpu")
    jcfg = jax_get_preset("stacked-ss-crossuser", **SMALL)
    jfam = jax_get_family(jcfg.model_family)
    jparams = jfam.init(jax.random.PRNGKey(0), jcfg.model)
    cases = [(_viewers(n_users=2), dict(n_peers=2), "n_peers 2 needs at least 3 viewers"),
             (_viewers(n_frames=30), dict(), "traces too short: 30 frames < h_in 10 \\+ max deadline 30 \\+ 1")]
    for xyz, kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            infer.stream_simulation(params, cfg, xyz, device="cpu", **kw)
        with pytest.raises(ValueError, match=msg):
            jax_infer.stream_simulation(jparams, jcfg, jfam.apply, xyz, extras_fn=jfam.batch_extras, **kw)
    with pytest.raises(ValueError, match="impl must be one of"):
        infer.stream_simulation(params, cfg, _viewers(), device="cpu", impl="xla")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One set of params of ``stacked-ss-crossuser`` at --h-in/--h-out 10 in
    a JAX (orbax) checkpoint and in a port checkpoint; a trace directory of
    one video's 5 viewers (120 frames at 10 Hz, quaternion logs); the npz of
    ``prepare-data`` at the same windows."""
    root = tmp_path_factory.mktemp("sim")
    preset = "stacked-ss-crossuser"
    jcfg = jax_get_preset(preset, model_h_in=10, model_h_out=10)
    jfam = jax_get_family(jcfg.model_family)
    jstate = jax_train.init_state(jcfg, jfam.init, jax_train.make_optimizer(jcfg), jax.random.PRNGKey(4))
    jax_checkpoint.Checkpointer(str(root / "jax_ck"), jcfg).save(jstate)
    cfg = get_preset(preset, model_h_in=10, model_h_out=10)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu")
    opt = TR.make_optimizer(cfg)
    fresh = TR.init_state(cfg, get_family(cfg.model_family).init, opt, device="cpu")
    Checkpointer(str(root / "port_ck"), cfg).save(TR.TrainState(params, opt.init(params), 1, fresh.rng))
    logs = root / "logs"
    for u, xyz in enumerate(_viewers(n_users=5, n_frames=120, seed=2)):
        (logs / f"user{u}").mkdir(parents=True)
        yaw, pitch = np.arctan2(xyz[:, 1], xyz[:, 0]), np.arcsin(np.clip(xyz[:, 2], -1, 1))
        cy, sy, cp, sp = np.cos(yaw / 2), np.sin(yaw / 2), np.cos(pitch / 2), np.sin(pitch / 2)
        t = np.arange(len(xyz)) / 10.0
        np.savetxt(logs / f"user{u}" / "video0.csv", np.column_stack([t, cy * cp, -sy * sp, cy * sp, sy * cp]),
                   fmt="%.8f", delimiter=",")
    npz = str(root / "win.npz")
    cli.main(["prepare-data", "--traces", str(logs), "--out", npz, "--h-in", "10", "--h-out", "10"])
    return {"preset": preset, "jax": str(root / "jax_ck"), "port": str(root / "port_ck"), "logs": str(logs),
            "npz": npz}


def _json(main, argv, capsys):
    import json

    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("peers", [[], ["--peers", "2"], ["--peers", "0"]], ids=["preset-k", "k2", "k0"])
def test_stream_sim_cli_matches_jax(checkpoints, peers, capsys):
    c = checkpoints
    argv = ["stream-sim", "--preset", c["preset"], "--h-in", "10", "--h-out", "10", "--traces", c["logs"],
            "--deadlines", "1,5,10", *peers]
    ref = _json(jax_cli.main, [*argv, "--ckpt-dir", c["jax"]], capsys)
    ours = _json(cli.main, [*argv, "--ckpt-dir", c["port"], "--device", "cpu"], capsys)
    _same_sim(ours, ref)
    # 119 frames (120 log rows 0.1 s apart resample to [0, 11.9)) - h_in 10 - the largest deadline 10 (and with
    # peers the horizon 10); --peers -1 takes the preset's K = 4, the most that 5 viewers allow
    assert (ours["viewers"], ours["ticks"]) == (5, 99)


def test_stream_sim_cli_defaults_to_the_kernels():
    parse = cli._build_parser().parse_args
    args = parse(["stream-sim", "--preset", "seq2seq-tf-30", "--ckpt-dir", "ck"])
    assert (args.impl, args.device, args.peers, args.deadlines) == ("fused", "cuda", -1, "1,10,30")
    assert jax_cli._build_parser().parse_args(["stream-sim", "--preset", "p", "--ckpt-dir", "c"]).impl == "xla"


def test_serve_cli_matches_jax(checkpoints, capsys):
    """``serve``'s JSON: the model's and the hold-last baseline's hit rate
    and tiles per frame on the test split, against JAX's; the port serves
    through the fused route (plain versions on the CPU), JAX through XLA."""
    c = checkpoints
    argv = ["serve", "--preset", c["preset"], "--h-in", "10", "--h-out", "10", "--data", c["npz"], "--fov", "80",
            "--tile-rows", "5", "--tile-cols", "10"]
    ref = _json(jax_cli.main, [*argv, "--ckpt-dir", c["jax"]], capsys)
    ours = _json(cli.main, [*argv, "--ckpt-dir", c["port"], "--device", "cpu"], capsys)
    assert ours.keys() == ref.keys()
    frames = ref["n_windows"] * ref["horizon"]
    for k in ("model_hit_rate", "persistence_hit_rate"):
        assert abs(ours[k] - ref[k]) <= 1.0 / frames + ROUNDING, (k, ours, ref)
    for k in ("model_tiles_per_frame", "persistence_tiles_per_frame", "n_windows", "horizon", "grid", "fov_deg"):
        assert ours[k] == ref[k], k
    assert ref["n_windows"] > 0 and ref["grid"] == "5x10"
