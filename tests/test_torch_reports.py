"""The reports of the port against the JAX package: ``utils.flops`` (the same
count for every preset), ``utils.profiling`` (the TensorBoard scalars read
back with tensorboard's ``EventAccumulator``: the same tags, steps and
values as JAX's ``tf.summary`` stream; the JSONL stream, the step timer, the
device trace, the anomaly scope), ``plots`` (both packages write each
figure), and ``eval --plot`` and ``train --tb-dir`` end to end, with the
messages that name matplotlib and tensorboard where they are absent."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from longterm360fov_tpu import plots as jax_plots
from longterm360fov_tpu.config import PRESETS as JAX_PRESETS
from longterm360fov_tpu.utils import flops as jax_flops
from longterm360fov_tpu.utils import profiling as jax_profiling
from longterm360fov_tpu_torch import cli, plots
from longterm360fov_tpu_torch.config import PRESETS
from longterm360fov_tpu_torch.utils import flops, profiling

FLOP_FNS = ("lstm_decode_flops", "lstm_train_flops", "transformer_decode_flops", "decode_flops", "train_flops")


@pytest.mark.parametrize("preset", sorted(JAX_PRESETS))
def test_flops_equal_jax_for_every_preset(preset):
    assert sorted(PRESETS) == sorted(JAX_PRESETS) and len(PRESETS) == 7
    for name in FLOP_FNS:
        ours, ref = getattr(flops, name)(PRESETS[preset]), getattr(jax_flops, name)(JAX_PRESETS[preset])
        assert ours == ref and ours > 0, name
    for peers in (0, 7):  # the peer work counts as JAX counts it
        over = PRESETS[preset].replace(n_other_users=peers)
        assert flops.decode_flops(over) == jax_flops.decode_flops(JAX_PRESETS[preset].replace(n_other_users=peers))
    assert flops.H100_BF16_PEAK == 989e12 and not hasattr(flops, "V5E_BF16_PEAK")


def _scalars(log_dir):
    """{tag: [(step, value)]} of the event files under ``log_dir``, read
    with tensorboard's plugin EventAccumulator, which gives ``tf.summary``'s
    tensor scalars and ``SummaryWriter``'s simple values alike as tensors."""
    from tensorboard.backend.event_processing.plugin_event_accumulator import EventAccumulator
    from tensorboard.util import tensor_util

    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, float(tensor_util.make_ndarray(e.tensor_proto))) for e in acc.Tensors(tag)]
            for tag in acc.Tags()["tensors"]}


def test_tensorboard_scalars_equal_jax(tmp_path):
    pytest.importorskip("tensorflow")  # JAX's writer is tf.summary's
    rows = [dict(step=1, loss=0.5, great_circle_deg=12.25, skipme="str"), dict(step=2, loss=0.25),
            dict(step=5, loss=0.125, steps_per_sec=3.0)]
    for writer, d in ((jax_profiling.TensorBoardWriter, tmp_path / "jax"), (profiling.TensorBoardWriter,
                                                                            tmp_path / "port")):
        with writer(str(d)) as tb:
            for r in rows:
                tb.write(**r)
            tb.write(7, loss=0.0625)  # the step as an argument
    ours, ref = _scalars(str(tmp_path / "port")), _scalars(str(tmp_path / "jax"))
    assert ours == ref
    assert ref["loss"] == [(1, 0.5), (2, 0.25), (5, 0.125), (7, 0.0625)] and "skipme" not in ref


def test_jsonl_stream_and_step_timer(tmp_path):
    import time

    for mod in (profiling, jax_profiling):
        p = str(tmp_path / f"{mod.__name__}.jsonl")
        with mod.MetricsWriter(p) as w:
            w.write(step=1, loss=0.5)
            w.write(step=2, loss=0.25, extra="x")
        assert [json.loads(line) for line in open(p)] == [{"step": 1, "loss": 0.5},
                                                          {"step": 2, "loss": 0.25, "extra": "x"}]
    t = profiling.StepTimer(items_per_step=32)
    assert t.steps_per_sec == 0.0
    t.tick()  # the warm-up step is not counted
    for _ in range(3):
        time.sleep(0.01)
        t.tick()
    assert t.steps == 3 and 0 < t.steps_per_sec < 1000
    assert t.items_per_sec == pytest.approx(32 * t.steps_per_sec, rel=0.2)


def test_profile_trace_writes_a_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.profile_trace(d, cuda=False) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum().item()
    assert any(n.endswith(".pt.trace.json") for n in os.listdir(d))
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_debug_nans_raises_in_the_backward_only():
    w = torch.tensor([-1.0], requires_grad=True)
    with profiling.debug_nans(True):
        assert torch.is_anomaly_enabled()
        y = torch.sqrt(w)  # a NaN in the forward passes unnoticed: the scope sees the backward
        with pytest.raises(RuntimeError, match="nan"):
            y.sum().backward()
    assert not torch.is_anomaly_enabled()


def test_both_packages_write_every_plot(tmp_path):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3, 30, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    history = [{"step": i, "loss": 1.0 / i} for i in range(1, 6)]
    for mod, tag in ((plots, "port"), (jax_plots, "jax")):
        paths = [mod.plot_error_by_step({"a": np.linspace(1, 9, 30), "b": np.linspace(2, 5, 30)},
                                        str(tmp_path / f"{tag}_curve.png"), rate_hz=10.0),
                 mod.plot_trajectory(v[0, :10], v[1], v[2], str(tmp_path / f"{tag}_traj.png")),
                 mod.plot_training_curve(history, str(tmp_path / f"{tag}_train.png"))]
        for p in paths:
            with open(p, "rb") as f:
                assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plots_without_matplotlib_name_it(monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises ImportError
    with pytest.raises(ImportError, match="matplotlib"):
        plots.plot_training_curve([{"step": 1, "loss": 1.0}], "never.png")
    with pytest.raises(SystemExit, match="eval --plot: the plots need the matplotlib package"):
        cli.main(["eval", "--preset", "seq2seq-tf-30", "--ckpt-dir", "no-such-dir", "--device", "cpu", "--plot",
                  "p"])  # refused before the checkpoint is opened


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two CPU steps of ``seq2seq-tf-30`` at --h-in/--h-out 10 on a small
    store, with --tb-dir and --log-file."""
    root = tmp_path_factory.mktemp("reports")
    win = str(root / "win.npz")
    cli.main(["prepare-data", "--out", win, "--h-in", "10", "--h-out", "10", "--n-users", "2", "--n-videos", "1",
              "--n-frames", "200"])
    run = ["--preset", "seq2seq-tf-30", "--h-in", "10", "--h-out", "10", "--data", win, "--device", "cpu",
           "--ckpt-dir", str(root / "ck")]
    cli.main(["train", *run, "--steps", "2", "--batch-size", "16", "--tb-dir", str(root / "tb"), "--log-file",
              str(root / "log.jsonl")])
    return root, run


def test_train_tb_dir_writes_the_logged_metrics(trained):
    pytest.importorskip("tensorboard")
    root, _ = trained
    logged = [json.loads(line) for line in open(root / "log.jsonl")]
    scalars = _scalars(str(root / "tb"))
    assert glob.glob(str(root / "tb" / "events.out.tfevents.*"))
    for key in ("loss", "great_circle_deg", "eval_great_circle_deg", "steps_per_sec"):
        assert scalars[key] == [(m["step"], pytest.approx(m[key], rel=1e-6)) for m in logged], key


def test_eval_plot_writes_both_figures(trained, capsys):
    root, run = trained
    prefix = str(root / "plot")
    cli.main(["eval", *run, "--json", "--plot", prefix])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(res["error_by_step_deg"]) == 10
    for kind in ("curve", "traj"):
        assert os.path.getsize(f"{prefix}_{kind}.png") > 1000


def test_eval_plot_series_matches_jax(trained):
    """What ``eval --plot`` draws: the persistence curve equal to JAX's
    ``baselines.persistence`` through its ``evaluate_predictions``, the
    model's curve the one ``evaluate`` returned, and the first window's
    prediction the plain forward's."""
    import jax.numpy as jnp

    from longterm360fov_tpu import baselines as jax_baselines
    from longterm360fov_tpu import evaluate as jax_evaluate
    from longterm360fov_tpu_torch import evaluate, infer
    from longterm360fov_tpu_torch.models import get_family

    root, run = trained
    args = cli._build_parser().parse_args(["eval", *run])
    cfg = cli._preset_cfg(args)
    fam = get_family(cfg.model_family)
    params = cli._serving_params(args, cfg, fam, "cpu")
    _, test_d = cli._load_or_synth_data(args, cfg)
    res = evaluate.evaluate(params, cfg, test_d, impl="fused")
    curves, pred = cli.eval_plot_series(params, cfg, test_d, res, "cpu")
    ref = jax_evaluate.evaluate_predictions(
        np.asarray(jax_baselines.persistence(jnp.asarray(test_d["past"]), cfg.model.h_out)), test_d["future"])
    assert list(curves) == [cfg.name, "persistence"] and curves[cfg.name] is res["error_by_step_deg"]
    # f32 degrees summed in another order: within a few ulps (2.1e-7 relative read)
    np.testing.assert_allclose(curves["persistence"], ref["error_by_step_deg"], rtol=1e-6, atol=0)
    plain = infer.predict_batch(params, cfg, fam.apply, {k: v[:1] for k, v in test_d.items() if k != "future"},
                                impl="plain")
    assert pred.shape == (cfg.model.h_out, 3)
    np.testing.assert_allclose(pred, plain[0].numpy(), rtol=0, atol=1e-5)


def test_train_tb_dir_without_tensorboard_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(SystemExit, match="train --tb-dir needs the tensorboard package"):
        cli.main(["train", "--preset", "seq2seq-tf-30", "--steps", "1", "--device", "cpu", "--tb-dir",
                  str(tmp_path / "tb")])
    assert not (tmp_path / "tb").exists()
    with pytest.raises(ImportError, match="tensorboard package"):
        profiling.TensorBoardWriter(str(tmp_path / "tb"))
