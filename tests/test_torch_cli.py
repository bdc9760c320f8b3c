"""The port's command line: ``presets`` and ``serve-bench``, its device on the
card by default; the transformer-30 rehearsal; ``train --seq-parallel`` and
``--pipeline-parallel`` against JAX's CLI (its messages and rounding lines
for the same argv) on 8 CPU entries."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import json

import jax
import numpy as np
import pytest
import torch

from longterm360fov_tpu import cli as jax_cli
from longterm360fov_tpu_torch import cli


def test_presets_lists_what_jax_lists(capsys):
    jax_cli.main(["presets"])
    ref = capsys.readouterr().out
    cli.main(["presets"])
    assert capsys.readouterr().out == ref


@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_serve_bench_on_cpu_is_labelled_cpu(impl, capsys):
    cli.main(["serve-bench", "--batch", "8", "--iters", "1", "--impl", impl,
              "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["impl"] == impl and res["batch"] == 8 and res["horizon"] == 30
    assert res["timer"] == "host clock" and res["device"] == {"kind": "cpu"}
    assert res["viewers_per_sec"] > 0


def test_serve_bench_defaults_to_the_card():
    assert cli._build_parser().parse_args(["serve-bench"]).device == "cuda"


@pytest.mark.skipif("torch.cuda.is_available()", reason="checks the no-card case")
def test_serve_bench_on_the_default_device_raises_without_a_card():
    with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
        cli.main(["serve-bench", "--batch", "8", "--iters", "1"])


@pytest.mark.skipif("torch.cuda.is_available()", reason="checks the no-card case")
def test_serve_bench_refuses_cuda_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.serve_bench(batch=8, iters=1, impl="fused", device="cuda")


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_transformer_30_train_eval_serve_bench_on_cpu(tmp_path, capsys):
    """A CPU rehearsal of the transformer-30 commands: train (K = 4 peers on
    the synthetic store, noisy teacher forcing), resume, eval, serve-bench."""
    ck, win = str(tmp_path / "ck"), str(tmp_path / "win.npz")
    # a small synthetic store (2 users of one video: K = 1 real peer, the rest masked)
    cli.main(["prepare-data", "--out", win, "--n-users", "2", "--n-videos", "1", "--n-frames", "400",
              "--n-other-users", "4"])
    run = ["--preset", "transformer-30", "--data", win, "--device", "cpu", "--ckpt-dir", ck]
    cli.main(["train", *run, "--steps", "2", "--batch-size", "8"])
    res = _last_json(capsys.readouterr().out)
    assert res["step"] == 2 and res["teacher_prob"] < 1.0 and "eval_great_circle_deg" in res
    cli.main(["train", *run, "--steps", "3", "--batch-size", "8", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and _last_json(out)["step"] == 3
    cli.main(["eval", *run, "--json"])
    assert len(_last_json(capsys.readouterr().out)["error_by_step_deg"]) == 30
    for impl in ("fused", "xla"):
        cli.main(["serve-bench", "--preset", "transformer-30", "--batch", "8", "--iters", "1", "--impl", impl,
                  "--device", "cpu"])
        res = _last_json(capsys.readouterr().out)
        assert res["peers"] == 4 and res["horizon"] == 30 and res["viewers_per_sec"] > 0


@pytest.mark.parametrize("flag", [["--seq-parallel", "2"], ["--pipeline-parallel", "2"]])
def test_transformer_parallel_flags_need_more_than_one_device(flag):
    """On one device (the CPU's; the one card's likewise) --seq-parallel 2
    and --pipeline-parallel 2 exit with the message JAX gives on one chip."""
    from longterm360fov_tpu.parallel import pp as jax_pp, sp as jax_sp

    one = jax.devices()[:1]
    ref = (jax_sp.make_sp_mesh, jax_pp.make_pp_mesh)[flag[0] == "--pipeline-parallel"]
    with pytest.raises(ValueError) as jax_err:
        ref(2, devices=one)
    with pytest.raises(SystemExit) as ours:
        cli.main(["train", "--preset", "transformer-30", "--device", "cpu", *flag])
    assert str(ours.value) == str(jax_err.value) == (
        "need 2 devices for dp=1 x sp=2, have 1" if flag[0] == "--seq-parallel" else "need 2 devices for pp=2, have 1")


def test_transformer_bench_params_match_init_limits():
    """serve-bench's transformer weights: the seeded init, with its
    Glorot-uniform limits, zero biases and LN scale 1."""
    from longterm360fov_tpu_torch.config import get_preset
    from longterm360fov_tpu_torch.models import transformer
    from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves

    cfg = get_preset("transformer-30")
    tree = params_from_numpy(cli.bench_params_np(cfg, 0), "cpu")
    ref = transformer.init(torch.Generator().manual_seed(0), cfg.model, device="cpu")
    for a, b in zip(tree_leaves(tree), tree_leaves(ref), strict=True):
        assert torch.equal(a, b)
    w1 = tree["enc"][0]["mlp"]["w1"]
    assert 0.9 * (6.0 / (128 + 512)) ** 0.5 <= w1.abs().max() <= (6.0 / (128 + 512)) ** 0.5
    assert torch.equal(tree["dec"][1]["ln3"]["scale"], torch.ones(128))
    assert not tree["dec"][0]["mlp"]["b1"].any()


# ------------------------------------------- sequence and pipeline parallelism


@pytest.fixture(scope="module")
def store_30(tmp_path_factory):
    """JAX's test store: 2 users of one video, 300 frames, 30 + 30 frames."""
    win = str(tmp_path_factory.mktemp("store") / "win.npz")
    cli.main(["prepare-data", "--out", win, "--h-in", "30", "--h-out", "30", "--n-users", "2", "--n-videos", "1",
              "--n-frames", "300"])
    return win


@pytest.fixture
def eight_devices(monkeypatch):
    """The port's local devices: 8 CPU entries, as JAX's 8 virtual devices."""
    from longterm360fov_tpu_torch.parallel import grid

    monkeypatch.setattr(grid, "local_devices", lambda kind="cuda": [torch.device("cpu")] * 8)


def _jax_lines(argv, monkeypatch, capsys):
    """What JAX's CLI prints for ``argv`` up to its training loop (patched
    out): its rounding and parallelism lines."""
    from longterm360fov_tpu import train as jax_train

    with monkeypatch.context() as m:
        m.setattr(jax_train, "train_loop", lambda *a, **k: (None, []))
        jax_cli.main(argv)
    return [ln for ln in capsys.readouterr().out.splitlines() if "rounding" in ln or "parallelism" in ln]


@pytest.mark.parametrize("flags,lines", [
    (["--batch-size", "10", "--seq-parallel", "2"],
     ["rounding batch_size down to 8 (multiple of SP data axis 4)",
      "sequence parallelism: horizon 30 ring-sharded over mesh {'data': 4, 'seq': 2}"]),
    (["--batch-size", "8", "--pipeline-parallel", "2"],
     ["pipeline parallelism: 2 decoder layers over 2 stages (GPipe microbatching)"]),
    # accum slices the batch before the microbatch split: 6 with 2 stages and
    # --accum 2 rounds to 4 (nd x accum), not to lcm(2, 2)
    (["--batch-size", "6", "--pipeline-parallel", "2", "--accum", "2"],
     ["rounding batch_size down to 4 (multiple of PP microbatch count 2)",
      "pipeline parallelism: 2 decoder layers over 2 stages (GPipe microbatching)"]),
], ids=["seq-parallel", "pipeline-parallel", "pipeline-parallel-accum"])
def test_cli_train_seq_and_pipeline_parallel(flags, lines, store_30, eight_devices, monkeypatch, capsys):
    """train --seq-parallel / --pipeline-parallel on 8 CPU entries: the
    rounding and parallelism lines are JAX's for the same argv, the loss
    finite."""
    argv = ["train", "--preset", "transformer-30", "--data", store_30, "--steps", "2", *flags]
    capsys.readouterr()
    assert _jax_lines(argv, monkeypatch, capsys) == lines
    cli.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert [ln for ln in out if "rounding" in ln or "parallelism" in ln] == lines
    assert np.isfinite(_last_json("\n".join(out))["loss"])


@pytest.mark.parametrize("argv,match", [
    (["--preset", "lstm-xyz-10", "--seq-parallel", "2"], "transformer family only"),
    (["--preset", "transformer-30", "--seq-parallel", "4"], "not divisible"),
    (["--preset", "transformer-30", "--seq-parallel", "-1"], "must be >= 1"),
    (["--preset", "transformer-30", "--seq-parallel", "2", "--data-parallel"], "drop --data-parallel"),
    (["--preset", "lstm-xyz-10", "--pipeline-parallel", "2"], "transformer family only"),
    (["--preset", "transformer-30", "--pipeline-parallel", "3"], "not divisible"),
    (["--preset", "transformer-30", "--pipeline-parallel", "2", "--seq-parallel", "2"], "exclusive"),
    (["--preset", "transformer-30", "--pipeline-parallel", "2", "--data-parallel"], "exclusive"),
    (["--preset", "transformer-30", "--seq-parallel", "15"], "need 15 devices"),
])
def test_cli_parallel_refusals_are_jax_s(argv, match, store_30, eight_devices):
    """Each refusal exits with the JAX CLI's text for the same argv."""
    argv = ["train", *argv, "--data", store_30, "--steps", "1"]
    with pytest.raises(SystemExit, match=match) as ours:
        cli.main([*argv, "--device", "cpu"])
    with pytest.raises(SystemExit) as ref:
        jax_cli.main(argv)
    assert str(ours.value) == str(ref.value)
