"""The port's command line: ``presets`` and ``serve-bench``, its device on the card by default."""

import json

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
def test_transformer_parallel_flags_still_raise(flag):
    with pytest.raises(SystemExit, match="parallelism"):
        cli.main(["train", "--preset", "transformer-30", "--device", "cpu", *flag])


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
