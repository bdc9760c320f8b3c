"""The port's command line: ``presets`` and ``serve-bench``."""

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


@pytest.mark.parametrize("impl", ["fused", "plain"])
def test_serve_bench_on_cpu_is_labelled_cpu(impl, capsys):
    cli.main(["serve-bench", "--batch", "8", "--iters", "1", "--impl", impl,
              "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["impl"] == impl and res["batch"] == 8 and res["horizon"] == 30
    assert res["timer"] == "host clock" and res["device"] == {"kind": "cpu"}
    assert res["viewers_per_sec"] > 0


def test_serve_bench_needs_a_device_argument():
    with pytest.raises(SystemExit):
        cli.main(["serve-bench"])


@pytest.mark.skipif("torch.cuda.is_available()", reason="checks the no-card case")
def test_serve_bench_refuses_cuda_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.serve_bench(batch=8, iters=1, impl="fused", device="cuda")
