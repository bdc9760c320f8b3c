"""The port's command line against the JAX package's: every subcommand of the
JAX ``_build_parser()`` exists in the port with the same flags, each with
the same dest, option strings, default, choices, type, required, const and
nargs, but for the documented divergences (ROADMAP.md, known divergences):
``--device`` on the subcommands that compute, ``serve-bench --seed``, and
``--impl`` defaulting to "fused" on ``serve-bench``, ``predict`` and
``stream-sim``. The parallel flags are parsed as JAX parses them, and each
runs on the CPU."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import argparse
import json
import threading

import numpy as np
import pytest
import torch

from longterm360fov_tpu import cli as jax_cli
from longterm360fov_tpu_torch import cli, serving
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models import get_family
from longterm360fov_tpu_torch.parallel import grid
from longterm360fov_tpu_torch.params import tensor_to_array

COMPUTING = ("extract-features", "train", "eval", "serve-bench", "predict", "serve", "stream-sim", "serve-daemon")
PORT_ONLY = {(cmd, "device") for cmd in COMPUTING} | {("serve-bench", "seed")}
FUSED_DEFAULT = {("serve-bench", "impl"), ("predict", "impl"), ("stream-sim", "impl")}


def _subcommands(parser):
    return next(a.choices for a in parser._actions if isinstance(a, argparse._SubParsersAction))


def _flags(sub):
    return {a.dest: dict(option_strings=tuple(a.option_strings), default=a.default,
                         choices=tuple(a.choices) if a.choices else None, type=a.type, required=a.required,
                         const=a.const, nargs=a.nargs)
            for a in sub._actions if not isinstance(a, argparse._HelpAction)}


JAX_SUBS = _subcommands(jax_cli._build_parser())


def test_the_port_has_every_subcommand_of_jax():
    assert sorted(_subcommands(cli._build_parser())) == sorted(JAX_SUBS)
    assert len(JAX_SUBS) == 12


@pytest.mark.parametrize("cmd", sorted(JAX_SUBS))
def test_flags_match_jax(cmd):
    ref, ours = _flags(JAX_SUBS[cmd]), _flags(_subcommands(cli._build_parser())[cmd])
    assert {d for d in ours if (cmd, d) in PORT_ONLY} == set(ours) - set(ref)
    assert set(ref) <= set(ours)
    for dest, spec in ref.items():
        got = dict(ours[dest])
        if (cmd, dest) in FUSED_DEFAULT:
            assert (spec["default"], got["default"]) == ("xla", "fused")
            got["default"] = spec["default"]
        assert got == spec, (cmd, dest)
    if cmd in COMPUTING:
        assert ours["device"]["default"] == "cuda"


@pytest.fixture(scope="module")
def small_store(tmp_path_factory):
    """A small synthetic store from ``prepare-data`` (2 users of one video,
    400 frames, 30 + 30-frame windows, K = 4 other-user slots)."""
    win = str(tmp_path_factory.mktemp("store") / "win.npz")
    cli.main(["prepare-data", "--out", win, "--n-users", "2", "--n-videos", "1", "--n-frames", "400",
              "--n-other-users", "4"])
    return win


@pytest.mark.parametrize("argv", [
    ["train", "--preset", "seq2seq-tf-30", "--data-parallel", "--steps", "1", "--batch-size", "8"],
    ["train", "--preset", "transformer-30", "--seq-parallel", "2", "--steps", "1", "--batch-size", "8"],
    ["train", "--preset", "transformer-30", "--pipeline-parallel", "2", "--steps", "1", "--batch-size", "8"],
    ["serve-daemon", "--preset", "seq2seq-tf-30", "--params", "p.npz", "--data-parallel", "--port", "0",
     "--max-batch", "2"],
], ids=["data-parallel", "seq-parallel", "pipeline-parallel", "daemon-data-parallel"])
def test_parallel_flags_run_on_cpu(argv, tmp_path, monkeypatch, capsys, small_store):
    """Every parallel flag runs on the CPU: --seq-parallel and
    --pipeline-parallel train on 8 CPU entries (JAX's 8 virtual devices) and
    print their grids; the data-parallel flags run, train in a world of one,
    the daemon on the one CPU device, which answers."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(grid, "local_devices", lambda kind="cuda": [torch.device("cpu")] * 8)
    if argv[0] == "train":
        argv = [*argv, "--data", small_store]
    if argv[0] == "serve-daemon":
        cfg = get_preset("seq2seq-tf-30")
        params = get_family(cfg.model_family).init(torch.Generator().manual_seed(0), cfg.model, device="cpu")
        np.savez("p.npz", **{k: tensor_to_array(v) for k, v in serving.flat_param_items(params)})
        serve_forever, seen = serving.FovServer.serve_forever, {}

        def serve_and_ask(server, *a, **k):
            def ask():
                c = serving.FovClient(*server.server_address, timeout=60.0)
                seen["reply"] = c.predict([[1.0, 0.0, 0.0]] * cfg.model.h_in)
                c.close()
                server.shutdown()

            threading.Thread(target=ask, daemon=True).start()
            serve_forever(server, *a, **k)

        monkeypatch.setattr(serving.FovServer, "serve_forever", serve_and_ask)
    cli.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    if argv[0] == "serve-daemon":
        assert len(seen["reply"]["yaw"]) == 30 and '"listening"' in out
    elif "--seq-parallel" in argv:
        assert "sequence parallelism: horizon 30 ring-sharded over mesh {'data': 4, 'seq': 2}" in out
        assert np.isfinite(json.loads(out.strip().splitlines()[-1])["loss"])
    elif "--pipeline-parallel" in argv:
        assert "pipeline parallelism: 2 decoder layers over 2 stages (GPipe microbatching)" in out
        assert np.isfinite(json.loads(out.strip().splitlines()[-1])["loss"])
    else:
        assert '"n_devices": 1' in out
