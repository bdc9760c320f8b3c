"""The port's command line against the JAX package's: every subcommand of the
JAX ``_build_parser()`` exists in the port with the same flags, each with
the same dest, option strings, default, choices, type, required, const and
nargs, but for the documented divergences (ROADMAP.md, known divergences):
``--device`` on the subcommands that compute, ``serve-bench --seed``, and
``--impl`` defaulting to "fused" on ``serve-bench``, ``predict`` and
``stream-sim``. The parallel flags are parsed as JAX parses them; the
data-parallel ones run, the sequence- and pipeline-parallel ones raise,
naming the parallelism slice."""

import argparse
import threading

import numpy as np
import pytest
import torch

from longterm360fov_tpu import cli as jax_cli
from longterm360fov_tpu_torch import cli, serving
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models import get_family
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


@pytest.mark.parametrize("argv", [
    ["train", "--preset", "seq2seq-tf-30", "--data-parallel", "--steps", "1", "--batch-size", "8"],
    ["train", "--preset", "transformer-30", "--seq-parallel", "2"],
    ["train", "--preset", "transformer-30", "--pipeline-parallel", "2"],
    ["serve-daemon", "--preset", "seq2seq-tf-30", "--params", "p.npz", "--data-parallel", "--port", "0",
     "--max-batch", "2"],
], ids=["data-parallel", "seq-parallel", "pipeline-parallel", "daemon-data-parallel"])
def test_parallel_flags_raise_naming_the_slice(argv, tmp_path, monkeypatch, capsys):
    """--seq-parallel and --pipeline-parallel raise, naming the parallelism
    slice; the data-parallel flags (slice P-1) run: train in a world of one,
    the daemon on the one CPU device, which answers."""
    if "--data-parallel" not in argv:
        with pytest.raises(SystemExit, match="not ported yet: .*slice 'parallelism'"):
            cli.main([*argv, "--device", "cpu"])
        return
    monkeypatch.chdir(tmp_path)
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
    else:
        assert '"n_devices": 1' in out
