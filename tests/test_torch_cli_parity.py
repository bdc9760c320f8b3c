"""The port's command line against the JAX package's: every subcommand of the
JAX ``_build_parser()`` exists in the port with the same flags, each with
the same dest, option strings, default, choices, type, required, const and
nargs, but for the documented divergences (ROADMAP.md, known divergences):
``--device`` on the subcommands that compute, ``serve-bench --seed``, and
``--impl`` defaulting to "fused" on ``serve-bench``, ``predict`` and
``stream-sim``. The parallel flags are parsed as JAX parses them and raise,
naming the parallelism slice."""

import argparse

import pytest

from longterm360fov_tpu import cli as jax_cli
from longterm360fov_tpu_torch import cli

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
    ["train", "--preset", "seq2seq-tf-30", "--data-parallel"],
    ["train", "--preset", "transformer-30", "--seq-parallel", "2"],
    ["train", "--preset", "transformer-30", "--pipeline-parallel", "2"],
    ["serve-daemon", "--preset", "seq2seq-tf-30", "--params", "p.npz", "--data-parallel"],
], ids=["data-parallel", "seq-parallel", "pipeline-parallel", "daemon-data-parallel"])
def test_parallel_flags_raise_naming_the_slice(argv):
    with pytest.raises(SystemExit, match="not ported yet: .*slice 'parallelism'"):
        cli.main([*argv, "--device", "cpu"])
