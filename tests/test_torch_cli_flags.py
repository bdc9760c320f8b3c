"""The port's model-shape flags on ``train``, ``eval`` and ``serve-bench``
against the JAX CLI's (``--h-in``/``--h-out`` with ``--peer-align`` and
``--peers``: the same config and model hashes for the same argv), a
checkpoint trained with them, and ``serve-bench --impl``'s JAX names."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import json

import pytest

from longterm360fov_tpu import cli as jax_cli
from longterm360fov_tpu_torch import cli

# the repo's best recipe on record (RESULTS.md): 100 frames in and out, K = 7 time-aligned peers
RECIPE = ["--h-in", "100", "--h-out", "100", "--peer-align", "--peers", "7"]
REQUIRED = {"train": [], "eval": ["--ckpt-dir", "ck"], "serve-bench": []}


@pytest.mark.parametrize("flags", [[], RECIPE], ids=["preset", "recipe"])
@pytest.mark.parametrize("cmd", ["train", "eval", "serve-bench"])
def test_model_flags_hash_as_jax(cmd, flags):
    argv = [cmd, "--preset", "stacked-ss-crossuser", *REQUIRED[cmd], *flags]
    ours = cli._preset_cfg(cli._build_parser().parse_args([*argv, "--device", "cpu"]))
    ref = jax_cli._preset_cfg(jax_cli._build_parser().parse_args(argv))
    assert (ours.hash(), ours.model_hash()) == (ref.hash(), ref.model_hash())
    assert (ours.model.h_in, ours.model.h_out, ours.n_other_users) == ((100, 100, 7) if flags else (30, 30, 4))
    assert ours.model.peer_align == bool(flags)


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_checkpoint_trained_with_h_flags_needs_them_to_load(tmp_path, capsys):
    """One CPU step at --h-in 20 --h-out 10 writes a checkpoint; eval with
    the same flags opens it, eval without them refuses it by the model
    hash, as JAX does."""
    ck, win = str(tmp_path / "ck"), str(tmp_path / "win.npz")
    shape = ["--h-in", "20", "--h-out", "10"]
    # a small store: prepare-data's own --h-in/--h-out are the window lengths
    cli.main(["prepare-data", "--out", win, *shape, "--n-users", "2", "--n-videos", "1", "--n-frames", "300"])
    run = ["--preset", "seq2seq-tf-30", "--data", win, "--ckpt-dir", ck, "--device", "cpu"]
    cli.main(["train", *run, *shape, "--steps", "1", "--batch-size", "8"])
    assert _last_json(capsys.readouterr().out)["step"] == 1
    cli.main(["eval", *run, *shape, "--json"])
    assert len(_last_json(capsys.readouterr().out)["error_by_step_deg"]) == 10
    with pytest.raises(SystemExit, match="model-config hash mismatch"):
        cli.main(["eval", *run, "--json"])


def test_serve_bench_impl_takes_jax_names(capsys):
    cli.main(["serve-bench", "--batch", "8", "--iters", "1", "--impl", "xla", "--device", "cpu",
              "--h-in", "20", "--h-out", "10"])
    res = _last_json(capsys.readouterr().out)
    assert res["impl"] == "xla" and res["horizon"] == 10 and res["viewers_per_sec"] > 0
    # the port's default is the card's path, JAX's its plain one (ROADMAP.md, known divergences)
    assert cli._build_parser().parse_args(["serve-bench", "--device", "cpu"]).impl == "fused"
    assert jax_cli._build_parser().parse_args(["serve-bench"]).impl == "xla"
    for parse, extra in ((cli._build_parser().parse_args, ["--device", "cpu"]),
                         (jax_cli._build_parser().parse_args, [])):
        with pytest.raises(SystemExit):
            parse(["serve-bench", "--impl", "plain", *extra])
    with pytest.raises(ValueError, match="impl must be one of"):
        cli.serve_bench(batch=8, iters=1, impl="plain", device="cpu")
