"""The port's process groups (``parallel.multihost``) and its launcher of a
world of ranks (``parallel.launch``) on the CPU, over gloo: a two-rank world
that takes its rows, its shard and rank 0's params; a world whose rank fails
or hangs ends in bounded time; and the CLI's ``train --data-parallel --device
cpu`` under ``python -m torch.distributed.run`` against the same command in
a world of one."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from longterm360fov_tpu_torch import cli
from longterm360fov_tpu_torch.parallel import init_multihost, launch, multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent('''
    import time

    import numpy as np
    import torch
    import torch.distributed as dist
    from longterm360fov_tpu_torch.models.cell import LSTMParams
    from longterm360fov_tpu_torch.parallel import global_batch, host_local_batch_slice, init_multihost
    from longterm360fov_tpu_torch.parallel import replicate_global


    def rows(mesh, full):
        sl = host_local_batch_slice(len(full["past"]))
        shard = global_batch(mesh, {k: v[sl] for k, v in full.items()})
        tree = {"proj": LSTMParams(torch.full((3, 2), float(mesh.rank)), torch.arange(4.0) + mesh.rank),
                "bf16": torch.full((5,), float(mesh.rank + 1), dtype=torch.bfloat16)}
        return {"again": init_multihost(), "world": mesh.world, "rank": mesh.rank, "slice": [sl.start, sl.stop],
                "shard": {k: v.numpy() for k, v in shard.items()}, "device": str(shard["past"].device),
                "replicated": replicate_global(mesh, tree)}


    def fail_on_rank_1(mesh, _):
        if mesh.rank == 1:
            raise RuntimeError("rank 1 gives up")
        dist.all_reduce(torch.ones(1))  # waits for the peer that never comes


    def hang(mesh, _):
        time.sleep(600)
''')


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    path = tmp_path_factory.mktemp("mh") / "mh_worker.py"
    path.write_text(WORKER)
    return str(path)


def test_init_multihost_is_a_no_op_single_process(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert init_multihost() is False
    assert init_multihost(world_size=1) is False
    assert not torch.distributed.is_initialized()
    assert multihost.host_local_batch_slice(16) == slice(0, 16)


def test_two_ranks_take_their_rows_and_rank_0s_params(worker, tmp_path):
    """Contiguous disjoint slices covering the batch; each shard on its
    rank's device; every leaf of the tree, f32 and bf16, rank 0's."""
    rng = np.random.default_rng(0)
    full = {"past": rng.normal(size=(16, 6, 3)).astype(np.float32),
            "future": rng.normal(size=(16, 6, 3)).astype(np.float32)}
    r0, r1 = launch.run_world(f"{worker}:rows", 2, full, workdir=str(tmp_path / "w"), timeout=60)
    assert (r0["world"], r0["rank"], r1["rank"]) == (2, 0, 1)
    assert r0["again"] is True  # a started group: init_multihost is idempotent
    assert r0["slice"] == [0, 8] and r1["slice"] == [8, 16]
    for r in (r0, r1):
        assert r["device"] == "cpu"
        for k in full:
            np.testing.assert_array_equal(r["shard"][k], full[k][slice(*r["slice"])])
        tree = r["replicated"]
        assert torch.equal(tree["proj"].w, torch.zeros(3, 2)) and torch.equal(tree["proj"].b, torch.arange(4.0))
        assert tree["bf16"].dtype == torch.bfloat16 and torch.equal(tree["bf16"].float(), torch.ones(5))


def test_a_failing_rank_ends_the_world_in_bounded_time(worker, tmp_path):
    """Rank 1 raises while rank 0 waits in a collective on it: run_world
    kills rank 0 and raises with rank 1's error, long before the group's
    timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 .* exited 1:\n(.|\n)*rank 1 gives up"):
        launch.run_world(f"{worker}:fail_on_rank_1", 2, workdir=str(tmp_path / "w"), timeout=120)
    assert time.monotonic() - t0 < 60


def test_a_hung_world_times_out(worker, tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="outlived 5.0 s"):
        launch.run_world(f"{worker}:hang", 2, workdir=str(tmp_path / "w"), timeout=5.0)
    assert time.monotonic() - t0 < 30


def _state(ck_dir, step):
    return torch.load(os.path.join(ck_dir, str(step), "state.pt"), weights_only=True)


def _last_json(text):
    return json.loads([line for line in text.splitlines() if line.startswith("{")][-1])


def test_cli_train_data_parallel_under_the_launcher_matches_world_one(tmp_path, capsys):
    """`python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    longterm360fov_tpu_torch train --data-parallel --device cpu`: two gloo
    ranks on the synthetic store; rank 0 alone prints and checkpoints, with
    n_devices 2, and its params are within 2e-6 of the same command without
    a launcher (a world of one); a resume under the launcher continues from
    the checkpoint."""
    argv = ["train", "--preset", "seq2seq-tf-30", "--steps", "3", "--batch-size", "16", "--device", "cpu",
            "--data-parallel"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    cli.main([*argv, "--ckpt-dir", one])
    m1 = _last_json(capsys.readouterr().out)
    assert m1["n_devices"] == 1 and m1["step"] == 3
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "longterm360fov_tpu_torch"]
    proc = subprocess.run([*cmd, *argv, "--ckpt-dir", two], capture_output=True, text=True, timeout=180,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0])["n_devices"] == 2
    a, b = _state(one, 3), _state(two, 3)
    for x, y in zip(a["params"], b["params"], strict=True):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2e-6, rtol=0)
    proc = subprocess.run([*cmd, *argv[:4], "5", *argv[5:], "--ckpt-dir", two, "--resume"], capture_output=True,
                          text=True, timeout=180, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("resumed from step 3") == 1
    assert _last_json(proc.stdout)["step"] == 5 and _state(two, 5)["step"] == 5
