"""Start a world of ranks on this host and collect what each returns.

:func:`run_world` starts ``world_size`` processes of this module, each of
which joins one process group through a ``file://`` store in ``workdir`` (no
port to pick), builds its :class:`~.mesh.DataMesh` on its device, calls the
target ``fn(mesh, payload)`` and saves what it returns. The world is joined
with a deadline: a rank that fails (after a short grace for its peers to end
on their own) or a world that outlives it has every rank killed, and
the group is destroyed in ``finally`` on every rank, so no caller waits on a
dead peer. The target is ``"package.module:function"`` or
``"path/to/file.py:function"``; the payload and the results go through
``torch.save``.

Run a rank by hand: ``python -m longterm360fov_tpu_torch.parallel.launch
WORKDIR RANK WORLD BACKEND DEVICE TARGET TIMEOUT_S``.
"""

from __future__ import annotations

import datetime
import importlib
import importlib.util
import os
import subprocess
import sys
import time
from typing import Any, List, Optional

import torch

__all__ = ["run_world"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FAIL_GRACE_S = 5.0  # after a rank fails, how long its peers may take to end on their own


def _resolve(target: str):
    where, _, name = target.rpartition(":")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(os.path.splitext(os.path.basename(where))[0], where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def run_world(
    target: str,
    world_size: int,
    payload: Any = None,
    *,
    workdir: str,
    backend: str = "gloo",
    device: str = "cpu",
    timeout: float = 300.0,
    env: Optional[dict] = None,
) -> List[Any]:
    """Run ``target(mesh, payload)`` on ``world_size`` ranks of a new
    process group over ``backend`` and return each rank's result, by rank.
    ``device`` is every rank's device (two ranks may share one card over
    gloo). ``workdir`` must be a fresh directory. Raises
    with the error output of the ranks that had failed when the world was
    stopped, and ``TimeoutError`` when it outlives ``timeout`` seconds."""
    os.makedirs(workdir, exist_ok=True)
    torch.save(payload, os.path.join(workdir, "payload.pt"))
    env = {**os.environ, **(env or {})}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    procs, logs, timed_out, failed = [], [], False, []
    try:
        for rank in range(world_size):
            log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, workdir, str(rank), str(world_size), backend,
                 device, target, str(timeout)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=_ROOT,
            ))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                # a rank failed: its peers fail with it or wait on it; those
                # that end within the grace report too, the rest are killed
                grace = time.monotonic() + FAIL_GRACE_S
                while time.monotonic() < grace and any(p.poll() is None for p in procs):
                    time.sleep(0.02)
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.02)
        failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()

    def tail(rank):
        with open(os.path.join(workdir, f"rank{rank}.log")) as f:
            return f"rank {rank} of {world_size} on {target} exited {procs[rank].returncode}:\n{f.read()[-3000:]}"

    if timed_out:
        raise TimeoutError(f"world of {world_size} on {target} outlived {timeout} s; {tail(0)}")
    if failed:  # the ranks that had failed when the world was stopped, not those killed for them
        raise RuntimeError("\n".join(tail(rank) for rank in failed))
    return [
        torch.load(os.path.join(workdir, f"result{rank}.pt"), weights_only=False)
        for rank in range(world_size)
    ]


def _rank_main(argv):
    from . import mesh, multihost

    workdir, rank, world, backend, device, target, timeout = argv
    rank, world = int(rank), int(world)
    import torch.distributed as dist

    multihost.init_multihost(
        f"file://{os.path.join(workdir, 'store')}", world, rank, backend=backend, device=device,
        timeout=datetime.timedelta(seconds=float(timeout)),
    )
    try:
        result = _resolve(target)(
            mesh.make_mesh(device), torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
        )
        path = os.path.join(workdir, f"result{rank}.pt")
        torch.save(result, path + ".tmp")
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
