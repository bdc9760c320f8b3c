"""The port stands alone: every module of longterm360fov_tpu_torch, and
chip_smoke.py, import with jax and the JAX package made unimportable — the
machine with the card has no jax."""

import _torch_threads  # noqa: F401  (first: sizes torch's thread pool)
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "longterm360fov_tpu"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import longterm360fov_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
names = [n for n in names if not n.endswith(".__main__")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # noqa: F401
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "longterm360fov_tpu") and sys.modules[m] is not None)
print(len(names), loaded, ",".join(names))
"""

# the training slice's modules, beside the serving slice's, the cross_user
# and scheduled-sampling slice's, the lockstep-peer slice's, the fusion
# slice's and the transformer slice's
_TRAIN_SLICE = ("baselines", "checkpoint", "data", "evaluate", "losses",
                "ops.lstm_train", "traces", "train")
_CROSS_USER_SLICE = ("models.cross_user", "ops.lstm_ss")
_PEER_ALIGN_SLICE = ("ops.lstm_align",)
_FUSION_SLICE = ("ops.conv_resize", "features", "features.equirect", "models.fusion")
_TRANSFORMER_SLICE = ("models.transformer", "ops.transformer_encode", "ops.transformer_decode")


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr
    count, loaded, names = proc.stdout.split(" ")
    assert int(count) >= 23, proc.stdout  # every module of the package
    assert loaded.strip() == "[]"
    names = names.strip().split(",")
    for mod in _TRAIN_SLICE + _CROSS_USER_SLICE + _PEER_ALIGN_SLICE + _FUSION_SLICE + _TRANSFORMER_SLICE:
        assert f"longterm360fov_tpu_torch.{mod}" in names


# slice I-a adds entry points to existing modules: the kernel cell, the decode
# kernel, the transformer's bf16 tiers
_SLICE_I_A = (("models.cell", "get_cell_fn"), ("models.seq2seq", "decode_fused"),
              ("ops.fused_lstm", "fused_lstm_cell"), ("ops.fused_lstm", "fused_decode"),
              ("ops.transformer_encode", "fused_encode_tokens_bf16"),
              ("ops.transformer_decode", "fused_ar_decode_bf16"))


def test_slice_entry_points_import_without_jax():
    probe = "\n".join([
        "import importlib, sys",
        "for blocked in ('jax', 'jaxlib', 'longterm360fov_tpu'):",
        "    sys.modules[blocked] = None",
        f"for mod, attr in {_SLICE_I_A!r}:",
        "    getattr(importlib.import_module('longterm360fov_tpu_torch.' + mod), attr)",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


# slices C-1 and C-2 (export, predict, the TCP daemon) add entry points to
# existing modules
_SLICE_C_1_2 = (("geometry", "euler_to_xyz_np"), ("infer", "predict_batch"), ("infer", "predict_euler"),
                ("params", "tensor_to_array"), ("serving", "pose_to_xyz"), ("serving", "ViewerSessions"),
                ("serving", "PeerPool"), ("serving", "encode_frame"), ("serving", "read_frame"),
                ("serving", "FovServer"), ("serving", "FovClient"), ("serving", "serve_daemon"),
                ("cli", "cmd_export"), ("cli", "cmd_predict"), ("cli", "cmd_serve_daemon"))

_DAEMON_PROBE = r"""
import importlib, sys, threading
for blocked in ('jax', 'jaxlib', 'longterm360fov_tpu'):
    sys.modules[blocked] = None
for mod, attr in MODS:
    getattr(importlib.import_module('longterm360fov_tpu_torch.' + mod), attr)
import numpy as np, torch
from longterm360fov_tpu_torch import serving
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models import get_family
cfg = get_preset('lstm-xyz-10')
fam = get_family(cfg.model_family)
params = fam.init(torch.Generator().manual_seed(0), cfg.model, device='cpu')
server = serving.serve_daemon(params, cfg, fam, device='cpu', port=0, max_batch=4, warmup=False)
threading.Thread(target=server.serve_forever, daemon=True).start()
past = np.tile(np.float32([1, 0, 0]), (cfg.model.h_in, 1))
for wire in ('json', 'binary'):
    c = serving.FovClient(*server.server_address, wire=wire)
    r = c.predict(past if wire == 'binary' else past.tolist())
    assert len(r['yaw']) == cfg.model.h_out, r
    c.close()
server.shutdown(); server.server_close(); server.batcher.stop()
print('ok')
"""


def test_export_predict_and_daemon_run_without_jax():
    """The slice's entry points import, and a CPU daemon answers on both
    wires, with jax and the JAX package unimportable."""
    proc = subprocess.run([sys.executable, "-c", _DAEMON_PROBE.replace("MODS", repr(_SLICE_C_1_2))], cwd=ROOT,
                          capture_output=True, text=True, timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


# slices C-3 and C-4 (trace ingest, the simulations and the reports): new
# modules and entry points
_SLICE_C_3_4_MODULES = ("datasets", "native", "plots", "utils", "utils.profiling", "utils.flops")
_SLICE_C_3_4 = (("geometry", "quat_normalize"), ("geometry", "quat_to_euler"), ("geometry", "quat_to_xyz"),
                ("geometry", "slerp"), ("traces", "load_trace"), ("traces", "resample"),
                ("infer", "stream_simulation"), ("cli", "cmd_serve"), ("cli", "cmd_stream_sim"),
                ("cli", "cmd_inspect_traces"))

_INGEST_PROBE = r"""
import importlib, os, sys, tempfile
for blocked in ('jax', 'jaxlib', 'longterm360fov_tpu', 'matplotlib', 'tensorboard'):
    sys.modules[blocked] = None
for mod in NEW:
    importlib.import_module('longterm360fov_tpu_torch.' + mod)
for mod, attr in MODS:
    getattr(importlib.import_module('longterm360fov_tpu_torch.' + mod), attr)
import numpy as np, torch
from longterm360fov_tpu_torch import datasets, infer, native
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models import get_family
root = tempfile.mkdtemp()
for u in range(3):
    os.makedirs(f'{root}/user{u}')
    t = np.arange(400) / 30.0
    yaw = 0.01 * u + np.linspace(0, 2, 400)
    q = np.stack([t, np.cos(yaw / 2), 0 * t, 0 * t, np.sin(yaw / 2)], 1)
    np.savetxt(f'{root}/user{u}/video0.csv', q, fmt='%.6f', delimiter=',')
store = datasets.load_dataset(root)
assert len(store) == 3 and len(store.traces[0]) == 134, [len(t) for t in store.traces]
cfg = get_preset('seq2seq-tf-30', model_h_in=10, model_h_out=10, model_hidden=16)
params = get_family(cfg.model_family).init(torch.Generator().manual_seed(0), cfg.model, device='cpu')
res = infer.stream_simulation(params, cfg, [t.xyz for t in store.traces], device='cpu', deadlines=(1, 5))
assert res['viewers'] == 3 and res['ticks'] == 134 - 10 - 5, res
lib = native.build()
assert lib.parent == native.BUILD_DIR and native.SOURCE.is_relative_to(native.BUILD_DIR.parents[1])
print('ok')
"""


def test_ingest_and_stream_simulation_run_without_jax():
    """The slice's modules import, and logs ingest through the C library into
    a streaming simulation on the CPU, with jax, the JAX package, matplotlib
    and tensorboard unimportable; the C library is built from the port's own
    source into the checkout's build directory."""
    probe = _INGEST_PROBE.replace("NEW", repr(_SLICE_C_3_4_MODULES)).replace("MODS", repr(_SLICE_C_3_4))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_the_slice_modules_are_in_the_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split(" ")[2].strip().split(",")
    for mod in _SLICE_C_3_4_MODULES:
        assert f"longterm360fov_tpu_torch.{mod}" in names


# slice P-1 (data parallelism): new modules, and a world of ranks started by
# parallel.launch whose processes cannot import jax or the JAX package
_SLICE_P_1_MODULES = ("draws", "parallel", "parallel.launch", "parallel.mesh", "parallel.multihost", "parallel.serve")

_BLOCKER = "import sys\nfor blocked in ('jax', 'jaxlib', 'longterm360fov_tpu'):\n    sys.modules[blocked] = None\n"

_WORLD_WORKER = r"""
import sys
import numpy as np
import torch
from longterm360fov_tpu_torch import train
from longterm360fov_tpu_torch.config import ExperimentConfig
from longterm360fov_tpu_torch.models import seq2seq
from longterm360fov_tpu_torch.parallel import make_sharded_predict_fn, train_loop_dp


def run(mesh, data):
    cfg = ExperimentConfig(name="no-jax", model=seq2seq.Seq2SeqConfig(d=3, hidden=16, layers=1, h_in=5, h_out=5),
                           batch_size=8, steps=2, scheduled_sampling=True)
    state, history = train_loop_dp(cfg, seq2seq.init, seq2seq.apply, data, mesh=mesh,
                                   fused_ss_fn=seq2seq.apply_fused_ss)
    xyz = make_sharded_predict_fn(state.params, cfg, seq2seq, ["cpu"] * 2)(data["past"][:4])
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "longterm360fov_tpu")
                    and sys.modules[m] is not None)
    return {"steps": history[-1]["step"], "shape": tuple(xyz.shape), "loaded": loaded,
            "blocked": "jax" in sys.modules and sys.modules["jax"] is None}
"""


def test_a_world_of_ranks_runs_without_jax(tmp_path):
    """The slice's modules import with jax blocked, and two gloo ranks train
    (scheduled sampling, data-parallel) and serve (sharded) with jax and the
    JAX package unimportable in every rank: a sitecustomize on the ranks'
    path blocks them before any import."""
    from longterm360fov_tpu_torch.parallel import launch

    probe = _BLOCKER + "import importlib\n" + "".join(
        f"importlib.import_module('longterm360fov_tpu_torch.{m}')\n" for m in _SLICE_P_1_MODULES) + "print('ok')"
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCKER)
    worker = tmp_path / "world_worker.py"
    worker.write_text(_WORLD_WORKER)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(32, 10, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    data = {"past": v[:, :5].copy(), "future": v[:, 5:].copy()}
    results = launch.run_world(f"{worker}:run", 2, data, workdir=str(tmp_path / "w"), timeout=120,
                               env={"PYTHONPATH": str(site)})
    assert [r["steps"] for r in results] == [2, 2]
    assert all(r["shape"] == (4, 5, 3) and r["loaded"] == [] and r["blocked"] for r in results)


# slices P-2 and P-3 (sequence, pipeline and tensor parallelism): new modules
# on device grids of one process
_SLICE_P_2_3_MODULES = ("parallel.grid", "parallel.sp", "parallel.pp", "parallel.tp")

_GRID_PROBE = r"""
import importlib
for mod in NEW:
    importlib.import_module('longterm360fov_tpu_torch.' + mod)
import torch
from longterm360fov_tpu_torch import cli, parallel
from longterm360fov_tpu_torch.models import seq2seq, transformer
cfg = seq2seq.Seq2SeqConfig(d=3, hidden=16, layers=2, h_in=4, h_out=4)
params = transformer.init(torch.Generator().manual_seed(0), cfg, device='cpu')
past, fut = torch.randn(4, 4, 3), torch.randn(4, 4, 3)
ref = transformer.apply(params, cfg, past, fut)
for out in (parallel.sp_decode(params, cfg, parallel.make_sp_mesh(2, devices=['cpu'] * 2), past, fut),
            parallel.pp_decode(params, cfg, parallel.make_pp_mesh(2, devices=['cpu'] * 2), past, fut)):
    assert (out - ref).abs().max() < 1e-5
s2s = seq2seq.init(torch.Generator().manual_seed(0), cfg, device='cpu')
mesh = parallel.make_mesh('cpu', model_parallel=2, devices=['cpu'] * 4)
out = parallel.tp_apply(parallel.apply_tp_shardings(s2s, mesh), cfg, past)
assert (out - seq2seq.decode(s2s, cfg, past)).abs().max() < 1e-5
assert not hasattr(cli, '_NOT_PORTED')
print('ok')
"""


def test_sequence_pipeline_and_tensor_parallelism_run_without_jax():
    """The slices' modules import, and a sequence-, a pipeline- and a
    tensor-parallel forward run on grids of CPU entries, with jax and the
    JAX package unimportable; the CLI has no unported flag left."""
    probe = _BLOCKER + _GRID_PROBE.replace("NEW", repr(_SLICE_P_2_3_MODULES))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
