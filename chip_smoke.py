"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and fails without one; it never continues on the CPU. Phases,
one line each:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. the build of every kernel of the serve path from ``csrc/``, and its time;
3. each kernel against its plain PyTorch version, at the full width of
   preset ``seq2seq-tf-30`` (hidden 128, 30 + 30 steps), at a batch that is
   not a multiple of the kernel's row tile, with 1 and 2 layers;
4. the main path: ``serving.make_serve_fn`` behind a ``DynamicBatcher``
   answers 64 concurrent single-viewer requests and one bulk request. Every
   answer must equal the direct batched call and the numpy oracle, and the
   kernel launch counts, zeroed just before, must have advanced;
5. ``serve-bench`` throughput, kernel and plain, at B = 16384 and at
   ``bench.py``'s B = 262144.

Then the kernel alone against its plain version at both batches, checked
against it there before it is timed, one JSON line on the kernels (launches
in phase 4, max error over phase 3 and both batches, kernel and plain times
at B = 262144, CUDA events), and last
the contract line ``{"ok": true, "device": {...}}``. Any failure raises.
"""

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from longterm360fov_tpu_torch import cli, oracle, serving, windows
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models import get_family
from longterm360fov_tpu_torch.ops import _build, fused_lstm
from longterm360fov_tpu_torch.params import params_from_numpy

PRESET = "seq2seq-tf-30"
KERNEL_TOL = 1e-4  # kernel vs plain, normalized outputs, f32 after 60 steps
ORACLE_TOL = 1e-4  # batcher answers vs the numpy oracle, unit xyz
KERNELS = [
    {
        "name": "fused_serve",
        "route": "cuda",
        "source": "longterm360fov_tpu_torch/csrc/fused_serve.cu",
        "replaces": "longterm360fov_tpu/ops/fused_lstm.py:503",
        "wrapper": fused_lstm.fused_serve,
    },
]


def unit_pasts(rng, n, h_in):
    v = rng.normal(size=(n, h_in, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(cfg, dev, batch, layers, seed):
    """fused_serve against fused_serve_reference on the same inputs."""
    mcfg = dataclasses.replace(cfg.model, layers=layers)
    p = params_from_numpy(oracle.init_params_np(seed, mcfg), dev)
    past = torch.as_tensor(unit_pasts(np.random.default_rng(seed), batch, mcfg.h_in), device=dev)
    past_n, _, _ = windows.normalize_window(past)
    args = (p["encoder"], p["decoder"], p["proj"]["w"], p["proj"]["b"], past_n, mcfg.h_out)
    out = fused_lstm.fused_serve(*args)
    torch.cuda.synchronize()
    ref = fused_lstm.fused_serve_reference(*args)
    if out.shape != (batch, mcfg.h_out, mcfg.d) or not torch.isfinite(out).all():
        raise AssertionError(f"kernel output {tuple(out.shape)} not finite or misshapen")
    return (out - ref).abs().max().item()


def drive_main_path(cfg, fam, dev, params_np, params):
    """64 concurrent single-viewer requests and one bulk request through a
    DynamicBatcher in front of the fused serve program; every answer must
    equal the direct batched call and the numpy oracle."""
    serve_fn = serving.make_serve_fn(params, cfg, fam, device=dev, impl="fused")
    rng = np.random.default_rng(7)
    singles = unit_pasts(rng, 64, cfg.model.h_in)
    bulk = unit_pasts(rng, 1000, cfg.model.h_in)
    bat = serving.DynamicBatcher(serve_fn, h_in=cfg.model.h_in, max_batch=1024, max_wait_ms=5.0)
    try:
        with ThreadPoolExecutor(max_workers=64) as pool:
            futs = [pool.submit(bat.predict, p) for p in singles]
            chunks = bat.submit_many(bulk)
            single_res = [f.result() for f in futs]
        for c in chunks:
            if not c.event.wait(60) or c.error is not None:
                raise AssertionError(f"bulk chunk failed: {c.error}")
        stats = bat.stats()
    finally:
        bat.stop()
    got = {
        key: np.concatenate([np.stack([r[key] for r in single_res])] + [c.result[key] for c in chunks])
        for key in ("yaw", "pitch", "prefetch")
    }
    pasts = np.concatenate([singles, bulk])
    direct = serve_fn.unpack(serve_fn({"past": pasts}).cpu().numpy())
    d_direct = max(float(np.abs(got[k] - direct[k]).max()) for k in ("yaw", "pitch"))
    same_tiles = bool((got["prefetch"] == direct["prefetch"]).all())
    yaw, pitch = got["yaw"], got["pitch"]
    xyz = np.stack([np.cos(pitch) * np.cos(yaw), np.cos(pitch) * np.sin(yaw), np.sin(pitch)], -1)
    d_oracle = float(np.abs(xyz - oracle.oracle_predict(params_np, cfg.model, pasts)).max())
    print(f"slice: {len(singles)} single + 1 bulk ({len(bulk)} rows) requests in {stats['batches']} batches; "
          f"max |yaw,pitch - direct| {d_direct:.3e}, prefetch equal {same_tiles}; "
          f"max |xyz - numpy oracle| {d_oracle:.3e} (tolerance {ORACLE_TOL})", flush=True)
    if not all(np.isfinite(got[k]).all() for k in ("yaw", "pitch")):
        raise AssertionError("non-finite answers")
    if d_direct > 1e-5 or not same_tiles:
        raise AssertionError("batched answers differ from the direct call")
    if not d_oracle <= ORACLE_TOL:
        raise AssertionError("answers disagree with the numpy oracle")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs only on the card")
    dev = torch.device("cuda:0")
    fused_lstm.exact_f32_matmul()  # the plain versions in exact f32, as the kernel
    cfg = get_preset(PRESET)
    fam = get_family(cfg.model_family)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}", flush=True)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)

    # 2. build
    b = _build.build("fused_serve")
    regs = " ".join(ln.strip() for ln in b.log.splitlines() if "registers" in ln or "spill" in ln)
    print(f"build: fused_serve.cu by nvcc in {b.seconds:.2f} s ({b.path.name}) {regs}", flush=True)

    # 3. kernel vs plain at full width
    errs = {f"layers={l}": check_kernel(cfg, dev, 4099, l, seed=l) for l in (1, 2)}
    max_err = max(errs.values())
    print(f"kernel vs plain, B=4099, hidden {cfg.model.hidden}, {cfg.model.h_in}+{cfg.model.h_out} steps: "
          f"max_abs_err {json.dumps(errs)} (tolerance {KERNEL_TOL})", flush=True)
    if not max_err <= KERNEL_TOL:
        raise AssertionError(f"kernel disagrees with its plain version: {errs}")

    # 4. main path: batcher → make_serve_fn → fused kernel
    params_np = oracle.init_params_np(0, cfg.model)
    params = params_from_numpy(params_np, dev)
    for k in KERNELS:
        k["wrapper"].launches = 0
    drive_main_path(cfg, fam, dev, params_np, params)
    launches = {k["name"]: k["wrapper"].launches for k in KERNELS}
    print(f"main path launches {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the main path never launched kernel {name}")

    # 5. serve-bench
    bench = []
    for batch, iters in ((16384, 10), (262144, 3)):
        for impl in ("fused", "plain"):
            r = cli.serve_bench(preset=PRESET, batch=batch, iters=iters, impl=impl, device=dev)
            bench.append({k: r[k] for k in ("impl", "batch", "iters", "ms_per_batch", "viewers_per_sec")})
    print(f"serve-bench (traj/s, with tile mask, CUDA events, {smi}): {json.dumps(bench)}", flush=True)

    # kernel alone vs its plain version: checked at the timed batch, then
    # timed in turns: plain, kernel, kernel, plain
    alone = {}
    for batch, iters in ((16384, 10), (262144, 3)):
        x = torch.as_tensor(unit_pasts(np.random.default_rng(1), batch, cfg.model.h_in), device=dev)
        x_n, _, _ = windows.normalize_window(x)
        args = (params["encoder"], params["decoder"], params["proj"]["w"], params["proj"]["b"],
                x_n, cfg.model.h_out)
        out = fused_lstm.fused_serve(*args)
        ref = fused_lstm.fused_serve_reference(*args)
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"kernel output at B={batch} not finite or misshapen")
        errs[f"B={batch}"] = (out - ref).abs().max().item()
        del out, ref
        if not errs[f"B={batch}"] <= KERNEL_TOL:
            raise AssertionError(f"kernel disagrees with its plain version at B={batch}: {errs}")
        t = {"plain": 0.0, "kernel": 0.0}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = fused_lstm.fused_serve if which == "kernel" else fused_lstm.fused_serve_reference
            t[which] += cuda_ms(lambda: fn(*args), iters) / 2
        alone[batch] = t
    print(f"fused_serve alone (ms, CUDA events, {smi}): {json.dumps(alone)}; "
          f"max_abs_err vs plain {json.dumps(errs)} (tolerance {KERNEL_TOL})", flush=True)
    out = {"kernels": [
        {**{k: v for k, v in KERNELS[0].items() if k != "wrapper"},
         "launches": launches["fused_serve"], "max_abs_err": max(errs.values()),
         "ms": alone[262144]["kernel"], "plain_ms": alone[262144]["plain"]},
    ]}
    print(json.dumps(out), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    t0 = time.time()
    main()
    print(f"chip_smoke: {time.time() - t0:.1f} s", file=sys.stderr)
