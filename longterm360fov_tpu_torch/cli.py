"""Command line of the port: ``python -m longterm360fov_tpu_torch``.

``presets`` lists the experiment presets; ``serve-bench`` times the serve
path (twin of the JAX ``serve-bench``) on an explicit device and prints one
JSON line. On ``--device cuda`` the time comes from CUDA events and the line
names the card and its power limit; on ``--device cpu`` it is the host
clock, for rehearsal only.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time

import numpy as np
import torch

__all__ = ["main", "serve_bench", "card"]


def card(device: torch.device) -> dict:
    """Name and power limit of the card behind ``device``, as
    ``nvidia-smi --query-gpu=name,power.limit`` reports them."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    info = {"kind": torch.cuda.get_device_name(index), "power_limit": None}
    if shutil.which("nvidia-smi"):
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        info["power_limit"] = q.split(",")[-1].strip()
    return info


def serve_bench(
    *, preset: str = "seq2seq-tf-30", batch: int, iters: int, impl: str,
    device, seed: int = 0,
) -> dict:
    """Time ``iters`` calls of the serve path (normalize → decode →
    denormalize → tile mask) on ``batch`` random viewers, after one warm-up
    call. Weights are ``oracle.init_params_np(seed)``, as in ``bench.py``.
    Turns TF32 off for the process (``exact_f32_matmul``)."""
    from . import infer, oracle
    from .config import get_preset
    from .ops.fused_lstm import exact_f32_matmul
    from .params import params_from_numpy

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    exact_f32_matmul()  # the plain impl in the f32 the kernel computes
    cfg = get_preset(preset)
    params = params_from_numpy(oracle.init_params_np(seed, cfg.model), device)
    rng = np.random.default_rng(seed)
    past = rng.normal(size=(batch, cfg.model.h_in, 3)).astype(np.float32)
    past /= np.linalg.norm(past, axis=-1, keepdims=True)
    x = torch.as_tensor(past, device=device)
    serve = infer.make_predict_fn(
        params, cfg, device=device, with_tiles=True, impl=impl
    )
    res = {"preset": preset, "impl": impl, "batch": batch, "iters": iters,
           "horizon": cfg.model.h_out}
    if device.type == "cuda":
        serve(x)
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            serve(x)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        res.update(timer="cuda events", device=card(device))
    else:
        serve(x)
        t0 = time.perf_counter()
        for _ in range(iters):
            serve(x)
        ms = (time.perf_counter() - t0) * 1e3 / iters
        res.update(timer="host clock", device={"kind": str(device)})
    res.update(ms_per_batch=ms, viewers_per_sec=batch * 1e3 / ms)
    return res


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="longterm360fov_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("presets", help="list experiment presets")
    sb = sub.add_parser("serve-bench", help="serve-path throughput microbench")
    sb.add_argument("--preset", default="seq2seq-tf-30")
    sb.add_argument("--batch", type=int, default=4096)
    sb.add_argument("--iters", type=int, default=30)
    sb.add_argument(
        "--impl", default="fused", choices=("fused", "plain"),
        help="fused = the hand-written CUDA serve kernel; plain = PyTorch ops",
    )
    sb.add_argument("--device", required=True, help="cuda, cuda:N or cpu")
    sb.add_argument("--seed", type=int, default=0)
    return p


def cmd_presets(_args):
    from .config import PRESETS

    for name, cfg in PRESETS.items():
        m = cfg.model
        print(
            f"{name:<24} family={cfg.model_family:<12} "
            f"h_in={m.h_in} h_out={m.h_out} hidden={m.hidden} layers={m.layers}"
        )


def cmd_serve_bench(args):
    print(json.dumps(serve_bench(
        preset=args.preset, batch=args.batch, iters=args.iters,
        impl=args.impl, device=args.device, seed=args.seed,
    )))


def main(argv=None):
    args = _build_parser().parse_args(argv)
    {"presets": cmd_presets, "serve-bench": cmd_serve_bench}[args.cmd](args)
