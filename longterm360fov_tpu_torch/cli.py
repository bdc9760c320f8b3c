"""Command line of the port: ``python -m longterm360fov_tpu_torch``.

``presets`` lists the experiment presets; ``inspect-traces`` previews or
validates a directory of head-pose logs; ``prepare-data`` packs the windows
of those logs (``--traces``) or of the synthetic store (with
``--features``, each window's video features) into an npz;
``extract-features`` turns per-video frame arrays into per-frame feature
vectors; ``train`` trains a preset and ``eval`` evaluates its checkpoint
(``--plot``: the error curve and one trajectory as PNGs); ``export``
flattens a checkpoint's params into one npz; ``predict`` writes one JSON
line of predicted trajectories per viewer; ``serve`` scores tile prefetch
on the test split and ``stream-sim`` in a tick-by-tick streaming
simulation; ``serve-daemon`` runs the online TCP server (twins of the JAX
subcommands); ``serve-bench`` times the serve path (twin of the JAX
``serve-bench``) and prints one JSON line. On the card the time comes from CUDA events and the
line names the card and its power limit; on ``--device cpu`` it is the host
clock, for rehearsal only.

Every subcommand that computes on a device takes ``--device``, ``cuda`` by
default (``cpu`` runs the kernels' plain versions), and runs there; the f32
products and convolutions run in full f32 on the card
(``exact_f32_matmul``). ``prepare-data`` and ``inspect-traces`` are host
code and ``export`` reads the checkpoint on the CPU: they take none.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["main", "serve_bench", "bench_params_np", "card", "extract_features"]

# train flags of the JAX CLI that the port does not have yet, and the
# ROADMAP.md item that brings each
_NOT_PORTED = {
    "seq_parallel": "--seq-parallel: ROADMAP.md, slice 'parallelism'",
    "pipeline_parallel": "--pipeline-parallel: ROADMAP.md, slice 'parallelism'",
}
# serve-bench and predict --impl, JAX's names: "fused" the hand-written
# kernels, "xla" the plain PyTorch path
SERVE_IMPLS = ("xla", "fused")
DEVICE_HELP = "cuda (the default), cuda:N or cpu"


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


def _with_peers(cfg) -> bool:
    return cfg.model_family in ("cross_user", "transformer") and cfg.n_other_users > 0


def bench_params_np(cfg, seed: int) -> dict:
    """Seeded numpy weights of the preset's family: ``oracle.init_params_np``
    (as in ``bench.py``) and, from ``default_rng(seed + 1)``, for cross_user
    a Glorot-uniform peer encoder (forget-gate bias 1), for fusion the conv
    stack (4 filters N(0, 1/9), a Glorot-uniform head) and the feature MLP
    (Glorot-uniform), as ``models.fusion.init`` draws them, with zero
    biases. The transformer's tree is ``models.transformer.init`` on a
    ``torch.Generator`` seeded with ``seed``, as numpy."""
    from . import oracle
    from .models.cell import LSTMParams

    if cfg.model_family == "transformer":
        from .models import transformer
        from .params import walk

        tree = transformer.init(torch.Generator().manual_seed(seed), cfg.model, device="cpu")
        return walk(tree, lambda _, t: t.numpy())
    tree = oracle.init_params_np(seed, cfg.model)
    if cfg.model_family == "cross_user":
        m = cfg.model
        lim = np.sqrt(6.0 / (m.d + m.ctx_dim + 4 * m.ctx_dim))
        w = np.random.default_rng(seed + 1).uniform(
            -lim, lim, size=(m.d + m.ctx_dim, 4 * m.ctx_dim)).astype(np.float32)
        b = np.zeros(4 * m.ctx_dim, np.float32)
        b[m.ctx_dim:2 * m.ctx_dim] = 1.0
        tree["peer_encoder"] = LSTMParams(w=w, b=b)
    if cfg.model_family == "fusion":
        from .models.fusion import CONV_GRID, FEATURE_DIM

        rng = np.random.default_rng(seed + 1)

        def glorot(rows, cols):
            lim = np.sqrt(6.0 / (rows + cols))
            return rng.uniform(-lim, lim, size=(rows, cols)).astype(np.float32)

        channels, hid, ctx = 4, max(cfg.model.ctx_dim, 64), cfg.model.ctx_dim
        tree["conv"] = {
            "kernels": (rng.normal(size=(channels, 3, 3)) / 3.0).astype(np.float32),
            "bias": np.zeros(channels, np.float32),
            "head_w": glorot(channels * CONV_GRID[0] * CONV_GRID[1], FEATURE_DIM),
            "head_b": np.zeros(FEATURE_DIM, np.float32),
        }
        tree["feat_proj"] = {"w1": glorot(FEATURE_DIM, hid), "b1": np.zeros(hid, np.float32),
                             "w2": glorot(hid, ctx), "b2": np.zeros(ctx, np.float32)}
    return tree


def serve_bench(
    *, preset: str = "seq2seq-tf-30", batch: int, iters: int, impl: str,
    device, seed: int = 0, peers: int = -1, peer_align: bool = False,
    h_in: Optional[int] = None, h_out: Optional[int] = None,
) -> dict:
    """Time ``iters`` calls of the serve path (normalize → decode →
    denormalize → tile mask) on ``batch`` random viewers, after one warm-up
    call. Weights are :func:`bench_params_np`; the inputs are drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``. A family
    that takes peers (cross_user, transformer) gets ``n_other_users``
    random unit-vector
    peer futures per viewer (``peers`` >= 0 overrides the preset's K), as
    the JAX ``serve-bench`` draws them; ``peer_align`` sets the time-aligned
    peer context (``--peer-align``); ``h_in``/``h_out`` override the
    model's window lengths (``--h-in``/``--h-out``). ``impl`` is JAX's
    name: "fused" the hand-written kernels, "xla" the plain PyTorch path
    (``make_predict_fn(impl="plain")``). The fusion family gets one N(0, 1)
    feature vector of width ``FEATURE_DIM`` per viewer, as
    ``scripts/bench_matrix.py`` draws them. Turns TF32 off for the process
    (``exact_f32_matmul``)."""
    from . import infer
    from .ops.fused_lstm import exact_f32_matmul
    from .params import params_from_numpy

    device = _device(str(device))
    exact_f32_matmul()  # the plain impl in the f32 the kernel computes
    if impl not in SERVE_IMPLS:
        raise ValueError(f"impl must be one of {SERVE_IMPLS}, got {impl!r}")
    cfg = _preset_cfg(argparse.Namespace(preset=preset, peers=peers, peer_align=peer_align,
                                         model_h_in=h_in, model_h_out=h_out))
    params = params_from_numpy(bench_params_np(cfg, seed), device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def unit(*shape):
        v = torch.randn(*shape, 3, generator=gen, device=device)
        return v / v.norm(dim=-1, keepdim=True)

    x = {"past": unit(batch, cfg.model.h_in)}
    if _with_peers(cfg):
        x["other_future"] = unit(batch, cfg.n_other_users, cfg.model.h_out)
    n_features = 0
    if cfg.model_family == "fusion":
        from .models.fusion import FEATURE_DIM

        n_features = FEATURE_DIM
        x["features"] = torch.randn(batch, FEATURE_DIM, generator=gen, device=device)
    serve = infer.make_predict_fn(
        params, cfg, device=device, with_tiles=True, impl="plain" if impl == "xla" else impl
    )
    res = {"preset": preset, "impl": impl, "batch": batch, "iters": iters,
           "horizon": cfg.model.h_out, "peers": cfg.n_other_users if _with_peers(cfg) else 0,
           "features": n_features}
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
    from .datasets import FORMATS

    p = argparse.ArgumentParser(prog="longterm360fov_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("presets", help="list experiment presets")

    pd = sub.add_parser("prepare-data", help="traces → packed windows npz")
    pd.add_argument("--out", required=True)
    pd.add_argument("--traces", help="directory of trace logs (per-video subdirs); synthetic store if omitted")
    pd.add_argument("--dataset-format", default="auto",
                    help="trace layout: auto|tsinghua|quat_wxyz|quat_xyzw|euler_deg|euler_rad")
    pd.add_argument("--h-in", type=int, default=30)
    pd.add_argument("--h-out", type=int, default=30)
    pd.add_argument("--rate-hz", type=float, default=10.0)
    pd.add_argument("--stride", type=int, default=1)
    pd.add_argument("--n-other-users", type=int, default=0)
    pd.add_argument("--n-users", type=int, default=8, help="synthetic only")
    pd.add_argument("--n-videos", type=int, default=2, help="synthetic only")
    pd.add_argument("--n-frames", type=int, default=1200, help="synthetic only")
    pd.add_argument("--features", help="per-video feature npz from extract-features; windows gain "
                    "a 'features' vector for the fusion family")

    xf = sub.add_parser("extract-features",
                        help="equirect video frames → per-frame feature vectors "
                        "(decode → saliency/motion → conv stack)")
    xf.add_argument("--frames-dir", required=True,
                    help="directory of per-video frame sources (<video>.npy/.npz arrays of "
                    "(T,H,W,3) frames, or video files when OpenCV can decode them)")
    xf.add_argument("--out", required=True, help="output npz (one array per video)")
    xf.add_argument("--max-frames", type=int)
    xf.add_argument("--stride", type=int, default=1)
    xf.add_argument("--seed", type=int, default=0, help="conv filter seed (torch.Generator)")
    xf.add_argument("--device", default="cuda", help=DEVICE_HELP)
    sb = sub.add_parser("serve-bench", help="serve-path throughput microbench")
    sb.add_argument("--preset", default="seq2seq-tf-30")
    sb.add_argument("--batch", type=int, default=4096)
    sb.add_argument("--iters", type=int, default=30)
    sb.add_argument(
        "--impl", default="fused", choices=SERVE_IMPLS,
        help="fused = the hand-written CUDA serve kernels (the default: the card's path); "
        "xla = the plain PyTorch path",
    )
    sb.add_argument("--device", default="cuda", help=DEVICE_HELP)
    sb.add_argument("--seed", type=int, default=0)
    sb.add_argument("--peer-align", action="store_true", dest="peer_align")

    tr = sub.add_parser("train", help="train a preset")
    tr.add_argument("--preset", required=True)
    tr.add_argument("--data", help="packed npz from prepare-data; synthetic if omitted")
    tr.add_argument("--steps", type=int)
    tr.add_argument("--batch-size", type=int)
    tr.add_argument("--lr", type=float)
    tr.add_argument("--accum", type=int, help="gradient-accumulation microbatches per step")
    tr.add_argument("--gc-weight", type=float, dest="gc_weight",
                    help="blend weight of the spherical great-circle loss")
    tr.add_argument("--ckpt-dir")
    tr.add_argument("--log-file")
    tr.add_argument("--resume", action="store_true")
    tr.add_argument("--device", default="cuda", help=DEVICE_HELP)
    tr.add_argument("--train-compute", dest="train_compute", choices=["float32", "bfloat16"])
    tr.add_argument("--peer-align", action="store_true", dest="peer_align")
    tr.add_argument("--bf16", action="store_true", help="bfloat16 params (model.param_dtype)")
    tr.add_argument("--data-parallel", action="store_true",
                    help="one rank a process under torchrun / python -m torch.distributed.run, each on "
                    "cuda:LOCAL_RANK (gloo on --device cpu); without a launcher a world of one")
    # JAX train flags not ported yet: each raises, naming its ROADMAP item
    tr.add_argument("--seq-parallel", type=int, default=0)
    tr.add_argument("--pipeline-parallel", type=int, default=0)
    tr.add_argument("--tb-dir", help="TensorBoard scalar log dir (optional; needs the tensorboard package)")

    ev = sub.add_parser("eval", help="evaluate a checkpoint")
    ev.add_argument("--preset", required=True)
    ev.add_argument("--ckpt-dir", required=True)
    ev.add_argument("--data")
    ev.add_argument("--json", action="store_true")
    ev.add_argument("--plot", help="write <PLOT>_curve.png and <PLOT>_traj.png (needs matplotlib)")
    ev.add_argument("--device", default="cuda", help=DEVICE_HELP)
    ev.add_argument("--peer-align", action="store_true", dest="peer_align")

    pr = sub.add_parser(
        "predict",
        help="one-shot offline prediction: each viewer trace's last H_in frames in, predicted "
        "(yaw, pitch) trajectory out, one JSON line per viewer",
    )
    pr.add_argument("--preset", required=True)
    group = pr.add_mutually_exclusive_group(required=True)
    group.add_argument("--ckpt-dir", help="checkpoint directory of `train`")
    group.add_argument("--params", help="flat npz from `export` (the port's or the JAX package's)")
    pr.add_argument("--traces", help="trace dir; synthetic store if omitted")
    pr.add_argument("--dataset-format", default="auto")
    pr.add_argument("--at-frame", type=int, default=None, metavar="N",
                    help="predict from the window ending at frame N (exclusive); default: each trace's "
                    "last frame")
    pr.add_argument("--peers", type=int, default=-1,
                    help="cross-viewer context size K (other viewers of the same video whose frames past "
                    "the window end are known); -1 = the preset's K for peer-consuming families, 0 = none")
    pr.add_argument("--tiles", action="store_true", help="include the unioned prefetch tile set per viewer")
    pr.add_argument("--tile-rows", type=int, default=6)
    pr.add_argument("--tile-cols", type=int, default=12)
    pr.add_argument("--fov", type=float, default=90.0)
    pr.add_argument("--out", help="output JSONL path (default: stdout)")
    pr.add_argument("--impl", default="fused", choices=SERVE_IMPLS,
                    help="fused = the hand-written CUDA serve kernels (the default); xla = the plain "
                    "PyTorch path")
    pr.add_argument("--peer-group", action="store_true",
                    help="group-shared peer serving (peer-consuming families): one peer set per video, the "
                    "first K full-span traces, shared by every viewer of that video "
                    "(serving.make_grouped_serve_fn)")
    pr.add_argument("--device", default="cuda", help=DEVICE_HELP)

    sd = sub.add_parser(
        "serve-daemon",
        help="online prediction server: line-JSON and binary frames over TCP, dynamic batching over "
        "concurrent viewers, per-viewer pose sessions, prefetch tile sets",
    )
    sd.add_argument("--preset", required=True)
    group = sd.add_mutually_exclusive_group(required=True)
    group.add_argument("--ckpt-dir", help="checkpoint directory of `train`")
    group.add_argument("--params", help="flat npz from `export` (the port's or the JAX package's)")
    sd.add_argument("--host", default="127.0.0.1")
    sd.add_argument("--port", type=int, default=8360)
    sd.add_argument("--max-batch", type=int, default=256,
                    help="largest coalesced batch (the bucket ladder caps here)")
    sd.add_argument("--max-wait-ms", type=float, default=2.0, help="how long a lone request waits for co-arrivals")
    sd.add_argument("--pipeline-depth", type=int, default=4,
                    help="batches allowed in flight awaiting device readback (1 = minimal)")
    sd.add_argument("--grouped-warmup", default=None,
                    help="run the grouped bulk path once at these shapes before the socket opens: "
                    "'ROWSxGROUPS[,ROWSxGROUPS...]', e.g. '2048x8,256x4'")
    sd.add_argument("--no-tiles", action="store_true", help="skip prefetch tile sets in responses")
    sd.add_argument("--tile-rows", type=int, default=6)
    sd.add_argument("--tile-cols", type=int, default=12)
    sd.add_argument("--fov", type=float, default=90.0)
    sd.add_argument("--impl", default="auto", choices=("auto", "xla", "fused"),
                    help="auto = fused: the CUDA kernels on the card, their plain versions on the CPU; "
                    "xla = the plain PyTorch path")
    sd.add_argument("--data-parallel", action="store_true",
                    help="shard every dispatch over every visible card of --device cuda (the one device "
                    "of --device cpu); batch buckets start at the card count")
    sd.add_argument("--device", default="cuda", help=DEVICE_HELP)

    ex = sub.add_parser("export", help="checkpoint → flat npz for serving deployments")
    ex.add_argument("--preset", required=True)
    ex.add_argument("--ckpt-dir", required=True)
    ex.add_argument("--out", required=True)
    ex.add_argument("--step", type=int, help="default: latest")

    sv = sub.add_parser("serve", help="streaming-prefetch simulation: hit rate + bandwidth")
    sv.add_argument("--preset", required=True)
    sv.add_argument("--ckpt-dir", required=True)
    sv.add_argument("--data")
    sv.add_argument("--fov", type=float, default=90.0)
    sv.add_argument("--tile-rows", type=int, default=6)
    sv.add_argument("--tile-cols", type=int, default=12)
    sv.add_argument("--device", default="cuda", help=DEVICE_HELP)

    st = sub.add_parser("stream-sim", help="continuous streaming simulation: per-deadline prefetch hit rates")
    st.add_argument("--preset", required=True)
    st.add_argument("--ckpt-dir", required=True)
    st.add_argument("--traces", help="trace dir; synthetic store if omitted")
    st.add_argument("--dataset-format", default="auto")
    st.add_argument("--deadlines", default="1,10,30")
    st.add_argument("--peers", type=int, default=-1,
                    help="cross-viewer context size K in the simulation (peers = other simulated viewers' known "
                    "futures); -1 = the preset's K for peer-consuming families")
    st.add_argument("--fov", type=float, default=90.0)
    st.add_argument("--impl", default="fused", choices=SERVE_IMPLS,
                    help="fused = the hand-written CUDA serve kernels (the default); xla = the plain PyTorch path")
    st.add_argument("--device", default="cuda", help=DEVICE_HELP)

    it = sub.add_parser("inspect-traces",
                        help="sniff a trace directory: per-file layout guess, rate, ranges, quaternion-norm "
                        "sanity (check the dataset adapters before prepare-data)")
    it.add_argument("--traces", required=True)
    it.add_argument("--limit", type=int, default=20, help="max files shown")
    it.add_argument("--validate", action="store_true",
                    help="strict mode: every file must parse unambiguously and pass all sanity checks; exit "
                    "code 2 on any failure")
    it.add_argument("--dataset-format", default="auto", choices=["auto", *sorted(FORMATS)],
                    help="pin the layout instead of sniffing")
    it.add_argument("--rate", type=float, default=10.0, help="resample Hz")

    for cp in (sb, tr, ev, sd, ex, sv):
        cp.add_argument(
            "--peers", type=int, default=-1,
            help="cross-viewer context size K for this run (the params are "
            "K-agnostic); -1 = the preset's K",
        )
    for cp in (pr, sd, ex, sv, st):
        cp.add_argument("--peer-align", action="store_true", dest="peer_align")
    for cp in (sb, tr, ev, pr, sd, ex, sv, st):
        # as in JAX: --h-in/--h-out (like --peer-align) change what the
        # params mean, so they are part of the model hash and every
        # subcommand that builds or loads the model takes them
        cp.add_argument(
            "--h-in", type=int, dest="model_h_in", metavar="T",
            help="override the preset's input-window length (model horizon, not the "
            "prepare-data window flag); part of the model hash — must match between "
            "train and eval/serve",
        )
        cp.add_argument(
            "--h-out", type=int, dest="model_h_out", metavar="T",
            help="override the preset's prediction horizon; part of the model hash — "
            "must match between train and eval/serve",
        )
    return p


def _overrides(args, **over) -> dict:
    """The preset overrides every subcommand shares: ``--peers`` (>= 0)
    sets ``n_other_users``, a data and serving-schema knob that is not part
    of the model hash; ``--peer-align`` sets ``model_peer_align`` (the
    cross_user family's time-aligned peer context) and ``--h-in``/``--h-out``
    set ``model_h_in``/``model_h_out``, all three part of the model hash, as
    the JAX CLI's ``_preset_cfg`` does."""
    if getattr(args, "peer_align", False):
        over["model_peer_align"] = True
    for k in ("model_h_in", "model_h_out"):
        if getattr(args, k, None) is not None:
            over[k] = getattr(args, k)
    # predict and stream-sim keep their own --peers: how many peers to
    # assemble per request, which may differ from the preset's K (the model
    # reads K from the shape)
    if getattr(args, "cmd", None) not in ("predict", "stream-sim") and getattr(args, "peers", -1) >= 0:
        over["n_other_users"] = args.peers
    return over


def _preset_cfg(args, **over):
    """The preset of ``args`` with :func:`_overrides` and ``over``."""
    from .config import get_preset

    return get_preset(args.preset, **_overrides(args, **over))


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}, but torch sees no CUDA device")
    return device


def _open_checkpoint(ckpt_dir, cfg, *, resuming=False):
    """A Checkpointer whose on-disk model hash matches ``cfg`` (else exit:
    the params would be misread); a full-hash mismatch only warns, when
    resuming."""
    from .checkpoint import Checkpointer

    ck = Checkpointer(ckpt_dir, cfg)
    if not ck.check_model_config():
        raise SystemExit(
            f"checkpoint in {ckpt_dir!r} was written for a different model "
            f"architecture/family than preset {cfg.name!r} (model-config "
            f"hash mismatch); evaluating it here would silently "
            f"misinterpret the parameters. Use the preset it was trained "
            f"with."
        )
    if resuming and not ck.check_config():
        print(
            f"warning: resuming in {ckpt_dir!r} with different training "
            f"hyperparameters than the checkpoint was created with "
            f"(config hash mismatch; architecture matches)",
            file=sys.stderr,
        )
    return ck


def _load_or_synth_data(args, cfg):
    """(train, test) window dicts: ``--data`` and its ``_test.npz`` twin
    (else a 90/10 window-index split), or the synthetic store of 8 users,
    2 videos and 1200 frames."""
    from . import data as D
    from . import traces as T

    if getattr(args, "data", None):
        packed = D.load_packed(args.data)
        test_path = os.path.splitext(args.data)[0] + "_test.npz"
        if os.path.exists(test_path):
            return packed, D.load_packed(test_path)
        print(
            f"warning: {test_path} not found; falling back to a 90/10 "
            f"window-index split (boundary windows share frames across "
            f"the cut — prefer prepare-data's paired _test.npz)",
            file=sys.stderr,
        )
        cut = int(len(packed["past"]) * 0.9)
        return ({k: v[:cut] for k, v in packed.items()},
                {k: v[cut:] for k, v in packed.items()})
    store = T.synthetic_store(
        n_users=8, n_videos=2, n_frames=1200, rate_hz=cfg.rate_hz, seed=cfg.seed,
    )
    return D.windows_from_store(
        store, cfg.model.h_in, cfg.model.h_out, stride=cfg.stride,
        n_other_users=cfg.n_other_users
        if cfg.model_family in ("cross_user", "transformer") else 0,
    )


def cmd_presets(_args):
    from .config import PRESETS

    for name, cfg in PRESETS.items():
        m = cfg.model
        print(
            f"{name:<24} family={cfg.model_family:<12} "
            f"h_in={m.h_in} h_out={m.h_out} hidden={m.hidden} layers={m.layers}"
        )


def cmd_prepare_data(args):
    from . import data as D
    from . import traces as T

    if args.traces:
        from . import datasets as DSETS

        store = DSETS.load_dataset(args.traces, fmt=args.dataset_format, rate_hz=args.rate_hz)
        if not len(store):
            raise SystemExit(f"no parseable traces under {args.traces} (format={args.dataset_format})")
    else:
        store = T.synthetic_store(n_users=args.n_users, n_videos=args.n_videos,
                                  n_frames=args.n_frames, rate_hz=args.rate_hz)
    video_features = None
    if args.features:
        with np.load(args.features) as z:
            video_features = {k: z[k] for k in z.files}
        print(f"loaded features for {len(video_features)} videos")
    train_d, test_d = D.windows_from_store(
        store, args.h_in, args.h_out, stride=args.stride, n_other_users=args.n_other_users,
        video_features=video_features,
    )
    span = args.h_in + args.h_out
    for split, d in (("train", train_d), ("test", test_d)):
        if not d:
            raise SystemExit(
                f"zero {split} windows: every trace's {split} segment is shorter than "
                f"h_in+h_out = {span} frames (traces are split 80/20 per trace). Use longer "
                f"traces or a shorter horizon."
            )
    D.save_packed(args.out, train_d)
    test_path = os.path.splitext(args.out)[0] + "_test.npz"
    D.save_packed(test_path, test_d)
    print(f"wrote {len(train_d['past'])} train / {len(test_d['past'])} test windows from "
          f"{len(store)} traces → {args.out}, {test_path}")


def extract_features(frames_dir, *, device, max_frames=None, stride=1, seed=0) -> dict:
    """Every frame source of ``frames_dir`` → {video (the file's stem):
    (T, 128) f32 per-frame features} through
    ``features.equirect.extract_clip_features`` on ``device``, with filters
    from ``torch.Generator().manual_seed(seed)``. Host decode runs one clip
    ahead on a thread (bounded: one decoded clip waits while the device
    works on the other). Undecodable sources are skipped with a note."""
    from concurrent.futures import ThreadPoolExecutor

    from .features import equirect as FE
    from .ops.fused_lstm import exact_f32_matmul

    device = _device(str(device))
    exact_f32_matmul()
    params = FE.init_conv_features(torch.Generator().manual_seed(seed), device=device)

    def decode(fname):
        video = os.path.splitext(fname)[0]
        try:
            frames = FE.decode_frames(os.path.join(frames_dir, fname), max_frames=max_frames,
                                      stride=stride)
        except (RuntimeError, ValueError) as e:
            return video, None, f"skipping {fname}: {e}"
        if frames.size == 0:
            return video, None, f"skipping {fname}: no frames"
        return video, frames, None

    files = [f for f in sorted(os.listdir(frames_dir))
             if os.path.isfile(os.path.join(frames_dir, f))]
    feats = {}
    with ThreadPoolExecutor(max_workers=1) as pool, torch.inference_mode():
        pending = pool.submit(decode, files[0]) if files else None
        for i in range(len(files)):
            video, frames, err = pending.result()
            pending = pool.submit(decode, files[i + 1]) if i + 1 < len(files) else None
            if err:
                print(err)
                continue
            feats[video] = FE.extract_clip_features(params, frames).cpu().numpy()
            print(f"{video}: {frames.shape[0]} frames -> {feats[video].shape}")
    return feats


def cmd_extract_features(args):
    feats = extract_features(args.frames_dir, device=args.device, max_frames=args.max_frames,
                             stride=args.stride, seed=args.seed)
    if not feats:
        raise SystemExit(f"no decodable frame sources in {args.frames_dir}")
    np.savez_compressed(args.out, **feats)
    print(f"wrote {len(feats)} videos -> {args.out}")


def cmd_serve_bench(args):
    print(json.dumps(serve_bench(
        preset=args.preset, batch=args.batch, iters=args.iters,
        impl=args.impl, device=args.device, seed=args.seed, peers=args.peers,
        peer_align=args.peer_align, h_in=args.model_h_in, h_out=args.model_h_out,
    )))


def cmd_train(args):
    from .models import get_family
    from .ops.fused_lstm import exact_f32_matmul

    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"not ported yet: {item}")
    if args.tb_dir:
        try:  # checked before the data and the model are made
            from torch.utils.tensorboard import SummaryWriter  # noqa: F401
        except ImportError:
            raise SystemExit("train --tb-dir needs the tensorboard package, which is not installed") from None
    over = {k: getattr(args, k) for k in ("steps", "batch_size", "lr", "accum", "gc_weight",
                                          "train_compute")
            if getattr(args, k) is not None}
    if args.data_parallel:
        over["data_parallel"] = True
    if args.bf16:  # bf16 params: part of the model hash, so eval refuses the checkpoint, as in JAX
        over["model_param_dtype"] = "bfloat16"
    cfg = _preset_cfg(args, **over)
    fam = get_family(cfg.model_family)
    device = _device(args.device)
    exact_f32_matmul()
    if not cfg.data_parallel:
        _train(args, cfg, fam, device)
        return
    from .parallel import init_multihost, make_mesh
    from .parallel.multihost import local_device

    if device.type == "cuda" and device.index is None:
        device = local_device()  # cuda:{LOCAL_RANK}
    started = init_multihost(device=device)
    try:
        _train(args, cfg, fam, device, make_mesh(device))
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _train(args, cfg, fam, device, mesh=None):
    """``train``'s body on ``device``; with ``mesh`` (``--data-parallel``)
    ``parallel.train_loop_dp`` on this rank, and only rank 0 prints."""
    from . import train as TR

    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    train_d, test_d = _load_or_synth_data(args, cfg)
    h_in, h_out = train_d["past"].shape[1], train_d["future"].shape[1]
    if (h_in, h_out) != (cfg.model.h_in, cfg.model.h_out):
        raise SystemExit(
            f"data windows are {h_in}-in/{h_out}-out but preset "
            f"{cfg.name!r} expects {cfg.model.h_in}-in/{cfg.model.h_out}-out; "
            f"re-run prepare-data with matching --h-in/--h-out"
        )
    if cfg.batch_size > len(train_d["past"]):
        cfg = cfg.replace(batch_size=len(train_d["past"]))
    if cfg.accum > 1 and cfg.batch_size % cfg.accum:
        bs = (cfg.batch_size // cfg.accum) * cfg.accum
        if bs == 0:
            raise SystemExit(f"--accum {cfg.accum} exceeds batch size {cfg.batch_size}")
        say(f"rounding batch_size down to {bs} (multiple of --accum)")
        cfg = cfg.replace(batch_size=bs)
    state = None
    if args.resume and args.ckpt_dir:
        if mesh is not None and mesh.rank:
            mesh.barrier()  # rank 0 opens the directory first: it may write its config.json
        ck = _open_checkpoint(args.ckpt_dir, cfg, resuming=True)
        if mesh is not None and not mesh.rank:
            mesh.barrier()
        if ck.latest_step() is not None:
            fresh = TR.init_state(cfg, fam.init, TR.make_optimizer(cfg), device=device)
            state = ck.restore(fresh)
            say(f"resumed from step {state.step}")
    kw = dict(
        eval_data=test_d or None, log_file=args.log_file, tb_dir=args.tb_dir,
        checkpoint_dir=args.ckpt_dir, state=state,
        extras_fn=getattr(fam, "batch_extras", None),
        fused_tf_fn=getattr(fam, "apply_fused_tf", None),
        fused_ss_fn=getattr(fam, "apply_fused_ss", None),
    )
    if mesh is None:
        state, history = TR.train_loop(cfg, fam.init, fam.apply, train_d, device=device, **kw)
    else:
        from .parallel import train_loop_dp

        state, history = train_loop_dp(cfg, fam.init, fam.apply, train_d, mesh=mesh, **kw)
    if history:
        say(json.dumps(history[-1]))


def cmd_eval(args):
    from . import evaluate as E
    from . import train as TR
    from .models import get_family
    from .ops.fused_lstm import exact_f32_matmul

    if args.plot:
        from .plots import require_matplotlib

        try:  # checked before anything is computed
            require_matplotlib()
        except ImportError as e:
            raise SystemExit(f"eval --plot: {e}") from None
    cfg = _preset_cfg(args)
    fam = get_family(cfg.model_family)
    device = _device(args.device)
    exact_f32_matmul()
    ck = _open_checkpoint(args.ckpt_dir, cfg)
    state = ck.restore(TR.init_state(cfg, fam.init, TR.make_optimizer(cfg), device=device))
    _, test_d = _load_or_synth_data(args, cfg)
    res = E.evaluate(state.params, cfg, test_d, impl="fused")
    if args.plot:
        from . import plots

        curves, pred = eval_plot_series(state.params, cfg, test_d, res, device)
        curve_png = plots.plot_error_by_step(curves, f"{args.plot}_curve.png", rate_hz=cfg.rate_hz)
        traj_png = plots.plot_trajectory(test_d["past"][0], test_d["future"][0], pred,
                                         f"{args.plot}_traj.png", rate_hz=cfg.rate_hz)
        print(f"plots: {curve_png}, {traj_png}", file=sys.stderr)
    if args.json:
        print(json.dumps(res))
    else:
        print(E.comparison_table({cfg.name: res}))


def eval_plot_series(params, cfg, test_d, res, device):
    """What ``eval --plot`` draws, computed on ``device`` where ``params``
    are: ``res`` is ``evaluate``'s result on ``test_d`` → ({name: the error
    curve by step in degrees} of the model and of the persistence baseline,
    the (H_out, 3) prediction of the first test window)."""
    from . import baselines
    from . import evaluate as E
    from . import infer
    from .models import get_family

    fam = get_family(cfg.model_family)
    past = torch.as_tensor(test_d["past"], device=device)
    pers = baselines.persistence(past, cfg.model.h_out).cpu().numpy()
    pers_res = E.evaluate_predictions(pers, test_d["future"])
    pred = infer.predict_batch(params, cfg, fam.apply, {k: v[:1] for k, v in test_d.items() if k != "future"},
                               None, getattr(fam, "batch_extras", None), impl="fused")
    return ({cfg.name: res["error_by_step_deg"], "persistence": pers_res["error_by_step_deg"]},
            pred[0].cpu().numpy())


def _serving_params(args, cfg, fam, device):
    """The params of ``--params`` (an `export` npz) or ``--ckpt-dir`` (the
    latest checkpoint) on ``device``."""
    from . import serving
    from . import train as TR

    if getattr(args, "params", None):
        return serving.load_exported_params(args.params, cfg, fam, device=device)
    ck = _open_checkpoint(args.ckpt_dir, cfg)
    return ck.restore(TR.init_state(cfg, fam.init, TR.make_optimizer(cfg), device=device)).params


def cmd_export(args):
    """Flatten a checkpoint's params into one npz (keys like
    'encoder.0.w', ``serving.flat_param_items``), read on the CPU: serving
    hosts load it with numpy alone, the JAX package's too."""
    from . import train as TR
    from .models import get_family
    from .params import tensor_to_array
    from .serving import flat_param_items

    cfg = _preset_cfg(args)
    fam = get_family(cfg.model_family)
    ck = _open_checkpoint(args.ckpt_dir, cfg)
    state = ck.restore(TR.init_state(cfg, fam.init, TR.make_optimizer(cfg), device="cpu"), step=args.step)
    flat = {k: tensor_to_array(v) for k, v in flat_param_items(state.params)}
    np.savez(args.out, **flat)
    print(
        f"exported {len(flat)} arrays "
        f"({sum(a.nbytes for a in flat.values())/1e6:.2f} MB) → {args.out}"
    )


def cmd_predict(args):
    """One-shot offline prediction: the last H_in observed frames of each
    viewer trace go in; predicted (yaw, pitch) trajectories in degrees, and
    optionally the unioned prefetch tile set, come out as one JSON line per
    viewer, as the JAX ``predict`` writes them. Peer-consuming families
    condition on other viewers' frames past the window end."""
    from . import geometry, infer
    from . import serving as SV
    from .models import get_family
    from .ops.fused_lstm import exact_f32_matmul

    cfg = _preset_cfg(args)
    fam = get_family(cfg.model_family)
    if args.peer_group:
        if cfg.model_family not in ("transformer", "cross_user") or args.peers == 0:
            raise SystemExit(
                "--peer-group is the peer-consuming families' shared-"
                "peer tier; needs a transformer or cross_user preset "
                "and K > 0 peers"
            )
        if args.at_frame is None:
            raise SystemExit(
                "--peer-group requires --at-frame: one shared playback "
                "position defines the per-video peer span"
            )
    device = _device(args.device)
    exact_f32_matmul()
    params = _serving_params(args, cfg, fam, device)
    store = _viewer_store(args, cfg)

    extras = getattr(fam, "batch_extras", None)
    k_peers = args.peers
    if k_peers < 0:
        k_peers = cfg.n_other_users if extras is not None else 0
    h_in, h_out = cfg.model.h_in, cfg.model.h_out
    if args.peer_group and not k_peers:
        raise SystemExit("--peer-group with an effective K of 0 peers")
    impl = "plain" if args.impl == "xla" else "fused"

    rows, pasts, peer_blocks, peer_masks = [], [], [], []
    for tr in store.traces:
        end = args.at_frame if args.at_frame is not None else len(tr.xyz)
        if end < h_in or end > len(tr.xyz):
            print(f"skipping {tr.user}/{tr.video}: window end {end} outside [{h_in}, {len(tr.xyz)}]",
                  file=sys.stderr)
            continue
        pasts.append(tr.xyz[end - h_in:end])
        if k_peers and not args.peer_group:
            peers = np.zeros((k_peers, h_out, 3), np.float32)
            mask = np.zeros((k_peers,), bool)
            got = 0
            for p in store.others(tr):
                if len(p.xyz) >= end + h_out:
                    peers[got] = p.xyz[end:end + h_out]
                    mask[got] = True
                    got += 1
                    if got == k_peers:
                        break
            peer_blocks.append(peers)
            peer_masks.append(mask)
        rows.append({"user": tr.user, "video": tr.video, "frame": end, "t_s": round(end / tr.rate_hz, 3),
                     "rate_hz": tr.rate_hz, "horizon": h_out})
    if not rows:
        raise SystemExit("no trace long enough for a full input window")

    fetch_union = None  # grouped path: horizon-unioned prefetch per row
    tile_mask = None
    if args.peer_group:
        # one peer set per video: the first K full-span traces of the video
        # at --at-frame, one copy of it on the device
        end = args.at_frame
        keys = [r["video"] for r in rows]
        sets, masks = {}, {}
        for video in dict.fromkeys(keys):
            peers = np.zeros((k_peers, h_out, 3), np.float32)
            m = np.zeros((k_peers,), np.float32)
            got = 0
            for tr in store.traces:
                if tr.video != video or len(tr.xyz) < end + h_out:
                    continue
                peers[got] = tr.xyz[end:end + h_out]
                m[got] = 1.0
                got += 1
                if got == k_peers:
                    break
            sets[video], masks[video] = peers, m
        gfn = SV.make_grouped_serve_fn(params, cfg, fam, device=device, with_tiles=args.tiles,
                                       tile_rows=args.tile_rows, tile_cols=args.tile_cols, fov_deg=args.fov,
                                       impl=impl)
        host = SV.grouped_predict(gfn, np.stack(pasts), keys, sets, masks)
        yaw, pitch = np.degrees(host["yaw"]), np.degrees(host["pitch"])
        fetch_union = host.get("prefetch")
        group_used = {v: int(m.sum()) for v, m in masks.items()}
    else:
        batch = {"past": np.stack(pasts)}
        if k_peers:
            batch["other_future"] = np.stack(peer_blocks)
            batch["other_mask"] = np.stack(peer_masks)
        serve = infer.make_predict_fn(params, cfg, device=device, with_tiles=args.tiles,
                                      tile_rows=args.tile_rows, tile_cols=args.tile_cols, fov_deg=args.fov,
                                      impl=impl)
        out = serve(batch)
        xyz, tile_mask = out if args.tiles else (out, None)
        yaw, pitch = geometry.xyz_to_euler(xyz)
        yaw, pitch = np.degrees(yaw.cpu().numpy()), np.degrees(pitch.cpu().numpy())
        tile_mask = None if tile_mask is None else tile_mask.cpu().numpy()

    fh = open(args.out, "w") if args.out else sys.stdout
    try:
        for i, row in enumerate(rows):
            row["yaw_deg"] = [round(float(v), 3) for v in yaw[i]]
            row["pitch_deg"] = [round(float(v), 3) for v in pitch[i]]
            if k_peers:
                row["peers_used"] = (group_used[row["video"]] if args.peer_group
                                     else int(peer_masks[i].sum()))
            fetch = None
            if tile_mask is not None:
                fetch = np.any(tile_mask[i], axis=0)
            elif fetch_union is not None:
                fetch = fetch_union[i]
            if fetch is not None:
                row["prefetch_tiles"] = np.nonzero(fetch)[0].tolist()
                row["grid"] = f"{args.tile_rows}x{args.tile_cols}"
            fh.write(json.dumps(row) + "\n")
    finally:
        if args.out:
            fh.close()
            print(f"wrote {len(rows)} predictions → {args.out}", file=sys.stderr)


def _viewer_store(args, cfg):
    """The viewers of ``predict`` and ``stream-sim``: the logs of
    ``--traces`` (layout ``--dataset-format``) at the preset's rate, else a
    synthetic store of 8 users of one 600-frame video."""
    if args.traces:
        from . import datasets as DSETS

        return DSETS.load_dataset(args.traces, fmt=args.dataset_format, rate_hz=cfg.rate_hz)
    from . import traces as T

    return T.synthetic_store(n_users=8, n_videos=1, n_frames=600, rate_hz=cfg.rate_hz, seed=cfg.seed + 1)


def cmd_serve(args):
    """Streaming-prefetch scoring: decode the test split, build tile
    prefetch sets from the predictions, and report how often the viewer's
    true tile was prefetched against the bandwidth spent, for the model and
    the hold-last baseline. The model serves through the fused route (the
    kernels on the card, their plain versions on the CPU), as
    ``serve-daemon --impl auto``; JAX's ``serve`` runs its XLA path."""
    from . import baselines, infer
    from .models import get_family
    from .ops.fused_lstm import exact_f32_matmul

    cfg = _preset_cfg(args)
    fam = get_family(cfg.model_family)
    device = _device(args.device)
    exact_f32_matmul()
    params = _serving_params(args, cfg, fam, device)
    _, test_d = _load_or_synth_data(args, cfg)
    kw = dict(tile_rows=args.tile_rows, tile_cols=args.tile_cols, fov_deg=args.fov)
    past = torch.as_tensor(test_d["past"], device=device)
    pred = infer.predict_batch(params, cfg, fam.apply, {"past": past}, None, getattr(fam, "batch_extras", None),
                               impl="fused")
    true = torch.as_tensor(test_d["future"], device=device)
    hit, tiles = infer.prefetch_accuracy(pred, true, **kw)
    hit_p, tiles_p = infer.prefetch_accuracy(baselines.persistence(past, cfg.model.h_out), true, **kw)
    print(json.dumps({
        "model_hit_rate": round(float(hit), 4),
        "model_tiles_per_frame": round(float(tiles), 2),
        "persistence_hit_rate": round(float(hit_p), 4),
        "persistence_tiles_per_frame": round(float(tiles_p), 2),
        "n_windows": int(test_d["past"].shape[0]),
        "horizon": cfg.model.h_out,
        "grid": f"{args.tile_rows}x{args.tile_cols}",
        "fov_deg": args.fov,
    }))


def cmd_stream_sim(args):
    """The streaming simulation (``infer.stream_simulation``) over the
    viewers of ``--traces`` or of a synthetic store; one JSON line."""
    from . import infer
    from .models import get_family
    from .ops.fused_lstm import exact_f32_matmul

    cfg = _preset_cfg(args)
    fam = get_family(cfg.model_family)
    device = _device(args.device)
    exact_f32_matmul()
    params = _serving_params(args, cfg, fam, device)
    store = _viewer_store(args, cfg)
    n_peers = args.peers
    if n_peers < 0:  # the preset's K for the families that take peers
        n_peers = cfg.n_other_users if getattr(fam, "batch_extras", None) is not None else 0
    res = infer.stream_simulation(
        params, cfg, [t.xyz for t in store.traces], device=device,
        deadlines=tuple(int(x) for x in args.deadlines.split(",")), fov_deg=args.fov,
        impl="plain" if args.impl == "xla" else "fused", n_peers=n_peers,
    )
    print(json.dumps(res))


def cmd_inspect_traces(args):
    """Report what the dataset adapters would do with each file: parsed
    shape, sniffed layout, rate estimate, column ranges, and quaternion-norm
    and angle-unit checks; ``--validate`` checks every file strictly and
    exits with code 2 on any failure. The output is the JAX
    ``inspect-traces``'s, line for line."""
    import glob

    from . import datasets as DS
    from .native import parse_trace_bytes

    if args.validate:
        res = DS.validate_dataset(args.traces, args.dataset_format, rate_hz=args.rate)
        n_fail = 0
        for rep in res["files"]:
            rel = os.path.relpath(rep["path"], args.traces)
            if rep["errors"]:
                n_fail += 1
                print(f"FAIL {rel} [{rep['fmt'] or '?'}]")
                for e in rep["errors"]:
                    print(f"     error: {e}")
            else:
                extra = f" {rep.get('rate_hz')} Hz" if rep.get("rate_hz") else ""
                print(f"ok   {rel} [{rep['fmt']}] {rep['rows']} rows{extra}")
            for w in rep["warnings"]:
                print(f"     warn: {w}")
        for w in res["dir_warnings"]:
            print(f"warn: {w}")
        total = len(res["files"])
        print(f"{total - n_fail}/{total} files valid" + ("" if res["ok"] else " — VALIDATION FAILED"))
        if not res["ok"]:
            raise SystemExit(2)
        return

    files = [p for p in sorted(glob.glob(os.path.join(args.traces, "**/*.*"), recursive=True)) if os.path.isfile(p)]
    if not files:
        raise SystemExit(f"no files under {args.traces}")
    shown = parsed = 0
    for path in files:
        if shown >= args.limit:
            print(f"... ({len(files) - shown} more files)")
            break
        rel = os.path.relpath(path, args.traces)
        if path.endswith(".json"):
            arr = DS._load_json_trace(path)
            if arr is None:
                print(f"{rel}: unparseable JSON trace")
                shown += 1
                continue
        else:
            try:
                with open(path, "rb") as f:
                    arr = parse_trace_bytes(f.read())
            except (OSError, ValueError) as e:
                print(f"{rel}: unparseable ({e})")
                shown += 1
                continue
        shown += 1
        if arr.shape[0] < 2:
            print(f"{rel}: {arr.shape} — too short to analyze")
            continue
        try:
            fmt = DS.sniff_format(arr)
        except ValueError as e:
            print(f"{rel}: {arr.shape} — {e}")
            continue
        parsed += 1
        spec = DS.FORMATS[fmt]
        ts = arr[:, spec.t_col]
        dt = np.diff(ts)
        dt = dt[dt > 0]
        rate = f"{1.0 / np.median(dt):.1f} Hz" if dt.size else "n/a"
        notes = []
        if spec.kind == "quat":
            qn = np.linalg.norm(arr[:, list(spec.cols)], axis=1)
            notes.append(f"quat |q| in [{qn.min():.3f}, {qn.max():.3f}]")
        else:
            yaw = arr[:, spec.cols[0]]
            notes.append(f"yaw range [{yaw.min():.2f}, {yaw.max():.2f}] ({'deg' if spec.degrees else 'rad'})")
            if not spec.degrees and np.abs(yaw).max() > 1.05 * np.pi:
                notes.append("CAUTION: |yaw| > pi — data may use a [0, 2pi) convention the adapters do not expect")
        if arr.shape[1] >= 5 and spec.kind == "euler":
            # sniffing takes a quaternion layout only with |q| within 0.05 of
            # 1, so a file that fell through here may hold corrupted or
            # unnormalized quaternions: say how close it came
            qn5 = np.linalg.norm(arr[:, 1:5], axis=1)
            extra = ""
            if 0.3 < float(np.median(qn5)) < 3.0:
                extra = (f" (cols 1-4 have |q| median {np.median(qn5):.2f} — "
                         f"possibly non-unit quaternions; renormalize upstream)")
            notes.append("CAUTION: >=5 columns but no unit-quaternion block found; "
                         "the euler guess may be wrong — check --dataset-format" + extra)
        if not np.all(np.diff(ts) >= 0):
            notes.append("WARNING: non-monotonic timestamps")
        print(f"{rel}: {arr.shape[0]} rows x {arr.shape[1]} cols -> format={fmt}, rate~{rate}; " + "; ".join(notes))
    print(f"\n{parsed}/{shown} shown files parse cleanly. If a layout guess "
          f"is wrong, pass prepare-data --dataset-format explicitly.")


def cmd_serve_daemon(args):
    """Online serving: dynamic batching, sessions and tile prefetch over
    TCP (``serving.serve_daemon``), params from a checkpoint or a flat
    `export` npz."""
    from . import serving
    from .models import get_family
    from .ops.fused_lstm import exact_f32_matmul

    gwarm = None
    if args.grouped_warmup:
        # checked before the params load
        try:
            gwarm = [tuple(int(v) for v in part.lower().split("x")) for part in args.grouped_warmup.split(",")]
            if any(len(p) != 2 or p[0] < 1 or p[1] < 1 for p in gwarm):
                raise ValueError
        except ValueError:
            raise SystemExit(
                f"--grouped-warmup wants 'ROWSxGROUPS[,...]' with "
                f"positive integers, got {args.grouped_warmup!r}"
            ) from None
    cfg = _preset_cfg(args)
    fam = get_family(cfg.model_family)
    device = _device(args.device)
    exact_f32_matmul()
    params = _serving_params(args, cfg, fam, device)
    mesh = None
    if args.data_parallel:  # every visible card, or the one CPU device
        mesh = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                if device.type == "cuda" else [device])
    server = serving.serve_daemon(
        params, cfg, fam, device=device, host=args.host, port=args.port, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, with_tiles=not args.no_tiles, tile_rows=args.tile_rows,
        tile_cols=args.tile_cols, fov_deg=args.fov, impl=args.impl, mesh=mesh,
        pipeline_depth=args.pipeline_depth, grouped_warmup=gwarm,
    )
    print(json.dumps({
        "listening": f"{args.host}:{server.server_address[1]}", "preset": cfg.name,
        "h_in": cfg.model.h_in, "h_out": cfg.model.h_out, "extras": sorted(server.batcher.extra_specs),
        "max_batch": args.max_batch,
    }), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
        print(json.dumps(server.batcher.stats()), file=sys.stderr)


def main(argv=None):
    args = _build_parser().parse_args(argv)
    {
        "presets": cmd_presets, "serve-bench": cmd_serve_bench,
        "train": cmd_train, "eval": cmd_eval, "prepare-data": cmd_prepare_data,
        "extract-features": cmd_extract_features, "export": cmd_export,
        "predict": cmd_predict, "serve-daemon": cmd_serve_daemon, "serve": cmd_serve,
        "stream-sim": cmd_stream_sim, "inspect-traces": cmd_inspect_traces,
    }[args.cmd](args)
