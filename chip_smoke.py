"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and fails without one; it never continues on the CPU. Phases,
one line each:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. the build of every kernel source in ``csrc/`` (one nvcc each, started
   together), with its time, registers and spills;
3. each kernel against its plain PyTorch version, at the full width of
   preset ``seq2seq-tf-30`` (hidden 128, 30 + 30 steps), at a batch that is
   not a multiple of the kernels' row tiles, with 1 and 2 layers:
   ``fused_serve``, and the ``lstm_seq_states`` forward, backward-recurrence
   and dW-reduction kernels at B = 4099 and B = 4096 with f32 and bf16
   residuals (the backward fed random upstream gradients);
4. the serving main path: ``serving.make_serve_fn`` behind a
   ``DynamicBatcher`` answers 64 concurrent single-viewer requests and one
   bulk request. Every answer must equal the direct batched call and the
   numpy oracle, and the kernel launch counts, zeroed just before, must have
   advanced;
5. ``serve-bench`` throughput, kernel and plain, at B = 16384 and at
   ``bench.py``'s B = 262144;
6. the training main path: ``train.train_loop`` on ``seq2seq-tf-30`` from
   the synthetic store at B = 4096 with ``train_impl="fused"``: the loss
   falls, logged steps evaluate through ``fused_serve``, a checkpoint is
   written, and a resume from it equals the uninterrupted run; the training
   kernels' launch counts, zeroed just before, must have advanced. Then one
   train step through the kernels against one through plain autograd, from
   the same state on the same batch;
7. train steps/s and windows/s at B = 4096, kernel path against plain path.

Then each kernel alone against its plain version at the main paths' shapes
(``fused_serve`` checked at both serve batches before it is timed), one JSON
line on the kernels (launches in phase 4 or 6, max error over every check,
kernel and plain times, CUDA events), and last the contract line
``{"ok": true, "device": {...}}``. Any failure raises.
"""

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from longterm360fov_tpu_torch import checkpoint, cli, data, oracle, serving, traces, train, windows
from longterm360fov_tpu_torch.config import get_preset
from longterm360fov_tpu_torch.models import get_family
from longterm360fov_tpu_torch.models.cell import LSTMParams
from longterm360fov_tpu_torch.ops import _build, fused_lstm, lstm_train
from longterm360fov_tpu_torch.params import params_from_numpy, tree_leaves

PRESET = "seq2seq-tf-30"
KERNEL_TOL = 1e-4  # kernel vs plain, normalized outputs, f32 after 60 steps
ORACLE_TOL = 1e-4  # batcher answers vs the numpy oracle, unit xyz
# lstm_seq_states kernels vs plain: the forward within 1e-5 absolute with f32
# residuals (exact f32 FMAs in another order); with bf16 residuals the same
# f32 values round to bf16, and a 1e-7 difference may cross a rounding
# boundary, so within one bf16 step (at most 2^-7 of the value). The backward, fed
# the same residuals, within 1e-4 of max|plain| per output: dW sums
# B·T = 122,970 terms in another order.
FWD_TOL = 1e-5
BWD_REL_TOL = 1e-4
TRAIN_B = 4096  # the batch scripts/bench_train.py trains seq2seq-tf-30 at
LSTM_SRC = "longterm360fov_tpu_torch/csrc/lstm_train.cu"
KERNELS = [
    {
        "name": "fused_serve",
        "route": "cuda",
        "source": "longterm360fov_tpu_torch/csrc/fused_serve.cu",
        "replaces": "longterm360fov_tpu/ops/fused_lstm.py:503",
        "wrapper": fused_lstm.fused_serve,
    },
    {
        "name": "lstm_seq_states_fwd",
        "route": "cuda",
        "source": LSTM_SRC,
        "replaces": "longterm360fov_tpu/ops/lstm_train.py:172",
        "wrapper": lstm_train.lstm_fwd,
    },
    {
        "name": "lstm_seq_states_bwd",
        "route": "cuda",
        "source": LSTM_SRC,
        "replaces": "longterm360fov_tpu/ops/lstm_train.py:396",
        "wrapper": lstm_train.lstm_bwd,
    },
    {
        "name": "lstm_seq_states_dw",
        "route": "cuda",
        "source": LSTM_SRC,
        "replaces": "longterm360fov_tpu/ops/lstm_train.py:396",
        "wrapper": lstm_train.lstm_dw,
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


def lstm_case(dev, batch, layers, seed, t=30, d=3, h=128):
    """Random full-width weights (Glorot-uniform, small biases), inputs,
    initial states and upstream gradients from a numpy seed."""
    rng = np.random.default_rng(seed)
    ps = []
    for l in range(layers):
        fan = (d if l == 0 else h) + h
        lim = np.sqrt(6 / (fan + 4 * h))
        ps.append(LSTMParams(
            torch.tensor(rng.uniform(-lim, lim, size=(fan, 4 * h)).astype(np.float32), device=dev),
            torch.tensor(rng.normal(size=4 * h).astype(np.float32) * 0.1, device=dev)))
    ts = [torch.tensor(rng.normal(size=s).astype(np.float32) * sc, device=dev)
          for s, sc in (((batch, t, d), 0.3), ((layers, batch, h), 0.3), ((layers, batch, h), 0.3),
                        ((batch, t, h), 1.0), ((layers, batch, h), 1.0), ((layers, batch, h), 1.0))]
    return ps, ts[:3], ts[3:]


def check_lstm_kernels(dev, batch, layers, rd, seed):
    """The three lstm_seq_states kernels against their plain versions on the
    same inputs → max abs error of each; raises past the tolerances."""
    ps, (xs, h0, c0), up = lstm_case(dev, batch, layers, seed)
    res = lstm_train.lstm_fwd(ps, xs, h0, c0, rd)
    ref = lstm_train._forward_reference(ps, xs, h0, c0, rd)
    torch.cuda.synchronize()
    fwd = 0.0
    for a, b in zip(res.hs + res.cs + res.gs, ref.hs + ref.cs + ref.gs):
        diff = (a.float() - b.float()).abs()
        tol = FWD_TOL if rd == torch.float32 else FWD_TOL + 2.0 ** -7 * b.float().abs()
        if a.shape != b.shape or not torch.isfinite(a.float()).all() or not (diff <= tol).all():
            raise AssertionError(f"lstm_fwd disagrees with its plain version (B={batch}, L={layers}, {rd})")
        fwd = max(fwd, diff.max().item())
    dg, dxs, dh0, dc0 = lstm_train.lstm_bwd(ps, c0, res, *up)
    dg_p, dxs_p, dh0_p, dc0_p = lstm_train._bwd_recurrence_reference(ps, c0, res, *up)
    dps = lstm_train.lstm_dw(ps, xs, h0, res, dg_p)
    dps_p = lstm_train._dw_reference(ps, xs, h0, res, dg_p)
    torch.cuda.synchronize()
    errs = {"fwd": fwd, "bwd": 0.0, "dw": 0.0}
    for kind, pairs in (
        ("bwd", list(zip(dg, dg_p)) + [(dxs, dxs_p), (dh0, dh0_p), (dc0, dc0_p)]),
        ("dw", [(a.w, b.w) for a, b in zip(dps, dps_p)] + [(a.b, b.b) for a, b in zip(dps, dps_p)]),
    ):
        for a, b in pairs:
            diff = (a - b).abs().max().item()
            if not torch.isfinite(a).all() or not diff <= BWD_REL_TOL * b.abs().max().item():
                raise AssertionError(f"lstm {kind} disagrees with its plain version (B={batch}, L={layers}, {rd})")
            errs[kind] = max(errs[kind], diff)
    return errs


def drive_training(dev, fam):
    """Phase 6: train_loop through the kernels, checkpoint and resume, and
    one step through the kernels against one through plain autograd."""
    cfg = get_preset(PRESET, batch_size=TRAIN_B, steps=40, eval_every=10, ckpt_every=20,
                     train_impl="fused")
    store = traces.synthetic_store(n_users=8, n_videos=2, n_frames=1200, rate_hz=cfg.rate_hz, seed=cfg.seed)
    train_d, test_d = data.windows_from_store(store, cfg.model.h_in, cfg.model.h_out)
    run = dict(device=dev, eval_data=test_d, fused_tf_fn=fam.apply_fused_tf)
    for k in KERNELS:
        k["wrapper"].launches = 0
    full, hist = train.train_loop(cfg, fam.init, fam.apply, train_d, **run)
    torch.cuda.synchronize()
    launches = {k["name"]: k["wrapper"].launches for k in KERNELS}
    print(f"training: {len(train_d['past'])} train / {len(test_d['past'])} test windows, "
          f"B={cfg.batch_size}, {cfg.steps} steps; logged "
          f"{json.dumps([{k: m[k] for k in ('step', 'loss', 'eval_great_circle_deg')} for m in hist])}; "
          f"launches {json.dumps(launches)}", flush=True)
    losses = [m["loss"] for m in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the training loss did not fall: {losses}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the training path never launched kernel {name}")

    with tempfile.TemporaryDirectory() as ck_dir:
        train.train_loop(cfg.replace(steps=20), fam.init, fam.apply, train_d,
                         checkpoint_dir=ck_dir, **run)
        ck = checkpoint.Checkpointer(ck_dir, cfg)
        opt = train.make_optimizer(cfg)
        restored = ck.restore(train.init_state(cfg, fam.init, opt, device=dev))
        resumed, _ = train.train_loop(cfg, fam.init, fam.apply, train_d, state=restored, **run)
    d_resume = max((a - b).abs().max().item()
                   for a, b in zip(tree_leaves(full.params), tree_leaves(resumed.params)))
    print(f"resume: checkpoint at step {restored.step}, resumed to step {resumed.step}; "
          f"max |params - uninterrupted| {d_resume:.3e} (tolerance 1e-6)", flush=True)
    if resumed.step != cfg.steps or not d_resume <= 1e-6:
        raise AssertionError("the resumed run differs from the uninterrupted one")

    # one step, kernels against plain autograd ("xla"), from the trained
    # state on the next batch: loss and gradients (f32 residuals tight;
    # bf16 residuals, the main path's default, at the JAX suite's 2e-2
    # bound), then the params after the update
    batch = next(train.batch_iterator(train_d, cfg.batch_size, seed=1))
    plain = cfg.replace(train_impl="xla")
    (l_p, _), g_p = train.make_grad_fn(plain, fam.apply)(full.params, batch)
    res_one = {}
    for rd, rel in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        fused_fn = lambda *a, rd=rd, **kw: fam.apply_fused_tf(*a, residual_dtype=rd, **kw)  # noqa: E731
        (l_k, _), g_k = train.make_grad_fn(cfg, fam.apply, fused_tf_fn=fused_fn)(full.params, batch)
        g_err = max((a - b).abs().max().item() / b.abs().max().item()
                    for a, b in zip(tree_leaves(g_k), tree_leaves(g_p)))
        l_err = abs(l_k.item() - l_p.item()) / abs(l_p.item())
        if not (g_err <= rel and l_err <= rel):
            raise AssertionError(f"train step through the kernels ({rd}) differs from plain: "
                                 f"loss {l_err:.2e}, grads {g_err:.2e} (tolerance {rel})")
        res_one[str(rd)[6:]] = {"loss_rel": l_err, "grad_rel": g_err}
    opt = train.make_optimizer(cfg)
    k_state, _ = train.make_train_step(cfg, fam.apply, opt, fused_tf_fn=fam.apply_fused_tf)(full, batch)
    p_state, _ = train.make_train_step(plain, fam.apply, opt)(full, batch)
    d_param = max((a - b).abs().max().item()
                  for a, b in zip(tree_leaves(k_state.params), tree_leaves(p_state.params)))
    print(f"one step, kernels vs plain autograd: {json.dumps(res_one)}; max |params after, "
          f"bf16 residuals - plain| {d_param:.3e} (tolerance 0.1·lr = {0.1 * cfg.lr:.0e})", flush=True)
    if not d_param <= 0.1 * cfg.lr:
        raise AssertionError("params after one step through the kernels differ from plain")
    return cfg, full, train_d, launches


def time_training(fam, cfg, state, train_d, smi):
    """Phase 7: the fast train step (the loop's step between logged steps),
    kernels against plain autograd, in turns plain, kernel, kernel, plain."""
    batch = next(train.batch_iterator(train_d, cfg.batch_size, seed=2))
    opt = train.make_optimizer(cfg)
    steps = {
        "kernel": train.make_train_step(cfg, fam.apply, opt, gc_metric=False,
                                        fused_tf_fn=fam.apply_fused_tf),
        "plain": train.make_train_step(cfg.replace(train_impl="xla"), fam.apply, opt, gc_metric=False),
    }
    iters = {"kernel": 20, "plain": 5}
    ms = {"kernel": 0.0, "plain": 0.0}
    for which in ("plain", "kernel", "kernel", "plain"):
        st = [state]

        def one():
            st[0] = steps[which](st[0], batch)[0]

        ms[which] += cuda_ms(one, iters[which]) / 2
    out = {w: {"ms_per_step": ms[w], "steps_per_sec": 1e3 / ms[w],
               "windows_per_sec": cfg.batch_size * 1e3 / ms[w]} for w in ms}
    print(f"train step (B={cfg.batch_size}, fast step, CUDA events, {smi}): {json.dumps(out)}", flush=True)


def time_lstm_kernels(dev, smi):
    """Each training kernel alone against its plain version at the main
    path's shapes (B = 4096, T = 30, D = 3, H = 128, one layer, bf16
    residuals), in turns plain, kernel, kernel, plain."""
    ps, (xs, h0, c0), up = lstm_case(dev, TRAIN_B, 1, seed=3)
    rd = torch.bfloat16
    res = lstm_train.lstm_fwd(ps, xs, h0, c0, rd)
    dg = lstm_train.lstm_bwd(ps, c0, res, *up)[0]
    calls = {
        "lstm_seq_states_fwd": (lambda: lstm_train.lstm_fwd(ps, xs, h0, c0, rd),
                                lambda: lstm_train._forward_reference(ps, xs, h0, c0, rd)),
        "lstm_seq_states_bwd": (lambda: lstm_train.lstm_bwd(ps, c0, res, *up),
                                lambda: lstm_train._bwd_recurrence_reference(ps, c0, res, *up)),
        "lstm_seq_states_dw": (lambda: lstm_train.lstm_dw(ps, xs, h0, res, dg),
                               lambda: lstm_train._dw_reference(ps, xs, h0, res, dg)),
    }
    out = {}
    for name, (kernel, plain) in calls.items():
        t = {"plain": 0.0, "kernel": 0.0}
        for which in ("plain", "kernel", "kernel", "plain"):
            t[which] += cuda_ms(kernel if which == "kernel" else plain, 10 if which == "kernel" else 3) / 2
        out[name] = t
    print(f"training kernels alone (ms, B={TRAIN_B}, L=1, bf16 residuals, CUDA events, {smi}): "
          f"{json.dumps(out)}", flush=True)
    return out


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

    # 2. build every kernel source, one nvcc each, started together
    sources = ("fused_serve", "lstm_train")
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        builds = dict(zip(sources, pool.map(_build.build, sources)))
    for name, b in builds.items():
        regs = " ".join(ln.strip() for ln in b.log.splitlines() if "registers" in ln or "spill" in ln)
        print(f"build: {name}.cu by nvcc in {b.seconds:.2f} s ({b.path.name}) {regs}", flush=True)

    # 3. kernel vs plain at full width
    errs = {f"layers={l}": check_kernel(cfg, dev, 4099, l, seed=l) for l in (1, 2)}
    max_err = max(errs.values())
    print(f"kernel vs plain, B=4099, hidden {cfg.model.hidden}, {cfg.model.h_in}+{cfg.model.h_out} steps: "
          f"max_abs_err {json.dumps(errs)} (tolerance {KERNEL_TOL})", flush=True)
    if not max_err <= KERNEL_TOL:
        raise AssertionError(f"kernel disagrees with its plain version: {errs}")
    lstm_errs = {}
    for batch in (4099, TRAIN_B):
        for layers in (1, 2):
            for rd in (torch.float32, torch.bfloat16):
                key = f"B={batch} L={layers} {str(rd)[6:]}"
                lstm_errs[key] = check_lstm_kernels(dev, batch, layers, rd, seed=layers)
    print(f"lstm_seq_states kernels vs plain, hidden 128, T=30, max_abs_err "
          f"{json.dumps(lstm_errs)} (forward {FWD_TOL}, one bf16 step with bf16 residuals; "
          f"backward {BWD_REL_TOL} of max|plain|)", flush=True)

    # 4. main path: batcher → make_serve_fn → fused kernel
    params_np = oracle.init_params_np(0, cfg.model)
    params = params_from_numpy(params_np, dev)
    serve_kernels = KERNELS[:1]
    for k in KERNELS:
        k["wrapper"].launches = 0
    drive_main_path(cfg, fam, dev, params_np, params)
    launches = {k["name"]: k["wrapper"].launches for k in serve_kernels}
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
    # 6. the training main path; 7. its speed; the training kernels alone
    tcfg, trained, train_d, train_launches = drive_training(dev, fam)
    time_training(fam, tcfg, trained, train_d, smi)
    lstm_alone = time_lstm_kernels(dev, smi)

    out = {"kernels": [
        {**{k: v for k, v in KERNELS[0].items() if k != "wrapper"},
         "launches": launches["fused_serve"], "max_abs_err": max(errs.values()),
         "ms": alone[262144]["kernel"], "plain_ms": alone[262144]["plain"]},
    ] + [
        {**{k: v for k, v in kern.items() if k != "wrapper"},
         "launches": train_launches[kern["name"]],
         "max_abs_err": max(e[kern["name"].rsplit("_", 1)[1]] for e in lstm_errs.values()),
         "ms": lstm_alone[kern["name"]]["kernel"], "plain_ms": lstm_alone[kern["name"]]["plain"]}
        for kern in KERNELS[1:]
    ]}
    print(json.dumps(out), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    t0 = time.time()
    main()
    print(f"chip_smoke: {time.time() - t0:.1f} s", file=sys.stderr)
