"""Probe of the PyTorch port's training recurrences on the tensor cores
on one NVIDIA card: the scheduled-sampling decoder backward
(``ops.lstm_ss.ss_bwd``, the static context of row 6, and
``ops.lstm_align.dec_bwd``, the per-step context of row 7;
``csrc/lstm_common.cuh`` ss_bwd_kernel), its teacher-forced mode, row 5's
backward (``ops.lstm_train.lstm_bwd``; ``csrc/lstm_train.cu``), the
training forwards in the same three modes (``ops.lstm_train.lstm_fwd``,
``ops.lstm_ss.ss_fwd``, ``ops.lstm_align.dec_fwd``; ``csrc/lstm_common.cuh``
train_fwd_kernel) and the lockstep peer forward
(``ops.lstm_align.peer_fwd``; ``csrc/lstm_align.cu`` on ``lstm_mma.cuh``'s
encoder).

Run from the root of a checkout: ``python3 scripts/torch_align_train_probe.py``.
``--checkout DIR`` imports the port (and its ``chip_smoke.py``) from another
checkout instead, such as an unpacked older commit; ``--self-only`` then
skips what that checkout may lack (the SASS report and the probe build);
``--skip-checks`` skips 2.; ``--widths-plain`` only times the backwards at
hidden 256 and 8 layers beside their plain versions and cuDNN's backward
data; ``--widths`` only times the widths and depths
(the end of 3.); ``--steps`` only times the train steps (5.). One
process a checkout, so that a call can run parent, change, change, parent.
Prints, on the card it finds (it fails without one):

1. the card's name and power limit; each build's registers and spills;
   unless ``--self-only``, every instance of both kernels with its
   registers, spills, shared memory and ``HMMA`` count
   (``chip_smoke.report_train_mma``) and the serve kernels' of
   ``csrc/fused_serve.cu``, whose peer context shares the peer forward's
   body (``chip_smoke.report_lstm_mma``);
2. the kernels against their plain versions at the card tests' shapes, in
   both compute types and residual types: the largest gap of each output
   relative to max|plain| (the backwards' f32 gate 1e-4; the forwards'
   absolute, gate 1e-5), whether a repeat is bit-equal, and whether a
   permuted batch gives the permuted answer bit for bit; the training
   forwards and backwards also at hidden 256 and at 8 layers;
3. times, CUDA events, in turns (``chip_smoke.in_turns``) within the
   process, on bf16 residuals: the decoder backward at
   ``stacked-ss-crossuser-10s``'s shape (B = 4096, T = 100, L = 2, C = 128,
   per step) and at row 6's (B = 4096, T = 30, L = 2, static C = 128 and
   64), the peer forward at B = 4096, K = 7, T = 100, C = 128, and the
   serve tier's peer context at the same shape (the body they share), each
   in f32 and bf16 compute; row 5's backward at the 10 s encoder's shape
   (B = 4096, T = 100, L = 2, on the f32 residuals it trains with; cuDNN's
   backward data in f32 beside it) and at ``seq2seq-tf-30``'s (B = 4096,
   T = 30, L = 1, bf16 residuals), in both compute types; and the three
   forwards alone at the same shapes (the decoder's at the 10 s and row 6
   shapes, row 5's at the 10 s encoder's, cuDNN's f32 forward beside it,
   and at ``seq2seq-tf-30``'s), in both compute types; then the widths and
   depths the backwards take again (hidden 256, L = 2, and 8 layers of
   hidden 128 at B = 4096: row 5's forward and backward at T = 100, the
   decoder's at T = 30 with a static context of 128), and 3 and 4 layers of
   hidden 128 (the backward's 32-row blocks with a W ring of 2 in f32 at 3
   layers and in bf16 at 4), where the checkout's choosers take them
   ("refused" where they do not);
4. unless ``--self-only``: the time split of the probe builds
   (``-DSSB_PROBE`` and ``-DLSTM_PROBE``: thread 0 of every block adds its
   ``clock64`` deltas a part, ``SsbPart`` and ``LstmPart`` order) of the
   decoder backward and forward and of row 5's at the 10 s shapes in both
   compute types;
5. with ``--steps`` only: the train step (CUDA events, the batch's copy to
   the card included) of ``stacked-ss-crossuser-10s``,
   ``stacked-ss-crossuser`` and ``seq2seq-tf-30`` at B = 4096 in f32 and
   bf16 compute, and a profile of the 10 s steps' device time by kernel.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PARTS = ("loads and above", "cell", "barriers", "products", "epilogue")  # SsbPart
FWD_PARTS = ("x and ctx staging", "products", "cell and residual stores", "publish", "barriers", "feedback",
             "states")  # LstmPart
F32, BF = torch.float32, torch.bfloat16


def rel_gaps(outs, refs):
    return [round((x - y).abs().max().item() / max(y.abs().max().item(), 1e-30), 9)
            for x, y in zip(outs, refs) if x is not None]


def abs_gaps(outs, refs):
    return [round((x.float() - y.float()).abs().max().item(), 9) for x, y in zip(outs, refs)]


def tag(rd, cd):
    return f"{str(rd)[6:]} residuals, {str(cd)[6:]} compute"


def check_bwd(chip_smoke, dev, lstm_align, lstm_ss):
    """2. for the decoder backward: both instances against the plain
    version, repeats, a permuted batch."""
    out = {}
    cases = [(4099, 2, 128, False, 30, "bernoulli"), (257, 3, 128, False, 30, "bernoulli"),
             (1, 1, 0, False, 30, "1"), (513, 2, 64, False, 30, "0"), (67, 2, 128, True, 100, "bernoulli"),
             (1000, 2, 32, True, 30, "1"), (301, 1, 96, True, 30, "0")]
    for batch, layers, c, step, t, coins in cases:
        ps, a = chip_smoke.ss_case(dev, batch, layers, c, coins, seed=batch + c, t=t)
        ctx = None if not c else (torch.randn((batch, t, c), device=dev) * 0.5 if step else a["ctx"])
        fwd = (ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"], ctx)
        for rd in (F32, BF):
            res = lstm_ss._forward_reference(*fwd, rd)[1]
            args = (ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], c)
            kern = lstm_align.dec_bwd if step else lstm_ss.ss_bwd
            for cd in (F32, BF):
                got = kern(*args, cd)
                again = kern(*args, cd)
                ref = lstm_ss._bwd_recurrence_reference(*args, step_ctx=step, compute_dtype=cd)
                flat = lambda o: [*o[0], *o[1:]]  # noqa: E731
                r = {"rel_gap": rel_gaps(flat(got), flat(ref)),
                     "repeat_bit_equal": all(torch.equal(x, y) for x, y in zip(flat(got), flat(again))
                                             if x is not None)}
                out[f"{'dec_bwd' if step else 'ss_bwd'} B={batch} L={layers} C={c} T={t} coins {coins} "
                    f"{tag(rd, cd)}"] = r
    # a permuted batch: the permuted answer, bit for bit
    batch, t = 300, 30
    ps, a = chip_smoke.ss_case(dev, batch, 2, 128, "bernoulli", seed=8, t=t)
    perm = torch.randperm(batch, generator=torch.Generator().manual_seed(0)).to(dev)
    ctx = torch.randn((batch, t, 128), device=dev)
    fwd = (ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"], ctx)
    res = lstm_ss._forward_reference(*fwd, BF)[1]
    res_p = type(res)(*[[x[perm] for x in part] for part in res])
    for cd in (F32, BF):
        full = lstm_align.dec_bwd(ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], 128, cd)
        cut = lstm_align.dec_bwd(ps, a["proj_w"], a["c0"][:, perm], a["coins"][:, perm], res_p, a["dys"][perm], 128,
                                 cd)
        same = all(torch.equal(x[perm], y) for x, y in zip(full[0], cut[0]))
        same &= torch.equal(full[1][perm], cut[1]) and torch.equal(full[2][:, perm], cut[2])
        same &= torch.equal(full[4][:, perm], cut[4]) and torch.equal(full[6][perm], cut[6])
        out[f"dec_bwd permuted batch B={batch} {tag(BF, cd)}"] = {"bit_equal": same}
    return out


def check_tf_bwd(chip_smoke, dev, lstm_train):
    """2. for row 5's backward (ss_bwd_kernel's teacher-forced mode), fed
    the forward kernel's residuals and random dhs_top, dhT, dcT."""
    out = {}
    cases = [(4099, 1, 3, 30, 128), (300, 2, 3, 100, 128), (1031, 1, 3, 30, 128), (300, 1, 3, 30, 64),
             (257, 2, 67, 30, 128), (257, 2, 131, 30, 128), (65, 3, 3, 12, 128), (33, 1, 9, 12, 32)]
    for batch, layers, d, t, h in cases:
        ps, (xs, h0, c0), up = chip_smoke.lstm_case(dev, batch, layers, seed=batch + d, t=t, d=d, h=h)
        perm = torch.randperm(batch, generator=torch.Generator().manual_seed(0)).to(dev)
        for rd in (F32, BF):
            res = lstm_train.lstm_fwd(ps, xs, h0, c0, rd)
            res_p = type(res)(*[[x[perm] for x in part] for part in res])
            for cd in (F32, BF):
                got = lstm_train.lstm_bwd(ps, c0, res, *up, compute_dtype=cd)
                again = lstm_train.lstm_bwd(ps, c0, res, *up, compute_dtype=cd)
                cut = lstm_train.lstm_bwd(ps, c0[:, perm], res_p, up[0][perm], up[1][:, perm], up[2][:, perm],
                                          compute_dtype=cd)
                ref = lstm_train._bwd_recurrence_reference(ps, c0, res, *up, cd)
                flat = lambda o: [*o[0], *o[1:]]  # noqa: E731
                moved = [*[g[perm] for g in got[0]], got[1][perm], got[2][:, perm], got[3][:, perm]]
                out[f"lstm_bwd B={batch} L={layers} D={d} T={t} H={h} {tag(rd, cd)}"] = {
                    "rel_gap": rel_gaps(flat(got), flat(ref)),
                    "repeat_bit_equal": all(torch.equal(x, y) for x, y in zip(flat(got), flat(again))),
                    "permuted_bit_equal": all(torch.equal(x, y) for x, y in zip(moved, flat(cut)))}
    return out


def check_fwd(chip_smoke, dev, lstm_align):
    """2. for the peer forward."""
    out = {}
    for batch, k, t, c in ((67, 7, 100, 128), (4099, 7, 30, 128), (13, 1, 20, 128), (257, 8, 30, 64),
                           (301, 4, 30, 32), (100, 3, 30, 96)):
        ps, a = chip_smoke.aligned_case(dev, batch, 1, k, "1", seed=batch + k, t=t)
        peer = chip_smoke.stack(np.random.default_rng(c), dev, 3, 1, c)[0]
        for rd in (F32, BF):
            for cd in (F32, BF):
                got = lstm_align.peer_fwd(peer, a["pxs"], a["pwt"], rd, cd)
                again = lstm_align.peer_fwd(peer, a["pxs"], a["pwt"], rd, cd)
                ref = lstm_align._peer_fwd_reference(peer, a["pxs"], a["pwt"], rd, cd)
                out[f"peer_fwd B={batch} K={k} T={t} C={c} {tag(rd, cd)}"] = {
                    "abs_gap": abs_gaps(got, ref), "repeat_bit_equal": all(map(torch.equal, got, again))}
    return out


def check_train_fwd(chip_smoke, dev, lstm_train, lstm_ss, lstm_align):
    """2. for the training forwards: each against its plain version (the
    largest absolute gap over ys and the residuals), repeats; the backward
    fed the kernel's residuals (relative gap), at hidden 256 and 8 layers
    too."""
    out = {}
    for batch, layers, d, t, h in ((4099, 1, 3, 30, 128), (300, 2, 3, 100, 128), (257, 2, 131, 30, 128),
                                   (100, 2, 3, 8, 256), (65, 8, 3, 6, 128)):
        ps, (xs, h0, c0), up = chip_smoke.lstm_case(dev, batch, layers, seed=batch + d, t=t, d=d, h=h)
        for rd in (F32, BF):
            for cd in (F32, BF):
                got = lstm_train.lstm_fwd(ps, xs, h0, c0, rd, cd)
                again = lstm_train.lstm_fwd(ps, xs, h0, c0, rd, cd)
                ref = lstm_train._forward_reference(ps, xs, h0, c0, rd, cd)
                flat = lambda r: [*r.hs, *r.cs, *r.gs]  # noqa: E731
                bw = lstm_train.lstm_bwd(ps, c0, got, *up, compute_dtype=cd)
                bref = lstm_train._bwd_recurrence_reference(ps, c0, got, *up, cd)
                out[f"lstm_fwd B={batch} L={layers} D={d} T={t} H={h} {tag(rd, cd)}"] = {
                    "abs_gap": max(abs_gaps(flat(got), flat(ref))),
                    "repeat_bit_equal": all(map(torch.equal, flat(got), flat(again))),
                    "bwd_rel_gap": max(rel_gaps([*bw[0], *bw[1:]], [*bref[0], *bref[1:]]))}
    for batch, layers, c, step, t, h in ((4099, 2, 128, False, 30, 128), (4099, 2, 64, False, 30, 128),
                                         (300, 2, 128, True, 100, 128), (100, 2, 128, False, 8, 256),
                                         (100, 2, 128, True, 8, 256), (65, 8, 128, True, 6, 128)):
        rng = np.random.default_rng(batch + c)
        ps, a = chip_smoke.ss_case(dev, batch, layers, c, "bernoulli", seed=batch + c, t=t, h=h)
        ctx = torch.tensor(rng.normal(size=(batch, t, c)).astype(np.float32) * 0.5, device=dev) if step else a["ctx"]
        fwd = (ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"], ctx)
        kern, bkern = (lstm_align.dec_fwd, lstm_align.dec_bwd) if step else (lstm_ss.ss_fwd, lstm_ss.ss_bwd)
        for rd in (F32, BF):
            for cd in (F32, BF):
                ys, res = kern(*fwd, rd, cd)
                ys2, res2 = kern(*fwd, rd, cd)
                yr, rr = lstm_ss._forward_reference(*fwd, rd, cd)
                flat = lambda y, r: [y, *r.hs, *r.cs, *r.gs]  # noqa: E731
                bargs = (ps, a["proj_w"], a["c0"], a["coins"], res, a["dys"], c)
                bw = bkern(*bargs, cd)
                bref = lstm_ss._bwd_recurrence_reference(*bargs, step_ctx=step, compute_dtype=cd)
                out[f"{'dec_fwd' if step else 'ss_fwd'} B={batch} L={layers} C={c} T={t} H={h} {tag(rd, cd)}"] = {
                    "abs_gap": max(abs_gaps(flat(ys, res), flat(yr, rr))),
                    "repeat_bit_equal": all(map(torch.equal, flat(ys, res), flat(ys2, res2))),
                    "bwd_rel_gap": max(rel_gaps([*bw[0], *bw[1:]], [*bref[0], *bref[1:]]))}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose port to import")
    ap.add_argument("--self-only", action="store_true", help="skip the SASS report and the probe build")
    ap.add_argument("--skip-checks", action="store_true", help="skip the checks against the plain versions")
    ap.add_argument("--widths", action="store_true", help="only time the widths and depths")
    ap.add_argument("--widths-plain", action="store_true",
                    help="only the widest and deepest backwards beside their plain versions and cuDNN")
    ap.add_argument("--steps", action="store_true", help="only time the train steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device; this probe runs only on the card")
    sys.path.insert(0, args.checkout)
    import chip_smoke
    from longterm360fov_tpu_torch.ops import _build, fused_lstm, lstm_align, lstm_ss, lstm_train

    fused_lstm.exact_f32_matmul()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; port from {args.checkout}", flush=True)
    dev = torch.device("cuda:0")
    if args.steps:
        return time_steps(chip_smoke, dev, smi)
    if args.widths:
        return time_widths(chip_smoke, dev, smi, lstm_train, lstm_ss)
    if args.widths_plain:
        return time_widths_plain(chip_smoke, dev, smi, lstm_train, lstm_ss)
    with ThreadPoolExecutor(max_workers=8) as pool:  # one nvcc each, started together
        jobs = {name: pool.submit(_build.build, name) for name in ("lstm_ss", "lstm_align", "fused_serve",
                                                                    "lstm_train")}
        if not args.self_only:
            jobs["probe"] = pool.submit(_build.build, "lstm_align", ("SSB_PROBE",))
            jobs["probe_tf"] = pool.submit(_build.build, "lstm_train", ("SSB_PROBE",))
            jobs["probe_fwd"] = pool.submit(_build.build, "lstm_align", ("LSTM_PROBE",))
            jobs["probe_tf_fwd"] = pool.submit(_build.build, "lstm_train", ("LSTM_PROBE",))
        builds = {k: j.result() for k, j in jobs.items()}
    for k, b in builds.items():
        print(f"build {k}: {b.seconds:.1f} s; {chip_smoke.ptxas_report(b.log)}", flush=True)
    if not args.self_only:
        chip_smoke.BUILD_LOGS.update({k: b.log for k, b in builds.items()})
        chip_smoke.report_train_mma(builds)
        chip_smoke.report_lstm_mma(builds)
    if not args.skip_checks:
        print(f"decoder backward against plain (max gap / max|plain| of dgates.., dy, dteacher, dy0, dh0, dc0, dctx; "
              f"f32 gate 1e-4): {json.dumps(check_bwd(chip_smoke, dev, lstm_align, lstm_ss))}", flush=True)
        print(f"peer forward against plain (max abs gap of php, pcp, ctx; f32 gate 1e-5): "
              f"{json.dumps(check_fwd(chip_smoke, dev, lstm_align))}", flush=True)
        print(f"row 5's backward against plain (max gap / max|plain| of dgates.., dxs, dh0, dc0; f32 gate 1e-4, "
              f"bf16 compute 1e-2): {json.dumps(check_tf_bwd(chip_smoke, dev, lstm_train))}", flush=True)
        print(f"the training forwards against plain (max abs gap over ys and the residuals, f32 gate 1e-5; the "
              f"backward fed their residuals, max gap / max|plain|): "
              f"{json.dumps(check_train_fwd(chip_smoke, dev, lstm_train, lstm_ss, lstm_align))}", flush=True)

    # 3. times
    B = chip_smoke.TRAIN_B
    calls, iters = {}, {}
    ps, a = chip_smoke.aligned_case(dev, B, 2, 7, "bernoulli", seed=11)
    php, pcp, ctx = lstm_align.peer_fwd(a["peer"], a["pxs"], a["pwt"], BF)
    fwd = (ps, a["proj_w"], a["proj_b"], a["h0"], a["c0"], a["y0"], a["teacher"], a["coins"], ctx)
    res10 = lstm_align.dec_fwd(*fwd, BF)[1]
    bargs10 = (ps, a["proj_w"], a["c0"], a["coins"], res10, a["dys"], 128)
    peer_xs = a["pxs"].reshape(B, 7, 100, 3)
    for cd in (F32, BF):
        n = str(cd)[6:]
        calls[f"dec_fwd 10s {n}"] = lambda cd=cd: lstm_align.dec_fwd(*fwd, BF, cd)
        calls[f"dec_bwd 10s {n}"] = lambda cd=cd: lstm_align.dec_bwd(*bargs10, cd)
        calls[f"peer_fwd 10s {n}"] = lambda cd=cd: lstm_align.peer_fwd(a["peer"], a["pxs"], a["pwt"], BF, cd)
        calls[f"peer_context serve {n}"] = lambda cd=cd: fused_lstm.peer_context(a["peer"], peer_xs, a["pwt"],
                                                                                compute_dtype=cd)
    for c in (128, 64):
        ps6, a6 = chip_smoke.ss_case(dev, B, 2, c, "bernoulli", seed=c)
        res6 = lstm_ss.ss_fwd(*chip_smoke.ss_fwd_args(ps6, a6), BF)[1]
        b6 = (ps6, a6["proj_w"], a6["c0"], a6["coins"], res6, a6["dys"], c)
        for cd in (F32, BF):
            calls[f"ss_fwd T=30 C={c} {str(cd)[6:]}"] = (lambda ps6=ps6, a6=a6, cd=cd: lstm_ss.ss_fwd(
                *chip_smoke.ss_fwd_args(ps6, a6), BF, cd))
            calls[f"ss_bwd T=30 C={c} {str(cd)[6:]}"] = lambda b6=b6, cd=cd: lstm_ss.ss_bwd(*b6, cd)
    iters = {k: (5 if "10s" in k or "serve" in k else 10) for k in calls}
    ms = chip_smoke.in_turns(calls, iters)
    print(f"alone at B={B} on bf16 residuals (ms a call, CUDA events, in turns; {smi}): {json.dumps(ms)}", flush=True)
    del calls, res10
    torch.cuda.empty_cache()
    tf_calls, tf_args = {}, {}
    for label, layers, t, rd in (("10s encoder", 2, 100, F32), ("seq2seq-tf-30", 1, 30, BF)):
        ps5, (xs, h0, c0), up = chip_smoke.lstm_case(dev, B, layers, seed=12, t=t)
        res5 = lstm_train.lstm_fwd(ps5, xs, h0, c0, rd)
        tf_args[label] = (ps5, c0, res5, up, xs, h0)
        for cd in (F32, BF):
            tf_calls[f"lstm_fwd {label} {str(cd)[6:]}"] = (lambda ps5=ps5, xs=xs, h0=h0, c0=c0, rd=rd, cd=cd:
                                                           lstm_train.lstm_fwd(ps5, xs, h0, c0, rd, cd))
            tf_calls[f"lstm_bwd {label} {str(cd)[6:]}"] = (lambda a=tf_args[label], cd=cd: lstm_train.lstm_bwd(
                *a[:3], *a[3], compute_dtype=cd))
        if label == "10s encoder":  # cuDNN's backward data in f32, the yardstick
            net = chip_smoke.cudnn_lstm(ps5, 3, dev, training=True)
            x_g = xs.clone().requires_grad_(True)
            h0_g, c0_g = h0.clone().requires_grad_(True), c0.clone().requires_grad_(True)
            y, (hn, cn) = net(x_g, (h0_g, c0_g))
            tf_calls[f"cudnn_bwd_data {label}"] = lambda y=y, hn=hn, cn=cn, x_g=x_g, h0_g=h0_g, c0_g=c0_g, up=up: \
                torch.autograd.grad((y, hn, cn), (x_g, h0_g, c0_g), up, retain_graph=True)

            def cudnn_fwd(net=net, xs=xs, h0=h0, c0=c0):
                with torch.no_grad():
                    return net(xs, (h0, c0))
            tf_calls[f"cudnn_fwd {label}"] = cudnn_fwd
    ms = chip_smoke.in_turns(tf_calls, {k: 5 if "10s" in k else 10 for k in tf_calls})
    print(f"row 5's forward and backward alone at B={B} (ms a call, CUDA events, in turns; the 10 s encoder "
          f"T = 100, L = 2, f32 residuals; seq2seq-tf-30 T = 30, L = 1, bf16 residuals; cuDNN's f32 forward and "
          f"backward data beside the 10 s encoder's; {smi}): {json.dumps(ms)}", flush=True)
    del tf_calls
    torch.cuda.empty_cache()
    time_widths(chip_smoke, dev, smi, lstm_train, lstm_ss)
    if args.self_only:
        return

    # 4. the probe build's split
    lib = lstm_align.bind(ctypes.CDLL(str(builds["probe"].path)))
    buf = (ctypes.c_ulonglong * len(PARTS))()
    for cd in (F32, BF):
        run = lambda: lstm_ss.bwd_launch(lib.align_dec_bwd, "dec_bwd", *bargs10[:6], 128,  # noqa: E731
                                         step_ctx=True, compute_dtype=cd)
        run()
        torch.cuda.synchronize()
        lib.ss_bwd_probe_read(buf)
        t_ms = chip_smoke.cuda_ms(run, 2)
        lib.ss_bwd_probe_read(buf)
        total = sum(buf)
        split = {p: round(v / total, 4) for p, v in zip(PARTS, buf) if v}
        print(f"dec_bwd {str(cd)[6:]} compute probe build at the 10 s shape ({t_ms:.3f} ms a call; thread 0's "
              f"clock64 a part, summed over the blocks): {json.dumps(split)}", flush=True)
    lib_tf = lstm_train.bind(ctypes.CDLL(str(builds["probe_tf"].path)))
    ps5, c0, res5, up = tf_args["10s encoder"][:4]
    for cd in (F32, BF):
        run = lambda: lstm_train.launch_bwd(lib_tf, ps5, c0, res5, *up, cd)  # noqa: E731
        run()
        torch.cuda.synchronize()
        lib_tf.lstm_bwd_probe_read(buf)
        t_ms = chip_smoke.cuda_ms(run, 2)
        lib_tf.lstm_bwd_probe_read(buf)
        total = sum(buf)
        split = {p: round(v / total, 4) for p, v in zip(PARTS, buf) if v}
        print(f"lstm_bwd {str(cd)[6:]} compute probe build at the 10 s encoder's shape ({t_ms:.3f} ms a call; "
              f"thread 0's clock64 a part, summed over the blocks): {json.dumps(split)}", flush=True)
    # the training forward's probe builds (-DLSTM_PROBE): the decoder's at the
    # 10 s shape, row 5's at the 10 s encoder's
    lib_f = lstm_align.bind(ctypes.CDLL(str(builds["probe_fwd"].path)))
    lib_tf_f = lstm_train.bind(ctypes.CDLL(str(builds["probe_tf_fwd"].path)))
    fbuf = (ctypes.c_ulonglong * len(FWD_PARTS))()
    xs5, h05 = tf_args["10s encoder"][4:]
    for label, lib_x, run_of in (
            ("dec_fwd at the 10 s shape", lib_f, lambda cd: lstm_ss.fwd_launch(
                lib_f.align_dec_fwd, "dec_fwd", *fwd, BF, cd, step_ctx=True)),
            ("lstm_fwd at the 10 s encoder's shape", lib_tf_f, lambda cd: lstm_train.launch_fwd(
                lib_tf_f, ps5, xs5, h05, c0, F32, cd))):
        for cd in (F32, BF):
            run_of(cd)
            torch.cuda.synchronize()
            lib_x.train_fwd_probe_read(fbuf)
            t_ms = chip_smoke.cuda_ms(lambda: run_of(cd), 2)
            lib_x.train_fwd_probe_read(fbuf)
            total = sum(fbuf)
            split = {p: round(v / total, 4) for p, v in zip(FWD_PARTS, fbuf) if v}
            print(f"{label}, {str(cd)[6:]} compute, probe build ({t_ms:.3f} ms a call; thread 0's clock64 a part, "
                  f"summed over the blocks): {json.dumps(split)}", flush=True)


def time_widths(chip_smoke, dev, smi, lstm_train, lstm_ss):
    """The end of 3.: the widths and depths the backwards take again, alone
    at B = 4096, in turns a shape (one shape's tensors on the card at a
    time), with their bounds."""
    B = chip_smoke.TRAIN_B
    ms, bounds = {}, {}
    for h, layers in ((256, 2), (128, 8), (128, 3), (128, 4)):
        wide = {}
        ps5, (xs, h0, c0), up = chip_smoke.lstm_case(dev, B, layers, seed=h + layers, t=100, h=h)
        ps6, a6 = chip_smoke.ss_case(dev, B, layers, 128, "bernoulli", seed=h + layers, h=h)
        for cd in (F32, BF):
            n = f"H={h} L={layers} {str(cd)[6:]}"
            try:
                res5 = lstm_train.lstm_fwd(ps5, xs, h0, c0, F32, cd)
                bw5 = lstm_train.lstm_bwd(ps5, c0, res5, *up, compute_dtype=cd)
                ys6, res6 = lstm_ss.ss_fwd(*chip_smoke.ss_fwd_args(ps6, a6), BF, cd)
                b6 = (ps6, a6["proj_w"], a6["c0"], a6["coins"], res6, a6["dys"], 128)
                bw6 = lstm_ss.ss_bwd(*b6, cd)
            except ValueError as e:
                print(f"{n}: refused ({e})", flush=True)
                continue
            wide[f"lstm_fwd T=100 {n}"] = lambda ps5=ps5, xs=xs, h0=h0, c0=c0, cd=cd: lstm_train.lstm_fwd(
                ps5, xs, h0, c0, F32, cd)
            wide[f"lstm_bwd T=100 {n}"] = lambda ps5=ps5, c0=c0, r=res5, up=up, cd=cd: lstm_train.lstm_bwd(
                ps5, c0, r, *up, compute_dtype=cd)
            wide[f"ss_fwd T=30 C=128 {n}"] = lambda ps6=ps6, a6=a6, cd=cd: lstm_ss.ss_fwd(
                *chip_smoke.ss_fwd_args(ps6, a6), BF, cd)
            wide[f"ss_bwd T=30 C=128 {n}"] = lambda b6=b6, cd=cd: lstm_ss.ss_bwd(*b6, cd)
            # the bounds, as chip_smoke.py's: the products at three-pass TF32 or bf16, the bytes once
            peak = chip_smoke.TF32X3_FLOPS if cd == F32 else chip_smoke.BF16_FLOPS
            w5, w6 = [t for p in ps5 for t in p], [t for p in ps6 for t in p]
            flop5 = chip_smoke.stack_flop(B, 100, [3] + [h] * (layers - 1), h)
            flop6 = chip_smoke.stack_flop(B, 30, [3 + 128] + [h] * (layers - 1), h)
            r5, r6 = [*res5.hs, *res5.cs, *res5.gs], [*res6.hs, *res6.cs, *res6.gs]
            bounds[f"lstm_fwd T=100 {n}"] = chip_smoke.bound(flop5, [xs, h0, c0, *w5], r5, peak)
            bounds[f"lstm_bwd T=100 {n}"] = chip_smoke.bound(flop5, [c0, *up, *w5, *res5.cs, *res5.gs],
                                                             [*bw5[0], *bw5[1:]], peak)
            a6_in = [a6[k] for k in ("h0", "c0", "y0", "teacher", "coins", "ctx", "proj_w", "proj_b")]
            bounds[f"ss_fwd T=30 C=128 {n}"] = chip_smoke.bound(flop6, a6_in + w6, [ys6, *r6], peak)
            bounds[f"ss_bwd T=30 C=128 {n}"] = chip_smoke.bound(
                flop6, [a6["dys"], a6["c0"], a6["coins"], a6["proj_w"], *w6, *res6.cs, *res6.gs],
                [*bw6[0], *bw6[1:6], bw6[6]], peak)
        if wide:
            ms.update(chip_smoke.in_turns(wide, {k: 3 for k in wide}))
        wide.clear()  # the shape's tensors go before the next shape's come
        res5 = bw5 = res6 = bw6 = None
        torch.cuda.empty_cache()
    if ms:
        print(f"the widths and depths taken again, alone at B={B} (ms a call, CUDA events, in turns; row 5 on f32 "
              f"residuals, the decoder on bf16; {smi}): {json.dumps(ms)}; their bounds (ms, by): "
              f"{json.dumps(bounds)}", flush=True)


def time_widths_plain(chip_smoke, dev, smi, lstm_train, lstm_ss):
    """The backward recurrences at hidden 256 (L = 2) and 8 layers (H =
    128), B = 4096, alone in turns beside their plain versions (the
    products in the same compute type) and, for row 5 (T = 100, f32
    residuals), cuDNN's backward data in f32; row 6 (T = 30, C = 128, bf16
    residuals) has no library call (its feedback)."""
    B = chip_smoke.TRAIN_B
    for h, layers in ((256, 2), (128, 8)):
        ps5, (xs, h0, c0), up = chip_smoke.lstm_case(dev, B, layers, seed=h + layers, t=100, h=h)
        ps6, a6 = chip_smoke.ss_case(dev, B, layers, 128, "bernoulli", seed=h + layers, h=h)
        res5 = lstm_train.lstm_fwd(ps5, xs, h0, c0, F32)
        res6 = lstm_ss.ss_fwd(*chip_smoke.ss_fwd_args(ps6, a6), BF)[1]
        b6 = (ps6, a6["proj_w"], a6["c0"], a6["coins"], res6, a6["dys"], 128)
        net = chip_smoke.cudnn_lstm(ps5, 3, dev, training=True)
        x_g = xs.clone().requires_grad_(True)
        h0_g, c0_g = h0.clone().requires_grad_(True), c0.clone().requires_grad_(True)
        y, (hn, cn) = net(x_g, (h0_g, c0_g))
        calls = {"row 5 cudnn_bwd_data f32": lambda: torch.autograd.grad((y, hn, cn), (x_g, h0_g, c0_g), up,
                                                                         retain_graph=True)}
        for cd in (F32, BF):
            n = str(cd)[6:]
            calls[f"row 5 kernel {n}"] = lambda cd=cd: lstm_train.lstm_bwd(ps5, c0, res5, *up, compute_dtype=cd)
            calls[f"row 5 plain {n}"] = lambda cd=cd: lstm_train._bwd_recurrence_reference(ps5, c0, res5, *up, cd)
            calls[f"row 6 kernel {n}"] = lambda cd=cd: lstm_ss.ss_bwd(*b6, cd)
            calls[f"row 6 plain {n}"] = lambda cd=cd: lstm_ss._bwd_recurrence_reference(*b6, compute_dtype=cd)
        ms = chip_smoke.in_turns(calls, {k: 1 if "plain" in k else 3 for k in calls})
        print(f"backward recurrences at H={h} L={layers}, B={B} (row 5 T=100 f32 residuals, row 6 T=30 C=128 bf16 "
              f"residuals; ms a call, CUDA events, in turns; {smi}): {json.dumps(ms)}", flush=True)
        del calls, res5, res6, b6, net, y, hn, cn
        torch.cuda.empty_cache()


def time_steps(chip_smoke, dev, smi):
    """5.: the train steps of the two crossuser presets and seq2seq-tf-30,
    and the 10 s steps' device time by kernel."""
    from longterm360fov_tpu_torch import train
    from longterm360fov_tpu_torch.config import get_preset
    from longterm360fov_tpu_torch.models import get_family

    out = {}
    for preset, iters in (("stacked-ss-crossuser-10s", 5), ("stacked-ss-crossuser", 10), ("seq2seq-tf-30", 10)):
        cfg = get_preset(preset, batch_size=chip_smoke.TRAIN_B)
        fam = get_family(cfg.model_family)
        batch = next(train.batch_iterator(chip_smoke.synthetic_windows(cfg)[0], cfg.batch_size, seed=2))
        for tc in ("float32", "bfloat16"):
            c = cfg.replace(train_compute=tc)
            opt = train.make_optimizer(c)
            st = [train.init_state(c, fam.init, opt, device=dev)]
            step = train.make_train_step(c, fam.apply, opt, gc_metric=False, **chip_smoke.family_fns(fam))

            def one():
                st[0] = step(st[0], batch)[0]
            out[f"{preset} {tc}"] = chip_smoke.cuda_ms(one, iters)
            if preset.endswith("10s"):
                chip_smoke.profile_device(f"{preset} {tc} step", one, 3, smi)
    print(f"train steps at B={chip_smoke.TRAIN_B} (ms a step, CUDA events; {smi}): {json.dumps(out)}", flush=True)


if __name__ == "__main__":
    main()
