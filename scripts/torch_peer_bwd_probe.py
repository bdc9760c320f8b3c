"""Probe of the PyTorch port's lockstep peer backward
(``ops.lstm_align.peer_bwd``, ``csrc/lstm_align.cu``) and its dproj reduction
(``ops.lstm_ss.ss_dproj``, ``csrc/lstm_ss.cu``) on one NVIDIA card.

Run from the root of a checkout: ``python3 scripts/torch_peer_bwd_probe.py``.
``--checkout DIR`` imports the port (and its ``chip_smoke.py``) from another
checkout instead, such as an unpacked older commit; ``--self-only`` then
skips what that checkout may lack (the probe and one-pass builds);
``--steps`` only times the train steps (5 below), one process a checkout,
so that a call can run parent, change, change, parent. Prints, on the card
it finds (it fails without one):

1. the card's name and power limit, and each build's registers and spills;
2. the peer backward in both compute types against its plain version at
   the card tests' shapes (``tests/test_torch_kernel_cuda.py``): the largest
   gap of each output relative to max|plain| and whether a repeat is
   bit-equal; then the same for a one-pass build (``-DPEER_ONE_PASS``: the
   f32 products' small terms dropped);
3. times, CUDA events, in turns (``chip_smoke.in_turns``), at
   ``stacked-ss-crossuser-10s``'s training shapes (B = 4096, K = 7,
   T = 100, C = 128, bf16 residuals): the peer backward in f32 and bf16
   compute against cuDNN's ``nn.LSTM`` backward data over the peer rows;
   the dproj reduction (B·T = 122,880 rows, H = 128, D = 3) in both compute
   types against one cuBLAS matmul, with the device time of each from
   ``torch.profiler`` and its host time (the host's clock over 2000 calls
   that the card keeps up with) beside its call time;
4. unless ``--self-only``: the time split of the probe build
   (``-DPEER_PROBE``: thread 0 of every block adds its ``clock64`` deltas
   per part, ``PeerPart`` order) in both compute types;
5. with ``--steps`` only: the fast train step (CUDA events, the batch's copy
   to the card included) of ``stacked-ss-crossuser`` (whose decoder
   launches the dproj reduction) and ``stacked-ss-crossuser-10s`` (the peer
   backward and dproj) at B = 4096, in f32 and bf16 compute, from the
   seed's initial weights.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PARTS = ("stage z", "barriers", "gate product", "cell backward", "dpgates stores", "dh product", "dpxs",
         "dpwt")
# the card tests' peer backward shapes (batch, K, T)
SHAPES = ((67, 7, 100), (1000, 7, 30), (257, 8, 30), (13, 1, 100), (301, 7, 1))
# the dproj reduction's (rows, D, H)
DPROJ_SHAPES = ((122880, 3, 128), (4099 * 30, 3, 128), (257, 1, 64), (30, 4, 128), (1, 3, 64))


def device_ms(fn, iters=20):
    """The device time of one call of ``fn``: the CUDA kernels
    torch.profiler (CUPTI) records over ``iters`` calls, summed, per call
    (kept here, not taken from chip_smoke.py, so that an older checkout's
    port can be timed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


def host_us(fn, calls=2000):
    """The host's time of one call of ``fn`` (µs) while the card keeps up:
    the host's clock over ``calls`` calls, not waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def time_steps(chip_smoke, dev, smi):
    """The fast train steps of the two crossuser presets (5. above)."""
    from longterm360fov_tpu_torch import train
    from longterm360fov_tpu_torch.config import get_preset
    from longterm360fov_tpu_torch.models import get_family

    out = {}
    for preset, iters in (("stacked-ss-crossuser", 10), ("stacked-ss-crossuser-10s", 5)):
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
    print(f"train steps at B={chip_smoke.TRAIN_B} (ms a step, CUDA events; {smi}): {json.dumps(out)}", flush=True)


def rel_gaps(outs, refs):
    return [round((x - y).abs().max().item() / max(y.abs().max().item(), 1e-30), 9) for x, y in zip(outs, refs)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose port to import")
    ap.add_argument("--self-only", action="store_true", help="skip the probe and one-pass builds")
    ap.add_argument("--steps", action="store_true", help="only time the train steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device; this probe runs only on the card")
    sys.path.insert(0, args.checkout)
    import chip_smoke
    from longterm360fov_tpu_torch.ops import _build, fused_lstm, lstm_align, lstm_ss

    fused_lstm.exact_f32_matmul()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; port from {args.checkout}", flush=True)
    dev = torch.device("cuda:0")
    if args.steps:
        return time_steps(chip_smoke, dev, smi)
    builds = {}
    with ThreadPoolExecutor(max_workers=4) as pool:  # one nvcc each, started together
        jobs = {"align": pool.submit(_build.build, "lstm_align"), "ss": pool.submit(_build.build, "lstm_ss")}
        if not args.self_only:
            jobs["probe"] = pool.submit(_build.build, "lstm_align", ("PEER_PROBE",))
            jobs["one_pass"] = pool.submit(_build.build, "lstm_align", ("PEER_ONE_PASS",))
        builds = {k: j.result() for k, j in jobs.items()}
    for k, b in builds.items():
        print(f"build {k}: {b.seconds:.1f} s; {chip_smoke.ptxas_report(b.log)}", flush=True)
    one_pass = None if args.self_only else lstm_align.bind(ctypes.CDLL(str(builds["one_pass"].path)))

    readings = {}
    for batch, k, t in SHAPES:
        _, a = chip_smoke.aligned_case(dev, batch, 1, k, "bernoulli", seed=k + t, t=t)
        rng = torch.Generator(device=dev).manual_seed(batch)
        for rd in (torch.float32, torch.bfloat16):
            php, pcp, _ = lstm_align.peer_fwd(a["peer"], a["pxs"], a["pwt"], rd)
            dctx = torch.randn((batch, t, 128), device=dev, generator=rng) * 0.1
            pargs = (a["peer"], a["pxs"], a["pwt"], php, pcp, dctx)
            for cd in (torch.float32, torch.bfloat16):
                out = lstm_align.peer_bwd(*pargs, cd)
                again = lstm_align.peer_bwd(*pargs, cd)
                ref = lstm_align._peer_bwd_reference(*pargs, cd)
                r = {"rel_gap": rel_gaps(out, ref), "repeat_bit_equal": all(map(torch.equal, out, again))}
                if one_pass is not None and cd == torch.float32:
                    r["one_pass_rel_gap"] = rel_gaps(lstm_align.launch_peer_bwd(one_pass, *pargs, cd), ref)
                readings[f"B={batch} K={k} T={t} {str(rd)[6:]} residuals, {str(cd)[6:]} compute"] = r
    print(f"peer_bwd against plain (max gap / max|plain| of dpgates, dpxs, dpwt; f32 gate 1e-4): "
          f"{json.dumps(readings)}", flush=True)
    readings = {}
    for rows, d, h in DPROJ_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(rows)
        dy = torch.randn((rows, 1, d), device=dev, generator=gen)
        for rd in (torch.float32, torch.bfloat16):
            h_top = (torch.rand((rows, 1, h), device=dev, generator=gen) * 2 - 1).to(rd)
            for cd in (torch.float32, torch.bfloat16):
                out = lstm_ss.ss_dproj(h_top, dy, cd)
                again = lstm_ss.ss_dproj(h_top, dy, cd)
                readings[f"Q={rows} D={d} H={h} {str(rd)[6:]} h, {str(cd)[6:]} compute"] = {
                    "rel_gap": rel_gaps(out, lstm_ss._dproj_reference(h_top, dy, cd)),
                    "repeat_bit_equal": all(map(torch.equal, out, again))}
    print(f"ss_dproj against plain (max gap / max|plain| of dproj_w, dproj_b; gate 1e-4): {json.dumps(readings)}",
          flush=True)

    _, a = chip_smoke.aligned_case(dev, chip_smoke.TRAIN_B, 2, 7, "bernoulli", seed=11)
    peer, pxs, pwt = a["peer"], a["pxs"], a["pwt"]
    rd, k = torch.bfloat16, 7
    php, pcp, _ = lstm_align.peer_fwd(peer, pxs, pwt, rd)
    dctx = torch.randn((chip_smoke.TRAIN_B, 100, 128), device=dev, generator=torch.Generator(device=dev)
                       .manual_seed(0)) * 0.05
    net = chip_smoke.cudnn_lstm([peer], 3, dev, training=True)
    x_g = pxs.clone().requires_grad_(True)
    y_lib, _ = net(x_g)
    dh_up = pwt.reshape(-1, 1, 1) * dctx.repeat_interleave(k, dim=0)
    pargs = (peer, pxs, pwt, php, pcp, dctx)
    ms = chip_smoke.in_turns({
        "f32": lambda: lstm_align.peer_bwd(*pargs),
        "bf16": lambda: lstm_align.peer_bwd(*pargs, torch.bfloat16),
        "cudnn": lambda: torch.autograd.grad(y_lib, x_g, dh_up, retain_graph=True)},
        {"f32": 5, "bf16": 5, "cudnn": 5})
    print(f"peer_bwd alone at B=4096, K=7, T=100, C=128, bf16 residuals (ms, CUDA events, in turns; cudnn: "
          f"nn.LSTM backward data over the 28,672 peer rows; {smi}): {json.dumps(ms)}", flush=True)
    del y_lib, net, x_g, dh_up
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(1)
    h_top = (torch.rand((chip_smoke.TRAIN_B, 30, 128), device=dev, generator=gen) * 2 - 1).bfloat16()
    dy = torch.randn((chip_smoke.TRAIN_B, 30, 3), device=dev, generator=gen)
    h1 = torch.cat([h_top.float().reshape(-1, 128), h_top.new_ones((h_top.shape[0] * 30, 1)).float()], dim=1)
    h1b, dyb, dy2 = h1.bfloat16(), dy.reshape(-1, 3).bfloat16(), dy.reshape(-1, 3)
    calls = {"f32": lambda: lstm_ss.ss_dproj(h_top, dy), "bf16": lambda: lstm_ss.ss_dproj(h_top, dy, torch.bfloat16),
             "cublas_f32": lambda: h1.t() @ dy2, "cublas_bf16": lambda: h1b.t() @ dyb}
    ms = chip_smoke.in_turns(calls, dict.fromkeys(calls, 50))
    dev_us = {name: round(device_ms(fn) * 1e3, 3) for name, fn in calls.items()}
    h_us = {name: round(host_us(fn), 2) for name, fn in calls.items()}
    print(f"ss_dproj alone at B·T=122,880, H=128, D=3, bf16 h (call ms, CUDA events, in turns; device µs a call "
          f"from torch.profiler; host µs a call; {smi}): {json.dumps({'ms': ms, 'device_us': dev_us, 'host_us': h_us})}",
          flush=True)
    if args.self_only:
        return

    lib = lstm_align.bind(ctypes.CDLL(str(builds["probe"].path)))
    buf = (ctypes.c_ulonglong * len(PARTS))()
    for cd in (torch.float32, torch.bfloat16):
        lstm_align.launch_peer_bwd(lib, *pargs, cd)
        torch.cuda.synchronize()
        lib.lstm_align_probe_read(buf)
        calls = 2
        t_ms = chip_smoke.cuda_ms(lambda: lstm_align.launch_peer_bwd(lib, *pargs, cd), calls)
        lib.lstm_align_probe_read(buf)
        total = sum(buf)
        split = {p: round(v / total, 4) for p, v in zip(PARTS, buf) if v}
        print(f"peer_bwd {str(cd)[6:]} compute probe build at B=4096 ({t_ms:.3f} ms a call, {total / (calls + 1):.0f} "
              f"clocks a call summed over the blocks; thread 0's clock64 a part): {json.dumps(split)}", flush=True)


if __name__ == "__main__":
    main()
