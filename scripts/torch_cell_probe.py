"""Probe of the PyTorch port's one-step LSTM cell in both tiers
(``ops.fused_lstm.fused_lstm_cell``: row 2 on f32 tensors in three-pass
TF32, row 2b on a ``--bf16`` model's bf16 tensors; ``cell="pallas"``) on one
NVIDIA card.

Run from the root of a checkout: ``python3 scripts/torch_cell_probe.py``.
Prints, on the card it finds (it fails without one):

1. the card's name and power limit;
2. the build of ``csrc/fused_serve.cu``: each cell instance's registers,
   spills and shared memory (``ptxas -v``) and its count of ``HMMA``
   instructions in the SASS;
3. both tiers against ``lstm_cell`` (and, in bf16, on the f32 widening) at
   the shapes of ``CHECKS``: hidden 1 to 1024, D_in 1 to 1024, ragged
   batches, x and h at odd element offsets, each repeat bit-equal; the
   largest gaps;
4. ``--probe``: the probe build's split (``-DLSTM_PROBE``: thread 0 of
   every block adds its ``clock64`` deltas to each part, read by
   ``fused_serve_probe_read``) of a launch at B = 16384, D_in = 3 and 128,
   H = 128, in both tiers: the prologue (the first three chunks' issue,
   c's loads), the ring's issue in the loop, the waits and barriers, the
   products, the cell with its stores;
5. ``--blocks``: the cell alone at B = 16384 (D_in 3 and 128) and 262,144
   (D_in 3), H = 128, in each block of ``BLOCKS`` (rows x units; the
   chooser's first), in turns (CUDA events) with each one's device time a
   launch (``torch.profiler``).
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from longterm360fov_tpu_torch.models.cell import LSTMParams, lstm_cell  # noqa: E402
from longterm360fov_tpu_torch.ops import _build, fused_lstm  # noqa: E402

# (batch, D_in, hidden, x and h at an odd element offset)
CHECKS = [(16384, 3, 128, False), (16383, 128, 128, False), (4099, 3, 128, True), (257, 131, 40, False),
          (1000, 3, 100, True), (513, 5, 272, False), (300, 3, 1024, False), (77, 1024, 8, True), (33, 7, 1, False),
          (129, 16, 96, False), (1, 3, 256, False), (2049, 1, 160, True)]
# candidate blocks (rows, units, W resident) of each tier, timed with --blocks
BLOCKS = {False: [(64, 64, True), (128, 32, True), (128, 32, False), (64, 32, False)],
          True: [(128, 64, True), (64, 64, True), (128, 64, False), (64, 64, False)]}


def inputs(dev, batch, d_in, hidden, cd, offset, seed):
    rng = np.random.default_rng(seed)
    (p,) = cs.stack(rng, dev, d_in, 1, h=hidden)
    p = LSTMParams(p.w.to(cd), p.b.to(cd))
    k = int(offset)
    x = cs.randn(rng, dev, (batch * d_in + k,)).to(cd)[k:].view(batch, d_in)
    h = cs.randn(rng, dev, (batch * hidden + k,), 0.5).to(cd)[k:].view(batch, hidden)
    c = cs.randn(rng, dev, (batch, hidden), 0.5).to(cd)
    return p, x, h, c


def check(dev, cd):
    """Both outputs of the kernel against lstm_cell at every CHECKS shape;
    a repeat bit-equal → {shape: largest gaps}."""
    out = {}
    for batch, d_in, hidden, offset in CHECKS:
        p, x, h, c = inputs(dev, batch, d_in, hidden, cd, offset, seed=batch + d_in + hidden)
        got = fused_lstm.fused_lstm_cell(p, x, (h, c))
        again = fused_lstm.fused_lstm_cell(p, x, (h, c))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"a repeat differs at B={batch}, D_in={d_in}, H={hidden}")

        def plain(c_):
            return list(lstm_cell(LSTMParams(*(t.to(c_) for t in p)), x.to(c_), (h.to(c_), c.to(c_))))
        out[f"B={batch} D_in={d_in} H={hidden}" + (" offset" if offset else "")] = cs.check_outputs(
            "fused_lstm_cell", list(got), cs.plains(cd, plain), f"B={batch}, D_in={d_in}, H={hidden}", "cell", cd)
    return out


def time_blocks(dev, smi, bf16):
    """The cell alone in each candidate block, in turns."""
    cd = torch.bfloat16 if bf16 else torch.float32
    chooser = fused_lstm.cell_block
    for batch, d_in in ((16384, 3), (16384, 128), (262144, 3)):
        p, x, h, c = inputs(dev, batch, d_in, 128, cd, False, seed=12 + d_in)
        fns, devs = {}, {}
        for rows, units, w_res in BLOCKS[bf16]:
            geo = fused_lstm.cell_geom(rows, units, w_res, d_in, 128, bf16)
            if geo.smem > 232448:
                continue

            def fn(geo=geo):
                fused_lstm.cell_block = lambda *_: geo
                try:
                    return fused_lstm.fused_lstm_cell(p, x, (h, c))
                finally:
                    fused_lstm.cell_block = chooser
            want = fused_lstm.fused_lstm_cell(p, x, (h, c))
            name = f"{rows}x{units}{' W resident' if w_res else ''}"
            if not all(torch.equal(a, b) for a, b in zip(fn(), want)):
                raise AssertionError(f"the block {name} gives other bits")
            fns[name] = fn
            devs[name] = cs.launch_device_ms(fn, "lstm_cell_kernel", 20)
        iters = 5 if batch > 100000 else 30
        with torch.inference_mode():
            ms = cs.in_turns(fns, dict.fromkeys(fns, iters))
        flop = cs.stack_flop(batch, 1, [d_in], 128)
        work = {cs.BF16_FLOPS: flop} if bf16 else {cs.TF32X3_FLOPS: flop}
        b_ms, b_by = cs.bound(work, [x, h, c, p.w, p.b], [h, c])
        print(f"{'bf16' if bf16 else 'f32'} cell, B={batch}, D_in={d_in}, H=128, blocks rows x units (the chooser's "
              f"{tuple(chooser(d_in, 128, bf16))}): ms a call in turns (CUDA events, {smi}) {json.dumps(ms)}; device "
              f"ms a launch [mean of the profiler's records, records kept of 20] {json.dumps(devs)}; bound "
              f"{b_ms:.4f} ms by {b_by}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", action="store_true", help="the probe build's time split")
    ap.add_argument("--blocks", action="store_true", help="time the candidate blocks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device; this probe runs only on the card")
    fused_lstm.exact_f32_matmul()
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    b = _build.build("fused_serve")
    cs.BUILD_LOGS["fused_serve"] = b.log
    hmma, fn = {}, None
    for ln in cs.sass(b.path).splitlines():
        if "Function :" in ln:
            fn = ("bf16" if "nv_bfloat16" in ln else "f32") if "lstm_cell_kernel" in ln else None
            if fn:
                hmma[fn] = 0
        elif fn and "HMMA" in ln:
            hmma[fn] += 1
    for tier, sym in (("f32", ("lstm_cell_kernel", "IfE")), ("bf16", ("lstm_cell_kernel", "nv_bfloat16"))):
        print(f"build (nvcc {b.seconds:.1f} s): lstm_cell_kernel<{tier}> {hmma.get(tier, 0)} HMMA instructions in its "
              f"SASS; {json.dumps(cs.ptxas_resources('fused_serve', sym))}", flush=True)
    lib = fused_lstm.bind(ctypes.CDLL(str(b.path)))
    for d_in, hidden in ((3, 1), (3, 40), (3, 128), (128, 128), (1024, 128), (5, 272), (3, 1024)):
        for bf16 in (False, True):
            got = (ctypes.c_longlong * 5)()
            lib.lstm_cell_block(d_in, hidden, int(bf16), got)
            if tuple(got) != tuple(int(v) for v in fused_lstm.cell_block(d_in, hidden, bf16)):
                raise AssertionError(f"the library's cell block at D_in={d_in}, H={hidden} is {tuple(got)}, the "
                                     f"chooser's {fused_lstm.cell_block(d_in, hidden, bf16)}")
    for cd in (torch.float32, torch.bfloat16):
        print(f"fused_lstm_cell {str(cd)[6:]} against lstm_cell (repeats bit-equal): {json.dumps(check(dev, cd))}",
              flush=True)
    if args.probe:
        probe = fused_lstm.bind(ctypes.CDLL(str(_build.build("fused_serve", ("LSTM_PROBE",)).path)))
        real = fused_lstm._library
        # csrc/lstm_mma.cuh LstmPart, as cell_step marks them
        parts = {6: "prologue", 0: "issue", 4: "waits and barriers", 1: "products", 2: "cell"}
        fused_lstm._library = lambda: probe
        try:
            for cd in (torch.float32, torch.bfloat16):
                for d_in in (3, 128):
                    p, x, h, c = inputs(dev, 16384, d_in, 128, cd, False, seed=12 + d_in)
                    buf = (ctypes.c_ulonglong * 7)()
                    fused_lstm.fused_lstm_cell(p, x, (h, c))
                    torch.cuda.synchronize()
                    probe.fused_serve_probe_read(buf)
                    for _ in range(20):
                        fused_lstm.fused_lstm_cell(p, x, (h, c))
                    torch.cuda.synchronize()
                    probe.fused_serve_probe_read(buf)
                    total = sum(buf[i] for i in parts)
                    geo = fused_lstm.cell_block(d_in, 128, cd == torch.bfloat16)
                    blocks = fused_lstm.cell_grid(geo, 16384, 128, 132) * -(-128 // geo.units) * 20
                    print(f"probe split of the {str(cd)[6:]} cell, B=16384, D_in={d_in}, H=128, block "
                          f"{tuple(geo)} (thread 0 of each block, {total / blocks:.0f} clocks a block): "
                          f"{json.dumps({n: round(buf[i] / total, 4) for i, n in parts.items()})}", flush=True)
        finally:
            fused_lstm._library = real
    if args.blocks:
        for bf16 in (False, True):
            time_blocks(dev, smi, bf16)


if __name__ == "__main__":
    main()
