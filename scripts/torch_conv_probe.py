"""Probe of the PyTorch port's fused resize + conv kernel
(``ops.conv_resize.fused_conv_resize``, row 8) on one NVIDIA card.

Run from the root of a checkout: ``python3 scripts/torch_conv_probe.py``.
Prints, on the card it finds (it fails without one):

1. the card's name and power limit;
2. (not with ``--time-only``) the build of ``csrc/conv_resize.cu``: its
   registers, spills and shared memory (``ptxas -v``), the library's shared
   memory of a tile against ``conv_smem``'s, and the kernel against its
   plain version at ``CHECKS`` (the card check's five shapes, a row wider
   than 48 KB, K = 5), each repeat bit-equal;
3. at 64 x 960 x 1920 → 32 x 64, C = 8 (``extract_clip_features``' frames)
   and 1200 x 480 x 960 → 32 x 64 (a clip), K = 3: the kernel's device
   time a launch (``torch.profiler``, the mean of 20 records) and its time
   a call (CUDA events), beside the bound (inputs once, outputs once) and
   the sector floor (the 32-byte sectors of the source rows and columns the
   taps touch, the output and the filters once; beside it the same in
   64-byte pieces); without ``--time-only``
   also each candidate tile height of ``ROWS`` in turns.

``--checkout DIR`` imports the port from another checkout, such as an
unpacked older commit, and ``--time-only`` skips 2. and the candidates, so
that one call can time two designs in turns, one process a checkout
(parent, change, change, parent).
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

CHECKS = [((3, 48, 96), (16, 32), 4, 3), ((64, 960, 1920), (32, 64), 8, 3), ((4099, 64, 128), (16, 32), 4, 3),
          ((5, 12, 20), (16, 32), 4, 3), ((7, 961, 1917), (32, 64), 8, 3), ((2, 40, 2000), (20, 1500), 3, 3),
          ((2, 60, 30000), (12, 20000), 4, 3), ((9, 200, 400), (17, 35), 4, 5)]
TIMED = [((64, 960, 1920), (32, 64), 8), ((1200, 480, 960), (32, 64), 8)]
ROWS = (4, 8, 16, 32)


def sector_floor(cr, shape, out_hw, c, k=3, sector=32):
    """Bytes the card must move at least: every ``sector``-byte piece of the
    source that holds a pixel some tap reads (both taps of every row and
    column, as the kernel reads them), the output and the filters once →
    (bytes, ms at 3.35 TB/s)."""
    b, src_h, src_w = shape
    h, w = out_hw
    rows = np.unique(cr.resize_taps(h, src_h)[0])
    cols = np.unique(cr.resize_taps(w, src_w)[0])
    sectors = np.unique((rows[:, None] * src_w + cols[None, :]) * 4 // sector).size
    nbytes = sector * b * sectors + 4 * (b * c * h * w + c * (k * k + 1))
    return nbytes, nbytes / 3.35e12 * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose port to import")
    ap.add_argument("--time-only", action="store_true", help="only the two shapes' times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device; this probe runs only on the card")
    sys.path.insert(0, args.checkout)
    import chip_smoke as cs
    from longterm360fov_tpu_torch.ops import _build, conv_resize as cr, fused_lstm

    fused_lstm.exact_f32_matmul()
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi} (port from {args.checkout})", flush=True)
    if not args.time_only:
        b = _build.build("conv_resize")
        cs.BUILD_LOGS["conv_resize"] = b.log
        print(f"build (nvcc {b.seconds:.1f} s): {json.dumps(cs.ptxas_resources('conv_resize', ('conv_resize_kernel',)))}",
              flush=True)
        lib = cr._library()
        for t in ((7, 64, 8, 3), (32, 64, 8, 3), (16, 256, 3, 3), (1, 256, 4, 5)):
            if lib.conv_resize_smem_bytes(*t) != cr.conv_smem(*t):
                raise AssertionError(f"the library's shared memory of a tile {t} is not conv_smem's")
        errs = {}
        for i, (shape, out_hw, c, k) in enumerate(CHECKS):
            rng = np.random.default_rng(i)
            frames, kernels = cs.randn(rng, dev, shape), cs.randn(rng, dev, (c, k, k), 1 / k)
            bias = cs.randn(rng, dev, (c,), 0.1)
            out = cr.fused_conv_resize(frames, out_hw, kernels, bias)
            again = cr.fused_conv_resize(frames, out_hw, kernels, bias)
            ref = cr.conv_resize_reference(frames, out_hw, kernels, bias)
            rel = (out - ref).abs().max().item() / ref.abs().max().item()
            if not (torch.equal(out, again) and rel <= cs.CONV_REL_TOL):
                raise AssertionError(f"conv_resize at {shape} → {out_hw}, C={c}, K={k}: {rel:.3e} of max|plain|")
            errs[f"{shape} -> {out_hw} C={c} K={k} tile {tuple(cr.conv_tile(shape[0], *out_hw, c, k)[:2])}"] = rel
        print(f"conv_resize against its plain version (of max|plain|; repeats bit-equal): {json.dumps(errs)}",
              flush=True)
    for shape, out_hw, c in TIMED:
        rng = np.random.default_rng(12)
        frames = torch.rand(shape, device=dev)
        kernels, bias = cs.randn(rng, dev, (c, 3, 3), 1 / 3), cs.randn(rng, dev, (c,), 0.1)
        fns = {"kernel": lambda: cr.fused_conv_resize(frames, out_hw, kernels, bias)}
        if not args.time_only:
            chooser = cr.conv_tile
            for rows in ROWS:
                def fn(rows=rows):
                    cr.conv_tile = lambda *a, **k: chooser(*a, **k)._replace(
                        rows=rows, smem=cr.conv_smem(rows, chooser(*a, **k).cols, c, 3))
                    try:
                        return cr.fused_conv_resize(frames, out_hw, kernels, bias)
                    finally:
                        cr.conv_tile = chooser
                if not torch.equal(fn(), fns["kernel"]()):
                    raise AssertionError(f"tiles of {rows} rows give other bits at {shape}")
                fns[f"rows={rows}"] = fn
        with torch.inference_mode():
            ms = cs.in_turns(fns, dict.fromkeys(fns, 50))
            dev_ms = {k: cs.launch_device_ms(f, "conv_resize_kernel", 20) for k, f in fns.items()}
        flop, nbytes = cs.conv_resize_work(shape, out_hw, c)
        floor, floor_ms = sector_floor(cr, shape, out_hw, c)
        floor64, floor64_ms = sector_floor(cr, shape, out_hw, c, sector=64)
        print(f"conv_resize {shape} -> {out_hw}, C={c}, K=3 ({smi}): ms a call (CUDA events, in turns) {json.dumps(ms)}; "
              f"device ms a launch [mean of the profiler's records, records kept of 20] {json.dumps(dev_ms)}; bound "
              f"{nbytes / 3.35e12 * 1e3:.5f} ms ({nbytes / 1e6:.2f} MB, {flop / 1e9:.3f} GFLOP); sector floor "
              f"{floor_ms:.5f} ms ({floor / 1e6:.2f} MB); in 64-byte pieces {floor64_ms:.5f} ms ({floor64 / 1e6:.2f} MB)",
              flush=True)


if __name__ == "__main__":
    main()
