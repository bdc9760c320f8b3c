"""The f32 peer context (``ops.fused_lstm.peer_context``, three-pass TF32,
``csrc/lstm_mma.cuh``'s encoder) across peer counts, on one NVIDIA card:
its time at ``stacked-ss-crossuser-10s``'s serving shape (B = 4096, K = 7,
T = 100, C = 128: 28,672 peer rows) and, where the checkout's chooser takes
them, at K = 9, 16, 64 and 256 over about the same rows (B·K ≈ 28,672),
each checked against its plain version first (``chip_smoke.ENC_TOL``) and
timed by CUDA events, with the block the chooser picks and the bf16 tier
beside it.

Run from the root of a checkout: ``python3 scripts/torch_peer_k_probe.py``.
``--checkout DIR`` imports the port from another checkout instead, such as
an unpacked older commit: run parent, change, change, parent in one call
(one process a checkout) to compare two versions on one card. Prints one
JSON line; fails without a card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# (B, K): B·K about the 10 s preset's 28,672 peer rows
SHAPES = ((4096, 7), (3186, 9), (1792, 16), (448, 64), (112, 256))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose port to import")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device; this probe runs only on the card")
    sys.path.insert(0, args.checkout)
    import chip_smoke
    from longterm360fov_tpu_torch.ops import fused_lstm

    fused_lstm.exact_f32_matmul()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev, t = torch.device("cuda:0"), 100
    rng = np.random.default_rng(2)
    peer = chip_smoke.stack(rng, dev, 3, 1)[0]
    out = {"card": smi, "checkout": args.checkout, "T": t, "C": 128, "shapes": {}}
    for batch, k in SHAPES:
        try:
            geo = fused_lstm.peer_tf32_rows(128, k, 3)
        except ValueError as e:
            out["shapes"][f"B={batch} K={k}"] = f"refused: {e}"
            continue
        pxs, w = chip_smoke.peer_inputs(rng, dev, chip_smoke.randn(rng, dev, (batch, 1, 3)), k, t)
        got = fused_lstm.peer_context(peer, pxs, w)
        gap = (got - fused_lstm.peer_context_reference(peer, pxs, w)).abs().max().item()
        if not gap <= chip_smoke.ENC_TOL:
            raise AssertionError(f"peer_context B={batch} K={k}: {gap} from plain, above {chip_smoke.ENC_TOL}")
        ms = chip_smoke.in_turns({"f32": lambda: fused_lstm.peer_context(peer, pxs, w),
                                  "bf16": lambda: fused_lstm.peer_context(peer, pxs, w,
                                                                          compute_dtype=torch.bfloat16)},
                                 {"f32": args.iters, "bf16": args.iters})
        out["shapes"][f"B={batch} K={k}"] = {"ms": ms, "max_abs_err": gap, "block": geo._asdict()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
