"""Probe of the PyTorch port's transformer decode in its bf16 tier
(``ops.transformer_decode.fused_ar_decode(compute_dtype=bfloat16)``, row 9c)
or, with ``--tier f32``, its f32 tier (row 9) on one NVIDIA card.

Run from the root of a checkout: ``python3 scripts/torch_decode_bf16_probe.py``.
``--checkout DIR`` imports the port (and its ``chip_smoke.py``) from another
checkout instead, such as an unpacked older commit, so that one call can
time both, one process a checkout (parent, change, change, parent);
``--self-only`` then leaves out the probe build and the block shapes,
which that checkout may lack. Prints, on the card it finds (it fails
without one):

1. the card's name and power limit;
2. the builds of ``csrc/transformer_decode.cu``: the kernels' own and the
   probe build (``-DTFM_PROBE``); each kernel instance of the tier's
   registers, spills and shared memory (``ptxas -v``) and its count of
   ``HMMA`` instructions in the SASS (``cuobjdump -sass``);
3. the kernel against its plain versions (``transformer._ar_decode``: in
   bf16 the bf16 and the f32 one, in f32 the f32 one) in every tier (no
   peers; K = 4 per-row peers with a row of no valid peer; ``peer_pool``
   "mean"; the window; group-shared peers with δv), in blocks of 64 and of
   32 rows, at ragged batches: the largest gap to each, and whether a
   repeat is bit-equal;
4. the time of one call (the wrapper's K/V projections included; CUDA
   events, ``chip_smoke.in_turns``) at ``transformer-30``'s B = 16384
   (K = 4, 120 peer tokens), in f32 also at 65,536, at ``transformer-10s``
   per row, B = 4096 (100 + 100 steps, window 8) and, in f32, of the
   group-shared tier at B = 4096, G = 8 with δv; blocks of 64 rows against
   blocks of 32;
5. the time split of the probe build at the first two shapes:
   thread 0 of every block adds its ``clock64`` deltas per part
   (``transformer_probe.cuh``'s DecPart); each part's share of the clocks
   summed over the blocks.

``--skip-checks`` leaves out 3.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PARTS = ("products", "chunk waits", "layer norms and epilogues", "self attention", "cross attention",
         "peer attention", "in_proj, out_proj and feedback", "barriers")  # tfm::DecPart, in order
BUILDS = {"kernels": (), "probe": ("TFM_PROBE",)}
# the card tests' cases (tests/test_torch_kernel_cuda.py): (layers, t_in, t_out, batch, k, pool, window, dv)
CASES = ((2, 30, 30, 257, 0, "none", 0, False), (2, 30, 30, 257, 4, "none", 0, False),
         (2, 30, 30, 257, 4, "mean", 0, False), (2, 30, 30, 257, 4, "none", 2, False),
         (1, 6, 9, 40, 4, "none", 8, True), (2, 30, 30, 131, 4, "mean", 2, True), (8, 4, 1, 33, 4, "none", 0, False))


def sass_hmma(nvcc, path):
    """HMMA instructions of each ar_decode_kernel instance in a library's SASS."""
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip() if "ar_decode_kernel" in ln else None
            if fn:
                counts[fn] = 0
        elif fn and "HMMA" in ln:
            counts[fn] += 1
    return counts


def case(cs, dev, layers, t_in, t_out, batch, k, pool, window, dv, seed=0):
    """chip_smoke.tf_case's inputs; grouped (dv): G = 3 groups as
    chip_smoke.shared_groups, one all masked, and δv → (m, params, enc, y0,
    peers: the wrapper's peer keywords)."""
    m, params, _, enc, y0, pm, pv = cs.tf_case(dev, batch, t_in, t_out, layers, 0 if dv else k, pool, window, seed)
    if not dv:
        return m, params, enc, y0, ({"peer_mem": pm, "peer_valid": pv} if k else {})
    rng = np.random.default_rng(seed)
    gmem, gvalid, gid = cs.shared_groups(dev, params, m, batch, t_out, rng)
    return m, params, enc, y0, {"peer_gmem": gmem, "peer_gvalid": gvalid, "peer_gid": gid,
                                "peer_dv": cs.randn(rng, dev, (batch, layers, m.hidden), 0.1)}


def plain(transformer, params, m, enc, y0, peers, tier):
    if "peer_gmem" in peers:
        return transformer._ar_decode(params, m, enc, peers["peer_gmem"], peers["peer_gvalid"], y0,
                                      peer_gid=peers["peer_gid"].long(), peer_dv=peers["peer_dv"],
                                      compute_dtype=tier)
    return transformer._ar_decode(params, m, enc, peers.get("peer_mem"), peers.get("peer_valid"), y0,
                                  compute_dtype=tier)


def shared_inputs(cs, transformer, dev, batch, n_groups):
    """``transformer-10s``'s shape through the shared tier (as
    chip_smoke.time_shared_tier): G groups of K = 4 unit-vector peer tracks,
    δv → (m, params, enc, y0, peers)."""
    m, params, _, enc, y0, _, _ = cs.tf_case(dev, batch, 100, 100, 2, 0, "none", 8, seed=20)
    rng = np.random.default_rng(20)
    gmem, gvalid = (x.contiguous() for x in transformer._peer_tokens(
        params, m, cs.unit_rows(rng, dev, (n_groups, 4, 100)), None))
    gid = torch.tensor(rng.integers(0, n_groups, size=batch), device=dev)
    return m, params, enc, y0, {"peer_gmem": gmem, "peer_gvalid": gvalid, "peer_gid": gid,
                                "peer_dv": cs.randn(rng, dev, (batch, 2, m.hidden), 0.1)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tier", choices=("bf16", "f32"), default="bf16", help="the tier to probe")
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose port to import")
    ap.add_argument("--self-only", action="store_true", help="leave out the probe build and the block shapes")
    ap.add_argument("--skip-checks", action="store_true", help="leave out the readings against the plain versions")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device; this probe runs only on the card")
    sys.path.insert(0, args.checkout)
    import chip_smoke as cs
    from longterm360fov_tpu_torch.models import transformer
    from longterm360fov_tpu_torch.ops import _build, fused_lstm
    from longterm360fov_tpu_torch.ops import transformer_decode as td

    fused_lstm.exact_f32_matmul()
    dev = torch.device("cuda:0")
    tier = torch.bfloat16 if args.tier == "bf16" else torch.float32
    sym_of_tier = "nv_bfloat16" if args.tier == "bf16" else "ar_decode_kernelIf"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; port from {args.checkout}; the {args.tier} tier", flush=True)

    names = ["kernels"] if args.self_only else list(BUILDS)
    with ThreadPoolExecutor(len(names)) as pool:
        builds = dict(zip(names, pool.map(lambda n: _build.build("transformer_decode", BUILDS[n]), names)))
    libs = {name: td.bind(ctypes.CDLL(str(b.path))) for name, b in builds.items()}
    nvcc = _build.find_nvcc()
    hmma = sass_hmma(nvcc, builds["kernels"].path)
    cs.BUILD_LOGS["transformer_decode"] = builds["kernels"].log
    res = {sym: {"HMMA": n, **cs.ptxas_resources("transformer_decode", (sym,))}
           for sym, n in hmma.items() if sym_of_tier in sym}
    smem = "" if args.self_only else "; dynamic shared memory at 64 / 32 rows " + json.dumps(
        {rows: libs["kernels"].transformer_decode_smem_bytes(rows, int(args.tier == "bf16")) for rows in (64, 32)})
    print(f"build (nvcc {builds['kernels'].seconds:.1f} s): {args.tier} instances {json.dumps(res)}{smem}",
          flush=True)

    def call(name, m, params, enc, y0, peers, rows=None):
        patches = [mock.patch.object(td, "_library", lambda: libs[name])]
        if rows is not None:
            patches.append(mock.patch.object(td, "decode_rows", lambda batch, n_sm: rows))
        for p in patches:
            p.start()
        try:
            return td.fused_ar_decode(params, m, enc, y0, compute_dtype=tier, **peers)
        finally:
            for p in patches:
                p.stop()

    block_rows = (None,) if args.self_only else (64, 32)
    if not args.skip_checks:
        readings = {}
        for layers, t_in, t_out, batch, k, pool, window, dv in CASES:
            m, params, enc, y0, peers = case(cs, dev, layers, t_in, t_out, batch, k, pool, window, dv)
            tiers = (tier,) if tier == torch.float32 else (tier, torch.float32)
            refs = {t: plain(transformer, params, m, enc, y0, peers, t) for t in tiers}
            for rows in block_rows:
                out = call("kernels", m, params, enc, y0, peers, rows)
                again = call("kernels", m, params, enc, y0, peers, rows)
                torch.cuda.synchronize()
                key = (f"L={layers} {t_in}+{t_out} B={batch} K={k} {pool} w={window}" + (" grouped dv" if dv else "")
                       + f" rows={rows}")
                readings[key] = {**{str(t)[6:]: (out - r).abs().max().item() for t, r in refs.items()},
                                 "finite": bool(torch.isfinite(out).all()),
                                 "repeat_bit_equal": bool(torch.equal(out, again))}
                if k and not dv:
                    alone = call("kernels", m, params, enc, y0, {}, rows)
                    readings[key]["no_peer_row"] = (out[0] - alone[0]).abs().max().item()
        gates = f"{cs.BF16_TOL} and {cs.BF16_F32_TOL}" if tier == torch.bfloat16 else f"{cs.TF_TOL}"
        print(f"fused_ar_decode {args.tier} against its plain versions (largest gaps; gates {gates}): "
              f"{json.dumps(readings)}", flush=True)

    shapes = {"transformer-30 B=16384": (2, 30, 30, 16384, 4, "none", 0),
              "transformer-10s per row B=4096": (2, 100, 100, 4096, 4, "none", 8)}
    if tier == torch.float32:
        shapes["transformer-30 B=65536"] = (2, 30, 30, 65536, 4, "none", 0)
    inputs = {}
    for label, (layers, t_in, t_out, batch, k, pool, window) in shapes.items():
        m, params, _, enc, y0, pm, pv = cs.tf_case(dev, batch, t_in, t_out, layers, k, pool, window, seed=16)
        inputs[label] = (m, params, enc, y0, {"peer_mem": pm, "peer_valid": pv})
    if tier == torch.float32:
        inputs["transformer-10s shared B=4096 G=8 dv"] = shared_inputs(cs, transformer, dev, 4096, 8)
    with torch.inference_mode():
        for label, (m, params, enc, y0, peers) in inputs.items():
            fns = {r if r else "kernel": (lambda r=r: call("kernels", m, params, enc, y0, peers, r))
                   for r in block_rows}
            ms = cs.in_turns(fns, dict.fromkeys(fns, 1 if "65536" in label else 2))
            chosen = "" if args.self_only else f" (the chooser's rows: {td.decode_rows(enc.shape[0], _build.sm_count(dev))})"
            print(f"{label}: a call (ms, CUDA events, in turns; {smi}){chosen}: {json.dumps(ms)}", flush=True)
        if args.self_only:
            return
        lib = libs["probe"]
        for label in list(inputs)[:2]:
            m, params, enc, y0, peers = inputs[label]
            buf = (ctypes.c_ulonglong * len(PARTS))()
            call("probe", m, params, enc, y0, peers)
            torch.cuda.synchronize()
            lib.transformer_decode_probe_read(buf)  # drop the first call's counts
            ms = cs.cuda_ms(lambda: call("probe", m, params, enc, y0, peers), 1)
            lib.transformer_decode_probe_read(buf)
            total = sum(buf)
            blocks = 2 * -(-enc.shape[0] // td.decode_rows(enc.shape[0], _build.sm_count(dev)))  # two calls counted
            split = {"ms": round(ms, 3), "clocks a block": round(total / blocks),
                     **{part: round(v / total, 4) for part, v in zip(PARTS, buf) if v}}
            print(f"{label}: time split of the probe build (thread 0's clock64 a part, summed over the blocks; "
                  f"{smi}): {json.dumps(split)}", flush=True)


if __name__ == "__main__":
    main()
