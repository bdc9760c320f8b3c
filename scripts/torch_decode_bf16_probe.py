"""Probe of the PyTorch port's transformer decode in its bf16 tier
(``ops.transformer_decode.fused_ar_decode(compute_dtype=bfloat16)``, row 9c)
on one NVIDIA card.

Run from the root of a checkout: ``python3 scripts/torch_decode_bf16_probe.py``.
Prints, on the card it finds (it fails without one):

1. the card's name and power limit;
2. the builds of ``csrc/transformer_decode.cu``: the kernels' own, the
   design before the tensor cores (``-DDEC_FMA``: the bf16 tier on the FMA
   body) and the probe builds of both (``-DTFM_PROBE``); each bf16 kernel
   instance's registers, spills and shared memory (``ptxas -v``) and its
   count of ``HMMA`` instructions in the SASS (``cuobjdump -sass``);
3. the kernel against its bf16 and f32 plain versions (``transformer.
   _ar_decode``) in every tier (no peers; K = 4 per-row peers with a row of
   no valid peer; ``peer_pool`` "mean"; the window; group-shared peers with
   δv), in blocks of 64 and of 32 rows, at ragged batches: the largest gap
   to each, and whether a repeat is bit-equal;
4. the time of one call (the wrapper's K/V projections included) at
   ``transformer-30``'s B = 16384 (K = 4, 120 peer tokens) and at
   ``transformer-10s`` per row, B = 4096 (100 + 100 steps, window 8): the
   kernels' own build against the ``-DDEC_FMA`` build, in turns (CUDA
   events; ``chip_smoke.in_turns``), and blocks of 64 rows against blocks
   of 32;
5. the time split of both probe builds at both shapes: thread 0 of every
   block adds its ``clock64`` deltas per part (``transformer_probe.cuh``'s
   DecPart); each part's share of the clocks summed over the blocks.

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
BUILDS = {"mma": (), "fma": ("DEC_FMA",), "mma probe": ("TFM_PROBE",), "fma probe": ("TFM_PROBE", "DEC_FMA")}
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-checks", action="store_true", help="leave out the readings against the plain versions")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device; this probe runs only on the card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from longterm360fov_tpu_torch.models import transformer
    from longterm360fov_tpu_torch.ops import _build, fused_lstm
    from longterm360fov_tpu_torch.ops import transformer_decode as td

    fused_lstm.exact_f32_matmul()
    dev = torch.device("cuda:0")
    bf16 = torch.bfloat16
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    with ThreadPoolExecutor(len(BUILDS)) as pool:
        builds = dict(zip(BUILDS, pool.map(lambda d: _build.build("transformer_decode", d), BUILDS.values())))
    libs = {name: td.bind(ctypes.CDLL(str(b.path))) for name, b in builds.items()}
    nvcc = _build.find_nvcc()
    for name in ("mma", "fma"):
        hmma = sass_hmma(nvcc, builds[name].path)
        res = {}
        for sym in hmma:
            if "nv_bfloat16" in sym:
                cs.BUILD_LOGS["transformer_decode"] = builds[name].log
                res[sym] = {"HMMA": hmma[sym], **cs.ptxas_resources("transformer_decode", (sym,))}
        smem = {rows: libs[name].transformer_decode_smem_bytes(rows) for rows in (64, 32)}
        print(f"build {name} ({' '.join(BUILDS[name]) or 'the kernels own'}; nvcc {builds[name].seconds:.1f} s): "
              f"bf16 instances {json.dumps(res)}; dynamic shared memory at 64 / 32 rows {json.dumps(smem)}",
              flush=True)

    def with_lib(name, rows=None):
        patches = [mock.patch.object(td, "_library", lambda: libs[name])]
        if rows is not None:
            patches.append(mock.patch.object(td, "decode_rows", lambda batch, n_sm: rows))
        return patches

    def call(name, m, params, enc, y0, peers, rows=None):
        patches = with_lib(name, rows)
        for p in patches:
            p.start()
        try:
            return td.fused_ar_decode(params, m, enc, y0, compute_dtype=bf16, **peers)
        finally:
            for p in patches:
                p.stop()

    if not args.skip_checks:
        readings = {}
        for layers, t_in, t_out, batch, k, pool, window, dv in CASES:
            m, params, enc, y0, peers = case(cs, dev, layers, t_in, t_out, batch, k, pool, window, dv)
            refs = {tier: plain(transformer, params, m, enc, y0, peers, tier) for tier in (bf16, torch.float32)}
            for rows in (64, 32):
                out = call("mma", m, params, enc, y0, peers, rows)
                again = call("mma", m, params, enc, y0, peers, rows)
                torch.cuda.synchronize()
                key = (f"L={layers} {t_in}+{t_out} B={batch} K={k} {pool} w={window}" + (" grouped dv" if dv else "")
                       + f" rows={rows}")
                readings[key] = {"bf16": (out - refs[bf16]).abs().max().item(),
                                 "f32": (out - refs[torch.float32]).abs().max().item(),
                                 "finite": bool(torch.isfinite(out).all()),
                                 "repeat_bit_equal": bool(torch.equal(out, again))}
                if k and not dv:
                    alone = call("mma", m, params, enc, y0, {}, rows)
                    readings[key]["no_peer_row"] = (out[0] - alone[0]).abs().max().item()
        print(f"fused_ar_decode bf16 against its bf16 and f32 plain versions (largest gaps; gates "
              f"{cs.BF16_TOL} and {cs.BF16_F32_TOL}): {json.dumps(readings)}", flush=True)

    shapes = {"transformer-30 B=16384": (2, 30, 30, 16384, 4, "none", 0),
              "transformer-10s per row B=4096": (2, 100, 100, 4096, 4, "none", 8)}
    inputs = {}
    for label, (layers, t_in, t_out, batch, k, pool, window) in shapes.items():
        m, params, _, enc, y0, pm, pv = cs.tf_case(dev, batch, t_in, t_out, layers, k, pool, window, seed=16)
        inputs[label] = (m, params, enc, y0, {"peer_mem": pm, "peer_valid": pv})
    with torch.inference_mode():
        for label, (m, params, enc, y0, peers) in inputs.items():
            fns = {"fma": lambda: call("fma", m, params, enc, y0, peers),
                   "mma": lambda: call("mma", m, params, enc, y0, peers)}
            ms = cs.in_turns(fns, {"fma": 1, "mma": 2})
            rows = cs.in_turns({r: (lambda r=r: call("mma", m, params, enc, y0, peers, r)) for r in (64, 32)},
                               {64: 2, 32: 2})
            print(f"{label}: a call (ms, CUDA events, in turns; {smi}): {json.dumps(ms)}; the kernels' build in "
                  f"blocks of 64 and of 32 rows (the chooser's: {td.decode_rows(enc.shape[0], td._n_sm(enc.device))}) {json.dumps(rows)}",
                  flush=True)
        for label, (m, params, enc, y0, peers) in inputs.items():
            splits = {}
            for name in ("fma probe", "mma probe"):
                lib = libs[name]
                buf = (ctypes.c_ulonglong * len(PARTS))()
                call(name, m, params, enc, y0, peers)
                torch.cuda.synchronize()
                lib.transformer_decode_probe_read(buf)  # drop the first call's counts
                ms = cs.cuda_ms(lambda: call(name, m, params, enc, y0, peers), 1)
                lib.transformer_decode_probe_read(buf)
                total = sum(buf)
                rows = 64 if name == "fma probe" else td.decode_rows(enc.shape[0], td._n_sm(enc.device))
                blocks = 2 * -(-enc.shape[0] // rows)  # two calls counted
                splits[name] = {"ms": round(ms, 3), "clocks a block": round(total / blocks),
                                **{part: round(v / total, 4) for part, v in zip(PARTS, buf) if v}}
            print(f"{label}: time split of the probe builds (thread 0's clock64 a part, summed over the blocks; "
                  f"{smi}): {json.dumps(splits)}", flush=True)


if __name__ == "__main__":
    main()
