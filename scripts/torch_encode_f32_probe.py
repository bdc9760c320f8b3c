"""Probe of the PyTorch port's f32 transformer encoder on one NVIDIA card:
the serving kernel's f32 tier (``ops.transformer_encode.fused_encode_tokens``)
and the training kernels (``ops.transformer_encode_train``: the forward with
the stash and the reverse).

Run from the root of a checkout: ``python3 scripts/torch_encode_f32_probe.py``.
``--checkout DIR`` imports the port (and its ``chip_smoke.py``) from another
checkout instead, such as an unpacked older commit; ``--self-only`` then
skips what that checkout may lack (the probe and one-pass builds, the
microbenchmark). Prints, on the card it finds (it fails without one):

1. the card's name and power limit;
2. the serving kernel's f32 tier against its plain version
   (``transformer._encode``) at the card tests' shapes
   (``tests/test_torch_kernel_cuda.py``), made as those tests make them: the
   largest gap and whether a repeat is bit-equal; then the same for a
   one-pass build (``-DTFM_ONE_PASS``: the products' small terms dropped);
   the training kernels: the forward against plain, every gradient against
   autograd through ``_encode`` relative to max(|g|, 1);
3. times, CUDA events, in turns (``chip_smoke.in_turns``): the serving
   kernel at B = 16384 and 65,536 (T = 30, L = 2) against its plain version
   and ``nn.TransformerEncoder`` with the same weights; the forward with
   the stash and the reverse at B = 4096 against their plain versions and
   ``nn.TransformerEncoder`` under autograd (``chip_smoke.time_encode_train``);
4. unless ``--self-only``: the time splits of the probe builds
   (``-DTFM_PROBE``: thread 0 of every block adds its ``clock64`` deltas per
   part: ``chip_smoke.encode_split``, ``encode_train_splits``), and a
   microbenchmark of ``mma.sync`` m16n8k8 TF32 with f32 accumulators (independent chains per
   warp, four blocks an SM, no shared memory), in TFLOP/s.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# the card tests' shapes (layers, T, B): the serving kernel's and the training kernels'
SERVE_SHAPES = ((2, 30, 257), (1, 6, 8), (3, 64, 5), (2, 7, 1), (2, 30, 16387), (2, 1, 65), (8, 30, 50),
                (2, 64, 3))
TRAIN_SHAPES = ((2, 30, 257), (1, 6, 8), (3, 64, 5), (2, 13, 1), (2, 30, 4096), (2, 1, 65), (8, 30, 20),
                (2, 64, 3))

MMA_BENCH = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include "tensor_core.cuh"

template <int ACC>
__global__ void mma_loop(float* out, int iters) {
  unsigned a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const unsigned b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  float c[ACC][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < ACC; ++j) mma_tf32(c[j], a, b0, b1);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < ACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int ACC>
void run(int warps, int sms, float* out) {
  const int iters = 4096, blocks = 4 * sms;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  mma_loop<ACC><<<blocks, warps * 32>>>(out, 16);
  cudaEventRecord(e0);
  mma_loop<ACC><<<blocks, warps * 32>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * 16 * 8 * 8 * ACC * (double)iters * warps * blocks;
  printf("%d %d %.1f %s\n", warps, ACC, flop / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, 4 * sms * 1024 * sizeof(float));
  for (int w : {4, 8, 16}) {
    run<4>(w, sms, out);
    run<8>(w, sms, out);
    run<16>(w, sms, out);
  }
  return 0;
}
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose port to import")
    ap.add_argument("--self-only", action="store_true",
                    help="skip the probe and one-pass builds and the microbenchmark")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device; this probe runs only on the card")
    sys.path.insert(0, args.checkout)
    import chip_smoke
    from longterm360fov_tpu_torch.models import transformer
    from longterm360fov_tpu_torch.ops import _build, fused_lstm
    from longterm360fov_tpu_torch.ops import transformer_encode as te

    fused_lstm.exact_f32_matmul()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; port from {args.checkout}", flush=True)
    dev = torch.device("cuda:0")
    if not args.self_only:  # one nvcc each, started together
        with ThreadPoolExecutor(max_workers=5) as pool:
            jobs = {"probe": pool.submit(_build.build, "transformer_encode", ("TFM_PROBE",)),
                    "train_probe": pool.submit(_build.build, "transformer_encode_train", ("TFM_PROBE",)),
                    "one_pass": pool.submit(_build.build, "transformer_encode", ("TFM_ONE_PASS",)),
                    "serve": pool.submit(_build.build, "transformer_encode"),
                    "train": pool.submit(_build.build, "transformer_encode_train")}
            builds = {k: j.result() for k, j in jobs.items()}
        chip_smoke.PROBE_BUILD, chip_smoke.PROBE_TRAIN_BUILD = builds["probe"], builds["train_probe"]
        for k, b in builds.items():
            print(f"build {k}: {b.seconds:.1f} s; {chip_smoke.ptxas_report(b.log)}", flush=True)

    serve = {}
    one_pass = None if args.self_only else te.bind(ctypes.CDLL(str(builds["one_pass"].path)))
    for layers, t, batch in SERVE_SHAPES:
        m, params, past_n, enc, *_ = chip_smoke.tf_case(dev, batch, t, 4, layers, seed=layers)
        with torch.inference_mode():
            out = te.fused_encode_tokens(params, m, past_n)
            again = te.fused_encode_tokens(params, m, past_n)
            reading = {"max_abs_err": (out - enc).abs().max().item(),
                       "repeat_bit_equal": bool(torch.equal(out, again))}
            if one_pass is not None:
                tensors, _ = te.layer_pointers(params["enc"], te._ENC_LEAVES, m.hidden)
                pos = transformer._pos_enc(t, m.hidden, device=dev)
                one = te.launch(one_pass, tensors, params["in_proj"], pos, past_n, torch.float32)
                reading["one_pass_max_abs_err"] = (one - enc).abs().max().item()
        serve[f"L={layers} T={t} B={batch}"] = reading
    print(f"fused_encode_tokens f32 against plain (tolerance {chip_smoke.TF_TOL}): {json.dumps(serve)}", flush=True)
    train = {}
    for layers, t, batch in TRAIN_SHAPES:
        try:
            train[f"L={layers} T={t} B={batch}"] = chip_smoke.check_encode_train(dev, batch, t, layers,
                                                                                   seed=layers + t, repeat=batch == 257)
        except AssertionError as e:  # reported, and the probe goes on
            train[f"L={layers} T={t} B={batch}"] = str(e)
    print(f"fused_encode_train against plain and autograd (forward {chip_smoke.TF_TOL}, gradients "
          f"{chip_smoke.GRAD_TOL}·max(|g|, 1)): {json.dumps(train)}", flush=True)

    for batch in (16384, 65536):
        m, params, past_n, *_ = chip_smoke.tf_case(dev, batch, 30, 4, 2, seed=0)
        net = chip_smoke.encoder_library(params, dev)
        emb = past_n @ params["in_proj"] + transformer._pos_enc(30, 128, device=dev)
        with torch.inference_mode():
            ms = chip_smoke.in_turns({"plain": lambda: transformer._encode(params, m, past_n),
                                      "kernel": lambda: te.fused_encode_tokens(params, m, past_n),
                                      "library": lambda: net(emb)}, {"plain": 2, "kernel": 5, "library": 5})
        print(f"fused_encode_tokens f32 alone at B={batch}, T=30, L=2 (ms, CUDA events, in turns; library "
              f"nn.TransformerEncoder; {smi}): {json.dumps(ms)}", flush=True)
    m, params, *_ = chip_smoke.tf_case(dev, 4096, 30, 4, 2, seed=0)
    chip_smoke.time_encode_train(dev, params, types.SimpleNamespace(model=m), 4096, smi)
    if args.self_only:
        return

    m, params, past_n, *_ = chip_smoke.tf_case(dev, 16384, 30, 4, 2, seed=0)
    ms, split, clocks = chip_smoke.encode_split(params, m, past_n)
    print(f"fused_encode_tokens f32 probe build at B=16384 ({ms:.3f} ms a call, {clocks:.0f} clocks a block): "
          f"{json.dumps(split)}", flush=True)
    m, params, past_n, *_ = chip_smoke.tf_case(dev, 4096, 30, 4, 2, seed=0)
    cot = torch.tensor(np.random.default_rng(0).normal(size=(4096, 30, 128)).astype(np.float32), device=dev)
    for name, (ms, split, clocks) in chip_smoke.encode_train_splits(params, m, past_n, cot).items():
        print(f"{name} probe build at B=4096 ({ms:.3f} ms a call, {clocks:.0f} clocks a block): {json.dumps(split)}",
              flush=True)

    work = Path(args.checkout) / "build" / "probe"
    work.mkdir(parents=True, exist_ok=True)
    (work / "mma_tf32_bench.cu").write_text(MMA_BENCH)
    exe = work / "mma_tf32_bench"
    subprocess.run([_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-I", str(_build.CSRC), "-o", str(exe), str(work / "mma_tf32_bench.cu")], check=True)
    rows = [ln.split(maxsplit=3) for ln in subprocess.run([str(exe)], capture_output=True, text=True,
                                                           check=True).stdout.splitlines()]
    rates = {f"{w} warps a block, {acc} accumulators a warp": float(tf) for w, acc, tf, err in rows
             if err == "no error"}
    print(f"mma.sync m16n8k8 tf32 alone, 4 blocks an SM (TFLOP/s, CUDA events; {smi}): {json.dumps(rates)}",
          flush=True)


if __name__ == "__main__":
    main()
