"""Probe of the PyTorch port's transformer encoder in its bf16 tier
(``ops.transformer_encode.fused_encode_tokens(compute_dtype=bfloat16)``)
on one NVIDIA card.

Run from the root of a checkout: ``python3 scripts/torch_encode_bf16_probe.py``.
``--checkout DIR`` imports the port (and its ``chip_smoke.py``) from another
checkout instead, such as an unpacked older commit; ``--self-only`` then
skips what that checkout may lack (the probe build, the microbenchmark).
Prints, on the card it finds (it fails without one):

1. the card's name and power limit;
2. the kernel against its bf16 and f32 plain versions at the card tests'
   shapes (``tests/test_torch_kernel_cuda.py``: five of the f32 test, T = 1
   and L = 8), each made as those tests make it: the largest gap to each
   plain version, the floor (the kernel's mean gap from the f32 plain
   version over the bf16 plain version's) and whether a repeat is
   bit-equal;
3. its time alone at B = 16384, T = 30, L = 2 against
   ``nn.TransformerEncoder`` in bf16 with the same weights, in turns
   (CUDA events; ``chip_smoke.in_turns``);
4. unless ``--self-only``: the time split of the probe build
   (``-DTFM_PROBE``: thread 0 of every block adds its ``clock64`` deltas
   per part), and a microbenchmark of ``mma.sync`` m16n8k16 bf16 with f32
   accumulators (independent accumulator chains per warp, four blocks an
   SM, no shared memory), in TFLOP/s.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2, 30, 257), (1, 6, 8), (3, 64, 5), (2, 7, 1), (2, 30, 16387), (2, 1, 100), (8, 30, 50))

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
    for (int j = 0; j < ACC; ++j) mma_bf16(c[j], a, b0, b1);
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
  const double flop = 2.0 * 16 * 8 * 16 * ACC * (double)iters * warps * blocks;
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


def case(seq2seq, transformer, params_from_numpy, walk, layers, t, batch, seed):
    """tests/test_torch_kernel_cuda.py's _tfm_case: random LN scales and
    biases moved off 1 and 0, pasts from numpy → (cfg, params, past)."""
    cfg = seq2seq.Seq2SeqConfig(hidden=128, layers=layers, h_in=t, h_out=4)
    params = transformer.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    rng = np.random.default_rng(seed)
    for leaf in [v for lay in params["enc"] + params["dec"] for sub in lay.values()
                 for key, v in sub.items() if key in ("scale", "bias", "b1", "b2")]:
        leaf += torch.tensor(rng.normal(size=leaf.shape).astype(np.float32) * 0.1)
    params = params_from_numpy(walk(params, lambda _, x: x.numpy()), "cuda")
    past = torch.tensor(rng.normal(size=(batch, t, 3)).astype(np.float32) * 0.3, device="cuda")
    return cfg, params, past


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(ROOT), help="the checkout whose port to import")
    ap.add_argument("--self-only", action="store_true", help="skip the probe build and the microbenchmark")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch sees no CUDA device; this probe runs only on the card")
    sys.path.insert(0, args.checkout)
    import chip_smoke
    from longterm360fov_tpu_torch.models import seq2seq, transformer
    from longterm360fov_tpu_torch.ops import _build, fused_lstm
    from longterm360fov_tpu_torch.ops import transformer_encode as te
    from longterm360fov_tpu_torch.params import params_from_numpy, walk

    fused_lstm.exact_f32_matmul()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; port from {args.checkout}", flush=True)
    bf16 = torch.bfloat16

    readings = {}
    for layers, t, batch in SHAPES:
        cfg, params, past = case(seq2seq, transformer, params_from_numpy, walk, layers, t, batch, seed=layers)
        out = te.fused_encode_tokens(params, cfg, past, compute_dtype=bf16)
        again = te.fused_encode_tokens(params, cfg, past, compute_dtype=bf16)
        plain, f32 = transformer._encode(params, cfg, past, bf16), transformer._encode(params, cfg, past)
        readings[f"L={layers} T={t} B={batch}"] = {
            "bf16": (out - plain).abs().max().item(), "f32": (out - f32).abs().max().item(),
            "plain_bf16_to_f32": (plain - f32).abs().max().item(),
            "floor": (out - f32).abs().mean().item() / (plain - f32).abs().mean().item(),
            "repeat_bit_equal": bool(torch.equal(out, again))}
    print(f"fused_encode_tokens bf16 against its bf16 and f32 plain versions (largest gaps, floor): "
          f"{json.dumps(readings)}", flush=True)

    cfg, params, past = case(seq2seq, transformer, params_from_numpy, walk, 2, 30, 16384, seed=0)
    net = chip_smoke.encoder_library(params, "cuda").to(bf16)
    emb = (past @ params["in_proj"] + transformer._pos_enc(30, 128, device="cuda")).to(bf16)
    with torch.inference_mode():
        ms = chip_smoke.in_turns({"kernel": lambda: te.fused_encode_tokens(params, cfg, past, compute_dtype=bf16),
                                  "library": lambda: net(emb)}, {"kernel": 5, "library": 5})
    print(f"fused_encode_tokens bf16 alone at B=16384, T=30, L=2 against nn.TransformerEncoder in bf16 (ms, CUDA "
          f"events, in turns; {smi}): {json.dumps(ms)}", flush=True)
    if args.self_only:
        return

    probe = te.bind(ctypes.CDLL(str(_build.build("transformer_encode", ("TFM_PROBE",)).path)))
    probe.transformer_encode_probe_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * len(chip_smoke.PROBE_PARTS))()
    tensors, _ = te.layer_pointers(params["enc"], te._ENC_LEAVES, 128)
    pos = transformer._pos_enc(30, 128, device="cuda")
    with torch.inference_mode():
        te.launch(probe, tensors, params["in_proj"], pos, past, bf16)
        torch.cuda.synchronize()
        probe.transformer_encode_probe_read(buf)  # drop the first call's counts
        te.launch(probe, tensors, params["in_proj"], pos, past, bf16)
        torch.cuda.synchronize()
        probe.transformer_encode_probe_read(buf)
    total = sum(buf)
    split = {part: round(v / total, 4) for part, v in zip(chip_smoke.PROBE_PARTS, buf)}
    print(f"time split of the probe build ({total / 8192:.0f} clocks a block): {json.dumps(split)}", flush=True)

    work = Path(args.checkout) / "build" / "probe"
    work.mkdir(parents=True, exist_ok=True)
    (work / "mma_bench.cu").write_text(MMA_BENCH)
    exe = work / "mma_bench"
    subprocess.run([_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-I", str(_build.CSRC), "-o", str(exe), str(work / "mma_bench.cu")], check=True)
    rows = [ln.split(maxsplit=3) for ln in subprocess.run([str(exe)], capture_output=True, text=True,
                                                           check=True).stdout.splitlines()]
    rates = {f"{w} warps a block, {acc} accumulators a warp": float(tf) for w, acc, tf, err in rows
             if err == "no error"}
    print(f"mma.sync m16n8k16 bf16 alone, 4 blocks an SM (TFLOP/s, CUDA events; {smi}): {json.dumps(rates)}",
          flush=True)


if __name__ == "__main__":
    main()
