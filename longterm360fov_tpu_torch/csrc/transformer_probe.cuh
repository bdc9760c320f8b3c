// The probe build of the transformer kernels (-DTFM_PROBE): probe.cuh's
// in-kernel clock64 counters. Thread 0 of every block adds the clocks it
// spends in each part of its work to g_probe (the encoders' Part) or
// g_dec_probe (the decoder's DecPart); the library's *_probe_read entry
// point copies the sums out and zeroes them. Without TFM_PROBE the marks
// compile to nothing.

#pragma once

#include "probe.cuh"

namespace tfm {

// the parts of the probe build's time split
enum Part {
  P_PRO,    // prologue: staging past, pos and in_proj
  P_IN,     // x = past · in_proj + pos
  P_LN,     // layer norms (the reverse: recomputed LN1 and LN2, and their backward)
  P_WAIT,   // the bf16 weight stream: waiting for a chunk (the f32 products stage
            // theirs among their mma, in P_MMA)
  P_MMA,    // the products' inner loops
  P_EPI,    // the products' epilogues (q, k, v stores, residual adds, gradient stores)
  P_GELU,   // b1 + GELU (the reverse: GELU and dGELU of the recomputed pre-activation)
  P_ATT,    // the attention (the reverse: its backward)
  P_BAR,    // block barriers
  P_OUT,    // the output rows (the reverse: d_x and in_proj's gradient)
  P_STASH,  // the forward's stash writes; the reverse's stash reads
  P_DW,     // the reverse's weight-gradient products (X^T · Y over the block's rows)
  P_PARTW,  // the reverse's partial-gradient writes (the dW tiles, bias and LN column sums)
  PARTS
};

__device__ unsigned long long g_probe[PARTS];

// the parts of the decoder's time split (transformer_decode.cu)
enum DecPart {
  DP_PROD,   // the products: their inner loops (f32: with the split of the next chunk among the mma)
  DP_WAIT,   // the weight stream: bf16, waiting for a chunk; f32, the chunk barriers
  DP_EPI,    // the layer norms and the products' epilogues
  DP_SELF,   // self attention over the cache, the cache writes included
  DP_CROSS,  // cross attention over the encoder's K/V
  DP_PEER,   // peer attention over the valid, in-window peer tokens, δv included
  DP_IO,     // in_proj of the fed-back token, out_proj and the feedback
  DP_BAR,    // block barriers between the phases
  DEC_PARTS
};

__device__ unsigned long long g_dec_probe[DEC_PARTS];
#ifdef TFM_PROBE
using Probe = ClockProbe<true>;
#else
using Probe = ClockProbe<false>;
#endif

__device__ __forceinline__ void sync_probe(Probe& pr) {
  __syncthreads();
  pr.mark(P_BAR);
}

// a block barrier of the decoder: the work before it is `part`'s
__device__ __forceinline__ void sync_dec(Probe& pr, int part) {
  pr.mark(part);
  __syncthreads();
  pr.mark(DP_BAR);
}

}  // namespace tfm
