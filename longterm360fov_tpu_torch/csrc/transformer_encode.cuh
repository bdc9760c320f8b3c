// What the transformer encoder's kernels share: the pointer table of a
// layer's weights, the layout of the training forward's stash, and the copy
// of a block's rows out of shared memory. The kernels replace the TPU
// Pallas kernels of longterm360fov_tpu/ops/transformer_encode.py
// (fused_encode_tokens: transformer_encode.cu) and
// ops/transformer_encode_train.py (fused_encode_train:
// transformer_encode_train.cu), whose headers give each one's bound on this
// card. Their forward, a block of 64 token rows (the T tokens of 64 / T
// viewers), is encode_rows_tf32 (transformer_f32mma.cuh: the products
// f32-accurate on the tensor cores as three-pass TF32, 2.35 ms of work at
// B = 16384, T = 30, L = 2, against 6.0 ms on the FMA units) in f32 and
// encode_rows_mma (transformer_mma.cuh) in bf16:
//   x = past · in_proj + pos, then L pre-LN layers of
//   x0 = x; q, k, v = LN1(x0) · Wq, Wk, Wv; att = attend(q, k, v);
//   x1 = x0 + att · Wo; x = x1 + gelu(LN2(x1) · W1 + b1) · W2 + b2
// → enc rows. What is left is in the kernels' headers: wgmma (both TF32
// operands k-major in shared memory) and a split-K weight-gradient pass.

#pragma once

#include "transformer_common.cuh"

#define MAX_LAYERS 8

namespace tfm {

// a layer's weights: ln1 scale and bias, wq, wk, wv, wo (H, H), ln2 scale and
// bias, w1 (H, 4H), b1 (4H,), w2 (4H, H), b2 (H,)
enum EncPtr { LN1_S, LN1_B, WQ, WK, WV, WO, LN2_S, LN2_B, W1, B1, W2, B2, ENC_PTRS };

struct EncParams {
  const float* layer[MAX_LAYERS][ENC_PTRS];
  const float* w_in;  // (d, H)
  const float* pos;   // (t, H) positional encoding
};

// what the training forward stashes a layer, each (n_tokens, H) f32 in
// (layers, STASH, n_tokens, H): the layer input x0, x1 after the attention
// residual, q, k, v and the attention output before Wo
enum Stash { ST_X0, ST_X1, ST_Q, ST_K, ST_V, ST_ATT, STASH };

// rows m < n_tok of a (ROWS, LDX) shared buffer to dst rows tok0 + m of an
// (n_tokens, H) array: a warp a row
__device__ __forceinline__ void rows_out(const float* src, float* __restrict__ dst, size_t tok0,
                                         int n_tok) {
  const int lane = threadIdx.x & 31;
  for (int m = threadIdx.x >> 5; m < n_tok; m += THREADS / 32)
    reinterpret_cast<float4*>(dst + (tok0 + m) * H)[lane] =
        *reinterpret_cast<const float4*>(src + m * LDX + 4 * lane);
}

}  // namespace tfm

