// The transformer encoder's forward for one block of 64 token rows, shared
// by the serving kernel (transformer_encode.cu) and the training forward
// that stashes what the reverse kernel reads (transformer_encode_train.cu):
// x = past · in_proj + pos, then L pre-LN layers of
//   x0 = x; q, k, v = LN1(x0) · Wq, Wk, Wv; att = attend(q, k, v);
//   x1 = x0 + att · Wo; x = x1 + gelu(LN2(x1) · W1 + b1) · W2 + b2
// → enc rows. A block holds the T tokens of `seqs` = 64 / T viewers; the
// residual stream, the LN output and q, k, v, the attention output or the
// MLP hidden layer sit in shared memory (transformer_common.cuh).

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

// The block's forward; smem holds SMEM_FLOATS floats. With kStash, stash
// (layers, STASH, n_tokens, H) receives every layer's x0, x1, q, k, v, att.
// T: the stored type of in_proj and the layers' matrices (Store<T>); both
// kernels instance it at float (the serving kernel's bf16 tier runs
// encode_rows_mma, transformer_mma.cuh). At __nv_bfloat16 every product's
// activation operand would be rounded to bf16 too (past, the LN outputs,
// the attention output, the GELU output), q, k, v f32.
template <bool kStash, typename T = float>
__device__ __forceinline__ void encode_rows(const EncParams& p, const float* __restrict__ past,
                                            float* __restrict__ enc, float* __restrict__ stash,
                                            int batch, int layers, int t, int d, int seqs,
                                            float* smem) {
  float* xs = smem;
  float* hs = xs + ROWS * LDX;
  float* big = hs + ROWS * LDX;
  float* qb = big;
  float* kb = big + ROWS * LDX;
  float* vb = big + 2 * ROWS * LDX;
  float* ab = big + 3 * ROWS * LDX;
  float* ws = big + BIG;  // gemm64's ring of weight slabs
  const int b0 = blockIdx.x * seqs;
  const int n_tok = min(seqs, batch - b0) * t;  // valid token rows
  const size_t tok0 = (size_t)b0 * t;
  const size_t n_tokens = (size_t)batch * t;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto stash_of = [=](int l, int s) { return stash + ((size_t)l * STASH + s) * n_tokens * H; };

  zero_smem(xs, SMEM_FLOATS);
  __syncthreads();
  // x = past · in_proj + pos
  for (int e = threadIdx.x; e < n_tok * H; e += THREADS) {
    const int m = e / H, n = e - m * H;
    const float* xp = past + (tok0 + m) * d;
    const T* w_in = as<T>(p.w_in);
    float acc = Store<T>::round(xp[0]) * Store<T>::ldg1(w_in + n);
    for (int i = 1; i < d; ++i) acc = fmaf(Store<T>::round(xp[i]), Store<T>::ldg1(w_in + i * H + n), acc);
    xs[m * LDX + n] = acc + __ldg(p.pos + (m % t) * H + n);
  }
  __syncthreads();

  for (int l = 0; l < layers; ++l) {
    const float* const* w = p.layer[l];
    if (kStash) rows_out(xs, stash_of(l, ST_X0), tok0, n_tok);
    layer_norm<T>(xs, hs, w[LN1_S], w[LN1_B]);
    __syncthreads();
    auto store_to = [](float* dst) {
      return [dst](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float* o = dst + (r0 + r) * LDX + c0;
          *reinterpret_cast<float4*>(o) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          *reinterpret_cast<float4*>(o + 4) = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
        }
      };
    };
    gemm64(hs, LDX, H, as<T>(w[WQ]), H, 0, ws, store_to(qb));
    gemm64(hs, LDX, H, as<T>(w[WK]), H, 0, ws, store_to(kb));
    gemm64(hs, LDX, H, as<T>(w[WV]), H, 0, ws, store_to(vb));
    __syncthreads();
    // bidirectional attention: a warp a query row, over its viewer's t keys
    for (int m = warp; m < n_tok; m += THREADS / 32) {
      const int first = (m / t) * t;
      Attend a;
      a.init(*reinterpret_cast<const float4*>(qb + m * LDX + 4 * lane));
      a.range<false, 4>(kb + first * LDX, vb + first * LDX, LDX, 0, t, nullptr);
      *reinterpret_cast<float4*>(ab + m * LDX + 4 * lane) = round4<T>(a.out());
    }
    __syncthreads();
    if (kStash) {
      rows_out(qb, stash_of(l, ST_Q), tok0, n_tok);
      rows_out(kb, stash_of(l, ST_K), tok0, n_tok);
      rows_out(vb, stash_of(l, ST_V), tok0, n_tok);
      rows_out(ab, stash_of(l, ST_ATT), tok0, n_tok);
    }
    auto add_to_x = [xs](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) xs[(r0 + r) * LDX + c0 + c] += acc[r][c];
    };
    gemm64(ab, LDX, H, as<T>(w[WO]), H, 0, ws, add_to_x);
    __syncthreads();
    if (kStash) rows_out(xs, stash_of(l, ST_X1), tok0, n_tok);
    layer_norm<T>(xs, hs, w[LN2_S], w[LN2_B]);
    __syncthreads();
    // u = gelu(h · W1 + b1), 128 columns a pass, into big (q, k, v, a are dead)
    const float* b1 = w[B1];
    auto gelu_to_u = [big, b1](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          big[(r0 + r) * LDU + c0 + c] = Store<T>::round(gelu_tanh(acc[r][c] + __ldg(b1 + c0 + c)));
    };
    for (int n0 = 0; n0 < MLP; n0 += H) gemm64(hs, LDX, H, as<T>(w[W1]), MLP, n0, ws, gelu_to_u);
    __syncthreads();
    const float* b2 = w[B2];
    auto mlp_to_x = [xs, b2](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) xs[(r0 + r) * LDX + c0 + c] += acc[r][c] + __ldg(b2 + c0 + c);
    };
    gemm64(big, LDU, MLP, as<T>(w[W2]), H, 0, ws, mlp_to_x);
    __syncthreads();
  }
  // enc_mem rows out
  rows_out(xs, enc, tok0, n_tok);
}

}  // namespace tfm

