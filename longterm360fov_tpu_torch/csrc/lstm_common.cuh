// Device code shared by the training kernels of lstm_train.cu, lstm_ss.cu
// and lstm_align.cu, for Hopper (sm_90a), f32 or bf16 compute, residuals in
// f32 or bf16:
//   * Res<RT>, the residual type (f32, or bf16 rounded to nearest even as
//     torch and XLA cast);
//   * the compute type CT of compute_type.cuh (cround, ldw4, ldw1): an
//     activation (h, x, dgates, dy) is kept in f32 and rounded where it
//     enters a product. Carries, gates, the cell update, residual stores and
//     the sums db, dproj_b stay f32;
//   * the thread tile of the forwards and the decoder backward: TR = 4 batch
//     rows x TJ = 4 hidden units per thread, a layer input held k-major
//     (K, R) in shared memory, and accumulate<NG>, the FMA loop that reads W
//     rows with 16-byte loads (the peer backward of lstm_align.cu has its
//     own tiles on the tensor cores, tensor_core.cuh's mma.sync);
//   * fwd_layer_step, one forward layer-step with its residual stores;
//   * the cp.async copies (16 and 4 bytes, groups) of the dW products and
//     the peer backward;
//   * the deterministic dW/db reduction: lstm_dw_pack_kernel writes each
//     layer's z = [h_{t-1}, input_t, 1] once, in the compute type, building
//     it with the MODE loader (the teacher-forced LSTM; layer 0 of the
//     scheduled-sampling decoder, whose input [x_t, ctx] with x_t = coin_t >
//     0 ? teacher_t : y_{t-1} is rebuilt from the forward's outputs as the
//     TPU backward rebuilds it; its lockstep variant, ctx summed from the
//     peers' residual h); lstm_dw_partial_kernel sums zᵀ·dgates over slices
//     of the (b, t) rows, on tensor cores in bf16 and exact FMAs in f32;
//     lstm_dw_sum_kernel adds the slices in a fixed order (no float atomics).
// lstm_train.cu's header says what bounds these kernels on the card and how
// the design answers it; lstm_align.cu's, the peer backward's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "compute_type.cuh"
#include "tensor_core.cuh"

#define MAX_LAYERS 8
#define TR 4        // batch rows per thread
#define TJ 4        // hidden units per thread: one float4 of each gate

// ---------------------------------------------------------------------------
// residual type: f32 or bf16 (round to nearest even, as torch and XLA cast)
// ---------------------------------------------------------------------------

template <typename RT>
struct Res;

template <>
struct Res<float> {
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  static __device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Res<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void ld4(const __nv_bfloat16* p,
                                             float (&v)[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  }
  static __device__ __forceinline__ void st4(__nv_bfloat16* p,
                                             const float (&v)[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

using F = Res<float>;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[g][r][j] += sum_{k<K} z[k][r0 + r] * W[k][g * goff + j0 + j].
// z is k-major (K, R) in shared memory, so the thread's 4 rows are one
// float4 (a broadcast: a warp shares its rows), rounded to CT as they enter
// the product; W (CT) rows are ldw values long.
template <int NG, typename CT>
__device__ __forceinline__ void accumulate(float (&acc)[NG][TR][TJ],
                                           const float* z, int K,
                                           const CT* __restrict__ W,
                                           int ldw, int goff, int R, int r0,
                                           int j0) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TR];
    F::ld4(z + k * R + r0, a);
#pragma unroll
    for (int r = 0; r < TR; ++r) a[r] = cround<CT>(a[r]);
    const CT* wk = W + (size_t)k * ldw + j0;
    float w[NG][TJ];
#pragma unroll
    for (int g = 0; g < NG; ++g) ldw4(wk + g * goff, w[g]);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int j = 0; j < TJ; ++j)
          acc[g][r][j] = fmaf(a[r], w[g][j], acc[g][r][j]);
  }
}

// z[k][r0 .. r0 + 3] = v[0 .. 3][j] for the thread's 4 rows: one 16-byte
// store per k (a k-major column of 4 rows)
__device__ __forceinline__ void st_rows(float* z, int k, int R, int r0,
                                        const float (&v)[TR][TJ], int j) {
  *reinterpret_cast<float4*>(z + k * R + r0) =
      make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

template <int NG>
__device__ __forceinline__ void zero(float (&acc)[NG][TR][TJ]) {
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int j = 0; j < TJ; ++j) acc[g][r][j] = 0.0f;
}

// h_s[l] and owner-private c_s[l] of the block's rows from (L, B, H) states
__device__ __forceinline__ void load_states(float* h_s, float* c_s,
                                            const float* __restrict__ h0,
                                            const float* __restrict__ c0,
                                            long long row0, int B, int H,
                                            int L, int R, int r0, int j0,
                                            int tid, int nthr) {
  const int HR = H * R;
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const long long row = row0 + r0 + r;
      float vh[TJ] = {0.0f, 0.0f, 0.0f, 0.0f}, vc[TJ] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (row < B) {
        F::ld4(h0 + ((size_t)l * B + row) * H + j0, vh);
        F::ld4(c0 + ((size_t)l * B + row) * H + j0, vc);
      }
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        h_s[l * HR + (j0 + j) * R + r0 + r] = vh[j];
        c_s[l * HR + (r * TJ + j) * nthr + tid] = vc[j];
      }
    }
}

// One forward layer-step for the block's R rows: gates = [in, h] @ W + b, the
// cell update, and the residual stores. in: (k_in, R) layer input; h: (H, R)
// this layer's hidden state, read and then overwritten; c: this layer's cell
// state, owner-private [TR * TJ][nthr]. GATES = false stores h and c only
// (the lockstep peer encoder, whose backward recomputes its gates). W is in
// the compute type CT.
template <typename RT, bool GATES = true, typename CT>
__device__ __forceinline__ void fwd_layer_step(
    const float* in, int k_in, float* h, float* c, const CT* __restrict__ W,
    const float* __restrict__ bias, RT* hs, RT* cs, RT* gs, long long row0,
    int B, int T, int t, int H, int R, int r0, int j0, int tid, int nthr) {
  float acc[4][TR][TJ];
  zero(acc);
  accumulate<4>(acc, in, k_in, W, 4 * H, H, R, r0, j0);
  accumulate<4>(acc, h, H, W + (size_t)k_in * 4 * H, 4 * H, H, R, r0, j0);
  __syncthreads();  // every thread is done reading h (and in) of this step

  float b[4][TJ];
#pragma unroll
  for (int g = 0; g < 4; ++g) F::ld4(bias + g * H + j0, b[g]);
  float hv[TR][TJ];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    float gv[4][TJ], cv[TJ];
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      gv[0][j] = sigmoid_f32(acc[0][r][j] + b[0][j]);
      gv[1][j] = sigmoid_f32(acc[1][r][j] + b[1][j]);
      gv[2][j] = tanhf(acc[2][r][j] + b[2][j]);
      gv[3][j] = sigmoid_f32(acc[3][r][j] + b[3][j]);
      const int idx = (r * TJ + j) * nthr + tid;
      cv[j] = gv[1][j] * c[idx] + gv[0][j] * gv[2][j];
      hv[r][j] = gv[3][j] * tanhf(cv[j]);
      c[idx] = cv[j];
    }
    const long long row = row0 + r0 + r;
    if (row < B) {
      const size_t q = (size_t)row * T + t;
      if constexpr (GATES) {
#pragma unroll
        for (int g = 0; g < 4; ++g) Res<RT>::st4(gs + q * 4 * H + g * H + j0, gv[g]);
      }
      Res<RT>::st4(cs + q * H + j0, cv);
      Res<RT>::st4(hs + q * H + j0, hv[r]);
    }
  }
#pragma unroll
  for (int j = 0; j < TJ; ++j) st_rows(h, j0 + j, R, r0, hv, j);
  __syncthreads();  // the new h is visible to the next layer and step
}

// One backward layer-step's cell part for the thread's rows: dgates from the
// residuals (gates, c_t, c_{t-1}; c0 at t = 0) and the gradients arriving at
// this layer's h (`above` plus the carried dh) and c (the carried dc). Writes
// dgates to device memory and k-major to dg_s, and carries dc = dc_total · f.
template <typename RT>
__device__ __forceinline__ void bwd_cell_step(
    const RT* gs, const RT* cs, const float* __restrict__ c0, float* dgates,
    const float (&above)[TR][TJ], float* dh_l, float* dc_l, float* dg_s,
    long long row0, int B, int T, int t, int l, int H, int R, int r0, int j0,
    int tid, int nthr) {
  const int G = 4 * H;
  float dgv[4][TR][TJ];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const long long row = row0 + r0 + r;
    float gv[4][TJ], ct[TJ], cp[TJ];
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      gv[0][j] = gv[1][j] = gv[2][j] = gv[3][j] = 0.0f;
      ct[j] = cp[j] = 0.0f;
    }
    if (row < B) {
      const size_t q = (size_t)row * T + t;
#pragma unroll
      for (int g = 0; g < 4; ++g) Res<RT>::ld4(gs + q * G + g * H + j0, gv[g]);
      Res<RT>::ld4(cs + q * H + j0, ct);
      if (t > 0)
        Res<RT>::ld4(cs + (q - 1) * H + j0, cp);
      else
        F::ld4(c0 + ((size_t)l * B + row) * H + j0, cp);
    }
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const int idx = (r * TJ + j) * nthr + tid;
      const float i_g = gv[0][j], f_g = gv[1][j], g_g = gv[2][j], o_g = gv[3][j];
      const float dh_total = above[r][j] + dh_l[idx];
      const float tanh_c = tanhf(ct[j]);
      const float dc_total = dh_total * o_g * (1.0f - tanh_c * tanh_c) + dc_l[idx];
      dgv[0][r][j] = dc_total * g_g * i_g * (1.0f - i_g);
      dgv[1][r][j] = dc_total * cp[j] * f_g * (1.0f - f_g);
      dgv[2][r][j] = dc_total * i_g * (1.0f - g_g * g_g);
      dgv[3][r][j] = dh_total * tanh_c * o_g * (1.0f - o_g);
      dc_l[idx] = dc_total * f_g;
    }
    if (row < B) {
      const size_t q = (size_t)row * T + t;
#pragma unroll
      for (int g = 0; g < 4; ++g) F::st4(dgates + q * G + g * H + j0, dgv[g][r]);
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < TJ; ++j) st_rows(dg_s, g * H + j0 + j, R, r0, dgv[g], j);
}

// The gradient of layer 0's first D input features at the block's rows below
// B: dx[r][d] = sum_k dg_s[k][r] * W[d][k] over the G = 4H gate columns of
// W's rows d < D, a thread per (row, d) with four partial sums; fn(r, d, dx)
// takes each. W is in the compute type CT, dgates rounded to it.
template <typename CT, typename Fn>
__device__ __forceinline__ void input_grad(const float* dg_s,
                                           const CT* __restrict__ W, int D,
                                           int G, int R, long long row0, int B,
                                           int tid, int nthr, Fn fn) {
  for (int i = tid; i < R * D; i += nthr) {
    const int r = i % R, d = i / R;
    if (row0 + r >= B) continue;
    const CT* wd = W + (size_t)d * G;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    for (int k = 0; k < G; k += 4) {
      s0 = fmaf(cround<CT>(dg_s[k * R + r]), ldw1(wd + k), s0);
      s1 = fmaf(cround<CT>(dg_s[(k + 1) * R + r]), ldw1(wd + k + 1), s1);
      s2 = fmaf(cround<CT>(dg_s[(k + 2) * R + r]), ldw1(wd + k + 2), s2);
      s3 = fmaf(cround<CT>(dg_s[(k + 3) * R + r]), ldw1(wd + k + 3), s3);
    }
    fn(r, d, (s0 + s1) + (s2 + s3));
  }
}

// ---------------------------------------------------------------------------
// dW / db reduction: a pack pass, then a split-K product on tiles of
// DW_F features x DW_T gate columns, then the fixed-order sum of the slices
// ---------------------------------------------------------------------------

#define DW_T 128  // dW tile: gate columns
#define DW_F 144  // dW tile: z features, 9 x 16 (nine m16 tiles of mma.sync)
#define DW_V 8    // z features a pack thread builds and stores (16 bytes in bf16)

struct DwArgs {
  const float* xs;     // (B, T, D): z's input part for layer 0 (teacher-forced)
  const float* h0;     // (B, H) this layer's initial h
  const void* hs;      // (B, T, H) this layer's residual h
  const void* cs_in;   // (B, T, H) the layer below's c; null for layer 0
  const void* gs_in;   // (B, T, 4H) the layer below's gates; null for layer 0
  const float* dg;     // (B, T, 4H) this layer's dgates
  // layer 0 of the scheduled-sampling decoder (coins != null): the input is
  // [x_t, ctx] with x_t = coin_t > 0 ? teacher_t : y_{t-1}, y_{-1} = y0
  const float* coins;    // (T, B)
  const float* teacher;  // (T, B, D)
  const float* ys;       // (B, T, D) the forward's outputs, f32
  const float* y0;       // (B, D)
  const float* ctx;      // (B, C); null when C == 0
  int C;
  // layer 0 of the lockstep-peer decoder (php != null): ctx_t is rebuilt as
  // Σ_k pwt[b, k] · php[b·K + k, t], k = 0 .. K - 1 in order, from the peer
  // encoder's residual h, as the TPU backward rebuilds it
  const void* php;    // (B·K, T, C) residual type
  const float* pwt;   // (B, K) mask weights
  int K;
};

// the reduction's z loaders: the teacher-forced LSTM, and layer 0 of the
// scheduled-sampling decoder with a static or a lockstep-peer context
enum DwMode { DW_TF = 0, DW_SS = 1, DW_ALIGN = 2 };

// 8 consecutive values of a residual-type (or f32) vector, widened to f32:
// one 16-byte load in bf16, two in f32
template <typename RT>
__device__ __forceinline__ void ld8(const RT* p, float (&v)[DW_V]);

template <>
__device__ __forceinline__ void ld8(const float* p, float (&v)[DW_V]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// bf16 → f32 is exact: the bf16 bits are the f32's upper half. Bit
// operations on values, not conversions through addresses, which would put
// the staging words in local memory.
template <>
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&v)[DW_V]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// two f32 rounded to bf16 (nearest even), low one first, as one word
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// 8 values stored in the compute type: two 16-byte stores in f32, one in bf16
__device__ __forceinline__ void st8(float* p, const float (&v)[DW_V]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void st8(__nv_bfloat16* p, const float (&v)[DW_V]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]), bf16x2(v[6], v[7]));
}

// input feature m of the layer at row q = b * T + t, one by one: o·tanh(c)
// of the layer below; or layer 0's input of the scheduled-sampling decoder,
// [x_t, ctx] with x_t = coin_t > 0 ? teacher_t : y_{t-1} and the static
// context; or xs. The lockstep context never comes here: it is whole
// 16-byte runs (C % 32 == 0, which align_dec_dw checks), built by z_chunk.
template <typename RT, int MODE>
__device__ __forceinline__ float z_in(const DwArgs& a, int q, int b, int t,
                                      int m, int B, int T, int D, int H) {
  if (a.gs_in != nullptr)
    return Res<RT>::ld(static_cast<const RT*>(a.gs_in) + (size_t)q * 4 * H + 3 * H + m) *
           tanhf(Res<RT>::ld(static_cast<const RT*>(a.cs_in) + (size_t)q * H + m));
  if constexpr (MODE == DW_TF) {
    return a.xs[(size_t)q * D + m];
  } else {
    if (MODE == DW_SS && m >= D) return a.ctx[(size_t)b * a.C + (m - D)];
    if (a.coins[(size_t)t * B + b] > 0.0f) return a.teacher[((size_t)t * B + b) * D + m];
    return t > 0 ? a.ys[(size_t)(q - 1) * D + m] : a.y0[(size_t)b * D + m];
  }
}

// The packed z of row q = b * T + t, in output order of features f:
//   [h_{t-1} (H) | input[nw:] (in - nw) | input[:nw] (nw) | 1 | 0 ...]
// with nw = D at layer 0 (x_t; its context, if any, is the wide part) and 0
// above (the whole input, o·tanh(c), is wide), so that the wide parts are
// whole 16-byte runs at any input width: h, the context and o·tanh(c) are
// read with 16-byte loads, the lockstep context summed over the K peers in
// order from them; the few narrow features (and a static context's ragged
// end) one by one. v: features f0 .. f0 + 7.
template <typename RT, int MODE>
__device__ __forceinline__ void z_chunk(const DwArgs& a, int q, int f0, int B,
                                        int T, int D, int H, int in, int nw,
                                        float (&v)[DW_V]) {
  const int b = q / T, t = q - b * T;
  if (f0 < H) {  // H % 32 == 0: whole chunks of h_{t-1}
    if (t > 0)
      ld8(static_cast<const RT*>(a.hs) + (size_t)(q - 1) * H + f0, v);
    else
      ld8(a.h0 + (size_t)b * H + f0, v);
    return;
  }
  const int u0 = f0 - H, wide = in - nw;
  if (u0 + DW_V <= wide) {
    if (a.gs_in != nullptr) {  // o·tanh(c) of the layer below (nw = 0)
      float o[DW_V], c[DW_V];
      ld8(static_cast<const RT*>(a.gs_in) + (size_t)q * 4 * H + 3 * H + u0, o);
      ld8(static_cast<const RT*>(a.cs_in) + (size_t)q * H + u0, c);
#pragma unroll
      for (int i = 0; i < DW_V; ++i) v[i] = o[i] * tanhf(c[i]);
      return;
    }
    if constexpr (MODE == DW_ALIGN) {  // ctx[u0 .. u0 + 7], k in order
      const RT* h = static_cast<const RT*>(a.php) + ((size_t)b * a.K * T + t) * a.C + u0;
#pragma unroll
      for (int i = 0; i < DW_V; ++i) v[i] = 0.0f;
      for (int k = 0; k < a.K; ++k) {
        float hk[DW_V];
        ld8(h + (size_t)k * T * a.C, hk);
        const float w = a.pwt[(size_t)b * a.K + k];
#pragma unroll
        for (int i = 0; i < DW_V; ++i) v[i] = fmaf(hk[i], w, v[i]);
      }
      return;
    } else if constexpr (MODE == DW_SS) {
      if (a.C % 4 == 0) {  // the static context, f32
        ld8(a.ctx + (size_t)b * a.C + u0, v);
        return;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < DW_V; ++i) {
    const int u = u0 + i;
    if (u < in)
      v[i] = z_in<RT, MODE>(a, q, b, t, u < wide ? nw + u : u - wide, B, T, D, H);
    else
      v[i] = u == in ? 1.0f : 0.0f;  // the constant feature of db, then zeros
  }
}

// Pack pass: zp (B·T, zld) in the compute type, zld = in + H + 1 rounded up
// to 8; a thread per 8 features of a row, consecutive threads along the row,
// so that loads and stores are coalesced. Every source of z is read once.
// One launch covers `rows` rows from q0, rows · zld / 8 < 2^31: the index
// math stays 32-bit (a 64-bit division is a subroutine call).
template <typename RT, int MODE, typename CT>
__global__ void __launch_bounds__(256)
    lstm_dw_pack_kernel(const DwArgs a, CT* __restrict__ zp, int q0, int rows, int B,
                        int T, int D, int H, int in, int nw, int zld) {
  const int per_row = zld / DW_V, total = rows * per_row;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int q = q0 + i / per_row, f0 = (i % per_row) * DW_V;
    float v[DW_V];
    z_chunk<RT, MODE>(a, q, f0, B, T, D, H, in, nw, v);
    st8(zp + (size_t)q * zld + f0, v);  // rounded to CT as it is stored
  }
}

// output row of packed feature f: dW's rows are [input (in), h (H)], db is
// row in + H
__device__ __forceinline__ int dw_row(int f, int H, int in, int nw) {
  if (f < H) return in + f;
  const int u = f - H, wide = in - nw;
  return u < wide ? nw + u : u < in ? u - wide : in + H;
}


// The product's tile per compute type. Both tiers: a block of 256 threads
// owns DW_F features x DW_T columns over one slice of the rows, staged KQ
// rows at a time in two shared-memory buffers (the next stage's loads in
// flight while the current one computes). f32: exact FMAs, a thread's 9
// features x 8 columns (4 + 4 + 1 features: ty*4, 64 + ty*4, 128 + ty;
// columns tx*4, 64 + tx*4), z and dgates staged by cp.async as they are.
// bf16: mma.sync m16n8k16 with f32 accumulators, a warp's 144 features x
// 16 columns (nine m16 by two n8 tiles); z arrives packed in bf16
// (cp.async), dgates in f32 through registers, rounded as they are staged,
// and db summed from the unrounded values.
template <typename CT>
struct DwTile;

template <>
struct DwTile<float> {
  static constexpr int KQ = 16;
  struct Smem {
    float z[2][16][DW_F];
    float g[2][16][DW_T];
  };
};

template <>
struct DwTile<__nv_bfloat16> {
  static constexpr int KQ = 32;
  static constexpr int ZS = DW_F + 8;  // row strides: ldmatrix's 8 rows fall on
  static constexpr int GS = DW_T + 8;  // distinct banks (304 and 272 bytes)
  struct Smem {  // bf16 bits
    unsigned short z[2][32][ZS];
    unsigned short g[2][32][GS];
  };
};

// Block (column tile, feature tile, slice s): partial[s][row(f)][n] = Σ over
// the slice's rows q of zp[q][f] · dg[q][n], for the M + 1 packed features
// (M = in + H) of its tile; the bf16 tier writes the constant's row, db,
// from its own sum of the unrounded dg (its 8 warps' sums added in order).
template <typename CT>
__global__ void __launch_bounds__(256, 2)
    lstm_dw_partial_kernel(const CT* __restrict__ zp, const float* __restrict__ dg,
                           float* __restrict__ partial, int Q, int H, int in,
                           int nw, int zld, int chunk) {
  using Tile = DwTile<CT>;
  constexpr int KQ = Tile::KQ;
  constexpr bool BF = !std::is_same<CT, float>::value;
  constexpr int ZV = 16 / sizeof(CT);  // z features per 16-byte copy
  __shared__ __align__(16) typename Tile::Smem sm;
  const int N = 4 * H, M = in + H;
  const int n0 = blockIdx.x * DW_T, f0 = blockIdx.y * DW_F;
  const int q_begin = blockIdx.z * chunk, q_end = min(q_begin + chunk, Q);
  const int tid = threadIdx.x;

  // z: KQ rows x DW_F features, 16 bytes a copy; past the rows or zld, zeros
  auto load_z = [&](int buf, int q0) {
    for (int i = tid; i < KQ * (DW_F / ZV); i += 256) {
      const int r = i / (DW_F / ZV), f = (i % (DW_F / ZV)) * ZV;
      const bool ok = q0 + r < q_end && f0 + f < zld;
      cp_async16(&sm.z[buf][r][f], ok ? zp + (size_t)(q0 + r) * zld + f0 + f : zp, ok);
    }
  };

  if constexpr (!BF) {
    float acc[9][8];
#pragma unroll
    for (int i = 0; i < 9; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    const int tx = tid % 16, ty = tid / 16;
    auto load = [&](int buf, int q0) {
      load_z(buf, q0);
#pragma unroll
      for (int j = 0; j < KQ * DW_T / 4 / 256; ++j) {
        const int i = tid + 256 * j, r = i / (DW_T / 4), c = (i % (DW_T / 4)) * 4;
        const bool ok = q0 + r < q_end;
        cp_async16(&sm.g[buf][r][c], ok ? dg + (size_t)(q0 + r) * N + n0 + c : dg, ok);
      }
      cp_async_commit();
    };
    int buf = 0;
    if (q_begin < q_end) load(0, q_begin);
    for (int q0 = q_begin; q0 < q_end; q0 += KQ, buf ^= 1) {
      cp_async_wait_all();
      __syncthreads();  // this stage landed; everyone is done with the other buffer
      if (q0 + KQ < q_end) load(buf ^ 1, q0 + KQ);
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&sm.z[buf][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&sm.z[buf][kk][64 + ty * 4]);
        const float a8 = sm.z[buf][kk][128 + ty];
        const float4 b0 = *reinterpret_cast<const float4*>(&sm.g[buf][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&sm.g[buf][kk][64 + tx * 4]);
        const float av[9] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a8};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 9; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    float* P = partial + (size_t)blockIdx.z * (M + 1) * N;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const int f = f0 + (i < 4 ? ty * 4 + i : i < 8 ? 64 + ty * 4 + i - 4 : 128 + ty);
      if (f > M) continue;
      float* row = P + (size_t)dw_row(f, H, in, nw) * N + n0;
      *reinterpret_cast<float4*>(row + tx * 4) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(row + 64 + tx * 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  } else {
    float acc[9][2][4];
#pragma unroll
    for (int i = 0; i < 9; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    float db_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // Σ of the unrounded dg
    const int warp = tid / 32, lane = tid % 32, mat = lane >> 3, r8 = lane & 7;
    // dgates: KQ rows x DW_T columns f32, four 16-byte loads a thread, run
    // e = tid + 256 * i: row e / 32 (= warp + 8 i), columns 4 * lane
    constexpr int GQ = KQ * DW_T / 4 / 256;
    float g[GQ][4];
    auto load_g = [&](int q0) {
#pragma unroll
      for (int i = 0; i < GQ; ++i) {
        const int q = q0 + warp + 8 * i;
        if (q < q_end) {
          const float4 v = *reinterpret_cast<const float4*>(dg + (size_t)q * N + n0 + 4 * lane);
          g[i][0] = v.x; g[i][1] = v.y; g[i][2] = v.z; g[i][3] = v.w;
        } else {
          g[i][0] = g[i][1] = g[i][2] = g[i][3] = 0.0f;
        }
      }
    };
    auto store_g = [&](int buf) {
#pragma unroll
      for (int i = 0; i < GQ; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) db_acc[c] += g[i][c];
        *reinterpret_cast<uint2*>(&sm.g[buf][warp + 8 * i][4 * lane]) =
            make_uint2(bf16x2(g[i][0], g[i][1]), bf16x2(g[i][2], g[i][3]));
      }
    };
    int buf = 0;
    if (q_begin < q_end) {
      load_z(0, q_begin);
      cp_async_commit();
      load_g(q_begin);
    }
    for (int q0 = q_begin; q0 < q_end; q0 += KQ, buf ^= 1) {
      store_g(buf);  // last read two stages ago, before the previous barrier
      cp_async_wait_all();
      __syncthreads();
      if (q0 + KQ < q_end) {
        load_z(buf ^ 1, q0 + KQ);
        cp_async_commit();
        load_g(q0 + KQ);  // in flight during the products below
      }
#pragma unroll
      for (int kk = 0; kk < KQ; kk += 16) {
        // B = dg (k = rows, n = the warp's 16 columns): matrices (k 0-7, n 0-7),
        // (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        unsigned b[4];
        ldsm_x4_trans(b, &sm.g[buf][kk + (mat & 1) * 8 + r8][warp * 16 + (mat >> 1) * 8]);
#pragma unroll
        for (int mt = 0; mt < 9; ++mt) {
          // A = zᵀ (m = features, k = rows): matrices (m 0-7, k 0-7),
          // (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
          unsigned a4[4];
          ldsm_x4_trans(a4, &sm.z[buf][kk + (mat >> 1) * 8 + r8][mt * 16 + (mat & 1) * 8]);
          mma_bf16(acc[mt][0], a4, b[0], b[1]);
          mma_bf16(acc[mt][1], a4, b[2], b[3]);
        }
      }
    }
    float* P = partial + (size_t)blockIdx.z * (M + 1) * N;
#pragma unroll
    for (int mt = 0; mt < 9; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // accumulator rows lane / 4 and + 8
        const int f = f0 + mt * 16 + (lane >> 2) + 8 * h;
        if (f >= M) continue;  // the constant's row is db, below
        float* row = P + (size_t)dw_row(f, H, in, nw) * N + n0 + warp * 16 + (lane & 3) * 2;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          *reinterpret_cast<float2*>(row + nt * 8) = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    if (f0 <= M && M < f0 + DW_F) {  // this feature tile holds the constant: db
      __syncthreads();  // every warp is done with the buffers
      float* red = reinterpret_cast<float*>(&sm.z[0][0][0]);
      *reinterpret_cast<float4*>(red + warp * DW_T + 4 * lane) =
          make_float4(db_acc[0], db_acc[1], db_acc[2], db_acc[3]);
      __syncthreads();
      if (tid < DW_T) {
        float s = 0.0f;
        for (int w = 0; w < 8; ++w) s += red[w * DW_T + tid];
        P[(size_t)M * N + n0 + tid] = s;
      }
    }
  }
}

// dw[i] (i < MN) and db[i - MN] = sum over s, in order, of partial[s][i]
__global__ void lstm_dw_sum_kernel(const float* __restrict__ partial, int S,
                                   int MN, int N, float* __restrict__ dw,
                                   float* __restrict__ db) {
  const int total = MN + N;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < S; ++k) s += partial[(size_t)k * total + i];
    if (i < MN)
      dw[i] = s;
    else
      db[i - MN] = s;
  }
}

// zld: the packed z's row length, in + H + 1 rounded up to DW_V
static inline int dw_zld(int in, int hidden) { return (in + hidden + 1 + DW_V - 1) / DW_V * DW_V; }

// dW (in + H, 4H) and db (4H,) of one layer with the z loader MODE (a
// DwMode; a template parameter, so that each source instantiates only the
// loaders it uses), layer input width `in`, of which the first nw features
// are narrow (x_t at layer 0, one by one; the rest, 16-byte runs): the pack
// pass into zp (batch·t_len x dw_zld(in, hidden) values of the compute type),
// then unless pack_only the partial sums over `splits` slices of the rows into
// `partial` (splits x (in + H + 1) x 4H floats) and their sum in a fixed
// order; residuals bf16 (bf16) or f32, compute bf16 (cbf16) or f32.
// Returns cudaGetLastError().
template <int MODE>
static inline cudaError_t dw_layer(const DwArgs& a, void* zp, float* partial, float* dw,
                                   float* db, int batch, int t_len, int d,
                                   int hidden, int in, int nw, int splits, bool bf16,
                                   bool cbf16, bool pack_only, cudaStream_t st) {
  const int Q = batch * t_len, N = 4 * hidden, M = in + hidden, zld = dw_zld(in, hidden);
  using BF = __nv_bfloat16;
  const int span = (1 << 30) / (zld / DW_V);  // rows a pack launch covers
  for (int q0 = 0; q0 < Q; q0 += span) {
    const int rows = std::min(span, Q - q0);
    const int pgrid = std::min((rows * (zld / DW_V) + 255) / 256, 1 << 20);
#define DW_PACK(RT, CT)                                              \
  lstm_dw_pack_kernel<RT, MODE, CT><<<pgrid, 256, 0, st>>>(          \
      a, static_cast<CT*>(zp), q0, rows, batch, t_len, d, hidden, in, nw, zld)
    if (bf16 && cbf16)
      DW_PACK(BF, BF);
    else if (bf16)
      DW_PACK(BF, float);
    else if (cbf16)
      DW_PACK(float, BF);
    else
      DW_PACK(float, float);
#undef DW_PACK
  }
  if (pack_only) return cudaGetLastError();
  const int kq = cbf16 ? DwTile<BF>::KQ : DwTile<float>::KQ;
  int chunk = (Q + splits - 1) / splits;
  chunk = (chunk + kq - 1) / kq * kq;
  const dim3 grid(N / DW_T, (M + 1 + DW_F - 1) / DW_F, splits);
  if (cbf16)
    lstm_dw_partial_kernel<BF><<<grid, 256, 0, st>>>(static_cast<const BF*>(zp), a.dg, partial,
                                                     Q, hidden, in, nw, zld, chunk);
  else
    lstm_dw_partial_kernel<float><<<grid, 256, 0, st>>>(static_cast<const float*>(zp), a.dg,
                                                        partial, Q, hidden, in, nw, zld, chunk);
  const int total = (M + 1) * N;
  lstm_dw_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(partial, splits,
                                                          M * N, N, dw, db);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// the scheduled-sampling decoder's recurrences (lstm_ss.cu's header says what
// they compute). STEP_CTX = false: a static context ctx (B, C), written into
// layer 0's input once, and dctx (B, C) summed over t (lstm_ss.cu);
// STEP_CTX = true: a per-step context ctx (B, T, C), reloaded every step, and
// dctx (B, T, C) written per step (the lockstep-peer decoder of
// lstm_align.cu). A template parameter, so that each instance keeps the
// registers of its own branch. The weights are in the compute type CT.
// ---------------------------------------------------------------------------

template <typename CT>
struct SsFwdArgs {
  const CT* w[MAX_LAYERS];     // (in_l + H, 4H); layer 0's input is D + C
  const float* b[MAX_LAYERS];  // (4H,)
  void* hs[MAX_LAYERS];        // (B, T, H) residual type
  void* cs[MAX_LAYERS];        // (B, T, H)
  void* gs[MAX_LAYERS];        // (B, T, 4H)
  const CT* proj_w;            // (H, D)
  const float* proj_b;         // (D,)
};

template <typename RT, bool STEP_CTX, typename CT>
__global__ void __launch_bounds__(256)
    ss_fwd_kernel(const float* __restrict__ h0, const float* __restrict__ c0,
                  const float* __restrict__ y0,
                  const float* __restrict__ teacher,
                  const float* __restrict__ coins,
                  const float* __restrict__ ctx, const SsFwdArgs<CT> a,
                  float* __restrict__ ys, int B, int T, int D, int C, int H,
                  int L, int R) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int j0 = (tid % (H / TJ)) * TJ;
  const int r0 = (tid / (H / TJ)) * TR;
  const int HR = H * R;
  float* h_s = smem;               // L x (H, R)
  float* c_s = h_s + L * HR;       // L x owner-private (TR * TJ, nthr)
  float* x_s = c_s + L * HR;       // (D + C, R) layer-0 input [x_t, ctx]
  float* y_s = x_s + (D + C) * R;  // (D, R) the fed-back y_{t-1}, f32
  const long long row0 = (long long)blockIdx.x * R;

  load_states(h_s, c_s, h0, c0, row0, B, H, L, R, r0, j0, tid, nthr);
  for (int i = tid; i < R * D; i += nthr) {
    const int r = i / D, d = i % D;
    const long long row = row0 + r;
    y_s[d * R + r] = row < B ? y0[row * D + d] : 0.0f;
  }
  if constexpr (!STEP_CTX) {
    for (int i = tid; i < R * C; i += nthr) {  // the static context, once
      const int r = i / C, c = i % C;
      const long long row = row0 + r;
      x_s[(D + c) * R + r] = row < B ? ctx[row * C + c] : 0.0f;
    }
  }
  __syncthreads();

  const float* h_top = h_s + (L - 1) * HR;
  for (int t = 0; t < T; ++t) {
    // x_t = coin_t > 0 ? teacher_t : y_{t-1}
    for (int i = tid; i < R * D; i += nthr) {
      const int r = i / D, d = i % D;
      const long long row = row0 + r;
      float x = 0.0f;
      if (row < B) {
        const size_t q = (size_t)t * B + row;
        x = coins[q] > 0.0f ? teacher[q * D + d] : y_s[d * R + r];
      }
      x_s[d * R + r] = x;
    }
    if constexpr (STEP_CTX) {  // this step's context
      for (int i = tid; i < R * C; i += nthr) {
        const int r = i / C, c = i % C;
        const long long row = row0 + r;
        x_s[(D + c) * R + r] = row < B ? ctx[((size_t)row * T + t) * C + c] : 0.0f;
      }
    }
    __syncthreads();
    for (int l = 0; l < L; ++l)
      fwd_layer_step<RT>(
          l == 0 ? x_s : h_s + (l - 1) * HR, l == 0 ? D + C : H, h_s + l * HR,
          c_s + l * HR, a.w[l], a.b[l], static_cast<RT*>(a.hs[l]),
          static_cast<RT*>(a.cs[l]), static_cast<RT*>(a.gs[l]), row0, B, T, t,
          H, R, r0, j0, tid, nthr);
    // y_t = h_top @ proj_w + proj_b from the f32 h (rounded to CT as it
    // enters the product): written out and fed back in f32
    for (int i = tid; i < R * D; i += nthr) {
      const int r = i / D, d = i % D;
      float y = 0.0f;
      for (int k = 0; k < H; ++k)
        y = fmaf(cround<CT>(h_top[k * R + r]), ldw1(a.proj_w + k * D + d), y);
      y += __ldg(a.proj_b + d);
      y_s[d * R + r] = y;
      const long long row = row0 + r;
      if (row < B) ys[((size_t)row * T + t) * D + d] = y;
    }
    __syncthreads();
  }
}

template <typename CT>
struct SsBwdArgs {
  const CT* w0;                 // layer 0's W (D + C + H, 4H): rows :D give dx
  const CT* wt[MAX_LAYERS];     // l == 0: W[D+C:]ᵀ (4H, H); l > 0:
                                // [W[H:]; W[:H]]ᵀ (4H, 2H), dh part first
  const CT* wtc;                // layer 0's W[D:D+C]ᵀ (4H, C); null if C == 0
  const void* cs[MAX_LAYERS];   // (B, T, H) residual type
  const void* gs[MAX_LAYERS];   // (B, T, 4H)
  float* dg[MAX_LAYERS];        // (B, T, 4H) dgates out
  const CT* proj_w;             // (H, D)
};

template <typename RT, bool STEP_CTX, typename CT>
__global__ void __launch_bounds__(256)
    ss_bwd_kernel(const float* __restrict__ dys, const float* __restrict__ c0,
                  const float* __restrict__ coins, const SsBwdArgs<CT> a,
                  float* __restrict__ dy, float* __restrict__ dteacher,
                  float* __restrict__ dy0, float* __restrict__ dh0,
                  float* __restrict__ dc0, float* __restrict__ dctx, int B,
                  int T, int D, int C, int H, int L, int R) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int j0 = (tid % (H / TJ)) * TJ;
  const int r0 = (tid / (H / TJ)) * TR;
  const int HR = H * R, G = 4 * H;
  float* dg_s = smem;             // (4H, R) dgates of this layer-step
  float* dh_s = dg_s + G * R;     // L x owner-private (TR * TJ, nthr)
  float* dc_s = dh_s + L * HR;    // L x owner-private
  float* dctx_s = dc_s + L * HR;  // (C, R) dctx, each entry summed by its owner
  float* fb_s = dctx_s + C * R;   // (D, R) feedback gradient of y_{t-1}
  float* dy_s = fb_s + D * R;     // (D, R) total gradient of y_t
  const long long row0 = (long long)blockIdx.x * R;

  // the decoder's final states get no gradient: the carries start at 0
  for (int i = tid; i < (2 * L * H + C + D) * R; i += nthr) dh_s[i] = 0.0f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // dy_t = dys_t + the feedback from step t + 1
    for (int i = tid; i < R * D; i += nthr) {
      const int r = i / D, d = i % D;
      const long long row = row0 + r;
      float v = 0.0f;
      if (row < B) {
        const size_t q = ((size_t)row * T + t) * D + d;
        v = dys[q] + fb_s[d * R + r];
        dy[q] = v;
      }
      dy_s[d * R + r] = v;
    }
    __syncthreads();
    float above[TR][TJ];  // dy_t · proj_wᵀ, the gradient at the top layer's h
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        float s = 0.0f;
        for (int d = 0; d < D; ++d)
          s = fmaf(cround<CT>(dy_s[d * R + r0 + r]), ldw1(a.proj_w + (size_t)(j0 + j) * D + d), s);
        above[r][j] = s;
      }
    for (int l = L - 1; l >= 0; --l) {
      bwd_cell_step<RT>(static_cast<const RT*>(a.gs[l]),
                        static_cast<const RT*>(a.cs[l]), c0, a.dg[l], above,
                        dh_s + l * HR, dc_s + l * HR, dg_s, row0, B, T, t, l,
                        H, R, r0, j0, tid, nthr);
      __syncthreads();  // dgates of this layer-step complete in dg_s

      if (l > 0) {
        float acc[2][TR][TJ];
        zero(acc);
        accumulate<2>(acc, dg_s, G, a.wt[l], 2 * H, H, R, r0, j0);
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int j = 0; j < TJ; ++j) {
            dh_s[l * HR + (r * TJ + j) * nthr + tid] = acc[0][r][j];
            above[r][j] = acc[1][r][j];
          }
      } else {
        float acc[1][TR][TJ];
        zero(acc);
        accumulate<1>(acc, dg_s, G, a.wt[0], H, 0, R, r0, j0);
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int j = 0; j < TJ; ++j)
            dh_s[(r * TJ + j) * nthr + tid] = acc[0][r][j];
        // dctx = dgates · W[D:D+C]ᵀ: the thread owns units c .. c + 3;
        // summed over t (static) or written for this step (per-step)
        for (int c = j0; c < C; c += H) {
          float cacc[1][TR][TJ];
          zero(cacc);
          accumulate<1>(cacc, dg_s, G, a.wtc, C, 0, R, r0, c);
          if constexpr (STEP_CTX) {
#pragma unroll
            for (int r = 0; r < TR; ++r) {
              const long long row = row0 + r0 + r;
              if (row < B) F::st4(dctx + ((size_t)row * T + t) * C + c, cacc[0][r]);
            }
          } else {
#pragma unroll
            for (int r = 0; r < TR; ++r)
#pragma unroll
              for (int j = 0; j < TJ; ++j) dctx_s[(c + j) * R + r0 + r] += cacc[0][r][j];
          }
        }
        // dx = dgates · W[:D]ᵀ → dteacher_t, and the feedback to y_{t-1}
        input_grad(dg_s, a.w0, D, G, R, row0, B, tid, nthr,
                   [&](int r, int d, float dx) {
                     const size_t q = (size_t)t * B + row0 + r;
                     const float coin = coins[q];
                     dteacher[q * D + d] = dx * coin;
                     fb_s[d * R + r] = dx * (1.0f - coin);
                   });
      }
      __syncthreads();  // dg_s is read by everyone before it is overwritten
    }
  }

  for (int i = tid; i < R * D; i += nthr) {
    const int r = i / D, d = i % D;
    const long long row = row0 + r;
    if (row < B) dy0[row * D + d] = fb_s[d * R + r];
  }
  if constexpr (!STEP_CTX) {
    for (int i = tid; i < R * C; i += nthr) {
      const int r = i / C, c = i % C;
      const long long row = row0 + r;
      if (row < B) dctx[row * C + c] = dctx_s[c * R + r];
    }
  }
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const long long row = row0 + r0 + r;
      if (row >= B) continue;
      float vh[TJ], vc[TJ];
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        vh[j] = dh_s[l * HR + (r * TJ + j) * nthr + tid];
        vc[j] = dc_s[l * HR + (r * TJ + j) * nthr + tid];
      }
      F::st4(dh0 + ((size_t)l * B + row) * H + j0, vh);
      F::st4(dc0 + ((size_t)l * B + row) * H + j0, vc);
    }
}

// ---------------------------------------------------------------------------
// launches shared by the C interfaces of lstm_ss.cu and lstm_align.cu; each
// returns cudaGetLastError() (0 = ok)
// ---------------------------------------------------------------------------

static inline bool ss_bad_shape(int batch, int t_len, int d, int ctx_dim, int hidden,
                         int layers, int rows) {
  return layers < 1 || layers > MAX_LAYERS || hidden < 32 || hidden % 32 ||
         rows < TR || rows % TR || batch < 1 || t_len < 1 || d < 1 ||
         ctx_dim < 0 || ctx_dim % 4 || (rows / TR) * (hidden / TJ) > 256;
}

// Launch `kernel` with `smem` bytes of dynamic shared memory (above 48 KB
// only after the attribute is raised) → cudaGetLastError().
template <typename Kernel, typename... Args>
static int launch_with_smem(Kernel kernel, int grid, int threads, size_t smem,
                            cudaStream_t st, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// The launches with the weights in the compute type CT and the residuals in
// RT (bf16 != 0: bf16).
template <bool STEP_CTX, typename CT>
static int ss_fwd_go(const float* h0, const float* c0, const float* y0,
                     const float* teacher, const float* coins, const float* ctx,
                     const void* const* w, const void* const* b,
                     const void* proj_w, const void* proj_b, void* const* hs,
                     void* const* cs, void* const* gs, float* ys, int batch,
                     int t_len, int d, int ctx_dim, int hidden, int layers,
                     int rows, int bf16, cudaStream_t st) {
  SsFwdArgs<CT> a;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    const bool on = l < layers;
    a.w[l] = on ? static_cast<const CT*>(w[l]) : nullptr;
    a.b[l] = on ? static_cast<const float*>(b[l]) : nullptr;
    a.hs[l] = on ? hs[l] : nullptr;
    a.cs[l] = on ? cs[l] : nullptr;
    a.gs[l] = on ? gs[l] : nullptr;
  }
  a.proj_w = static_cast<const CT*>(proj_w);
  a.proj_b = static_cast<const float*>(proj_b);
  const size_t smem =
      ((size_t)2 * layers * hidden + 2 * d + ctx_dim) * rows * sizeof(float);
  const int threads = (rows / TR) * (hidden / TJ);
  const int grid = (batch + rows - 1) / rows;
  if (bf16)
    return launch_with_smem(ss_fwd_kernel<__nv_bfloat16, STEP_CTX, CT>, grid,
                            threads, smem, st, h0, c0, y0, teacher, coins, ctx,
                            a, ys, batch, t_len, d, ctx_dim, hidden, layers,
                            rows);
  return launch_with_smem(ss_fwd_kernel<float, STEP_CTX, CT>, grid, threads,
                          smem, st, h0, c0, y0, teacher, coins, ctx, a, ys,
                          batch, t_len, d, ctx_dim, hidden, layers, rows);
}

template <bool STEP_CTX, typename CT>
static int ss_bwd_go(const float* dys, const float* c0, const float* coins,
                     const void* w0, const void* const* wt, const void* wtc,
                     const void* proj_w, const void* const* cs,
                     const void* const* gs, void* const* dg, float* dy,
                     float* dteacher, float* dy0, float* dh0, float* dc0,
                     float* dctx, int batch, int t_len, int d, int ctx_dim,
                     int hidden, int layers, int rows, int bf16,
                     cudaStream_t st) {
  SsBwdArgs<CT> a;
  a.w0 = static_cast<const CT*>(w0);
  a.wtc = static_cast<const CT*>(wtc);
  a.proj_w = static_cast<const CT*>(proj_w);
  for (int l = 0; l < MAX_LAYERS; ++l) {
    const bool on = l < layers;
    a.wt[l] = on ? static_cast<const CT*>(wt[l]) : nullptr;
    a.cs[l] = on ? cs[l] : nullptr;
    a.gs[l] = on ? gs[l] : nullptr;
    a.dg[l] = on ? static_cast<float*>(dg[l]) : nullptr;
  }
  const size_t smem = ((size_t)4 * hidden + (size_t)2 * layers * hidden +
                       ctx_dim + 2 * d) * rows * sizeof(float);
  const int threads = (rows / TR) * (hidden / TJ);
  const int grid = (batch + rows - 1) / rows;
  if (bf16)
    return launch_with_smem(ss_bwd_kernel<__nv_bfloat16, STEP_CTX, CT>, grid,
                            threads, smem, st, dys, c0, coins, a, dy, dteacher,
                            dy0, dh0, dc0, dctx, batch, t_len, d, ctx_dim,
                            hidden, layers, rows);
  return launch_with_smem(ss_bwd_kernel<float, STEP_CTX, CT>, grid, threads,
                          smem, st, dys, c0, coins, a, dy, dteacher, dy0, dh0,
                          dc0, dctx, batch, t_len, d, ctx_dim, hidden, layers,
                          rows);
}

// rows: batch rows per block, a multiple of 4. The block has (rows / 4) *
// (hidden / 4) threads and (2 * layers * hidden + 2 * d + ctx_dim) * rows
// floats of dynamic shared memory. coins (t_len, batch), teacher (t_len,
// batch, d); ctx (batch, ctx_dim) or, STEP_CTX, (batch, t_len, ctx_dim); null
// when ctx_dim == 0. w and proj_w are bf16 when cbf16 (the bf16 compute
// type), else f32.
template <bool STEP_CTX>
static int ss_fwd_launch(const void* h0, const void* c0, const void* y0,
                         const void* teacher, const void* coins,
                         const void* ctx, const void* const* w,
                         const void* const* b, const void* proj_w,
                         const void* proj_b, void* const* hs, void* const* cs,
                         void* const* gs, void* ys, int batch, int t_len,
                         int d, int ctx_dim, int hidden, int layers, int rows,
                         int bf16, int cbf16, void* stream) {
  if (ss_bad_shape(batch, t_len, d, ctx_dim, hidden, layers, rows))
    return (int)cudaErrorInvalidValue;
  const auto go = cbf16 ? &ss_fwd_go<STEP_CTX, __nv_bfloat16> : &ss_fwd_go<STEP_CTX, float>;
  return go(static_cast<const float*>(h0), static_cast<const float*>(c0),
            static_cast<const float*>(y0), static_cast<const float*>(teacher),
            static_cast<const float*>(coins), static_cast<const float*>(ctx), w,
            b, proj_w, proj_b, hs, cs, gs, static_cast<float*>(ys), batch, t_len,
            d, ctx_dim, hidden, layers, rows, bf16,
            static_cast<cudaStream_t>(stream));
}

// Same block shape as ss_fwd_launch, with (4 * hidden + 2 * layers * hidden
// + ctx_dim + 2 * d) * rows floats of dynamic shared memory. w0 is layer 0's
// W; wt its transposed blocks (see SsBwdArgs); wtc null when ctx_dim == 0;
// the weights bf16 when cbf16, else f32. dctx is (batch, ctx_dim) or,
// STEP_CTX, (batch, t_len, ctx_dim).
template <bool STEP_CTX>
static int ss_bwd_launch(const void* dys, const void* c0, const void* coins,
                         const void* w0, const void* const* wt, const void* wtc,
                         const void* proj_w, const void* const* cs,
                         const void* const* gs, void* const* dg, void* dy,
                         void* dteacher, void* dy0, void* dh0, void* dc0,
                         void* dctx, int batch, int t_len, int d, int ctx_dim,
                         int hidden, int layers, int rows, int bf16, int cbf16,
                         void* stream) {
  if (ss_bad_shape(batch, t_len, d, ctx_dim, hidden, layers, rows))
    return (int)cudaErrorInvalidValue;
  const auto go = cbf16 ? &ss_bwd_go<STEP_CTX, __nv_bfloat16> : &ss_bwd_go<STEP_CTX, float>;
  return go(static_cast<const float*>(dys), static_cast<const float*>(c0),
            static_cast<const float*>(coins), w0, wt, wtc, proj_w, cs, gs, dg,
            static_cast<float*>(dy), static_cast<float*>(dteacher),
            static_cast<float*>(dy0), static_cast<float*>(dh0),
            static_cast<float*>(dc0), static_cast<float*>(dctx), batch, t_len, d,
            ctx_dim, hidden, layers, rows, bf16, static_cast<cudaStream_t>(stream));
}

// dW/db of every decoder layer (the reduction above; layer 0's input rebuilt
// by the MODE loader from coins, teacher, ys, y0 and a static ctx (DW_SS) or
// the per-step context from php and pwt (DW_ALIGN); the layers above read
// their input from the residuals, the DW_TF loader). `zp` holds batch·t_len x
// max_l dw_zld(in_l, H) values of the compute type and `partial` splits x
// (max_l(in_l + H) + 1) x 4H floats, both reused layer after layer.
// pack_layer >= 0: only that layer's pack pass, into zp.
template <int MODE>
static inline int ss_dw_layers(const void* h0, const void* y0, const void* teacher,
                        const void* coins, const void* ctx, const void* php,
                        const void* pwt, int n_peers, const void* ys,
                        const void* const* hs, const void* const* cs,
                        const void* const* gs, const void* const* dg, void* zp,
                        void* partial, void* const* dw, void* const* db,
                        int batch, int t_len, int d, int ctx_dim, int hidden,
                        int layers, int splits, int bf16, int cbf16,
                        int pack_layer, void* stream) {
  if (layers < 1 || layers > MAX_LAYERS || hidden < 32 || hidden % 32 ||
      batch < 1 || t_len < 1 || d < 1 || ctx_dim < 0 || splits < 1 ||
      pack_layer >= layers || (long long)batch * t_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < layers; ++l) {
    if (pack_layer >= 0 && l != pack_layer) continue;
    DwArgs a = {};
    a.h0 = static_cast<const float*>(h0) + (size_t)l * batch * hidden;
    a.hs = hs[l];
    a.dg = static_cast<const float*>(dg[l]);
    if (l > 0) {
      a.cs_in = cs[l - 1];
      a.gs_in = gs[l - 1];
    } else {
      a.coins = static_cast<const float*>(coins);
      a.teacher = static_cast<const float*>(teacher);
      a.ys = static_cast<const float*>(ys);
      a.y0 = static_cast<const float*>(y0);
      a.ctx = static_cast<const float*>(ctx);
      a.C = ctx_dim;
      a.php = php;
      a.pwt = static_cast<const float*>(pwt);
      a.K = n_peers;
    }
    const auto layer = l == 0 ? dw_layer<MODE> : dw_layer<DW_TF>;
    const cudaError_t e = layer(
        a, zp, static_cast<float*>(partial), pack_layer >= 0 ? nullptr : static_cast<float*>(dw[l]),
        pack_layer >= 0 ? nullptr : static_cast<float*>(db[l]), batch, t_len, d, hidden,
        l == 0 ? d + ctx_dim : hidden, l == 0 ? d : 0, splits, bf16 != 0, cbf16 != 0,
        pack_layer >= 0, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
