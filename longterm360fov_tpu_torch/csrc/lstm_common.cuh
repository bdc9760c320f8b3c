// Device code shared by the training kernels of lstm_train.cu and lstm_ss.cu,
// for Hopper (sm_90a), exact f32 compute, residuals in f32 or bf16:
//   * Res<RT>, the residual type (f32, or bf16 rounded to nearest even as
//     torch and XLA cast);
//   * the thread tile: TR = 4 batch rows x TJ = 4 hidden units per thread,
//     a layer input held k-major (K, R) in shared memory, and accumulate<NG>,
//     the FMA loop that reads W rows with 16-byte loads;
//   * fwd_layer_step, one forward layer-step with its residual stores;
//   * the deterministic dW/db reduction: lstm_dw_partial_kernel over slices
//     of the (b, t) rows, then lstm_dw_sum_kernel, which adds the slices in a
//     fixed order (no float atomics). Its z loader builds
//     [h_{t-1}, input_t, 1] for the teacher-forced LSTM and, given coins (a
//     second instance of the kernel), for layer 0 of the scheduled-sampling
//     decoder, whose input is [x_t, ctx] with x_t = coin_t > 0 ? teacher_t :
//     y_{t-1}, rebuilt from the forward's outputs as the TPU backward
//     rebuilds it.
// lstm_train.cu's header says what bounds these kernels on the card and how
// the design answers it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MAX_LAYERS 8
#define TR 4        // batch rows per thread
#define TJ 4        // hidden units per thread: one float4 of each gate
#define DW_T 128    // dW tile: rows (z features) and columns (gates)
#define DW_K 16     // (b, t) rows per shared-memory stage of the reduction

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
// float4 (a broadcast: a warp shares its rows); W rows are ldw floats long.
template <int NG>
__device__ __forceinline__ void accumulate(float (&acc)[NG][TR][TJ],
                                           const float* z, int K,
                                           const float* __restrict__ W,
                                           int ldw, int goff, int R, int r0,
                                           int j0) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TR];
    F::ld4(z + k * R + r0, a);
    const float* wk = W + (size_t)k * ldw + j0;
    float w[NG][TJ];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(wk + g * goff));
      w[g][0] = v.x;
      w[g][1] = v.y;
      w[g][2] = v.z;
      w[g][3] = v.w;
    }
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
// state, owner-private [TR * TJ][nthr].
template <typename RT>
__device__ __forceinline__ void fwd_layer_step(
    const float* in, int k_in, float* h, float* c, const float* __restrict__ W,
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
#pragma unroll
      for (int g = 0; g < 4; ++g) Res<RT>::st4(gs + q * 4 * H + g * H + j0, gv[g]);
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
// takes each.
template <typename Fn>
__device__ __forceinline__ void input_grad(const float* dg_s,
                                           const float* __restrict__ W, int D,
                                           int G, int R, long long row0, int B,
                                           int tid, int nthr, Fn fn) {
  for (int i = tid; i < R * D; i += nthr) {
    const int r = i % R, d = i / R;
    if (row0 + r >= B) continue;
    const float* wd = W + (size_t)d * G;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    for (int k = 0; k < G; k += 4) {
      s0 = fmaf(dg_s[k * R + r], __ldg(wd + k), s0);
      s1 = fmaf(dg_s[(k + 1) * R + r], __ldg(wd + k + 1), s1);
      s2 = fmaf(dg_s[(k + 2) * R + r], __ldg(wd + k + 2), s2);
      s3 = fmaf(dg_s[(k + 3) * R + r], __ldg(wd + k + 3), s3);
    }
    fn(r, d, (s0 + s1) + (s2 + s3));
  }
}

// ---------------------------------------------------------------------------
// dW / db reduction
// ---------------------------------------------------------------------------

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
};

// feature m < D + C of the scheduled-sampling decoder's layer-0 input
// [x_t, ctx] at row q = b * T + t
__device__ __forceinline__ float ss_in(const DwArgs& a, int q, int b, int t,
                                       int m, int B, int D) {
  if (m >= D) return a.ctx[(size_t)b * a.C + (m - D)];
  if (a.coins[(size_t)t * B + b] > 0.0f)
    return a.teacher[((size_t)t * B + b) * D + m];
  return t > 0 ? a.ys[(size_t)(q - 1) * D + m] : a.y0[(size_t)b * D + m];
}

// The reduction orders z's features h first: feature f < H is h_{t-1}[f],
// H <= f < H + in is input_t[f - H], so the h part is whole float4 runs at
// any input width; feature H + in is the constant 1, whose row of the
// product is db. Output row of feature f: f < H ? in + f : f - H (db is
// row in + H, after dW).
//
// z[q][f .. f + 3] of row q = b * T + t (zero past the features). SS: layer
// 0 of the scheduled-sampling decoder; a template parameter, so that the
// teacher-forced kernel keeps its short loader and its registers.
template <typename RT, bool SS>
__device__ __forceinline__ void z_quad(const DwArgs& a, int q, int f, int B,
                                       int T, int D, int H, int in,
                                       float (&v)[4]) {
  if (f < H) {
    const int b = q / T;
    if (q - b * T > 0)
      Res<RT>::ld4(static_cast<const RT*>(a.hs) + (size_t)(q - 1) * H + f, v);
    else
      F::ld4(a.h0 + (size_t)b * H + f, v);
  } else if (f - H >= in) {  // the constant feature of db
    v[0] = f - H == in ? 1.0f : 0.0f;
    v[1] = v[2] = v[3] = 0.0f;
  } else if (a.gs_in != nullptr) {  // o·tanh(c) of the layer below
    const int m = f - H;
    float o[4], c[4];
    Res<RT>::ld4(static_cast<const RT*>(a.gs_in) + (size_t)q * 4 * H + 3 * H + m, o);
    Res<RT>::ld4(static_cast<const RT*>(a.cs_in) + (size_t)q * H + m, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = o[i] * tanhf(c[i]);
  } else if (SS) {  // [x_t, ctx]
    const int b = q / T, t = q - b * T;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = f - H + i;
      v[i] = m < in ? ss_in(a, q, b, t, m, B, D) : (m == in ? 1.0f : 0.0f);
    }
  } else {  // xs, D floats a row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = f - H + i;
      v[i] = m < in ? a.xs[(size_t)q * D + m] : (m == in ? 1.0f : 0.0f);
    }
  }
}

#define DW_Q (DW_K * DW_T / 4 / 256)  // float4 runs of each operand a thread loads

// Block (n tile, f tile, slice s): partial[s][row(f)][n] = sum over the
// slice's rows q of z[q][f] * dg[q][n], for the M + 1 features of z and the
// constant (M = in + H).
template <typename RT, bool SS>
__global__ void __launch_bounds__(256, 2)
    lstm_dw_partial_kernel(const DwArgs a, float* __restrict__ partial, int B,
                           int T, int D, int H, int in, int chunk) {
  __shared__ __align__(16) float As[DW_K][DW_T];
  __shared__ __align__(16) float Bs[DW_K][DW_T];
  const int N = 4 * H, M = in + H;  // features: M, and the constant
  const int n0 = blockIdx.x * DW_T, f0 = blockIdx.y * DW_T;
  const int Q = B * T;
  const int q_begin = blockIdx.z * chunk;
  const int q_end = min(q_begin + chunk, Q);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool active = f0 + ty * 4 <= M;  // warps past a short last tile rest
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // run e = tid + 256 * i of a stage: row kk = e / 32, columns 4 * (e % 32)
  float za[DW_Q][4], ga[DW_Q][4];
  int q0 = q_begin;
#define DW_LOAD                                                                \
  _Pragma("unroll") for (int i = 0; i < DW_Q; ++i) {                           \
    const int e = tid + 256 * i, q = q0 + e / 32, c = 4 * (e % 32);            \
    za[i][0] = za[i][1] = za[i][2] = za[i][3] = 0.0f;                          \
    ga[i][0] = ga[i][1] = ga[i][2] = ga[i][3] = 0.0f;                          \
    if (q < q_end) {                                                           \
      if (f0 + c <= M) z_quad<RT, SS>(a, q, f0 + c, B, T, D, H, in, za[i]);    \
      F::ld4(a.dg + (size_t)q * N + n0 + c, ga[i]);                            \
    }                                                                          \
  }
  if (q0 < q_end) {
    DW_LOAD
  }
  for (; q0 < q_end;) {
#pragma unroll
    for (int i = 0; i < DW_Q; ++i) {
      const int e = tid + 256 * i;
      F::st4(&As[e / 32][4 * (e % 32)], za[i]);
      F::st4(&Bs[e / 32][4 * (e % 32)], ga[i]);
    }
    __syncthreads();
    q0 += DW_K;
    if (q0 < q_end) {  // in flight during the FMAs below
      DW_LOAD
    }
    if (active) {
#pragma unroll
      for (int kk = 0; kk < DW_K; ++kk) {
        float av[8], bv[8];
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
        av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
        av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
        bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
        bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#undef DW_LOAD

  float* P = partial + (size_t)blockIdx.z * (M + 1) * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = f0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (f > M) continue;
    const int m = f < H ? in + f : f < M ? f - H : M;  // output row
    *reinterpret_cast<float4*>(P + (size_t)m * N + n0 + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(P + (size_t)m * N + n0 + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
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

// dW (in + H, 4H) and db (4H,) of one layer: the partial sums over `splits`
// slices of the B·T rows into `partial` (splits x (in + H + 1) x 4H floats),
// then their sum in a fixed order. Returns cudaGetLastError().
static inline cudaError_t dw_layer(const DwArgs& a, float* partial, float* dw,
                                   float* db, int batch, int t_len, int d,
                                   int hidden, int in, int splits, bool bf16,
                                   cudaStream_t st) {
  const int Q = batch * t_len, N = 4 * hidden, M = in + hidden;
  int chunk = (Q + splits - 1) / splits;
  chunk = (chunk + DW_K - 1) / DW_K * DW_K;
  const dim3 grid(N / DW_T, (M + 1 + DW_T - 1) / DW_T, splits);
#define DW_PARTIAL(RT, SS) \
  lstm_dw_partial_kernel<RT, SS><<<grid, 256, 0, st>>>(a, partial, batch, t_len, d, hidden, in, chunk)
  const bool ss = a.coins != nullptr;
  if (bf16) {
    if (ss) DW_PARTIAL(__nv_bfloat16, true); else DW_PARTIAL(__nv_bfloat16, false);
  } else {
    if (ss) DW_PARTIAL(float, true); else DW_PARTIAL(float, false);
  }
#undef DW_PARTIAL
  const int total = (M + 1) * N;
  lstm_dw_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(partial, splits,
                                                          M * N, N, dw, db);
  return cudaGetLastError();
}
