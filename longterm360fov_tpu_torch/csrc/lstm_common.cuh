// Device code shared by the training kernels of lstm_train.cu, lstm_ss.cu
// and lstm_align.cu, for Hopper (sm_90a), f32 or bf16 compute, residuals in
// f32 or bf16:
//   * Res<RT>, the residual type (f32, or bf16 rounded to nearest even as
//     torch and XLA cast);
//   * the compute type CT of compute_type.cuh (cround, ldw1): an activation
//     (h, x, dgates, dy) is kept in f32 and rounded where it enters a
//     product. Carries, gates, the cell update, residual stores and the
//     sums db, dproj_b stay f32;
//   * the training forward on the tensor cores (train_fwd_kernel, both
//     compute tiers: lstm_mma.cuh's serve body in a training mode) and the
//     backward recurrence (ss_bwd_kernel, lstm_mma.cuh's pieces), each in
//     three modes: the scheduled-sampling decoder's with a static or a
//     per-step context (lstm_ss.cu, lstm_align.cu) and the teacher-forced
//     LSTM's (lstm_train.cu); the peer kernels of lstm_align.cu have their
//     own (the peer forward is lstm_mma.cuh's encoder);
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
#include "lstm_mma.cuh"
#include "tensor_core.cuh"

#define MAX_LAYERS 8

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
  // a pair of values (units u, u + 1)
  static __device__ __forceinline__ void st2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
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
  static __device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

using F = Res<float>;

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
// The training forwards on the tensor cores (train_fwd_kernel), in the three
// modes of the backward (SsbMode, a template parameter): the teacher-forced
// LSTM's (SSB_TF: lstm_seq_states' forward, lstm_train.cu) and the
// scheduled-sampling decoder's with a static context (SSB_STATIC, lstm_ss.cu)
// or a per-step one (SSB_STEP, the lockstep decoder of lstm_align.cu); both
// compute tiers (P = lstm_mma::Tf32Mma, three-pass TF32, or Bf16Mma).
// It is the serve kernel's decoder phase (lstm_mma.cuh server) in a training
// mode: from given states h0, c0 (L, B, H) (h0 into z, rounded where the
// tier rounds; c0 into the lanes' slots), T steps of L stacked cells on z =
// [x_t (padded to whole k-steps) | ctx (padded likewise) | h_0 .. h_L-1] a
// block row, with the encoders' warp tiles, product and cell; every
// layer-step's h, c and activated gates i, f, g, o stored in the residual
// type RT from the cell's registers, (B, T, H) and (B, T, 4H) a layer, as
// the backward and the dW pack read them. SSB_TF: x_t = xs[b, t] (D up to
// hidden + 8: the teacher-forced decoder's [x, ctx] rides as its input),
// staged into z after layer 0 has read x_t-1. The decoder modes: x_t = coin_t
// > 0 ? teacher_t : y_t-1 (y0 at t = 0), D <= 8; the static context written
// into z once, or ctx_t+1 by cp.async into an f32 staging buffer during step
// t's products and rounded into z after layer 0 has read ctx_t (the lockstep
// serve kernel's route); y_t = h_top · proj_w + proj_b on the FMA units from
// the staging buffer's h_top (rounded where the tier rounds), written f32 to
// ys and, with the coin of step t + 1, into z's x columns. The pieces it
// shares with the serve kernel are lstm_mma.cuh's (zero16, ctx_load,
// ctx_stage, ctx_land, states_load, publish, project); the x staging stays a
// lambda in each, since a shared one raised the serve kernels' spills.
// What bounds it, what it costs and what the design does about it:
// lstm_train.cu's header.
// ---------------------------------------------------------------------------

enum SsbMode { SSB_STATIC = 0, SSB_STEP = 1, SSB_TF = 2 };
constexpr int SSB_MAX_D = 8;  // coordinates a token
// The f32 forward's products: three-pass TF32 with both operands split to
// nearest (split_round) and chunks of TFW_CHUNK = 2 k8 steps of fresh
// accumulators. With the serve kernels' truncating split and chunks of 4
// the decoder forward leaves the 1e-5 gate at C = 128 (a static context of
// unit variance); this way its gap to a float64 loop is under the plain f32
// version's own, for about 7 % more time (PERF.md §6, row 6).
constexpr int TFW_CHUNK = 2;

struct TrainFwdArgs {
  const uint4* w;              // every layer's W packed for the tier (pack_weights_tf32 / pack_weights), layer after layer
  const float* b[MAX_LAYERS];  // (4H,)
  void* hs[MAX_LAYERS];        // (B, T, H) residual type
  void* cs[MAX_LAYERS];        // (B, T, H)
  void* gs[MAX_LAYERS];        // (B, T, 4H) activated gates i, f, g, o
  const float* h0;             // (L, B, H)
  const float* c0;             // (L, B, H)
  const float* xs;             // SSB_TF: (B, T, D) layer 0's input
  const float* y0;             // (B, D)
  const float* teacher;        // (T, B, D)
  const float* coins;          // (T, B)
  const float* ctx;            // (B, C), or SSB_STEP (B, T, C); null when C == 0
  const void* proj_wt;         // (D, H) proj_w transposed, in the compute type
  const float* proj_b;         // (D,)
  float* ys;                   // (B, T, D)
};

// A block's dynamic shared memory, in this order: c (when in shared memory),
// z, the staging of the new h (E rows of H + 8) and the lockstep mode's
// ctx_t+1 (rp x C f32).
template <typename P>
__host__ __device__ inline long long tfw_smem_bytes(int rp, int d, int c, int h, int layers, bool c_smem, int mode) {
  constexpr int e = sizeof(typename P::E);
  long long s = c_smem ? 4LL * layers * rp * h : 0;
  s += (long long)e * rp * lstm_mma::serve_ldz<P>(d, c, h, layers) + (long long)e * rp * (h + 8);
  return s + (mode == SSB_STEP ? 4LL * rp * c : 0);
}

// lstm_mma::cell with the residual stores: the lane's activated gates (q =
// 0..3: i, f, g, o) and new c (q = 4) of its pairs go to res(row, unit, q,
// v_unit, v_unit+1), the new h to put(row, unit, h_unit, h_unit+1).
template <int MT, int UT, typename Bias, typename CGet, typename CSet, typename Put, typename Store>
__device__ __forceinline__ void cell_res(const float (&acc)[MT][UT][4][4], int r0, int u0, int lane, Bias bias,
                                         CGet c_get, CSet c_set, Put put, Store res) {
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ut = 0; ut < UT; ++ut) {
    const int unit = u0 + 8 * ut + 2 * t4;
    float2 b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = bias(q, unit);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float4 cv = c_get(mt, ut);
      const float c_old[4] = {cv.x, cv.y, cv.z, cv.w};
      float v[5][4], h[4];  // the gates and the new c (e = 0..3: rows g, g, g + 8, g + 8 at units 2t, 2t + 1)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[0][e] = sigmoid_f32(acc[mt][ut][0][e] + ((e & 1) ? b[0].y : b[0].x));
        v[1][e] = sigmoid_f32(acc[mt][ut][1][e] + ((e & 1) ? b[1].y : b[1].x));
        v[2][e] = tanhf(acc[mt][ut][2][e] + ((e & 1) ? b[2].y : b[2].x));
        v[3][e] = sigmoid_f32(acc[mt][ut][3][e] + ((e & 1) ? b[3].y : b[3].x));
        v[4][e] = v[1][e] * c_old[e] + v[0][e] * v[2][e];
        h[e] = v[3][e] * tanhf(v[4][e]);
      }
      c_set(mt, ut, make_float4(v[4][0], v[4][1], v[4][2], v[4][3]));
      const int row = r0 + 16 * mt + g8;
      put(row, unit, h[0], h[1]);
      put(row + 8, unit, h[2], h[3]);
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        res(row, unit, q, v[q][0], v[q][1]);
        res(row + 8, unit, q, v[q][2], v[q][3]);
      }
    }
  }
}

template <typename RT, int MODE, typename P>
__global__ void __launch_bounds__(512)
    train_fwd_kernel(const TrainFwdArgs a, int B, int T, int D, int C, int H, int L, const lstm_mma::Geom geo) {
  using namespace lstm_mma;
  constexpr int MT = 2;
  using TL = BodyTile<P, MT>;
  using E = typename P::E;
  constexpr bool TF = MODE == SSB_TF, STEP_CTX = MODE == SSB_STEP;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int rp = geo.rp, kx = kx_of<P>(D), kxc = kx + ctx_pad<P>(C), ldz = serve_ldz<P>(D, C, H, L), lde = H + 8;
  const int bands = H / TL::UNITS, tiles = rp / TL::ROWS * bands;
  const int kstride = kstride_of(H), G = 4 * H;
  const long long p0 = (long long)blockIdx.x * rp;
  const int nrows = (int)min((long long)rp, (long long)B - p0);  // the block's rows in the batch
  LstmProbe pr(g_lstm_probe);

  char* sp = reinterpret_cast<char*>(smem4);
  float4* cm;
  if (geo.c_glob) {
    cm = reinterpret_cast<float4*>(geo.c_glob + (size_t)blockIdx.x * L * rp * H);
  } else {
    cm = reinterpret_cast<float4*>(sp);
    sp += (size_t)4 * L * rp * H;
  }
  E* z = reinterpret_cast<E*>(sp);
  sp += sizeof(E) * rp * ldz;
  E* est = reinterpret_cast<E*>(sp);  // the new h of a layer-step (rounded in bf16), rows of H + 8
  sp += sizeof(E) * rp * lde;
  float* cst = reinterpret_cast<float*>(sp);  // SSB_STEP: ctx_t+1 (rp, C)
  const E* pwt = static_cast<const E*>(a.proj_wt);  // the decoder modes: proj_w transposed (D, H), from L1

  // x_t (SSB_TF) at element i of the block's rp x D, 0 past the rows
  auto x_at = [&](int t, int i) {
    const int r = i / D, d = i - r * D;
    return r < nrows ? ldg_now(a.xs + ((p0 + r) * T + t) * D + d) : 0.0f;
  };
  auto x_put = [&](int i, float v) {
    const int r = i / D;
    z[r * ldz + (i - r * D)] = P::cvt(v);
  };
  auto ctx_src = [&](int t) {  // row r's context of step t
    return [ctx = a.ctx, p0, T, C, t](int r) {
      return ctx + (STEP_CTX ? ((size_t)(p0 + r) * T + t) * C : (size_t)(p0 + r) * C);
    };
  };
  // the decoder's input of step t at row r (< nrows), coordinate d: the
  // teacher where the coin is up, else the previous output y
  auto x_dec = [&](int t, int r, int d, float y) {
    const size_t q = (size_t)t * B + p0 + r;
    return __ldg(a.coins + q) > 0.0f ? __ldg(a.teacher + q * D + d) : y;
  };

  zero16(z, rp * ldz * (int)sizeof(E) / 16);
  __syncthreads();  // z zeroed before x_0, the context and h0 land in it
  if constexpr (TF) {
    for (int i = tid; i < rp * D; i += nthr) x_put(i, x_at(0, i));
  } else {
    for (int i = tid; i < nrows * D; i += nthr) {
      const int r = i / D, d = i - r * D;
      z[r * ldz + d] = P::cvt(x_dec(0, r, d, __ldg(a.y0 + (p0 + r) * D + d)));
    }
  }
  ctx_load<P>(z + kx, ldz, rp, nrows, C, ctx_src(0));  // the static context, or ctx_0
  states_load<P, MT, TL>(z + kxc, ldz, cm, a.h0, a.c0, B, p0, nrows, rp, H, L);
  __syncthreads();  // z and c in place
  pr.mark(LP_STATES);

  // One layer-step of every tile: [za | zb] · W_l + b_l on the tensor cores,
  // the cell on the accumulators with c from the lanes' slots of layer l;
  // the new h into est, the residuals out.
  auto layer_tiles = [&](int l, int t) {
    const uint4* wl = a.w + (l ? (size_t)((kxc + H) / P::KS + (l - 1) * (2 * H / P::KS)) * kstride : 0);
    const E* za = l ? z + kxc + (l - 1) * H : z;
    const E* zb = z + kxc + l * H;
    const float* bl = a.b[l];
    RT* const hs = static_cast<RT*>(a.hs[l]);
    RT* const cs = static_cast<RT*>(a.cs[l]);
    RT* const gs = static_cast<RT*>(a.gs[l]);
    float4* cl0 = cm + (size_t)l * rp * H / 4 + lane;
    for (int tau = warp; tau < tiles; tau += nwarps) {
      const int r0 = tau / bands * TL::ROWS, u0 = tau % bands * TL::UNITS;
      float acc[MT][TL::UT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ut = 0; ut < TL::UT; ++ut)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][ut][q][e] = 0.0f;
      tile_product<P, MT, TFW_CHUNK, true>(acc, za + r0 * ldz, (l ? H : kxc) / P::KS, zb + r0 * ldz, H / P::KS,
                                            wl + tau % bands * TL::NP * 32 + lane, kstride, ldz, lane);
      pr.mark(LP_PRODUCTS);
      float4* cs4 = cl0 + (size_t)tau * MT * TL::UT * 32;
      cell_res<MT>(
          acc, r0, u0, lane, [&](int q, int unit) { return __ldg(reinterpret_cast<const float2*>(bl + q * H + unit)); },
          [&](int mt, int ut) { return cs4[(mt * TL::UT + ut) * 32]; },
          [&](int mt, int ut, float4 c) { cs4[(mt * TL::UT + ut) * 32] = c; },
          [&](int row, int unit, float h0, float h1) {
            P::put2(est + row * lde + unit, h0, h1);
            if (row < nrows) Res<RT>::st2(hs + ((size_t)(p0 + row) * T + t) * H + unit, h0, h1);
          },
          [&](int row, int unit, int q, float v0, float v1) {
            if (row >= nrows) return;
            const size_t o = (size_t)(p0 + row) * T + t;
            Res<RT>::st2(q < 4 ? gs + o * G + q * H + unit : cs + o * H + unit, v0, v1);
          });
      pr.mark(LP_CELL);
    }
  };

  for (int t = 0; t < T; ++t) {
    // SSB_TF: the thread's first element of x_t+1, loaded ahead of the products
    const float xr = TF && t + 1 < T && tid < rp * D ? x_at(t + 1, tid) : 0.0f;
    if (STEP_CTX && t + 1 < T) ctx_stage(cst, rp, nrows, C, ctx_src(t + 1), a.ctx);  // ctx_t+1 lands in cst
    pr.mark(LP_STAGE);
    for (int l = 0; l < L; ++l) {
      layer_tiles(l, t);
      __syncthreads();  // every tile of the layer-step read z; the staging is whole
      pr.mark(LP_BARRIERS);
      publish(z + kxc + l * H, ldz, est, lde, rp, H);
      pr.mark(LP_PUBLISH);
      if (l == 0 && t + 1 < T) {  // layer 0 has read x_t and ctx_t
        if constexpr (TF) {
          if (tid < rp * D) x_put(tid, xr);
          for (int i = tid + nthr; i < rp * D; i += nthr) x_put(i, x_at(t + 1, i));
        }
        if constexpr (STEP_CTX) ctx_land<P>(z + kx, ldz, cst, rp, C);
        pr.mark(LP_STAGE);
      }
      if (!TF && l == L - 1) {
        // y = h_top · proj_w + proj_b: ys[b, t], and with the coin of step
        // t + 1, x_t+1 in z
        project<P, SSB_MAX_D>(
            est, lde, rp, nrows, H, D, a.proj_b, [&](int i, int u) { return P::get4(pwt + i * H + u); },
            [&](int r, int i, float y) {
              a.ys[((size_t)(p0 + r) * T + t) * D + i] = y;
              if (t + 1 < T) z[r * ldz + i] = P::cvt(x_dec(t + 1, r, i, y));
            });
        pr.mark(LP_FEEDBACK);
      }
      __syncthreads();  // z holds this layer's h (x_t+1, ctx_t+1) for the next layer or step
      pr.mark(LP_BARRIERS);
    }
  }
}

// ---------------------------------------------------------------------------
// The backward recurrence on the tensor cores (ss_bwd_kernel) in three modes
// (SsbMode, a template parameter): the scheduled-sampling decoder's with a
// static context (lstm_ss.cu) or a per-step one (lstm_align.cu), and the
// teacher-forced LSTM's (lstm_train.cu, described after the first two); both
// compute tiers: P = lstm_mma::Tf32Mma (f32 compute: three-pass TF32 on mma.sync
// m16n8k8, operands split by split_fast, sums in fresh chunk accumulators)
// or lstm_mma::Bf16Mma (bf16 compute: mma.sync m16n8k16, bf16 operands, f32
// sums). In reverse time, per layer from the top down: the cell backward
// from the residual gates, c_t and c_{t-1} (c0 at t = 0), the carried dh
// and dc and `above` (dy_t · proj_wᵀ at the top layer); dgates, written f32;
// then dgates · Wᵀ, whose columns are, for l > 0, [the carried dh (H) |
// `above` of layer l - 1 (H)], and for layer 0 [the carried dh (H) | dctx
// (C) | dx (D)]; from dx, with the coin at step t, dteacher_t and the
// feedback into dy_{t-1}; at the end dy0, dh0 and dc0. SSB_STEP writes dctx
// per step (the lockstep decoder), SSB_STATIC sums it over t (lstm_ss.cu).
// SSB_TF, the teacher-forced LSTM (lstm_seq_states' backward, replacing the
// Pallas _bwd_kernel of longterm360fov_tpu/ops/lstm_train.py): no feedback,
// coin, projection or context; the top layer's `above` is the upstream
// dhs_top[t], read in the accumulator layout; the carries start from dhT,
// dcT; layer 0's input gradient dxs (B, T, D + C) is written every step, its
// first D (<= 8) columns as dx above and the other C (whole n8 tiles, at
// most H: a static context joined to every step's input) as the per-step
// dctx tiles are; at the end dh0, dc0.
//
// What bounds it on the card (stacked-ss-crossuser-10s: B = 4096, T = 100,
// L = 2, H = C = 128, D = 3): the products, 2·B·T·4H·(2H + H + C + 8) =
// 216 GFLOP with proj, 1.31 ms in three-pass TF32 at 495 / 3 TFLOP/s and
// 0.22 ms in bf16; the bytes, the residual gates and c read and the f32
// dgates written once, 0.885 ms at 3.35 TB/s with bf16 residuals: the bf16
// tier's bound; the recurrence, serial over T·L layer-steps, each a cell,
// a barrier and a product of K = 4H; and W, 1.05 MB in f32 a step, which no
// block's shared memory holds beside its state: every block reads it from
// L2 every step.
// What the design does about it:
//   * A block holds 32 batch rows (two m16 tiles, MT = 2) in H / 8 warps (16
//     at H = 128): one wave of 128 blocks at B = 4096. Warp w owns the units
//     8w .. 8w + 7 of all 32 rows: in the cell (its lanes' (row, unit) pairs
//     in mma's accumulator layout: rows g, g + 8 of each m-tile, units 2t,
//     2t + 1) and in the product, whose n-tiles are those units' dh and
//     `above`, so that the layer below reads `above` from the same warp's
//     registers and the carried dh, dc stay in lane-private slots of shared
//     memory. Where every layer's carries leave no room for 32 rows (8
//     layers at H = 128), the block holds 16 (MT = 1); above H = 128, where
//     a warp a unit block would pass 16 warps, a warp owns two (UB = 2: H /
//     16 warps, 16 rows a block), runs the cell of both and a product of
//     two n-tiles for each, and adds both blocks' dx partials in its slots.
//     MT and UB are template parameters, as the ring's depth: the 32-row
//     instances of one unit block a warp are those of every preset.
//   * The cell writes dgates f32 to device memory and, rounded where the
//     tier rounds (bf16), into an A buffer in shared memory (32 rows x 4H,
//     a 16-byte pad a row: ldmatrix's eight rows on distinct banks); a
//     barrier after the cell and one after the product (a second buffer,
//     which would save the latter, measured no faster).
//   * Each warp's product reads all 4H of dgates as its k by ldmatrix and
//     its n-tiles of Wᵀ as a stream of 16-byte pieces a lane (two k-steps a
//     piece) from L2, packed once a call by ops/lstm_ss.py pack_bwd_weights
//     in mma's B fragment order, each lane's pieces by cp.async through the
//     warp's own ring in shared memory, 3 k-pairs ahead of the mma (1 ahead
//     in registers left the products waiting on L2). The ring's depth is a
//     template parameter: 4 k-pairs, or 2 (1 ahead) where a deeper stack's
//     carries leave no room for 4 (ssb_stages). At layer 0 the C / 8
//     dctx n-tiles go one a warp.
//   * dx (D <= 8 columns): every warp's partial over its own 32 gate
//     columns, an mma on the cell's registers (dx_partial), summed in warp
//     order after the barrier (as a warp's third n-tile it held every other
//     warp at the barrier; on the FMA units it cost more). The feedback
//     (dteacher_t, dy_{t-1} = dys_{t-1} + dx·(1 - coin), `above` = dy ·
//     proj_wᵀ) runs on the FMA units, its coin and dys loaded at the step's
//     start; dy_{t-1} goes into shared memory, one more barrier a step.
//   * The residual gates and c of the next layer-step are loaded into
//     registers before the current product in the bf16 tier on bf16
//     residuals (24 registers). f32 residuals, and the f32 tier, whose
//     three-pass product spilled beside them (8 % of its time), load them
//     at the cell.
// The probe build (-DSSB_PROBE): thread 0 of every block adds the clock64
// ticks of each part to g_ssb_probe; ss_bwd_probe_read copies them out.
enum SsbPart {
  SB_LOADS,     // the residuals' loads (where they are not ahead) and `above` (from dy or dhs_top) at the top layer
  SB_CELL,      // the cell backward, the dgates stores (device and shared memory)
  SB_BARRIERS,  // block barriers
  SB_PRODUCTS,  // dgates · Wᵀ
  SB_EPILOGUE,  // the carried dh, dctx, the feedback
  SB_PARTS
};
__device__ unsigned long long g_ssb_probe[SB_PARTS];
#ifdef SSB_PROBE
using SsbProbe = ClockProbe<true>;
#else
using SsbProbe = ClockProbe<false>;
#endif

struct SsBwdArgs {
  const uint4* wt[MAX_LAYERS];  // layer l's Wᵀ packed (pack_bwd_weights), n-tile after n-tile
  const void* w0x;              // layer 0's W[:D] (D, 4H) in the compute type: dx
  const void* cs[MAX_LAYERS];   // (B, T, H) residual type
  const void* gs[MAX_LAYERS];   // (B, T, 4H)
  float* dg[MAX_LAYERS];        // (B, T, 4H) dgates out
  const void* proj_w;           // (H, D) in the compute type
  // SSB_TF only
  const float* dhs_top;  // (B, T, H) the upstream gradient of the top layer's h
  const float* dhT;      // (L, B, H) the carries' start
  const float* dcT;
  float* dxs;            // (B, T, D + C) layer 0's input gradient
};

// The block's dynamic shared memory: an A buffer of 16·mt rows x (4H + a
// 16-byte pad) in P::E, the carried dh and dc of every layer (f32), the
// static context's dctx sums (f32; STEP_CTX: none), dy_t of the rows (16·mt
// x SSB_MAX_D f32), the warps' partials of dx (h / (8·ub) warps x 16·mt x
// SSB_MAX_D f32) and each warp's ring of W's pieces (stages x 2 n-tiles x
// 512 bytes).
template <typename P>
__host__ __device__ inline long long ssb_smem_bytes(int h, int layers, int c, bool step_ctx, int stages, int mt = 2,
                                                    int ub = 1) {
  const int rows = 16 * mt, warps = h / (8 * ub);
  return (long long)sizeof(typename P::E) * rows * (4 * h + P::PAD) + 8LL * layers * rows * h +
         (step_ctx ? 0 : 4LL * rows * c) + 4LL * rows * SSB_MAX_D * (1 + warps) + 1024LL * stages * warps;
}

// The block of the backward recurrence (ops/lstm_ss.py bwd_block chooses the
// same): up to hidden 128 a warp owns one unit block of 8 (hidden / 8 warps,
// at most 16) and the block 32 rows (mt = 2) with the W ring 4 k-pairs deep
// (W read 3 k-pairs ahead), or 2 where the carries leave no room for 4;
// past that, and above hidden 128, where a warp owns two unit blocks (ub =
// 2: hidden / 16 warps), 16 rows (mt = 1) and a ring of 2. mt = 0: no block
// fits.
struct SsbBlock {
  int mt, ub, stages;
  long long smem;
};
template <typename P>
__host__ __device__ inline SsbBlock ssb_block(int h, int layers, int c, bool step_ctx) {
  const int ub = h > 128 ? 2 : 1;
  if (ub == 1)
    for (int stages = 4; stages >= 2; stages -= 2) {
      const long long s = ssb_smem_bytes<P>(h, layers, c, step_ctx, stages, 2, 1);
      if (s <= lstm_mma::SMEM_LIMIT) return {2, 1, stages, s};
    }
  const long long s = ssb_smem_bytes<P>(h, layers, c, step_ctx, 2, 1, ub);
  return s <= lstm_mma::SMEM_LIMIT ? SsbBlock{1, ub, 2, s} : SsbBlock{0, ub, 0, s};
}

// A warp's partial of dx = dgates · W[:D]ᵀ over the 32 gate columns of one
// of its unit blocks (gate q's units u - 2t .. + 7) for one m-tile, added to
// acc, on the tensor cores from the cell's registers: dg[q][hh][j] is the
// lane's dgates of gate q at row g + 8·hh, unit u + j, which are mma's A
// fragments in the k order below; the lane's B fragments are W[:D] at row n
// = g (zero where g >= D: ok), from w0x (D, 4H) in the compute type at w0 =
// g·4H + u. bf16 (m16n8k16): k16 step j covers gates 2j, 2j + 1, k = 2t, 2t
// + 1 ↔ units u, u + 1 of the first, k = 8 + 2t, .. of the second, rounded
// to bf16 as the A buffer. f32 (three-pass TF32, m16n8k8): k8 step q is gate
// q, k = t ↔ unit u, k = t + 4 ↔ unit u + 1. acc: rows g, g + 8 x d = 2t, 2t
// + 1.
template <typename P>
__device__ __forceinline__ void dx_partial(float (&acc)[4], const float (&dg)[4][2][2], const void* w0x, bool ok,
                                           size_t w0, int H) {
  if constexpr (std::is_same<P, lstm_mma::Tf32Mma>::value) {
    const float* wp = static_cast<const float*>(w0x) + w0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 bw = ok ? __ldg(reinterpret_cast<const float2*>(wp + q * H)) : make_float2(0.0f, 0.0f);
      unsigned ah[4], al[4], bh[2], bl[2];
      const float av[4] = {dg[q][0][0], dg[q][1][0], dg[q][0][1], dg[q][1][1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) lstm_mma::split_fast(av[e], ah[e], al[e]);
      lstm_mma::split_fast(bw.x, bh[0], bl[0]);
      lstm_mma::split_fast(bw.y, bh[1], bl[1]);
      mma_tf32(acc, al, bh[0], bh[1]);
      mma_tf32(acc, ah, bl[0], bl[1]);
      mma_tf32(acc, ah, bh[0], bh[1]);
    }
  } else {
    const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w0x) + w0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      unsigned av[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(dg[2 * j + (e >> 1)][e & 1][0], dg[2 * j + (e >> 1)][e & 1][1]);
        av[e] = *reinterpret_cast<const unsigned*>(&v);
      }
      const unsigned b0 = ok ? __ldg(reinterpret_cast<const unsigned*>(wp + 2 * j * H)) : 0u;
      const unsigned b1 = ok ? __ldg(reinterpret_cast<const unsigned*>(wp + (2 * j + 1) * H)) : 0u;
      mma_bf16(acc, av, b0, b1);
    }
  }
}

// a pair of residual values (units u, u + 1) loaded where it stands (volatile:
// the next layer-step's loads stay ahead of the product's asm), widened at use
template <typename RT>
struct ResPair;

template <>
struct ResPair<float> {
  using Raw = float2;
  static __device__ __forceinline__ Raw ld(const float* p) {
    Raw v;
    asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "l"(p));
    return v;
  }
  static __device__ __forceinline__ Raw zero() { return make_float2(0.0f, 0.0f); }
  static __device__ __forceinline__ float2 wide(Raw v) { return v; }
};

template <>
struct ResPair<__nv_bfloat16> {
  using Raw = unsigned;
  static __device__ __forceinline__ Raw ld(const __nv_bfloat16* p) {
    Raw v;
    asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
    return v;
  }
  static __device__ __forceinline__ Raw zero() { return 0u; }
  static __device__ __forceinline__ float2 wide(Raw v) {
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
  }
};

// acc[n][mt] = A · Wᵀ[:, n-tile n] for the block's 16·MT rows (mt: rows
// 16mt .. + 15) over k = 4H: A the dgates buffer `a` (row stride lda, P::E),
// by ldmatrix; the n-tiles' packed streams wn[n] (plus the lane), 16 bytes a
// lane a k-pair (two k-steps), each lane's pieces copied by cp.async into
// its own slots of the warp's ring of S k-pairs in shared memory (`ring`:
// S x 2 x 32 uint4), S - 1 k-pairs ahead of the mma; a lane reads only
// what it copied, so its own cp.async.wait_group orders them.
template <typename P, int NT, int S, int MT>
__device__ __forceinline__ void ssb_product(float (&acc)[NT][MT][4], const typename P::E* a, int lda,
                                            const uint4* const (&wn)[NT], int kpairs, int lane, uint4* ring) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][mt][e] = 0.0f;
  auto issue = [&](int kp) {
    if (kp < kpairs)
#pragma unroll
      for (int n = 0; n < NT; ++n) cp_async16(ring + ((kp % S) * 2 + n) * 32 + lane, wn[n] + 32 * kp, true);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);
  // k-pair kp's pieces from the ring; then the copy of k-pair kp + S - 1 into
  // the slot that k-pair kp - 1 left
  auto fetch = [&](uint4 (&b)[NT], int kp) {
    cp_async_wait<S - 2>();
#pragma unroll
    for (int n = 0; n < NT; ++n) b[n] = ring[((kp % S) * 2 + n) * 32 + lane];
    issue(kp + S - 1);
  };
  if constexpr (std::is_same<P, lstm_mma::Tf32Mma>::value) {
    const float* ap = a + (lane & 15) * lda + (lane >> 4) * 4;
    // chunks of two k-pairs (4 k8 steps) in fresh accumulators, added to acc
    for (int kp0 = 0; kp0 < kpairs; kp0 += 2) {
      float c[NT][MT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[n][mt][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = kp0 + j;
        uint4 b[NT];
        fetch(b, kp);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned bh[NT][2], bl[NT][2];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            lstm_mma::split_fast(__uint_as_float(h ? b[n].z : b[n].x), bh[n][0], bl[n][0]);
            lstm_mma::split_fast(__uint_as_float(h ? b[n].w : b[n].y), bh[n][1], bl[n][1]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            unsigned r[4], ah[4], al[4];
            ldsm_x4(r, ap + mt * 16 * lda + 8 * (2 * kp + h));
#pragma unroll
            for (int e = 0; e < 4; ++e) lstm_mma::split_fast(__uint_as_float(r[e]), ah[e], al[e]);
            // a_lo·b_hi, a_hi·b_lo, a_hi·b_hi: the small terms first
#pragma unroll
            for (int pass = 0; pass < 3; ++pass)
#pragma unroll
              for (int n = 0; n < NT; ++n) {
                const unsigned(&av)[4] = pass == 0 ? al : ah;
                const unsigned(&bv)[2] = pass == 1 ? bl[n] : bh[n];
                mma_tf32(c[n][mt], av, bv[0], bv[1]);
              }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][mt][e] += c[n][mt][e];
    }
  } else {
    const __nv_bfloat16* ap = a + (lane & 15) * lda + (lane >> 4) * 8;
#pragma unroll 2
    for (int kp = 0; kp < kpairs; ++kp) {
      uint4 b[NT];
      fetch(b, kp);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          unsigned av[4];
          ldsm_x4(av, ap + mt * 16 * lda + 16 * (2 * kp + h));
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_bf16(acc[n][mt], av, h ? b[n].z : b[n].x, h ? b[n].w : b[n].y);
        }
    }
  }
}

// MT: m16 tiles of rows a block (rows = 16·MT); UB: unit blocks of 8 a warp
// (warps = H / (8·UB)). Unit block k of the block is warp k / UB's.
template <typename RT, int MODE, typename P, int STAGES, int MT, int UB>
__global__ void __launch_bounds__(512)
    ss_bwd_kernel(const float* __restrict__ dys, const float* __restrict__ c0, const float* __restrict__ coins,
                  const SsBwdArgs a, float* __restrict__ dy, float* __restrict__ dteacher, float* __restrict__ dy0,
                  float* __restrict__ dh0, float* __restrict__ dc0, float* __restrict__ dctx, int B, int T, int D,
                  int C, int H, int L) {
  using E = typename P::E;
  using CT = std::conditional_t<std::is_same<P, lstm_mma::Tf32Mma>::value, float, __nv_bfloat16>;
  constexpr bool STEP_CTX = MODE != SSB_STATIC, TF = MODE == SSB_TF;
  constexpr int ROWS = 16 * MT;
  using RP = ResPair<RT>;
  using Raw = typename RP::Raw;
  // the next layer-step's residuals in registers during the bf16 tier's
  // product on bf16 residuals (24 registers; f32 ones would take 48, and
  // the three-pass product spills beside them); a warp of one unit block only
  constexpr bool AHEAD =
      UB == 1 && !std::is_same<RT, float>::value && std::is_same<P, lstm_mma::Bf16Mma>::value;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, nw = blockDim.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int G = 4 * H, lda = G + P::PAD, NB = H / 8, CB = C / 8;
  const int kpairs = G / (2 * P::KS), tile_u4 = kpairs * 32;  // k-pairs of K = 4H; uint4s of a packed n-tile
  const int rpw = (ROWS + nw - 1) / nw;                       // rows a warp takes in the feedback
  const long long row0 = (long long)blockIdx.x * ROWS;
  SsbProbe pr(g_ssb_probe);

  char* sp = reinterpret_cast<char*>(smem4);
  E* const ab = reinterpret_cast<E*>(sp);  // the A buffer of dgates (ROWS, lda)
  sp += sizeof(E) * ROWS * lda;
  // slot ((l·NB + k)·MT + mt)·32 + lane of unit block k (NB = nw·UB): the carried dh
  float4* dhs = reinterpret_cast<float4*>(sp);
  float4* dcs = dhs + (size_t)L * nw * UB * MT * 32;  // the carried dc
  sp += (size_t)2 * 16 * L * nw * UB * MT * 32;
  float4* dsum = reinterpret_cast<float4*>(sp);  // static dctx: slot (ct·MT + mt)·32 + lane of unit block ct
  if (!STEP_CTX) sp += (size_t)16 * CB * MT * 32;
  float* dys_s = reinterpret_cast<float*>(sp);  // (ROWS, SSB_MAX_D): dy_t of the block's rows
  sp += (size_t)4 * ROWS * SSB_MAX_D;
  float* dxp = reinterpret_cast<float*>(sp);  // (nw, ROWS, SSB_MAX_D): the warps' partials of dx
  sp += (size_t)4 * nw * ROWS * SSB_MAX_D;
  uint4* ring = reinterpret_cast<uint4*>(sp) + (size_t)w * STAGES * 64;  // the warp's ring of W's pieces

  // unit block ub of the warp: its index and the lane's units u, u + 1
  const int u0 = 8 * w * UB + 2 * t4;
  auto blk = [&](int ub) { return w * UB + ub; };
  auto unit = [&](int ub) { return u0 + 8 * ub; };
  auto slot = [&](int l, int k, int mt) { return ((size_t)(l * nw * UB + k) * MT + mt) * 32 + lane; };
  // the lane's rows: 16·mt + 8·hh + g
  auto grow = [&](int mt, int hh) { return row0 + 16 * mt + 8 * hh + g8; };
  // the lane's pairs of f32 rows (row stride ld) of the block, rows g and
  // g + 8 of m-tile mt at units u, u + 1, as a float4 in the accumulator
  // layout (zeros past the batch)
  auto pairs = [&](const float* src, size_t ld, int mt, int u) {
    float2 v[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long row = grow(mt, hh);
      v[hh] = row < B ? *reinterpret_cast<const float2*>(src + (size_t)row * ld + u) : make_float2(0.0f, 0.0f);
    }
    return make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
  };
  if constexpr (TF) {  // the carries from dhT, dcT into the lanes' own slots
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int ub = 0; ub < UB; ++ub)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          dhs[slot(l, blk(ub), mt)] = pairs(a.dhT + (size_t)l * B * H, H, mt, unit(ub));
          dcs[slot(l, blk(ub), mt)] = pairs(a.dcT + (size_t)l * B * H, H, mt, unit(ub));
        }
  } else {
    for (int i = tid; i < 2 * L * nw * UB * MT * 32; i += blockDim.x) dhs[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (!STEP_CTX)
    for (int i = tid; i < CB * MT * 32; i += blockDim.x) dsum[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // dy_{T-1} = dys_{T-1}: the decoder's last output gets no feedback
  for (int i = tid; i < (TF ? 0 : ROWS * SSB_MAX_D); i += blockDim.x) {
    const int r = i / SSB_MAX_D, d = i % SSB_MAX_D;
    const long long row = row0 + r;
    float v = 0.0f;
    if (d < D && row < B) {
      const size_t q = ((size_t)row * T + T - 1) * D + d;
      v = dys[q];
      dy[q] = v;
    }
    dys_s[i] = v;
  }

  // the residuals of layer-step (l, t) for the lane's pairs at units u, u +
  // 1: gates, c_t, c_{t-1} (t > 0; c0 is read in the cell)
  struct Ahead {
    Raw g[4][MT][2], ct[MT][2], cp[MT][2];
  };
  auto load = [&](Ahead& r, int l, int t, int u) {
    const RT* gs = static_cast<const RT*>(a.gs[l]);
    const RT* cs = static_cast<const RT*>(a.cs[l]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long row = grow(mt, hh);
        const bool ok = row < B;
        const size_t q = (size_t)row * T + t;
#pragma unroll
        for (int k = 0; k < 4; ++k) r.g[k][mt][hh] = ok ? RP::ld(gs + q * G + k * H + u) : RP::zero();
        r.ct[mt][hh] = ok ? RP::ld(cs + q * H + u) : RP::zero();
        r.cp[mt][hh] = ok && t > 0 ? RP::ld(cs + (q - 1) * H + u) : RP::zero();
      }
  };

  Ahead res;
  if (AHEAD) load(res, L - 1, T - 1, unit(0));
  __syncthreads();  // the slots zeroed, dy_{T-1} in place
  float4 above[UB][MT];  // the gradient at the lane's pairs of this layer's h from above
  pr.mark(SB_LOADS);
  for (int t = T - 1; t >= 0; --t) {
    // the coin of step t and dys_{t-1} at the lane's first (row, d) of the feedback
    float fb_coin = 0.0f, fb_dys = 0.0f;
    if constexpr (!TF) {
      const int d = lane % SSB_MAX_D, r = w + nw * (lane / SSB_MAX_D);
      const long long row = row0 + r;
      if (lane < rpw * SSB_MAX_D && r < ROWS && d < D && row < B) {
        fb_coin = lstm_mma::ldg_now(coins + (size_t)t * B + row);
        if (t > 0) fb_dys = lstm_mma::ldg_now(dys + ((size_t)row * T + t - 1) * D + d);
      }
    }
    for (int l = L - 1; l >= 0; --l) {
#pragma unroll
      for (int ub = 0; ub < UB; ++ub) {
        const int u = unit(ub);
        if (TF && l == L - 1) {  // the upstream dhs_top[t]
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) above[ub][mt] = pairs(a.dhs_top + (size_t)t * H, (size_t)T * H, mt, u);
        } else if (l == L - 1) {  // dy_t · proj_wᵀ from the f32 dy, rounded to CT as it enters the product
          const CT* pw = static_cast<const CT*>(a.proj_w);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float* dyr = dys_s + (16 * mt + 8 * (e >> 1) + g8) * SSB_MAX_D;
              const CT* pwu = pw + (size_t)(u + (e & 1)) * D;
              float s = 0.0f;
              for (int d = 0; d < D; ++d) s = fmaf(cround<CT>(dyr[d]), ldw1(pwu + d), s);
              v[e] = s;
            }
            above[ub][mt] = make_float4(v[0], v[1], v[2], v[3]);
          }
        }
      }
      if (!AHEAD && UB == 1) load(res, l, t, unit(0));
      pr.mark(SB_LOADS);
      // -- the cell backward on the lane's pairs of each unit block; dgates
      // out and into the A buffer; at layer 0 the warp's partial of dx over
      // its gate columns
      {
        float* dgo = a.dg[l];
#pragma unroll
        for (int ub = 0; ub < UB; ++ub) {
          const int u = unit(ub);
          if (!AHEAD && UB > 1) load(res, l, t, u);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float4* dh_slot = dhs + slot(l, blk(ub), mt);
            float4* dc_slot = dcs + slot(l, blk(ub), mt);
            const float4 dh4 = *dh_slot, dc4 = *dc_slot;
            const float dhv[4] = {dh4.x, dh4.y, dh4.z, dh4.w};
            const float ab4[4] = {above[ub][mt].x, above[ub][mt].y, above[ub][mt].z, above[ub][mt].w};
            float dcv[4] = {dc4.x, dc4.y, dc4.z, dc4.w};
            float dg[4][2][2];  // gate, row g or g + 8, unit u or u + 1
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const long long row = grow(mt, hh);
              float2 gq[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) gq[k] = RP::wide(res.g[k][mt][hh]);
              const float2 ct = RP::wide(res.ct[mt][hh]);
              float2 cp = RP::wide(res.cp[mt][hh]);
              if (t == 0 && row < B) cp = *reinterpret_cast<const float2*>(c0 + ((size_t)l * B + row) * H + u);
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int e = 2 * hh + j;
                const float i_g = j ? gq[0].y : gq[0].x, f_g = j ? gq[1].y : gq[1].x;
                const float g_g = j ? gq[2].y : gq[2].x, o_g = j ? gq[3].y : gq[3].x;
                const float c_t = j ? ct.y : ct.x, c_p = j ? cp.y : cp.x;
                const float dh_total = ab4[e] + dhv[e];
                const float tanh_c = tanhf(c_t);
                const float dc_total = dh_total * o_g * (1.0f - tanh_c * tanh_c) + dcv[e];
                dg[0][hh][j] = dc_total * g_g * i_g * (1.0f - i_g);
                dg[1][hh][j] = dc_total * c_p * f_g * (1.0f - f_g);
                dg[2][hh][j] = dc_total * i_g * (1.0f - g_g * g_g);
                dg[3][hh][j] = dh_total * tanh_c * o_g * (1.0f - o_g);
                dcv[e] = dc_total * f_g;
              }
              const int r = 16 * mt + 8 * hh + g8;
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                P::put2(ab + (size_t)r * lda + k * H + u, dg[k][hh][0], dg[k][hh][1]);
                if (row < B)
                  *reinterpret_cast<float2*>(dgo + ((size_t)row * T + t) * G + k * H + u) =
                      make_float2(dg[k][hh][0], dg[k][hh][1]);
              }
            }
            *dc_slot = make_float4(dcv[0], dcv[1], dcv[2], dcv[3]);
            if (l == 0) {  // dx's partial (rows of the m-tile x d = 2t, 2t + 1) into dxp, added to
                           // the warp's earlier unit blocks' (the lane's own slots)
              float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              dx_partial<P>(acc, dg, a.w0x, g8 < D, (size_t)g8 * G + u, H);
              const int r = 16 * mt + g8;
              float2* lo = reinterpret_cast<float2*>(dxp + ((size_t)w * ROWS + r) * SSB_MAX_D + 2 * t4);
              float2* hi = reinterpret_cast<float2*>(dxp + ((size_t)w * ROWS + r + 8) * SSB_MAX_D + 2 * t4);
              if (ub > 0) {
                const float2 a0 = *lo, a1 = *hi;
                acc[0] += a0.x, acc[1] += a0.y, acc[2] += a1.x, acc[3] += a1.y;
              }
              *lo = make_float2(acc[0], acc[1]);
              *hi = make_float2(acc[2], acc[3]);
            }
          }
        }
      }
      pr.mark(SB_CELL);
      __syncthreads();  // the A buffer is whole
      pr.mark(SB_BARRIERS);
      if (AHEAD && (l > 0 || t > 0)) load(res, l > 0 ? l - 1 : L - 1, l > 0 ? t : t - 1, unit(0));
      // -- dgates · Wᵀ: the warp's n-tiles, then what each feeds
      const uint4* wl = a.wt[l] + lane;
      auto epilogue = [&](int id, int ub, const float (&v)[MT][4]) {
        if (id < NB) {  // the carried dh of unit block id, for step t - 1
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) dhs[slot(l, id, mt)] = make_float4(v[mt][0], v[mt][1], v[mt][2], v[mt][3]);
        } else if (l > 0) {  // `above` of layer l - 1 at the same pairs
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) above[ub][mt] = make_float4(v[mt][0], v[mt][1], v[mt][2], v[mt][3]);
        } else {  // dctx of context columns 8·ct .. (TF: dxs' columns D + 8·ct ..)
          const int ct = id - NB;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if constexpr (TF) {  // rows of D + C floats: no pair is 8-byte aligned for every D
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const long long row = grow(mt, hh);
                if (row < B) {
                  float* o = a.dxs + ((size_t)row * T + t) * (D + C) + D + 8 * ct + 2 * t4;
                  o[0] = v[mt][2 * hh];
                  o[1] = v[mt][2 * hh + 1];
                }
              }
            } else if constexpr (STEP_CTX) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const long long row = grow(mt, hh);
                if (row < B)
                  *reinterpret_cast<float2*>(dctx + ((size_t)row * T + t) * C + 8 * ct + 2 * t4) =
                      make_float2(v[mt][2 * hh], v[mt][2 * hh + 1]);
              }
            } else {
              float4& sm = dsum[((size_t)ct * MT + mt) * 32 + lane];
              sm = make_float4(sm.x + v[mt][0], sm.y + v[mt][1], sm.z + v[mt][2], sm.w + v[mt][3]);
            }
          }
        }
      };
      if (l == 0) {
        // dx = the warps' partials summed in warp order (TF: written to dxs);
        // dteacher_t and the feedback into dy_{t-1} (dy0 at t = 0): lane
        // i·8 + d of warp w takes row w + nw·i, coordinate d, its coin and
        // dys_{t-1} loaded ahead
        for (int j = lane, first = 1; j < rpw * SSB_MAX_D; j += 32, first = 0) {
          const int d = j % SSB_MAX_D, r = w + nw * (j / SSB_MAX_D);
          const long long row = row0 + r;
          if (d >= D || r >= ROWS) continue;
          float dx = 0.0f;
          for (int v = 0; v < nw; ++v) dx += dxp[((size_t)v * ROWS + r) * SSB_MAX_D + d];
          if constexpr (TF) {
            if (row < B) a.dxs[((size_t)row * T + t) * (D + C) + d] = dx;
            continue;
          }
          float next = 0.0f;
          if (row < B) {
            const size_t q = (size_t)t * B + row;
            const float coin = first ? fb_coin : coins[q];
            dteacher[q * D + d] = dx * coin;
            const float fb = dx * (1.0f - coin);
            if (t > 0) {
              const size_t qy = ((size_t)row * T + t - 1) * D + d;
              next = (first ? fb_dys : dys[qy]) + fb;
              dy[qy] = next;
            } else {
              dy0[(size_t)row * D + d] = fb;
            }
          }
          if (t > 0) dys_s[r * SSB_MAX_D + d] = next;
        }
        pr.mark(SB_EPILOGUE);
      }
      // each unit block's n-tiles: its dh, then `above` (l > 0) or its dctx
      // tile, the product of NT n-tiles through the warp's ring
      auto product = [&](auto& acc, const auto& wn) {
        constexpr int NT = std::extent<std::remove_reference_t<decltype(wn)>>::value;
        ssb_product<P, NT, STAGES, MT>(acc, ab, lda, wn, kpairs, lane, ring);
      };
#pragma unroll
      for (int ub = 0; ub < UB; ++ub) {
        const int k = blk(ub), id1 = l > 0 || k < CB ? NB + k : -1;
        if (id1 >= 0) {
          float acc[2][MT][4];
          const uint4* const wn[2] = {wl + (size_t)k * tile_u4, wl + (size_t)id1 * tile_u4};
          product(acc, wn);
          pr.mark(SB_PRODUCTS);
          epilogue(k, ub, acc[0]);
          epilogue(id1, ub, acc[1]);
        } else {
          float acc[1][MT][4];
          const uint4* const wn[1] = {wl + (size_t)k * tile_u4};
          product(acc, wn);
          pr.mark(SB_PRODUCTS);
          epilogue(k, ub, acc[0]);
        }
      }
      pr.mark(SB_EPILOGUE);
      __syncthreads();  // every warp has read the A buffer before the next cell writes it
      pr.mark(SB_BARRIERS);
    }
    if constexpr (!TF) {
      __syncthreads();  // dy_{t-1} of every row in dys_s
      pr.mark(SB_BARRIERS);
    }
  }

  // dh0, dc0 from the slots; the static context's dctx from its sums
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int ub = 0; ub < UB; ++ub)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float4 vh = dhs[slot(l, blk(ub), mt)], vc = dcs[slot(l, blk(ub), mt)];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long row = grow(mt, hh);
          if (row >= B) continue;
          const size_t o = ((size_t)l * B + row) * H + unit(ub);
          *reinterpret_cast<float2*>(dh0 + o) = hh ? make_float2(vh.z, vh.w) : make_float2(vh.x, vh.y);
          *reinterpret_cast<float2*>(dc0 + o) = hh ? make_float2(vc.z, vc.w) : make_float2(vc.x, vc.y);
        }
      }
  if (!STEP_CTX)
#pragma unroll
    for (int ub = 0; ub < UB; ++ub) {
      const int k = blk(ub);
      if (k >= CB) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float4 v = dsum[((size_t)k * MT + mt) * 32 + lane];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long row = grow(mt, hh);
          if (row < B)
            *reinterpret_cast<float2*>(dctx + (size_t)row * C + 8 * k + 2 * t4) =
                hh ? make_float2(v.z, v.w) : make_float2(v.x, v.y);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// launches shared by the C interfaces of lstm_ss.cu and lstm_align.cu; each
// returns cudaGetLastError() (0 = ok)
// ---------------------------------------------------------------------------

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

// The training forward (train_fwd_kernel) in mode MODE: a block of rp = 32
// rows (one 32-row warp tile) and `warps` warps (at most 16), c in
// shared memory or, where c_glob is given, in c_glob (grid x layers x rp x
// hidden floats), as ops/lstm_train.py fwd_block chooses; hidden a multiple
// of 32 up to 256, 1..8 layers; SSB_TF: d >= 1 input columns, no context;
// the decoder modes: d <= 8, ctx_dim a multiple of 4. Returns
// cudaGetLastError() (0 = ok); an invalid value for a block it does not take.
static inline long long train_fwd_smem(int rp, int d, int ctx_dim, int hidden, int layers, bool c_smem, int mode,
                                       int cbf16) {
  return cbf16 ? tfw_smem_bytes<lstm_mma::Bf16Mma>(rp, d, ctx_dim, hidden, layers, c_smem, mode)
               : tfw_smem_bytes<lstm_mma::Tf32Mma>(rp, d, ctx_dim, hidden, layers, c_smem, mode);
}

static inline bool train_fwd_bad_shape(int batch, int t_len, int d, int ctx_dim, int hidden, int layers, int rp,
                                       int warps, bool c_smem, int mode, int cbf16) {
  return layers < 1 || layers > MAX_LAYERS || hidden < 32 || hidden > 256 || hidden % 32 || batch < 1 ||
         t_len < 1 || d < 1 || (mode != SSB_TF && d > SSB_MAX_D) || ctx_dim < 0 || ctx_dim % 4 ||
         (mode == SSB_TF && ctx_dim) || rp != 32 || warps < 1 || warps > 16 ||
         (long long)batch * t_len >= (1LL << 31) ||
         train_fwd_smem(rp, d, ctx_dim, hidden, layers, c_smem, mode, cbf16) > lstm_mma::SMEM_LIMIT;
}

template <int MODE>
static int train_fwd_go(const TrainFwdArgs& a, void* c_glob, int batch, int t_len, int d, int ctx_dim, int hidden,
                        int layers, int rp, int warps, int bf16, int cbf16, void* stream) {
  const bool c_smem = c_glob == nullptr;
  if (train_fwd_bad_shape(batch, t_len, d, ctx_dim, hidden, layers, rp, warps, c_smem, MODE, cbf16))
    return (int)cudaErrorInvalidValue;
  const long long smem = train_fwd_smem(rp, d, ctx_dim, hidden, layers, c_smem, MODE, cbf16);
  const lstm_mma::Geom geo{rp, 2, 0, static_cast<float*>(c_glob)};
  const int grid = (batch + rp - 1) / rp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TFW(RT, P)                                                                                            \
  launch_with_smem(train_fwd_kernel<RT, MODE, P>, grid, 32 * warps, (size_t)smem, st, a, batch, t_len, d, ctx_dim, \
                   hidden, layers, geo)
  using BF = __nv_bfloat16;
  if (bf16 && cbf16) return TFW(BF, lstm_mma::Bf16Mma);
  if (bf16) return TFW(BF, lstm_mma::Tf32Mma);
  if (cbf16) return TFW(float, lstm_mma::Bf16Mma);
  return TFW(float, lstm_mma::Tf32Mma);
#undef TFW
}

// The training forward's arguments: W packed, every layer's pointers, the
// states; the mode's own pointers are set by the caller.
static inline TrainFwdArgs train_fwd_args(const void* w, const void* const* b, void* const* hs, void* const* cs,
                                          void* const* gs, const void* h0, const void* c0, int layers) {
  TrainFwdArgs a = {};
  a.w = static_cast<const uint4*>(w);
  for (int l = 0; l < std::min(layers, MAX_LAYERS); ++l) {
    a.b[l] = static_cast<const float*>(b[l]);
    a.hs[l] = hs[l];
    a.cs[l] = cs[l];
    a.gs[l] = gs[l];
  }
  a.h0 = static_cast<const float*>(h0);
  a.c0 = static_cast<const float*>(c0);
  return a;
}

// The scheduled-sampling decoder's forward (a static context, or STEP_CTX a
// per-step one): coins (t_len, batch), teacher (t_len, batch, d), y0 (batch,
// d), ctx (batch, ctx_dim) or (batch, t_len, ctx_dim) (null when ctx_dim ==
// 0), proj_wt (d, hidden) proj_w transposed in the compute type → ys (batch,
// t_len, d) f32 and the residuals.
template <bool STEP_CTX>
static int ss_fwd_launch(const void* w, const void* const* b, void* const* hs, void* const* cs, void* const* gs,
                         const void* h0, const void* c0, const void* y0, const void* teacher, const void* coins,
                         const void* ctx, const void* proj_wt, const void* proj_b, void* ys, void* c_glob, int batch,
                         int t_len, int d, int ctx_dim, int hidden, int layers, int rp, int warps, int bf16,
                         int cbf16, void* stream) {
  TrainFwdArgs a = train_fwd_args(w, b, hs, cs, gs, h0, c0, layers);
  a.y0 = static_cast<const float*>(y0);
  a.teacher = static_cast<const float*>(teacher);
  a.coins = static_cast<const float*>(coins);
  a.ctx = static_cast<const float*>(ctx);
  a.proj_wt = proj_wt;
  a.proj_b = static_cast<const float*>(proj_b);
  a.ys = static_cast<float*>(ys);
  if (ctx_dim > 0 && ctx == nullptr) return (int)cudaErrorInvalidValue;
  return train_fwd_go<STEP_CTX ? SSB_STEP : SSB_STATIC>(a, c_glob, batch, t_len, d, ctx_dim, hidden, layers, rp,
                                                        warps, bf16, cbf16, stream);
}

// The backward recurrence (ss_bwd_kernel): its block from ssb_block (32 or
// 16 batch rows, hidden / 8 or hidden / 16 warps; hidden a multiple of 32 up
// to 256) with W rings of its depth; wt: every layer's Wᵀ packed for the
// tier (ops/lstm_ss.py pack_bwd_weights; f32, or bf16 when cbf16); w0x
// layer 0's W[:d] and proj_w in the tier's type; ctx_dim a multiple of 8 up
// to hidden (the dctx n-tiles, one a unit block), d <= 8. dctx is (batch,
// ctx_dim) or, STEP_CTX, (batch, t_len, ctx_dim). The teacher-forced mode
// takes the same shapes, with d the narrow and ctx_dim the wide columns of
// layer 0's input.
static inline bool ss_bwd_bad_shape(int batch, int t_len, int d, int ctx_dim, int hidden, int layers) {
  return layers < 1 || layers > MAX_LAYERS || hidden < 32 || hidden > 256 || hidden % 32 || batch < 1 ||
         t_len < 1 || d < 1 || d > SSB_MAX_D || ctx_dim < 0 || ctx_dim % 8 || ctx_dim > hidden ||
         (long long)batch * t_len >= (1LL << 31);
}

// ss_bwd_kernel's block (ssb_block) in the tier; the teacher-forced mode's
// is that of a per-step context (step_ctx)
static inline SsbBlock ss_bwd_block(int hidden, int layers, int ctx_dim, bool step_ctx, int cbf16) {
  return cbf16 ? ssb_block<lstm_mma::Bf16Mma>(hidden, layers, ctx_dim, step_ctx)
               : ssb_block<lstm_mma::Tf32Mma>(hidden, layers, ctx_dim, step_ctx);
}

// ss_bwd_kernel's dynamic shared memory at its block, -1 for a shape it
// does not take
static inline long long ss_bwd_smem(int d, int ctx_dim, int hidden, int layers, bool step_ctx, int cbf16) {
  if (ss_bwd_bad_shape(1, 1, d, ctx_dim, hidden, layers)) return -1;
  const SsbBlock g = ss_bwd_block(hidden, layers, ctx_dim, step_ctx, cbf16);
  return g.mt ? g.smem : -1;
}

// The kernel's per-layer pointers, w0x and proj_w (null in the
// teacher-forced mode) as its arguments; the mode's own pointers are set by
// the caller.
static inline SsBwdArgs ss_bwd_args(const void* const* wt, const void* w0x, const void* proj_w,
                                    const void* const* cs, const void* const* gs, void* const* dg, int layers) {
  SsBwdArgs a = {};
  for (int l = 0; l < std::min(layers, MAX_LAYERS); ++l) {
    a.wt[l] = static_cast<const uint4*>(wt[l]);
    a.cs[l] = cs[l];
    a.gs[l] = gs[l];
    a.dg[l] = static_cast<float*>(dg[l]);
  }
  a.w0x = w0x;
  a.proj_w = proj_w;
  return a;
}

// Launch ss_bwd_kernel in the mode MODE (the scheduled-sampling pointers,
// dys .. dy0 and dctx, null in SSB_TF).
template <int MODE>
static int ss_bwd_go(const SsBwdArgs& a, const void* dys, const void* c0, const void* coins, void* dy,
                     void* dteacher, void* dy0, void* dh0, void* dc0, void* dctx, int batch, int t_len, int d,
                     int ctx_dim, int hidden, int layers, int bf16, int cbf16, void* stream) {
  constexpr bool STEP_CTX = MODE != SSB_STATIC;
  if (ss_bwd_bad_shape(batch, t_len, d, ctx_dim, hidden, layers)) return (int)cudaErrorInvalidValue;
  const SsbBlock g = ss_bwd_block(hidden, layers, ctx_dim, STEP_CTX, cbf16);
  if (g.mt == 0) return (int)cudaErrorInvalidValue;
  const int grid = (batch + 16 * g.mt - 1) / (16 * g.mt), threads = 32 * (hidden / (8 * g.ub));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *f_dys = static_cast<const float*>(dys), *f_c0 = static_cast<const float*>(c0),
              *f_coins = static_cast<const float*>(coins);
  float *o_dy = static_cast<float*>(dy), *o_dt = static_cast<float*>(dteacher), *o_dy0 = static_cast<float*>(dy0),
        *o_dh0 = static_cast<float*>(dh0), *o_dc0 = static_cast<float*>(dc0), *o_dctx = static_cast<float*>(dctx);
#define SSB_AT(RT, P, S, MT, UB)                                                                                 \
  launch_with_smem(ss_bwd_kernel<RT, MODE, P, S, MT, UB>, grid, threads, (size_t)g.smem, st, f_dys, f_c0,       \
                   f_coins, a, o_dy, o_dt, o_dy0, o_dh0, o_dc0, o_dctx, batch, t_len, d, ctx_dim, hidden, layers)
  // the instances: 32 rows with rings of 4 or 2; 16 rows with a ring of 2, a
  // warp of one or two unit blocks
#define SSB(RT, P)                                                                                  \
  (g.mt == 2 ? (g.stages == 4 ? SSB_AT(RT, P, 4, 2, 1) : SSB_AT(RT, P, 2, 2, 1))                   \
             : (g.ub == 1 ? SSB_AT(RT, P, 2, 1, 1) : SSB_AT(RT, P, 2, 1, 2)))
  using BF = __nv_bfloat16;
  if (bf16 && cbf16) return SSB(BF, lstm_mma::Bf16Mma);
  if (bf16) return SSB(BF, lstm_mma::Tf32Mma);
  if (cbf16) return SSB(float, lstm_mma::Bf16Mma);
  return SSB(float, lstm_mma::Tf32Mma);
#undef SSB
#undef SSB_AT
}

// The scheduled-sampling decoder's backward: a static context, or STEP_CTX a
// per-step one
template <bool STEP_CTX>
static int ss_bwd_launch(const void* dys, const void* c0, const void* coins, const void* const* wt,
                         const void* w0x, const void* proj_w, const void* const* cs, const void* const* gs, void* const* dg, void* dy,
                         void* dteacher, void* dy0, void* dh0, void* dc0, void* dctx, int batch, int t_len, int d,
                         int ctx_dim, int hidden, int layers, int bf16, int cbf16, void* stream) {
  return ss_bwd_go<STEP_CTX ? SSB_STEP : SSB_STATIC>(ss_bwd_args(wt, w0x, proj_w, cs, gs, dg, layers), dys, c0,
                                                     coins, dy, dteacher, dy0, dh0, dc0, dctx, batch, t_len, d,
                                                     ctx_dim, hidden, layers, bf16, cbf16, stream);
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
