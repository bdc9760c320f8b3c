// Teacher-forced stacked LSTM for training, forward and backward, for Hopper
// (sm_90a), exact f32 compute, residuals in f32 or bf16.
//
// Replaces the TPU Pallas kernels of
//   longterm360fov_tpu/ops/lstm_train.py::lstm_seq_states
// (_fwd_kernel and _bwd_kernel under a jax.custom_vjp) with three kernels:
//   * lstm_fwd_kernel: the forward recurrence over T steps and L layers from
//     (h0, c0). It saves per layer h, c (B, T, H) and the post-activation
//     gates i, f, g, o (B, T, 4H) in the residual type. Carries stay f32.
//   * lstm_bwd_kernel: the backward recurrence in reverse time. Per layer,
//     top-down, it forms dgates = [di, df, dg, do] from the residuals and the
//     carried (dh, dc), writes dgates (B, T, 4H) f32, and runs
//     dz = dgates · Wᵀ: dz's h part is the next carried dh, its input part
//     the gradient of the layer below (dxs for layer 0). It ends with dh0,
//     dc0. The top layer's dh is the upstream dhs_top plus the carried dh;
//     the carries start from dhT, dcT.
//   * lstm_dw_partial_kernel + lstm_dw_sum_kernel: dW_l = Σ_{b,t} zᵀ·dgates
//     and db_l = Σ_{b,t} dgates with z = [input_t, h_{t-1}]: input_t is xs
//     for layer 0 and o·tanh(c) of the layer below, rebuilt from its
//     residuals, for l > 0; h_{t-1} is read from the residuals, and from h0
//     at t = 0. The TPU kernel summed dW in a buffer that stayed in VMEM
//     across its grid, which ran in order; blocks here run in parallel, so
//     the (b, t) rows are split into S slices, each block writes the partial
//     sums of one dW tile over one slice, and a second pass adds the S
//     partials in a fixed order. No float atomics: two runs give the same
//     bits.
// Every tensor is read and written batch-major, (B, T, ·), as the caller
// holds it: a row's H values are contiguous, so a warp's per-step stores of
// one row are one coalesced 512-byte (f32) or 256-byte (bf16) segment. No
// time-major copies.
//
// What bounds it on the card, at seq2seq-tf-30's training shapes
// (B = 4096, T = 30, D = 3, H = 128, L = 1):
//   * Arithmetic. The forward is 2·B·T·(D+H)·4H = 16.5 GFLOP per pass, the
//     backward recurrence 16.1 GFLOP (dgates·Wᵀ) and the dW reduction
//     16.5 GFLOP, all exact f32 on the FMA units (67 TFLOP/s peak, so at
//     least 0.25 ms each).
//   * Bytes. The residuals are 6H words per row-step: 377 MB per pass in f32,
//     189 MB in bf16, plus dgates (4H f32, 252 MB) written by the backward
//     recurrence and read by the reduction. At 3.35 TB/s that is 0.06-0.19 ms
//     per kernel, under the FMA time: all three kernels are bound by FMA
//     throughput, as fused_serve is, and not by bytes.
//   * W does not fit shared memory (131 x 512 x 4 = 268 KB > 227 KB); as in
//     fused_serve.cu it is streamed from L2 with 16-byte loads every step.
//   * Occupancy at the training batch. fused_serve's 64 rows per block give
//     64 blocks at B = 4096: under half a wave on 132 SMs. Here a thread owns
//     TR = 4 rows x TJ = 4 hidden units and a block 16 rows (the wrapper
//     picks; 8 rows per thread spilled registers and ran slower): at
//     B = 4096 that is 256 blocks of 128 threads, two resident per SM, one
//     wave. The dW reduction tiles dW into 128 x 128 tiles and splits the
//     B·T rows so that the full tiles alone give two blocks per SM.
// What the design does about it:
//   * The recurrences keep every carry on chip: h of every layer k-major in
//     shared memory (read as the second half of [x, h]), c and the backward's
//     dh, dc in owner-private shared memory (a thread owns the same
//     (row, unit) pairs in every step, so the cell math needs no exchange),
//     and the current step's dgates k-major in shared memory for the
//     dgates · Wᵀ product, which reads Wᵀ (prepared by the wrapper) with
//     coalesced 16-byte loads. A k-major column of the thread's 4 rows is one
//     16-byte shared load (a broadcast: a warp shares its rows) and one
//     16-byte store.
//   * The dW reduction is a tiled f32 GEMM over the (b, t) rows: 16 rows of z
//     and dgates per stage in shared memory, an 8 x 8 register tile per
//     thread (64 FMAs per four 16-byte shared loads), the next stage's
//     16-byte global loads in flight while the current one computes. z is
//     assembled while it is loaded, h part first so that it is whole 16-byte
//     runs, and is never written to device memory.

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

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float* w[MAX_LAYERS];  // (in_l + H, 4H), gate order i, f, g, o
  const float* b[MAX_LAYERS];  // (4H,)
  void* hs[MAX_LAYERS];        // (B, T, H) residual type
  void* cs[MAX_LAYERS];        // (B, T, H)
  void* gs[MAX_LAYERS];        // (B, T, 4H)
};

// One layer-step for the block's R rows: gates = [in, h] @ W + b, the cell
// update, and the residual stores. in: (k_in, R) layer input; h: (H, R) this
// layer's hidden state, read and then overwritten; c: this layer's cell
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

template <typename RT>
__global__ void __launch_bounds__(256)
    lstm_fwd_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                    const float* __restrict__ c0, const FwdArgs a, int B,
                    int T, int D, int H, int L, int R) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int j0 = (tid % (H / TJ)) * TJ;
  const int r0 = (tid / (H / TJ)) * TR;
  const int HR = H * R;
  float* h_s = smem;          // L x (H, R)
  float* c_s = h_s + L * HR;  // L x (TR * TJ, nthr): the same H * R floats
  float* x_s = c_s + L * HR;  // (D, R) layer-0 input x_t
  const long long row0 = (long long)blockIdx.x * R;

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

  for (int t = 0; t < T; ++t) {
    for (int i = tid; i < R * D; i += nthr) {
      const int r = i / D, d = i % D;
      const long long row = row0 + r;
      x_s[d * R + r] = row < B ? xs[(row * T + t) * D + d] : 0.0f;
    }
    __syncthreads();
    for (int l = 0; l < L; ++l)
      fwd_layer_step<RT>(
          l == 0 ? x_s : h_s + (l - 1) * HR, l == 0 ? D : H, h_s + l * HR,
          c_s + l * HR, a.w[l], a.b[l], static_cast<RT*>(a.hs[l]),
          static_cast<RT*>(a.cs[l]), static_cast<RT*>(a.gs[l]), row0, B, T, t,
          H, R, r0, j0, tid, nthr);
  }
}

// ---------------------------------------------------------------------------
// backward recurrence
// ---------------------------------------------------------------------------

struct BwdArgs {
  const float* w[MAX_LAYERS];   // (in_l + H, 4H): layer 0's rows :D give dxs
  const float* wt[MAX_LAYERS];  // l == 0: W[D:]ᵀ (4H, H); l > 0:
                                // [W[H:]; W[:H]]ᵀ (4H, 2H), dh part first
  const void* cs[MAX_LAYERS];   // (B, T, H) residual type
  const void* gs[MAX_LAYERS];   // (B, T, 4H)
  float* dg[MAX_LAYERS];        // (B, T, 4H) dgates out
};

template <typename RT>
__global__ void __launch_bounds__(256)
    lstm_bwd_kernel(const float* __restrict__ dhs_top,
                    const float* __restrict__ dhT,
                    const float* __restrict__ dcT,
                    const float* __restrict__ c0, const BwdArgs a,
                    float* __restrict__ dxs, float* __restrict__ dh0,
                    float* __restrict__ dc0, int B, int T, int D, int H,
                    int L, int R) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int j0 = (tid % (H / TJ)) * TJ;
  const int r0 = (tid / (H / TJ)) * TR;
  const int HR = H * R, G = 4 * H;
  float* dg_s = smem;            // (4H, R) dgates of this layer-step
  float* dh_s = dg_s + G * R;    // L x owner-private (TR * TJ, nthr)
  float* dc_s = dh_s + L * HR;   // L x owner-private
  const long long row0 = (long long)blockIdx.x * R;

  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const long long row = row0 + r0 + r;
      float vh[TJ] = {0.0f, 0.0f, 0.0f, 0.0f}, vc[TJ] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (row < B) {
        F::ld4(dhT + ((size_t)l * B + row) * H + j0, vh);
        F::ld4(dcT + ((size_t)l * B + row) * H + j0, vc);
      }
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        dh_s[l * HR + (r * TJ + j) * nthr + tid] = vh[j];
        dc_s[l * HR + (r * TJ + j) * nthr + tid] = vc[j];
      }
    }

  for (int t = T - 1; t >= 0; --t) {
    float above[TR][TJ];  // gradient arriving at this layer's h from above
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const long long row = row0 + r0 + r;
      float v[TJ] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (row < B) F::ld4(dhs_top + ((size_t)row * T + t) * H + j0, v);
#pragma unroll
      for (int j = 0; j < TJ; ++j) above[r][j] = v[j];
    }
    for (int l = L - 1; l >= 0; --l) {
      const RT* gs = static_cast<const RT*>(a.gs[l]);
      const RT* cs = static_cast<const RT*>(a.cs[l]);
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
          const int idx = l * HR + (r * TJ + j) * nthr + tid;
          const float i_g = gv[0][j], f_g = gv[1][j], g_g = gv[2][j], o_g = gv[3][j];
          const float dh_total = above[r][j] + dh_s[idx];
          const float tanh_c = tanhf(ct[j]);
          const float dc_total = dh_total * o_g * (1.0f - tanh_c * tanh_c) + dc_s[idx];
          dgv[0][r][j] = dc_total * g_g * i_g * (1.0f - i_g);
          dgv[1][r][j] = dc_total * cp[j] * f_g * (1.0f - f_g);
          dgv[2][r][j] = dc_total * i_g * (1.0f - g_g * g_g);
          dgv[3][r][j] = dh_total * tanh_c * o_g * (1.0f - o_g);
          dc_s[idx] = dc_total * f_g;
        }
        if (row < B) {
          const size_t q = (size_t)row * T + t;
#pragma unroll
          for (int g = 0; g < 4; ++g) F::st4(a.dg[l] + q * G + g * H + j0, dgv[g][r]);
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < TJ; ++j) st_rows(dg_s, g * H + j0 + j, R, r0, dgv[g], j);
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
        // dxs[row, t, d] = sum_k dgates[k][row] * W[d][k] (W's first D rows):
        // a thread per (row, d), four partial sums
        for (int i = tid; i < R * D; i += nthr) {
          const int r = i % R, d = i / R;
          const long long row = row0 + r;
          if (row >= B) continue;
          const float* wd = a.w[0] + (size_t)d * G;
          float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
          for (int k = 0; k < G; k += 4) {
            s0 = fmaf(dg_s[k * R + r], __ldg(wd + k), s0);
            s1 = fmaf(dg_s[(k + 1) * R + r], __ldg(wd + k + 1), s1);
            s2 = fmaf(dg_s[(k + 2) * R + r], __ldg(wd + k + 2), s2);
            s3 = fmaf(dg_s[(k + 3) * R + r], __ldg(wd + k + 3), s3);
          }
          dxs[(row * T + t) * D + d] = (s0 + s1) + (s2 + s3);
        }
      }
      __syncthreads();  // dg_s is read by everyone before it is overwritten
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
// dW / db reduction
// ---------------------------------------------------------------------------

struct DwArgs {
  const float* xs;     // (B, T, D): z's input part for layer 0
  const float* h0;     // (B, H) this layer's initial h
  const void* hs;      // (B, T, H) this layer's residual h
  const void* cs_in;   // (B, T, H) the layer below's c; null for layer 0
  const void* gs_in;   // (B, T, 4H) the layer below's gates; null for layer 0
  const float* dg;     // (B, T, 4H) this layer's dgates
};

// The reduction orders z's features h first: feature f < H is h_{t-1}[f],
// H <= f < H + in is input_t[f - H], so the h part is whole float4 runs at
// any input width; feature H + in is the constant 1, whose row of the
// product is db. Output row of feature f: f < H ? in + f : f - H (db is
// row in + H, after dW).
//
// z[q][f .. f + 3] of row q = b * T + t (zero past the features)
template <typename RT>
__device__ __forceinline__ void z_quad(const DwArgs& a, int q, int f, int T,
                                       int D, int H, int in, float (&v)[4]) {
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
template <typename RT>
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
      if (f0 + c <= M) z_quad<RT>(a, q, f0 + c, T, D, H, in, za[i]);           \
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

// dw[i] (i < M*N) and db[i - M*N] = sum over s, in order, of partial[s][i]
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

// ---------------------------------------------------------------------------
// C interface: each function launches on `stream` and returns
// cudaGetLastError() (0 = ok).
// ---------------------------------------------------------------------------

static bool bad_shape(int batch, int t_len, int d, int hidden, int layers,
                      int rows) {
  return layers < 1 || layers > MAX_LAYERS || hidden < 32 || hidden % 32 ||
         rows < TR || rows % TR || batch < 1 || t_len < 1 || d < 1 ||
         (rows / TR) * (hidden / TJ) > 256;
}

extern "C" {

// rows: batch rows per block, a multiple of 4. The block has
// (rows / 4) * (hidden / 4) threads and (2 * layers * hidden + d) * rows
// floats of dynamic shared memory.
int lstm_fwd(const void* xs, const void* h0, const void* c0,
             const void* const* w, const void* const* b, void* const* hs,
             void* const* cs, void* const* gs, int batch, int t_len, int d,
             int hidden, int layers, int rows, int bf16, void* stream) {
  if (bad_shape(batch, t_len, d, hidden, layers, rows))
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    const bool on = l < layers;
    a.w[l] = on ? static_cast<const float*>(w[l]) : nullptr;
    a.b[l] = on ? static_cast<const float*>(b[l]) : nullptr;
    a.hs[l] = on ? hs[l] : nullptr;
    a.cs[l] = on ? cs[l] : nullptr;
    a.gs[l] = on ? gs[l] : nullptr;
  }
  const size_t smem = ((size_t)2 * layers * hidden + d) * rows * sizeof(float);
  const int threads = (rows / TR) * (hidden / TJ);
  const int grid = (batch + rows - 1) / rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *x = static_cast<const float*>(xs), *hh = static_cast<const float*>(h0),
              *cc = static_cast<const float*>(c0);
#define LAUNCH_FWD(RTV)                                                        \
  {                                                                            \
    cudaError_t e = cudaFuncSetAttribute(                                      \
        lstm_fwd_kernel<RTV>, cudaFuncAttributeMaxDynamicSharedMemorySize,     \
        (int)smem);                                                            \
    if (e != cudaSuccess) return (int)e;                                       \
    lstm_fwd_kernel<RTV><<<grid, threads, smem, st>>>(                         \
        x, hh, cc, a, batch, t_len, d, hidden, layers, rows);                  \
  }
  if (bf16)
    LAUNCH_FWD(__nv_bfloat16)
  else
    LAUNCH_FWD(float)
#undef LAUNCH_FWD
  return (int)cudaGetLastError();
}

// Same block shape as lstm_fwd, with (4 * hidden + 2 * layers * hidden) * rows
// floats of dynamic shared memory.
int lstm_bwd(const void* dhs_top, const void* dhT, const void* dcT,
             const void* c0, const void* const* w, const void* const* wt,
             const void* const* cs, const void* const* gs, void* const* dg,
             void* dxs, void* dh0, void* dc0, int batch, int t_len, int d,
             int hidden, int layers, int rows, int bf16, void* stream) {
  if (bad_shape(batch, t_len, d, hidden, layers, rows))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    const bool on = l < layers;
    a.w[l] = on ? static_cast<const float*>(w[l]) : nullptr;
    a.wt[l] = on ? static_cast<const float*>(wt[l]) : nullptr;
    a.cs[l] = on ? cs[l] : nullptr;
    a.gs[l] = on ? gs[l] : nullptr;
    a.dg[l] = on ? static_cast<float*>(dg[l]) : nullptr;
  }
  const size_t smem =
      ((size_t)4 * hidden + (size_t)2 * layers * hidden) * rows * sizeof(float);
  const int threads = (rows / TR) * (hidden / TJ);
  const int grid = (batch + rows - 1) / rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *up = static_cast<const float*>(dhs_top),
              *dh = static_cast<const float*>(dhT),
              *dc = static_cast<const float*>(dcT),
              *cc = static_cast<const float*>(c0);
  float *dx = static_cast<float*>(dxs), *oh = static_cast<float*>(dh0),
        *oc = static_cast<float*>(dc0);
#define LAUNCH_BWD(RTV)                                                        \
  {                                                                            \
    cudaError_t e = cudaFuncSetAttribute(                                      \
        lstm_bwd_kernel<RTV>, cudaFuncAttributeMaxDynamicSharedMemorySize,     \
        (int)smem);                                                            \
    if (e != cudaSuccess) return (int)e;                                       \
    lstm_bwd_kernel<RTV><<<grid, threads, smem, st>>>(                         \
        up, dh, dc, cc, a, dx, oh, oc, batch, t_len, d, hidden, layers, rows); \
  }
  if (bf16)
    LAUNCH_BWD(__nv_bfloat16)
  else
    LAUNCH_BWD(float)
#undef LAUNCH_BWD
  return (int)cudaGetLastError();
}

// Per layer: the partial sums over `splits` slices of the B·T rows, then
// their sum. `partial` holds splits x (max_l(in_l + H) + 1) x 4H floats and
// is reused layer after layer (the launches are ordered on the stream).
int lstm_dw(const void* xs, const void* h0, const void* const* hs,
            const void* const* cs, const void* const* gs,
            const void* const* dg, void* partial, void* const* dw,
            void* const* db, int batch, int t_len, int d, int hidden,
            int layers, int splits, int bf16, void* stream) {
  if (layers < 1 || layers > MAX_LAYERS || hidden < 32 || hidden % 32 ||
      batch < 1 || t_len < 1 || d < 1 || splits < 1 ||
      (long long)batch * t_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Q = batch * t_len, N = 4 * hidden;
  int chunk = (Q + splits - 1) / splits;
  chunk = (chunk + DW_K - 1) / DW_K * DW_K;
  float* part = static_cast<float*>(partial);
  for (int l = 0; l < layers; ++l) {
    DwArgs a;
    a.xs = static_cast<const float*>(xs);
    a.h0 = static_cast<const float*>(h0) + (size_t)l * batch * hidden;
    a.hs = hs[l];
    a.cs_in = l > 0 ? cs[l - 1] : nullptr;
    a.gs_in = l > 0 ? gs[l - 1] : nullptr;
    a.dg = static_cast<const float*>(dg[l]);
    const int in = l == 0 ? d : hidden, M = in + hidden;
    const dim3 grid(N / DW_T, (M + 1 + DW_T - 1) / DW_T, splits);
    if (bf16)
      lstm_dw_partial_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
          a, part, batch, t_len, d, hidden, in, chunk);
    else
      lstm_dw_partial_kernel<float><<<grid, 256, 0, st>>>(
          a, part, batch, t_len, d, hidden, in, chunk);
    const int total = (M + 1) * N;
    lstm_dw_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(
        part, splits, M * N, N, static_cast<float*>(dw[l]),
        static_cast<float*>(db[l]));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

const char* lstm_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
