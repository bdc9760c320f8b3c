// Scheduled-sampling LSTM decoder for training, forward and backward, for
// Hopper (sm_90a), exact f32 compute, residuals in f32 or bf16.
//
// Replaces the TPU Pallas kernels of
//   longterm360fov_tpu/ops/lstm_ss.py::ss_decode
// (_fwd_kernel and _bwd_kernel under a jax.custom_vjp) with four kernels:
//   * ss_fwd_kernel: T decoder steps from (h0, c0) (L, B, H) and y0 (B, D).
//     Step t feeds layer 0 [x_t, ctx] with x_t = coin_t > 0 ? teacher_t :
//     y_{t-1} (y_{-1} = y0), runs L stacked cells and projects
//     y_t = h_top · proj_w + proj_b from the f32 h, which is fed back. It
//     writes ys (B, T, D) f32 and, per layer, h, c (B, T, H) and the gates
//     i, f, g, o (B, T, 4H) in the residual type.
//   * ss_bwd_kernel: the backward recurrence in reverse time. The total
//     gradient of y_t is the upstream dys_t plus the feedback from step t+1;
//     the top layer's h gets dy_t · proj_wᵀ plus the carried dh; each
//     layer's cell backward is lstm_train.cu's; layer 0's input gradient
//     [dx, dctx] = dgates · W0[:D+C]ᵀ splits into dteacher_t = dx · coin_t,
//     the feedback dx · (1 - coin_t) to y_{t-1} (dy0 at t = 0) and dctx,
//     which the block that owns the row sums over t. It writes dgates per
//     layer, dy (B, T, D) (the total gradient of every y_t), dteacher
//     (T, B, D), dy0, dh0, dc0 and dctx. Coins get no gradient.
//   * the dW/db reduction of lstm_common.cuh, whose layer-0 z is
//     [x_t, ctx, h_{t-1}] with x_t rebuilt from coin, teacher and the f32
//     ys (y0 at t = 0), as the TPU backward rebuilds it; layer l > 0 reads
//     o·tanh(c) of the layer below from the residuals;
//   * ss_dproj_partial_kernel + lstm_dw_sum_kernel: dproj_w = Σ h_topᵀ·dy and
//     dproj_b = Σ dy over the B·T rows, h_top read from the residuals.
// The TPU kernel summed dW, db, dproj and dctx in VMEM across its ordered
// grid. Blocks here run in parallel, so every sum across rows is split into
// slices whose partial sums a second pass adds in a fixed order: no float
// atomics, two runs give the same bits. dctx is per row: no cross-block sum.
//
// What bounds it on the card, at stacked-ss-crossuser's training shapes
// (B = 4096, T = 30, D = 3, C = 128, H = 128, L = 2):
//   * Arithmetic. A pass is 2·B·T·((D + C + H) + 2H)·4H = 64.8 GFLOP (the
//     forward's gate products; the backward's dgates · Wᵀ; the dW
//     reduction), exact f32 on the FMA units (67 TFLOP/s): at least 0.97 ms
//     each. The projection and its gradient are 2·B·T·H·D, under 1 %.
//   * Bytes. bf16 residuals are 6H·2 bytes per layer and row-step: 377 MB a
//     pass, and dgates (4H f32) 503 MB, 0.1-0.3 ms at 3.35 TB/s: under the
//     FMA time.
//   * The serial chain. Step t - 1 of the backward cannot start before layer
//     0 of step t has produced dx, so the feedback runs through every layer
//     of every step, and the dy · proj_wᵀ term sits on that path.
// What the design does about it: lstm_train.cu's tiles (a thread owns 4 rows
// x 4 hidden units, a block 16 rows: 256 blocks of 128 threads at
// B = 4096, two per SM), every carry on chip (h, c, dh, dc, the feedback y
// and dy, dctx in shared memory), W streamed from L2 with 16-byte loads; the
// feedback and projection are D = 3 wide and ride in the same block.

#include "lstm_common.cuh"

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct SsFwdArgs {
  const float* w[MAX_LAYERS];  // (in_l + H, 4H); layer 0's input is D + C
  const float* b[MAX_LAYERS];  // (4H,)
  void* hs[MAX_LAYERS];        // (B, T, H) residual type
  void* cs[MAX_LAYERS];        // (B, T, H)
  void* gs[MAX_LAYERS];        // (B, T, 4H)
  const float* proj_w;         // (H, D)
  const float* proj_b;         // (D,)
};

template <typename RT>
__global__ void __launch_bounds__(256)
    ss_fwd_kernel(const float* __restrict__ h0, const float* __restrict__ c0,
                  const float* __restrict__ y0,
                  const float* __restrict__ teacher,
                  const float* __restrict__ coins,
                  const float* __restrict__ ctx, const SsFwdArgs a,
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
  for (int i = tid; i < R * C; i += nthr) {  // the static context, once
    const int r = i / C, c = i % C;
    const long long row = row0 + r;
    x_s[(D + c) * R + r] = row < B ? ctx[row * C + c] : 0.0f;
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
    __syncthreads();
    for (int l = 0; l < L; ++l)
      fwd_layer_step<RT>(
          l == 0 ? x_s : h_s + (l - 1) * HR, l == 0 ? D + C : H, h_s + l * HR,
          c_s + l * HR, a.w[l], a.b[l], static_cast<RT*>(a.hs[l]),
          static_cast<RT*>(a.cs[l]), static_cast<RT*>(a.gs[l]), row0, B, T, t,
          H, R, r0, j0, tid, nthr);
    // y_t = h_top @ proj_w + proj_b from the f32 h: written out and fed back
    for (int i = tid; i < R * D; i += nthr) {
      const int r = i / D, d = i % D;
      float y = 0.0f;
      for (int k = 0; k < H; ++k)
        y = fmaf(h_top[k * R + r], __ldg(a.proj_w + k * D + d), y);
      y += __ldg(a.proj_b + d);
      y_s[d * R + r] = y;
      const long long row = row0 + r;
      if (row < B) ys[((size_t)row * T + t) * D + d] = y;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// backward recurrence
// ---------------------------------------------------------------------------

struct SsBwdArgs {
  const float* w0;              // layer 0's W (D + C + H, 4H): rows :D give dx
  const float* wt[MAX_LAYERS];  // l == 0: W[D+C:]ᵀ (4H, H); l > 0:
                                // [W[H:]; W[:H]]ᵀ (4H, 2H), dh part first
  const float* wtc;             // layer 0's W[D:D+C]ᵀ (4H, C); null if C == 0
  const void* cs[MAX_LAYERS];   // (B, T, H) residual type
  const void* gs[MAX_LAYERS];   // (B, T, 4H)
  float* dg[MAX_LAYERS];        // (B, T, 4H) dgates out
  const float* proj_w;          // (H, D)
};

template <typename RT>
__global__ void __launch_bounds__(256)
    ss_bwd_kernel(const float* __restrict__ dys, const float* __restrict__ c0,
                  const float* __restrict__ coins, const SsBwdArgs a,
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
          s = fmaf(dy_s[d * R + r0 + r], __ldg(a.proj_w + (size_t)(j0 + j) * D + d), s);
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
        // dctx += dgates · W[D:D+C]ᵀ: the thread owns units c .. c + 3
        for (int c = j0; c < C; c += H) {
          float cacc[1][TR][TJ];
          zero(cacc);
          accumulate<1>(cacc, dg_s, G, a.wtc, C, 0, R, r0, c);
#pragma unroll
          for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int j = 0; j < TJ; ++j) dctx_s[(c + j) * R + r0 + r] += cacc[0][r][j];
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
  for (int i = tid; i < R * C; i += nthr) {
    const int r = i / C, c = i % C;
    const long long row = row0 + r;
    if (row < B) dctx[row * C + c] = dctx_s[c * R + r];
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
// dproj reduction
// ---------------------------------------------------------------------------

// Block s sums the rows q of its slice in `groups` interleaved row groups of
// H + 32 threads: thread j < H of a group holds dproj_w[j][:D] += h_top[q][j]
// · dy[q][:D], lane j - H < D of its last warp dproj_b[j - H] += dy[q][j - H].
// The groups are added in order through shared memory into
// partial[s] = (dproj_w (H, D) row-major, dproj_b (D,)).
template <typename RT>
__global__ void __launch_bounds__(1024)
    ss_dproj_partial_kernel(const RT* __restrict__ hs_top,
                            const float* __restrict__ dy,
                            float* __restrict__ partial, int Q, int D, int H,
                            int chunk, int groups) {
  extern __shared__ float red[];  // (groups, (H + 1) * D)
  const int width = H + 32, out = (H + 1) * D;
  const int g = threadIdx.x / width, j = threadIdx.x % width;
  const int q_begin = blockIdx.x * chunk;
  const int q_end = min(q_begin + chunk, Q);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (j < H) {
#pragma unroll 4
    for (int q = q_begin + g; q < q_end; q += groups) {
      const float h = Res<RT>::ld(hs_top + (size_t)q * H + j);
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (d < D) acc[d] = fmaf(h, dy[(size_t)q * D + d], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < 4; ++d)
      if (d < D) red[g * out + j * D + d] = acc[d];
  } else if (j - H < D) {
    for (int q = q_begin + g; q < q_end; q += groups) acc[0] += dy[(size_t)q * D + j - H];
    red[g * out + H * D + j - H] = acc[0];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < out; i += blockDim.x) {
    float s = red[i];
    for (int k = 1; k < groups; ++k) s += red[k * out + i];
    partial[(size_t)blockIdx.x * out + i] = s;
  }
}

// ---------------------------------------------------------------------------
// C interface: each function launches on `stream` and returns
// cudaGetLastError() (0 = ok).
// ---------------------------------------------------------------------------

static bool bad_shape(int batch, int t_len, int d, int ctx_dim, int hidden,
                      int layers, int rows) {
  return layers < 1 || layers > MAX_LAYERS || hidden < 32 || hidden % 32 ||
         rows < TR || rows % TR || batch < 1 || t_len < 1 || d < 1 ||
         ctx_dim < 0 || ctx_dim % 4 || (rows / TR) * (hidden / TJ) > 256;
}

#define SET_SMEM_AND_LAUNCH(KERNEL, ...)                                      \
  {                                                                           \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);      \
    if (e != cudaSuccess) return (int)e;                                      \
    KERNEL<<<grid, threads, smem, st>>>(__VA_ARGS__);                         \
  }

extern "C" {

// rows: batch rows per block, a multiple of 4. The block has
// (rows / 4) * (hidden / 4) threads and (2 * layers * hidden + 2 * d +
// ctx_dim) * rows floats of dynamic shared memory. ctx is null when
// ctx_dim == 0; coins (t_len, batch), teacher (t_len, batch, d).
int ss_fwd(const void* h0, const void* c0, const void* y0, const void* teacher,
           const void* coins, const void* ctx, const void* const* w,
           const void* const* b, const void* proj_w, const void* proj_b,
           void* const* hs, void* const* cs, void* const* gs, void* ys,
           int batch, int t_len, int d, int ctx_dim, int hidden, int layers,
           int rows, int bf16, void* stream) {
  if (bad_shape(batch, t_len, d, ctx_dim, hidden, layers, rows))
    return (int)cudaErrorInvalidValue;
  SsFwdArgs a;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    const bool on = l < layers;
    a.w[l] = on ? static_cast<const float*>(w[l]) : nullptr;
    a.b[l] = on ? static_cast<const float*>(b[l]) : nullptr;
    a.hs[l] = on ? hs[l] : nullptr;
    a.cs[l] = on ? cs[l] : nullptr;
    a.gs[l] = on ? gs[l] : nullptr;
  }
  a.proj_w = static_cast<const float*>(proj_w);
  a.proj_b = static_cast<const float*>(proj_b);
  const size_t smem =
      ((size_t)2 * layers * hidden + 2 * d + ctx_dim) * rows * sizeof(float);
  const int threads = (rows / TR) * (hidden / TJ);
  const int grid = (batch + rows - 1) / rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *hh = static_cast<const float*>(h0), *cc = static_cast<const float*>(c0),
              *yy = static_cast<const float*>(y0),
              *te = static_cast<const float*>(teacher),
              *co = static_cast<const float*>(coins),
              *cx = static_cast<const float*>(ctx);
  float* out = static_cast<float*>(ys);
  if (bf16)
    SET_SMEM_AND_LAUNCH(ss_fwd_kernel<__nv_bfloat16>, hh, cc, yy, te, co, cx, a,
                        out, batch, t_len, d, ctx_dim, hidden, layers, rows)
  else
    SET_SMEM_AND_LAUNCH(ss_fwd_kernel<float>, hh, cc, yy, te, co, cx, a, out,
                        batch, t_len, d, ctx_dim, hidden, layers, rows)
  return (int)cudaGetLastError();
}

// Same block shape as ss_fwd, with (4 * hidden + 2 * layers * hidden +
// ctx_dim + 2 * d) * rows floats of dynamic shared memory. w0 is layer 0's
// W; wt its transposed blocks (see SsBwdArgs); wtc null when ctx_dim == 0.
int ss_bwd(const void* dys, const void* c0, const void* coins, const void* w0,
           const void* const* wt, const void* wtc, const void* proj_w,
           const void* const* cs, const void* const* gs, void* const* dg,
           void* dy, void* dteacher, void* dy0, void* dh0, void* dc0,
           void* dctx, int batch, int t_len, int d, int ctx_dim, int hidden,
           int layers, int rows, int bf16, void* stream) {
  if (bad_shape(batch, t_len, d, ctx_dim, hidden, layers, rows))
    return (int)cudaErrorInvalidValue;
  SsBwdArgs a;
  a.w0 = static_cast<const float*>(w0);
  a.wtc = static_cast<const float*>(wtc);
  a.proj_w = static_cast<const float*>(proj_w);
  for (int l = 0; l < MAX_LAYERS; ++l) {
    const bool on = l < layers;
    a.wt[l] = on ? static_cast<const float*>(wt[l]) : nullptr;
    a.cs[l] = on ? cs[l] : nullptr;
    a.gs[l] = on ? gs[l] : nullptr;
    a.dg[l] = on ? static_cast<float*>(dg[l]) : nullptr;
  }
  const size_t smem = ((size_t)4 * hidden + (size_t)2 * layers * hidden +
                       ctx_dim + 2 * d) * rows * sizeof(float);
  const int threads = (rows / TR) * (hidden / TJ);
  const int grid = (batch + rows - 1) / rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *up = static_cast<const float*>(dys), *cc = static_cast<const float*>(c0),
              *co = static_cast<const float*>(coins);
  float *o_dy = static_cast<float*>(dy), *o_dt = static_cast<float*>(dteacher),
        *o_dy0 = static_cast<float*>(dy0), *o_dh = static_cast<float*>(dh0),
        *o_dc = static_cast<float*>(dc0), *o_dx = static_cast<float*>(dctx);
  if (bf16)
    SET_SMEM_AND_LAUNCH(ss_bwd_kernel<__nv_bfloat16>, up, cc, co, a, o_dy, o_dt,
                        o_dy0, o_dh, o_dc, o_dx, batch, t_len, d, ctx_dim,
                        hidden, layers, rows)
  else
    SET_SMEM_AND_LAUNCH(ss_bwd_kernel<float>, up, cc, co, a, o_dy, o_dt, o_dy0,
                        o_dh, o_dc, o_dx, batch, t_len, d, ctx_dim, hidden,
                        layers, rows)
  return (int)cudaGetLastError();
}

// dW/db per layer (lstm_common.cuh's reduction; layer 0's input rebuilt from
// coins, teacher, ys, y0 and ctx). `partial` holds splits x
// (max_l(in_l + H) + 1) x 4H floats, reused layer after layer.
int ss_dw(const void* h0, const void* y0, const void* teacher,
          const void* coins, const void* ctx, const void* ys,
          const void* const* hs, const void* const* cs, const void* const* gs,
          const void* const* dg, void* partial, void* const* dw,
          void* const* db, int batch, int t_len, int d, int ctx_dim,
          int hidden, int layers, int splits, int bf16, void* stream) {
  if (layers < 1 || layers > MAX_LAYERS || hidden < 32 || hidden % 32 ||
      batch < 1 || t_len < 1 || d < 1 || ctx_dim < 0 || splits < 1 ||
      (long long)batch * t_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < layers; ++l) {
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
    }
    const cudaError_t e = dw_layer(
        a, static_cast<float*>(partial), static_cast<float*>(dw[l]),
        static_cast<float*>(db[l]), batch, t_len, d, hidden,
        l == 0 ? d + ctx_dim : hidden, splits, bf16 != 0, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// dproj_w (hidden, d) and dproj_b (d,) over the batch·t_len rows of hs_top
// (residual type) and dy (f32), d <= 4. `partial` holds splits x
// (hidden + 1) x d floats.
int ss_dproj(const void* hs_top, const void* dy, void* partial, void* dproj_w,
             void* dproj_b, int batch, int t_len, int d, int hidden,
             int splits, int bf16, void* stream) {
  if (batch < 1 || t_len < 1 || d < 1 || d > 4 || hidden < 1 ||
      hidden + 32 > 1024 || splits < 1 ||
      (long long)batch * t_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Q = batch * t_len;
  const int groups = min(4, 1024 / (hidden + 32));
  const int threads = groups * (hidden + 32);
  const size_t smem = (size_t)groups * (hidden + 1) * d * sizeof(float);
  const int chunk = (Q + splits - 1) / splits;
  float* part = static_cast<float*>(partial);
  const float* g = static_cast<const float*>(dy);
  if (bf16)
    ss_dproj_partial_kernel<__nv_bfloat16><<<splits, threads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(hs_top), g, part, Q, d, hidden,
        chunk, groups);
  else
    ss_dproj_partial_kernel<float><<<splits, threads, smem, st>>>(
        static_cast<const float*>(hs_top), g, part, Q, d, hidden, chunk,
        groups);
  const int total = (hidden + 1) * d;
  lstm_dw_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      part, splits, hidden * d, d, static_cast<float*>(dproj_w),
      static_cast<float*>(dproj_b));
  return (int)cudaGetLastError();
}

const char* lstm_ss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
