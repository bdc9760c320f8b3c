// Scheduled-sampling LSTM decoder for training, forward and backward, for
// Hopper (sm_90a), f32 or bf16 compute, residuals in f32 or bf16.
//
// Replaces the TPU Pallas kernels of
//   longterm360fov_tpu/ops/lstm_ss.py::ss_decode
// (_fwd_kernel and _bwd_kernel under a jax.custom_vjp) with four kernels.
// The two recurrences live in lstm_common.cuh, whose per-step-context
// instances lstm_align.cu launches; this file launches the static-context
// ones (STEP_CTX = false):
//   * train_fwd_kernel (the scheduled-sampling modes): T decoder steps from
//     (h0, c0) (L, B, H) and y0 (B, D), on the tensor cores. Step t feeds
//     layer 0 [x_t, ctx] with x_t = coin_t > 0 ? teacher_t : y_{t-1}
//     (y_{-1} = y0), runs L stacked cells and projects y_t = h_top · proj_w
//     + proj_b from h_top as the tier rounds it, which is fed back. It writes
//     ys (B, T, D) f32 and, per layer, h, c (B, T, H) and the gates i, f, g,
//     o (B, T, 4H) in the residual type.
//   * ss_bwd_kernel: the backward recurrence in reverse time, on the tensor
//     cores (lstm_common.cuh's header says how). The total gradient of y_t
//     is the upstream dys_t plus the feedback from step t+1; the top layer's
//     h gets dy_t · proj_wᵀ plus the carried dh; layer 0's input gradient
//     [dx, dctx] = dgates · W0[:D+C]ᵀ splits into dteacher_t = dx · coin_t,
//     the feedback dx · (1 - coin_t) to y_{t-1} (dy0 at t = 0) and dctx,
//     which the warp that owns the columns sums over t. It writes dgates
//     per layer, dy (B, T, D) (the total gradient of every y_t), dteacher
//     (T, B, D), dy0, dh0, dc0 and dctx. Coins get no gradient.
//   * the dW/db reduction of lstm_common.cuh, whose layer-0 z is
//     [x_t, ctx, h_{t-1}] with x_t rebuilt from coin, teacher and the f32
//     ys (y0 at t = 0), as the TPU backward rebuilds it; layer l > 0 reads
//     o·tanh(c) of the layer below from the residuals;
//   * ss_dproj_partial_kernel + ss_dproj_sum_kernel: dproj_w = Σ h_topᵀ·dy
//     and dproj_b = Σ dy over the B·T rows, h_top read from the residuals.
// The bf16 compute type rounds both operands of every product to bf16 and
// sums in f32, as lstm_train.cu's does, here also in the projection
// y = h_top·proj_w (ys and the fed-back y stay f32), dy·proj_wᵀ, the
// layer-0 dW loader's rebuilt [x_t, ctx] and dproj_w = Σ h_topᵀ·dy; dproj_b
// sums the unrounded dy.
// The TPU kernel summed dW, db, dproj and dctx in VMEM across its ordered
// grid. Blocks here run in parallel, so every sum across rows is split into
// slices whose partial sums a second pass adds in a fixed order: no float
// atomics, two runs give the same bits. dctx is per row: no cross-block sum.
//
// What bounds it on the card, at stacked-ss-crossuser's training shapes
// (B = 4096, T = 30, D = 3, C = 128, H = 128, L = 2):
//   * Arithmetic. A pass is 2·B·T·((D + C + H) + 2H)·4H = 64.8 GFLOP (the
//     forward's gate products; the backward's dgates · Wᵀ; the dW
//     reduction): 0.39 ms in three-pass TF32 at 495 / 3 TFLOP/s (the
//     recurrences), 0.97 ms on the FMA units (the f32 dW). The projection
//     and its gradient are 2·B·T·H·D, under 1 %.
//   * Bytes. bf16 residuals are 6H·2 bytes per layer and row-step: 377 MB a
//     pass, and dgates (4H f32) 503 MB, 0.1-0.3 ms at 3.35 TB/s.
//   * The serial chain. Step t - 1 of the backward cannot start before layer
//     0 of step t has produced dx, so the feedback runs through every layer
//     of every step, and the dy · proj_wᵀ term sits on that path.
// What the design does about it: the forward is lstm_train.cu's (the serve
// kernel's decoder body, lstm_common.cuh train_fwd_kernel): every carry on
// chip, the static context written into z once, the feedback and the
// projection (D = 3 wide) in the same block on the FMA units, W streamed
// from L2. The backward is lstm_common.cuh's tensor-core body (32-row blocks
// of 16 warps, carries in shared memory, W packed once a call and streamed
// through each warp's ring).

#include "lstm_common.cuh"

// ---------------------------------------------------------------------------
// dproj reduction
// ---------------------------------------------------------------------------

#define DPROJ_THREADS 256
#define DPROJ_TILE 256  // dy rows staged in shared memory at a time
#define DPROJ_AHEAD 4   // h rows a thread has in flight

// 16 bytes of residual values, widened: 4 f32 or 8 bf16
__device__ __forceinline__ void ld16(const float* p, float (&v)[4]) { F::ld4(p, v); }
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Replaces the dproj part of lstm_ss.py::_bwd_kernel. What bounds it: bytes,
// h_top read once (B·T·H in the residual type: 31.5 MB in bf16 at the
// training shapes) and dy (1.5 MB): 9.8 µs at 3.35 TB/s. The FMA design
// read 2 bytes a thread a row (33-38 µs on the card); this one reads 16.
// Block s sums the rows q of its slice [s·chunk, (s + 1)·chunk) (chunk a
// multiple of 4). A row's h_top is H / UV threads of UV = 16 / sizeof(RT)
// units, one 16-byte load each; the block's 256 / (H / UV) row groups
// (rounded down: the threads past the last group only stage dy) take the
// slice's rows in turn, DPROJ_AHEAD rows in flight a thread. The slice's
// dy, contiguous, is staged DPROJ_TILE rows at a time in shared memory by
// 16-byte loads (a row is read there as a broadcast). Thread j of group r:
// dproj_w[j·UV + u][d] += h_top[q][j·UV + u] · dy[q][d], both rounded to CT;
// its group's first thread also dproj_b[d] += dy[q][d], unrounded. The groups
// are added in order through shared memory into partial[s] = (dproj_w (H, D)
// row-major, dproj_b (D,)). 80 registers (f32 h) or 101 (bf16), no spills;
// 4 KB of dy and groups x (H + 1)·D floats of shared memory.
template <typename RT, typename CT>
__global__ void __launch_bounds__(DPROJ_THREADS)
    ss_dproj_partial_kernel(const RT* __restrict__ hs_top, const float* __restrict__ dy,
                            float* __restrict__ partial, int Q, int D, int H, int chunk) {
  constexpr int UV = 16 / sizeof(RT);
  __shared__ __align__(16) float dys[DPROJ_TILE * 4];
  extern __shared__ float red[];  // (groups, (H + 1) · D)
  const int tpr = H / UV, groups = DPROJ_THREADS / tpr, out = (H + 1) * D;
  const int gr = threadIdx.x / tpr, j = threadIdx.x % tpr;
  const int q_begin = min(blockIdx.x * chunk, Q), q_end = min(q_begin + chunk, Q);
  float acc[UV][4] = {}, db[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int base = q_begin; base < q_end; base += DPROJ_TILE) {
    const int n = min(DPROJ_TILE, q_end - base), nf = n * D;
    __syncthreads();  // the last tile's reads are done
    const float* src = dy + (size_t)base * D;  // 16-byte aligned: base·D is a multiple of 4
    for (int i = threadIdx.x; i < nf / 4; i += DPROJ_THREADS)
      reinterpret_cast<float4*>(dys)[i] = reinterpret_cast<const float4*>(src)[i];
    for (int i = nf / 4 * 4 + threadIdx.x; i < nf; i += DPROJ_THREADS) dys[i] = src[i];
    __syncthreads();
    for (int r0 = gr; gr < groups && r0 < n; r0 += DPROJ_AHEAD * groups) {
      float h[DPROJ_AHEAD][UV];
#pragma unroll
      for (int a = 0; a < DPROJ_AHEAD; ++a) {
        const int r = r0 + a * groups;
        if (r < n) {
          ld16(hs_top + (size_t)(base + r) * H + j * UV, h[a]);
        } else {
#pragma unroll
          for (int u = 0; u < UV; ++u) h[a][u] = 0.0f;
        }
      }
#pragma unroll
      for (int a = 0; a < DPROJ_AHEAD; ++a) {
        const int r = r0 + a * groups;
        if (r >= n) break;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          if (d >= D) break;
          const float y = dys[r * D + d], yc = cround<CT>(y);
#pragma unroll
          for (int u = 0; u < UV; ++u) acc[u][d] = fmaf(cround<CT>(h[a][u]), yc, acc[u][d]);
          db[d] += y;
        }
      }
    }
  }
  if (gr < groups) {
#pragma unroll
    for (int u = 0; u < UV; ++u)
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (d < D) red[gr * out + (j * UV + u) * D + d] = acc[u][d];
    if (j == 0)
      for (int d = 0; d < D; ++d) red[gr * out + H * D + d] = db[d];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < out; i += DPROJ_THREADS) {
    float s = red[i];
    for (int k = 1; k < groups; ++k) s += red[k * out + i];
    partial[(size_t)blockIdx.x * out + i] = s;
  }
}

// dproj_w[i] (i < H·D) and dproj_b[i - H·D] = the sum of partial[k][i] over
// the S slices, a warp an output: lane l adds slices l, l + 32, .. in
// order, then the 32 lane sums in a fixed tree (lane 0's).
__global__ void ss_dproj_sum_kernel(const float* __restrict__ partial, int S, int HD, int out,
                                    float* __restrict__ dpw, float* __restrict__ dpb) {
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (i >= out) return;
  float s = 0.0f;
  for (int k = lane; k < S; k += 32) s += partial[(size_t)k * out + i];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) {
    if (i < HD)
      dpw[i] = s;
    else
      dpb[i - HD] = s;
  }
}

// ---------------------------------------------------------------------------
// C interface: each function launches on `stream` and returns
// cudaGetLastError() (0 = ok).
// ---------------------------------------------------------------------------

extern "C" {

// ss_fwd, ss_bwd and ss_dw: the static-context instances of lstm_common.cuh's
// launches (see ss_fwd_launch, ss_bwd_launch and ss_dw_layers for the
// arguments, block shapes and shared memory). ctx and dctx are (batch,
// ctx_dim), null when ctx_dim == 0. bf16: residuals in bf16; cbf16: the bf16
// compute type, whose weights arrive in bf16.
int ss_fwd(const void* w, const void* const* b, void* const* hs, void* const* cs, void* const* gs, const void* h0,
           const void* c0, const void* y0, const void* teacher, const void* coins, const void* ctx,
           const void* proj_wt, const void* proj_b, void* ys, void* c_glob, int batch, int t_len, int d, int ctx_dim,
           int hidden, int layers, int rp, int warps, int bf16, int cbf16, void* stream) {
  return ss_fwd_launch<false>(w, b, hs, cs, gs, h0, c0, y0, teacher, coins, ctx, proj_wt, proj_b, ys, c_glob, batch,
                              t_len, d, ctx_dim, hidden, layers, rp, warps, bf16, cbf16, stream);
}

// The forward's dynamic shared memory at a block of rp rows, c in shared
// memory (c_smem) or not, per step (step_ctx) or static context; -1 for a
// block it does not take
long long ss_fwd_smem(int rp, int d, int ctx_dim, int hidden, int layers, int c_smem, int step_ctx, int cbf16) {
  const int mode = step_ctx ? SSB_STEP : SSB_STATIC;
  if (train_fwd_bad_shape(1, 1, d, ctx_dim, hidden, layers, rp, 1, c_smem != 0, mode, cbf16)) return -1;
  return train_fwd_smem(rp, d, ctx_dim, hidden, layers, c_smem != 0, mode, cbf16);
}

// The forward's probe build's sums (-DLSTM_PROBE; LstmPart order, LP_PARTS
// of them) into out, then zeroed; without LSTM_PROBE, zeros.
int train_fwd_probe_read(unsigned long long* out) { return probe_read(g_lstm_probe, out); }

int ss_bwd(const void* dys, const void* c0, const void* coins, const void* const* wt, const void* w0x,
           const void* proj_w, const void* const* cs, const void* const* gs, void* const* dg, void* dy,
           void* dteacher, void* dy0, void* dh0, void* dc0, void* dctx, int batch, int t_len, int d,
           int ctx_dim, int hidden, int layers, int bf16, int cbf16, void* stream) {
  return ss_bwd_launch<false>(dys, c0, coins, wt, w0x, proj_w, cs, gs, dg, dy, dteacher, dy0, dh0, dc0, dctx, batch,
                              t_len, d, ctx_dim, hidden, layers, bf16, cbf16, stream);
}

// The backward recurrence's dynamic shared memory (ssb_smem_bytes at the
// block ssb_block picks) in the tier (cbf16: bf16), per step (step_ctx) or
// static context; -1 for a shape it does not take. Its block (rows, warps, W
// ring depth) into out.
long long ss_bwd_smem(int hidden, int layers, int d, int ctx_dim, int step_ctx, int cbf16, int* out) {
  const SsbBlock g = ss_bwd_block(hidden, layers, ctx_dim, step_ctx != 0, cbf16);
  out[0] = 16 * g.mt, out[1] = hidden / (8 * g.ub), out[2] = g.stages;
  return ss_bwd_smem(d, ctx_dim, hidden, layers, step_ctx != 0, cbf16);
}

int ss_dw(const void* h0, const void* y0, const void* teacher,
          const void* coins, const void* ctx, const void* ys,
          const void* const* hs, const void* const* cs, const void* const* gs,
          const void* const* dg, void* zpack, void* partial, void* const* dw,
          void* const* db, int batch, int t_len, int d, int ctx_dim,
          int hidden, int layers, int splits, int bf16, int cbf16,
          int pack_layer, void* stream) {
  return ss_dw_layers<DW_SS>(h0, y0, teacher, coins, ctx, nullptr, nullptr, 0, ys,
                      hs, cs, gs, dg, zpack, partial, dw, db, batch, t_len, d,
                      ctx_dim, hidden, layers, splits, bf16, cbf16, pack_layer, stream);
}

// dproj_w (hidden, d) and dproj_b (d,) over the batch·t_len rows of hs_top
// (residual type) and dy (f32), d <= 4, in the bf16 compute type when
// cbf16; hidden a multiple of 16 / sizeof(residual) whose row is at most
// 256 pieces of 16 bytes. `partial` holds splits x (hidden + 1) x d floats.
int ss_dproj(const void* hs_top, const void* dy, void* partial, void* dproj_w,
             void* dproj_b, int batch, int t_len, int d, int hidden,
             int splits, int bf16, int cbf16, void* stream) {
  const int uv = bf16 ? 8 : 4, tpr = hidden / uv;
  if (batch < 1 || t_len < 1 || d < 1 || d > 4 || hidden < uv || hidden % uv ||
      tpr > DPROJ_THREADS || splits < 1 || (long long)batch * t_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Q = batch * t_len, out = (hidden + 1) * d;
  const int chunk = ((Q + splits - 1) / splits + 3) / 4 * 4;  // 16-byte aligned dy slices
  const size_t smem = (size_t)(DPROJ_THREADS / tpr) * out * sizeof(float);
  float* part = static_cast<float*>(partial);
  const float* g = static_cast<const float*>(dy);
#define DPROJ(RT, CT)                                                          \
  ss_dproj_partial_kernel<RT, CT><<<splits, DPROJ_THREADS, smem, st>>>(        \
      static_cast<const RT*>(hs_top), g, part, Q, d, hidden, chunk)
  using BF = __nv_bfloat16;
  if (bf16 && cbf16)
    DPROJ(BF, BF);
  else if (bf16)
    DPROJ(BF, float);
  else if (cbf16)
    DPROJ(float, BF);
  else
    DPROJ(float, float);
#undef DPROJ
  ss_dproj_sum_kernel<<<(out + 7) / 8, 256, 0, st>>>(part, splits, hidden * d, out,
                                                     static_cast<float*>(dproj_w),
                                                     static_cast<float*>(dproj_b));
  return (int)cudaGetLastError();
}

const char* lstm_ss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
