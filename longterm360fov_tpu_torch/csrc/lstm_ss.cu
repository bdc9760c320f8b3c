// Scheduled-sampling LSTM decoder for training, forward and backward, for
// Hopper (sm_90a), f32 or bf16 compute, residuals in f32 or bf16.
//
// Replaces the TPU Pallas kernels of
//   longterm360fov_tpu/ops/lstm_ss.py::ss_decode
// (_fwd_kernel and _bwd_kernel under a jax.custom_vjp) with four kernels.
// The two recurrences live in lstm_common.cuh, whose per-step-context
// instances lstm_align.cu launches; this file launches the static-context
// ones (STEP_CTX = false):
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
// dproj reduction
// ---------------------------------------------------------------------------

// Block s sums the rows q of its slice in `groups` interleaved row groups of
// H + 32 threads: thread j < H of a group holds dproj_w[j][:D] += h_top[q][j]
// · dy[q][:D], lane j - H < D of its last warp dproj_b[j - H] += dy[q][j - H].
// The groups are added in order through shared memory into
// partial[s] = (dproj_w (H, D) row-major, dproj_b (D,)). CT rounds h_top and
// dy in dproj_w's product; dproj_b sums dy as it is.
template <typename RT, typename CT>
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
      const float h = cround<CT>(Res<RT>::ld(hs_top + (size_t)q * H + j));
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (d < D) acc[d] = fmaf(h, cround<CT>(dy[(size_t)q * D + d]), acc[d]);
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

extern "C" {

// ss_fwd, ss_bwd and ss_dw: the static-context instances of lstm_common.cuh's
// launches (see ss_fwd_launch, ss_bwd_launch and ss_dw_layers for the
// arguments, block shapes and shared memory). ctx and dctx are (batch,
// ctx_dim), null when ctx_dim == 0. bf16: residuals in bf16; cbf16: the bf16
// compute type, whose weights arrive in bf16.
int ss_fwd(const void* h0, const void* c0, const void* y0, const void* teacher,
           const void* coins, const void* ctx, const void* const* w,
           const void* const* b, const void* proj_w, const void* proj_b,
           void* const* hs, void* const* cs, void* const* gs, void* ys,
           int batch, int t_len, int d, int ctx_dim, int hidden, int layers,
           int rows, int bf16, int cbf16, void* stream) {
  return ss_fwd_launch<false>(h0, c0, y0, teacher, coins, ctx, w, b, proj_w,
                              proj_b, hs, cs, gs, ys, batch, t_len, d, ctx_dim,
                              hidden, layers, rows, bf16, cbf16, stream);
}

int ss_bwd(const void* dys, const void* c0, const void* coins, const void* w0,
           const void* const* wt, const void* wtc, const void* proj_w,
           const void* const* cs, const void* const* gs, void* const* dg,
           void* dy, void* dteacher, void* dy0, void* dh0, void* dc0,
           void* dctx, int batch, int t_len, int d, int ctx_dim, int hidden,
           int layers, int rows, int bf16, int cbf16, void* stream) {
  return ss_bwd_launch<false>(dys, c0, coins, w0, wt, wtc, proj_w, cs, gs, dg,
                              dy, dteacher, dy0, dh0, dc0, dctx, batch, t_len,
                              d, ctx_dim, hidden, layers, rows, bf16, cbf16,
                              stream);
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
// cbf16. `partial` holds splits x (hidden + 1) x d floats.
int ss_dproj(const void* hs_top, const void* dy, void* partial, void* dproj_w,
             void* dproj_b, int batch, int t_len, int d, int hidden,
             int splits, int bf16, int cbf16, void* stream) {
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
#define DPROJ(RT, CT)                                             \
  ss_dproj_partial_kernel<RT, CT><<<splits, threads, smem, st>>>( \
      static_cast<const RT*>(hs_top), g, part, Q, d, hidden, chunk, groups)
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
