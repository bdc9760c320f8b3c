// Lockstep-peer scheduled-sampling decoder for training, forward and
// backward, for Hopper (sm_90a), f32 or bf16 compute, residuals in f32 or
// bf16.
//
// Replaces the TPU Pallas kernels of
//   longterm360fov_tpu/ops/lstm_align.py::aligned_ss_decode
// (_fwd_kernel and _bwd_kernel under a jax.custom_vjp). At decoder step t the
// K peer encoders (one LSTM cell of hidden C, shared weights Wp (D + C, 4C),
// from zero state) advance one step on their known windows pxs_t, and
// ctx_t = Σ_k pwt[b, k] · h_k,t (k = 0 .. K - 1 in order, from the f32 h) is
// step t's context; the decoder is lstm_ss.cu's with that per-step context.
// The TPU kernel ran both in one pass over (batch tile, t). Here:
//   * align_peer_fwd_kernel: the peer recurrence over the B·K peer rows,
//     peer row p = b·K + k. A block holds all K peers of RV viewers, so ctx_t
//     is a block-local sum in a fixed order. It writes the peer h and c
//     (B·K, T, C) in the residual type (the gates are not saved: the backward
//     recomputes them, as the TPU backward does) and ctx (B, T, C) f32;
//   * the decoder forward and backward recurrences: lstm_common.cuh's
//     ss_fwd_kernel and ss_bwd_kernel with STEP_CTX = true (ctx_t reloaded
//     every step; dctx_t written per step, not summed over t);
//   * align_peer_bwd_kernel: the peer backward in reverse time, over the
//     peer rows: dh_k,t = pwt[b, k] · dctx_t + the carried dh; the gates
//     recomputed from [pxs_t, h_{t-1}] (h_{t-1} read from the residuals, 0 at
//     t = 0) and c_t, c_{t-1} read from the residuals; it writes the peer
//     dgates (B·K, T, 4C) f32, dpxs (B·K, T, D) and dpwt[b, k] = Σ_t Σ_c
//     dctx_t · h_k,t (the residual h), each row's sum in a fixed order;
//   * the dW/db reductions of lstm_common.cuh: the decoder's (layer 0's
//     context rebuilt from the residual peer h and pwt, as the TPU backward
//     rebuilds it: the DW_ALIGN loader) and the peer encoder's, the
//     teacher-forced loader over the B·K·T rows with z = [pxs_t, h_{t-1}];
//   * dproj: lstm_ss.cu's ss_dproj, launched by the wrapper.
// The bf16 compute type (lstm_common.cuh) rounds the operands of the peer
// gates [pxs_t, h_{t-1}]·Wp in the forward and in the backward's recomputed
// gates alike (the residual h_{t-1} is the forward's h rounded to the residual
// type, whose bf16 rounding is the same), dgates·Wpᵀ and the peer dW; ctx_t
// is formed from the unrounded h and rounded only where it enters the
// decoder's layer-0 product; dpwt is an elementwise sum and stays f32.
// The dependencies allow the split: the peer forward reads nothing of the
// decoder, and the decoder backward hands dctx_t to the peers and takes
// nothing back. So the peer recurrences run over B·K rows (K times the
// decoder's), and only the decoder's serial feedback chain runs at B rows.
//
// What bounds it on the card, at stacked-ss-crossuser-10s's training shapes
// (B = 4096, K = 7, T = 100, D = 3, C = H = 128, L = 2):
//   * Arithmetic. The peer forward is 2·B·K·T·(D + C)·4C = 385 GFLOP, the
//     decoder forward 216 GFLOP; the backward recurrences the same again
//     plus the peers' recomputed gates (385); the dW reductions as much as
//     the forwards: about 2.3 TFLOP a step, exact f32 on the FMA units
//     (67 TFLOP/s).
//   * Bytes. bf16 peer residuals are 2C·2 bytes a row-step: 1.5 GB a pass;
//     the peer dgates (4C f32) 5.9 GB, written once and read once: about
//     4 ms at 3.35 TB/s against about 35 ms of FMA time.
// What the design does about it: lstm_train.cu's tiles (a thread owns 4 rows
// x 4 units), every carry on chip, W streamed from L2 with 16-byte loads,
// and the split above, which gives the peer kernels K times the rows.

#include "lstm_common.cuh"

// ---------------------------------------------------------------------------
// peer forward
// ---------------------------------------------------------------------------

// Block: RV viewers from b0 = blockIdx.x · RV, their R = RV·K peer rows from
// p0 = b0·K (contiguous in the (B·K, T, ·) layout). Per step: x_t = pxs_t,
// one cell step (fwd_layer_step, h and c stored), then ctx_t of the block's
// viewers from the f32 h in shared memory.
template <typename RT, typename CT>
__global__ void __launch_bounds__(256)
    align_peer_fwd_kernel(const float* __restrict__ pxs,
                          const float* __restrict__ pwt,
                          const CT* __restrict__ wp,
                          const float* __restrict__ bp, RT* __restrict__ php,
                          RT* __restrict__ pcp, float* __restrict__ ctx, int B,
                          int K, int T, int D, int C, int RV) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int R = RV * K, P = B * K;
  const int j0 = (tid % (C / TJ)) * TJ;
  const int r0 = (tid / (C / TJ)) * TR;
  float* h_s = smem;            // (C, R)
  float* c_s = h_s + C * R;     // owner-private (TR * TJ, nthr)
  float* x_s = c_s + C * R;     // (D, R)
  float* w_s = x_s + D * R;     // (R,) pwt of the block's peer rows
  const long long b0 = (long long)blockIdx.x * RV, row0 = b0 * K;

  for (int i = tid; i < 2 * C * R; i += nthr) h_s[i] = 0.0f;  // h_s, c_s
  for (int r = tid; r < R; r += nthr) w_s[r] = row0 + r < P ? pwt[row0 + r] : 0.0f;
  for (int t = 0; t < T; ++t) {
    for (int i = tid; i < R * D; i += nthr) {
      const int r = i / D, d = i % D;
      const long long row = row0 + r;
      x_s[d * R + r] = row < P ? pxs[((size_t)row * T + t) * D + d] : 0.0f;
    }
    __syncthreads();
    fwd_layer_step<RT, false>(x_s, D, h_s, c_s, wp, bp, php, pcp, nullptr,
                              row0, P, T, t, C, R, r0, j0, tid, nthr);
    // ctx_t[b][c] = Σ_k w[b, k] · h[b·K + k][c]: neighbouring threads write
    // neighbouring units of a row. The next step's h is written only after
    // its first barrier, so these reads need none of their own.
    for (int i = tid; i < RV * C; i += nthr) {
      const int v = i / C, c = i % C;
      const long long b = b0 + v;
      if (b >= B) continue;
      float s = 0.0f;
      for (int k = 0; k < K; ++k) s += h_s[c * R + v * K + k] * w_s[v * K + k];
      ctx[((size_t)b * T + t) * C + c] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// peer backward recurrence
// ---------------------------------------------------------------------------

// Block: R peer rows from row0 = blockIdx.x · R. wpt is Wp[D:]ᵀ (4C, C),
// which gives the carried dh; Wp's first D rows give dpxs. Wp and wpt are in
// the compute type CT.
template <typename RT, typename CT>
__global__ void __launch_bounds__(256)
    align_peer_bwd_kernel(const float* __restrict__ pxs,
                          const float* __restrict__ pwt,
                          const CT* __restrict__ wp,
                          const CT* __restrict__ wpt,
                          const float* __restrict__ bp,
                          const RT* __restrict__ php,
                          const RT* __restrict__ pcp,
                          const float* __restrict__ dctx,
                          float* __restrict__ dpg, float* __restrict__ dpxs,
                          float* __restrict__ dpwt, int P, int K, int T, int D,
                          int C, int R) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int G = 4 * C, CR = C * R, NJ = C / TJ;
  const int j0 = (tid % NJ) * TJ;
  const int r0 = (tid / NJ) * TR;
  float* z_s = smem;                 // (D + C, R) [pxs_t, h_{t-1}]
  float* dg_s = z_s + (D + C) * R;   // (4C, R) this step's dgates
  float* dh_s = dg_s + G * R;        // owner-private carried dh
  float* dc_s = dh_s + CR;           // owner-private carried dc
  float* red = dc_s + CR;            // (R, C / TJ) the dpwt partial sums
  const long long row0 = (long long)blockIdx.x * R;

  for (int i = tid; i < 2 * CR; i += nthr) dh_s[i] = 0.0f;  // dh_s, dc_s
  float wv[TR], pw_acc[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const long long row = row0 + r0 + r;
    wv[r] = row < P ? pwt[row] : 0.0f;
    pw_acc[r] = 0.0f;
  }
  float bias[4][TJ];
#pragma unroll
  for (int g = 0; g < 4; ++g) F::ld4(bp + g * C + j0, bias[g]);

  for (int t = T - 1; t >= 0; --t) {
    for (int i = tid; i < R * D; i += nthr) {
      const int r = i / D, d = i % D;
      const long long row = row0 + r;
      z_s[d * R + r] = row < P ? pxs[((size_t)row * T + t) * D + d] : 0.0f;
    }
    for (int i = tid; i < R * C; i += nthr) {
      const int r = i / C, c = i % C;
      const long long row = row0 + r;
      z_s[(D + c) * R + r] =
          row < P && t > 0 ? Res<RT>::ld(php + ((size_t)row * T + t - 1) * C + c) : 0.0f;
    }
    __syncthreads();
    // the gates, recomputed: [pxs_t, h_{t-1}] · Wp + bp; then, in place,
    // their gradients
    float acc[4][TR][TJ];
    zero(acc);
    accumulate<4>(acc, z_s, D + C, wp, G, C, R, r0, j0);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const long long row = row0 + r0 + r;
      float dcx[TJ] = {0.0f, 0.0f, 0.0f, 0.0f}, hv[TJ] = {0.0f, 0.0f, 0.0f, 0.0f};
      float ct[TJ] = {0.0f, 0.0f, 0.0f, 0.0f}, cp[TJ] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (row < P) {
        const size_t q = (size_t)row * T + t;
        F::ld4(dctx + ((size_t)(row / K) * T + t) * C + j0, dcx);
        Res<RT>::ld4(php + q * C + j0, hv);
        Res<RT>::ld4(pcp + q * C + j0, ct);
        if (t > 0) Res<RT>::ld4(pcp + (q - 1) * C + j0, cp);
      }
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int idx = (r * TJ + j) * nthr + tid;
        const float i_g = sigmoid_f32(acc[0][r][j] + bias[0][j]);
        const float f_g = sigmoid_f32(acc[1][r][j] + bias[1][j]);
        const float g_g = tanhf(acc[2][r][j] + bias[2][j]);
        const float o_g = sigmoid_f32(acc[3][r][j] + bias[3][j]);
        const float dh = wv[r] * dcx[j] + dh_s[idx];
        const float tanh_c = tanhf(ct[j]);
        const float dc = dh * o_g * (1.0f - tanh_c * tanh_c) + dc_s[idx];
        acc[0][r][j] = dc * g_g * i_g * (1.0f - i_g);
        acc[1][r][j] = dc * cp[j] * f_g * (1.0f - f_g);
        acc[2][r][j] = dc * i_g * (1.0f - g_g * g_g);
        acc[3][r][j] = dh * tanh_c * o_g * (1.0f - o_g);
        dc_s[idx] = dc * f_g;
        pw_acc[r] += dcx[j] * hv[j];
      }
      if (row < P) {
        const size_t q = (size_t)row * T + t;
#pragma unroll
        for (int g = 0; g < 4; ++g) F::st4(dpg + q * G + g * C + j0, acc[g][r]);
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < TJ; ++j) st_rows(dg_s, g * C + j0 + j, R, r0, acc[g], j);
    __syncthreads();  // this step's dgates complete in dg_s
    // the carried dh = dgates · Wp[D:]ᵀ
    float dacc[1][TR][TJ];
    zero(dacc);
    accumulate<1>(dacc, dg_s, G, wpt, C, 0, R, r0, j0);
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int j = 0; j < TJ; ++j) dh_s[(r * TJ + j) * nthr + tid] = dacc[0][r][j];
    // dpxs_t = dgates · Wp[:D]ᵀ
    input_grad(dg_s, wp, D, G, R, row0, P, tid, nthr, [&](int r, int d, float dx) {
      dpxs[((size_t)(row0 + r) * T + t) * D + d] = dx;
    });
    __syncthreads();  // z_s and dg_s are read by everyone before the next step
  }
  // dpwt of each row: its C / TJ threads' sums, added in unit order
#pragma unroll
  for (int r = 0; r < TR; ++r) red[(r0 + r) * NJ + j0 / TJ] = pw_acc[r];
  __syncthreads();
  for (int r = tid; r < R; r += nthr) {
    if (row0 + r >= P) continue;
    float s = 0.0f;
    for (int q = 0; q < NJ; ++q) s += red[r * NJ + q];
    dpwt[row0 + r] = s;
  }
}

// ---------------------------------------------------------------------------
// C interface: each function launches on `stream` and returns
// cudaGetLastError() (0 = ok).
// ---------------------------------------------------------------------------

extern "C" {

// The peer forward: pxs (batch·n_peers, t_len, d) f32, pwt (batch, n_peers),
// wp (d + ctx_dim, 4·ctx_dim), bp (4·ctx_dim,) → php, pcp (batch·n_peers,
// t_len, ctx_dim) residual type, ctx (batch, t_len, ctx_dim) f32. rows_v
// viewers a block: (rows_v·n_peers / 4)·(ctx_dim / 4) threads and
// (2·ctx_dim + d + 1)·rows_v·n_peers floats of dynamic shared memory. bf16:
// residuals in bf16; cbf16: the bf16 compute type, wp in bf16.
int align_peer_fwd(const void* pxs, const void* pwt, const void* wp,
                   const void* bp, void* php, void* pcp, void* ctx, int batch,
                   int n_peers, int t_len, int d, int ctx_dim, int rows_v,
                   int bf16, int cbf16, void* stream) {
  const int rows = rows_v * n_peers;
  if (batch < 1 || n_peers < 1 || t_len < 1 || d < 1 || ctx_dim < 32 ||
      ctx_dim % 32 || rows_v < 1 || rows % TR ||
      (rows / TR) * (ctx_dim / TJ) > 256 ||
      (long long)batch * n_peers * t_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)2 * ctx_dim + d + 1) * rows * sizeof(float);
  const int threads = (rows / TR) * (ctx_dim / TJ);
  const int grid = (batch + rows_v - 1) / rows_v;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *x = static_cast<const float*>(pxs), *w = static_cast<const float*>(pwt),
              *b = static_cast<const float*>(bp);
  float* out = static_cast<float*>(ctx);
#define PEER_FWD(RT, CT)                                                         \
  launch_with_smem(align_peer_fwd_kernel<RT, CT>, grid, threads, smem, st, x, w, \
                   static_cast<const CT*>(wp), b, static_cast<RT*>(php),         \
                   static_cast<RT*>(pcp), out, batch, n_peers, t_len, d,         \
                   ctx_dim, rows_v)
  using BF = __nv_bfloat16;
  if (bf16 && cbf16) return PEER_FWD(BF, BF);
  if (bf16) return PEER_FWD(BF, float);
  if (cbf16) return PEER_FWD(float, BF);
  return PEER_FWD(float, float);
#undef PEER_FWD
}

// The decoder's recurrences with a per-step context: ctx and dctx (batch,
// t_len, ctx_dim) f32; otherwise lstm_ss.cu's ss_fwd and ss_bwd.
int align_dec_fwd(const void* h0, const void* c0, const void* y0,
                  const void* teacher, const void* coins, const void* ctx,
                  const void* const* w, const void* const* b,
                  const void* proj_w, const void* proj_b, void* const* hs,
                  void* const* cs, void* const* gs, void* ys, int batch,
                  int t_len, int d, int ctx_dim, int hidden, int layers,
                  int rows, int bf16, int cbf16, void* stream) {
  if (ctx == nullptr || ctx_dim < 1) return (int)cudaErrorInvalidValue;
  return ss_fwd_launch<true>(h0, c0, y0, teacher, coins, ctx, w, b, proj_w,
                             proj_b, hs, cs, gs, ys, batch, t_len, d, ctx_dim,
                             hidden, layers, rows, bf16, cbf16, stream);
}

int align_dec_bwd(const void* dys, const void* c0, const void* coins,
                  const void* w0, const void* const* wt, const void* wtc,
                  const void* proj_w, const void* const* cs,
                  const void* const* gs, void* const* dg, void* dy,
                  void* dteacher, void* dy0, void* dh0, void* dc0, void* dctx,
                  int batch, int t_len, int d, int ctx_dim, int hidden,
                  int layers, int rows, int bf16, int cbf16, void* stream) {
  if (wtc == nullptr || dctx == nullptr || ctx_dim < 1) return (int)cudaErrorInvalidValue;
  return ss_bwd_launch<true>(dys, c0, coins, w0, wt, wtc, proj_w, cs, gs, dg,
                             dy, dteacher, dy0, dh0, dc0, dctx, batch, t_len, d,
                             ctx_dim, hidden, layers, rows, bf16, cbf16, stream);
}

// The peer backward recurrence: rows peer rows a block, (rows / 4)·(ctx_dim
// / 4) threads and ((d + ctx_dim) + 4·ctx_dim + 2·ctx_dim + ctx_dim / 4)·rows
// floats of dynamic shared memory. wpt is Wp[d:]ᵀ (4·ctx_dim, ctx_dim); dctx
// (batch, t_len, ctx_dim); out: dpg (batch·n_peers, t_len, 4·ctx_dim), dpxs
// (batch·n_peers, t_len, d), dpwt (batch, n_peers). wp and wpt in bf16 when
// cbf16.
int align_peer_bwd(const void* pxs, const void* pwt, const void* wp,
                   const void* wpt, const void* bp, const void* php,
                   const void* pcp, const void* dctx, void* dpg, void* dpxs,
                   void* dpwt, int batch, int n_peers, int t_len, int d,
                   int ctx_dim, int rows, int bf16, int cbf16, void* stream) {
  const long long peers = (long long)batch * n_peers;
  if (batch < 1 || n_peers < 1 || t_len < 1 || d < 1 || ctx_dim < 32 ||
      ctx_dim % 32 || rows < TR || rows % TR ||
      (rows / TR) * (ctx_dim / TJ) > 256 || peers * t_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)(d + ctx_dim) + 4 * ctx_dim + 2 * ctx_dim +
                       ctx_dim / TJ) * rows * sizeof(float);
  const int threads = (rows / TR) * (ctx_dim / TJ);
  const int grid = (int)((peers + rows - 1) / rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *x = static_cast<const float*>(pxs), *w = static_cast<const float*>(pwt),
              *b = static_cast<const float*>(bp), *dc = static_cast<const float*>(dctx);
  float *o_g = static_cast<float*>(dpg), *o_x = static_cast<float*>(dpxs),
        *o_w = static_cast<float*>(dpwt);
#define PEER_BWD(RT, CT)                                                          \
  launch_with_smem(align_peer_bwd_kernel<RT, CT>, grid, threads, smem, st, x, w,  \
                   static_cast<const CT*>(wp), static_cast<const CT*>(wpt), b,    \
                   static_cast<const RT*>(php), static_cast<const RT*>(pcp), dc,  \
                   o_g, o_x, o_w, (int)peers, n_peers, t_len, d, ctx_dim, rows)
  using BF = __nv_bfloat16;
  if (bf16 && cbf16) return PEER_BWD(BF, BF);
  if (bf16) return PEER_BWD(BF, float);
  if (cbf16) return PEER_BWD(float, BF);
  return PEER_BWD(float, float);
#undef PEER_BWD
}

// dW/db of every decoder layer; layer 0's context rebuilt from php and pwt
// (see ss_dw_layers).
int align_dec_dw(const void* h0, const void* y0, const void* teacher,
                 const void* coins, const void* php, const void* pwt,
                 const void* ys, const void* const* hs, const void* const* cs,
                 const void* const* gs, const void* const* dg, void* zpack,
                 void* partial, void* const* dw, void* const* db, int batch,
                 int t_len, int d, int ctx_dim, int n_peers, int hidden,
                 int layers, int splits, int bf16, int cbf16, int pack_layer,
                 void* stream) {
  if (php == nullptr || pwt == nullptr || n_peers < 1 || ctx_dim < 32 || ctx_dim % 32)
    return (int)cudaErrorInvalidValue;  // C as the peer kernels take it
  return ss_dw_layers<DW_ALIGN>(h0, y0, teacher, coins, nullptr, php, pwt, n_peers, ys,
                      hs, cs, gs, dg, zpack, partial, dw, db, batch, t_len, d, ctx_dim,
                      hidden, layers, splits, bf16, cbf16, pack_layer, stream);
}

// dWp (d + ctx_dim, 4·ctx_dim) and dbp over the peers·t_len rows:
// z = [pxs_t, h_{t-1}] (h0 = zeros (peers, ctx_dim) f32 at t = 0), the
// teacher-forced loader. zpack holds peers·t_len x dw_zld(d, ctx_dim) values
// of the compute type, `partial` splits x (d + ctx_dim + 1) x 4·ctx_dim
// floats. pack_only: only the pack pass, into zpack.
int align_peer_dw(const void* pxs, const void* h0, const void* php,
                  const void* dpg, void* zpack, void* partial, void* dw, void* db,
                  int peers, int t_len, int d, int ctx_dim, int splits,
                  int bf16, int cbf16, int pack_only, void* stream) {
  if (peers < 1 || t_len < 1 || d < 1 || ctx_dim < 32 || ctx_dim % 32 ||
      splits < 1 || (long long)peers * t_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  DwArgs a = {};
  a.xs = static_cast<const float*>(pxs);
  a.h0 = static_cast<const float*>(h0);
  a.hs = php;
  a.dg = static_cast<const float*>(dpg);
  return (int)dw_layer<DW_TF>(a, zpack, static_cast<float*>(partial), static_cast<float*>(dw),
                       static_cast<float*>(db), peers, t_len, d, ctx_dim, d, d,
                       splits, bf16 != 0, cbf16 != 0, pack_only != 0,
                       static_cast<cudaStream_t>(stream));
}

const char* lstm_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
