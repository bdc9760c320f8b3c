// Teacher-forced stacked LSTM for training, forward and backward, for Hopper
// (sm_90a), f32 or bf16 compute, residuals in f32 or bf16.
//
// Replaces the TPU Pallas kernels of
//   longterm360fov_tpu/ops/lstm_train.py::lstm_seq_states
// (_fwd_kernel and _bwd_kernel under a jax.custom_vjp) with three kernels:
//   * lstm_fwd_kernel: the forward recurrence over T steps and L layers from
//     (h0, c0). It saves per layer h, c (B, T, H) and the post-activation
//     gates i, f, g, o (B, T, 4H) in the residual type. Carries stay f32.
//   * the backward recurrence in reverse time: lstm_common.cuh's
//     ss_bwd_kernel in its teacher-forced mode (SSB_TF), on the tensor
//     cores. Per layer, top-down, it forms dgates = [di, df, dg, do] from the
//     residuals and the carried (dh, dc), writes dgates (B, T, 4H) f32, and
//     runs dz = dgates · Wᵀ: dz's h part is the next carried dh, its input
//     part the gradient of the layer below (dxs for layer 0). It ends with
//     dh0, dc0. The top layer's dh is the upstream dhs_top plus the carried
//     dh; the carries start from dhT, dcT.
//   * lstm_dw_pack_kernel + lstm_dw_partial_kernel + lstm_dw_sum_kernel:
//     dW_l = Σ_{b,t} zᵀ·dgates and db_l = Σ_{b,t} dgates with
//     z = [input_t, h_{t-1}]: input_t is xs for layer 0 and o·tanh(c) of the
//     layer below, rebuilt from its residuals, for l > 0; h_{t-1} is read
//     from the residuals, and from h0 at t = 0. The pack pass writes z once
//     in the compute type. The TPU kernel summed dW in a buffer that stayed
//     in VMEM across its grid, which ran in order; blocks here run in
//     parallel, so the (b, t) rows are split into S slices, each block
//     writes the partial sums of one dW tile over one slice, and a second
//     pass adds the S partials in a fixed order. No float atomics: two runs
//     give the same bits.
// The bf16 compute type (the TPU kernels' compute_dtype=bfloat16 tier)
// rounds both operands of each product to bf16 and sums in f32: the gate
// products [x, h]·W, dgates·Wᵀ, the dW sums zᵀ·dgates; db sums the unrounded
// dgates, and carries, gates, residuals and dgates in device memory stay f32
// or the residual type (lstm_common.cuh, cround). W is read as bf16 that the
// wrapper rounded once per call, half the bytes from L2. The forward's
// products still run on the FMA units (the operands widened to f32), so it
// is no faster than f32; the backward and the dW sums run on the tensor
// cores. Every tensor is read and written batch-major, (B, T, ·), as the
// caller holds it: no time-major copies.
//
// What bounds them on the card, at seq2seq-tf-30's training shapes
// (B = 4096, T = 30, D = 3, H = 128, L = 1):
//   * Arithmetic. The forward is 2·B·T·(D+H)·4H = 16.5 GFLOP per pass, the
//     backward recurrence 16.1 GFLOP (dgates·Wᵀ) and the dW reduction
//     16.5 GFLOP. On the FMA units (67 TFLOP/s peak) that is at least
//     0.25 ms each; the backward in three-pass TF32 (495 / 3 TFLOP/s) 0.10
//     ms, in bf16 (989 TFLOP/s dense) 0.016 ms.
//   * Bytes. The residuals are 6H words per row-step: 377 MB per pass in f32,
//     189 MB in bf16, plus dgates (4H f32, 252 MB) written by the backward
//     recurrence and read by the reduction. At 3.35 TB/s that is 0.06-0.19 ms
//     per kernel: the forward is bound by FMA throughput, the backward's
//     tiers by bytes (0.14-0.19 ms) once on the tensor cores. At the
//     crossuser 10 s encoder (B = 4096, T = 100, L = 2, f32 residuals) the
//     backward reads 2.10 GB of gates and c and writes 1.68 GB of dgates:
//     1.19 ms, against 164 GFLOP, 0.99 ms in three-pass TF32.
//   * W does not fit shared memory beside a block's state (131 x 512 x 4 =
//     268 KB > 227 KB); it is read from L2 every layer-step.
//   * Occupancy at the training batch. The forward's thread owns TR = 4 rows
//     x TJ = 4 hidden units and a block 16 rows (the wrapper picks; 8 rows
//     per thread spilled registers and ran slower): at B = 4096 that is 256
//     blocks of 128 threads, two resident per SM, one wave. The backward's
//     32-row blocks of 16 warps give 128 blocks, one wave on 132 SMs. The dW
//     reduction tiles dW into 144 x 128 tiles and splits the B·T rows so
//     that the full tiles alone give two blocks per SM.
// What the design does about it:
//   * The forward keeps every carry on chip: h of every layer k-major in
//     shared memory (read as the second half of [x, h]) and c in
//     owner-private shared memory (a thread owns the same (row, unit) pairs
//     in every step, so the cell math needs no exchange). A k-major column
//     of the thread's 4 rows is one 16-byte shared load (a broadcast: a warp
//     shares its rows) and one 16-byte store.
//   * The backward is the scheduled-sampling decoder's (lstm_common.cuh says
//     how it runs): warp w holds units 8w .. 8w + 7 of the block's 32 rows in
//     the cell, which runs in mma's accumulator layout, and in its n-tiles of
//     the product; dgates go to device memory and, in the tier's type, to an
//     A buffer in shared memory; Wᵀ, packed once a call in mma's B fragment
//     order (ops/lstm_ss.py pack_bwd_weights), streams from L2 through each
//     warp's cp.async ring. It runs without the feedback, the coin, the
//     projection and the context: the top layer's upstream gradient is
//     dhs_top[t], the carries start from dhT, dcT, and dxs is written every
//     step, its first D (up to 8) columns from the warps' mma partials, the
//     rest (the teacher-forced decoder's static context, D = 3 + C) from
//     whole n8 tiles of layer 0's product.
//   * The dW reduction reads each operand from device memory once, or
//     nearly. A pack pass builds z once, h part first so that its wide parts
//     are whole 16-byte runs, and writes it in the compute type (in bf16 a
//     quarter of dgates' bytes); the product then tiles dW into 144 features
//     x 128 columns, so that the 132 features of an input of 3 are one tile
//     (and 257-260 two), and no block reads dgates for a handful of
//     features. A block stages its slice's rows in two shared-memory
//     buffers, the next stage's loads in flight while the current one
//     computes: in bf16 (mma.sync m16n8k16, f32 accumulators) 32 rows, z by
//     cp.async and dgates through registers, rounded as they are stored and
//     summed unrounded for db; in f32 16 rows by cp.async and a 9 x 8 FMA
//     tile per thread. A pack is a bytes-bound pass; the products keep 128
//     registers, two blocks per SM.
// The device code these kernels share with lstm_ss.cu and lstm_align.cu is
// in lstm_common.cuh.

#include "lstm_common.cuh"

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename CT>
struct FwdArgs {
  const CT* w[MAX_LAYERS];     // (in_l + H, 4H), gate order i, f, g, o
  const float* b[MAX_LAYERS];  // (4H,)
  void* hs[MAX_LAYERS];        // (B, T, H) residual type
  void* cs[MAX_LAYERS];        // (B, T, H)
  void* gs[MAX_LAYERS];        // (B, T, 4H)
};

template <typename RT, typename CT>
__global__ void __launch_bounds__(256)
    lstm_fwd_kernel(const float* __restrict__ xs, const float* __restrict__ h0,
                    const float* __restrict__ c0, const FwdArgs<CT> a, int B,
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

  load_states(h_s, c_s, h0, c0, row0, B, H, L, R, r0, j0, tid, nthr);

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
// C interface: each function launches on `stream` and returns
// cudaGetLastError() (0 = ok).
// ---------------------------------------------------------------------------

static bool bad_shape(int batch, int t_len, int d, int hidden, int layers,
                      int rows) {
  return layers < 1 || layers > MAX_LAYERS || hidden < 32 || hidden % 32 ||
         rows < TR || rows % TR || batch < 1 || t_len < 1 || d < 1 ||
         (rows / TR) * (hidden / TJ) > 256;
}

// The launches with the weights in the compute type CT (see lstm_fwd and
// lstm_bwd below).
template <typename CT>
static int fwd_go(const float* xs, const float* h0, const float* c0,
                  const void* const* w, const void* const* b, void* const* hs,
                  void* const* cs, void* const* gs, int batch, int t_len, int d,
                  int hidden, int layers, int rows, int bf16, cudaStream_t st) {
  FwdArgs<CT> a;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    const bool on = l < layers;
    a.w[l] = on ? static_cast<const CT*>(w[l]) : nullptr;
    a.b[l] = on ? static_cast<const float*>(b[l]) : nullptr;
    a.hs[l] = on ? hs[l] : nullptr;
    a.cs[l] = on ? cs[l] : nullptr;
    a.gs[l] = on ? gs[l] : nullptr;
  }
  const size_t smem = ((size_t)2 * layers * hidden + d) * rows * sizeof(float);
  const int threads = (rows / TR) * (hidden / TJ);
  const int grid = (batch + rows - 1) / rows;
  if (bf16)
    return launch_with_smem(lstm_fwd_kernel<__nv_bfloat16, CT>, grid, threads,
                            smem, st, xs, h0, c0, a, batch, t_len, d, hidden,
                            layers, rows);
  return launch_with_smem(lstm_fwd_kernel<float, CT>, grid, threads, smem, st,
                          xs, h0, c0, a, batch, t_len, d, hidden, layers, rows);
}

extern "C" {

// rows: batch rows per block, a multiple of 4. The block has
// (rows / 4) * (hidden / 4) threads and (2 * layers * hidden + d) * rows
// floats of dynamic shared memory. bf16: residuals in bf16; cbf16: the bf16
// compute type, w in bf16 (else f32).
int lstm_fwd(const void* xs, const void* h0, const void* c0,
             const void* const* w, const void* const* b, void* const* hs,
             void* const* cs, void* const* gs, int batch, int t_len, int d,
             int hidden, int layers, int rows, int bf16, int cbf16,
             void* stream) {
  if (bad_shape(batch, t_len, d, hidden, layers, rows))
    return (int)cudaErrorInvalidValue;
  const auto go = cbf16 ? &fwd_go<__nv_bfloat16> : &fwd_go<float>;
  return go(static_cast<const float*>(xs), static_cast<const float*>(h0),
            static_cast<const float*>(c0), w, b, hs, cs, gs, batch, t_len, d,
            hidden, layers, rows, bf16, static_cast<cudaStream_t>(stream));
}

// The backward recurrence: lstm_common.cuh's ss_bwd_kernel in its
// teacher-forced mode (SSB_TF; 32 rows a block of hidden / 8 warps, hidden a
// multiple of 32 up to 128). wt: every layer's Wᵀ packed for the tier
// (ops/lstm_ss.py pack_bwd_weights with d_narrow, d_wide); w0x layer 0's
// W[:d_narrow] in the tier's type (f32, or bf16 when cbf16); layer 0's input
// is d_narrow (1..8) + d_wide (a multiple of 8 up to hidden) columns, dxs
// (batch, t_len, d_narrow + d_wide); residuals bf16 (bf16) or f32.
int lstm_bwd(const void* dhs_top, const void* dhT, const void* dcT, const void* c0, const void* const* wt,
             const void* w0x, const void* const* cs, const void* const* gs, void* const* dg, void* dxs, void* dh0,
             void* dc0, int batch, int t_len, int d_narrow, int d_wide, int hidden, int layers, int bf16, int cbf16,
             void* stream) {
  SsBwdArgs a = ss_bwd_args(wt, w0x, nullptr, cs, gs, dg, layers);
  a.dhs_top = static_cast<const float*>(dhs_top);
  a.dhT = static_cast<const float*>(dhT);
  a.dcT = static_cast<const float*>(dcT);
  a.dxs = static_cast<float*>(dxs);
  return ss_bwd_go<SSB_TF>(a, nullptr, c0, nullptr, nullptr, nullptr, nullptr, dh0, dc0, nullptr, batch, t_len,
                           d_narrow, d_wide, hidden, layers, bf16, cbf16, stream);
}

// The backward recurrence's dynamic shared memory at a shape it takes (-1
// for one it does not), bytes
long long lstm_bwd_smem(int hidden, int layers, int d_narrow, int d_wide, int cbf16) {
  if (ss_bwd_bad_shape(1, 1, d_narrow, d_wide, hidden, layers)) return -1;
  return cbf16 ? ss_bwd_smem_bytes<lstm_mma::Bf16Mma>(hidden, layers, d_wide, true)
               : ss_bwd_smem_bytes<lstm_mma::Tf32Mma>(hidden, layers, d_wide, true);
}

// The probe build's sums (-DSSB_PROBE; SsbPart order, SB_PARTS of them)
// into out, then zeroed; without SSB_PROBE, zeros.
int lstm_bwd_probe_read(unsigned long long* out) { return probe_read(g_ssb_probe, out); }

// Per layer: the pack pass into zpack (batch·t_len x max_l dw_zld(in_l, H)
// values of the compute type), the partial sums over `splits` slices of the
// B·T rows, then their sum. `partial` holds splits x (max_l(in_l + H) + 1) x
// 4H floats; both are reused layer after layer (the launches are ordered on
// the stream). pack_layer >= 0: only that layer's pack pass, into zpack.
int lstm_dw(const void* xs, const void* h0, const void* const* hs,
            const void* const* cs, const void* const* gs,
            const void* const* dg, void* zpack, void* partial, void* const* dw,
            void* const* db, int batch, int t_len, int d, int hidden,
            int layers, int splits, int bf16, int cbf16, int pack_layer,
            void* stream) {
  if (layers < 1 || layers > MAX_LAYERS || hidden < 32 || hidden % 32 ||
      batch < 1 || t_len < 1 || d < 1 || splits < 1 || pack_layer >= layers ||
      (long long)batch * t_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < layers; ++l) {
    if (pack_layer >= 0 && l != pack_layer) continue;
    DwArgs a = {};
    a.xs = static_cast<const float*>(xs);
    a.h0 = static_cast<const float*>(h0) + (size_t)l * batch * hidden;
    a.hs = hs[l];
    a.cs_in = l > 0 ? cs[l - 1] : nullptr;
    a.gs_in = l > 0 ? gs[l - 1] : nullptr;
    a.dg = static_cast<const float*>(dg[l]);
    const bool pack_only = pack_layer >= 0;
    const cudaError_t e = dw_layer<DW_TF>(
        a, zpack, static_cast<float*>(partial), pack_only ? nullptr : static_cast<float*>(dw[l]),
        pack_only ? nullptr : static_cast<float*>(db[l]), batch, t_len, d, hidden,
        l == 0 ? d : hidden, l == 0 ? d : 0, splits, bf16 != 0, cbf16 != 0, pack_only, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

const char* lstm_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
