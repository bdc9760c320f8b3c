// Teacher-forced stacked LSTM for training, forward and backward, for Hopper
// (sm_90a), f32 or bf16 compute, residuals in f32 or bf16.
//
// Replaces the TPU Pallas kernels of
//   longterm360fov_tpu/ops/lstm_train.py::lstm_seq_states
// (_fwd_kernel and _bwd_kernel under a jax.custom_vjp) with three kernels:
//   * the forward recurrence over T steps and L layers from (h0, c0):
//     lstm_common.cuh's train_fwd_kernel in its teacher-forced mode
//     (SSB_TF), on the tensor cores. It saves per layer h, c (B, T, H) and
//     the post-activation gates i, f, g, o (B, T, 4H) in the residual type.
//     Carries stay f32.
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
// or the residual type (lstm_common.cuh, cround). The f32 tier's products
// run on the tensor cores as three-pass TF32 (lstm_mma.cuh product_tf32),
// the forward's with both operands split to nearest (split_round). Every
// tensor is read and written batch-major, (B, T, ·), as the caller holds
// it: no time-major copies.
//
// What bounds them on the card, at seq2seq-tf-30's training shapes
// (B = 4096, T = 30, D = 3, H = 128, L = 1):
//   * Arithmetic. The forward is 2·B·T·(D+H)·4H = 16.5 GFLOP per pass, the
//     backward recurrence 16.1 GFLOP (dgates·Wᵀ) and the dW reduction
//     16.5 GFLOP: 0.10 ms each in three-pass TF32 (495 / 3 TFLOP/s), 0.017
//     ms in bf16 (989 TFLOP/s dense), 0.25 ms on the FMA units (67 TFLOP/s).
//   * Bytes. The residuals are 6H words per row-step: 377 MB per pass in f32,
//     189 MB in bf16, plus dgates (4H f32, 252 MB) written by the backward
//     recurrence and read by the reduction. At 3.35 TB/s that is 0.06-0.19 ms
//     per kernel: the f32 forward is bound by its products, the bf16 one by
//     its residual stores, the backward's tiers by bytes (0.14-0.19 ms). At
//     the crossuser 10 s encoder (B = 4096, T = 100, L = 2, f32 residuals)
//     the forward does 162 GFLOP (0.99 ms in three-pass TF32) and writes 2.5
//     GB (0.75 ms); the backward reads 2.10 GB of gates and c and writes 1.68
//     GB of dgates: 1.19 ms, against 164 GFLOP, 0.99 ms.
//   * W does not fit shared memory beside a block's state (131 x 512 x 4 =
//     268 KB > 227 KB); it is read from L2 every layer-step.
//   * The recurrence: T·L serial layer-steps, each a product, a cell and
//     two barriers; 128 blocks of 32 rows at B = 4096, one wave on 132 SMs.
// What the design does about it:
//   * The forward is the serve kernel's decoder body (lstm_mma.cuh server,
//     lstm_common.cuh says how the training modes extend it): z = [x_t | h_0
//     .. h_L-1] a block row in shared memory in the tier's type, the
//     encoders' warp tiles of all four gates (32 rows x 8 units in f32 on
//     16 warps, x 16 in bf16 on 8 at 32 rows), c in the lanes' slots, W
//     packed once a call (ops/fused_lstm.py pack_weights_tf32, pack_weights)
//     and streamed from L2 by each warp; h, c and the gates stored from the
//     cell's registers as 8- or 4-byte pairs, a quad of lanes 8 units along
//     a row. Layer 0's input takes whole k-steps of any width (the
//     teacher-forced decoder's [x, ctx], D = 3 + C). 32-row blocks give 128
//     blocks at B = 4096; 64 rows where the grid still has 128
//     (ops/lstm_train.py fwd_block).
//   * The backward is the scheduled-sampling decoder's (lstm_common.cuh says
//     how it runs): warp w holds units 8w .. 8w + 7 of the block's 32 rows in
//     the cell, which runs in mma's accumulator layout, and in its n-tiles of
//     the product; dgates go to device memory and, in the tier's type, to an
//     A buffer in shared memory; Wᵀ, packed once a call in mma's B fragment
//     order (ops/lstm_ss.py pack_bwd_weights), streams from L2 through each
//     warp's cp.async ring; deep stacks in 16-row blocks, hidden above 128
//     with two unit blocks a warp. It runs without the feedback, the coin,
//     the projection and the context: the top layer's upstream gradient is
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
// C interface: each function launches on `stream` and returns
// cudaGetLastError() (0 = ok).
// ---------------------------------------------------------------------------

extern "C" {

// The forward recurrence: lstm_common.cuh's train_fwd_kernel in its
// teacher-forced mode (SSB_TF). w: every layer's W packed for the tier
// (ops/fused_lstm.py pack_weights_tf32, f32; pack_weights when cbf16, bf16),
// b (4·hidden,) f32 a layer; xs (batch, t_len, d), h0, c0 (layers, batch,
// hidden) f32 → hs, cs (batch, t_len, hidden) and gs (batch, t_len,
// 4·hidden) a layer, bf16 when bf16, else f32. The block (ops/lstm_train.py
// fwd_block): rp rows, `warps` warps, c in shared memory or, where c_glob is
// given, in c_glob (grid x layers x rp x hidden floats).
int lstm_fwd(const void* w, const void* const* b, const void* xs, const void* h0, const void* c0, void* const* hs,
             void* const* cs, void* const* gs, void* c_glob, int batch, int t_len, int d, int hidden, int layers,
             int rp, int warps, int bf16, int cbf16, void* stream) {
  TrainFwdArgs a = train_fwd_args(w, b, hs, cs, gs, h0, c0, layers);
  a.xs = static_cast<const float*>(xs);
  return train_fwd_go<SSB_TF>(a, c_glob, batch, t_len, d, 0, hidden, layers, rp, warps, bf16, cbf16, stream);
}

// The forward's dynamic shared memory at a block of rp rows, c in shared
// memory (c_smem) or not; -1 for a block it does not take
long long lstm_fwd_smem(int rp, int d, int hidden, int layers, int c_smem, int cbf16) {
  if (train_fwd_bad_shape(1, 1, d, 0, hidden, layers, rp, 1, c_smem != 0, SSB_TF, cbf16)) return -1;
  return train_fwd_smem(rp, d, 0, hidden, layers, c_smem != 0, SSB_TF, cbf16);
}

// The forward's probe build's sums (-DLSTM_PROBE; LstmPart order, LP_PARTS
// of them) into out, then zeroed; without LSTM_PROBE, zeros.
int train_fwd_probe_read(unsigned long long* out) { return probe_read(g_lstm_probe, out); }

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
// for one it does not), bytes; its block (rows, warps, W ring depth) into
// out
long long lstm_bwd_smem(int hidden, int layers, int d_narrow, int d_wide, int cbf16, int* out) {
  const SsbBlock g = ss_bwd_block(hidden, layers, d_wide, true, cbf16);
  out[0] = 16 * g.mt, out[1] = hidden / (8 * g.ub), out[2] = g.stages;
  return ss_bwd_smem(d_narrow, d_wide, hidden, layers, true, cbf16);
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
