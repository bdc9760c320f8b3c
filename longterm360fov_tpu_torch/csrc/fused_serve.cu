// Whole-request LSTM serve kernel and whole-sequence encode kernel for
// Hopper (sm_90a), in exact f32 and in the bf16 compute tier.
//
// fused_serve_kernel replaces the TPU Pallas kernel
//   longterm360fov_tpu/ops/fused_lstm.py::fused_serve / _serve_kernel
// in its no-context, static-context and lockstep-peer tiers, f32 and bf16. One launch
// runs the whole request (the lockstep tier: two, see below):
//   * the L-layer encoder over T_in steps, from zero state;
//   * T_out autoregressive decoder steps. Decoder layer l starts from the
//     encoder's final (h, c) of layer l; the layer-0 input is [y, ctx]: the
//     previous output y, starting from y0 = past_n[:, T_in - 1], and, in the
//     static-context tier, the row's context ctx (B, C), written once;
//   * y = h_top @ proj_w + proj_b after every decoder step, fed back.
// fused_encode_kernel replaces
//   longterm360fov_tpu/ops/fused_lstm.py::fused_encode / _encode_kernel:
// the same encoder phase over xs (B, T, D), returning only the final
// top-layer h (B, H). Nothing is saved per step (the peer encoder of the
// cross_user family at serving time: B·K rows).
// fused_serve_kernel<false, float> given states also replaces
//   longterm360fov_tpu/ops/fused_lstm.py::fused_decode / _decode_kernel:
// the decoder phase alone, started from given h0, c0 (L, B, H) and y0
// (B, D), with an optional static context (seq2seq.decode_fused). The same
// instance runs it, so the decoder loop is the serve kernel's, registers
// and all; the only new code loads the states, h0 into z and c0 into the
// lanes' slots of every warp tile.
// lstm_cell_kernel<ST> replaces
//   longterm360fov_tpu/ops/fused_lstm.py::fused_lstm_cell / _cell_kernel:
// one layer-step of B rows, x, h, c, W and b stored in ST (f32, or bf16 on a
// bf16 model, whose h and c it writes in bf16 too) (the cell="pallas" path: 60 launches a
// seq2seq-tf-30 request). One step has no recurrence to keep on chip, so a
// block holds a tile of rows and of units, not every unit: both tiers run
// lstm_mma.cuh's cell_step on a grid of row tiles and unit blocks, W read
// as stored and kept in shared memory over many row tiles where it fits
// (else streamed beside z), z = [x | h] streamed through a cp.async ring,
// the f32 tier's products in three-pass TF32 and the bf16 tier's on bf16
// mma.sync; it takes every hidden and D_in (lstm_mma.cuh says what bounds
// it and what its design does about that).
// Inputs are read and outputs written in the caller's batch-major layout; a
// ragged last block is masked.
//
// What bounds them on the card:
//   * Arithmetic. Every layer-step is a (R x in+H) @ (in+H x 4H) product:
//     2.1 TFLOP per serve call at B = 262144, D = 3, H = 128, 30 + 30 steps,
//     L = 1. In exact f32 on the FMA units (67 TFLOP/s) that is 31.6 ms;
//     the static context adds C k-rows to the decoder's layer 0 (C = 128:
//     1.5x the decoder's layer-0 work). The encode kernel at the crossuser
//     peer rows (262,144 = 65,536 viewers x 4 peers, T = 30, L = 1) is 1.06
//     TFLOP: 15.7 ms on the FMA units, 6.4 ms in three-pass TF32.
//   * Weight traffic. One layer's W is (3 + 128) x 512 x 4 = 268 KB in f32,
//     more than the 227 KB of shared memory a block can have, so W is read
//     from L2 every layer-step.
//   * The cell's exact f32 sigmoids and tanhs, and the recurrence: the
//     steps are serial inside a block.
// What the design does about it: the serve kernel, the peer context and the
// encode kernel run on the tensor cores in both tiers (lstm_mma.cuh's server
// and encoder): the bf16 tier on bf16 mma.sync, the f32 tier in three-pass
// TF32, which keeps 22 bits an operand and sums in f32, at 495 / 3 TFLOP/s
// instead of the FMA units' 67. A warp tile holds all four gates of its (row, unit)
// pairs, so the cell runs on the accumulators in registers; c stays in the
// lanes' slots through both phases; z, a block row of [x or y | ctx | h of
// every layer], is the products' A in shared memory. fused_encode_kernel
// <float> is the f32 peer context's body without the context: 64-row blocks
// of 16 warps (ops/fused_lstm.py encode_tf32_rows), W packed once a call and
// streamed from L2, the unrounded top-layer h written from z at the end.
// The lockstep-peer tier (preset stacked-ss-crossuser-10s): at decoder step
// t, K peer LSTM cells (hidden C, from zero state) advance one step on the
// peers' known future windows, and ctx_t = Σ_k w_k · h_k,t is step t's
// context. The TPU kernel kept all K peers' h and c beside the decoder in one
// block. Here that is 2·K·C floats a viewer row on top of the decoder's
// 2·L·H + D + C (7 KB on 2.5 KB at K = 7, C = H = 128), which would cut a
// block to 16 rows and 64 threads. The peer chains never read the decoder,
// so the tier is two launches instead:
//   * peer_context_kernel runs the peer cells over the B·K peer rows, the
//     fused_encode way (a block holds all K peers of RV viewers, so the
//     masked mean is a block-local sum in a fixed order) and writes ctx_t
//     (B, T_out, C) f32 for every step: 3.4 GB at B = 65536, about 2 ms of
//     device-memory traffic written and read;
//   * fused_serve_kernel<true> copies ctx_t+1 into z's context columns
//     during step t's products (cp.async) instead of once. The per-step
//     load is a template parameter, so the static tier's instance keeps its
//     registers.
// The bf16 compute tier (compute_dtype=bfloat16) is the compute type CT of
// compute_type.cuh, a template parameter of every kernel but the cell's:
//   * W and proj_w are read as bf16, rounded once per call by the wrapper;
//   * every activation that enters a product is rounded where it enters it:
//     the staged input x_t, the stored h of every layer (so the decoder's
//     seed h is the rounded encoder h), the static context, the first and
//     the fed-back y, the peers' inputs and h; the peer context
//     ctx_t = Σ_k w_k · h_k is summed from the unrounded peer h, as the TPU
//     kernel sums it in f32, and rounded only where the decoder's product
//     reads it;
//   * c, the peers' c, the gate sums, the biases, ctx_t and the written y
//     stay f32; fused_encode_kernel writes the rounded top-layer h, as the
//     TPU kernel reads it back from its bf16 buffer.
// Its two encoders, peer_context_kernel<__nv_bfloat16> and
// fused_encode_kernel<__nv_bfloat16>, run on the tensor cores
// (lstm_mma.cuh): many independent rows from zero state and no feedback,
// so a block's layer-step is one [in, h] (rows x k) · W (k x 4H) product on
// mma.sync m16n8k16 and the cell update on its accumulators. What bounds
// them on Hopper is then no longer the products (about 2 µs a step of a
// block of 64 rows at mma.sync's rate) but the cell's exact f32 sigmoids
// and tanhs on the FMA and MUFU units (about 3 µs; on the card 55 % of a
// step, the products 30 %) and the recurrence (two barriers a
// layer-step). The packed bf16 W stays resident in shared memory where it
// fits beside the block's state (the timed shapes' 144 KB), and streams
// from L2 every step where it does not. The rounding points map onto the
// fragments as the writes into the bf16 A buffer: x_t and each layer's new
// h are rounded as they are stored there, the f32 h of the peer rows is
// staged apart for ctx_t, and c and the accumulators stay f32 in the
// lanes. The serve kernel's bf16 instances run the same pieces through both
// phases (lstm_mma.cuh's server: the encoder, then the decoder with its
// feedback y on the FMA units and, in the lockstep tier, ctx_t by cp.async
// during the products), and the cell kernel runs its one step on the tensor
// cores in both tiers (lstm_mma.cuh's cell_step).

#include "compute_type.cuh"
#include "lstm_mma.cuh"

#define MAX_LAYERS 8

template <typename CT>
struct Weights {
  const CT* w_enc[MAX_LAYERS];     // (in_l + H, 4H), gate order i, f, g, o
  const float* b_enc[MAX_LAYERS];  // (4H,)
  const CT* w_dec[MAX_LAYERS];
  const float* b_dec[MAX_LAYERS];
  const CT* proj_w;     // (H, D)
  const float* proj_b;  // (D,)
};

// h0 == nullptr: the serve kernel, the encoder over past (B, T_in, D) from
// zero state, then the decoder. h0, c0 (L, B, H) given (the f32 tier only):
// the decode kernel (fused_decode), the decoder alone from those states,
// with past = y0 as (B, 1, D). Both tiers are lstm_mma.cuh's server (every
// layer's W of a phase packed in w_enc[0], w_dec[0]; the block's shape in
// geo): the f32 tier on three-pass TF32 in 64- or 32-row tiles (geo.mt 4
// or 2) of 8 warps with STEP_CTX, else 32 x 8 tiles (2) of 16 warps
// (lstm_mma.cuh's BodyTile), the bf16 tier on bf16 mma in 32- or 16-row
// tiles (2 or 1).
template <bool STEP_CTX, typename CT>
__global__ void __launch_bounds__(std::is_same<CT, float>::value && STEP_CTX ? 256 : 512)
    fused_serve_kernel(const float* __restrict__ past, const float* __restrict__ ctx, float* __restrict__ out,
                       const Weights<CT> wts, int B, int T_in, int T_out, int D, int C, int H, int L,
                       const float* __restrict__ h0, const float* __restrict__ c0, const lstm_mma::Geom geo) {
  const uint4* we = reinterpret_cast<const uint4*>(wts.w_enc[0]);
  const uint4* wd = reinterpret_cast<const uint4*>(wts.w_dec[0]);
  if constexpr (std::is_same<CT, float>::value && STEP_CTX) {
    using P = lstm_mma::Tf32Mma;
    if (geo.mt == 4)
      lstm_mma::server<P, 4, true>(past, ctx, out, we, wd, wts.b_enc, wts.b_dec, wts.proj_w, wts.proj_b, B, T_in,
                                   T_out, D, C, H, L, geo, h0, c0);
    else
      lstm_mma::server<P, 2, true>(past, ctx, out, we, wd, wts.b_enc, wts.b_dec, wts.proj_w, wts.proj_b, B, T_in,
                                   T_out, D, C, H, L, geo, h0, c0);
  } else if constexpr (std::is_same<CT, float>::value) {
    lstm_mma::server<lstm_mma::Tf32Mma, 2, false>(past, ctx, out, we, wd, wts.b_enc, wts.b_dec, wts.proj_w,
                                                  wts.proj_b, B, T_in, T_out, D, C, H, L, geo, h0, c0);
  } else {
    using P = lstm_mma::Bf16Mma;
    if (geo.mt == 2)
      lstm_mma::server<P, 2, STEP_CTX>(past, ctx, out, we, wd, wts.b_enc, wts.b_dec, wts.proj_w, wts.proj_b, B, T_in,
                                       T_out, D, C, H, L, geo);
    else
      lstm_mma::server<P, 1, STEP_CTX>(past, ctx, out, we, wd, wts.b_enc, wts.b_dec, wts.proj_w, wts.proj_b, B, T_in,
                                       T_out, D, C, H, L, geo);
  }
}

// One LSTM step (fused_lstm_cell) for the block's rows and units: x (B,
// Din), h and c (B, H) in, h and c out, every tensor stored in ST;
// lstm_mma.cuh's cell_step on the grid (row tiles of `rows`, unit blocks of
// `units`; with W resident, w_res, a block takes every gridDim.x-th row
// tile): f32 in three-pass TF32, bf16 on bf16 mma.sync.
template <typename ST>
__global__ void __launch_bounds__(lstm_mma::CELL_THREADS)
    lstm_cell_kernel(const ST* __restrict__ x, const ST* __restrict__ h, const ST* __restrict__ c,
                     const ST* __restrict__ w, const ST* __restrict__ b, ST* __restrict__ h_out,
                     ST* __restrict__ c_out, int B, int Din, int H, int rows, int units, int w_res) {
  using P = std::conditional_t<std::is_same<ST, float>::value, lstm_mma::Tf32Mma, lstm_mma::Bf16Mma>;
  lstm_mma::cell_step<P>(x, h, c, w, b, h_out, c_out, B, Din, H, rows, units, w_res);
}

// The lockstep peer encoders of the serve tier: one LSTM cell of hidden C
// (wts.w_enc[0] (D + C, 4C) packed, from zero state) over the B·K peer rows
// of pxs (B·K, T, D), peer row p = b·K + k. A block holds all K peers of RV
// viewers (R = RV·K rows, contiguous from b0·K, padded to whole tiles), so
// after every step ctx_t[b] = Σ_k pwt[b, k] · h_k,t (k = 0 .. K - 1 in
// order, from the f32 h, unrounded in the bf16 tier too) is a block-local
// sum; it is written to ctx (B, T, C) in f32. Both tiers are lstm_mma.cuh's
// encoder (the block's shape in geo): f32 on three-pass TF32 in 32 x 8
// tiles, bf16 on bf16 mma in 32- or 16-row tiles; 16 warps.
template <typename CT>
__global__ void __launch_bounds__(512)
    peer_context_kernel(const float* __restrict__ pxs, const float* __restrict__ pwt, float* __restrict__ ctx,
                        const Weights<CT> wts, int B, int K, int T, int D, int C, int RV, const lstm_mma::Geom geo) {
  const uint4* w = reinterpret_cast<const uint4*>(wts.w_enc[0]);
  const long long p0 = (long long)blockIdx.x * RV * K;
  if constexpr (std::is_same<CT, float>::value) {
    lstm_mma::encoder<lstm_mma::Tf32Mma, 2, true>(pxs, pwt, ctx, w, wts.b_enc, p0, B * K, RV * K, T, D, C, 1, K, RV,
                                                  B, geo);
  } else {
    using P = lstm_mma::Bf16Mma;
    if (geo.mt == 2)
      lstm_mma::encoder<P, 2, true>(pxs, pwt, ctx, w, wts.b_enc, p0, B * K, RV * K, T, D, C, 1, K, RV, B, geo);
    else
      lstm_mma::encoder<P, 1, true>(pxs, pwt, ctx, w, wts.b_enc, p0, B * K, RV * K, T, D, C, 1, K, RV, B, geo);
  }
}

// The f32 peer context with its staging of h in device memory (geo.h_glob):
// one viewer's rows past what a block's shared memory holds beside z (at
// C = 128, from 208 rows). A kernel of its own, so that peer_context_kernel
// keeps its staging addressed as shared memory and its registers.
__global__ void __launch_bounds__(512)
    peer_context_glob_kernel(const float* __restrict__ pxs, const float* __restrict__ pwt, float* __restrict__ ctx,
                             const Weights<float> wts, int B, int K, int T, int D, int C, int RV,
                             const lstm_mma::Geom geo) {
  const long long p0 = (long long)blockIdx.x * RV * K;
  lstm_mma::encoder<lstm_mma::Tf32Mma, 2, true, void, true>(pxs, pwt, ctx, reinterpret_cast<const uint4*>(wts.w_enc[0]),
                                                            wts.b_enc, p0, B * K, RV * K, T, D, C, 1, K, RV, B, geo);
}

// Both tiers are lstm_mma.cuh's encoder (every layer's W packed in
// wts.w_enc[0], one array; the block's shape in geo): the f32 tier on
// three-pass TF32 in 32 x 8 tiles of up to 16 warps, W streamed, returning
// the unrounded f32 top-layer h; the bf16 tier on bf16 mma in 32- or 16-row
// tiles, returning the rounded h.
template <typename CT>
__global__ void __launch_bounds__(512)
    fused_encode_kernel(const float* __restrict__ xs, float* __restrict__ out, const Weights<CT> wts, int B, int T,
                        int D, int H, int L, const lstm_mma::Geom geo) {
  const uint4* w = reinterpret_cast<const uint4*>(wts.w_enc[0]);
  const long long p0 = (long long)blockIdx.x * geo.rp;
  if constexpr (std::is_same<CT, float>::value) {
    lstm_mma::encoder<lstm_mma::Tf32Mma, 2, false>(xs, nullptr, out, w, wts.b_enc, p0, B, geo.rp, T, D, H, L, 1, 1,
                                                   B, geo);
  } else {
    using P = lstm_mma::Bf16Mma;
    if (geo.mt == 2)
      lstm_mma::encoder<P, 2, false>(xs, nullptr, out, w, wts.b_enc, p0, B, geo.rp, T, D, H, L, 1, 1, B, geo);
    else
      lstm_mma::encoder<P, 1, false>(xs, nullptr, out, w, wts.b_enc, p0, B, geo.rp, T, D, H, L, 1, 1, B, geo);
  }
}

// The pointer arrays (null for an absent part) as the kernels' Weights<CT>.
template <typename CT>
static Weights<CT> weights(const void* const* w_enc, const void* const* b_enc,
                           const void* const* w_dec, const void* const* b_dec,
                           const void* proj_w, const void* proj_b,
                           int layers) {
  Weights<CT> w = {};
  for (int l = 0; l < layers; ++l) {
    if (w_enc) w.w_enc[l] = static_cast<const CT*>(w_enc[l]);
    if (b_enc) w.b_enc[l] = static_cast<const float*>(b_enc[l]);
    if (w_dec) w.w_dec[l] = static_cast<const CT*>(w_dec[l]);
    if (b_dec) w.b_dec[l] = static_cast<const float*>(b_dec[l]);
  }
  w.proj_w = static_cast<const CT*>(proj_w);
  w.proj_b = static_cast<const float*>(proj_b);
  return w;
}

// A block's tiles of the tier P (lstm_mma.cuh's BodyTile): 32- or 16-row
// tiles (mt 2 or 1) of up to 16 warps in bf16, W resident or streamed; in
// f32 W streamed (product_tf32 reads it through the read-only path), the
// lockstep serve kernel (step_ctx) in 64- or 32-row tiles (mt 4 or 2) of
// up to 8 warps, the others in 32-row tiles of up to 16
template <typename P>
static bool takes_block(int rp, int mt, int warps, int w_res, bool step_ctx) {
  const bool f32 = std::is_same<P, lstm_mma::Tf32Mma>::value;
  const bool tiles = f32 ? !w_res && (step_ctx ? (mt == 4 || mt == 2) && warps <= 8 : mt == 2)
                         : mt == 2 || mt == 1;
  return tiles && rp >= 16 * mt && rp % (16 * mt) == 0 && warps >= 1 && warps <= 16;
}

// The dynamic shared memory of an encoder block of the tier P (lstm_mma.cuh):
// rp rows, `rows` of them real, `warps` warps, W resident (w_res) or
// streamed, c in shared memory (c_glob null) or in c_glob; -1 for a shape
// the kernels do not take.
template <typename P>
static long long mma_smem(bool peer, int rp, int rows, int d, int hidden, int layers, int mt, int warps,
                          int w_res, const void* c_glob, const void* h_glob = nullptr) {
  if (!takes_block<P>(rp, mt, warps, w_res, false) || rows < 1 || rows > rp || hidden < 32 || hidden % 32 || d < 1 ||
      layers < 1 ||
      layers > MAX_LAYERS)
    return -1;
  const long long s =
      lstm_mma::smem_bytes<P>(peer, rp, rows, d, hidden, layers, w_res, c_glob == nullptr, h_glob == nullptr);
  return s > lstm_mma::SMEM_LIMIT ? -1 : s;
}

// Set the kernel's dynamic shared memory and launch it on (grid, threads).
template <typename Kernel, typename... Args>
static int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                  void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a serve block of the tier P (lstm_mma.cuh's
// server): rp rows, `warps` warps, W resident (w_res) or streamed, c in
// shared memory (c_glob null) or in c_glob; -1 for a shape it does not take
// (the context in whole k16 steps in bf16, whole 16-byte pieces in f32).
template <typename P>
static long long serve_mma_smem(int rp, int d, int ctx_dim, int hidden, int layers, int mt, int warps, int w_res,
                                const void* c_glob, bool step_ctx) {
  const int ctx_step = std::is_same<P, lstm_mma::Bf16Mma>::value ? 16 : 4;
  if (!takes_block<P>(rp, mt, warps, w_res, step_ctx) || hidden < 32 || hidden % 32 || d < 1 ||
      d > lstm_mma::SERVE_MAX_D ||
      ctx_dim < 0 || ctx_dim % ctx_step || layers < 1 || layers > MAX_LAYERS)
    return -1;
  const long long s =
      lstm_mma::serve_smem_bytes<P>(rp, d, ctx_dim, hidden, layers, w_res, c_glob == nullptr, step_ctx);
  return s > lstm_mma::SMEM_LIMIT ? -1 : s;
}

// Launch the serve kernel of the tier CT at a block shape that
// serve_mma_smem takes; h0, c0 given: the decoder alone (f32).
template <typename CT>
static int launch_serve(const void* past, const void* ctx, void* out, const Weights<CT>& wts, int batch, int t_in,
                        int t_out, int d, int ctx_dim, int hidden, int layers, int rows, int step_ctx, int mt,
                        int warps, int w_res, void* c_glob, const void* h0, const void* c0, void* stream) {
  using P = std::conditional_t<std::is_same<CT, float>::value, lstm_mma::Tf32Mma, lstm_mma::Bf16Mma>;
  const long long smem = serve_mma_smem<P>(rows, d, ctx_dim, hidden, layers, mt, warps, w_res, c_glob, step_ctx);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const lstm_mma::Geom geo{rows, mt, w_res, static_cast<float*>(c_glob)};
#define SERVE(STEP)                                                                                            \
  launch(fused_serve_kernel<STEP, CT>, (batch + rows - 1) / rows, 32 * warps, (size_t)smem, stream,             \
         static_cast<const float*>(past), static_cast<const float*>(ctx), static_cast<float*>(out), wts, batch,  \
         t_in, t_out, d, ctx_dim, hidden, layers, static_cast<const float*>(h0), static_cast<const float*>(c0), \
         geo)
  return step_ctx ? SERVE(true) : SERVE(false);
#undef SERVE
}

// xs (batch, t_len, d) → out (batch, hidden). w[0] holds every layer's W
// packed in one array (ops/fused_lstm.py pack_weights_tf32 in f32,
// pack_weights in bf16), b `layers` pointers; `rows` = rp rows a block in
// tiles of 16·mt, `warps` warps, W resident (w_res, bf16 only) or streamed, c
// in shared memory or in c_glob (grid x layers x rp x hidden floats;
// lstm_mma.cuh).
template <typename CT>
static int launch_encode(const void* xs, void* out, const void* const* w, const void* const* b, int batch, int t_len,
                         int d, int hidden, int layers, int rows, int mt, int warps, int w_res, void* c_glob,
                         void* stream) {
  using P = std::conditional_t<std::is_same<CT, float>::value, lstm_mma::Tf32Mma, lstm_mma::Bf16Mma>;
  const long long smem =
      batch < 1 || t_len < 1 ? -1 : mma_smem<P>(false, rows, rows, d, hidden, layers, mt, warps, w_res, c_glob);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  Weights<CT> wts = weights<CT>(nullptr, b, nullptr, nullptr, nullptr, nullptr, layers);
  wts.w_enc[0] = static_cast<const CT*>(w[0]);
  return launch(fused_encode_kernel<CT>, (batch + rows - 1) / rows, 32 * warps, (size_t)smem, stream,
                static_cast<const float*>(xs), static_cast<float*>(out), wts, batch, t_len, d, hidden, layers,
                lstm_mma::Geom{rows, mt, w_res, static_cast<float*>(c_glob)});
}

extern "C" {

// Each function launches its kernel on `stream` and returns
// cudaGetLastError() (0 = ok). The pointer arrays hold `layers` device
// pointers each; `rows` is the batch rows per block. With `bf16` set, the
// weight matrices (W, proj_w)
// are bf16 and the products run in the bf16 compute tier; biases,
// activations and outputs are f32 in both tiers.

// ctx is null when ctx_dim == 0; the decoder's layer-0 W is then (d +
// hidden, 4 * hidden), else (d + ctx_dim + hidden, 4 * hidden). ctx is
// (batch, ctx_dim), or, with step_ctx, (batch, t_out, ctx_dim): the
// lockstep-peer tier's per-step context. w_enc[0] and w_dec[0] hold every
// layer's W of the phase packed in one array (ops/fused_lstm.py
// pack_weights_tf32 in f32, pack_weights in bf16); `rows` = rp rows a block
// in tiles of 16·mt, `warps` warps, W resident (w_res) or streamed, c in
// shared memory or in c_glob (grid x layers x rp x hidden floats;
// lstm_mma.cuh's server); d <= 4; ctx_dim % 4 == 0 in f32, % 16 in bf16.
int fused_serve_launch(const void* past, const void* ctx, void* out,
                       const void* const* w_enc, const void* const* b_enc,
                       const void* const* w_dec, const void* const* b_dec,
                       const void* proj_w, const void* proj_b, int batch,
                       int t_in, int t_out, int d, int ctx_dim, int hidden,
                       int layers, int rows, int step_ctx, int bf16, int mt,
                       int warps, int w_res, void* c_glob, void* stream) {
  if (batch < 1 || t_in < 1 || t_out < 1 || ctx_dim < 0 || (ctx_dim > 0) != (ctx != nullptr) ||
      (step_ctx && ctx_dim == 0) || layers < 1 || layers > MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    Weights<__nv_bfloat16> wts = weights<__nv_bfloat16>(nullptr, b_enc, nullptr, b_dec, proj_w, proj_b, layers);
    wts.w_enc[0] = static_cast<const __nv_bfloat16*>(w_enc[0]);
    wts.w_dec[0] = static_cast<const __nv_bfloat16*>(w_dec[0]);
    return launch_serve(past, ctx, out, wts, batch, t_in, t_out, d, ctx_dim, hidden, layers, rows, step_ctx, mt,
                        warps, w_res, c_glob, nullptr, nullptr, stream);
  }
  Weights<float> wts = weights<float>(nullptr, b_enc, nullptr, b_dec, proj_w, proj_b, layers);
  wts.w_enc[0] = static_cast<const float*>(w_enc[0]);
  wts.w_dec[0] = static_cast<const float*>(w_dec[0]);
  return launch_serve(past, ctx, out, wts, batch, t_in, t_out, d, ctx_dim, hidden, layers, rows, step_ctx, mt, warps,
                      w_res, c_glob, nullptr, nullptr, stream);
}

// The dynamic shared memory of a serve block at the given shape
// (lstm_mma::serve_smem_bytes) in bf16 and in f32, bytes
long long fused_serve_smem_bytes(int rows, int d, int ctx_dim, int hidden, int layers, int w_res, int c_smem,
                                 int step_ctx) {
  return lstm_mma::serve_smem_bytes<lstm_mma::Bf16Mma>(rows, d, ctx_dim, hidden, layers, w_res, c_smem, step_ctx);
}
long long fused_serve_tf32_smem_bytes(int rows, int d, int ctx_dim, int hidden, int layers, int w_res, int c_smem,
                                      int step_ctx) {
  return lstm_mma::serve_smem_bytes<lstm_mma::Tf32Mma>(rows, d, ctx_dim, hidden, layers, w_res, c_smem, step_ctx);
}

// The dynamic shared memory of a peer-context block at the given shape
// (lstm_mma::smem_bytes of the tier), bytes
long long peer_context_smem_bytes(int rp, int rows, int d, int ctx_dim, int w_res, int c_smem, int bf16, int h_smem) {
  return bf16 ? lstm_mma::smem_bytes<lstm_mma::Bf16Mma>(true, rp, rows, d, ctx_dim, 1, w_res, c_smem, h_smem)
              : lstm_mma::smem_bytes<lstm_mma::Tf32Mma>(true, rp, rows, d, ctx_dim, 1, w_res, c_smem, h_smem);
}

// The peer context of the lockstep tier: pxs (batch·n_peers, t_len, d), pwt
// (batch, n_peers), w (d + ctx_dim, 4·ctx_dim) packed (ops/fused_lstm.py
// pack_weights_tf32 in f32, pack_weights in bf16), b (4·ctx_dim,) → ctx
// (batch, t_len, ctx_dim). rows_v viewers a block, their rows padded to rp
// in tiles of 16·mt, `warps` warps, W resident in shared memory (w_res) or
// streamed, c in shared memory or, where c_glob is given, in c_glob (grid x
// rp x ctx_dim floats), the staging of h in shared memory or, where h_glob is
// given, in h_glob (grid x rows_v·n_peers x ctx_dim floats; lstm_mma.cuh).
int peer_context_launch(const void* pxs, const void* pwt, void* ctx,
                        const void* w, const void* b, int batch, int n_peers,
                        int t_len, int d, int ctx_dim, int rows_v, int bf16,
                        int rp, int mt, int warps, int w_res, void* c_glob,
                        void* h_glob, void* stream) {
  if (n_peers < 1 || rows_v < 1 || batch < 1 || t_len < 1 ||
      (long long)batch * n_peers * t_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int rows = rows_v * n_peers, grid = (batch + rows_v - 1) / rows_v;
  const lstm_mma::Geom geo{rp, mt, w_res, static_cast<float*>(c_glob), static_cast<float*>(h_glob)};
#define PEER(KERNEL, CT, P)                                                                                      \
  do {                                                                                                           \
    const long long smem = mma_smem<P>(true, rp, rows, d, ctx_dim, 1, mt, warps, w_res, c_glob, h_glob);         \
    if (smem < 0) return (int)cudaErrorInvalidValue;                                                             \
    return launch(KERNEL, grid, 32 * warps, (size_t)smem, stream, static_cast<const float*>(pxs),                \
                  static_cast<const float*>(pwt), static_cast<float*>(ctx),                                      \
                  weights<CT>(&w, &b, nullptr, nullptr, nullptr, nullptr, 1), batch, n_peers, t_len, d, ctx_dim, \
                  rows_v, geo);                                                                                  \
  } while (0)
  if (bf16 && h_glob) return (int)cudaErrorInvalidValue;  // the bf16 tier stages h in shared memory
  if (bf16) PEER(peer_context_kernel<__nv_bfloat16>, __nv_bfloat16, lstm_mma::Bf16Mma);
  if (h_glob) PEER(peer_context_glob_kernel, float, lstm_mma::Tf32Mma);
  PEER(peer_context_kernel<float>, float, lstm_mma::Tf32Mma);
#undef PEER
}

// The encoder (launch_encode above) in bf16 (`bf16`) or f32.
int fused_encode_launch(const void* xs, void* out, const void* const* w,
                        const void* const* b, int batch, int t_len, int d,
                        int hidden, int layers, int rows, int bf16, int mt,
                        int warps, int w_res, void* c_glob, void* stream) {
  const auto go = bf16 ? &launch_encode<__nv_bfloat16> : &launch_encode<float>;
  return go(xs, out, w, b, batch, t_len, d, hidden, layers, rows, mt, warps, w_res, c_glob, stream);
}

// The dynamic shared memory of an encoder block at the given shape
// (lstm_mma::smem_bytes of the tier), bytes
long long fused_encode_smem_bytes(int rp, int d, int hidden, int layers, int w_res, int c_smem, int bf16) {
  return bf16 ? lstm_mma::smem_bytes<lstm_mma::Bf16Mma>(false, rp, rp, d, hidden, layers, w_res, c_smem)
              : lstm_mma::smem_bytes<lstm_mma::Tf32Mma>(false, rp, rp, d, hidden, layers, w_res, c_smem);
}

// The decoder alone, in f32: h0, c0 (layers, batch, hidden), y0 (batch, d),
// ctx (batch, ctx_dim) or null when ctx_dim == 0, out (batch, t_out, d); the
// decoder's weights and the block's shape as in fused_serve_launch (the f32
// serve kernel from given states).
int fused_decode_f32(const void* h0, const void* c0, const void* y0, const void* ctx, void* out,
                     const void* const* w_dec, const void* const* b_dec, const void* proj_w, const void* proj_b,
                     int batch, int t_out, int d, int ctx_dim, int hidden, int layers, int rows, int mt, int warps,
                     int w_res, void* c_glob, void* stream) {
  if (batch < 1 || t_out < 1 || ctx_dim < 0 || (ctx_dim > 0) != (ctx != nullptr) || layers < 1 ||
      layers > MAX_LAYERS || h0 == nullptr || c0 == nullptr)
    return (int)cudaErrorInvalidValue;
  Weights<float> wts = weights<float>(nullptr, nullptr, nullptr, b_dec, proj_w, proj_b, layers);
  wts.w_dec[0] = static_cast<const float*>(w_dec[0]);
  // y0 is the kernel's past of one step
  return launch_serve(y0, ctx, out, wts, batch, 1, t_out, d, ctx_dim, hidden, layers, rows, 0, mt, warps, w_res,
                      c_glob, h0, c0, stream);
}

// One LSTM step: x (batch, d_in), h and c (batch, hidden), w (d_in + hidden,
// 4 * hidden), b (4 * hidden,) → h_out, c_out (batch, hidden), every tensor
// f32, or with `bf16` every tensor bf16; any d_in and hidden. Blocks of
// `rows` x `units`, W resident (w_res) or streamed (lstm_mma::cell_takes;
// ops/fused_lstm.py cell_block chooses lstm_mma::cell_block's), `grid_x`
// blocks of row tiles (1 .. the row tiles: the row tiles with W streamed),
// lstm_mma::cell_geom's warps and shared memory. c, w, b, h_out and c_out
// 16-byte aligned; x and h at any offset.
int lstm_cell_launch(const void* x, const void* h, const void* c, const void* w, const void* b, void* h_out,
                     void* c_out, int batch, int d_in, int hidden, int rows, int units, int w_res, int grid_x,
                     int bf16, void* stream) {
  if (batch < 1 || d_in < 1 || hidden < 1 || rows < 1 || units < 1 || (hidden + units - 1) / units > 65535 ||
      grid_x < 1 || grid_x > (batch + rows - 1) / rows)
    return (int)cudaErrorInvalidValue;
#define CELL(ST, P)                                                                                               \
  do {                                                                                                            \
    if (!lstm_mma::cell_takes<P>(rows, units, w_res, d_in, hidden)) return (int)cudaErrorInvalidValue;           \
    const lstm_mma::CellGeom g = lstm_mma::cell_geom<P>(rows, units, w_res, d_in, hidden);                      \
    return launch(lstm_cell_kernel<ST>, dim3(grid_x, (hidden + units - 1) / units), 32 * g.warps, (size_t)g.smem, \
                  stream, static_cast<const ST*>(x), static_cast<const ST*>(h), static_cast<const ST*>(c),        \
                  static_cast<const ST*>(w), static_cast<const ST*>(b), static_cast<ST*>(h_out),                  \
                  static_cast<ST*>(c_out), batch, d_in, hidden, rows, units, w_res);                             \
  } while (0)
  if (bf16) CELL(__nv_bfloat16, lstm_mma::Bf16Mma);
  CELL(float, lstm_mma::Tf32Mma);
#undef CELL
}

// The cell's block at (d_in, hidden) in the tier (lstm_mma::cell_block) →
// out: rows, units, warps, W resident, bytes of dynamic shared memory
void lstm_cell_block(int d_in, int hidden, int bf16, long long* out) {
  const lstm_mma::CellGeom g = bf16 ? lstm_mma::cell_block<lstm_mma::Bf16Mma>(d_in, hidden)
                                    : lstm_mma::cell_block<lstm_mma::Tf32Mma>(d_in, hidden);
  out[0] = g.rows, out[1] = g.units, out[2] = g.warps, out[3] = g.w_res, out[4] = g.smem;
}

// The probe build's sums (-DLSTM_PROBE; LstmPart order, LP_PARTS of them)
// into out, then zeroed; without LSTM_PROBE, zeros.
int fused_serve_probe_read(unsigned long long* out) { return probe_read(g_lstm_probe, out); }

const char* fused_serve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
