// Transformer autoregressive-decode kernel for Hopper (sm_90a), in two
// tiers, exact f32 and bf16 (the JAX package's default on its
// accelerator): no peers, per-row peer K/V, and group-shared peer K/V with
// the per-row anchor correction δv; peer_pool "none" or "mean" and an
// optional peer window in each.
//
// Replaces the TPU Pallas kernel of
//   longterm360fov_tpu/ops/transformer_decode.py::fused_ar_decode
//   (_decode_kernel; the group-shared tier attend_peer_shared and
//   attend_peer_shared_windowed, and attp - dv_ref[l])
// which runs the whole rollout in one launch: per step t and layer l,
//   x += Wo·attend(q, self K/V cache)       q, k, v = LN1(x)·Wq, Wk, Wv;
//                                            k, v appended at row t
//   x += Wo_c·attend(LN2(x)·Wq_c, cross K/V) over the T_in encoder tokens
//   x += Wo_p·attend(LN3(x)·Wq_p, peer K/V)  over the valid peer tokens
//                                            (|t_k - t| <= w when windowed),
//                                            0 where there is none
//   x += W2·gelu(W1·LN4(x) + b1) + b2
// then y = LN_f(x)·Wout + bout, written out and fed back as the next token
// (x = y·in_proj + pos[t + 1]). The cross and peer K/V are projected
// outside, once (the wrapper's torch.matmul, as JAX's project_kv). On the
// TPU all caches stay resident in ~100 MB of VMEM for the rollout.
//
// What bounds it on the card (transformer-30: L = 2, H = 128, T_in = T_out
// = 30, K = 4 peers: K·T = 120 peer tokens):
//   * Operations: 16·H² MACs a row-layer-step for the products and about
//     42 K for the attention: 36.5 MFLOP a row, 0.60 TFLOP at B = 16384.
//   * Bytes: the K/V the rollout reads, counted once, is 5.0 GB at
//     B = 16384 in f32 (1.5 ms at 3.35 TB/s). But the caches do not fit on
//     chip: per row and layer the peer K/V is 123 KB, the cross K/V 31 KB,
//     the self K/V 31 KB in f32, 370 KB a row over two layers against 227 KB
//     of shared memory a block. They live in device memory, and every step
//     re-reads them: about 160 GB at B = 16384 in f32 (about 49 ms at
//     3.35 TB/s), half that in bf16. Both tiers' bodies are up against that
//     re-read.
// What the design does about it, in both tiers (transformer_decode_mma.cuh
// for bf16, transformer_decode_f32mma.cuh for f32):
//   * A block of 16 warps holds 64 batch rows' activations in shared memory,
//     or 32 where 64-row blocks would leave SMs idle (the wrapper chooses,
//     ops/transformer_decode.py decode_rows), and runs every product of a
//     step on mma.sync: bf16 operands, or f32 operands as three passes of
//     TF32; the 2.1 MB of decoder weights stay in L2 and stream through a
//     ring in shared memory in a fixed order across the attention, the
//     layers and the steps, one block barrier a chunk.
//   * The attention is a warp a query row, each half-warp on its own
//     tokens, a lane 8 dims of a token in 16-byte loads, several tokens a
//     half-warp scored before one rescale of the online softmax. Masked
//     peer tokens and those outside the window are not read: the work
//     follows the data. A position with no attendable peer token adds
//     exactly 0, as the model's per-position gate does.
//   * The self cache (2, L, B, T_out, H) is written at row t and read at
//     rows < t only, so the wrapper allocates it uninitialized; the current
//     token's k, v come from shared memory.
// The group-shared tier (peer_gid given): co-batched viewers of one video
// attend the same K peer tracks, so the wrapper projects the peer K/V once
// a group, (G, KT, H), and row b reads group peer_gid[b]'s K/V and
// validity. The TPU kernel reads the group id once a 128-row tile and
// needs group-pure tiles (the batch sorted and each group padded to a tile
// multiple); here it is read per row, so any order is right and nothing is
// padded. With peer_dv (B, L, H), the peer-attend output of row b at layer
// l less peer_dv[b, l] goes through Wo_p: the row's anchor shift of the
// peer tokens, which softmax cancels in K and which the weights, summing to
// 1, carry into V as a constant. A position with no attendable token still
// adds exactly 0. What it changes in the bound (transformer-10s: L = 2,
// 100 + 100 steps, K = 4, window 8, G = 8 at B = 4096): the peer K/V is
// 410 KB a row-layer per row (3.4 GB at B = 4096) but 6.6 MB in all when
// shared, which the 50 MB L2 holds, and the wrapper's peer K/V products
// shrink from 0.43 TFLOP to G rows. The cross and self K/V that every step
// re-reads (about 130 GB at B = 4096) still come from device memory: the
// shared tier is up against the same re-read as the per-row one, less the
// peer share.
// The bf16 tier (transformer_decode_bf16) is the TPU kernel's
// compute_dtype=bfloat16 arithmetic, not its layout: the matrices, the
// cross and peer K/V (projected outside from bf16 operands, stored in bf16,
// as JAX's project_kv) and the self cache in bf16; every product's
// activation operand rounded to bf16 where it is written (the LN outputs,
// the attention outputs less δv, the GELU output, the fed-back y), f32
// sums; LN, softmax, q, GELU, δv and the residual stream in f32. It halves
// the K/V bytes that bound the per-row tier. The f32 tier
// (transformer_decode_f32) keeps 22 significant bits of each product
// operand and sums in f32: within 3e-5 of the exact-f32 plain version over
// 100 + 100-step rollouts (chip_smoke.py).
// The JAX shared tier rounds q and the softmax weights to bf16 for its MXU
// products; here every tier attends with f32 q and weights.
// A probe build (-DTFM_PROBE) splits each block's clocks by part
// (transformer_probe.cuh's DecPart), read by transformer_decode_probe_read.
// Later work (not here): keeping a block's K/V on chip across steps.

#include <type_traits>

#include "transformer_decode_f32mma.cuh"

namespace {

using namespace tfm;

// T: the stored type of the matrices, the cross and peer K/V and the self
// cache (f32: decode_rows_tf32; bf16: decode_rows_mma); R: the rows of a
// block, 64 or 32
template <typename T, int R>
__global__ void __launch_bounds__(MMA_THREADS, 1)
ar_decode_kernel(const DecParams p, const DecArgs g, T* self_kv) {
  extern __shared__ float4 smem4[];
  if constexpr (std::is_same<T, float>::value)
    dec::decode_rows_tf32<R>(p, g, self_kv, reinterpret_cast<float*>(smem4));
  else
    dec::decode_rows_mma<R>(p, g, self_kv, reinterpret_cast<unsigned char*>(smem4));
}

// dynamic shared memory of a block of the tier of T at R rows, bytes
template <typename T, int R>
constexpr int smem_bytes() {
  return std::is_same<T, float>::value ? dec::F32Shape<R>::SMEM : dec::Shape<R>::SMEM;
}

template <typename T, int R>
int launch_rows(const DecParams& p, const DecArgs& g, void* self_kv, cudaStream_t stream) {
  const int smem = smem_bytes<T, R>();
  cudaError_t err = cudaFuncSetAttribute(ar_decode_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ar_decode_kernel<T, R><<<(g.batch + R - 1) / R, MMA_THREADS, smem, stream>>>(p, g, static_cast<T*>(self_kv));
  return (int)cudaGetLastError();
}

// One launch on `stream`: grid ceil(batch / rows) blocks of `rows` = 64 or
// 32 rows (any other value is refused), 512 threads; f32 210,944 or
// 125,952 bytes of dynamic shared memory, bf16 223,232 or 146,432. y0
// (batch, d) f32, peer_valid (batch, kt) bytes (0 = masked; null when
// kt = 0), self_kv (2, layers, batch, t_out, 128) scratch, out (batch,
// t_out, d) f32; layer_ptrs holds 24 device pointers a layer in DecPtr's
// order (the peer ones null when kt = 0). Group-shared peers: peer_gid
// (batch,) int32 row → group in [0, G), and the peer K, V (G, kt, 128) and
// peer_valid (G, kt) hold the G groups'; peer_dv (batch, layers, 128) f32
// or null. window <= 0: no peer window; else token i of the peer memory is
// attended at step t when |i % seg - t| <= window. In the f32 tier every
// tensor is f32 and the matrices' slots (the self, cross and peer wq, wk,
// wv, wo as the table lists them, w1, w2) hold Wᵀ; in the bf16 tier the
// matrices, w_in, w_out, the cross and peer K, V and self_kv are bf16, the
// rest f32. Returns cudaGetLastError() (0 = ok), or cudaErrorInvalidValue
// for a shape the kernel does not take.
template <typename T>
int launch(const void* y0, const void* peer_valid, const void* peer_gid, const void* peer_dv,
           void* self_kv, void* out, const void* const* layer_ptrs, const void* w_in,
           const void* w_out, const void* b_out, const void* fln_s, const void* fln_b,
           const void* pos, int batch, int layers, int t_in, int t_out, int d, int kt,
           int window, int seg, int rows, void* stream) {
  if (batch < 1 || layers < 1 || layers > MAX_LAYERS || t_in < 1 || t_out < 1 || d < 1 ||
      d > MAX_D || kt < 0 || (kt > 0 && (peer_valid == nullptr || seg < 1)) ||
      ((peer_gid != nullptr || peer_dv != nullptr) && kt == 0) || (peer_dv != nullptr && peer_gid == nullptr) ||
      (rows != 64 && rows != 32))
    return (int)cudaErrorInvalidValue;
  DecParams p = {};
  for (int l = 0; l < layers; ++l)
    for (int i = 0; i < DEC_PTRS; ++i)
      p.layer[l][i] = static_cast<const float*>(layer_ptrs[l * DEC_PTRS + i]);
  p.w_in = static_cast<const float*>(w_in);
  p.w_out = static_cast<const float*>(w_out);
  p.b_out = static_cast<const float*>(b_out);
  p.fln_s = static_cast<const float*>(fln_s);
  p.fln_b = static_cast<const float*>(fln_b);
  p.pos = static_cast<const float*>(pos);
  const DecArgs g = {static_cast<const float*>(y0), static_cast<const unsigned char*>(peer_valid),
                     static_cast<const int*>(peer_gid), static_cast<const float*>(peer_dv),
                     static_cast<float*>(out), batch, layers, t_in, t_out, d, kt, window, seg};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rows == 64 ? launch_rows<T, 64>(p, g, self_kv, st) : launch_rows<T, 32>(p, g, self_kv, st);
}

}  // namespace

extern "C" {

// The f32 and bf16 tiers, in blocks of `rows` (64 or 32) rows:
// ops/transformer_decode.py decode_rows chooses them from the batch.
int transformer_decode_f32(const void* y0, const void* peer_valid, const void* peer_gid,
                           const void* peer_dv, void* self_kv, void* out,
                           const void* const* layer_ptrs, const void* w_in, const void* w_out,
                           const void* b_out, const void* fln_s, const void* fln_b,
                           const void* pos, int batch, int layers, int t_in, int t_out, int d,
                           int kt, int window, int seg, int rows, void* stream) {
  return launch<float>(y0, peer_valid, peer_gid, peer_dv, self_kv, out, layer_ptrs, w_in, w_out, b_out,
                       fln_s, fln_b, pos, batch, layers, t_in, t_out, d, kt, window, seg, rows, stream);
}

int transformer_decode_bf16(const void* y0, const void* peer_valid, const void* peer_gid,
                            const void* peer_dv, void* self_kv, void* out,
                            const void* const* layer_ptrs, const void* w_in, const void* w_out,
                            const void* b_out, const void* fln_s, const void* fln_b,
                            const void* pos, int batch, int layers, int t_in, int t_out, int d,
                            int kt, int window, int seg, int rows, void* stream) {
  return launch<__nv_bfloat16>(y0, peer_valid, peer_gid, peer_dv, self_kv, out, layer_ptrs, w_in, w_out,
                               b_out, fln_s, fln_b, pos, batch, layers, t_in, t_out, d, kt, window, seg, rows,
                               stream);
}

// the dynamic shared memory of a block at `rows` rows (64 or 32; else -1)
// in the bf16 tier (`bf16` set) or the f32 tier, bytes
int transformer_decode_smem_bytes(int rows, int bf16) {
  if (rows != 64 && rows != 32) return -1;
  if (bf16) return rows == 32 ? smem_bytes<__nv_bfloat16, 32>() : smem_bytes<__nv_bfloat16, 64>();
  return rows == 32 ? smem_bytes<float, 32>() : smem_bytes<float, 64>();
}

const char* transformer_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The probe build's clock counters (tfm::DecPart order, tfm::DEC_PARTS of
// them) since the last read, summed over blocks, into out (host memory);
// zeroes them. Without TFM_PROBE, zeros.
int transformer_decode_probe_read(unsigned long long* out) { return probe_read(tfm::g_dec_probe, out); }

}  // extern "C"
