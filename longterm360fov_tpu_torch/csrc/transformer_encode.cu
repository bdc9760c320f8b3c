// Transformer encoder kernel for Hopper (sm_90a), in two tiers: f32, and
// bf16 (the JAX package's default on its accelerator).
//
// Replaces the TPU Pallas kernel of
//   longterm360fov_tpu/ops/transformer_encode.py::fused_encode_tokens
//   (_encode_kernel)
// which, 128 viewers a grid step, computes feature-major on the TPU:
//   x = past_n · in_proj + pos_enc, then L pre-LN layers of
//   x += Wo · attend(LN1(x)) (4 heads, bidirectional over the T tokens) and
//   x += W2 · gelu(W1 · LN2(x) + b1) + b2
// → enc_mem (B, T, H = 128). The products run in its body, the attention on
// the VPU as broadcast multiplies and reductions.
//
// The f32 tier (transformer_encode_f32) is exact f32 as the TPU kernel's
// f32 tier computes it: lax.Precision.HIGHEST products, a multi-pass split
// on the TPU's matrix unit.
//
// What bounds it on the card. Operations: 12·H² MACs a token-layer for the
// projections and the MLP, and 2·T·H for the attention: at T = 30, L = 2
// and B = 16384, 0.387 TFLOP of products and 15 GFLOP of attention. The
// products are f32-accurate on the tensor cores as three-pass TF32: 2.35 ms
// at 495 / 3 TFLOP/s (the attention's 0.22 ms on the FMA units run beside
// them); on the FMA units alone they would take 6.0 ms at 67 TFLOP/s. Its
// bytes (past in, enc_mem out: 1.5 KB + 15 KB a viewer) take 0.08 ms. The
// weights (12·H² floats a layer, 768 KB) are read by every block and stay
// in L2.
//
// What the design does about it (encode_rows_tf32, transformer_f32mma.cuh).
// A block holds 64 token rows, the T tokens of R = 64 / T viewers (R = 2 at
// T = 30: 60 rows), and keeps the residual stream and every intermediate in
// shared memory: between layers nothing goes to device memory. Its six
// products run on mma.sync m16n8k8 TF32 in three passes (each operand split
// into hi and lo, the small terms first, each chunk's sums flushed into f32
// registers), 8 warps of 32 x 32 tiles; the weights stream from L2 in
// chunks of 32 k-columns, split once a block as they land, one barrier a
// chunk. q is written over the LN output, the attention output over q, and
// the MLP runs in 128-column slabs of its hidden layer, so that four
// activation buffers leave room for the split weights. The attention stays
// f32 on the FMA units, a thread a (row, head) with the head's 32 dims in
// registers, an online softmax over the viewer's T key rows. The kernel
// takes T <= 64 (one viewer's tokens in one block), the JAX routing
// threshold; the wrapper raises above it, and passes the matrices
// transposed (Wᵀ: each product stages its B operand k-contiguous). It runs
// at about 12 ms on an NVIDIA H100 80GB HBM3 at 700 W, where the FMA design
// took 24.0 and nn.TransformerEncoder (cuBLAS in exact f32) takes 17.7
// (PERF.md).
//
// What is left: the products run at under half of mma.sync's TF32 rate,
// their inner loop shared with the fragments' splitting and the weights'
// staging; the attention, GELU and layer norms on the FMA units are a
// fifth of the time. wgmma would read both operands from shared memory
// itself, but for TF32 it needs both k-major there: the activations as
// they are, the weights as Wᵀ chunks, each split into hi and lo planes in
// shared memory (no room beside four activation buffers at 64 rows); TMA
// multicast of the weight chunks across a cluster would cut the L2 reads.
//
// The bf16 tier (transformer_encode_bf16) is the TPU kernel's
// compute_dtype=bfloat16 arithmetic, not its layout: in_proj and the
// matrices stored in bf16, every product's activation operand rounded to
// bf16 where it is written, f32 sums; LN, softmax, GELU, q, k, v and the
// residual stream in f32. What bounds it on this card: its products, bf16
// by bf16 summed in f32, are tensor-core work, 0.39 TFLOP at B = 16384
// (T = 30, L = 2), 0.39 ms at the 989 TFLOP/s dense bf16 peak; the
// attention (2·T·H MACs a token-layer, 15 GFLOP) stays f32, 0.23 ms on the
// FMA units beside them; the bytes take 0.08 ms. An FMA design of this tier
// (the f32 tier's former FMA body on bf16 weights) ran at the f32 rate,
// 19.15 ms on an NVIDIA H100 80GB HBM3 at 700 W.
//
// What the design does about it (encode_rows_mma, transformer_mma.cuh): a
// block of 512 threads over the same 64 token rows; the six matrix
// products on mma.sync m16n8k16 (bf16 operands by ldmatrix from shared
// memory, f32 accumulators), the weights streamed in 128-row chunks through
// a two-stage cp.async ring with one barrier a chunk; the LN outputs, the
// attention output and the MLP's hidden layer stored in bf16 (half the
// bytes each operand load moves), the residual stream and q, k, v in f32;
// the attention two threads a (row, head). What is left: the ldmatrix
// traffic of 16 x 32 warp tiles (each W fragment read by four warps, each
// A fragment by four), the issue-bound attention and GELU on the FMA
// units, one block an SM (222 KB of shared memory); wgmma, which reads its
// operands from shared memory itself, and TMA multicast of the weights
// across a cluster are the next steps.

#include <type_traits>

#include "transformer_f32mma.cuh"
#include "transformer_mma.cuh"

namespace {

using namespace tfm;

// T: float, the f32 tier (encode_rows_tf32, transformer_f32mma.cuh);
// __nv_bfloat16, the bf16 tier (encode_rows_mma, transformer_mma.cuh)
template <typename T>
constexpr int block_threads() {
  return std::is_same<T, float>::value ? THREADS : MMA_THREADS;
}

template <typename T>
__global__ void __launch_bounds__(std::is_same<T, float>::value ? THREADS : MMA_THREADS, 1)
encode_tokens_kernel(const EncParams p, const float* __restrict__ past,
                     float* __restrict__ enc, int batch, int layers, int t,
                     int d, int seqs) {
  extern __shared__ float4 smem4[];
  if constexpr (std::is_same<T, float>::value)
    encode_rows_tf32<false>(p, past, enc, nullptr, batch, layers, t, d, seqs, reinterpret_cast<float*>(smem4));
  else
    encode_rows_mma(p, past, enc, batch, layers, t, d, seqs, reinterpret_cast<unsigned char*>(smem4));
}

// dynamic shared memory of a block of the tier's kernel, bytes
template <typename T>
constexpr int smem_bytes() {
  return std::is_same<T, float>::value ? F32_SMEM_FLOATS * (int)sizeof(float) : MMA_SMEM_BYTES;
}

template <typename T>
int launch(const void* past, void* enc, const void* const* layer_ptrs, const void* w_in,
           const void* pos, int batch, int layers, int t, int d, void* stream) {
  if (batch < 1 || layers < 1 || layers > MAX_LAYERS || t < 1 || t > ROWS || d < 1 ||
      (!std::is_same<T, float>::value && d > MMA_MAX_D))
    return (int)cudaErrorInvalidValue;
  EncParams p = {};
  for (int l = 0; l < layers; ++l)
    for (int i = 0; i < ENC_PTRS; ++i)
      p.layer[l][i] = static_cast<const float*>(layer_ptrs[l * ENC_PTRS + i]);
  p.w_in = static_cast<const float*>(w_in);
  p.pos = static_cast<const float*>(pos);
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      encode_tokens_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int seqs = ROWS / t;
  const int grid = (batch + seqs - 1) / seqs;
  encode_tokens_kernel<T><<<grid, block_threads<T>(), smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(past), static_cast<float*>(enc), batch, layers, t,
      d, seqs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch on `stream`: grid ceil(batch / (64 / t)) blocks of 256
// threads, 208,896 bytes of dynamic shared memory (the bf16 tier: 512
// threads, 222,208 bytes, d <= 64). past (batch, t, d) and enc (batch, t,
// 128) f32; layer_ptrs holds 12 device pointers a layer in EncPtr's order,
// the matrices' slots pointing at their transposes (Wq..Woᵀ, W1ᵀ (4H, H),
// W2ᵀ (H, 4H), each row-major); pos (t, 128). Returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a shape the kernel does not take.
int transformer_encode_f32(const void* past, void* enc, const void* const* layer_ptrs,
                           const void* w_in, const void* pos, int batch, int layers,
                           int t, int d, void* stream) {
  return launch<float>(past, enc, layer_ptrs, w_in, pos, batch, layers, t, d, stream);
}

// The bf16 tier: the same, with w_in and the matrices wq, wk, wv, wo, w1,
// w2 of every layer stored in bf16, as they are (W, not Wᵀ; the LN
// parameters and biases stay f32).
int transformer_encode_bf16(const void* past, void* enc, const void* const* layer_ptrs,
                            const void* w_in, const void* pos, int batch, int layers,
                            int t, int d, void* stream) {
  return launch<__nv_bfloat16>(past, enc, layer_ptrs, w_in, pos, batch, layers, t, d, stream);
}

// the dynamic shared memory of a block: f32 tier (bf16 = 0) or bf16 tier
int transformer_encode_smem_bytes(int bf16) {
  return bf16 ? smem_bytes<__nv_bfloat16>() : smem_bytes<float>();
}

const char* transformer_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef TFM_PROBE
// The probe build's clock counters (tfm::Part order, tfm::PARTS of them)
// since the last read, summed over blocks, into out (host memory); zeroes
// them. Returns cudaGetLastError()-style codes.
int transformer_encode_probe_read(unsigned long long* out) { return probe_read(tfm::g_probe, out); }
#endif

}  // extern "C"
