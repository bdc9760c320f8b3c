// Transformer encoder kernel for Hopper (sm_90a), exact f32.
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
// What bounds it on the card. Operations: 12·H² MACs a token-layer for the
// projections and the MLP, and 2·T·H for the attention: 24.6 MFLOP a viewer
// at T = 30, L = 2, 0.40 TFLOP at B = 16384, 6.0 ms at the 67 TFLOP/s f32
// FMA peak. Its bytes (past in, enc_mem out: 1.5 KB + 15 KB a viewer) take
// 0.08 ms. The weights (4·H² + 8·H² floats a layer, 768 KB) are read by
// every block and stay in L2.
//
// What the design does about it. A block holds 64 token rows: the T tokens
// of R = 64 / T viewers (R = 2 at T = 30: 60 rows), so one weight element
// read from L2 feeds 64 FMAs. The residual stream, the LN output and q, k,
// v, the attention output or the MLP hidden layer all sit in shared memory
// (transformer_common.cuh); between layers nothing goes to device memory.
// Every product is gemm64: 256 threads of 4 rows x 8 columns, f32 FMAs in
// k order, the weights streamed through a two-stage cp.async ring in shared
// memory. The attention is a warp a query row (all 4 heads: 8 lanes a
// head) over its viewer's T key rows in shared memory, an online softmax.
// The kernel takes T <= 64 (one viewer's tokens in one block), the JAX
// routing threshold; the wrapper raises above it.

#include "transformer_common.cuh"

#define MAX_LAYERS 8

namespace {

using namespace tfm;

// a layer's weights: ln1 scale and bias, wq, wk, wv, wo (H, H), ln2 scale and
// bias, w1 (H, 4H), b1 (4H,), w2 (4H, H), b2 (H,)
enum EncPtr { LN1_S, LN1_B, WQ, WK, WV, WO, LN2_S, LN2_B, W1, B1, W2, B2, ENC_PTRS };

struct EncParams {
  const float* layer[MAX_LAYERS][ENC_PTRS];
  const float* w_in;  // (d, H)
  const float* pos;   // (t, H) positional encoding
};

__global__ void __launch_bounds__(THREADS, 1)
encode_tokens_kernel(const EncParams p, const float* __restrict__ past,
                     float* __restrict__ enc, int batch, int layers, int t,
                     int d, int seqs) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* hs = xs + ROWS * LDX;
  float* big = hs + ROWS * LDX;
  float* qb = big;
  float* kb = big + ROWS * LDX;
  float* vb = big + 2 * ROWS * LDX;
  float* ab = big + 3 * ROWS * LDX;
  float* ws = big + BIG;  // gemm64's ring of weight slabs
  const int b0 = blockIdx.x * seqs;
  const int n_tok = min(seqs, batch - b0) * t;  // valid token rows
  const size_t tok0 = (size_t)b0 * t;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  zero_smem(xs, SMEM_FLOATS);
  __syncthreads();
  // x = past · in_proj + pos
  for (int e = threadIdx.x; e < n_tok * H; e += THREADS) {
    const int m = e / H, n = e - m * H;
    const float* xp = past + (tok0 + m) * d;
    float acc = xp[0] * __ldg(p.w_in + n);
    for (int i = 1; i < d; ++i) acc = fmaf(xp[i], __ldg(p.w_in + i * H + n), acc);
    xs[m * LDX + n] = acc + __ldg(p.pos + (m % t) * H + n);
  }
  __syncthreads();

  for (int l = 0; l < layers; ++l) {
    const float* const* w = p.layer[l];
    layer_norm(xs, hs, w[LN1_S], w[LN1_B]);
    __syncthreads();
    auto store_to = [](float* dst) {
      return [dst](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float* o = dst + (r0 + r) * LDX + c0;
          *reinterpret_cast<float4*>(o) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          *reinterpret_cast<float4*>(o + 4) = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
        }
      };
    };
    gemm64(hs, LDX, H, w[WQ], H, 0, ws, store_to(qb));
    gemm64(hs, LDX, H, w[WK], H, 0, ws, store_to(kb));
    gemm64(hs, LDX, H, w[WV], H, 0, ws, store_to(vb));
    __syncthreads();
    // bidirectional attention: a warp a query row, over its viewer's t keys
    for (int m = warp; m < n_tok; m += THREADS / 32) {
      const int first = (m / t) * t;
      Attend a;
      a.init(*reinterpret_cast<const float4*>(qb + m * LDX + 4 * lane));
      a.range<false, 4>(kb + first * LDX, vb + first * LDX, LDX, 0, t, nullptr);
      *reinterpret_cast<float4*>(ab + m * LDX + 4 * lane) = a.out();
    }
    __syncthreads();
    auto add_to_x = [xs](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) xs[(r0 + r) * LDX + c0 + c] += acc[r][c];
    };
    gemm64(ab, LDX, H, w[WO], H, 0, ws, add_to_x);
    __syncthreads();
    layer_norm(xs, hs, w[LN2_S], w[LN2_B]);
    __syncthreads();
    // u = gelu(h · W1 + b1), 128 columns a pass, into big (q, k, v, a are dead)
    const float* b1 = w[B1];
    auto gelu_to_u = [big, b1](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          big[(r0 + r) * LDU + c0 + c] = gelu_tanh(acc[r][c] + __ldg(b1 + c0 + c));
    };
    for (int n0 = 0; n0 < MLP; n0 += H) gemm64(hs, LDX, H, w[W1], MLP, n0, ws, gelu_to_u);
    __syncthreads();
    const float* b2 = w[B2];
    auto mlp_to_x = [xs, b2](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) xs[(r0 + r) * LDX + c0 + c] += acc[r][c] + __ldg(b2 + c0 + c);
    };
    gemm64(big, LDU, MLP, w[W2], H, 0, ws, mlp_to_x);
    __syncthreads();
  }
  // enc_mem rows out, a warp a row
  for (int m = warp; m < n_tok; m += THREADS / 32)
    reinterpret_cast<float4*>(enc + (tok0 + m) * H)[lane] =
        *reinterpret_cast<const float4*>(xs + m * LDX + 4 * lane);
}

}  // namespace

extern "C" {

// One launch on `stream`: grid ceil(batch / (64 / t)) blocks of 256
// threads, 210,944 bytes of dynamic shared memory. past (batch, t, d) and
// enc (batch, t, 128) f32; layer_ptrs holds 12 device pointers a layer in
// EncPtr's order; pos (t, 128). Returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a shape the kernel does not take.
int transformer_encode_f32(const void* past, void* enc, const void* const* layer_ptrs,
                           const void* w_in, const void* pos, int batch, int layers,
                           int t, int d, void* stream) {
  if (batch < 1 || layers < 1 || layers > MAX_LAYERS || t < 1 || t > ROWS || d < 1)
    return (int)cudaErrorInvalidValue;
  EncParams p = {};
  for (int l = 0; l < layers; ++l)
    for (int i = 0; i < ENC_PTRS; ++i)
      p.layer[l][i] = static_cast<const float*>(layer_ptrs[l * ENC_PTRS + i]);
  p.w_in = static_cast<const float*>(w_in);
  p.pos = static_cast<const float*>(pos);
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      encode_tokens_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int seqs = ROWS / t;
  const int grid = (batch + seqs - 1) / seqs;
  encode_tokens_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(past), static_cast<float*>(enc), batch, layers, t,
      d, seqs);
  return (int)cudaGetLastError();
}

const char* transformer_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
