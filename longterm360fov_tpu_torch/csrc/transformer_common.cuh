// Device code shared by the transformer kernels (transformer_encode.cu,
// transformer_decode.cu), exact f32 on the FMA units: a block-wide product
// of 64 activation rows in shared memory with a weight matrix in device
// memory, the pre-LN layer norm, the tanh GELU, and one query row's 4-head
// attention as an online softmax.
//
// Both kernels hold 64 activation rows of width H = 128 in shared memory
// (token rows in the encoder, batch rows in the decoder):
//   xs  (64, LDX)  the residual stream x
//   hs  (64, LDX)  a layer norm's output, the input of the products
//   big (64, 528)  q, k, v and the attention output as four (64, LDX)
//                  buffers, or the MLP's hidden layer as one (64, LDU)
//   ws  (2, 8, 128) the two-stage ring of weight slabs of gemm64
// 210,944 bytes of the 227 KB a block may have. The row strides LDX = 132
// and LDU = 516 are 16-byte multiples whose rows r and r + 4 fall 16 banks
// apart, so the two distinct rows a warp reads in one product step do not
// conflict.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tfm {

constexpr int H = 128;        // model width: the kernels take hidden = 128 only
constexpr int HEADS = 4;      // 32-wide heads; a warp's lane l holds dims 4l..4l+3,
                              // so lanes 8n..8n+7 hold head n
constexpr int MLP = 4 * H;    // MLP hidden width
constexpr int ROWS = 64;      // activation rows a block holds
constexpr int THREADS = 256;  // 16 x 16 threads of 4 rows x 8 columns in a product
constexpr int LDX = H + 4;
constexpr int LDU = MLP + 4;
constexpr int BIG = ROWS * (MLP + 16);  // >= 4 * ROWS * LDX and >= ROWS * LDU
constexpr int KS = 8;                  // k rows of W a stage of gemm64's ring
constexpr int WSTAGE = KS * 128;       // floats of one stage: KS x 128 columns
constexpr int WS_FLOATS = 2 * WSTAGE;  // the two stages of the ring
constexpr int SMEM_FLOATS = 2 * ROWS * LDX + BIG + WS_FLOATS;  // xs, hs, big, ws
constexpr float SCALE = 0.17677669529663687f;  // 1 / sqrt(head width 32)
constexpr unsigned FULL = 0xffffffffu;

static_assert(4 * ROWS * LDX <= BIG && ROWS * LDU <= BIG, "big buffer too small");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void zero_smem(float* s, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = 0.f;
}

// Copies of 16 bytes from device to shared memory that do not wait:
// cp.async on the card (the emulation for checking the logic on a CPU
// copies at once).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#else
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::);
#endif
}

// out = A · W[:, n0 : n0 + 128] for the block's 64 rows: A (64, K) in shared
// memory with row stride lda (K a multiple of KS); W (K, ldw) row-major in
// device memory. Every block reads the same matrices, so they stay in L2;
// KS x 128 slabs of W go through a two-stage ring in shared memory (ws,
// WS_FLOATS floats), the next slab copied by cp.async while the block
// computes on the current one, so no thread waits on L2 inside the k loop.
// Thread (rg, cg) = (tid / 16, tid % 16) accumulates rows 4·rg..4·rg+3 x
// columns n0 + 8·cg..+7 over k in order, one fmaf a term, and hands its
// 4 x 8 sums to epi(r0, c0, acc) with c0 the absolute column. Block-wide:
// every thread of the block calls it, and it synchronizes the block.
template <typename Epi>
__device__ __forceinline__ void gemm64(const float* A, int lda, int K,
                                       const float* __restrict__ W, int ldw,
                                       int n0, float* ws, Epi epi) {
  const int r0 = (threadIdx.x >> 4) * 4;
  const int cl = (threadIdx.x & 15) * 8;  // column within the 128
  // the stage copy: thread t moves float4 t of the KS x 128 slab
  const int cp_row = threadIdx.x >> 5, cp_col = (threadIdx.x & 31) * 4;
  const float* wsrc = W + (size_t)cp_row * ldw + n0 + cp_col;
  float* wdst = ws + cp_row * 128 + cp_col;
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  const int stages = K / KS;
  cp_async16(wdst, wsrc);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s landed for every thread; stage s - 1 is free
    if (s + 1 < stages) {
      cp_async16(wdst + ((s + 1) & 1) * WSTAGE, wsrc + (size_t)(s + 1) * KS * ldw);
      cp_async_commit();
    }
    const float* wk = ws + (s & 1) * WSTAGE + cl;
    const int k0 = s * KS;
#pragma unroll
    for (int kq = 0; kq < KS; kq += 4) {
      float a[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(A + (r0 + r) * lda + k0 + kq);
        a[r][0] = v.x;
        a[r][1] = v.y;
        a[r][2] = v.z;
        a[r][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w0 = *reinterpret_cast<const float4*>(wk + (kq + kk) * 128);
        const float4 w1 = *reinterpret_cast<const float4*>(wk + (kq + kk) * 128 + 4);
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r][kk], w[c], acc[r][c]);
      }
    }
  }
  __syncthreads();  // every thread is done with the ring before the next product fills it
  epi(r0, n0 + cl, acc);
}

// Y[r] = (X[r] - mean) · 1/sqrt(var + 1e-6) · scale + bias for every row r
// of the block (a warp a row), with the population variance, as the
// models' _ln. X and Y have row stride LDX.
__device__ __forceinline__ void layer_norm(const float* X, float* Y,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  const float4 s = __ldg(reinterpret_cast<const float4*>(scale) + lane);
  const float4 b = __ldg(reinterpret_cast<const float4*>(bias) + lane);
  for (int r = threadIdx.x >> 5; r < ROWS; r += THREADS / 32) {
    const float4 x = *reinterpret_cast<const float4*>(X + r * LDX + 4 * lane);
    const float mu = warp_sum((x.x + x.y) + (x.z + x.w)) / (float)H;
    const float4 d = make_float4(x.x - mu, x.y - mu, x.z - mu, x.w - mu);
    const float var = warp_sum((d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w)) / (float)H;
    const float inv = 1.0f / sqrtf(var + 1e-6f);
    *reinterpret_cast<float4*>(Y + r * LDX + 4 * lane) =
        make_float4(d.x * inv * s.x + b.x, d.y * inv * s.y + b.y,
                    d.z * inv * s.z + b.z, d.w * inv * s.w + b.w);
  }
}

// jax.nn.gelu's tanh form, with the accurate tanhf
__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x))));
}

// One query row's 4-head attention, by one warp: lane l holds q, the
// running output and the key/value dims 4l..4l+3; lanes 8n..8n+7 hold head
// n, whose logit is their 8-lane sum. An online softmax: m the running max
// of the head's logits, l the sum of exp(logit - m), acc the sum of
// exp(logit - m) · v. A masked token is skipped, which is what its -1e9
// logit gives (exp underflows to exactly 0) whenever a token is attended.
struct Attend {
  float4 q;
  float m, l;
  float4 acc;
  bool any;  // a token was attended

  __device__ __forceinline__ void init(float4 q_) {
    q = q_;
    m = -INFINITY;
    l = 0.f;
    acc = make_float4(0.f, 0.f, 0.f, 0.f);
    any = false;
  }

  // k and v are the lane's dims of one token; warp-uniform calls only
  __device__ __forceinline__ void add(float4 k, float4 v) {
    float s = (q.x * k.x + q.y * k.y) + (q.z * k.z + q.w * k.w);
    s += __shfl_xor_sync(FULL, s, 4);
    s += __shfl_xor_sync(FULL, s, 2);
    s += __shfl_xor_sync(FULL, s, 1);
    s *= SCALE;
    const float mn = fmaxf(m, s);
    const float corr = expf(m - mn);  // 0 for the first token (m = -inf)
    const float p = expf(s - mn);
    l = l * corr + p;
    acc = make_float4(acc.x * corr + p * v.x, acc.y * corr + p * v.y,
                      acc.z * corr + p * v.z, acc.w * corr + p * v.w);
    m = mn;
    any = true;
  }

  // Tokens j0 <= j < j1 of K and V (row stride ld floats), those whose
  // valid[j] is non-zero when valid is given, kAhead at a time so that their
  // loads are in flight together (device memory: 8 tokens, 8 KB a warp).
  // Kernel-read-only memory (kReadOnly) goes through the read-only path; the
  // decode's self cache, written by the kernel, does not.
  template <bool kReadOnly, int kAhead>
  __device__ __forceinline__ void range(const float* K, const float* V, size_t ld,
                                        int j0, int j1, const unsigned char* valid) {
    const int lane = threadIdx.x & 31;
    for (int j = j0; j < j1; j += kAhead) {
      float4 kk[kAhead], vv[kAhead];
      bool ok[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int jj = j + u;
        ok[u] = jj < j1 && (valid == nullptr || valid[jj] != 0);
        if (ok[u]) {
          const float4* kp = reinterpret_cast<const float4*>(K + jj * ld) + lane;
          const float4* vp = reinterpret_cast<const float4*>(V + jj * ld) + lane;
          kk[u] = kReadOnly ? __ldg(kp) : *kp;
          vv[u] = kReadOnly ? __ldg(vp) : *vp;
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (ok[u]) add(kk[u], vv[u]);
    }
  }

  // the normalized output for the lane's dims; zeros when nothing was
  // attended (the models gate such a peer position to exactly 0)
  __device__ __forceinline__ float4 out() const {
    if (!any) return make_float4(0.f, 0.f, 0.f, 0.f);
    return make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
  }
};

}  // namespace tfm
