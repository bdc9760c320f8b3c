// Device code shared by the transformer kernels (transformer_decode.cu,
// and in part the encoder's: transformer_encode.cu,
// transformer_encode_train.cu), f32 arithmetic on the FMA units: the
// decoder's block-wide product (gemm64) of 64 activation rows in shared
// memory with a weight matrix in device memory, the pre-LN layer norm, the
// tanh GELU, and one query row's 4-head attention as an online softmax.
// The encoder's products run on the tensor cores (transformer_f32mma.cuh,
// transformer_mma.cuh) and use the constants, Store<T> and gelu_tanh here.
//
// Two tiers, by the type T the weights and K/V are stored in (Store<T>):
// float, exact f32; and __nv_bfloat16, the JAX bf16 tier's arithmetic: the
// operands of every product rounded to bf16 (the weights stored so, the
// activations rounded where they are written: layer_norm<T>, the attention
// output, the GELU output), products summed in f32; LN, softmax, GELU and
// the residual stream in f32. A bf16 value is exact in f32, so each
// product term is the exact product of the two rounded operands.
//
// The decoder holds 64 batch rows of width H = 128 in shared memory:
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

#include <cuda_bf16.h>
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

// Loads and stores of the stored type T as f32 values: 4 consecutive
// elements (a lane's dims of a token row) or 8 (a thread's columns of a
// weight slab in shared memory), and the rounding to T.
template <typename T>
struct Store;

template <>
struct Store<float> {
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
  template <bool kReadOnly>
  static __device__ __forceinline__ float4 load4(const float* p) {
    const float4* q = reinterpret_cast<const float4*>(p);
    return kReadOnly ? __ldg(q) : *q;
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
    const float4 w0 = *reinterpret_cast<const float4*>(p);
    const float4 w1 = *reinterpret_cast<const float4*>(p + 4);
    w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
    w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
  }
};

template <>
struct Store<__nv_bfloat16> {
  // a pair of bf16 in 32 bits, the first in the low half: widening to f32
  // is a shift, exact
  static __device__ __forceinline__ float lo(unsigned u) { return __uint_as_float(u << 16); }
  static __device__ __forceinline__ float hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }
  static __device__ __forceinline__ unsigned pack(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&v);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float ldg1(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  template <bool kReadOnly>
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    const uint2 u = kReadOnly ? __ldg(q) : *q;
    return make_float4(lo(u.x), hi(u.x), lo(u.y), hi(u.y));
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack(v.x, v.y), pack(v.z, v.w));
  }
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&w)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = lo(u.x); w[1] = hi(u.x); w[2] = lo(u.y); w[3] = hi(u.y);
    w[4] = lo(u.z); w[5] = hi(u.z); w[6] = lo(u.w); w[7] = hi(u.w);
  }
};

// a float4 of activations rounded to T, kept in f32
template <typename T>
__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(Store<T>::round(v.x), Store<T>::round(v.y), Store<T>::round(v.z),
                     Store<T>::round(v.w));
}

// a pointer of a kernel's pointer table (kept as const float*) to a matrix
// stored in T
template <typename T>
__device__ __forceinline__ const T* as(const float* p) {
  return reinterpret_cast<const T*>(p);
}

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
template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src) {
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

// every group but the newest N complete
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// out = A · W[:, n0 : n0 + 128] for the block's 64 rows: A (64, K) in shared
// memory with row stride lda (K a multiple of the stage's k rows); W (K,
// ldw) row-major in device memory, stored in T. Every block reads the same
// matrices, so they stay in L2; slabs of W (KS x 128 floats, or 2·KS x 128
// bf16: 4 KB either way) go through a two-stage ring in shared memory (ws,
// WS_FLOATS floats), the next slab copied by cp.async while the block
// computes on the current one, so no thread waits on L2 inside the k loop.
// Thread (rg, cg) = (tid / 16, tid % 16) accumulates rows 4·rg..4·rg+3 x
// columns n0 + 8·cg..+7 over k in order, one fmaf a term, and hands its
// 4 x 8 sums to epi(r0, c0, acc) with c0 the absolute column. Block-wide:
// every thread of the block calls it, and it synchronizes the block.
template <typename T, typename Epi>
__device__ __forceinline__ void gemm64(const float* A, int lda, int K,
                                       const T* __restrict__ W, int ldw,
                                       int n0, float* ws, Epi epi) {
  constexpr int EPC = 16 / sizeof(T);            // elements of one 16-byte copy
  constexpr int KST = THREADS * EPC / 128;       // k rows a stage: KS for f32
  constexpr int STAGE = KST * 128;               // elements a stage
  static_assert(STAGE * sizeof(T) == WSTAGE * sizeof(float), "a stage is 4 KB");
  const int r0 = (threadIdx.x >> 4) * 4;
  const int cl = (threadIdx.x & 15) * 8;  // column within the 128
  // the stage copy: thread t moves 16-byte piece t of the stage's slab
  const int cp_row = threadIdx.x / (128 / EPC), cp_col = (threadIdx.x % (128 / EPC)) * EPC;
  const T* wsrc = W + (size_t)cp_row * ldw + n0 + cp_col;
  T* wring = reinterpret_cast<T*>(ws);
  T* wdst = wring + cp_row * 128 + cp_col;
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  const int stages = K / KST;
  cp_async16(wdst, wsrc);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s landed for every thread; stage s - 1 is free
    if (s + 1 < stages) {
      cp_async16(wdst + ((s + 1) & 1) * STAGE, wsrc + (size_t)(s + 1) * KST * ldw);
      cp_async_commit();
    }
    const T* wk = wring + (s & 1) * STAGE + cl;
    const int k0 = s * KST;
#pragma unroll
    for (int kq = 0; kq < KST; kq += 4) {
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
        float w[8];
        Store<T>::load8(wk + (kq + kk) * 128, w);
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
// models' _ln; Y rounded to T, since it is a product's operand. X and Y
// have row stride LDX.
template <typename T = float>
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
        round4<T>(make_float4(d.x * inv * s.x + b.x, d.y * inv * s.y + b.y,
                              d.z * inv * s.z + b.z, d.w * inv * s.w + b.w));
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

  // Tokens j0 <= j < j1 of K and V (stored in T, row stride ld elements),
  // those whose valid[j] is non-zero when valid is given, kAhead at a time
  // so that their loads are in flight together (device memory: 8 tokens,
  // 8 KB a warp in f32). Kernel-read-only memory (kReadOnly) goes through
  // the read-only path; the decode's self cache, written by the kernel,
  // does not.
  template <bool kReadOnly, int kAhead, typename T>
  __device__ __forceinline__ void range(const T* K, const T* V, size_t ld,
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
          kk[u] = Store<T>::template load4<kReadOnly>(K + jj * ld + 4 * lane);
          vv[u] = Store<T>::template load4<kReadOnly>(V + jj * ld + 4 * lane);
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
