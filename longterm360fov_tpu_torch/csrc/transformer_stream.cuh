// The bf16 products of the transformer kernels on the tensor cores, shared
// by the encoder's bf16 tier (transformer_mma.cuh, 64 token rows a block)
// and the decode's (transformer_decode_mma.cuh, 64 or 32 batch rows a
// block), both 512 threads, 16 warps:
//   * WeightStream<Order>: the weight stream. A kernel's products read their
//     matrices in a fixed order (Order::source: the encoder's 12 chunks a
//     layer, the decode's 16 or 14 a layer-step), cut into chunks of KC =
//     128 k-rows x 128 columns (32 KB of bf16) that go through a ring of
//     STAGES = 2 stages by cp.async, the next chunk in flight while the
//     block computes on one, also across the attention and the layer norms.
//   * gemm_mma<R>: out[R, 128] = A[R, K] · W[K, n0 : n0 + 128], A bf16 in
//     shared memory, on mma.sync m16n8k16 with f32 accumulators; warp w owns
//     the 16 x TN tile at rows 16·(w % (R / 16)), columns TN·(w / (R / 16))
//     (TN = 32 at 64 rows, 16 at 32): per 16 k-rows one ldmatrix of A and
//     TN / 16 ldmatrix.trans of W (read as stored, (K, N) row-major), the
//     next 16 k-rows' fragments loading during the mma. One block barrier a
//     chunk. The epilogue hands each thread's f32 sums, two columns at a
//     time, to a callback.
//   * layer_norm_bf16<R>: LN of the block's f32 rows, stored in bf16 (the A
//     operand of the next product).
// The bf16 row strides LDB = 136 and LDUB = 520 (272 and 1,040 bytes, 16
// more than a multiple of 128) put the 8 rows that one ldmatrix tile reads
// on distinct banks.

#pragma once

#include "tensor_core.cuh"
#include "transformer_common.cuh"
#include "transformer_probe.cuh"

namespace tfm {

using bf16 = __nv_bfloat16;

constexpr int MMA_THREADS = 512;
constexpr int MMA_WARPS = MMA_THREADS / 32;
constexpr int LDB = H + 8;       // bf16 row stride of an A buffer and of a ring stage
constexpr int LDUB = MLP + 8;    // bf16 row stride of the MLP's hidden layer u
constexpr int KC = 128;          // k-rows of W a chunk
constexpr int STAGES = 2;        // chunks of the ring
constexpr int CHUNK = KC * LDB;  // bf16 elements of a stage

// The weight stream: chunk g (Order::source(g, ldw): its first k-row of W,
// as the products read it, and W's row stride) goes to ring stage
// g % STAGES; issue() copies the next chunk (an empty group past the last),
// so that a chunk's group is always STAGES - 1 groups back.
template <typename Order>
struct WeightStream {
  Order order;
  int total;  // chunks of the kernel
  bf16* ring;
  int next;   // the chunk issue() copies

  __device__ __forceinline__ void issue() {
    if (next < total) {
      int ldw;
      const bf16* src = order.source(next, ldw);
      bf16* dst = ring + (next % STAGES) * CHUNK;
      // KC rows x 128 columns: 16 pieces of 16 bytes a row
#pragma unroll
      for (int i = threadIdx.x; i < KC * 16; i += MMA_THREADS) {
        const int r = i >> 4, c = (i & 15) * 8;
        cp_async16(dst + r * LDB + c, src + (size_t)r * ldw + c);
      }
    }
    cp_async_commit();
    ++next;
  }
};

// out = A · W[:, n0 : n0 + 128] for the block's R rows, W the next K / KC
// chunks of the weight stream; A (R, K) bf16 in shared memory, row stride
// lda. epi(row, col, v0, v1) receives the f32 sums of columns col and
// col + 1 (col absolute, even). Block-wide: every thread calls it; it waits
// at one barrier a chunk, which also orders the writes of A before it. The
// probe marks its chunk waits, its mma loops and its epilogue as the
// caller's parts wait_part, mma_part and epi_part.
template <int R, typename Stream, typename Epi>
__device__ __forceinline__ void gemm_mma(const bf16* A, int lda, int K, int n0, Stream& ws, Probe& pr,
                                         int wait_part, int mma_part, int epi_part, Epi epi) {
  static_assert(R == 64 || R == 32, "64 or 32 rows a block");
  constexpr int TN = R == 64 ? 32 : 16;  // columns a warp
  constexpr int NP = TN / 16;            // pairs of n8 tiles a warp
  static_assert(MMA_WARPS == (R / 16) * (H / TN), "a warp a 16 x TN tile of a product");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp % (R / 16)) * 16, wn = (warp / (R / 16)) * TN;
  float acc[2 * NP][4];
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // ldmatrix addresses: A tiles (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15),
  // (8-15, 8-15); W tiles (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
  // (k 8-15, n 8-15)
  const bf16* a_lane = A + (wm + (lane & 15)) * lda + (lane >> 4) * 8;
  const int w_lane = (lane & 15) * LDB + wn + (lane >> 4) * 8;
  unsigned a[2][4], b[2][NP][4];  // [k-step parity]: the next k-step's fragments load during this one's mma
  auto load = [&](int buf, const bf16* a_k, const bf16* w_k) {
    ldsm_x4(a[buf], a_k);
#pragma unroll
    for (int np = 0; np < NP; ++np) ldsm_x4_trans(b[buf][np], w_k + np * 16);
  };
  for (int k0 = 0; k0 < K; k0 += KC) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // the chunk landed for every thread; the stage before it is free
    pr.mark(wait_part);
    const bf16* wsm = ws.ring + ((ws.next - (STAGES - 1)) % STAGES) * CHUNK + w_lane;
    ws.issue();
    load(0, a_lane + k0, wsm);
#pragma unroll
    for (int s = 0; s < KC / 16; ++s) {
      const int cur = s & 1;
      if (s + 1 < KC / 16) load(cur ^ 1, a_lane + k0 + (s + 1) * 16, wsm + (s + 1) * 16 * LDB);
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        mma_bf16(acc[2 * np], a[cur], b[cur][np][0], b[cur][np][1]);
        mma_bf16(acc[2 * np + 1], a[cur], b[cur][np][2], b[cur][np][3]);
      }
    }
    pr.mark(mma_part);
  }
  // accumulator nt: rows lane / 4 and + 8, columns 2 · (lane % 4) + 0, 1
#pragma unroll
  for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      epi(wm + (lane >> 2) + 8 * h, n0 + wn + nt * 8 + 2 * (lane & 3), acc[nt][2 * h], acc[nt][2 * h + 1]);
  pr.mark(epi_part);
}

// Y[r] = LN(X[r]) rounded to bf16 for every row r of the block's R (a warp
// a row): layer_norm<bf16>'s arithmetic, stored in bf16 with row stride LDB
template <int R>
__device__ __forceinline__ void layer_norm_bf16(const float* X, bf16* Y, const float* __restrict__ scale,
                                                const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  const float4 s = __ldg(reinterpret_cast<const float4*>(scale) + lane);
  const float4 b = __ldg(reinterpret_cast<const float4*>(bias) + lane);
#pragma unroll
  for (int i = 0; i < R / MMA_WARPS; ++i) {  // a warp's rows at once: their reductions interleave
    const int r = (threadIdx.x >> 5) + i * MMA_WARPS;
    const float4 x = *reinterpret_cast<const float4*>(X + r * LDX + 4 * lane);
    const float mu = warp_sum((x.x + x.y) + (x.z + x.w)) / (float)H;
    const float4 d = make_float4(x.x - mu, x.y - mu, x.z - mu, x.w - mu);
    const float var = warp_sum((d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w)) / (float)H;
    const float inv = 1.0f / sqrtf(var + 1e-6f);
    *reinterpret_cast<uint2*>(Y + r * LDB + 4 * lane) =
        make_uint2(Store<bf16>::pack(d.x * inv * s.x + b.x, d.y * inv * s.y + b.y),
                   Store<bf16>::pack(d.z * inv * s.z + b.z, d.w * inv * s.w + b.w));
  }
}

}  // namespace tfm
