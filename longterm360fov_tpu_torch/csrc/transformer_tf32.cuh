// The three-pass TF32 products of the transformer kernels' f32 tiers on
// the tensor cores, shared by the encoder (rows 10 and 11:
// transformer_f32mma.cuh, 64 token rows a block of 8 warps) and the
// autoregressive decode (row 9: transformer_decode_f32mma.cuh, 64 or 32
// batch rows a block of 16 warps).
//
// Three passes. An f32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi) (cvt.rna: 11 significant bits each, 22 together); a product
// a · b is a_lo · b_hi + a_hi · b_lo + a_hi · b_hi, each on mma.sync
// m16n8k8 with f32 accumulators, the small terms first; a_lo · b_lo (2^-22
// of a · b) is dropped. The tensor cores round each mma's sum into the
// accumulator toward zero, so a product sums each chunk of KC k-rows in a
// fresh accumulator and adds it to an f32 register sum (round to nearest):
// a bias of at most 3 · KC / 8 truncations a chunk, not of every k-step of
// the product. A one-pass build (-DTFM_ONE_PASS) drops the small terms: its
// products keep 11 bits, and the card tests show that the gates tell it
// from three passes.
//
// The products. Every product is out[BR, 128] = A[BR, 128] · B[128, 128]
// (K = N = 128), A f32 in shared memory with row stride LDX, B a 128 x 128
// block of a weight matrix or of its transpose, tiled over the block's
// warps as Tiling<BR, NW> says (the encoder: warp w of 8 owns the 32 x 32
// tile at rows 32·(w % 2), columns 32·(w / 2)). Per 8 k-rows a warp loads
// its A fragments with one ldmatrix an m16 tile (a row of four f32 values
// is read as eight 16-bit ones: lane l gets row l / 4, column l % 4 of
// each 8 x 4 tile, the TF32 A layout) and splits them (reused over its
// n-tiles), loads the B fragments, already split, with two ldmatrix a pair
// of n-tiles, and issues three mma a tile pair. B reaches shared memory
// k-contiguous (Bᵀ, n rows of KC k values), so that its fragments load
// without a transpose: the forwards read Wᵀ, which the wrappers pass in
// the matrices' slots of the pointer table, and the encoder's reverse
// input-gradient products read W itself.
//
// The weight stream. Each kernel reads its 128 x 128 blocks of Bᵀ in a
// fixed order (Src), cut into chunks of KC k-columns x 128 rows. A chunk
// comes from L2 into registers (LOADS float4 a thread) one chunk ahead,
// and is split into hi and lo and stored in shared memory among the mma of
// the chunk before it: a ring of two stages of (hi, lo) planes, one block
// barrier a chunk.

#pragma once

#include "tensor_core.cuh"
#include "transformer_common.cuh"
#include "transformer_probe.cuh"

namespace tfm {

static_assert(THREADS == 256 && ROWS == 64 && H == 128, "rows 10 and 11 tile 64 x 128 over 8 warps");

// The warps' tiles of a product out[BR, 128] over NW warps: warp w owns
// the WM x WN tile at rows WM·(w % MB), columns WN·(w / MB), MI m16 tiles
// by NI n8 tiles. Rows 10 and 11 (64 rows, 8 warps): 32 x 32; the f32
// decode (transformer_decode_f32mma.cuh, 16 warps): 32 x 16 at 64 rows, 16
// x 16 at 32 (16 x 32 at 64 rows, which splits half as much of A, measured
// the same: PERF.md, row 9).
template <int BR, int NW>
struct Tiling {
  static constexpr int WM = (BR == 64) ? 32 : 16;  // rows a warp
  static constexpr int MI = WM / 16;
  static constexpr int MB = BR / WM;               // warps along the rows
  static constexpr int WN = H / (NW / MB);         // columns a warp
  static constexpr int NI = WN / 8;
  static_assert(MB * (H / WN) == NW && NI % 2 == 0 && (BR == 64 || BR == 32), "a warp a tile of whole n16 pairs");
};
using EncTiling = Tiling<ROWS, THREADS / 32>;  // rows 10 and 11

// the ring of split weight chunks of KC k-columns, filled by NT threads
template <int KC, int NT = THREADS>
struct Ring {
  static constexpr int DEPTH = KC;
  static constexpr int LDW = KC + 4;       // floats a row (n) of a plane: ldmatrix rows on distinct banks
  static constexpr int PLANE = H * LDW;    // floats of the hi or the lo plane of a stage
  static constexpr int STAGE = 2 * PLANE;  // hi, then lo
  static constexpr int FLOATS = 2 * STAGE;
  static constexpr int CHUNKS = H / KC;    // chunks of a 128 x 128 block
  static constexpr int LOADS = H * KC / 4 / NT;  // float4 a thread a chunk
  static_assert(LOADS * 4 * NT == H * KC && KC % 8 == 0, "a chunk is whole float4 a thread");
};

// The weight stream: chunk g of the kernel's sequence (block g / CHUNKS of
// Src, its k-columns KC·(g % CHUNKS)..) goes to stage g % 2. Invariant at
// the start of a chunk's barrier: chunk `next - 1` is split in its stage,
// chunk `next` is in raw. Past the last chunk it loads the last one again
// and stores it in the stage nobody reads: no branch, so that the compiler
// can interleave the staging with a product's mma.
template <int KC, typename Src, int NT = THREADS>
struct Tf32Stream {
  using R = Ring<KC, NT>;
  Src src;     // src(b, ld): the first float of block b of Bᵀ, its row stride ld
  int total;   // chunks of the kernel
  float* ring;
  int next;
  float4 raw[R::LOADS];

  // chunk next from L2 into raw; loads that do not wait
  __device__ __forceinline__ void load() {
    const int g = min(next, total - 1);
    int ld;
    const float* b = src(g / R::CHUNKS, ld) + (g % R::CHUNKS) * KC;
#pragma unroll
    for (int i = 0; i < R::LOADS; ++i) {
      const int q = threadIdx.x + i * NT, n = q / (KC / 4), k = (q % (KC / 4)) * 4;
      raw[i] = __ldg(reinterpret_cast<const float4*>(b + (size_t)n * ld + k));
    }
  }

  // raw (chunk next) split into its stage, then the chunk after it loaded
  __device__ __forceinline__ void advance() {
    float* hi = ring + (next & 1) * R::STAGE;
#pragma unroll
    for (int i = 0; i < R::LOADS; ++i) {
      const int q = threadIdx.x + i * NT, n = q / (KC / 4), k = (q % (KC / 4)) * 4;
      const float v[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
      unsigned h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(v[e], h[e], l[e]);
      *reinterpret_cast<uint4*>(hi + n * R::LDW + k) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(hi + R::PLANE + n * R::LDW + k) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    ++next;
    load();
  }

  // the first chunk split in stage 0, the second in flight; the caller's
  // next barrier makes the stage visible
  __device__ __forceinline__ void start() {
    next = 0;
    load();
    advance();
  }
};

// a warp's tile of a product's f32 sums: [m-tile][n-tile][element]
template <typename TL>
using TileOf = float[TL::MI][TL::NI][4];
using Tile = TileOf<EncTiling>;  // rows 10 and 11: 32 x 32

template <typename TL = EncTiling>
__device__ __forceinline__ void zero_tile(TileOf<TL>& s) {
#pragma unroll
  for (int i = 0; i < TL::MI; ++i)
#pragma unroll
    for (int j = 0; j < TL::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
}

// sum (+)= A · B for the stream's next block B: A (BR, 128) f32 in shared
// memory, row stride LDX, tiled over the warps as TL. Block-wide: every
// thread calls it; it waits at one barrier a chunk, which also orders the
// writes of A before it. The caller synchronizes before anything
// overwrites A. The probe marks the chunk barriers as bar_part and the mma
// loops (with the staging of the next chunk among them) as mma_part.
template <typename TL = EncTiling, typename Stream>
__device__ __forceinline__ void product(const float* A, Stream& st, TileOf<TL>& sum, Probe& pr, int bar_part = P_BAR,
                                        int mma_part = P_MMA) {
  using R = typename Stream::R;
  constexpr int KC = R::DEPTH, MI = TL::MI, NI = TL::NI;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp % TL::MB) * TL::WM, wn = (warp / TL::MB) * TL::WN;
  // ldmatrix rows: A tiles (rows 0-7, k 0-3), (8-15, 0-3), (0-7, 4-7),
  // (8-15, 4-7) → a0..a3; Bᵀ tiles (n 0-7, k 0-3), (n 0-7, k 4-7),
  // (n 8-15, k 0-3), (n 8-15, k 4-7) → b0, b1 of two n-tiles
  const float* a_lane = A + (wm + (lane & 15)) * LDX + (lane >> 4) * 4;
  const int b_lane = (wn + ((lane >> 4) << 3) + (lane & 7)) * R::LDW + ((lane >> 3) & 1) * 4;
  for (int c = 0; c < R::CHUNKS; ++c) {
    __syncthreads();  // chunk next - 1 split for every thread; the other stage is free
    pr.mark(bar_part);
    const float* hi = st.ring + ((st.next - 1) & 1) * R::STAGE + b_lane;
    const float* lo = hi + R::PLANE;
    const float* a_k = a_lane + c * KC;
    float acc[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 8) {
      unsigned ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        unsigned r[4];
        ldsm_x4(r, a_k + mi * 16 * LDX + ks);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), ah[mi][e], al[mi][e]);
      }
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        unsigned r[4], s[4];
        ldsm_x4(r, hi + np * 16 * R::LDW + ks);
        ldsm_x4(s, lo + np * 16 * R::LDW + ks);
        bh[2 * np][0] = r[0], bh[2 * np][1] = r[1], bh[2 * np + 1][0] = r[2], bh[2 * np + 1][1] = r[3];
        bl[2 * np][0] = s[0], bl[2 * np][1] = s[1], bl[2 * np + 1][0] = s[2], bl[2 * np + 1][1] = s[3];
      }
#ifndef TFM_ONE_PASS
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
#endif
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
      if (ks == 0) st.advance();  // the next chunk into the other stage, among this one's mma
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] += acc[i][j][e];
    pr.mark(mma_part);
  }
}

// epi(row, col, v0, v1) over the warp's tile of sum: v0, v1 at columns
// col, col + 1 (col absolute: n0 + the tile's column), rows of the block
template <typename TL = EncTiling, typename Epi>
__device__ __forceinline__ void tile_out(const TileOf<TL>& sum, int n0, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp % TL::MB) * TL::WM + (lane >> 2), c0 = n0 + (warp / TL::MB) * TL::WN + 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(r0 + 16 * mi + 8 * h, c0 + 8 * ni, sum[mi][ni][2 * h], sum[mi][ni][2 * h + 1]);
}

}  // namespace tfm
