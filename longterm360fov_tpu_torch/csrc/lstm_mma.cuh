// The LSTM encoders and serve kernel on the tensor cores (sm_90a), in both
// compute tiers: the layer step of peer_context_kernel and fused_encode_kernel
// (fused_serve.cu), an LSTM over many independent rows from
// zero state with no feedback (also the training tier's lockstep peer
// forward, align_peer_fwd_kernel in lstm_align.cu, with its residual
// stores), the serve kernel (server below) and the one-step cell
// (cell_step, at the end): per step t and layer l,
//   gates = [in_t, h_l,t-1] @ W_l + b_l;  c = f * c + i * g;  h = o * tanh(c).
// Each body is a template on its product (Bf16Mma or Tf32Mma below): the
// bf16 tier's products on mma.sync m16n8k16 with bf16 operands, and the f32
// tier's (peer_context_kernel<float>, fused_encode_kernel<float>,
// fused_serve_kernel<*, float>, lstm_cell_kernel<float>) in three-pass TF32 on mma.sync m16n8k8, which keeps 22 bits an operand.
//
// What bounds it on Hopper (peer context at B = 4096, K = 7, T = 100,
// C = 128: 28,672 rows; one step of a block of 64 rows):
//   * the products: 64 x 144 x 512 x 2 = 9.4 MFLOP a step on mma.sync
//     m16n8k16 (bf16 operands, f32 sums), about 2 µs at its 600-650 TFLOP/s;
//     three times that in three-pass TF32 at half the rate, about 12 µs;
//   * the cell: 8,192 (row, unit) pairs of three sigmoids and two tanhf in
//     exact f32 (expf, tanhf and an IEEE division, no fast math), some 90
//     instructions and 10 MUFU operations a pair, about 3 µs of issue; it
//     stays on the FMA and MUFU units;
//   * the recurrence: the steps are serial inside a block, two barriers a
//     layer-step; blocks share nothing;
//   * in f32, W: no layer's W fits a block's shared memory beside the state
//     (295 KB at C = 128), so it streams from L2 every layer-step.
// On the card (NVIDIA H100 80GB HBM3, 700 W; scripts/torch_lstm_encode_probe.py,
// PERF.md) a step of a bf16 block takes about 9 µs: the probe build's split is
// the cell 55 %, the products 30 %, the publish and x staging 14 %. Fewer,
// wider warps (8 of 32 x 32 tiles) made the cell slower, and two groups of
// rows with their own barriers did not overlap one's products with the
// other's cell better than the warps already do.
// What the design does about it:
//   * Warp tiles (BodyTile). A tile is 32 rows x 16 units (MT = 2 m16
//     tiles; 16 rows x 32 units, MT = 1, where a block has only 16 rows)
//     across all four gates: 16 n8 tiles, 64 f32 accumulators a lane; in
//     f32 32 rows x 8 units (32 accumulators), and in the f32 lockstep
//     serve kernel 64 rows x 8 units (MT = 4) or 32 x 16. W's columns are
//     packed so that a tile's n-tiles are, per unit block of 8, its i, f, g
//     and o columns: a lane's accumulators hold the four gates of its (row,
//     unit) pairs, and the cell update runs in registers. A block's tiles
//     go round its warps (at most 16; 8 in the f32 lockstep serve kernel).
//   * A operand. z, one row of [x_t (padded to whole k-steps), h_0, ..,
//     h_L-1] a block row, in shared memory at a row stride of 16 bytes past
//     a multiple of 32 (ldmatrix's eight rows on distinct banks); layer l's
//     A is the slice [x_t | h_l] or [h_l-1 | h_l], read by ldsm_x4. In bf16
//     the rounding points of the tier are the writes into z: x_t and every
//     layer's new h are rounded to bf16 as they are stored there, and the
//     products read nothing else. In f32 z holds the f32 values, and ldsm_x4
//     reads them as TF32 A fragments (tensor_core.cuh), split in registers.
//   * B operand. The wrapper packs W_l (pack_weights, pack_weights_tf32 in
//     ops/fused_lstm.py) into mma's B fragment order: per k-step and pair of
//     n-tiles a lane's 16 bytes {b0, b1 of n-tile 2p, b0, b1 of n-tile
//     2p + 1}, 512 contiguous bytes a warp (bf16: a k16 step; f32: a k8
//     step). Where every layer's packed W fits beside the block's state (the
//     bf16 timed shapes: (16 + 128) x 512 bf16 = 144 KB), it is copied into
//     shared memory once and stays there: a block reads W from L2 once, not
//     once a step. Else a lane loads its fragments from device memory (L2)
//     every step: the streamed route of wider or deeper encoders and of
//     every f32 block, which reads W once a step for every tile of rows (64
//     rows in f32).
//   * The step. Per layer-step each warp runs its tiles: the product, then
//     the cell on the accumulators with c from its lane-private slots (f32,
//     in shared memory, or in device memory where it does not fit) and the
//     new h written to a staging buffer; a barrier; then the block publishes
//     the staging into z (rounding it in bf16), sums the peer context, and
//     stores the next step's x (its global loads issued before the
//     products); a barrier.
//   * The peer context. The staging buffer of peer_context holds the f32 h
//     of the block's real rows (all K peers of RV viewers; the rows padded
//     up to whole tiles compute on zeros and are never stored), XOR-swizzled
//     by row so the lanes' float2 stores fall on distinct banks; ctx_t[v] =
//     Σ_k w_k · h_k (k = 0 .. K - 1 in order, each product and sum rounded
//     to nearest, as the plain version computes them) is summed from it.
//     A block holds one viewer's K = 1..256 peers; where the f32 z and the
//     staging of that many rows do not fit a block together (from 208 rows
//     of C = 128: 275 KB at 256), the staging lives in device memory
//     (Geom::h_glob, L2-resident), written by the cells and read back after
//     the barrier.
//   * fused_encode writes the top-layer h from z: rounded in bf16, the f32 h
//     in f32.
// The three-pass TF32 product (product_tf32): an f32 operand x is split into
// hi, x with its 13 low mantissa bits cleared, and lo = x - hi, which mma
// reads as TF32 (split_fast: 21 bits kept); a · b is a_lo · b_hi +
// a_hi · b_lo + a_hi · b_hi, the small terms first, a_lo · b_lo (at most
// 2^-20 of a · b) dropped. The tensor cores round each mma's sum toward
// zero, so the product sums each chunk of 4 or 8 k8 steps (TF32_CHUNK,
// TF32_CHUNK_STEP_CTX) in fresh accumulators and
// adds it to the f32 sums of the tile (round to nearest), as
// transformer_tf32.cuh does: a 32 x 8 tile keeps 32 sums and 32 chunk
// accumulators a lane, so an f32 block has 16 warps of 128 registers; the
// lockstep serve kernel's 64 x 8 tiles keep 64 and 64 on 8 warps of up to
// 255 registers, and read each W element once a 64-row block where the
// others read it twice. W streams from L2 as packed f32 (4 B an element)
// and is split in registers, two k8 steps ahead of its mma.
// The split is split_fast (a mask and a subtraction, 21 bits kept), not
// cvt.rna, whose rounding compiles to a compare and a branch a value.

#pragma once

#include "compute_type.cuh"
#include "probe.cuh"
#include "tensor_core.cuh"

// The probe build (-DLSTM_PROBE): thread 0 of every block adds the clock64
// ticks it spends in each part of its work to g_lstm_probe (probe.cuh's
// ClockProbe); fused_serve_probe_read copies the sums out and zeroes them.
enum LstmPart {
  LP_STAGE,     // the next step's x (the serve body: or ctx_t): its global loads and its stores into z
  LP_PRODUCTS,  // the tiles' products
  LP_CELL,      // the cell update on the accumulators, c, h to the staging buffer
  LP_PUBLISH,   // the staging into z; peer_context: the context sum and its store
  LP_BARRIERS,  // block barriers
  LP_FEEDBACK,  // the serve body: y = h_top · proj_w + proj_b, written out and into z; W's copies
  LP_STATES,    // the f32 serve body from given states (fused_decode): h0 into z, c0 into the lanes' slots
  LP_PARTS
};
__device__ unsigned long long g_lstm_probe[LP_PARTS];
#ifdef LSTM_PROBE
using LstmProbe = ClockProbe<true>;
#else
using LstmProbe = ClockProbe<false>;
#endif

namespace lstm_mma {

using bf16 = __nv_bfloat16;

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a Hopper block may use

// A block's shape, chosen by the wrapper (ops/fused_lstm.py encode_tc_rows,
// peer_tc_rows, serve_tc_rows; peer_tf32_rows, serve_tf32_rows): rp rows
// padded to whole tiles of 16·mt rows; W resident in
// shared memory or streamed; c in shared memory, or in c_glob (grid x layers
// x rp x H floats) where it does not fit; the peer context's staging of the
// f32 h in shared memory, or in h_glob (grid x rows x H floats) where it does
// not fit beside z (the f32 tier from 208 peer rows of C = 128).
struct Geom {
  int rp, mt, w_res;
  float* c_glob;
  float* h_glob = nullptr;
};

template <int MT, int UT_ = 4 / MT>
struct Tile {
  static constexpr int UT = UT_;        // unit blocks of 8 a tile
  static constexpr int ROWS = 16 * MT;  // rows a tile
  static constexpr int UNITS = 8 * UT;  // units a tile
  static constexpr int NP = 2 * UT;     // pairs of n-tiles (4·UT n-tiles: i, f, g, o a unit block)
};

// The products of a tier, a template parameter of encoder and server: the
// type E of z and of the staging, the k-rows of a k-step (KS), z's row
// padding (PAD: 16 bytes of E), and how a value is stored into z (rounded
// to bf16, or as it is).
struct Bf16Mma {
  using E = bf16;
  using E2 = __nv_bfloat162;  // a pair of E
  static constexpr int KS = 16, PAD = 8;
  __device__ static __forceinline__ E cvt(float x) { return __float2bfloat16_rn(x); }
  __device__ static __forceinline__ float wide(E x) { return __bfloat162float(x); }
  __device__ static __forceinline__ void put2(E* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  __device__ static __forceinline__ void put4(E* p, float4 v) {
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(p);
    dst[0] = __floats2bfloat162_rn(v.x, v.y);
    dst[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  __device__ static __forceinline__ E2 ld2(const E* p) { return *reinterpret_cast<const E2*>(p); }
  __device__ static __forceinline__ E2 pair(E a, E b) { return __halves2bfloat162(a, b); }
  __device__ static __forceinline__ float2 wide2(E2 v) { return __bfloat1622float2(v); }
  __device__ static __forceinline__ float4 get4(const E* p) {
    const uint2 hv = *reinterpret_cast<const uint2*>(p);
    const float2 h01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hv.x));
    const float2 h23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hv.y));
    return make_float4(h01.x, h01.y, h23.x, h23.y);
  }
};

// the f32 tier's three-pass TF32 products (product_tf32)
struct Tf32Mma {
  using E = float;
  using E2 = float2;
  static constexpr int KS = 8, PAD = 4;
  __device__ static __forceinline__ E cvt(float x) { return x; }
  __device__ static __forceinline__ float wide(E x) { return x; }
  __device__ static __forceinline__ void put2(E* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  __device__ static __forceinline__ void put4(E* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
  __device__ static __forceinline__ E2 ld2(const E* p) { return *reinterpret_cast<const E2*>(p); }
  __device__ static __forceinline__ E2 pair(E a, E b) { return make_float2(a, b); }
  __device__ static __forceinline__ float2 wide2(E2 v) { return v; }
  __device__ static __forceinline__ float4 get4(const E* p) { return *reinterpret_cast<const float4*>(p); }
};

template <typename P = Bf16Mma>
__host__ __device__ inline int kx_of(int d) { return (d + P::KS - 1) / P::KS * P::KS; }
template <typename P = Bf16Mma>
__host__ __device__ inline int ldz_of(int d, int h, int layers) { return kx_of<P>(d) + layers * h + P::PAD; }
// uint4s of a k-step of packed W, in both tiers: H / 4 pairs of n-tiles x 32 lanes
__host__ __device__ inline int kstride_of(int h) { return h / 4 * 32; }
// uint4s of layer l's packed W: (k rows / KS) k-steps
template <typename P = Bf16Mma>
__host__ __device__ inline long long w_layer_u4(int l, int d, int h) {
  return (long long)((l ? h : kx_of<P>(d)) + h) / P::KS * kstride_of(h);
}
template <typename P = Bf16Mma>
__host__ __device__ inline long long w_u4(int d, int h, int layers) {
  long long n = 0;
  for (int l = 0; l < layers; ++l) n += w_layer_u4<P>(l, d, h);
  return n;
}

// Shared memory of a block, in this order: W (when resident), c (when in
// shared memory), z, the staging buffer (peer: the f32 h of the `rows` real
// rows, when in shared memory; encode: E rows of H + 8), and the peer weights
// of the rows.
template <typename P = Bf16Mma>
__host__ __device__ inline long long smem_bytes(bool peer, int rp, int rows, int d, int h, int layers, bool w_res,
                                                bool c_smem, bool h_smem = true) {
  constexpr int e = sizeof(typename P::E);
  long long s = w_res ? 16 * w_u4<P>(d, h, layers) : 0;
  s += c_smem ? 4LL * layers * rp * h : 0;
  s += (long long)e * rp * ldz_of<P>(d, h, layers);
  s += peer ? (h_smem ? 4LL * rows * h : 0) + (4LL * rows + 15) / 16 * 16 : (long long)e * rp * (h + 8);
  return s;
}

// The column of h_k in a peer row's f32 staging: bits 3-4 of the unit
// XOR-ed with the row, so that the 8 rows of a lane group's float2 stores
// fall on 4 distinct 32-byte bank groups (H % 32 == 0)
__device__ __forceinline__ int swz(int row, int unit) { return unit ^ ((row & 3) << 3); }

// A global load issued where it stands: volatile, so that the compiler
// keeps it ahead of the products' asm (the next step's x lands during them)
__device__ __forceinline__ float ldg_now(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// acc += [za | zb] (the tile's rows, ks_a then ks_b k16 steps) · W_tile:
// A by ldsm_x4 from z, B as packed (w: the tile's first pair of the first
// k-step, plus the lane; kstride uint4s a k-step), in shared or device
// memory (generic loads).
template <int MT>
__device__ __forceinline__ void product(float (&acc)[MT][Tile<MT>::UT][4][4], const bf16* za, int ks_a,
                                        const bf16* zb, int ks_b, const uint4* w, int kstride, int ldz,
                                        int lane) {
  using TL = Tile<MT>;
  const int arow = (lane & 15) * ldz + (lane >> 4) * 8;
  auto step = [&](const bf16* zp, const uint4* wk) {
    unsigned a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], zp + mt * 16 * ldz + arow);
#pragma unroll
    for (int p0 = 0; p0 < TL::NP; p0 += 4) {  // four pairs of n-tiles at a time: 16 registers of B
      uint4 b[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) b[p] = wk[(p0 + p) * 32];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int ut = (p0 + p) >> 1, q = 2 * (p & 1);
          mma_bf16(acc[mt][ut][q], a[mt], b[p].x, b[p].y);
          mma_bf16(acc[mt][ut][q + 1], a[mt], b[p].z, b[p].w);
        }
    }
  };
#pragma unroll 2
  for (int ks = 0; ks < ks_a; ++ks) step(za + ks * 16, w + (size_t)ks * kstride);
  w += (size_t)ks_a * kstride;
#pragma unroll 2
  for (int ks = 0; ks < ks_b; ++ks) step(zb + ks * 16, w + (size_t)ks * kstride);
}

// k8 steps a chunk of product_tf32's fresh accumulators: 4, and 8 in the
// lockstep serve kernel (measured in turns: 6.5 % faster there, 2-5 % slower
// in the other f32 instances; PERF.md §6, row 1)
constexpr int TF32_CHUNK = 4, TF32_CHUNK_STEP_CTX = 8;

// x → (hi, lo) for the three passes, in integer and f32 adds, no cvt (whose
// rna rounding compiles to a compare and a branch a value): hi = x with its
// 13 low mantissa bits cleared, a TF32 value; lo = x - hi, exact, which mma
// reads as TF32, dropping lo's low bits. hi + lo keeps 21 bits of x.
__device__ __forceinline__ void split_fast(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x → (hi, lo) rounded to nearest: hi = x rounded to TF32 (half an ulp of
// TF32 added to the bits, then the 13 low mantissa bits cleared: ties away
// from zero), lo = x - hi (exact) rounded likewise; hi + lo keeps 22 bits of
// x to nearest, where split_fast's truncations keep 21 to within 2^-20.
// Two integer adds a value more than split_fast.
__device__ __forceinline__ void split_round(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// 16 bytes of packed W from device memory through the read-only path
__device__ __forceinline__ uint4 ldg_u4(const uint4* p) { return __ldg(p); }

// sum += [za | zb] (the tile's rows, ks_a then ks_b k8 steps, f32) · W_tile
// in three-pass TF32: A by ldsm_x4 from z as TF32 fragments and split in
// registers; B from device memory as packed (w: the tile's first pair of
// the first k-step, plus the lane; kstride uint4s a k-step), two k8 steps
// ahead of its mma, split after the load (split_fast; ROUND: split_round);
// each chunk of CHUNK k8 steps summed in fresh accumulators, then added to
// sum.
template <int MT, int CHUNK, int UT, bool ROUND = false>
__device__ __forceinline__ void product_tf32(float (&sum)[MT][UT][4][4], const float* za, int ks_a,
                                             const float* zb, int ks_b, const uint4* __restrict__ w, int kstride,
                                             int ldz, int lane) {
  auto split = [](float x, unsigned& hi, unsigned& lo) {
    if constexpr (ROUND)
      split_round(x, hi, lo);
    else
      split_fast(x, hi, lo);
  };
  using TL = Tile<MT, UT>;
  constexpr int NP = TL::NP;
  const int arow = (lane & 15) * ldz + (lane >> 4) * 4;
  const int steps = ks_a + ks_b;
  // k8 step s: A's columns, W's step (past the last: the last again, unread)
  auto a_at = [&](int s) { return (s < ks_a ? za + 8 * s : zb + 8 * (s - ks_a)) + arow; };
  auto load = [&](uint4 (&b)[NP], int s) {
    const uint4* wk = w + (size_t)min(s, steps - 1) * kstride;
#pragma unroll
    for (int p = 0; p < NP; ++p) b[p] = ldg_u4(wk + p * 32);
  };
  auto step = [&](float (&acc)[MT][TL::UT][4][4], const float* ap, const uint4 (&b)[NP]) {
    unsigned bh[NP][4], bl[NP][4];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float v[4] = {__uint_as_float(b[p].x), __uint_as_float(b[p].y), __uint_as_float(b[p].z),
                          __uint_as_float(b[p].w)};
#pragma unroll
      for (int e = 0; e < 4; ++e) split(v[e], bh[p][e], bl[p][e]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      unsigned r[4], ah[4], al[4];
      ldsm_x4(r, ap + mt * 16 * ldz);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(r[e]), ah[e], al[e]);
      // the passes a_lo·b_hi, a_hi·b_lo, a_hi·b_hi, each over the m-tile's
      // n-tiles: 2·NP independent sums between dependent mma
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const unsigned(&a)[4] = pass == 0 ? al : ah;
            const unsigned(&b)[4] = pass == 1 ? bl[p] : bh[p];
            mma_tf32(acc[mt][p >> 1][2 * (p & 1) + hf], a, b[2 * hf], b[2 * hf + 1]);
          }
    }
  };
  uint4 b0[NP], b1[NP];
  load(b0, 0);
  load(b1, 1);
  for (int s0 = 0; s0 < steps; s0 += CHUNK) {
    float acc[MT][TL::UT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ut = 0; ut < TL::UT; ++ut)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][ut][q][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < CHUNK; j += 2) {
      const int s = s0 + j;
      if (s < steps) {
        step(acc, a_at(s), b0);
        load(b0, s + 2);
      }
      if (s + 1 < steps) {
        step(acc, a_at(s + 1), b1);
        load(b1, s + 3);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ut = 0; ut < TL::UT; ++ut)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[mt][ut][q][e] += acc[mt][ut][q][e];
  }
}

// The warp tile of a body of the tier P: 16·MT rows x 32 / MT units, all
// four gates (bf16: 16 warps of 128 registers), except the f32 peer
// context and serve kernel, 32 rows x 8 units (MT = 2: 16 warps of 128
// registers), and the f32 lockstep serve kernel (STEP_CTX), 64 x 8 (MT = 4)
// or 32 x 16 on 8 warps of up to 255 registers: each measured faster
// there than the other (PERF.md §6, row 1).
template <typename P, int MT, bool STEP_CTX = false>
using BodyTile = Tile<MT, std::is_same<P, Tf32Mma>::value && !STEP_CTX ? 1 : 4 / MT>;

// the tier's product of a tile: bf16 (product) or three-pass TF32 (product_tf32 in chunks of CHUNK k8 steps,
// its operands split by split_fast or, ROUND, split_round)
template <typename P, int MT, int CHUNK = TF32_CHUNK, bool ROUND = false, int UT>
__device__ __forceinline__ void tile_product(float (&acc)[MT][UT][4][4], const typename P::E* za, int ks_a,
                                             const typename P::E* zb, int ks_b, const uint4* w, int kstride, int ldz,
                                             int lane) {
  if constexpr (std::is_same<P, Tf32Mma>::value)
    product_tf32<MT, CHUNK, UT, ROUND>(acc, za, ks_a, zb, ks_b, w, kstride, ldz, lane);
  else
    product<MT>(acc, za, ks_a, zb, ks_b, w, kstride, ldz, lane);
}

// The cell update of a tile from its accumulators: the lane's pairs (rows
// r0 + 16·mt + g and + 8, units u0 + 8·ut + 2t and + 1). bias(ut, q, unit)
// gives gate q's f32 bias at units unit, unit + 1; c_get(mt, ut) the old c
// of the pairs as a float4 (e = 0..3: rows g, g, g + 8, g + 8 at units 2t,
// 2t + 1) and c_set(mt, ut, c) takes the new one; the new h goes to
// put(row, unit, h_unit, h_unit+1). The encoders keep c in lane-private f32
// slots; the one-step cell (cell_step) takes c from, and gives it to,
// device memory in the tier's type.
template <int MT, int UT, typename Bias, typename CGet, typename CSet, typename Put>
__device__ __forceinline__ void cell(const float (&acc)[MT][UT][4][4], int r0, int u0, int lane,
                                     Bias bias, CGet c_get, CSet c_set, Put put) {
  using TL = Tile<MT, UT>;
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ut = 0; ut < TL::UT; ++ut) {
    const int unit = u0 + 8 * ut + 2 * t4;
    float2 b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = bias(ut, q, unit);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float4 cv = c_get(mt, ut);
      const float c_old[4] = {cv.x, cv.y, cv.z, cv.w};
      float c_new[4], h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bi = (e & 1) ? b[0].y : b[0].x, bf = (e & 1) ? b[1].y : b[1].x;
        const float bg = (e & 1) ? b[2].y : b[2].x, bo = (e & 1) ? b[3].y : b[3].x;
        const float i_g = sigmoid_f32(acc[mt][ut][0][e] + bi);
        const float f_g = sigmoid_f32(acc[mt][ut][1][e] + bf);
        const float g_g = tanhf(acc[mt][ut][2][e] + bg);
        const float o_g = sigmoid_f32(acc[mt][ut][3][e] + bo);
        c_new[e] = f_g * c_old[e] + i_g * g_g;
        h[e] = o_g * tanhf(c_new[e]);
      }
      c_set(mt, ut, make_float4(c_new[0], c_new[1], c_new[2], c_new[3]));
      const int row = r0 + 16 * mt + g8;
      put(row, unit, h[0], h[1]);
      put(row + 8, unit, h[2], h[3]);
    }
  }
}

// The L-layer encoder over T steps for the block's rows, from zero state,
// its products those of P (Bf16Mma or Tf32Mma).
// PEER: the lockstep peer cells (L = 1, hidden H = C): rows = RV·K real rows
// of peer rows p = p0 + r (p < nrows), and after every step ctx_t of the
// block's viewers into out (B, T, C). Else (fused_encode): rows = rp batch
// rows from p0 (p < nrows), and the top-layer h from z into out (B, H):
// rounded in bf16, as it is in f32.
// RT (PEER only; void: none): the training tier's residuals, every step's h
// (from the staging) and c (from the lanes' slots) into php and pcp (nrows,
// T, H) in RT, 16-byte pieces along whole rows, during the publish
// (ops/lstm_align.py peer_fwd).
// HG (PEER only): the staging in geo.h_glob, not in shared memory; a template
// parameter, so that the shared-memory instance addresses its staging as
// shared (a pointer chosen at run time compiles to generic loads and stores:
// 1-3 % slower at K = 7).
template <typename P, int MT, bool PEER, typename RT = void, bool HG = false>
__device__ __forceinline__ void encoder(const float* __restrict__ xs, const float* __restrict__ pwt,
                                        float* __restrict__ out, const uint4* __restrict__ wg,
                                        const float* const* bias, long long p0, int nrows, int rows, int T,
                                        int D, int H, int L, int K, int RV, int B, const Geom& geo,
                                        RT* __restrict__ php = nullptr, RT* __restrict__ pcp = nullptr) {
  using TL = BodyTile<P, MT>;
  using E = typename P::E;
  constexpr bool RES = !std::is_void<RT>::value;
  static_assert(PEER || !RES, "residual stores are the lockstep peer forward's");
  static_assert(PEER || !HG, "only the peer context stages h in device memory");
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int rp = geo.rp, kx = kx_of<P>(D), ldz = ldz_of<P>(D, H, L);
  const int bands = H / TL::UNITS, tiles = rp / TL::ROWS * bands;
  const int kstride = kstride_of(H);  // uint4s of a k-step of packed W
  LstmProbe pr(g_lstm_probe);

  char* sp = reinterpret_cast<char*>(smem4);
  const uint4* w_all = wg;
  if (geo.w_res) {
    uint4* ws = reinterpret_cast<uint4*>(sp);
    const long long n = w_u4<P>(D, H, L);
    for (long long i = tid; i < n; i += nthr) ws[i] = wg[i];
    w_all = ws;
    sp += 16 * n;
  }
  float4* cm;
  if (geo.c_glob) {
    cm = reinterpret_cast<float4*>(geo.c_glob + (size_t)blockIdx.x * L * rp * H);
  } else {
    cm = reinterpret_cast<float4*>(sp);
    sp += (size_t)4 * L * rp * H;
  }
  E* z = reinterpret_cast<E*>(sp);
  sp += sizeof(E) * rp * ldz;
  // PEER: f32 h of the real rows, swizzled, in shared memory or (HG) in h_glob
  float* hst = HG ? geo.h_glob + (size_t)blockIdx.x * rows * H : reinterpret_cast<float*>(sp);
  E* est = reinterpret_cast<E*>(sp);  // else: h in E, rows of H + 8
  const int lde = H + 8;
  float* wrow = reinterpret_cast<float*>(sp + (HG ? 0 : (size_t)4 * rows * H));  // PEER: w of the rows

  for (int i = tid; i < L * rp * H / 4; i += nthr) cm[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = tid; i < rp * ldz * (int)sizeof(E) / 16; i += nthr)
    reinterpret_cast<uint4*>(z)[i] = make_uint4(0, 0, 0, 0);
  if constexpr (PEER)
    for (int r = tid; r < rows; r += nthr) wrow[r] = p0 + r < nrows ? pwt[p0 + r] : 0.0f;
  // x_t into z[r][0 .. D): element i of the block's rp x D, 0 past the rows
  auto x_at = [&](int t, int i) {
    const int r = i / D, d = i - r * D;
    return r < rows && p0 + r < nrows ? ldg_now(xs + ((p0 + r) * T + t) * D + d) : 0.0f;
  };
  auto x_put = [&](int i, float v) {
    const int r = i / D;
    z[r * ldz + (i - r * D)] = P::cvt(v);
  };
  __syncthreads();  // z zeroed before x_0 lands in it
  for (int i = tid; i < rp * D; i += nthr) x_put(i, x_at(0, i));
  __syncthreads();  // W, z and c in place

  for (int t = 0; t < T; ++t) {
    // the thread's first element of x_t+1, loaded ahead of the products
    const float xr = t + 1 < T && tid < rp * D ? x_at(t + 1, tid) : 0.0f;
    pr.mark(LP_STAGE);
    for (int l = 0; l < L; ++l) {
      const E* za = z + (l ? kx + (l - 1) * H : 0);
      const E* zb = z + kx + l * H;
      const uint4* wl = w_all + (l ? w_layer_u4<P>(0, D, H) + (l - 1) * w_layer_u4<P>(1, D, H) : 0);
      float4* cl = cm + (size_t)l * rp * H / 4 + lane;
      for (int tau = warp; tau < tiles; tau += nwarps) {
        const int r0 = tau / bands * TL::ROWS, u0 = tau % bands * TL::UNITS;
        float acc[MT][TL::UT][4][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int ut = 0; ut < TL::UT; ++ut)
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][ut][q][e] = 0.0f;
        tile_product<P, MT>(acc, za + r0 * ldz, (l ? H : kx) / P::KS, zb + r0 * ldz, H / P::KS,
                            wl + tau % bands * TL::NP * 32 + lane, kstride, ldz, lane);
        pr.mark(LP_PRODUCTS);
        float4* cs = cl + (size_t)tau * MT * TL::UT * 32;
        const float* bl = bias[l];
        auto b_of = [&](int, int q, int unit) { return __ldg(reinterpret_cast<const float2*>(bl + q * H + unit)); };
        auto c_get = [&](int mt, int ut) { return cs[(mt * TL::UT + ut) * 32]; };
        auto c_set = [&](int mt, int ut, float4 c) { cs[(mt * TL::UT + ut) * 32] = c; };
        if constexpr (PEER) {
          cell<MT>(acc, r0, u0, lane, b_of, c_get, c_set, [&](int row, int unit, float h0, float h1) {
            if (row < rows) *reinterpret_cast<float2*>(hst + row * H + swz(row, unit)) = make_float2(h0, h1);
          });
        } else {
          cell<MT>(acc, r0, u0, lane, b_of, c_get, c_set,
                   [&](int row, int unit, float h0, float h1) { P::put2(est + row * lde + unit, h0, h1); });
        }
        pr.mark(LP_CELL);
      }
      __syncthreads();  // every tile of the layer-step read z; the staging is whole
      pr.mark(LP_BARRIERS);
      E* zh = z + kx + l * H;
      if constexpr (PEER) {  // a warp a viewer, a lane 4 units: its K rows into z and ctx_t
        const long long b0 = p0 / K;
        for (int v = warp; v < RV && b0 + v < B; v += nwarps) {
          for (int u = 4 * lane; u < H; u += 128) {
            float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
            for (int k = 0; k < K; ++k) {
              const int r = v * K + k;
              const float4 h = *reinterpret_cast<const float4*>(hst + r * H + swz(r, u));
              const float w = wrow[r];
              s.x = __fadd_rn(s.x, __fmul_rn(h.x, w));
              s.y = __fadd_rn(s.y, __fmul_rn(h.y, w));
              s.z = __fadd_rn(s.z, __fmul_rn(h.z, w));
              s.w = __fadd_rn(s.w, __fmul_rn(h.w, w));
              P::put4(zh + r * ldz + u, h);
            }
            *reinterpret_cast<float4*>(out + ((size_t)(b0 + v) * T + t) * H + u) = s;
          }
        }
        if constexpr (RES) {
          // the residual h (from the staging) and c (from the lanes' slots)
          // of every real row in RT, 16-byte pieces of EV units, consecutive
          // threads along a row: whole rows of a step stored together
          constexpr int EV = 16 / sizeof(RT);
          for (int i = tid; i < rows * (H / EV); i += nthr) {
            const int r = i / (H / EV), u = (i % (H / EV)) * EV;
            if (p0 + r >= nrows) continue;
            // slot of (row r, units u + 2j, + 1): tile, m-tile, unit block, lane (g, t)
            const int r_in = r % TL::ROWS, ut = u % TL::UNITS / 8, hh = r_in / 8 % 2;
            const float4* slot = cm + ((size_t)((r / TL::ROWS) * bands + u / TL::UNITS) * MT * TL::UT +
                                       (r_in / 16) * TL::UT + ut) * 32 + (r_in % 8) * 4;
            float hv[EV], cv[EV];
#pragma unroll
            for (int j = 0; j < EV; j += 4) {
              const float4 h = *reinterpret_cast<const float4*>(hst + r * H + swz(r, u + j));
              hv[j] = h.x, hv[j + 1] = h.y, hv[j + 2] = h.z, hv[j + 3] = h.w;
            }
#pragma unroll
            for (int j = 0; j < EV; j += 2) {
              const float4 c = slot[(u + j) % 8 / 2];
              cv[j] = hh ? c.z : c.x, cv[j + 1] = hh ? c.w : c.y;
            }
            const size_t o = ((size_t)(p0 + r) * T + t) * H + u;
            if constexpr (std::is_same<RT, float>::value) {
              *reinterpret_cast<float4*>(php + o) = make_float4(hv[0], hv[1], hv[2], hv[3]);
              *reinterpret_cast<float4*>(pcp + o) = make_float4(cv[0], cv[1], cv[2], cv[3]);
            } else {
              unsigned hw[4], cw[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const __nv_bfloat162 hb = __floats2bfloat162_rn(hv[2 * j], hv[2 * j + 1]);
                const __nv_bfloat162 cb = __floats2bfloat162_rn(cv[2 * j], cv[2 * j + 1]);
                hw[j] = *reinterpret_cast<const unsigned*>(&hb);
                cw[j] = *reinterpret_cast<const unsigned*>(&cb);
              }
              *reinterpret_cast<uint4*>(php + o) = make_uint4(hw[0], hw[1], hw[2], hw[3]);
              *reinterpret_cast<uint4*>(pcp + o) = make_uint4(cw[0], cw[1], cw[2], cw[3]);
            }
          }
        }
      } else {
        constexpr int EV = 16 / sizeof(E);  // elements a uint4
        for (int i = tid; i < rp * H / EV; i += nthr) {
          const int r = i / (H / EV), u = (i % (H / EV)) * EV;
          *reinterpret_cast<uint4*>(zh + r * ldz + u) = *reinterpret_cast<const uint4*>(est + r * lde + u);
        }
      }
      pr.mark(LP_PUBLISH);
      if (l == 0 && t + 1 < T) {  // layer 0 has read x_t
        if (tid < rp * D) x_put(tid, xr);
        for (int i = tid + nthr; i < rp * D; i += nthr) x_put(i, x_at(t + 1, i));
        pr.mark(LP_STAGE);
      }
      __syncthreads();  // z holds this layer's h (and x_t+1) for the next layer or step
      pr.mark(LP_BARRIERS);
    }
  }
  if constexpr (!PEER) {  // the top-layer h as z holds it (bf16: rounded), row-major
    const E* ztop = z + kx + (L - 1) * H;
    for (int i = tid; i < rp * H; i += nthr) {
      const int r = i / H, u = i % H;
      if (p0 + r < nrows) out[(p0 + r) * H + u] = P::wide(ztop[r * ldz + u]);
    }
  }
}

// ---------------------------------------------------------------------------
// The serve kernel in both tiers (fused_serve_kernel<STEP_CTX, CT> in
// fused_serve.cu, replacing the Pallas _serve_kernel of
// longterm360fov_tpu/ops/fused_lstm.py::fused_serve, f32 and
// compute_dtype=bfloat16; the f32 instance from given states also replaces
// _decode_kernel of fused_decode): the L-layer encoder over T_in steps from zero state, then T_out
// decoder steps from the encoder's final (h, c) of every layer, the layer-0
// input [y, ctx], and y = round(h_top) · proj_w + proj_b fed back; ctx
// none, static (B, C), or (STEP_CTX) the lockstep tier's per-step ctx_t
// (B, T_out, C).
//
// What bounds it on the card (stacked-ss-crossuser-10s at B = 65,536: L =
// 2, H = 128, C = 128, 100 + 100 steps): the products, 26 M row-layer-steps
// of 0.15-0.28 MFLOP, about 6.2 TFLOP, 10 ms at mma.sync's 600-650 TFLOP/s;
// the cell's exact sigmoids and tanhs (the encoders' 55 % of a step); the
// recurrence (two barriers a layer-step); and, where the packed W does not
// fit beside the block's state, W's reads from L2 every layer-step.
// What the design does about it: the encoders' pieces (encoder above) on
// one block of rp rows, through both phases:
//   * z, a bf16 row of [x or y (padded to a k16 step) | ctx (C) | h_0 ..
//     h_L-1] a block row; layer 0's A is [x | h_0] in the encoder (two
//     pieces: product's za and zb) and [y | ctx | h_0] in the decoder (one
//     run); the rounding points are the writes into z: x_t, every layer's
//     new h, the static ctx once, ctx_t every step, the fed-back y; the
//     first y is x_T_in-1 as the encoder left it in z.
//   * The warp tiles, product and cell of the encoders: 32 rows x 16 units
//     of all four gates (16 rows x 32 units at MT = 1), c in the lanes'
//     slots, which carry each layer's c from the encoder into the decoder.
//   * W packed by pack_weights (ops/fused_lstm.py), the decoder's layer 0
//     with its k-rows [y padded to a k16 step | ctx | h]. Where the larger
//     phase's packed W fits beside the block's state (L = 1, C = 0: 144 KB
//     each) it is resident, the decoder's copied over the encoder's between
//     the phases; else every warp reads its fragments from L2 each
//     layer-step (the encoders' streamed route). A block-shared ring of
//     W's k-steps (16 KB each, by cp.async, one barrier a k-step) was
//     slower than L2 at both streamed serving shapes (PERF.md, row 1b).
//   * The feedback y (D·H MACs a row, D <= 4) on the FMA units, 8 threads
//     a row, from the staging buffer's rounded h_top and proj_w staged in
//     shared memory once, while the block publishes h_top into z: no
//     barrier of its own.
//   * The lockstep tier's ctx_t+1 comes by cp.async into an f32 staging
//     buffer during step t's products and is rounded into z after layer 0
//     has read ctx_t, each thread the pieces it copied.
// The f32 tier (P = Tf32Mma) is the same body with z, the staging and W in
// f32 and the products in three-pass TF32 (product_tf32): k8 steps, the
// context padded to whole k8 steps, 64-row warp tiles of 8 warps, W always
// from L2 (one phase is 0.3-1.1 MB in f32). Its row 3 instance takes given
// states (h0, c0 (L, B, H) and y0 as the past of one step: fused_decode):
// h0 into z, c0 into the lanes' slots of every tile, then the decoder phase
// alone. The bf16 body takes none: fused_decode widens bf16 to f32 and runs
// the f32 instance.

// z's row of the serve body, in P::E: [x or y (kx_of(d)) | ctx (c, padded to
// whole k-steps) | h of every layer | PAD]
template <typename P = Bf16Mma>
__host__ __device__ inline int ctx_pad(int c) { return (c + P::KS - 1) / P::KS * P::KS; }
template <typename P = Bf16Mma>
__host__ __device__ inline int serve_ldz(int d, int c, int h, int layers) {
  return kx_of<P>(d) + ctx_pad<P>(c) + layers * h + P::PAD;
}
// uint4s of one phase's packed W: layer 0 (k_in0 + h k-rows), then layers - 1 of 2h
template <typename P = Bf16Mma>
__host__ __device__ inline long long phase_w_u4(int k_in0, int h, int layers) {
  return ((long long)k_in0 + h + (long long)(layers - 1) * 2 * h) / P::KS * kstride_of(h);
}

constexpr int SERVE_MAX_D = 4;  // coordinates a token the serve body takes

// Shared memory of a serve block, in this order: W (when resident: the
// larger phase's), c (when in shared memory), z, the staging of the new h
// (E rows of H + 8), proj_w transposed (d x h f32), and with STEP_CTX
// ctx_t+1 (rp x c f32).
template <typename P = Bf16Mma>
__host__ __device__ inline long long serve_smem_bytes(int rp, int d, int c, int h, int layers, bool w_res,
                                                      bool c_smem, bool step_ctx) {
  constexpr int e = sizeof(typename P::E);
  const int kx = kx_of<P>(d), kxc = kx + ctx_pad<P>(c);
  const long long w = phase_w_u4<P>(kx, h, layers) > phase_w_u4<P>(kxc, h, layers) ? phase_w_u4<P>(kx, h, layers)
                                                                                     : phase_w_u4<P>(kxc, h, layers);
  long long s = w_res ? 16 * w : 0;
  s += c_smem ? 4LL * layers * rp * h : 0;
  s += (long long)e * rp * serve_ldz<P>(d, c, h, layers) + (long long)e * rp * (h + 8) + 4LL * d * h;
  return s + (step_ctx ? 4LL * rp * c : 0);
}

// The pieces of the serve body that the training forward (lstm_common.cuh
// train_fwd_kernel, the decoder phase in a training mode) runs too. Every
// thread of the block calls each; the block holds rows p0 .. p0 + nrows - 1
// of the batch in rp rows of z (row stride ldz), the rows past the batch
// zero where z is read.

// every uint4 of n16 · 16 bytes at p to zero
__device__ __forceinline__ void zero16(void* p, int n16) {
  for (int i = threadIdx.x; i < n16; i += blockDim.x) reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
}

// A context's pieces of 4 columns, piece i row i / (C / 4), columns 4·(i %
// (C / 4)) .., from src(r) (the row's context of the step): straight into
// z's context columns zc (ctx_load), or by cp.async into the f32 staging cst
// (rp x C; ctx_stage, `any` a valid address for the rows past the batch,
// which land as zeros) and from there into zc once the thread's own copies
// landed (ctx_land).
template <typename P, typename Src>
__device__ __forceinline__ void ctx_load(typename P::E* zc, int ldz, int rp, int nrows, int C, Src src) {
  for (int i = threadIdx.x; i < rp * C / 4; i += blockDim.x) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4;
    if (r < nrows) P::put4(zc + r * ldz + c, __ldg(reinterpret_cast<const float4*>(src(r) + c)));
  }
}
template <typename Src>
__device__ __forceinline__ void ctx_stage(float* cst, int rp, int nrows, int C, Src src, const float* any) {
  for (int i = threadIdx.x; i < rp * C / 4; i += blockDim.x) {
    const int r = i / (C / 4);
    const bool ok = r < nrows;
    cp_async16(cst + 4 * i, ok ? src(r) + (i % (C / 4)) * 4 : any, ok);
  }
  cp_async_commit();
}
template <typename P>
__device__ __forceinline__ void ctx_land(typename P::E* zc, int ldz, const float* cst, int rp, int C) {
  cp_async_wait<0>();
  for (int i = threadIdx.x; i < rp * C / 4; i += blockDim.x) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4;
    P::put4(zc + r * ldz + c, *reinterpret_cast<const float4*>(cst + 4 * i));
  }
}

// Given states: h0 (L, B, H) into z's h columns zh (layer l at zh + l·H),
// c0 into the lanes' slots cm of every tile TL of MT m-tiles: slot (tile
// tau, mt·UT + ut, lane) of layer l holds rows r0 + 16·mt + g and + 8,
// units u0 + 8·ut + 2t and + 1.
template <typename P, int MT, typename TL>
__device__ __forceinline__ void states_load(typename P::E* zh, int ldz, float4* cm, const float* __restrict__ h0,
                                            const float* __restrict__ c0, int B, long long p0, int nrows, int rp,
                                            int H, int L) {
  const int bands = H / TL::UNITS;
  for (int i = threadIdx.x; i < L * rp * H / 4; i += blockDim.x) {
    const int l = i / (rp * H / 4), r = i % (rp * H / 4) / (H / 4), u = i % (H / 4) * 4;
    const float4 v = r < nrows ? __ldg(reinterpret_cast<const float4*>(h0 + ((size_t)l * B + p0 + r) * H + u))
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    P::put4(zh + r * ldz + l * H + u, v);
  }
  for (int i = threadIdx.x; i < L * rp * H / 4; i += blockDim.x) {
    const int l = i / (rp * H / 4), k = i % (rp * H / 4), ln = k % 32, j = k / 32 % (MT * TL::UT);
    const int tau = k / 32 / (MT * TL::UT), mt = j / TL::UT, ut = j % TL::UT;
    const int row = tau / bands * TL::ROWS + 16 * mt + (ln >> 2);
    const int unit = tau % bands * TL::UNITS + 8 * ut + 2 * (ln & 3);
    const float* src = c0 + ((size_t)l * B + p0 + row) * H + unit;
    const float2 lo = row < nrows ? __ldg(reinterpret_cast<const float2*>(src)) : make_float2(0.0f, 0.0f);
    const float2 hi = row + 8 < nrows ? __ldg(reinterpret_cast<const float2*>(src + 8 * H)) : make_float2(0.0f, 0.0f);
    cm[i] = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
}

// the staging est (the new h of a layer-step, rows of lde) into z's h
// columns zh of its layer
template <typename E>
__device__ __forceinline__ void publish(E* zh, int ldz, const E* est, int lde, int rp, int H) {
  constexpr int EV = 16 / sizeof(E);  // elements a uint4
  for (int i = threadIdx.x; i < rp * H / EV; i += blockDim.x) {
    const int r = i / (H / EV), u = (i % (H / EV)) * EV;
    *reinterpret_cast<uint4*>(zh + r * ldz + u) = *reinterpret_cast<const uint4*>(est + r * lde + u);
  }
}

// y = h_top · proj_w + proj_b on the FMA units from the staging est (h_top
// as the tier rounds it): 8 threads a row, thread part p of row r summing
// units 32·j + 4·p .. + 3 (j < H / 32), all D (<= MAXD) outputs at once,
// then the 8 parts; the part-0 thread of a row in the batch hands output i
// to sink(r, i, y). Every row of the block, so that whole warps shuffle.
// w4(i, u): proj_w's column i at units u .. u + 3.
template <typename P, int MAXD, typename W4, typename Sink>
__device__ __forceinline__ void project(const typename P::E* est, int lde, int rp, int nrows, int H, int D,
                                        const float* __restrict__ proj_b, W4 w4, Sink sink) {
  const int part = threadIdx.x & 7;
  for (int r = threadIdx.x >> 3; r < rp; r += blockDim.x >> 3) {
    float s[MAXD] = {};
    for (int u = 4 * part; u < H; u += 32) {
      const float4 hv = P::get4(est + r * lde + u);
#pragma unroll
      for (int i = 0; i < MAXD; ++i) {
        if (i < D) {
          const float4 w = w4(i, u);
          s[i] = fmaf(hv.x, w.x, s[i]);
          s[i] = fmaf(hv.y, w.y, s[i]);
          s[i] = fmaf(hv.z, w.z, s[i]);
          s[i] = fmaf(hv.w, w.w, s[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAXD; ++i) {
      if (i < D) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], 1);
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], 2);
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], 4);
        if (part == 0 && r < nrows) sink(r, i, s[i] + __ldg(proj_b + i));
      }
    }
  }
}

template <typename P, int MT, bool STEP_CTX>
__device__ __forceinline__ void server(const float* __restrict__ past, const float* __restrict__ ctx,
                                       float* __restrict__ out, const uint4* __restrict__ w_enc,
                                       const uint4* __restrict__ w_dec, const float* const* b_enc,
                                       const float* const* b_dec, const typename P::E* __restrict__ proj_w,
                                       const float* __restrict__ proj_b, int B, int T_in, int T_out, int D, int C,
                                       int H, int L, const Geom& geo, const float* __restrict__ h0 = nullptr,
                                       const float* __restrict__ c0 = nullptr) {
  using TL = BodyTile<P, MT, STEP_CTX>;
  using E = typename P::E;
  constexpr bool STATES = std::is_same<P, Tf32Mma>::value;  // the f32 body takes given states
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int rp = geo.rp, kx = kx_of<P>(D), kxc = kx + ctx_pad<P>(C), ldz = serve_ldz<P>(D, C, H, L), lde = H + 8;
  const int bands = H / TL::UNITS, tiles = rp / TL::ROWS * bands;
  const int kstride = kstride_of(H);  // uint4s of a k-step of packed W
  const long long p0 = (long long)blockIdx.x * rp;
  const int nrows = (int)min((long long)rp, (long long)B - p0);  // the block's rows in the batch
  LstmProbe pr(g_lstm_probe);

  char* sp = reinterpret_cast<char*>(smem4);
  uint4* ws = reinterpret_cast<uint4*>(sp);
  if (geo.w_res) sp += 16 * max(phase_w_u4<P>(kx, H, L), phase_w_u4<P>(kxc, H, L));
  float4* cm;
  if (geo.c_glob) {
    cm = reinterpret_cast<float4*>(geo.c_glob + (size_t)blockIdx.x * L * rp * H);
  } else {
    cm = reinterpret_cast<float4*>(sp);
    sp += (size_t)4 * L * rp * H;
  }
  E* z = reinterpret_cast<E*>(sp);
  sp += sizeof(E) * rp * ldz;
  E* est = reinterpret_cast<E*>(sp);  // the new h of a layer-step (rounded in bf16), rows of H + 8
  sp += sizeof(E) * rp * lde;
  float* pwt = reinterpret_cast<float*>(sp);  // proj_w transposed, (D, H) f32
  sp += (size_t)4 * D * H;
  float* cst = reinterpret_cast<float*>(sp);  // STEP_CTX: ctx_t+1 (rp, C)

  // a phase's packed W (k_in0 + H k-rows at layer 0): copied into ws where
  // resident, else read where it is
  auto w_phase = [&](const uint4* wg, int k_in0) {
    if (!geo.w_res) return wg;
    const long long n = phase_w_u4<P>(k_in0, H, L);
    for (long long i = tid; i < n; i += nthr) ws[i] = wg[i];
    return static_cast<const uint4*>(ws);
  };
  // One layer-step of every tile: [za | zb] · W_l + b_l on the tensor
  // cores, the cell on the accumulators with c from the lanes' slots of
  // layer l, the new h into est.
  auto layer_tiles = [&](const uint4* wl, const float* bl, const E* za, int ks_a, int l) {
    const E* zb = z + kxc + l * H;
    float4* cl0 = cm + (size_t)l * rp * H / 4 + lane;
    for (int tau = warp; tau < tiles; tau += nwarps) {
      const int r0 = tau / bands * TL::ROWS, u0 = tau % bands * TL::UNITS;
      float acc[MT][TL::UT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ut = 0; ut < TL::UT; ++ut)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][ut][q][e] = 0.0f;
      tile_product<P, MT, STEP_CTX ? TF32_CHUNK_STEP_CTX : TF32_CHUNK>(acc, za + r0 * ldz, ks_a, zb + r0 * ldz,
                                                                      H / P::KS, wl + tau % bands * TL::NP * 32 + lane,
                                                                      kstride, ldz, lane);
      pr.mark(LP_PRODUCTS);
      float4* cs = cl0 + (size_t)tau * MT * TL::UT * 32;
      auto b_of = [&](int, int q, int unit) { return __ldg(reinterpret_cast<const float2*>(bl + q * H + unit)); };
      auto c_get = [&](int mt, int ut) { return cs[(mt * TL::UT + ut) * 32]; };
      auto c_set = [&](int mt, int ut, float4 c) { cs[(mt * TL::UT + ut) * 32] = c; };
      cell<MT>(acc, r0, u0, lane, b_of, c_get, c_set,
               [&](int row, int unit, float h0, float h1) { P::put2(est + row * lde + unit, h0, h1); });
      pr.mark(LP_CELL);
    }
  };
  // the layer-l slice of a phase's packed W (k_in0 + H k-rows at layer 0)
  auto w_layer = [&](const uint4* w_all, int k_in0, int l) {
    return w_all + (l ? (size_t)((k_in0 + H) / P::KS + (l - 1) * (2 * H / P::KS)) * kstride : 0);
  };
  auto x_at = [&](int t, int i) {
    const int r = i / D, d = i - r * D;
    return r < nrows ? ldg_now(past + ((p0 + r) * T_in + t) * D + d) : 0.0f;
  };
  auto x_put = [&](int i, float v) {
    const int r = i / D;
    z[r * ldz + (i - r * D)] = P::cvt(v);
  };
  auto ctx_src = [&](int t) {  // row r's context of step t
    return [ctx, p0, T_out, C, t](int r) {
      return ctx + (STEP_CTX ? ((size_t)(p0 + r) * T_out + t) * C : (size_t)(p0 + r) * C);
    };
  };

  zero16(cm, L * rp * H / 4);
  zero16(z, rp * ldz * (int)sizeof(E) / 16);
  for (int i = tid; i < D * H; i += nthr) pwt[i] = P::wide(proj_w[(i % H) * D + i / H]);
  const bool states = STATES && h0 != nullptr;
  const uint4* wa = states ? w_enc : w_phase(w_enc, kx);
  __syncthreads();  // z zeroed before x_0 and the first context land in it
  for (int i = tid; i < rp * D; i += nthr) x_put(i, x_at(0, i));
  // the static context, or ctx_0: z's ctx columns, which the encoder does not read
  ctx_load<P>(z + kx, ldz, rp, nrows, C, ctx_src(0));
  if constexpr (STATES) {
    if (states) {  // given states: h0 into z's h columns, c0 into the lanes' slots of every tile
      states_load<P, MT, TL>(z + kxc, ldz, cm, h0, c0, B, p0, nrows, rp, H, L);
      pr.mark(LP_STATES);
    }
  }
  __syncthreads();  // W, z and c in place
  pr.mark(LP_FEEDBACK);

  // -- the encoder over T_in steps; layer 0's A is [x | h_0]
  for (int t = 0; t < (states ? 0 : T_in); ++t) {
    // the thread's first element of x_t+1, loaded ahead of the products
    const float xr = t + 1 < T_in && tid < rp * D ? x_at(t + 1, tid) : 0.0f;
    pr.mark(LP_STAGE);
    for (int l = 0; l < L; ++l) {
      layer_tiles(w_layer(wa, kx, l), b_enc[l], l ? z + kxc + (l - 1) * H : z, (l ? H : kx) / P::KS, l);
      __syncthreads();  // every tile of the layer-step read z; the staging is whole
      pr.mark(LP_BARRIERS);
      publish(z + kxc + l * H, ldz, est, lde, rp, H);
      pr.mark(LP_PUBLISH);
      if (l == 0 && t + 1 < T_in) {  // layer 0 has read x_t
        if (tid < rp * D) x_put(tid, xr);
        for (int i = tid + nthr; i < rp * D; i += nthr) x_put(i, x_at(t + 1, i));
        pr.mark(LP_STAGE);
      }
      __syncthreads();  // z holds this layer's h (and x_t+1) for the next layer or step
      pr.mark(LP_BARRIERS);
    }
  }

  // -- the decoder over T_out steps from the encoder's (h, c) or the given
  // states; y_0 = x_T_in-1 (or y0) is in z; layer 0's A is [y | ctx | h_0]
  wa = w_phase(w_dec, kxc);  // over the encoder's W: every warp is past its last product
  __syncthreads();
  pr.mark(LP_FEEDBACK);
  for (int t = 0; t < T_out; ++t) {
    if (STEP_CTX && t + 1 < T_out) {  // ctx_t+1 lands in cst during this step's products
      ctx_stage(cst, rp, nrows, C, ctx_src(t + 1), ctx);
      pr.mark(LP_STAGE);
    }
    for (int l = 0; l < L; ++l) {
      layer_tiles(w_layer(wa, kxc, l), b_dec[l], l ? z + kxc + (l - 1) * H : z, (l ? H : kxc) / P::KS, l);
      __syncthreads();
      pr.mark(LP_BARRIERS);
      publish(z + kxc + l * H, ldz, est, lde, rp, H);
      pr.mark(LP_PUBLISH);
      if (l == L - 1) {  // y = h_top · proj_w + proj_b: out[b, t], and the next step's y in z
        project<P, SERVE_MAX_D>(
            est, lde, rp, nrows, H, D, proj_b,
            [&](int i, int u) { return *reinterpret_cast<const float4*>(pwt + i * H + u); },
            [&](int r, int i, float y) {
              out[((size_t)(p0 + r) * T_out + t) * D + i] = y;
              z[r * ldz + i] = P::cvt(y);
            });
        pr.mark(LP_FEEDBACK);
      }
      if (STEP_CTX && l == 0 && t + 1 < T_out) {  // layer 0 has read ctx_t: ctx_t+1 into z
        ctx_land<P>(z + kx, ldz, cst, rp, C);
        pr.mark(LP_STAGE);
      }
      __syncthreads();  // z holds this layer's h (the next step's y and ctx) for the next layer or step
      pr.mark(LP_BARRIERS);
    }
  }
}

// ---------------------------------------------------------------------------
// The one-step cell in both tiers (lstm_cell_kernel<ST> in fused_serve.cu,
// replacing the Pallas _cell_kernel of
// longterm360fov_tpu/ops/fused_lstm.py::fused_lstm_cell): x (B, D), h and c
// (B, H), W (D + H, 4H) and b (4H,) stored in the tier's E (f32, or bf16 on
// a bf16 model, whose h and c it writes in bf16); the gates f32 sums, the
// cell the encoders' exact-f32 cell on the accumulators. The f32 tier's
// products run in three-pass TF32 (Tf32Mma), the bf16 tier's are the exact
// products of its bf16 values (Bf16Mma).
//
// What bounds it on the card (B = 16384, D = 3 or 128, H = 128): one step
// has no recurrence to keep on chip. f32: 2.3-4.3 GFLOP of products, three
// times that in three-pass TF32 (14-26 µs at 495 / 3 TFLOP/s), against
// 34-42 MB in and out (10-13 µs at 3.35 TB/s); bf16: 17-21 MB (5-6 µs)
// against 2.4-4.3 GFLOP (2.5-4.4 µs on mma.sync). Then the cell's exact
// sigmoids and tanhs, and the L2 reads of W (every row block reads its unit
// block's columns) and of z (every unit block reads its rows').
// What the design does about it:
//   * The grid is (row tiles, unit blocks): one step has no recurrence, so
//     a block need not hold every unit. A block holds R rows and U units of
//     H, all four gates of each, on up to 16 warps. Its warp tiles are 32
//     rows x 16 units (bf16, Tile<2>) or 32 x 8 (f32, Tile<2, 1>) of all four
//     gates, so a lane's accumulators hold the four gates of its (row, unit)
//     pairs and the cell runs in registers. Every hidden and D is taken: a
//     ragged last unit block, or a hidden that is not a whole tile, has zero
//     W columns in the stage and stores nothing past H.
//   * W's columns of the block (every k-row, 4U columns: gate q of the
//     block's units at q·U ..) stay in shared memory where they fit beside
//     the ring, read as stored, with no pack; the block then takes every
//     gridDim.x-th row tile, one block an SM a unit block (cell_block:
//     f32 64 x 64, else 128 x 32; bf16 128 x 64; cell_grid). On the card
//     that ran 8-13 % faster than streaming W beside z, and 128-row blocks
//     2-6 % faster than 64 rows on 8 warps, two blocks an SM (PERF.md §6).
//     Where W does not fit (D or H of several hundred), it streams through
//     the ring beside z, a row tile a block (128 x 32 in f32, x 64 in bf16).
//   * z = [x | h] streams through a ring of CELL_STAGES chunks of CELL_KC =
//     32 k-rows, three in flight, one barrier a chunk (z's R x 32 columns
//     at a row stride 16 bytes past a multiple of 32: ldmatrix's rows on
//     distinct banks). The k-steps (KS = 8 or 16 k-rows) are x's, padded to
//     a whole step, then h's, padded likewise, the k-rows past D or H zeros
//     in the stage, so the ring does not grow with D or H. A thread copies
//     the same 16-byte pieces of every chunk by cp.async (the Tensor Memory
//     Accelerator's bulk copies of whole rows took 1.5x as long, PERF.md
//     §6); a source row that is not whole 16-byte pieces at aligned
//     addresses comes by element (f32: 4-byte cp.async; bf16: loads and one
//     16-byte store), so x and h may sit at any offset (x at D = 3 always
//     does).
//   * f32: A by ldsm_x4 from the stage as TF32 fragments, B read by element
//     from it (row stride 4U + 8 words: a warp's 32 reads on 32 banks), both
//     split by split_fast (on the card, PERF.md §6, the truncating split
//     read within 1.2e-6 of lstm_cell, split_round 9.5e-7 and 5-8 %
//     slower), the three
//     passes into fresh accumulators a chunk (4 k8 steps), then added to the
//     f32 sums, as product_tf32 does. bf16: A by ldsm_x4, B by
//     ldsm_x4_trans from the stage, mma.sync m16n8k16 into the f32 sums.
//   * c loads as pairs before the product, the bias after it; h and c go out
//     as pairs (by element where H is odd).
constexpr int CELL_THREADS = 512;  // the kernel's __launch_bounds__: 128 registers a thread
constexpr int CELL_STAGES = 4;     // chunks of the ring
constexpr int CELL_KC = 32;        // k-rows a chunk
constexpr int CELL_ROWS = 128;     // rows a block that streams W

template <typename P>
using CellTile = Tile<2, std::is_same<P, Tf32Mma>::value ? 1 : 2>;

struct CellGeom {
  int rows, units, warps, w_res;  // w_res: W's columns of the block resident, the block over many row tiles
  long long smem;
};

// row strides of a stage, in E: z's chunk and W's
template <typename P>
__host__ __device__ inline int cell_ldz() { return CELL_KC + P::PAD; }
__host__ __device__ inline int cell_ldw(int units) { return 4 * units + 8; }
// chunks of CELL_KC k-rows: x's k-steps, padded, then h's
template <typename P>
__host__ __device__ inline int cell_chunks(int d, int h) {
  constexpr int KS = P::KS, CK = CELL_KC / KS;
  return ((d + KS - 1) / KS + (h + KS - 1) / KS + CK - 1) / CK;
}

// A block of rows x units: its warps and shared memory, the ring's stages
// (z's chunk, and W's where it is not resident) then, w_res, W's columns of
// the block for every chunk
template <typename P>
__host__ __device__ inline CellGeom cell_geom(int rows, int units, int w_res, int d, int h) {
  using TL = CellTile<P>;
  const long long ring =
      (long long)CELL_STAGES * ((long long)rows * cell_ldz<P>() + (w_res ? 0 : (long long)CELL_KC * cell_ldw(units)));
  const long long wr = w_res ? (long long)cell_chunks<P>(d, h) * CELL_KC * cell_ldw(units) : 0;
  return {rows, units, rows / TL::ROWS * (units / TL::UNITS), w_res, (long long)sizeof(typename P::E) * (ring + wr)};
}

// The tier's block at (d, h) (ops/fused_lstm.py cell_block mirrors it): W
// resident in the first of the candidate blocks (rows x units, 16 warps;
// units no more than h rounded up to whole tiles) whose shared memory holds
// it, else W streamed through the ring in 128-row blocks of 32 (f32) or 64
// (bf16) units
template <typename P>
__host__ __device__ inline CellGeom cell_block(int d, int h) {
  using TL = CellTile<P>;
  constexpr bool F32 = std::is_same<P, Tf32Mma>::value;
  const int whole = (h + TL::UNITS - 1) / TL::UNITS * TL::UNITS;
  const int cand[2][2] = {{F32 ? 64 : 128, 64}, {128, 32}};  // (rows, units) with W resident; bf16 the first
  for (int i = 0; i < (F32 ? 2 : 1); ++i) {
    const CellGeom g = cell_geom<P>(cand[i][0], cand[i][1] < whole ? cand[i][1] : whole, 1, d, h);
    if (g.smem <= SMEM_LIMIT) return g;
  }
  const int streamed = F32 ? 32 : 64;  // units of a streamed block
  return cell_geom<P>(CELL_ROWS, streamed < whole ? streamed : whole, 0, d, h);
}

// whether the kernel takes a block of `rows` x `units` (w_res: W resident)
// at (d, h)
template <typename P>
__host__ __device__ inline bool cell_takes(int rows, int units, int w_res, int d, int h) {
  using TL = CellTile<P>;
  if (rows < TL::ROWS || rows % TL::ROWS || units < TL::UNITS || units % TL::UNITS) return false;
  const CellGeom g = cell_geom<P>(rows, units, w_res, d, h);
  return g.warps <= CELL_THREADS / 32 && g.smem <= SMEM_LIMIT;
}

// A chunk's products of the warp's tile (`ks` of its k-steps): za, z's
// stage at the tile's first row; wb, W's stage at the tile's first unit
// (gate q at wb + q·U). f32: three-pass TF32 in fresh accumulators, then
// into sum; bf16: into sum.
template <typename P, int UT>
__device__ __forceinline__ void cell_chunk(float (&sum)[2][UT][4][4], const typename P::E* za,
                                           const typename P::E* wb, int ldz, int ldw, int U, int ks, int lane) {
  constexpr int CK = CELL_KC / P::KS;
  if constexpr (std::is_same<P, Tf32Mma>::value) {
    float acc[2][4][4] = {};
    const float* ap = za + (lane & 15) * ldz + (lane >> 4) * 4;
    const float* bp = wb + (lane & 3) * ldw + (lane >> 2);  // k-row t, unit g of the n-tile
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      if (j < ks) {
        unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          unsigned r[4];
          ldsm_x4(r, ap + mt * 16 * ldz + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) split_fast(__uint_as_float(r[e]), ah[mt][e], al[mt][e]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) split_fast(bp[(8 * j + 4 * hf) * ldw + q * U], bh[q][hf], bl[q][hf]);
        // a_lo·b_hi, a_hi·b_lo, a_hi·b_hi: the small terms first
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const unsigned(&b)[2] = pass == 1 ? bl[q] : bh[q];
              mma_tf32(acc[mt][q], pass == 0 ? al[mt] : ah[mt], b[0], b[1]);
            }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mt][0][q][e] += acc[mt][q][e];
  } else {
    const bf16* ap = za + (lane & 15) * ldz + (lane >> 4) * 8;
    const bf16* bp = wb + (lane & 15) * ldw + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      if (j < ks) {
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldsm_x4(a[mt], ap + mt * 16 * ldz + 16 * j);
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // a gate's B fragments at a time: 4 registers, not 16, beside the sums
          unsigned bq[4];
          ldsm_x4_trans(bq, bp + 16 * j * ldw + q * U);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(sum[mt][0][q], a[mt], bq[0], bq[1]);
            mma_bf16(sum[mt][1][q], a[mt], bq[2], bq[3]);
          }
        }
      }
    }
  }
}

// One step of the block's row tiles (R rows: blockIdx.x, blockIdx.x +
// gridDim.x, .. of them) and U units (blockIdx.y · U ..); W's columns of
// the block resident in shared memory (w_res) or streamed with z. Every
// thread of the block calls it.
template <typename P>
__device__ __forceinline__ void cell_step(const typename P::E* __restrict__ x, const typename P::E* __restrict__ h,
                                          const typename P::E* __restrict__ c, const typename P::E* __restrict__ w,
                                          const typename P::E* __restrict__ b, typename P::E* __restrict__ h_out,
                                          typename P::E* __restrict__ c_out, int B, int D, int H, int R, int U,
                                          int w_res) {
  using E = typename P::E;
  using TL = CellTile<P>;
  constexpr int KS = P::KS, CK = CELL_KC / KS, PV = 16 / sizeof(E);  // k-steps a chunk; elements a 16-byte piece
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int ldz = cell_ldz<P>(), ldw = cell_ldw(U);
  const int u0 = blockIdx.y * U, nunits = min(U, H - u0);
  const int xsteps = (D + KS - 1) / KS, steps = xsteps + (H + KS - 1) / KS, chunks = (steps + CK - 1) / CK;
  const long long row_tiles = ((long long)B + R - 1) / R;
  const int total = (int)((row_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x) * chunks;  // the block's chunks
  const int stage = R * ldz + (w_res ? 0 : CELL_KC * ldw);  // elements a stage: z's chunk (and W's)
  E* ring = reinterpret_cast<E*>(smem4);
  E* wres = ring + (size_t)CELL_STAGES * stage;  // w_res: W's columns of the block, chunk after chunk
  auto tile_row0 = [&](int ti) { return ((long long)blockIdx.x + (long long)ti * gridDim.x) * R; };
  const auto whole = [](const void* p, int n) { return n % PV == 0 && (reinterpret_cast<size_t>(p) & 15) == 0; };
  const bool x_vec = whole(x, D), h_vec = whole(h, H), w_vec = whole(w, H);

  // PV elements at dst from src, `valid` of them, the rest zeros: one
  // 16-byte cp.async where vec (valid is PV or 0 there), else by element
  auto piece = [&](E* dst, const E* src, bool vec, int valid) {
    if (vec) {
      cp_async16(dst, valid > 0 ? src : w, valid > 0);
    } else if constexpr (std::is_same<P, Tf32Mma>::value) {
#pragma unroll
      for (int e = 0; e < PV; ++e) cp_async4(dst + e, e < valid ? src + e : w, e < valid);
    } else {
      __align__(16) E v[PV];
#pragma unroll
      for (int e = 0; e < PV; ++e) v[e] = e < valid ? src[e] : P::cvt(0.0f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  };
  // A thread's pieces are the same in every chunk: z's column zk of rows
  // zr0, zr0 + zdr, ..; W's gate wq, its columns wu .. of rows wk0, wk0 + wdk,
  // .. (a block's threads are whole rows of pieces of both: R / 8 rows of
  // W's, 32·R / (8 or 4) of z's)
  constexpr int ZP = CELL_KC / PV;  // pieces of a row of z's chunk
  const int zk = tid % ZP * PV, zr0 = tid / ZP, zdr = nthr / ZP;
  const int WP = U / PV, NWP = 4 * WP;  // pieces of a gate's U columns, of a row of W's chunk
  const int wq = tid % NWP / WP, wu = tid % WP * PV, wk0 = tid / NWP, wdk = nthr / NWP;
  const int wvalid = max(0, min(PV, nunits - wu));
  // k-step s = ch·CK + k / KS of chunk ch is x's columns and W's rows KS·s
  // .. (s < xsteps), else h's columns KS·(s - xsteps) .. and W's rows D +
  // KS·(s - xsteps) ..
  auto issue_w = [&](int ch, E* ws) {  // W's chunk ch into ws
    for (int k = wk0; k < CELL_KC; k += wdk) {
      const int s = ch * CK + k / KS;
      const bool xs = s < xsteps;
      const int kr = (xs ? s : s - xsteps) * KS + k % KS;  // the k-row in x's or h's part of W
      const bool ok = s < steps && kr < (xs ? D : H);
      const E* src = w + ((size_t)(xs ? kr : D + kr) * 4 + wq) * H + u0 + wu;
      piece(ws + k * ldw + wq * U + wu, src, w_vec, ok ? wvalid : 0);
    }
  };
  auto issue = [&](int g) {  // the block's chunk g (chunk g % chunks of its tile g / chunks) into its stage
    if (g < total) {
      const int ti = g / chunks, ch = g - ti * chunks;
      const long long r0 = tile_row0(ti);
      const int nr = (int)min((long long)R, (long long)B - r0);
      E* zs = ring + (size_t)(g % CELL_STAGES) * stage;
      const int s = ch * CK + zk / KS;
      const bool xs = s < xsteps;
      const int col = (xs ? s : s - xsteps) * KS + zk % KS, ld = xs ? D : H;
      const int valid = max(0, min(PV, (s >= steps ? 0 : ld) - col));
      const E* src = (xs ? x : h) + r0 * ld + col;
      for (int r = zr0; r < R; r += zdr)
        piece(zs + r * ldz + zk, src + (long long)r * ld, xs ? x_vec : h_vec, r < nr ? valid : 0);
      if (!w_res) issue_w(ch, zs + R * ldz);
    }
    cp_async_commit();
  };
  LstmProbe pr(g_lstm_probe);
  if (w_res)  // every chunk of W, in the first group
    for (int ch = 0; ch < chunks; ++ch) issue_w(ch, wres + (size_t)ch * CELL_KC * ldw);
  for (int g = 0; g < CELL_STAGES - 1; ++g) issue(g);

  // the warp's tile: rows r0 .. of the block, units uw .. of the block
  const int utiles = U / TL::UNITS, r0 = warp / utiles * TL::ROWS, uw = warp % utiles * TL::UNITS;
  const bool tiled = u0 + uw < H;
  const int g8 = lane >> 2, t4 = lane & 3;
  // c, b, h_out and c_out are 16-byte aligned: a pair at an even unit is
  // whole where H is even
  const bool pairs = H % 2 == 0;
  auto ld2 = [&](const E* p, int unit) {  // the pair at p (unit), as stored; 0 past H
    if (pairs && unit < H) return P::ld2(p);
    return P::pair(unit < H ? p[0] : P::cvt(0.0f), unit + 1 < H ? p[1] : P::cvt(0.0f));
  };
  auto st2 = [&](E* p, int unit, float v0, float v1) {  // nothing past H
    if (pairs) {
      if (unit < H) P::put2(p, v0, v1);
    } else {
      if (unit < H) p[0] = P::cvt(v0);
      if (unit + 1 < H) p[1] = P::cvt(v1);
    }
  };
  pr.mark(LP_STATES);

  float sum[2][TL::UT][4][4];
  typename P::E2 cv[2][TL::UT][2];  // c of the lane's pairs, as stored
  for (int g = 0; g < total; ++g) {
    const int ti = g / chunks, ch = g - ti * chunks;
    const long long row0 = tile_row0(ti);
    const int nrows = (int)min((long long)R, (long long)B - row0);
    if (ch == 0) {
      // c of the lane's pairs (rows r0 + 16·mt + g8 and + 8, units u0 + uw +
      // 8·ut + 2·t4 and + 1), loaded before the tile's product; 0 past the
      // batch
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int ut = 0; ut < TL::UT; ++ut) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r0 + 16 * mt + g8 + 8 * hh, unit = u0 + uw + 8 * ut + 2 * t4;
            cv[mt][ut][hh] = ld2(c + (row0 + row) * H + unit, tiled && row < nrows ? unit : H);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[mt][ut][q][e] = 0.0f;
        }
      pr.mark(LP_STATES);
    }
    cp_async_wait<CELL_STAGES - 2>();
    __syncthreads();  // chunk g landed for every thread; the stage of chunk g - 1 is free
    pr.mark(LP_BARRIERS);
    issue(g + CELL_STAGES - 1);
    pr.mark(LP_STAGE);
    const E* zs = ring + (size_t)(g % CELL_STAGES) * stage;
    const E* wst = w_res ? wres + (size_t)ch * CELL_KC * ldw : zs + R * ldz;
    if (tiled) cell_chunk<P>(sum, zs + r0 * ldz, wst + uw, ldz, ldw, U, min(CK, steps - ch * CK), lane);
    pr.mark(LP_PRODUCTS);
    if (tiled && ch == chunks - 1) {
      // the cell on the accumulators; h and c out, nothing past the batch or H
      cell<2>(
          sum, r0, u0 + uw, lane, [&](int, int q, int unit) { return P::wide2(ld2(b + q * H + unit, unit)); },
          [&](int mt, int ut) {
            const float2 lo = P::wide2(cv[mt][ut][0]), hi = P::wide2(cv[mt][ut][1]);
            return make_float4(lo.x, lo.y, hi.x, hi.y);
          },
          [&](int mt, int ut, float4 cn) {
            const int row = r0 + 16 * mt + g8, unit = u0 + uw + 8 * ut + 2 * t4;
            if (row < nrows) st2(c_out + (row0 + row) * H + unit, unit, cn.x, cn.y);
            if (row + 8 < nrows) st2(c_out + (row0 + row + 8) * H + unit, unit, cn.z, cn.w);
          },
          [&](int row, int unit, float h0, float h1) {
            if (row < nrows) st2(h_out + (row0 + row) * H + unit, unit, h0, h1);
          });
      pr.mark(LP_CELL);
    }
  }
}

}  // namespace lstm_mma
