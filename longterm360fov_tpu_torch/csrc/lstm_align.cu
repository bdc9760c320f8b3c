// Lockstep-peer scheduled-sampling decoder for training, forward and
// backward, for Hopper (sm_90a), f32 or bf16 compute, residuals in f32 or
// bf16.
//
// Replaces the TPU Pallas kernels of
//   longterm360fov_tpu/ops/lstm_align.py::aligned_ss_decode
// (_fwd_kernel and _bwd_kernel under a jax.custom_vjp). At decoder step t the
// K peer encoders (one LSTM cell of hidden C, shared weights Wp (D + C, 4C),
// from zero state) advance one step on their known windows pxs_t, and
// ctx_t = Σ_k pwt[b, k] · h_k,t (k = 0 .. K - 1 in order, from the f32 h) is
// step t's context; the decoder is lstm_ss.cu's with that per-step context.
// The TPU kernel ran both in one pass over (batch tile, t). Here:
//   * align_peer_fwd_kernel: the peer recurrence over the B·K peer rows,
//     peer row p = b·K + k, on the serve tier's peer context body
//     (lstm_mma.cuh encoder, on the tensor cores in both tiers). A block
//     holds all K peers of RV viewers, so ctx_t is a block-local sum in a
//     fixed order. It writes the peer h and c (B·K, T, C) in the residual
//     type (the gates are not saved: the backward recomputes them, as the
//     TPU backward does) and ctx (B, T, C) f32;
//   * the decoder forward and backward recurrences: lstm_common.cuh's
//     train_fwd_kernel and ss_bwd_kernel (both on the tensor cores) in
//     their per-step mode, SSB_STEP (ctx_t+1 staged by cp.async during step
//     t and rounded into z; dctx_t written per step, not summed over t);
//   * align_peer_bwd_kernel: the peer backward in reverse time, over the
//     peer rows: dh_k,t = pwt[b, k] · dctx_t + the carried dh; the gates
//     recomputed from [pxs_t, h_{t-1}] (h_{t-1} read from the residuals, 0 at
//     t = 0) and c_t, c_{t-1} read from the residuals; it writes the peer
//     dgates (B·K, T, 4C) f32, dpxs (B·K, T, D) and dpwt[b, k] = Σ_t Σ_c
//     dctx_t · h_k,t (the residual h), each row's sum in a fixed order;
//   * the dW/db reductions of lstm_common.cuh: the decoder's (layer 0's
//     context rebuilt from the residual peer h and pwt, as the TPU backward
//     rebuilds it: the DW_ALIGN loader) and the peer encoder's, the
//     teacher-forced loader over the B·K·T rows with z = [pxs_t, h_{t-1}];
//   * dproj: lstm_ss.cu's ss_dproj, launched by the wrapper.
// The bf16 compute type (lstm_common.cuh) rounds the operands of the peer
// gates [pxs_t, h_{t-1}]·Wp in the forward and in the backward's recomputed
// gates alike (the residual h_{t-1} is the forward's h rounded to the residual
// type, whose bf16 rounding is the same), dgates·Wpᵀ and the peer dW; ctx_t
// is formed from the unrounded h and rounded only where it enters the
// decoder's layer-0 product; dpwt is an elementwise sum and stays f32.
// The dependencies allow the split: the peer forward reads nothing of the
// decoder, and the decoder backward hands dctx_t to the peers and takes
// nothing back. So the peer recurrences run over B·K rows (K times the
// decoder's), and only the decoder's serial feedback chain runs at B rows.
//
// What bounds it on the card, at stacked-ss-crossuser-10s's training shapes
// (B = 4096, K = 7, T = 100, D = 3, C = H = 128, L = 2):
//   * Arithmetic. The peer forward is 2·B·K·T·(D + C)·4C = 385 GFLOP, the
//     decoder forward 216 GFLOP; the backward recurrences the same again
//     plus the peers' recomputed gates (385); the dW reductions as much as
//     the forwards: about 2.3 TFLOP a step. The peer forward (2.33 ms), the
//     decoder backward (1.31 ms) and the peer backward's 770 GFLOP run on
//     the tensor cores as three-pass TF32 (495 / 3 TFLOP/s: 4.67 ms; with
//     bf16 residuals the gates' h part, 376 GFLOP, is exact in TF32 and
//     takes two passes: 3.90 ms; 11.5 ms on the FMA units), or in bf16
//     (0.78 ms at 989 TFLOP/s); so does the decoder forward (1.31 ms in
//     three-pass TF32).
//   * Bytes. bf16 peer residuals are 2C·2 bytes a row-step: 1.5 GB a pass;
//     the peer dgates (4C f32) 5.9 GB, written once and read once: 1.75 ms
//     each way at 3.35 TB/s, the bf16 peer backward's bound (2.27 ms with
//     its residual reads).
// What the design does about it: lstm_train.cu's forward body for the
// decoder forward (the serve kernel's decoder phase on the tensor cores,
// every carry on chip, W streamed from L2), and the split above, which
// gives the peer kernels K times the rows. The peer forward, which in that design took
// 19.2-19.3 ms, runs the serve tier's peer context body (lstm_mma.cuh),
// which stores the residual h (from its f32 staging) and c (from the
// lanes' slots) in 16-byte pieces along whole rows during the publish;
// the decoder backward (19.4-19.8 ms) is lstm_common.cuh's tensor-core body
// (its header says how). The peer backward, which in that
// design took 54 ms, 35 % of the f32 train step, read all of Wp and
// Wp[D:]ᵀ (530 KB) from L2 every step for 16 rows and ran its two products
// (43.7 % of its time the dh product, 28.7 % the recomputed gates, by its
// probe build) on the FMA units: it is a block of 4 to 8 warps of 16 rows
// each (7 at this shape: 256 blocks, two waves of one block an SM) whose
// products run on mma.sync (PeerTile below): the weights pass as a stream
// of 35 KB planes (f32, split into TF32 hi and lo once a call; 11 KB in
// bf16) through a ring in shared memory, one barrier a plane, each plane
// read by every warp, 112 rows a pass; the gate tiles' accumulators are the
// cell backward's inputs and dz's A operand in place, so dgates never
// leave registers but for their store; the carried dh (and z) live in
// shared memory, the carried dc in registers; z_{t-1}'s rows land by
// cp.async during step t. With bf16 residuals the f32 tier's z is exact in
// TF32: its h part takes two passes. At C = 128 (-Xptxas -v, sm_90a): the
// f32 tier on bf16 residuals 255 registers with 172 bytes of spill stores
// and 92 of loads, 221,984 bytes of shared memory at 7 warps; the bf16 tier
// 255 registers, no spills, 158,240 bytes; f32 residuals (f32 tier) 250,656
// bytes at 7 warps do not fit: 5 warps. Widths: an instance for each C of
// 32, 64, 96 and 128 (the tiles are per C) and D <= 8 (z's x part is one k8
// step, dpxs one n-tile). A wider C is refused: a lane's carried dc and dz
// are C + 4 floats in registers, 132 at C = 128, where the f32 tier
// already takes all 255.

#include "lstm_common.cuh"
#include "probe.cuh"

// The probe build of the peer backward (-DPEER_PROBE): thread 0 of every
// block adds the clock64 ticks it spends in each part of its work to
// g_peer_probe (probe.cuh's ClockProbe); lstm_align_probe_read copies the sums
// out and zeroes them. Without PEER_PROBE the marks compile to nothing.
enum PeerPart {
  PB_STAGE,  // z = [pxs_t, h_{t-1}] into shared memory
  PB_BAR,    // block barriers, with the waits for the weight planes and their copies issued
  PB_GATES,  // the recomputed gates' product [pxs_t, h_{t-1}] · Wp
  PB_CELL,   // the cell backward with its residual and dctx loads
  PB_STORE,  // the dpgates stores
  PB_DH,     // the carried dh = dgates · Wp[D:]ᵀ (with dpxs, its last n-tile)
  PB_DX,     // dpxs = dgates · Wp[:D]ᵀ (the step's end: the carried dh to shared memory, dpxs stored)
  PB_END,    // dpwt
  PB_PARTS
};
__device__ unsigned long long g_peer_probe[PB_PARTS];
#ifdef PEER_PROBE
using PeerProbe = ClockProbe<true>;
#else
using PeerProbe = ClockProbe<false>;
#endif

// ---------------------------------------------------------------------------
// peer forward
// ---------------------------------------------------------------------------

// The serve tier's peer context body (lstm_mma.cuh encoder<P, MT, PEER =
// true>, that of peer_context_kernel in fused_serve.cu) with the residual
// stores: a block holds all K peers of RV viewers (rows p0 = b0·K .., padded
// to whole tiles), f32 compute on three-pass TF32 in 32 x 8 tiles, bf16 on
// bf16 mma in 32- or 16-row tiles, 16 warps; W packed once a call
// (ops/fused_lstm.py pack_weights_tf32, pack_weights) and the block from
// peer_tf32_rows / peer_tc_rows. Every step stores h and c into php and pcp
// in RT by 16-byte pieces and ctx_t, summed from the f32 h, into ctx.
template <typename RT, typename P, int MT>
__global__ void __launch_bounds__(512)
    align_peer_fwd_kernel(const float* __restrict__ pxs, const float* __restrict__ pwt, float* __restrict__ ctx,
                          const uint4* __restrict__ w, const float* __restrict__ bp, RT* __restrict__ php,
                          RT* __restrict__ pcp, int B, int K, int T, int D, int C, int RV, const lstm_mma::Geom geo) {
  const float* bias[1] = {bp};
  const long long p0 = (long long)blockIdx.x * RV * K;
  lstm_mma::encoder<P, MT, true, RT>(pxs, pwt, ctx, w, bias, p0, B * K, RV * K, T, D, C, 1, K, RV, B, geo, php, pcp);
}

// The f32 peer forward with its staging of h in device memory (geo.h_glob),
// as fused_serve.cu's peer_context_glob_kernel: a kernel of its own, so that
// align_peer_fwd_kernel keeps its staging in shared memory.
template <typename RT>
__global__ void __launch_bounds__(512)
    align_peer_fwd_glob_kernel(const float* __restrict__ pxs, const float* __restrict__ pwt,
                               float* __restrict__ ctx, const uint4* __restrict__ w, const float* __restrict__ bp,
                               RT* __restrict__ php, RT* __restrict__ pcp, int B, int K, int T, int D, int C, int RV,
                               const lstm_mma::Geom geo) {
  const float* bias[1] = {bp};
  const long long p0 = (long long)blockIdx.x * RV * K;
  lstm_mma::encoder<lstm_mma::Tf32Mma, 2, true, RT, true>(pxs, pwt, ctx, w, bias, p0, B * K, RV * K, T, D, C, 1, K,
                                                          RV, B, geo, php, pcp);
}

// ---------------------------------------------------------------------------
// peer backward recurrence
// ---------------------------------------------------------------------------

// The peer backward's tiles for C = 8·NQ. A warp owns 16 peer rows (one
// m16 tile of mma.sync) for every step; a block of `warps` warps shares one
// stream of weight planes. Its unit chunk q (units 8q .. 8q + 7) is the
// four gate tiles (i, f, g, o) of those 8 units: the gates' product
// z_t · Wz[:, chunk] gives a lane the four gates of its (row, unit) pairs
// in the m16n8 accumulator layout, the cell backward runs on them in
// registers, and the same registers are the A operand of the chunk's term
// of dz = dgates · Wzᵀ (k = the chunk's 32 gate columns), summed over the
// chunks in registers. z and dz are feature-ordered [h (C), x (D), zeros]
// (Wz: Wp's rows D.. then 0 .. D - 1, then zero rows), so that h starts a
// row and dz's last n-tile is dpxs.
//   * f32 (three-pass TF32): KZ = C + 8 features (whole k8 steps; D <= 8).
//     Plane P1 (the gates' B, n-major): 32 gate columns x KZ, each k8 step
//     a lane's float4 {hi(k0 + t), hi(k0 + t + 4), lo(k0 + t), lo(k0 + t +
//     4)} at row n = nt·8 + g (a row is 2·KZ floats, ≡ 16 mod 32: the two
//     rows of a quarter-warp's loads fall on the two halves of the banks).
//     Plane P2 (dz's B, c-major): KZ rows c x the 32 gate columns, the k
//     order of each gate's 8 columns permuted so that the gate tile's
//     accumulators (c0, c1 at columns 2t, 2t + 1) are its A fragment (k = t
//     ↔ column 2t, k = t + 4 ↔ 2t + 1): a lane's float4 {hi(2t), hi(2t + 1),
//     lo(2t), lo(2t + 1)} of row c = nt·8 + g, the gate's 16-float group at
//     position gi ^ (c & 1) of the 64-float row (conflict-free).
//   * bf16: KZ = C + 16 (whole k16 steps). P1: 32 rows of KZ + 8 bf16 (the
//     padding puts ldmatrix's 8 rows on distinct banks); P2: C + 16 rows c
//     (dh, dpxs, zero rows to pair the n-tiles) of 40 bf16 (32 gate columns
//     in their natural order: two gate tiles are one k16 A fragment).
template <typename CT, int NQ>
struct PeerTile {
  static constexpr bool BF = !std::is_same<CT, float>::value;
  static constexpr int C = 8 * NQ;
  static constexpr int KZ = BF ? C + 16 : C + 8;  // z features, whole k-steps
  static constexpr int NT = BF ? NQ + 2 : NQ + 1;  // dz n-tiles: dh, dpxs (bf16: and a zero tile)
  static constexpr int LDZ = BF ? KZ + 8 : KZ + 4;  // z row stride (elements)
  static constexpr int RS1 = BF ? KZ + 8 : 2 * KZ;  // P1 row stride
  static constexpr int RS2 = BF ? 40 : 64;           // P2 row stride
  static constexpr int KC = BF ? C + 16 : C + 8;     // P2 rows
  static constexpr int P1 = 32 * RS1, P2 = KC * RS2;
  static constexpr int STAGE = P1 > P2 ? P1 : P2;    // elements of a ring stage (a plane)
  static constexpr int NSTAGE = BF ? 3 : 2;          // planes in the ring
  static_assert(STAGE * sizeof(CT) % 16 == 0 && LDZ * sizeof(CT) % 16 == 0, "16-byte rows");
};

// Shared memory of a block: the ring, then per warp its z (CT), its raw h
// rows (RT, the next step's, landing by cp.async), its raw x (16 x 8 f32)
// and its carried dh (16 x C f32, lane-private float4s).
template <typename RT, typename CT, int NQ>
__host__ __device__ constexpr int peer_warp_bytes() {
  using L = PeerTile<CT, NQ>;
  return 16 * L::LDZ * (int)sizeof(CT) + 16 * L::C * (int)sizeof(RT) + 16 * 8 * 4 + 16 * L::C * 4;
}

// ... and last the ring's mbarriers (32 bytes)
template <typename RT, typename CT, int NQ>
__host__ __device__ constexpr int peer_smem_bytes(int warps) {
  using L = PeerTile<CT, NQ>;
  return L::NSTAGE * L::STAGE * (int)sizeof(CT) + warps * peer_warp_bytes<RT, CT, NQ>() + 32;
}

// The weight planes' copies by the Tensor Memory Accelerator: one thread
// asks for a whole plane (cp.async.bulk), whose bytes complete the phase of
// the stage's mbarrier; every thread waits on that phase.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// two consecutive residual values, widened
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The weight stream: Wp (D + C, 4C) f32 → 2·NQ planes (P1, P2 of each unit
// chunk) of STAGE elements, in the layouts above; f32 split into TF32 hi and
// lo (cvt.rna, as split_tf32), bf16 rounded.
template <typename CT, int NQ>
__global__ void align_peer_wprep_kernel(const float* __restrict__ wp, CT* __restrict__ out, int D) {
  using L = PeerTile<CT, NQ>;
  constexpr int C = L::C, G = 4 * C;
  auto w = [&](int k, int j, int q) {  // Wz[k][chunk q's gate column j]
    const int row = k < C ? D + k : (k < C + D ? k - C : -1);
    return row < 0 ? 0.0f : wp[(size_t)row * G + (j >> 3) * C + 8 * q + (j & 7)];
  };
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < 2 * NQ * L::STAGE; e += gridDim.x * blockDim.x) {
    const int plane = e / L::STAGE, x = e % L::STAGE, q = plane >> 1;
    if constexpr (L::BF) {
      float v = 0.0f;
      if (!(plane & 1)) {
        const int n = x / L::RS1, k = x % L::RS1;
        if (n < 32 && k < L::KZ) v = w(k, n, q);
      } else {
        const int c = x / L::RS2, j = x % L::RS2;
        if (c < L::KC && j < 32) v = w(c, j, q);
      }
      out[e] = __float2bfloat16_rn(v);
    } else {
      float v = 0.0f;
      int pl = 0;
      if (!(plane & 1)) {
        const int n = x / L::RS1, r = x % L::RS1, kk = r >> 4, s = r & 15;
        pl = (s >> 1) & 1;
        if (n < 32) v = w(8 * kk + 4 * (s & 1) + (s >> 2), n, q);
      } else {
        const int c = x / L::RS2, r = x % L::RS2, gi = (r >> 4) ^ (c & 1), s = r & 15;
        pl = (s >> 1) & 1;
        if (c < L::KC) v = w(c, 8 * gi + 2 * (s >> 2) + (s & 1), q);
      }
      unsigned hi, lo;
      split_tf32(v, hi, lo);
      out[e] = __uint_as_float(pl ? lo : hi);
    }
  }
}

// The gates' product of one unit chunk for the warp's 16 rows: pre[gate][e]
// = z · Wz[:, chunk] in the accumulator layout (e: rows g, g, g + 8, g + 8;
// units 2t, 2t + 1). bf16: one pass into pre. f32: three passes, the small
// terms in their own accumulators (eight independent chains), added last;
// ZX: z's h part (its first NQ k8 steps) is exact in TF32 (bf16
// residuals), so its lo is 0 and those steps take two passes, a_hi · b_lo
// and a_hi · b_hi.
template <typename CT, int NQ, bool ZX>
__device__ __forceinline__ void peer_gates(const CT* z, const CT* st, float (&pre)[4][4]) {
  using L = PeerTile<CT, NQ>;
  const int lane = threadIdx.x & 31;
  if constexpr (L::BF) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pre[n][e] = 0.0f;
    const CT* za = z + (lane & 15) * L::LDZ + (lane >> 4) * 8;
    const CT* pb = st + (((lane >> 4) << 3) | (lane & 7)) * L::RS1 + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < L::KZ / 16; ++kk) {
      unsigned a[4];
      ldsm_x4(a, za + kk * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned b[4];
        ldsm_x4(b, pb + np * 16 * L::RS1 + kk * 16);
        mma_bf16(pre[2 * np], a, b[0], b[1]);
        mma_bf16(pre[2 * np + 1], a, b[2], b[3]);
      }
    }
  } else {
    float small[4][4] = {}, big[4][4] = {};
    const float* za = z + (lane & 15) * L::LDZ + (lane >> 4) * 4;
    const float* pb = st + (lane >> 2) * L::RS1 + 4 * (lane & 3);
    auto step = [&](int kk, bool exact) {
      unsigned ah[4], al[4];
      ldsm_x4(ah, za + kk * 8);
      if (!exact) {
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(ah[e]), ah[e], al[e]);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const uint4 b = *reinterpret_cast<const uint4*>(pb + n * 8 * L::RS1 + kk * 16);
#ifndef PEER_ONE_PASS
        if (!exact) mma_tf32(small[n], al, b.x, b.y);
        mma_tf32(small[n], ah, b.z, b.w);
#endif
        mma_tf32(big[n], ah, b.x, b.y);
      }
    };
#pragma unroll 4
    for (int kk = 0; kk < NQ; ++kk) step(kk, ZX);
    step(NQ, false);  // z's x part, f32
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pre[n][e] = big[n][e] + small[n][e];
  }
}

// dz += dgates · Wzᵀ over one unit chunk's 32 gate columns (dg: the four
// gate tiles, the A operand in place). f32: three passes, small terms first.
template <typename CT, int NQ>
__device__ __forceinline__ void peer_dz(const CT* st, const float (&dg)[4][4],
                                        float (&dz)[PeerTile<CT, NQ>::NT][4]) {
  using L = PeerTile<CT, NQ>;
  const int lane = threadIdx.x & 31;
  if constexpr (L::BF) {
    const CT* pb = st + (((lane >> 4) << 3) | (lane & 7)) * L::RS2 + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      const unsigned a[4] = {bf16x2(dg[2 * kp][0], dg[2 * kp][1]), bf16x2(dg[2 * kp][2], dg[2 * kp][3]),
                             bf16x2(dg[2 * kp + 1][0], dg[2 * kp + 1][1]),
                             bf16x2(dg[2 * kp + 1][2], dg[2 * kp + 1][3])};
#pragma unroll
      for (int np = 0; np < L::NT / 2; ++np) {
        unsigned b[4];
        ldsm_x4(b, pb + np * 16 * L::RS2 + kp * 16);
        mma_bf16(dz[2 * np], a, b[0], b[1]);
        mma_bf16(dz[2 * np + 1], a, b[2], b[3]);
      }
    }
  } else {
    const int g = lane >> 2;
    const float* pb = st + g * L::RS2 + 4 * (lane & 3);
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      const float a[4] = {dg[gi][0], dg[gi][2], dg[gi][1], dg[gi][3]};  // k = t ↔ 2t, t + 4 ↔ 2t + 1
      unsigned ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
      const float* pg = pb + ((gi ^ (g & 1)) << 4);
#pragma unroll
      for (int n = 0; n < L::NT; ++n) {
        const uint4 b = *reinterpret_cast<const uint4*>(pg + n * 8 * L::RS2);
#ifndef PEER_ONE_PASS
        mma_tf32(dz[n], al, b.x, b.y);
        mma_tf32(dz[n], ah, b.z, b.w);
#endif
        mma_tf32(dz[n], ah, b.x, b.y);
      }
    }
  }
}

// Block: `warps` warps, warp w the 16 peer rows from (blockIdx.x·warps +
// w)·16. Per step t, in reverse, the 2·NQ planes of the weight stream pass
// through the ring, one block barrier a plane, the next plane(s) in flight
// (thread 0 asks the TMA for a whole plane, bulk_copy); at the first plane
// a warp turns its raw rows (landed by cp.async during the step before)
// into z_t = [h_{t-1}, pxs_t] and starts the copy of step t - 1's. Plane P1 of chunk q: the gates (peer_gates), then the cell
// backward of the chunk's (row, unit) pairs in registers: dh = pwt·dctx_t
// + the carried dh (shared memory), dc (registers, rotated a chunk at a
// time), dgates written to dpg; plane P2: dz += dgates · Wzᵀ (peer_dz).
// After the last chunk dz's dh tiles become the carried dh and its last
// tile dpxs_t. dpwt: a lane's sum over t and its units, the 4 lanes of a
// row added in lane order.
template <typename RT, typename CT, int NQ>
__global__ void __launch_bounds__(256, 1)
    align_peer_bwd_kernel(const float* __restrict__ pxs, const float* __restrict__ pwt,
                          const CT* __restrict__ wstream, const float* __restrict__ bp,
                          const RT* __restrict__ php, const RT* __restrict__ pcp,
                          const float* __restrict__ dctx, float* __restrict__ dpg,
                          float* __restrict__ dpxs, float* __restrict__ dpwt, int P, int K, int T,
                          int D) {
  using L = PeerTile<CT, NQ>;
  constexpr int C = L::C, G = 4 * C, S = 2 * NQ, NS = L::NSTAGE;
  constexpr int STAGE_BYTES = L::STAGE * (int)sizeof(CT);
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  CT* ring = reinterpret_cast<CT*>(smem);
  char* mine = smem + NS * STAGE_BYTES + warp * peer_warp_bytes<RT, CT, NQ>();
  CT* z = reinterpret_cast<CT*>(mine);
  RT* raw = reinterpret_cast<RT*>(mine + 16 * L::LDZ * sizeof(CT));
  float* xraw = reinterpret_cast<float*>(raw + 16 * C);
  float4* dh_old = reinterpret_cast<float4*>(xraw + 16 * 8);
  const long long row0 = ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * 16;
  const long long rows[2] = {row0 + g, row0 + g + 8}, views[2] = {rows[0] / K, rows[1] / K};
  PeerProbe pr(g_peer_probe);

  // z_tt's raw rows: h_{tt-1} (zeros at tt = 0 and past P) and pxs_tt
  auto copy_raw = [&](int tt) {
    constexpr int V = C * (int)sizeof(RT) / 16;  // 16-byte pieces of an h row
    for (int i = lane; i < 16 * V; i += 32) {
      const int r = i / V, v = i % V;
      const long long row = row0 + r;
      const bool ok = row < P && tt > 0;
      const RT* src = ok ? php + ((size_t)row * T + tt - 1) * C + v * (16 / sizeof(RT)) : php;
      cp_async16(reinterpret_cast<char*>(raw) + (r * V + v) * 16, src, ok);
    }
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = i / D, d = i % D;
      const long long row = row0 + r;
      const bool ok = row < P;
      cp_async4(xraw + r * 8 + d, ok ? pxs + ((size_t)row * T + tt) * D + d : pxs, ok);
    }
  };
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      smem + NS * STAGE_BYTES + (blockDim.x >> 5) * peer_warp_bytes<RT, CT, NQ>());
  auto copy_plane = [&](int s) {  // thread 0
    bulk_copy(reinterpret_cast<char*>(ring) + (s % NS) * STAGE_BYTES,
              reinterpret_cast<const char*>(wstream) + (size_t)(s % S) * STAGE_BYTES, STAGE_BYTES, full + s % NS);
  };

  for (int i = lane; i < 16 * L::LDZ; i += 32) z[i] = CT(0.0f);  // z's padding stays 0
  for (int i = lane; i < NQ * 32; i += 32) dh_old[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float wv[2], pw[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) wv[i] = rows[i] < P ? pwt[rows[i]] : 0.0f;
  const int total = T * S;
  copy_raw(T - 1);
  cp_async_commit();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < NS - 1; ++s)
      if (s < total) copy_plane(s);
  }
  __syncthreads();  // the mbarriers initialized

  float dc[NQ][4] = {};        // the carried dc of chunk 0 .. NQ - 1, rotated
  float dz[L::NT][4] = {};     // this step's dz
  float dg[4][4];              // the current chunk's dgates
  pr.mark(PB_STAGE);
  for (int s = 0; s < total; ++s) {
    const int step = s / S, p = s - step * S, q = p >> 1, t = T - 1 - step;
    if (p == 0) {  // z_t from the raw rows (landed during step t + 1), then step t - 1's in flight
      cp_async_wait<0>();
      __syncwarp();
      constexpr int C4 = C / 4;
      for (int i = lane; i < 16 * C4; i += 32) {
        const int r = i / C4, c = (i % C4) * 4;
        float v[4];
        Res<RT>::ld4(raw + r * C + c, v);
        if constexpr (L::BF) {
          *reinterpret_cast<uint2*>(z + r * L::LDZ + c) = make_uint2(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]));
        } else {
          *reinterpret_cast<float4*>(z + r * L::LDZ + c) = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      for (int i = lane; i < 16 * D; i += 32) z[(i / D) * L::LDZ + C + i % D] = CT(xraw[(i / D) * 8 + i % D]);
      __syncwarp();
      if (t > 0) copy_raw(t - 1);
      cp_async_commit();
    }
    pr.mark(PB_STAGE);
    mbar_wait(full + s % NS, (s / NS) & 1);  // plane s landed
    __syncthreads();  // every warp is done with plane s - 1: its stage is free
    if (threadIdx.x == 0 && s + NS - 1 < total) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stage's reads before the copy's writes
      copy_plane(s + NS - 1);
    }
    const CT* st = ring + (s % NS) * L::STAGE;
    pr.mark(PB_BAR);
    if (!(p & 1)) {
      // the chunk's cell inputs, in flight during the gates' product
      const int u = 8 * q + 2 * t4;
      float2 dcx[2], hv[2], ct[2], cp[2], bias[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) bias[n] = *reinterpret_cast<const float2*>(bp + n * C + u);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dcx[i] = hv[i] = ct[i] = cp[i] = make_float2(0.f, 0.f);
        if (rows[i] < P) {
          const size_t qq = (size_t)rows[i] * T + t;
          dcx[i] = *reinterpret_cast<const float2*>(dctx + ((size_t)views[i] * T + t) * C + u);
          hv[i] = ld2(php + qq * C + u);
          ct[i] = ld2(pcp + qq * C + u);
          if (t > 0) cp[i] = ld2(pcp + (qq - 1) * C + u);
        }
      }
      float pre[4][4];
      peer_gates<CT, NQ, std::is_same<RT, __nv_bfloat16>::value>(z, st, pre);
      pr.mark(PB_GATES);
      const float4 dho = dh_old[q * 32 + lane];
      const float dhv[4] = {dho.x, dho.y, dho.z, dho.w};
      float dcn[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, h = e & 1;
        const float dx = h ? dcx[i].y : dcx[i].x, hx = h ? hv[i].y : hv[i].x;
        const float cx = h ? ct[i].y : ct[i].x, px = h ? cp[i].y : cp[i].x;
        const float i_g = sigmoid_f32(pre[0][e] + (h ? bias[0].y : bias[0].x));
        const float f_g = sigmoid_f32(pre[1][e] + (h ? bias[1].y : bias[1].x));
        const float g_g = tanhf(pre[2][e] + (h ? bias[2].y : bias[2].x));
        const float o_g = sigmoid_f32(pre[3][e] + (h ? bias[3].y : bias[3].x));
        const float dh = wv[i] * dx + dhv[e];
        const float tanh_c = tanhf(cx);
        const float dcv = dh * o_g * (1.0f - tanh_c * tanh_c) + dc[0][e];
        dg[0][e] = dcv * g_g * i_g * (1.0f - i_g);
        dg[1][e] = dcv * px * f_g * (1.0f - f_g);
        dg[2][e] = dcv * i_g * (1.0f - g_g * g_g);
        dg[3][e] = dh * tanh_c * o_g * (1.0f - o_g);
        dcn[e] = dcv * f_g;
        pw[i] += dx * hx;
      }
#pragma unroll
      for (int j = 0; j < NQ - 1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dc[j][e] = dc[j + 1][e];
#pragma unroll
      for (int e = 0; e < 4; ++e) dc[NQ - 1][e] = dcn[e];
      pr.mark(PB_CELL);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (rows[i] < P) {
          float* o = dpg + ((size_t)rows[i] * T + t) * G + u;
#pragma unroll
          for (int n = 0; n < 4; ++n) *reinterpret_cast<float2*>(o + n * C) = make_float2(dg[n][2 * i], dg[n][2 * i + 1]);
        }
      pr.mark(PB_STORE);
    } else {
      peer_dz<CT, NQ>(st, dg, dz);
      pr.mark(PB_DH);
      if (q == NQ - 1) {  // dz complete: the carried dh, dpxs_t
#pragma unroll
        for (int n = 0; n < NQ; ++n) dh_old[n * 32 + lane] = make_float4(dz[n][0], dz[n][1], dz[n][2], dz[n][3]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int d = 2 * t4 + h;
            if (rows[i] < P && d < D) dpxs[((size_t)rows[i] * T + t) * D + d] = dz[NQ][2 * i + h];
          }
#pragma unroll
        for (int n = 0; n < L::NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dz[n][e] = 0.0f;
        pr.mark(PB_DX);
      }
    }
  }
  cp_async_wait<0>();
  // dpwt of each row: its four lanes' sums, added in lane order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) s += __shfl_sync(0xffffffffu, pw[i], (lane & ~3) | j);
    if (t4 == 0 && rows[i] < P) dpwt[rows[i]] = s;
  }
  pr.mark(PB_END);
}

// ---------------------------------------------------------------------------
// C interface: each function launches on `stream` and returns
// cudaGetLastError() (0 = ok).
// ---------------------------------------------------------------------------

extern "C" {

// The peer forward's dynamic shared memory (lstm_mma::smem_bytes) in the
// tier (cbf16: bf16) at a block of rp rows in tiles of 16·mt, rows_v·n_peers
// real ones, `warps` warps, W resident (w_res) or streamed, c in shared
// memory (c_smem) or device memory, the staging of h in shared memory (h_smem)
// or device memory; -1 for a block it does not take (f32:
// 32-row tiles, W streamed; bf16: 32- or 16-row tiles; ctx_dim 32, 64, 96
// or 128; at most 16 warps).
long long align_peer_fwd_smem(int d, int ctx_dim, int n_peers, int rows_v, int rp, int mt, int warps, int w_res,
                              int c_smem, int cbf16, int h_smem) {
  const int rows = rows_v * n_peers;
  const bool tiles = cbf16 ? mt == 1 || mt == 2 : mt == 2 && !w_res;
  if (!tiles || d < 1 || d > 8 || ctx_dim < 32 || ctx_dim > 128 || ctx_dim % 32 || n_peers < 1 || rows_v < 1 ||
      rows > rp || rp % (16 * mt) || warps < 1 || warps > 16)
    return -1;
  const long long s =
      cbf16 ? lstm_mma::smem_bytes<lstm_mma::Bf16Mma>(true, rp, rows, d, ctx_dim, 1, w_res, c_smem, h_smem)
            : lstm_mma::smem_bytes<lstm_mma::Tf32Mma>(true, rp, rows, d, ctx_dim, 1, w_res, c_smem, h_smem);
  return s > lstm_mma::SMEM_LIMIT ? -1 : s;
}

// The peer forward: pxs (batch·n_peers, t_len, d) f32, pwt (batch, n_peers),
// w Wp (d + ctx_dim, 4·ctx_dim) packed for the tier (cbf16: pack_weights,
// bf16; else pack_weights_tf32, f32), bp (4·ctx_dim,) → php, pcp
// (batch·n_peers, t_len, ctx_dim) residual type (bf16: bf16), ctx (batch,
// t_len, ctx_dim) f32. The block: rows_v viewers in rp rows, tiles of 16·mt
// rows, `warps` warps, W resident (w_res) or streamed, c in shared memory or,
// where c_glob is given, in c_glob (grid x rp x ctx_dim floats), the staging
// of h in shared memory or, where h_glob is given, in h_glob (grid x
// rows_v·n_peers x ctx_dim floats).
int align_peer_fwd(const void* pxs, const void* pwt, const void* w, const void* bp, void* php, void* pcp, void* ctx,
                   void* c_glob, void* h_glob, int batch, int n_peers, int t_len, int d, int ctx_dim, int rows_v,
                   int rp, int mt, int warps, int w_res, int bf16, int cbf16, void* stream) {
  const long long smem = align_peer_fwd_smem(d, ctx_dim, n_peers, rows_v, rp, mt, warps, w_res, c_glob == nullptr,
                                             cbf16, h_glob == nullptr);
  if (smem < 0 || batch < 1 || t_len < 1 || (long long)batch * n_peers * t_len >= (1LL << 31) || (cbf16 && h_glob))
    return (int)cudaErrorInvalidValue;
  const int grid = (batch + rows_v - 1) / rows_v;
  const lstm_mma::Geom geo{rp, mt, w_res, static_cast<float*>(c_glob), static_cast<float*>(h_glob)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *x = static_cast<const float*>(pxs), *pw = static_cast<const float*>(pwt),
              *b = static_cast<const float*>(bp);
  const uint4* wp = static_cast<const uint4*>(w);
  float* out = static_cast<float*>(ctx);
#define PEER_KERNEL(KERNEL, RT)                                                                                   \
  launch_with_smem(KERNEL, grid, 32 * warps, (size_t)smem, st, x, pw, out, wp, b, static_cast<RT*>(php),        \
                   static_cast<RT*>(pcp), batch, n_peers, t_len, d, ctx_dim, rows_v, geo)
#define PEER_FWD(RT, P, MT) PEER_KERNEL((align_peer_fwd_kernel<RT, P, MT>), RT)
  using BF = __nv_bfloat16;
  using lstm_mma::Bf16Mma;
  using lstm_mma::Tf32Mma;
  if (cbf16) {
    if (bf16) return mt == 2 ? PEER_FWD(BF, Bf16Mma, 2) : PEER_FWD(BF, Bf16Mma, 1);
    return mt == 2 ? PEER_FWD(float, Bf16Mma, 2) : PEER_FWD(float, Bf16Mma, 1);
  }
  if (h_glob)
    return bf16 ? PEER_KERNEL(align_peer_fwd_glob_kernel<BF>, BF)
                : PEER_KERNEL(align_peer_fwd_glob_kernel<float>, float);
  return bf16 ? PEER_FWD(BF, Tf32Mma, 2) : PEER_FWD(float, Tf32Mma, 2);
#undef PEER_FWD
#undef PEER_KERNEL
}

// The decoder's recurrences with a per-step context: ctx and dctx (batch,
// t_len, ctx_dim) f32; otherwise lstm_ss.cu's ss_fwd and ss_bwd.
int align_dec_fwd(const void* w, const void* const* b, void* const* hs, void* const* cs, void* const* gs,
                  const void* h0, const void* c0, const void* y0, const void* teacher, const void* coins,
                  const void* ctx, const void* proj_wt, const void* proj_b, void* ys, void* c_glob, int batch,
                  int t_len, int d, int ctx_dim, int hidden, int layers, int rp, int warps, int bf16, int cbf16,
                  void* stream) {
  if (ctx == nullptr || ctx_dim < 1) return (int)cudaErrorInvalidValue;
  return ss_fwd_launch<true>(w, b, hs, cs, gs, h0, c0, y0, teacher, coins, ctx, proj_wt, proj_b, ys, c_glob, batch,
                             t_len, d, ctx_dim, hidden, layers, rp, warps, bf16, cbf16, stream);
}

// The decoder forward's probe build's sums (-DLSTM_PROBE; LstmPart order,
// LP_PARTS of them) into out, then zeroed; without LSTM_PROBE, zeros.
int train_fwd_probe_read(unsigned long long* out) { return probe_read(g_lstm_probe, out); }

int align_dec_bwd(const void* dys, const void* c0, const void* coins, const void* const* wt, const void* w0x,
                  const void* proj_w, const void* const* cs, const void* const* gs, void* const* dg, void* dy,
                  void* dteacher, void* dy0, void* dh0, void* dc0, void* dctx, int batch, int t_len, int d,
                  int ctx_dim, int hidden, int layers, int bf16, int cbf16, void* stream) {
  if (dctx == nullptr || ctx_dim < 1) return (int)cudaErrorInvalidValue;
  return ss_bwd_launch<true>(dys, c0, coins, wt, w0x, proj_w, cs, gs, dg, dy, dteacher, dy0, dh0, dc0, dctx, batch,
                             t_len, d, ctx_dim, hidden, layers, bf16, cbf16, stream);
}

// The peer backward's dynamic shared memory at warps warps a block, or -1
// for a ctx_dim it does not take (32, 64, 96 and 128 only).
int peer_bwd_smem(int ctx_dim, int warps, int bf16, int cbf16) {
  using BF = __nv_bfloat16;
#define SMEM(NQ)                                                                              \
  return bf16 ? (cbf16 ? peer_smem_bytes<BF, BF, NQ>(warps) : peer_smem_bytes<BF, float, NQ>(warps)) \
              : (cbf16 ? peer_smem_bytes<float, BF, NQ>(warps) : peer_smem_bytes<float, float, NQ>(warps))
  switch (ctx_dim) {
    case 32: SMEM(4);
    case 64: SMEM(8);
    case 96: SMEM(12);
    case 128: SMEM(16);
    default: return -1;
  }
#undef SMEM
}

// Bytes of the peer backward's weight stream (the wstream scratch): two
// planes for each chunk of 8 units; -1 for a ctx_dim it does not take.
int peer_bwd_stream_bytes(int ctx_dim, int cbf16) {
#define STREAM(NQ) \
  return 2 * NQ * (cbf16 ? PeerTile<__nv_bfloat16, NQ>::STAGE * 2 : PeerTile<float, NQ>::STAGE * 4)
  switch (ctx_dim) {
    case 32: STREAM(4);
    case 64: STREAM(8);
    case 96: STREAM(12);
    case 128: STREAM(16);
    default: return -1;
  }
#undef STREAM
}

// The peer backward recurrence: warps x 16 peer rows a block (warps <= 8),
// peer_bwd_smem(ctx_dim, warps, bf16, cbf16) bytes of dynamic shared memory;
// ctx_dim 32, 64, 96 or 128, d <= 8. wp is Wp (d + ctx_dim, 4·ctx_dim) f32;
// wstream, peer_bwd_stream_bytes(ctx_dim, cbf16) bytes of scratch, receives
// the weight planes (align_peer_wprep_kernel) before the recurrence reads
// them. dctx (batch, t_len, ctx_dim); out: dpg (batch·n_peers, t_len,
// 4·ctx_dim), dpxs (batch·n_peers, t_len, d), dpwt (batch, n_peers).
int align_peer_bwd(const void* pxs, const void* pwt, const void* wp, void* wstream,
                   const void* bp, const void* php, const void* pcp, const void* dctx, void* dpg,
                   void* dpxs, void* dpwt, int batch, int n_peers, int t_len, int d, int ctx_dim,
                   int warps, int bf16, int cbf16, void* stream) {
  const long long peers = (long long)batch * n_peers;
  const int smem = peer_bwd_smem(ctx_dim, warps, bf16, cbf16);
  if (batch < 1 || n_peers < 1 || t_len < 1 || d < 1 || d > 8 || smem <= 0 || warps < 1 ||
      warps > 8 || smem > 232448 || peers * t_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int grid = (int)((peers + 16 * warps - 1) / (16 * warps));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *x = static_cast<const float*>(pxs), *w = static_cast<const float*>(pwt),
              *b = static_cast<const float*>(bp), *dc = static_cast<const float*>(dctx),
              *wf = static_cast<const float*>(wp);
  float *o_g = static_cast<float*>(dpg), *o_x = static_cast<float*>(dpxs),
        *o_w = static_cast<float*>(dpwt);
  using BF = __nv_bfloat16;
#define PEER_BWD(RT, CT, NQ)                                                                        \
  do {                                                                                              \
    CT* ws = static_cast<CT*>(wstream);                                                             \
    align_peer_wprep_kernel<CT, NQ><<<64, 256, 0, st>>>(wf, ws, d);                                 \
    return launch_with_smem(align_peer_bwd_kernel<RT, CT, NQ>, grid, 32 * warps, smem, st, x, w, \
                            ws, b, static_cast<const RT*>(php), static_cast<const RT*>(pcp), dc,    \
                            o_g, o_x, o_w, (int)peers, n_peers, t_len, d);                          \
  } while (0)
#define PEER_BWD_C(RT, CT)                   \
  switch (ctx_dim) {                         \
    case 32: PEER_BWD(RT, CT, 4);            \
    case 64: PEER_BWD(RT, CT, 8);            \
    case 96: PEER_BWD(RT, CT, 12);           \
    default: PEER_BWD(RT, CT, 16);           \
  }
  if (bf16 && cbf16) PEER_BWD_C(BF, BF);
  if (bf16) PEER_BWD_C(BF, float);
  if (cbf16) PEER_BWD_C(float, BF);
  PEER_BWD_C(float, float);
#undef PEER_BWD_C
#undef PEER_BWD
}

// dW/db of every decoder layer; layer 0's context rebuilt from php and pwt
// (see ss_dw_layers).
int align_dec_dw(const void* h0, const void* y0, const void* teacher,
                 const void* coins, const void* php, const void* pwt,
                 const void* ys, const void* const* hs, const void* const* cs,
                 const void* const* gs, const void* const* dg, void* zpack,
                 void* partial, void* const* dw, void* const* db, int batch,
                 int t_len, int d, int ctx_dim, int n_peers, int hidden,
                 int layers, int splits, int bf16, int cbf16, int pack_layer,
                 void* stream) {
  if (php == nullptr || pwt == nullptr || n_peers < 1 || ctx_dim < 32 || ctx_dim % 32)
    return (int)cudaErrorInvalidValue;  // C as the peer kernels take it
  return ss_dw_layers<DW_ALIGN>(h0, y0, teacher, coins, nullptr, php, pwt, n_peers, ys,
                      hs, cs, gs, dg, zpack, partial, dw, db, batch, t_len, d, ctx_dim,
                      hidden, layers, splits, bf16, cbf16, pack_layer, stream);
}

// dWp (d + ctx_dim, 4·ctx_dim) and dbp over the peers·t_len rows:
// z = [pxs_t, h_{t-1}] (h0 = zeros (peers, ctx_dim) f32 at t = 0), the
// teacher-forced loader. zpack holds peers·t_len x dw_zld(d, ctx_dim) values
// of the compute type, `partial` splits x (d + ctx_dim + 1) x 4·ctx_dim
// floats. pack_only: only the pack pass, into zpack.
int align_peer_dw(const void* pxs, const void* h0, const void* php,
                  const void* dpg, void* zpack, void* partial, void* dw, void* db,
                  int peers, int t_len, int d, int ctx_dim, int splits,
                  int bf16, int cbf16, int pack_only, void* stream) {
  if (peers < 1 || t_len < 1 || d < 1 || ctx_dim < 32 || ctx_dim % 32 ||
      splits < 1 || (long long)peers * t_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  DwArgs a = {};
  a.xs = static_cast<const float*>(pxs);
  a.h0 = static_cast<const float*>(h0);
  a.hs = php;
  a.dg = static_cast<const float*>(dpg);
  return (int)dw_layer<DW_TF>(a, zpack, static_cast<float*>(partial), static_cast<float*>(dw),
                       static_cast<float*>(db), peers, t_len, d, ctx_dim, d, d,
                       splits, bf16 != 0, cbf16 != 0, pack_only != 0,
                       static_cast<cudaStream_t>(stream));
}

// The probe build's clock counters (PeerPart order, PB_PARTS of them) into
// out, then zeroed; without PEER_PROBE, zeros.
int lstm_align_probe_read(unsigned long long* out) { return probe_read(g_peer_probe, out); }

// The decoder backward's probe counters (lstm_common.cuh SsbPart order,
// SB_PARTS of them) into out, then zeroed; without SSB_PROBE, zeros.
int ss_bwd_probe_read(unsigned long long* out) { return probe_read(g_ssb_probe, out); }

const char* lstm_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
