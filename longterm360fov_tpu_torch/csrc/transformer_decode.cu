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
//     42 K for the attention: 36.5 MFLOP a row, 0.60 TFLOP at B = 16384,
//     8.9 ms at the 67 TFLOP/s f32 FMA peak.
//   * Bytes: the K/V the rollout reads, counted once, is 5.0 GB at
//     B = 16384 (1.5 ms at 3.35 TB/s). But the caches do not fit on chip:
//     per row and layer the peer K/V is 123 KB, the cross K/V 31 KB, the
//     self K/V 31 KB, 370 KB a row over two layers against 227 KB of shared
//     memory a block. They live in device memory, and every step re-reads
//     them: about 151 GB at B = 16384, 45 ms at 3.35 TB/s, five times the
//     operations bound. This simple design is up against that re-read.
// What the design does about it:
//   * A block holds 64 batch rows' activations in shared memory
//     (transformer_common.cuh) and runs every product of a step as gemm64:
//     one weight element read from L2 feeds 64 FMAs; the 2.1 MB of decoder
//     weights stay in L2 and stream through a cp.async ring in shared memory.
//   * The attention is a warp a row, all four heads at once (8 lanes a
//     head): each token's K and V row is one coalesced 512-byte read, eight
//     tokens in flight a warp, an online softmax over them. Masked peer
//     tokens and those outside the window are not read: the work follows
//     the data. A position with no attendable peer token adds exactly 0, as
//     the model's per-position gate does.
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
// sums; LN, softmax, q, GELU, δv and the residual stream in f32
// (Store<T>, transformer_common.cuh). It halves the K/V bytes that bound the
// per-row tier (about 80 GB re-read at B = 16384 for transformer-30). Its
// body is decode_rows_mma (transformer_decode_mma.cuh): the products on the
// tensor cores (mma.sync bf16), 64- or 32-row blocks of 16 warps chosen by
// the wrapper, and the attention two tokens a warp in 16-byte pieces, G at
// a time a half-warp. Before, it was the FMA body below instanced on bf16, which a
// build with -DDEC_FMA still launches (scripts/torch_decode_bf16_probe.py
// times the two in turns; the wrapper never loads that build).
// The JAX shared tier rounds q and the softmax weights to bf16 for its MXU
// products; here every tier attends with f32 q and weights.
// A probe build (-DTFM_PROBE) splits each block's clocks by part
// (transformer_probe.cuh's DecPart), read by transformer_decode_probe_read.
// Later work (not here): keeping a block's K/V on chip across steps.

#include <type_traits>

#include "transformer_decode_mma.cuh"

namespace {

using namespace tfm;

// The FMA body, the f32 tier's (and, in a -DDEC_FMA build, the bf16
// tier's): a block of ROWS = 64 rows, THREADS = 256. T: the stored type of
// the matrices, the cross and peer K/V and the self cache (Store<T>): float,
// or __nv_bfloat16, whose activation operands are rounded to bf16 where
// they are written.
template <typename T>
__device__ __forceinline__ void decode_rows_fma(const DecParams& p, const float* __restrict__ y0,
                                                const unsigned char* __restrict__ peer_valid,
                                                const int* __restrict__ peer_gid,
                                                const float* __restrict__ peer_dv, T* self_kv,
                                                float* __restrict__ out, int batch, int layers, int t_in,
                                                int t_out, int d, int kt, int window, int seg, float4* smem4) {
  Probe pr(g_dec_probe);
  float* xs = reinterpret_cast<float*>(smem4);
  float* hs = xs + ROWS * LDX;
  float* big = hs + ROWS * LDX;
  float* qb = big;
  float* kb = big + ROWS * LDX;
  float* vb = big + 2 * ROWS * LDX;
  float* ab = big + 3 * ROWS * LDX;
  float* ws = big + BIG;  // gemm64's ring of weight slabs
  float* ys = ws + WS_FLOATS;  // (ROWS, MAX_D) the fed-back token
  const int b0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, batch - b0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t layer_stride = (size_t)batch * t_out * H;  // one layer's self K (or V)

  zero_smem(xs, SMEM_FLOATS + ROWS * MAX_D);
  sync_dec(pr, DP_IO);
  for (int e = threadIdx.x; e < nrows * d; e += THREADS)
    ys[(e / d) * MAX_D + e % d] = y0[(size_t)b0 * d + e];
  sync_dec(pr, DP_IO);

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
  auto add_to_x = [xs](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) xs[(r0 + r) * LDX + c0 + c] += acc[r][c];
  };

  for (int t = 0; t < t_out; ++t) {
    // x = y · in_proj + pos[t]
    const T* w_in = as<T>(p.w_in);
    for (int e = threadIdx.x; e < ROWS * H; e += THREADS) {
      const int r = e / H, n = e - r * H;
      float acc = Store<T>::round(ys[r * MAX_D]) * Store<T>::ldg1(w_in + n);
      for (int i = 1; i < d; ++i)
        acc = fmaf(Store<T>::round(ys[r * MAX_D + i]), Store<T>::ldg1(w_in + i * H + n), acc);
      xs[r * LDX + n] = acc + __ldg(p.pos + t * H + n);
    }
    sync_dec(pr, DP_IO);
    for (int l = 0; l < layers; ++l) {
      const float* const* w = p.layer[l];
      // -- self attention over the cache, this step's k, v appended
      layer_norm<T>(xs, hs, w[LN1_S], w[LN1_B]);
      sync_dec(pr, DP_EPI);
      gemm64(hs, LDX, H, as<T>(w[S_WQ]), H, 0, ws, store_to(qb));
      gemm64(hs, LDX, H, as<T>(w[S_WK]), H, 0, ws, store_to(kb));
      gemm64(hs, LDX, H, as<T>(w[S_WV]), H, 0, ws, store_to(vb));
      sync_dec(pr, DP_PROD);
      for (int r = warp; r < nrows; r += THREADS / 32) {
        const size_t row = ((size_t)l * batch + b0 + r) * t_out * H;
        T* kc = self_kv + row;
        T* vc = self_kv + (size_t)layers * layer_stride + row;
        // this step's k, v as the cache holds them (rounded to T)
        const float4 k = round4<T>(*reinterpret_cast<const float4*>(kb + r * LDX + 4 * lane));
        const float4 v = round4<T>(*reinterpret_cast<const float4*>(vb + r * LDX + 4 * lane));
        Store<T>::store4(kc + (size_t)t * H + 4 * lane, k);
        Store<T>::store4(vc + (size_t)t * H + 4 * lane, v);
        Attend a;
        a.init(*reinterpret_cast<const float4*>(qb + r * LDX + 4 * lane));
        a.range<false, 8>(kc, vc, H, 0, t, nullptr);
        a.add(k, v);
        *reinterpret_cast<float4*>(ab + r * LDX + 4 * lane) = round4<T>(a.out());
      }
      sync_dec(pr, DP_SELF);
      gemm64(ab, LDX, H, as<T>(w[S_WO]), H, 0, ws, add_to_x);
      sync_dec(pr, DP_PROD);
      // -- cross attention over the encoder's K/V
      layer_norm<T>(xs, hs, w[LN2_S], w[LN2_B]);
      sync_dec(pr, DP_EPI);
      gemm64(hs, LDX, H, as<T>(w[C_WQ]), H, 0, ws, store_to(qb));
      sync_dec(pr, DP_PROD);
      for (int r = warp; r < nrows; r += THREADS / 32) {
        const size_t row = (size_t)(b0 + r) * t_in * H;
        Attend a;
        a.init(*reinterpret_cast<const float4*>(qb + r * LDX + 4 * lane));
        a.range<true, 8>(as<T>(w[C_K]) + row, as<T>(w[C_V]) + row, H, 0, t_in, nullptr);
        *reinterpret_cast<float4*>(ab + r * LDX + 4 * lane) = round4<T>(a.out());
      }
      sync_dec(pr, DP_CROSS);
      gemm64(ab, LDX, H, as<T>(w[C_WO]), H, 0, ws, add_to_x);
      sync_dec(pr, DP_PROD);
      // -- peer attention over the valid (and in-window) peer tokens
      if (kt > 0) {
        layer_norm<T>(xs, hs, w[LN3_S], w[LN3_B]);
        sync_dec(pr, DP_EPI);
        gemm64(hs, LDX, H, as<T>(w[P_WQ]), H, 0, ws, store_to(qb));
        sync_dec(pr, DP_PROD);
        for (int r = warp; r < nrows; r += THREADS / 32) {
          // the row's own peer memory, or its group's
          const size_t row = (size_t)(peer_gid ? __ldg(peer_gid + b0 + r) : b0 + r) * kt;
          const T* pk = as<T>(w[P_K]) + row * H;
          const T* pv = as<T>(w[P_V]) + row * H;
          const unsigned char* valid = peer_valid + row;
          Attend a;
          a.init(*reinterpret_cast<const float4*>(qb + r * LDX + 4 * lane));
          if (window <= 0) {
            a.range<true, 8>(pk, pv, H, 0, kt, valid);
          } else {
            // token i sits at t_k = i % seg of its segment: per segment, the
            // tokens with |t_k - t| <= window
            for (int s0 = 0; s0 < kt; s0 += seg)
              a.range<true, 8>(pk, pv, H, s0 + max(0, t - window),
                            min(kt, min(s0 + seg, s0 + t + window + 1)), valid);
          }
          float4 o = a.out();
          if (peer_dv != nullptr && a.any) {  // the anchor correction δv
            const float4 dv = __ldg(
                reinterpret_cast<const float4*>(peer_dv + ((size_t)(b0 + r) * layers + l) * H) + lane);
            o = make_float4(o.x - dv.x, o.y - dv.y, o.z - dv.z, o.w - dv.w);
          }
          *reinterpret_cast<float4*>(ab + r * LDX + 4 * lane) = round4<T>(o);
        }
        sync_dec(pr, DP_PEER);
        gemm64(ab, LDX, H, as<T>(w[P_WO]), H, 0, ws, add_to_x);
        sync_dec(pr, DP_PROD);
      }
      // -- MLP: u = gelu(LN4(x) · W1 + b1) into big, then x += u · W2 + b2
      layer_norm<T>(xs, hs, w[LN4_S], w[LN4_B]);
      sync_dec(pr, DP_EPI);
      const float* b1 = w[B1];
      auto gelu_to_u = [big, b1](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            big[(r0 + r) * LDU + c0 + c] = Store<T>::round(gelu_tanh(acc[r][c] + __ldg(b1 + c0 + c)));
      };
      for (int n0 = 0; n0 < MLP; n0 += H) gemm64(hs, LDX, H, as<T>(w[W1]), MLP, n0, ws, gelu_to_u);
      sync_dec(pr, DP_PROD);
      const float* b2 = w[B2];
      auto mlp_to_x = [xs, b2](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) xs[(r0 + r) * LDX + c0 + c] += acc[r][c] + __ldg(b2 + c0 + c);
      };
      gemm64(big, LDU, MLP, as<T>(w[W2]), H, 0, ws, mlp_to_x);
      sync_dec(pr, DP_PROD);
    }
    // y = LN_f(x) · Wout + bout: out[b, t], and the next step's token
    layer_norm<T>(xs, hs, p.fln_s, p.fln_b);
    sync_dec(pr, DP_EPI);
    for (int r = warp; r < nrows; r += THREADS / 32) {
      const float4 h = *reinterpret_cast<const float4*>(hs + r * LDX + 4 * lane);
      for (int i = 0; i < d; ++i) {
        const T* wo = as<T>(p.w_out) + (4 * lane) * d + i;
        float s = h.x * Store<T>::ldg1(wo);
        s = fmaf(h.y, Store<T>::ldg1(wo + d), s);
        s = fmaf(h.z, Store<T>::ldg1(wo + 2 * d), s);
        s = fmaf(h.w, Store<T>::ldg1(wo + 3 * d), s);
        const float y = warp_sum(s) + __ldg(p.b_out + i);
        if (lane == 0) {
          out[((size_t)(b0 + r) * t_out + t) * d + i] = y;
          ys[r * MAX_D + i] = y;
        }
      }
    }
    sync_dec(pr, DP_IO);
  }
}

// Does the tier of T run the FMA body: the f32 tier always, the bf16 tier
// only in a -DDEC_FMA build (the design before the tensor cores, kept for
// scripts/torch_decode_bf16_probe.py's comparison in turns)
template <typename T>
__host__ __device__ constexpr bool fma_body() {
#ifdef DEC_FMA
  return true;
#else
  return std::is_same<T, float>::value;
#endif
}

// threads of a block of R rows
template <typename T, int R>
__host__ __device__ constexpr int block_threads() { return fma_body<T>() ? THREADS : dec::Shape<R>::THREADS; }

// dynamic shared memory of a block, bytes
template <typename T, int R>
__host__ __device__ constexpr int smem_bytes() {
  return fma_body<T>() ? (SMEM_FLOATS + ROWS * MAX_D) * (int)sizeof(float) : dec::Shape<R>::SMEM;
}

// T: the stored type of the matrices, the cross and peer K/V and the self
// cache; R: the rows of a block of the bf16 body (the FMA body's are ROWS)
template <typename T, int R>
__global__ void __launch_bounds__(block_threads<T, R>(), 1)
ar_decode_kernel(const DecParams p, const DecArgs g, T* self_kv) {
  extern __shared__ float4 smem4[];
  if constexpr (fma_body<T>())
    decode_rows_fma<T>(p, g.y0, g.peer_valid, g.peer_gid, g.peer_dv, self_kv, g.out, g.batch, g.layers, g.t_in,
                       g.t_out, g.d, g.kt, g.window, g.seg, smem4);
  else
    dec::decode_rows_mma<R>(p, g, self_kv, reinterpret_cast<unsigned char*>(smem4));
}

template <typename T, int R>
int launch_rows(const DecParams& p, const DecArgs& g, void* self_kv, cudaStream_t stream) {
  const int smem = smem_bytes<T, R>();
  cudaError_t err = cudaFuncSetAttribute(ar_decode_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = fma_body<T>() ? ROWS : R;
  ar_decode_kernel<T, R><<<(g.batch + rows - 1) / rows, block_threads<T, R>(), smem, stream>>>(
      p, g, static_cast<T*>(self_kv));
  return (int)cudaGetLastError();
}

// One launch on `stream`. The f32 tier: grid ceil(batch / 64) blocks of 256
// threads, 210,944 + 1,024 bytes of dynamic shared memory; the bf16 tier:
// blocks of `rows` = 64 or 32 rows (512 threads, 223,232 or 146,432 bytes;
// any other value is refused). y0 (batch, d) f32,
// peer_valid (batch, kt) bytes (0 = masked; null when kt = 0), self_kv
// (2, layers, batch, t_out, 128) scratch, out (batch, t_out, d) f32;
// layer_ptrs holds 24 device pointers a layer in DecPtr's order (the peer
// ones null when kt = 0). Group-shared peers: peer_gid (batch,) int32 row
// → group in [0, G), and the peer K, V (G, kt, 128) and peer_valid (G, kt)
// hold the G groups'; peer_dv (batch, layers, 128) f32 or null. window <=
// 0: no peer window; else token i of the peer memory is attended at step t
// when |i % seg - t| <= window. In the f32 tier every tensor is f32; in the
// bf16 tier the matrices (the self, cross and peer wq, wk, wv, wo as the
// table lists them, w1, w2), w_in, w_out, the cross and peer K, V and
// self_kv are bf16, the rest f32. Returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a shape the kernel does not take.
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
  if constexpr (fma_body<T>())
    return launch_rows<T, 64>(p, g, self_kv, st);
  else
    return rows == 64 ? launch_rows<T, 64>(p, g, self_kv, st) : launch_rows<T, 32>(p, g, self_kv, st);
}

}  // namespace

extern "C" {

int transformer_decode_f32(const void* y0, const void* peer_valid, const void* peer_gid,
                           const void* peer_dv, void* self_kv, void* out,
                           const void* const* layer_ptrs, const void* w_in, const void* w_out,
                           const void* b_out, const void* fln_s, const void* fln_b,
                           const void* pos, int batch, int layers, int t_in, int t_out, int d,
                           int kt, int window, int seg, void* stream) {
  return launch<float>(y0, peer_valid, peer_gid, peer_dv, self_kv, out, layer_ptrs, w_in, w_out, b_out,
                       fln_s, fln_b, pos, batch, layers, t_in, t_out, d, kt, window, seg, 64, stream);
}

// The bf16 tier, in blocks of `rows` (64 or 32) rows: ops/transformer_decode.py
// decode_rows chooses them from the batch.
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

// the dynamic shared memory of a block of the bf16 tier's body at `rows`
// rows (64 or 32; the FMA body's in a -DDEC_FMA build), bytes
int transformer_decode_smem_bytes(int rows) {
  return rows == 32 ? smem_bytes<__nv_bfloat16, 32>() : smem_bytes<__nv_bfloat16, 64>();
}

const char* transformer_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The probe build's clock counters (tfm::DecPart order, tfm::DEC_PARTS of
// them) since the last read, summed over blocks, into out (host memory);
// zeroes them. Without TFM_PROBE, zeros.
int transformer_decode_probe_read(unsigned long long* out) { return probe_read(tfm::g_dec_probe, out); }

}  // extern "C"
