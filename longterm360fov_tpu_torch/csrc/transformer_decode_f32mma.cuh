// The transformer decode's f32 tier on the tensor cores: the rollout of one
// block of R = 64 or 32 batch rows (transformer_decode.cu's
// ar_decode_kernel<float, R>) in exact-f32 semantics: every product on
// three-pass TF32 (transformer_tf32.cuh: 22 significant bits of each
// operand, f32 sums), the attention, LN, GELU, δv, the residual stream and
// the self cache in f32. in_proj and out_proj (d <= 4) stay on the FMA
// units.
//
// What bounds it on the card (transformer-30 at B = 16384: L = 2, 30 + 30
// steps, K = 4 peers, 120 peer tokens; NVIDIA H100 80GB HBM3):
//   * the K/V re-read. A row's K/V over two layers is about 370 KB in f32
//     against 227 KB of shared memory a block, so every step reads the
//     self, cross and peer K/V of its rows from device memory again: about
//     165 tokens x 1 KB a row-layer-step, 160 GB a call, about 49 ms at
//     3.35 TB/s, twice row 9c's (the bf16 tier's) floor. This is the floor
//     of any design that keeps the K/V in device memory; the bound of
//     PERF.md counts each K/V once.
//   * the products: 16·H² MACs a row-layer-step, 0.52 TFLOP at B = 16384,
//     3.2 ms at 495 / 3 TFLOP/s (three passes of TF32).
// What the design does about it (row 9c's block layout, transformer_
// decode_mma.cuh, on f32 operands):
//   * Products on mma.sync m16n8k8, three passes (product, tile_out of
//     transformer_tf32.cuh), over 16 warps: warp w the 32 x 16 tile at rows
//     32·(w % 2), columns 16·(w / 2) of a 64-row block, or the 16 x 16 tile
//     at rows 16·(w % 2), columns 16·(w / 2) of a 32-row one. B is Wᵀ,
//     k-contiguous, as the wrapper passes it (ops/transformer_encode.py
//     stored_matrix); the
//     stream runs in row 9c's fixed order (DecOrder: self Wq, Wk, Wv, Wo;
//     cross Wq, Wo; peer Wq, Wo; W1's four 128-column slabs; W2's four
//     128-row slabs), chunks of KC = 16 k-columns split into (hi, lo)
//     planes among the previous chunk's mma, across the attention, the
//     layer norms, the layers and the steps; one block barrier a chunk.
//   * 16 warps a block (512 threads, one block an SM) of R = 64 rows
//     (210,944 bytes), or of R = 32 rows (125,952 bytes) where 64-row blocks
//     would leave SMs idle, chosen by the wrapper as row 9c's
//     (ops/transformer_decode.py decode_rows).
//   * The attention: row 9c's Attend on f32 K/V: a warp a query row, each
//     half-warp on its own tokens, a lane 8 dims of a token (two 16-byte
//     loads of K and two of V), 2 tokens a half-warp scored before one
//     rescale; the windowed ranges walked as one run; masked and
//     out-of-window tokens not read; exactly 0 where no token is
//     attendable, δv included.
// Shared memory of a block (R rows), five (R, LDX) f32 buffers:
//   xs  the residual stream x
//   hs  the LN outputs and the attention outputs (the products' A rows)
//   q, k, v  the attention's q, k, v; the MLP's hidden layer u in four
//       128-column slabs, over q, k, v and, for the last slab, over hs once
//       W1's last product has read it
//   the ring of the weight stream (two stages of hi and lo planes, 40,960
//   bytes), and ys (R, MAX_D) the fed-back token.
// A probe build (-DTFM_PROBE) splits each block's clocks by part
// (transformer_probe.cuh's DecPart: the products' chunk barriers under
// DP_WAIT, their mma loops with the staging of the next chunk under
// DP_PROD).

#pragma once

#include "transformer_decode_mma.cuh"
#include "transformer_tf32.cuh"

namespace tfm {
namespace dec {

constexpr int F32_KC = 16;  // k-columns of Wᵀ a chunk of the f32 weight stream

// The block of R rows of the f32 body: 16 warps, the products' tiles, the
// ring and the shared memory.
template <int R>
struct F32Shape {
  static constexpr int THREADS = MMA_THREADS;
  static constexpr int WARPS = MMA_WARPS;
  using TL = Tiling<R, WARPS>;
  using RG = Ring<F32_KC, THREADS>;
  static constexpr int SMEM = (5 * R * LDX + RG::FLOATS + R * MAX_D) * (int)sizeof(float);
  static_assert(SMEM <= 232448, "a block may have 227 KB of shared memory");
};

// The rollout's 128 x 128 blocks of Bᵀ = Wᵀ in DecOrder's order: block b is
// block j = b % per_layer of layer (b / per_layer) % layers. The matrices'
// slots of the pointer table hold Wᵀ: Wq..Woᵀ (H, H), W1ᵀ (4H, H), W2ᵀ
// (H, 4H).
struct DecF32Src {
  const DecParams* p;
  int layers;
  bool peers;
  int per_layer;  // blocks a layer-step: 16 or 14

  __device__ __forceinline__ const float* operator()(int b, int& ld) const {
    const float* const* w = p->layer[(b / per_layer) % layers];
    int j = b % per_layer;
    ld = H;
    if (j < 4) return w[S_WQ + j];  // self Wq, Wk, Wv, Wo
    if (j < 6) return w[j == 4 ? C_WQ : C_WO];
    if (peers) {
      if (j < 8) return w[j == 6 ? P_WQ : P_WO];
      j -= 2;
    }
    if (j < 10) return w[W1] + (size_t)(j - 6) * H * H;  // W1ᵀ rows 128·(j - 6)..: W1's columns
    ld = MLP;
    return w[W2] + (j - 10) * H;  // W2ᵀ columns 128·(j - 10)..: W2's k-rows
  }
};

// Y[r] = LN(X[r]) for every row r of the block's R (a warp a row, R / 16
// rows a warp at once): layer_norm<float>'s arithmetic, f32, row stride LDX
template <int R>
__device__ __forceinline__ void layer_norm_f32(const float* X, float* Y, const float* __restrict__ scale,
                                               const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  const float4 s = __ldg(reinterpret_cast<const float4*>(scale) + lane);
  const float4 b = __ldg(reinterpret_cast<const float4*>(bias) + lane);
#pragma unroll
  for (int i = 0; i < R / MMA_WARPS; ++i) {
    const int r = (threadIdx.x >> 5) + i * MMA_WARPS;
    const float4 x = *reinterpret_cast<const float4*>(X + r * LDX + 4 * lane);
    const float mu = warp_sum((x.x + x.y) + (x.z + x.w)) / (float)H;
    const float4 d = make_float4(x.x - mu, x.y - mu, x.z - mu, x.w - mu);
    const float var = warp_sum((d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w)) / (float)H;
    const float inv = 1.0f / sqrtf(var + 1e-6f);
    *reinterpret_cast<float4*>(Y + r * LDX + 4 * lane) =
        make_float4(d.x * inv * s.x + b.x, d.y * inv * s.y + b.y, d.z * inv * s.z + b.z, d.w * inv * s.w + b.w);
  }
}

// The block's rollout in the f32 tier: rows b0 = blockIdx.x · R .. of the
// batch; smem holds F32Shape<R>::SMEM bytes.
template <int R>
__device__ __forceinline__ void decode_rows_tf32(const DecParams& p, const DecArgs& g, float* self_kv, float* smem) {
  using S = F32Shape<R>;
  using TL = typename S::TL;
  float* xs = smem;
  float* hs = xs + R * LDX;
  float* qb = hs + R * LDX;
  float* kb = qb + R * LDX;
  float* vb = kb + R * LDX;
  float* ys = vb + R * LDX + S::RG::FLOATS;
  const int layers = g.layers, t_out = g.t_out, d = g.d, kt = g.kt;
  const int per_layer = kt > 0 ? CHUNKS : CHUNKS - 2;
  Tf32Stream<F32_KC, DecF32Src, S::THREADS> st;
  st.src = DecF32Src{&p, layers, kt > 0, per_layer};
  st.total = t_out * layers * per_layer * S::RG::CHUNKS;
  st.ring = vb + R * LDX;
  Probe pr(g_dec_probe);
  TileOf<TL> sum;
  // sum = A · (the stream's next block), or += with accumulate
  auto product_ = [&](const float* A, bool accumulate = false) {
    if (!accumulate) zero_tile<TL>(sum);
    product<TL>(A, st, sum, pr, DP_WAIT, DP_PROD);
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, li = lane & 15, half = lane >> 4;
  const int b0 = blockIdx.x * R;
  const int nrows = min(R, g.batch - b0);
  const size_t layer_stride = (size_t)g.batch * t_out * H;  // one layer's self K (or V)

  st.start();  // the first chunk split into its stage, the second in flight, during the prologue
  for (int i = threadIdx.x; i < R * MAX_D; i += S::THREADS) ys[i] = 0.f;
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * d; e += S::THREADS) ys[(e / d) * MAX_D + e % d] = g.y0[(size_t)b0 * d + e];
  sync_dec(pr, DP_IO);

  auto store_to = [](float* dst) {
    return [dst](int r, int c, float v0, float v1) {
      *reinterpret_cast<float2*>(dst + r * LDX + c) = make_float2(v0, v1);
    };
  };
  auto add_to_x = [xs](int r, int c, float v0, float v1) {
    float2* x = reinterpret_cast<float2*>(xs + r * LDX + c);
    *x = make_float2(x->x + v0, x->y + v1);
  };
  // the attention output of row r (half 0's lanes) into hs
  auto put = [hs, li, half](int r, const float (&o)[8]) {
    if (half == 0) {
      float* dst = hs + r * LDX + 8 * li;
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(o[4], o[5], o[6], o[7]);
    }
  };
  float* const slab[MLP / H] = {qb, kb, vb, hs};  // where u's 128-column slabs go

  for (int t = 0; t < t_out; ++t) {
    // x = y · in_proj + pos[t]
    for (int e = threadIdx.x; e < R * H; e += S::THREADS) {
      const int r = e / H, n = e - r * H;
      float acc = ys[r * MAX_D] * __ldg(p.w_in + n);
      for (int i = 1; i < d; ++i) acc = fmaf(ys[r * MAX_D + i], __ldg(p.w_in + i * H + n), acc);
      xs[r * LDX + n] = acc + __ldg(p.pos + t * H + n);
    }
    sync_dec(pr, DP_IO);
    for (int l = 0; l < layers; ++l) {
      const float* const* w = p.layer[l];
      // -- self attention over the cache, this step's k, v appended
      layer_norm_f32<R>(xs, hs, w[LN1_S], w[LN1_B]);
      pr.mark(DP_EPI);
      product_(hs);
      tile_out<TL>(sum, 0, store_to(qb));
      product_(hs);
      tile_out<TL>(sum, 0, store_to(kb));
      product_(hs);
      tile_out<TL>(sum, 0, store_to(vb));
      sync_dec(pr, DP_EPI);  // q, k, v whole; every warp is done with LN1's output
      for (int r = warp; r < nrows; r += S::WARPS) {
        const size_t row = ((size_t)l * g.batch + b0 + r) * t_out * H;
        float* kc = self_kv + row;
        float* vc = self_kv + (size_t)layers * layer_stride + row;
        const Kv8<float> k_now = Kv8<float>::load<false>(kb + r * LDX + 8 * li);
        const Kv8<float> v_now = Kv8<float>::load<false>(vb + r * LDX + 8 * li);
        (half ? v_now : k_now).store((half ? vc : kc) + (size_t)t * H + 8 * li);
        Attend<float> a;
        a.init(qb + r * LDX + 8 * li);
        a.tokens<false>(kc, vc, 1, t, 0, t, t, nullptr);
        const Kv8<float> kn[1] = {k_now}, vn[1] = {v_now};
        const bool on[1] = {half == 0};
        a.add<1>(kn, vn, on);
        float o[8];
        a.out(o);
        put(r, o);
      }
      pr.mark(DP_SELF);
      product_(hs);
      tile_out<TL>(sum, 0, add_to_x);
      sync_dec(pr, DP_EPI);
      // -- cross attention over the encoder's K/V
      layer_norm_f32<R>(xs, hs, w[LN2_S], w[LN2_B]);
      pr.mark(DP_EPI);
      product_(hs);
      tile_out<TL>(sum, 0, store_to(qb));
      sync_dec(pr, DP_EPI);
      for (int r = warp; r < nrows; r += S::WARPS) {
        const size_t row = (size_t)(b0 + r) * g.t_in * H;
        Attend<float> a;
        a.init(qb + r * LDX + 8 * li);
        a.tokens<true>(w[C_K] + row, w[C_V] + row, 1, g.t_in, 0, g.t_in, g.t_in, nullptr);
        float o[8];
        a.out(o);
        put(r, o);
      }
      pr.mark(DP_CROSS);
      product_(hs);
      tile_out<TL>(sum, 0, add_to_x);
      sync_dec(pr, DP_EPI);
      // -- peer attention over the valid (and in-window) peer tokens
      if (kt > 0) {
        layer_norm_f32<R>(xs, hs, w[LN3_S], w[LN3_B]);
        pr.mark(DP_EPI);
        product_(hs);
        tile_out<TL>(sum, 0, store_to(qb));
        sync_dec(pr, DP_EPI);
        const PeerRange pw(g, t);
        for (int r = warp; r < nrows; r += S::WARPS) {
          // the row's own peer memory, or its group's
          const size_t row = (size_t)(g.peer_gid ? __ldg(g.peer_gid + b0 + r) : b0 + r) * kt;
          Attend<float> a;
          a.init(qb + r * LDX + 8 * li);
          a.tokens<true>(w[P_K] + row * H, w[P_V] + row * H, pw.n_seg, pw.seg, pw.lo, pw.len, kt,
                         g.peer_valid + row);
          float o[8];
          if (a.out(o) && g.peer_dv != nullptr) sub_dv(g, b0 + r, l, li, o);  // the anchor correction δv
          put(r, o);
        }
        pr.mark(DP_PEER);
        product_(hs);
        tile_out<TL>(sum, 0, add_to_x);
        sync_dec(pr, DP_EPI);
      }
      // -- MLP: u = gelu(LN4(x) · W1 + b1) in four 128-column slabs (the
      // last over LN4's output once every warp has read it), then
      // x += u · W2 + b2, one sum over the four slabs
      layer_norm_f32<R>(xs, hs, w[LN4_S], w[LN4_B]);
      pr.mark(DP_EPI);
      const float* b1 = w[B1];
      for (int s = 0; s < MLP / H; ++s) {
        product_(hs);
        if (s + 1 == MLP / H) sync_dec(pr, DP_EPI);
        float* u = slab[s];
        tile_out<TL>(sum, s * H, [u, b1, s](int r, int c, float v0, float v1) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + c));
          *reinterpret_cast<float2*>(u + r * LDX + c - s * H) = make_float2(gelu_tanh(v0 + bb.x), gelu_tanh(v1 + bb.y));
        });
      }
      for (int s = 0; s < MLP / H; ++s) product_(slab[s], s > 0);
      const float* b2 = w[B2];
      tile_out<TL>(sum, 0, [xs, b2](int r, int c, float v0, float v1) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + c));
        float2* x = reinterpret_cast<float2*>(xs + r * LDX + c);
        *x = make_float2(x->x + (v0 + bb.x), x->y + (v1 + bb.y));
      });
      sync_dec(pr, DP_EPI);
    }
    // y = LN_f(x) · Wout + bout: out[b, t], and the next step's token
    layer_norm_f32<R>(xs, hs, p.fln_s, p.fln_b);
    sync_dec(pr, DP_EPI);
    for (int r = warp; r < nrows; r += S::WARPS) {
      const float4 h = *reinterpret_cast<const float4*>(hs + r * LDX + 4 * lane);
      for (int i = 0; i < d; ++i) {
        const float* wo = p.w_out + (4 * lane) * d + i;
        float s = h.x * __ldg(wo);
        s = fmaf(h.y, __ldg(wo + d), s);
        s = fmaf(h.z, __ldg(wo + 2 * d), s);
        s = fmaf(h.w, __ldg(wo + 3 * d), s);
        const float y = warp_sum(s) + __ldg(p.b_out + i);
        if (lane == 0) {
          g.out[((size_t)(b0 + r) * t_out + t) * d + i] = y;
          ys[r * MAX_D + i] = y;
        }
      }
    }
    sync_dec(pr, DP_IO);
  }
}

}  // namespace dec
}  // namespace tfm
