// The transformer decode's bf16 tier on the tensor cores: the rollout of
// one block of R = 64 or 32 batch rows (transformer_decode.cu's
// ar_decode_kernel<__nv_bfloat16, R>), with the tier's arithmetic
// (Store<__nv_bfloat16>): the matrices, the cross and peer K/V and the
// self cache stored in bf16; every product's activation operand rounded to
// bf16 where it is written (the LN outputs, the attention outputs less δv,
// the GELU output, the fed-back y), the products summed in f32; q, the
// softmax, the LN statistics, the GELU, δv and the residual stream in f32;
// the self cache holds k and v rounded, and the current token's k and v
// are attended as rounded. in_proj (d <= 4) and out_proj stay on the FMA
// units.
//
// What bounds it on the card (transformer-30 at B = 16384: L = 2, 30 + 30
// steps, K = 4 peers, 120 peer tokens; NVIDIA H100 80GB HBM3):
//   * the K/V re-read. A row's K/V over two layers is about 185 KB in bf16
//     against 227 KB of shared memory a block, so every step reads the self,
//     cross and peer K/V of its rows from device memory again: about 165
//     tokens x 512 bytes a row-layer-step, 80 GB a call, about 24 ms at
//     3.35 TB/s (transformer-10s per row at B = 4096, window 8: about 210
//     tokens, 88 GB, 26 ms). This is the floor of any design that keeps the
//     K/V in device memory; the bound of PERF.md counts each K/V once.
//   * the products: 16·H² MACs a row-layer-step, 0.52 TFLOP at B = 16384,
//     under 1 ms on mma.sync at 600-650 TFLOP/s.
// What the design does about it:
//   * Products on mma.sync m16n8k16 (bf16 operands, f32 accumulators):
//     the encoder's gemm_mma and weight stream (transformer_stream.cuh) at
//     R rows, warp w the 16 x TN tile at rows 16·(w % (R / 16)), columns
//     TN·(w / (R / 16)) (TN = 32 at 64 rows, 16 at 32), A from hb or u in
//     bf16 and W read as stored. The stream runs in the layer's fixed order
//     (DecOrder): self Wq, Wk, Wv, Wo; cross Wq, Wo; peer Wq, Wo (with
//     peers); W1's four 128-column slabs; W2's four 128-row slabs: 16 chunks
//     of 128 x 128 (14 without peers), the next chunk in flight while the
//     block computes on one and across the attention, the layer norms, the
//     layers and the steps. One block barrier a chunk.
//   * More warps for the attention: 16 warps a block (512 threads, one
//     block an SM) of R = 64 rows (223,232 bytes), or of R = 32 rows
//     (146,432 bytes) where 64-row blocks would leave SMs idle. The wrapper
//     picks R from the batch (ops/transformer_decode.py decode_rows), so
//     that a batch of 4096 fills 128 SMs, not 64, with twice the warps.
//   * Cheaper attention reads: a warp a query row, each half-warp on its own
//     tokens, a lane 8 dims of a token (16 bytes of K and of V, a head's 32
//     dims on 4 lanes); G tokens a half-warp scored together before one max
//     and one rescale of the online softmax, their 2·G 16-byte loads in
//     flight together; the halves merged at the end. The windowed peer
//     ranges of the K segments are walked as one run of tokens. Masked and
//     out-of-window tokens are not read, and a position with no attendable
//     token adds exactly 0, δv included.
// Shared memory of a block (R rows):
//   xs   (R, LDX)  f32   the residual stream x
//   q, k, v 3 x (R, LDX) f32; the MLP's hidden layer u, (R, LDUB) bf16,
//                  over them once the attention has read them
//   hb   (R, LDB)  bf16  the LN outputs and the attention outputs, each
//                  dead when the next is written
//   ring 2 x (128, LDB) bf16  the weight stream
//   ys   (R, MAX_D) f32  the fed-back token
// A probe build (-DTFM_PROBE) adds in-kernel clock64 counters
// (transformer_probe.cuh's DecPart).

#pragma once

#include "transformer_stream.cuh"

#define MAX_LAYERS 8
#define MAX_D 4

namespace tfm {

// a layer's weights and projected memories: ln1 scale and bias; self wq,
// wk, wv, wo; ln2; cross wq, wo and the cross K, V (batch, t_in, H); ln3;
// peer wq, wo and the peer K, V (batch, kt, H) (null without peers); ln4;
// w1, b1, w2, b2
enum DecPtr {
  LN1_S, LN1_B, S_WQ, S_WK, S_WV, S_WO,
  LN2_S, LN2_B, C_WQ, C_WO, C_K, C_V,
  LN3_S, LN3_B, P_WQ, P_WO, P_K, P_V,
  LN4_S, LN4_B, W1, B1, W2, B2, DEC_PTRS
};

struct DecParams {
  const float* layer[MAX_LAYERS][DEC_PTRS];
  const float* w_in;   // (d, H)
  const float* w_out;  // (H, d)
  const float* b_out;  // (d,)
  const float* fln_s;  // final LN scale, bias (H,)
  const float* fln_b;
  const float* pos;    // (t_out, H) positional encoding
};

// The rollout's inputs beside the weights.
struct DecArgs {
  const float* y0;                  // (batch, d) the last observed position
  const unsigned char* peer_valid;  // (batch or G, kt); null without peers
  const int* peer_gid;              // (batch,) row → group, or null
  const float* peer_dv;             // (batch, layers, H) or null
  float* out;                       // (batch, t_out, d)
  int batch, layers, t_in, t_out, d, kt, window, seg;
};

namespace dec {

constexpr int CHUNKS = 16;  // 128 x 128 chunks of a layer's matrices, with peers
constexpr int G = 4;        // tokens a half-warp scores together

// The block of R rows: 16 warps (gemm_mma's tiles), 4 or 2 rows of the
// attention a warp; the shared memory.
template <int R>
struct Shape {
  static_assert(R == 64 || R == 32, "64 or 32 rows a block");
  static constexpr int THREADS = MMA_THREADS;
  static constexpr int WARPS = MMA_WARPS;
  static constexpr int SMEM = 4 * R * LDX * (int)sizeof(float) + (R * LDB + STAGES * CHUNK) * (int)sizeof(bf16) +
                              R * MAX_D * (int)sizeof(float);
  static_assert(R * LDUB * sizeof(bf16) <= 3 * R * LDX * sizeof(float), "u does not fit over q, k, v");
  static_assert(SMEM <= 232448, "a block may have 227 KB of shared memory");
};

// The rollout's matrices in the order its products read them: chunk g is
// chunk j = g % per_layer of layer (g / per_layer) % layers (steps repeat
// the layers' order).
struct DecOrder {
  const DecParams* p;
  int layers;
  bool peers;
  int per_layer;  // chunks a layer-step: 16 or 14

  __device__ __forceinline__ const bf16* source(int g, int& ldw) const {
    const float* const* w = p->layer[(g / per_layer) % layers];
    int j = g % per_layer;
    ldw = H;
    if (j < 4) return as<bf16>(w[S_WQ + j]);  // self Wq, Wk, Wv, Wo
    if (j < 6) return as<bf16>(w[j == 4 ? C_WQ : C_WO]);
    if (peers) {
      if (j < 8) return as<bf16>(w[j == 6 ? P_WQ : P_WO]);
      j -= 2;
    }
    if (j < 10) {  // W1 (H, MLP): 128-column slab j - 6
      ldw = MLP;
      return as<bf16>(w[W1]) + (j - 6) * 128;
    }
    return as<bf16>(w[W2]) + (size_t)(j - 10) * 128 * H;  // W2 (MLP, H): 128-row slab j - 10
  }
};

// 8 f32 values as 8 bf16 (rounded to nearest), and back (exact)
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(Store<bf16>::pack(v[0], v[1]), Store<bf16>::pack(v[2], v[3]), Store<bf16>::pack(v[4], v[5]),
                    Store<bf16>::pack(v[6], v[7]));
}

__device__ __forceinline__ void widen8(uint4 u, float (&v)[8]) {
  v[0] = Store<bf16>::lo(u.x); v[1] = Store<bf16>::hi(u.x);
  v[2] = Store<bf16>::lo(u.y); v[3] = Store<bf16>::hi(u.y);
  v[4] = Store<bf16>::lo(u.z); v[5] = Store<bf16>::hi(u.z);
  v[6] = Store<bf16>::lo(u.w); v[7] = Store<bf16>::hi(u.w);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// A lane's 8 dims of a token's K or V row as the tier stores them: 16
// bytes of bf16, or 32 bytes of f32 (two 16-byte loads).
template <typename T>
struct Kv8;

template <>
struct Kv8<bf16> {
  uint4 u;
  template <bool kReadOnly>
  __device__ __forceinline__ static Kv8 load(const bf16* p) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    return {kReadOnly ? __ldg(q) : *q};
  }
  __device__ __forceinline__ static Kv8 zero() { return {make_uint4(0, 0, 0, 0)}; }
  __device__ __forceinline__ void widen(float (&v)[8]) const { widen8(u, v); }
  __device__ __forceinline__ void store(bf16* p) const { *reinterpret_cast<uint4*>(p) = u; }
};

template <>
struct Kv8<float> {
  float4 a, b;
  template <bool kReadOnly>
  __device__ __forceinline__ static Kv8 load(const float* p) {
    const float4* q = reinterpret_cast<const float4*>(p);
    return kReadOnly ? Kv8{__ldg(q), __ldg(q + 1)} : Kv8{q[0], q[1]};
  }
  __device__ __forceinline__ static Kv8 zero() {
    return {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  }
  __device__ __forceinline__ void widen(float (&v)[8]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<float4*>(p)[0] = a;
    reinterpret_cast<float4*>(p)[1] = b;
  }
};

// One query row's 4-head attention by one warp over K/V stored in T (bf16
// or f32): half-warp h = lane / 16 runs its own online softmax over its own
// tokens; lane li = lane % 16 holds q, the running output and the
// key/value dims 8·li..8·li+7 (head li / 4: a head's 32 dims on 4 lanes,
// its logit their sum). m is the running max of the head's logits, l the
// sum of exp(logit - m), acc the sum of exp(logit - m) · v. A token that is
// not attended is not read and adds nothing, which is what its -1e9 logit
// gives in the plain version (exp underflows to exactly 0) whenever a
// token is attended. G tokens a half-warp are scored before one rescale: 4
// in bf16, 2 in f32, so that either has 8 loads of 16 bytes in flight a
// lane.
template <typename T>
struct Attend {
  static constexpr int G = 8 / (int)sizeof(T);
  float q[8], acc[8];
  float m, l;

  __device__ __forceinline__ void init(const float* q_row) {
    load8(q_row, q);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    m = -INFINITY;
    l = 0.f;
  }

  // the half-warp's N tokens k[u], v[u] (the lane's 8 dims), those with
  // ok[u]: N logits, then one max and one rescale. Warp-uniform calls (the
  // logit's shuffles); the 4 lanes of a head see the same ok.
  template <int N>
  __device__ __forceinline__ void add(const Kv8<T> (&k)[N], const Kv8<T> (&v)[N], const bool (&ok)[N]) {
    float s[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      float kf[8];
      k[u].widen(kf);
      float d = q[0] * kf[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) d = fmaf(q[i], kf[i], d);
      d += __shfl_xor_sync(FULL, d, 1);
      d += __shfl_xor_sync(FULL, d, 2);
      s[u] = ok[u] ? d * SCALE : -INFINITY;
    }
    float mn = m;
#pragma unroll
    for (int u = 0; u < N; ++u) mn = fmaxf(mn, s[u]);
    if (mn == -INFINITY) return;  // nothing attended yet by this half's head
    const float corr = expf(m - mn);  // 0 for the first tokens (m = -inf)
    l *= corr;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const float p = expf(s[u] - mn);  // 0 for a token not attended
      float vf[8];
      v[u].widen(vf);
      l += p;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
    }
    m = mn;
  }

  // The tokens of n_seg segments of `seg` tokens: in each, the `len` tokens
  // from offset lo (tokens j >= kt dropped), those whose valid[j] is non-zero
  // when valid is given, G a half-warp at a time, all their loads in flight
  // together. K and V row stride H. Kernel-read-only memory (kReadOnly) goes
  // through the read-only path; the self cache, written by the kernel, does
  // not.
  template <bool kReadOnly>
  __device__ __forceinline__ void tokens(const T* K, const T* V, int n_seg, int seg, int lo, int len, int kt,
                                         const unsigned char* valid) {
    const int lane = threadIdx.x & 31, li = lane & 15, half = lane >> 4;
    const int n = n_seg * len;
    for (int v0 = 0; v0 < n; v0 += 2 * G) {
      Kv8<T> kr[G], vr[G];
      bool ok[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int vv = v0 + half * G + u;
        const int sg = n_seg == 1 ? 0 : vv / len;
        const int j = sg * seg + lo + (vv - sg * len);
        ok[u] = vv < n && j < kt && (valid == nullptr || valid[j] != 0);
        kr[u] = vr[u] = Kv8<T>::zero();
        if (ok[u]) {
          kr[u] = Kv8<T>::template load<kReadOnly>(K + (size_t)j * H + 8 * li);
          vr[u] = Kv8<T>::template load<kReadOnly>(V + (size_t)j * H + 8 * li);
        }
      }
      add<G>(kr, vr, ok);
    }
  }

  // the two halves merged → the normalized output for the lane's 8 dims
  // (the same in both halves); false, and zeros, when nothing was attended
  // (the models gate such a peer position to exactly 0)
  __device__ __forceinline__ bool out(float (&o)[8]) const {
    const float mo = __shfl_xor_sync(FULL, m, 16), lo = __shfl_xor_sync(FULL, l, 16);
    float ao[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) ao[i] = __shfl_xor_sync(FULL, acc[i], 16);
    const float mt = fmaxf(m, mo);
    if (mt == -INFINITY) {
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = 0.f;
      return false;
    }
    const float a = expf(m - mt), b = expf(mo - mt);
    const float lt = l * a + lo * b;
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = (acc[i] * a + ao[i] * b) / lt;
    return true;
  }
};

// The peer tokens step t attends: token i sits at t_k = i % seg of its
// segment, so per segment the tokens with |t_k - t| <= window (all of them
// when window <= 0), as Attend::tokens walks them (n_seg, seg, lo, len).
struct PeerRange {
  int n_seg, seg, lo, len;
  __device__ __forceinline__ PeerRange(const DecArgs& g, int t) : n_seg(1), seg(g.kt), lo(0), len(g.kt) {
    if (g.window > 0) {
      n_seg = (g.kt + g.seg - 1) / g.seg;
      seg = g.seg;
      lo = max(0, t - g.window);
      len = max(0, min(g.seg, t + g.window + 1) - lo);
    }
  }
};

// the row's anchor correction δv at layer l subtracted from its 8 dims o
// (the lane's)
__device__ __forceinline__ void sub_dv(const DecArgs& g, int row, int l, int li, float (&o)[8]) {
  const float* dvp = g.peer_dv + ((size_t)row * g.layers + l) * H + 8 * li;
  const float4 d0 = __ldg(reinterpret_cast<const float4*>(dvp));
  const float4 d1 = __ldg(reinterpret_cast<const float4*>(dvp + 4));
  o[0] -= d0.x; o[1] -= d0.y; o[2] -= d0.z; o[3] -= d0.w;
  o[4] -= d1.x; o[5] -= d1.y; o[6] -= d1.z; o[7] -= d1.w;
}

// The block's rollout in the bf16 tier: rows b0 = blockIdx.x · R .. of the
// batch; smem holds Shape<R>::SMEM bytes.
template <int R>
__device__ __forceinline__ void decode_rows_mma(const DecParams& p, const DecArgs& g, bf16* self_kv,
                                                unsigned char* smem) {
  using S = Shape<R>;
  float* xs = reinterpret_cast<float*>(smem);
  float* qb = xs + R * LDX;
  float* kb = qb + R * LDX;
  float* vb = kb + R * LDX;
  bf16* ub = reinterpret_cast<bf16*>(qb);
  bf16* hb = reinterpret_cast<bf16*>(vb + R * LDX);
  bf16* ring = hb + R * LDB;
  float* ys = reinterpret_cast<float*>(ring + STAGES * CHUNK);
  const int layers = g.layers, t_out = g.t_out, d = g.d, kt = g.kt;
  const int per_layer = kt > 0 ? CHUNKS : CHUNKS - 2;
  WeightStream<DecOrder> ws{{&p, layers, kt > 0, per_layer}, t_out * layers * per_layer, ring, 0};
  Probe pr(g_dec_probe);
  auto product = [&](const bf16* A, int lda, int K, int n0, auto epi) {
    gemm_mma<R>(A, lda, K, n0, ws, pr, DP_WAIT, DP_PROD, DP_EPI, epi);
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, li = lane & 15, half = lane >> 4;
  const int b0 = blockIdx.x * R;
  const int nrows = min(R, g.batch - b0);
  const size_t layer_stride = (size_t)g.batch * t_out * H;  // one layer's self K (or V)

  ws.issue();  // the first chunk lands during the prologue
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
  // the attention output of row r (half 0's lanes), rounded, into hb
  auto put = [hb, li, half](int r, const float (&o)[8]) {
    if (half == 0) *reinterpret_cast<uint4*>(hb + r * LDB + 8 * li) = pack8(o);
  };

  for (int t = 0; t < t_out; ++t) {
    // x = y · in_proj + pos[t]
    const bf16* w_in = as<bf16>(p.w_in);
    for (int e = threadIdx.x; e < R * H; e += S::THREADS) {
      const int r = e / H, n = e - r * H;
      float acc = Store<bf16>::round(ys[r * MAX_D]) * Store<bf16>::ldg1(w_in + n);
      for (int i = 1; i < d; ++i)
        acc = fmaf(Store<bf16>::round(ys[r * MAX_D + i]), Store<bf16>::ldg1(w_in + i * H + n), acc);
      xs[r * LDX + n] = acc + __ldg(p.pos + t * H + n);
    }
    sync_dec(pr, DP_IO);
    for (int l = 0; l < layers; ++l) {
      const float* const* w = p.layer[l];
      // -- self attention over the cache, this step's k, v appended
      layer_norm_bf16<R>(xs, hb, w[LN1_S], w[LN1_B]);
      pr.mark(DP_EPI);
      product(hb, LDB, H, 0, store_to(qb));
      product(hb, LDB, H, 0, store_to(kb));
      product(hb, LDB, H, 0, store_to(vb));
      sync_dec(pr, DP_EPI);
      for (int r = warp; r < nrows; r += S::WARPS) {
        const size_t row = ((size_t)l * g.batch + b0 + r) * t_out * H;
        bf16* kc = self_kv + row;
        bf16* vc = self_kv + (size_t)layers * layer_stride + row;
        // this step's k, v as the cache holds them (rounded to bf16)
        float f[8];
        load8(kb + r * LDX + 8 * li, f);
        const Kv8<bf16> k_now = {pack8(f)};
        load8(vb + r * LDX + 8 * li, f);
        const Kv8<bf16> v_now = {pack8(f)};
        (half ? v_now : k_now).store((half ? vc : kc) + (size_t)t * H + 8 * li);
        Attend<bf16> a;
        a.init(qb + r * LDX + 8 * li);
        a.tokens<false>(kc, vc, 1, t, 0, t, t, nullptr);
        const Kv8<bf16> kn[1] = {k_now}, vn[1] = {v_now};
        const bool on[1] = {half == 0};
        a.add<1>(kn, vn, on);
        float o[8];
        a.out(o);
        put(r, o);
      }
      pr.mark(DP_SELF);
      product(hb, LDB, H, 0, add_to_x);
      sync_dec(pr, DP_EPI);
      // -- cross attention over the encoder's K/V
      layer_norm_bf16<R>(xs, hb, w[LN2_S], w[LN2_B]);
      pr.mark(DP_EPI);
      product(hb, LDB, H, 0, store_to(qb));
      sync_dec(pr, DP_EPI);
      for (int r = warp; r < nrows; r += S::WARPS) {
        const size_t row = (size_t)(b0 + r) * g.t_in * H;
        Attend<bf16> a;
        a.init(qb + r * LDX + 8 * li);
        a.tokens<true>(as<bf16>(w[C_K]) + row, as<bf16>(w[C_V]) + row, 1, g.t_in, 0, g.t_in, g.t_in, nullptr);
        float o[8];
        a.out(o);
        put(r, o);
      }
      pr.mark(DP_CROSS);
      product(hb, LDB, H, 0, add_to_x);
      sync_dec(pr, DP_EPI);
      // -- peer attention over the valid (and in-window) peer tokens
      if (kt > 0) {
        layer_norm_bf16<R>(xs, hb, w[LN3_S], w[LN3_B]);
        pr.mark(DP_EPI);
        product(hb, LDB, H, 0, store_to(qb));
        sync_dec(pr, DP_EPI);
        const PeerRange pw(g, t);
        for (int r = warp; r < nrows; r += S::WARPS) {
          // the row's own peer memory, or its group's
          const size_t row = (size_t)(g.peer_gid ? __ldg(g.peer_gid + b0 + r) : b0 + r) * kt;
          Attend<bf16> a;
          a.init(qb + r * LDX + 8 * li);
          a.tokens<true>(as<bf16>(w[P_K]) + row * H, as<bf16>(w[P_V]) + row * H, pw.n_seg, pw.seg, pw.lo, pw.len,
                         kt, g.peer_valid + row);
          float o[8];
          if (a.out(o) && g.peer_dv != nullptr) sub_dv(g, b0 + r, l, li, o);  // the anchor correction δv
          put(r, o);
        }
        pr.mark(DP_PEER);
        product(hb, LDB, H, 0, add_to_x);
        sync_dec(pr, DP_EPI);
      }
      // -- MLP: u = gelu(LN4(x) · W1 + b1) over q, k, v, then x += u · W2 + b2
      layer_norm_bf16<R>(xs, hb, w[LN4_S], w[LN4_B]);
      pr.mark(DP_EPI);
      const float* b1 = w[B1];
      auto gelu_to_u = [ub, b1](int r, int c, float v0, float v1) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + c));
        *reinterpret_cast<unsigned*>(ub + r * LDUB + c) = Store<bf16>::pack(gelu_tanh(v0 + bb.x), gelu_tanh(v1 + bb.y));
      };
      for (int n0 = 0; n0 < MLP; n0 += H) product(hb, LDB, H, n0, gelu_to_u);
      const float* b2 = w[B2];
      auto mlp_to_x = [xs, b2](int r, int c, float v0, float v1) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + c));
        float2* x = reinterpret_cast<float2*>(xs + r * LDX + c);
        *x = make_float2(x->x + (v0 + bb.x), x->y + (v1 + bb.y));
      };
      product(ub, LDUB, MLP, 0, mlp_to_x);
      sync_dec(pr, DP_EPI);
    }
    // y = LN_f(x) (rounded) · Wout + bout: out[b, t], and the next step's token
    layer_norm_bf16<R>(xs, hb, p.fln_s, p.fln_b);
    sync_dec(pr, DP_EPI);
    for (int r = warp; r < nrows; r += S::WARPS) {
      const uint2 u = *reinterpret_cast<const uint2*>(hb + r * LDB + 4 * lane);
      const float h0 = Store<bf16>::lo(u.x), h1 = Store<bf16>::hi(u.x);
      const float h2 = Store<bf16>::lo(u.y), h3 = Store<bf16>::hi(u.y);
      for (int i = 0; i < d; ++i) {
        const bf16* wo = as<bf16>(p.w_out) + (4 * lane) * d + i;
        float s = h0 * Store<bf16>::ldg1(wo);
        s = fmaf(h1, Store<bf16>::ldg1(wo + d), s);
        s = fmaf(h2, Store<bf16>::ldg1(wo + 2 * d), s);
        s = fmaf(h3, Store<bf16>::ldg1(wo + 3 * d), s);
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
