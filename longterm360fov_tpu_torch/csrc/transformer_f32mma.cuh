// The transformer encoder's f32 tier on the tensor cores: the forward of
// one block of 64 token rows on three-pass TF32 products
// (transformer_tf32.cuh; encode_rows_tf32: transformer_encode.cu's
// encode_tokens_kernel<float> and transformer_encode_train.cu's
// encode_stash_kernel). The reverse kernel (transformer_encode_train.cu)
// runs its products on the same helpers, and on dw_product below.
//
// The shared memory for the split planes of the weight stream comes from
// the activation buffers: the forward keeps four (64, LDX) buffers, not
// seven (q is written over the LN output once its product is done, the
// attention output over q, and the MLP runs in four 128-column slabs of
// its hidden layer, each slab's second product added to x), so its ring
// takes chunks of KC = 32 (73,728 bytes); the reverse keeps five, with
// KC = 16 (40,960 bytes).
//
// The weight-gradient products (dw_product) are dW = Xᵀ · Y over the
// block's 64 rows, X and Y (64, LDX) in shared memory: k runs over the
// rows, so both operands are strided in k and no ldmatrix serves them.
// Their fragments load with scalar loads, the k-step's row of k = c taken
// as 2c and of k = c + 4 as 2c + 1 for both operands (any order of k gives
// the same sum), so that the 32 lanes of each load fall on 32 banks
// (row stride 132: rows 2c are 8 banks apart).

#pragma once

#include "transformer_mma.cuh"
#include "transformer_tf32.cuh"

namespace tfm {

// dW[i][j] = Σ_m X[m][i] · Y[m][j] over the block's 64 rows, for i, j in
// [0, 128): X and Y (ROWS, LDX) in shared memory; warp w owns i in
// 32·(w % 4).., j in 64·(w / 4)..; epi(i, j, v0, v1) receives columns j,
// j + 1. Reads only: the caller synchronizes around it.
template <typename Epi>
__device__ __forceinline__ void dw_product(const float* X, const float* Y, Probe& pr, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wi = (warp & 3) * 32, wj = (warp >> 2) * 64;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll 2
  for (int s = 0; s < ROWS; s += 8) {
    // k = c: row s + 2c; k = c + 4: row s + 2c + 1
    const float* x0 = X + (s + 2 * c) * LDX + wi + g;
    const float* y0 = Y + (s + 2 * c) * LDX + wj + g;
    unsigned ah[2][4], al[2][4], bh[8][2], bl[8][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float v[4] = {x0[16 * mi], x0[16 * mi + 8], x0[LDX + 16 * mi], x0[LDX + 16 * mi + 8]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(v[e], ah[mi][e], al[mi][e]);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      split_tf32(y0[8 * ni], bh[ni][0], bl[ni][0]);
      split_tf32(y0[LDX + 8 * ni], bh[ni][1], bl[ni][1]);
    }
#ifndef TFM_ONE_PASS
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) mma_tf32(acc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) mma_tf32(acc[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
#endif
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) mma_tf32(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
  }
  pr.mark(P_DW);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(wi + 16 * mi + g + 8 * h, wj + 8 * ni + 2 * c, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  pr.mark(P_PARTW);
}

// Y[r] = LN(X[r]) for every row r of the block: layer_norm<float>'s
// arithmetic, a warp's 8 rows at once so that their reductions interleave.
// Y may be X (a lane reads its values of a row before it writes them).
__device__ __forceinline__ void layer_norm_rows(const float* X, float* Y, const float* __restrict__ scale,
                                                const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  const float4 s = __ldg(reinterpret_cast<const float4*>(scale) + lane);
  const float4 b = __ldg(reinterpret_cast<const float4*>(bias) + lane);
#pragma unroll
  for (int i = 0; i < ROWS / (THREADS / 32); ++i) {
    const int r = (threadIdx.x >> 5) + i * (THREADS / 32);
    const float4 x = *reinterpret_cast<const float4*>(X + r * LDX + 4 * lane);
    const float mu = warp_sum((x.x + x.y) + (x.z + x.w)) / (float)H;
    const float4 d = make_float4(x.x - mu, x.y - mu, x.z - mu, x.w - mu);
    const float var = warp_sum((d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w)) / (float)H;
    const float inv = 1.0f / sqrtf(var + 1e-6f);
    *reinterpret_cast<float4*>(Y + r * LDX + 4 * lane) =
        make_float4(d.x * inv * s.x + b.x, d.y * inv * s.y + b.y, d.z * inv * s.z + b.z, d.w * inv * s.w + b.w);
  }
}

// ---- the forward

constexpr int FKC = 32;          // the forward's chunk depth
constexpr int FWD_BLOCKS = 12;   // 128 x 128 blocks of Bᵀ a layer
constexpr int F32_SMEM_FLOATS = 4 * ROWS * LDX + Ring<FKC>::FLOATS;  // xs, hs, kb, vb, the ring
static_assert(F32_SMEM_FLOATS * 4 <= 232448, "a block may have 227 KB of shared memory");

// The forward's blocks of Bᵀ = Wᵀ, a layer's in the order its products read
// them: Wv, Wk, Wq, Wo, then W1's slab s and W2's slab s for s = 0..3. The
// matrices' slots of p hold Wᵀ: Wq..Woᵀ (H, H), W1ᵀ (4H, H), W2ᵀ (H, 4H).
struct FwdSrc {
  const EncParams* p;
  __device__ __forceinline__ const float* operator()(int b, int& ld) const {
    const float* const* w = p->layer[b / FWD_BLOCKS];
    const int j = b % FWD_BLOCKS;
    ld = H;
    if (j < 4) return w[j == 0 ? WV : j == 1 ? WK : j == 2 ? WQ : WO];
    const int s = (j - 4) >> 1;
    if (((j - 4) & 1) == 0) return w[W1] + (size_t)s * H * H;  // W1ᵀ rows 128·s..
    ld = MLP;
    return w[W2] + s * H;  // W2ᵀ columns 128·s..
  }
};

// The block's forward on three-pass TF32 products: the T tokens of `seqs`
// = 64 / T viewers from past (batch, t, d) to enc rows; with kStash, stash
// (layers, STASH, n_tokens, H) receives every layer's x0, x1, q, k, v, att.
// smem holds F32_SMEM_FLOATS floats:
//   xs (64, LDX) the residual stream x
//   hs (64, LDX) LN1's output, then q, then the attention output, then LN2's
//   kb (64, LDX) k, then the MLP's hidden slab u = gelu(LN2(x) · W1[:, s] + b1),
//                whose u · W2[s] is added to x before the next slab
//   vb (64, LDX) v
//   the ring of the weight stream
// The bidirectional attention of the block's rows, in f32: thread (row m,
// head) = (tid % 64, tid / 64) holds the head's 32 dims of q and of the
// output in registers (no shuffles) and runs an online softmax over its
// viewer's t key rows, two keys a step (one rescale for both); the output
// goes over q (hs), which only its thread reads. Rows past the valid ones
// keep their q.
__device__ __forceinline__ void attend_rows(float* hs, const float* kb, const float* vb, int n_tok, int t) {
  constexpr int HD = H / HEADS;
  const int m = threadIdx.x % ROWS, col = (threadIdx.x / ROWS) * HD;
  if (m >= n_tok) return;
  float* row = hs + m * LDX + col;
  float q[HD], o[HD];
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    q[c] = v.x, q[c + 1] = v.y, q[c + 2] = v.z, q[c + 3] = v.w;
    o[c] = o[c + 1] = o[c + 2] = o[c + 3] = 0.f;
  }
  auto logit = [&](int j) {
    const float* kr = kb + j * LDX + col;
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < HD; c += 4) {
      const float4 k = *reinterpret_cast<const float4*>(kr + c);
      s4[0] = fmaf(q[c], k.x, s4[0]);
      s4[1] = fmaf(q[c + 1], k.y, s4[1]);
      s4[2] = fmaf(q[c + 2], k.z, s4[2]);
      s4[3] = fmaf(q[c + 3], k.w, s4[3]);
    }
    return ((s4[0] + s4[1]) + (s4[2] + s4[3])) * SCALE;
  };
  float mx = -INFINITY, l = 0.f;
  const int first = (m / t) * t, end = first + t;
  int j = first;
  for (; j + 1 < end; j += 2) {
    const float sa = logit(j), sb = logit(j + 1);
    const float mn = fmaxf(mx, fmaxf(sa, sb));
    const float corr = expf(mx - mn);  // 0 for the first keys (mx = -inf)
    const float pa = expf(sa - mn), pb = expf(sb - mn);
    l = l * corr + (pa + pb);
    const float* va = vb + j * LDX + col;
#pragma unroll
    for (int c = 0; c < HD; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(va + c);
      const float4 y = *reinterpret_cast<const float4*>(va + LDX + c);
      o[c] = fmaf(pb, y.x, fmaf(pa, x.x, o[c] * corr));
      o[c + 1] = fmaf(pb, y.y, fmaf(pa, x.y, o[c + 1] * corr));
      o[c + 2] = fmaf(pb, y.z, fmaf(pa, x.z, o[c + 2] * corr));
      o[c + 3] = fmaf(pb, y.w, fmaf(pa, x.w, o[c + 3] * corr));
    }
    mx = mn;
  }
  if (j < end) {  // the last key of an odd t
    const float s = logit(j);
    const float mn = fmaxf(mx, s);
    const float corr = expf(mx - mn);
    const float p = expf(s - mn);
    l = l * corr + p;
    const float* vr = vb + j * LDX + col;
#pragma unroll
    for (int c = 0; c < HD; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(vr + c);
      o[c] = fmaf(p, v.x, o[c] * corr);
      o[c + 1] = fmaf(p, v.y, o[c + 1] * corr);
      o[c + 2] = fmaf(p, v.z, o[c + 2] * corr);
      o[c + 3] = fmaf(p, v.w, o[c + 3] * corr);
    }
  }
#pragma unroll
  for (int c = 0; c < HD; c += 4)
    *reinterpret_cast<float4*>(row + c) = make_float4(o[c] / l, o[c + 1] / l, o[c + 2] / l, o[c + 3] / l);
}

template <bool kStash>
__device__ __forceinline__ void encode_rows_tf32(const EncParams& p, const float* __restrict__ past,
                                                 float* __restrict__ enc, float* __restrict__ stash, int batch,
                                                 int layers, int t, int d, int seqs, float* smem) {
  float* xs = smem;
  float* hs = xs + ROWS * LDX;
  float* kb = hs + ROWS * LDX;
  float* vb = kb + ROWS * LDX;
  Tf32Stream<FKC, FwdSrc> st;
  st.src = FwdSrc{&p};
  st.total = layers * FWD_BLOCKS * Ring<FKC>::CHUNKS;
  st.ring = vb + ROWS * LDX;
  Probe pr(g_probe);
  const int b0 = blockIdx.x * seqs;
  const int n_tok = min(seqs, batch - b0) * t;  // valid token rows
  const size_t tok0 = (size_t)b0 * t;
  const size_t n_tokens = (size_t)batch * t;
  auto stash_of = [=](int l, int s) { return stash + ((size_t)l * STASH + s) * n_tokens * H; };

  st.start();
  pr.mark(P_PRO);
  {  // x = past · in_proj + pos: thread column n, rows m0 + 2r, their sums
     // side by side; rows past the valid ones 0
    constexpr int R = ROWS * H / THREADS;
    const int n = threadIdx.x % H, m0 = threadIdx.x / H;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int i = 0; i < d; ++i) {
      const float wi = __ldg(p.w_in + i * H + n);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int m = m0 + r * (THREADS / H);
        if (m < n_tok) acc[r] = fmaf(__ldg(past + (tok0 + m) * d + i), wi, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = m0 + r * (THREADS / H);
      xs[m * LDX + n] = m < n_tok ? acc[r] + __ldg(p.pos + (m % t) * H + n) : 0.f;
    }
  }
  pr.mark(P_IN);
  sync_probe(pr);

  auto store_to = [](float* dst) {
    return [dst](int r, int c, float v0, float v1) {
      *reinterpret_cast<float2*>(dst + r * LDX + c) = make_float2(v0, v1);
    };
  };
  auto add_to_x = [xs](int r, int c, float v0, float v1) {
    float2* x = reinterpret_cast<float2*>(xs + r * LDX + c);
    *x = make_float2(x->x + v0, x->y + v1);
  };
  Tile sum;
  for (int l = 0; l < layers; ++l) {
    const float* const* w = p.layer[l];
    if (kStash) rows_out(xs, stash_of(l, ST_X0), tok0, n_tok);
    pr.mark(P_STASH);
    layer_norm_rows(xs, hs, w[LN1_S], w[LN1_B]);
    pr.mark(P_LN);
    zero_tile(sum);
    product(hs, st, sum, pr);
    tile_out(sum, 0, store_to(vb));
    pr.mark(P_EPI);
    zero_tile(sum);
    product(hs, st, sum, pr);
    tile_out(sum, 0, store_to(kb));
    pr.mark(P_EPI);
    zero_tile(sum);
    product(hs, st, sum, pr);
    sync_probe(pr);  // every warp is done with LN1's output: q goes over it
    tile_out(sum, 0, store_to(hs));
    pr.mark(P_EPI);
    sync_probe(pr);
    if (kStash) {
      rows_out(hs, stash_of(l, ST_Q), tok0, n_tok);
      rows_out(kb, stash_of(l, ST_K), tok0, n_tok);
      rows_out(vb, stash_of(l, ST_V), tok0, n_tok);
      pr.mark(P_STASH);
      sync_probe(pr);  // q is stashed before the attention output goes over it
    }
    attend_rows(hs, kb, vb, n_tok, t);
    pr.mark(P_ATT);
    sync_probe(pr);
    if (kStash) rows_out(hs, stash_of(l, ST_ATT), tok0, n_tok);
    pr.mark(P_STASH);
    zero_tile(sum);
    product(hs, st, sum, pr);
    tile_out(sum, 0, add_to_x);
    pr.mark(P_EPI);
    sync_probe(pr);  // x1 complete; every warp is done with the attention output
    if (kStash) rows_out(xs, stash_of(l, ST_X1), tok0, n_tok);
    pr.mark(P_STASH);
    layer_norm_rows(xs, hs, w[LN2_S], w[LN2_B]);
    pr.mark(P_LN);
    // x += gelu(h · W1 + b1) · W2 + b2, 128 hidden columns a slab: u in kb;
    // each slab's u · W2[slab] added to x (b2 with the first)
    const float* b1 = w[B1];
    const float* b2 = w[B2];
    for (int s = 0; s < MLP / H; ++s) {
      zero_tile(sum);
      product(hs, st, sum, pr);
      tile_out(sum, s * H, [kb, b1, s](int r, int c, float v0, float v1) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + c));
        *reinterpret_cast<float2*>(kb + r * LDX + c - s * H) = make_float2(gelu_tanh(v0 + bb.x), gelu_tanh(v1 + bb.y));
      });
      pr.mark(P_GELU);
      zero_tile(sum);
      product(kb, st, sum, pr);
      tile_out(sum, 0, [xs, b2, s](int r, int c, float v0, float v1) {
        const float2 bb = s == 0 ? __ldg(reinterpret_cast<const float2*>(b2 + c)) : make_float2(0.f, 0.f);
        float2* x = reinterpret_cast<float2*>(xs + r * LDX + c);
        *x = make_float2(x->x + (v0 + bb.x), x->y + (v1 + bb.y));
      });
      pr.mark(P_EPI);
    }
    sync_probe(pr);
  }
  rows_out(xs, enc, tok0, n_tok);
  pr.mark(P_OUT);
}

}  // namespace tfm
