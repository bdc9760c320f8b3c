// Differentiable transformer encoder for Hopper (sm_90a), f32: a forward
// that stashes what the backward reads, a reverse kernel, and a reduction
// of the weight gradients.
//
// Replaces the TPU Pallas kernels of
//   longterm360fov_tpu/ops/transformer_encode_train.py::fused_encode_train
//   (_fwd_stash_kernel, _reverse_kernel under its custom VJP)
// which compute the encoder of transformer_encode.cuh (in_proj + pos, L
// pre-LN layers of 4-head bidirectional attention and a tanh-GELU MLP) with
// a stash of [x0, x1, q, k, v, att] a layer, then, from the stash and the
// cotangent g of enc_mem, d_x = g_emb · in_projᵀ and every weight's
// gradient: the LN and GELU backward, the attention backward and the
// weight products in its own body, the layer loop run in reverse. On the
// TPU its grid runs in order and the weight gradients accumulate in one
// VMEM block across the batch tiles.
//
// What bounds it on the card (transformer-30: L = 2, T = 30, H = 128, at
// B = 4096, 122,880 token rows):
//   * Operations. The forward is 12·H² MACs a token-layer for the products
//     and 2·T·H for the attention: 0.097 TFLOP of products, f32-accurate on
//     the tensor cores as three-pass TF32, 0.59 ms at 495 / 3 TFLOP/s (1.5
//     ms on the FMA units at 67). The reverse needs the two transposed
//     products of each (the input gradient and the weight gradient): 24·H²
//     MACs a token-layer, 0.193 TFLOP, 1.17 ms (3.0 on the FMA units), and
//     twice the attention's FMA work beside them. It also recomputes LN1,
//     LN2 and the MLP's first product from the stash.
//   * Bytes. The stash is 6·L·T·H f32 a viewer, 755 MB at B = 4096 (0.23
//     ms each way); the weight-gradient partials below are 1.58 MB a block,
//     3.24 GB over 2,048 blocks, written once and read once by the
//     reduction (0.97 ms each way). The reverse's inputs and outputs take
//     1.21 ms: with its products on the tensor cores, bytes bound it.
// What the design does about it:
//   * A block holds 64 token rows, the T tokens of 64 / T viewers (R = 2 at
//     T = 30), as the serving encoder does. Every matrix product is
//     three-pass TF32 on mma.sync (transformer_f32mma.cuh): the forward is
//     the serving tier's body with the stash written on the way; the
//     reverse's input-gradient products read W itself (W1ᵀ for the
//     recomputed pre-activation) through the same weight stream, in chunks
//     of 16 k-columns (the reverse keeps five activation buffers), and its
//     weight gradients Xᵀ · Y over the block's rows are dw_product, whose
//     operands are strided in k and load with scalar loads.
//   * The reverse keeps G, the gradient of the residual stream, and four
//     (64, H) buffers in shared memory, walks the MLP's 4H hidden columns 128
//     at a time (gelu and the gradient of the pre-activation written out),
//     and recomputes LN1, LN2 and the MLP's first product from the stash
//     rather than storing them.
//   * The attention backward is a thread a (row, head), 32 dims in
//     registers, no shuffles: as a query row, its softmax statistics and dq
//     (an online softmax, held in registers), then as a key row, dk and dv,
//     written over the key and value it read. D_i = Σ_j p_ij dp_ij comes
//     as g_att_i · att_i from the stashed output.
//   * Each block writes its partial weight gradients (every product's, the
//     bias and LN column sums) to its own slot; the reduction kernel adds the
//     slots in block order. No float atomics: two runs give the same bits.
// What is left: the 3.24 GB of partials, about as long as the reverse's
// products take on the tensor cores, would shrink under a split-K dW pass
// that sums the blocks' Xᵀ · Y over many row tiles before it writes them;
// wgmma needs both TF32 operands k-major in shared memory, which Xᵀ · Y's
// operands (k over the rows) are not without a transpose.

#include "transformer_f32mma.cuh"

namespace {

using namespace tfm;

// the transposed weights the reverse reads a layer: W1ᵀ (4H, H), for the
// recomputed pre-activation (its other products read W itself)
enum EncTPtr { W1T, ENC_T_PTRS };

// a block's partial gradients of one layer, at these float offsets
constexpr int G_WQ = 0, G_WK = H * H, G_WV = 2 * H * H, G_WO = 3 * H * H;
constexpr int G_W1 = 4 * H * H;   // (H, 4H)
constexpr int G_W2 = 8 * H * H;   // (4H, H)
constexpr int G_B1 = 12 * H * H;  // (4H,)
constexpr int G_B2 = G_B1 + MLP;
constexpr int G_LN1_S = G_B2 + H, G_LN1_B = G_LN1_S + H, G_LN2_S = G_LN1_B + H, G_LN2_B = G_LN2_S + H;
constexpr int LAYER_GRAD = G_LN2_B + H;  // 197,760 floats
// then the input projection's (d, H) after the layers

constexpr int RKC = 16;                   // the reverse's chunk depth
constexpr int RB_BUFS = 5;                // G and four working buffers, (ROWS, LDX) each
constexpr int STATS = 3 * ROWS * HEADS;   // softmax max, sum, and D a row and head
constexpr int RB_SMEM_FLOATS = RB_BUFS * ROWS * LDX + Ring<RKC>::FLOATS + STATS;
static_assert(RB_SMEM_FLOATS * 4 <= 232448, "a block may have 227 KB of shared memory");

struct EncGradParams {
  const float* layer[MAX_LAYERS][ENC_PTRS];
  const float* layer_t[MAX_LAYERS][ENC_T_PTRS];
  const float* w_in;  // (d, H)
};

__global__ void __launch_bounds__(THREADS, 1)
encode_stash_kernel(const EncParams p, const float* __restrict__ past, float* __restrict__ enc,
                    float* __restrict__ stash, int batch, int layers, int t, int d, int seqs) {
  extern __shared__ float4 smem4[];
  encode_rows_tf32<true>(p, past, enc, stash, batch, layers, t, d, seqs, reinterpret_cast<float*>(smem4));
}

// jax.nn.gelu's tanh form, differentiated
__device__ __forceinline__ float dgelu_tanh(float x) {
  const float c = 0.7978845608028654f, a = 0.044715f;
  const float th = tanhf(c * (x + a * (x * x * x)));
  return 0.5f * (1.0f + th) + 0.5f * x * (1.0f - th * th) * c * (1.0f + 3.0f * a * (x * x));
}

// out[j] = Σ_m Y[m][j] over the block's 64 rows, in order
__device__ __forceinline__ void col_sum(const float* Y, float* __restrict__ out) {
  if (threadIdx.x < H) {  // four sums side by side, rows m % 4, then added in a fixed order
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int m = 0; m < ROWS; m += 4)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[k] += Y[(m + k) * LDX + threadIdx.x];
    out[threadIdx.x] = (s[0] + s[1]) + (s[2] + s[3]);
  }
}

// rows m < n_tok of an (n_tokens, H) array into a (ROWS, LDX) buffer, the
// other rows 0: a warp a row, a warp's 8 rows' loads in flight together
__device__ __forceinline__ void rows_in(float* dst, const float* __restrict__ src, size_t tok0,
                                        int n_tok) {
  const int lane = threadIdx.x & 31;
  constexpr int R = ROWS / (THREADS / 32);
  float4 v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = (threadIdx.x >> 5) + i * (THREADS / 32);
    v[i] = m < n_tok ? __ldg(reinterpret_cast<const float4*>(src + (tok0 + m) * H) + lane)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    *reinterpret_cast<float4*>(dst + ((threadIdx.x >> 5) + i * (THREADS / 32)) * LDX + 4 * lane) = v[i];
}

// The LN backward of y = (x - mu) · rstd · scale + bias for every row (a
// warp a row): G += dL/dx given gy = dL/dy; X is overwritten with gy ⊙ xhat,
// whose column sums are dL/dscale (gy's are dL/dbias). A zero row of x and
// gy (a padding row) gives 0.
__device__ __forceinline__ void ln_backward(float* X, const float* GY, const float* __restrict__ scale,
                                            float* G) {
  const int lane = threadIdx.x & 31;
  const float4 s = __ldg(reinterpret_cast<const float4*>(scale) + lane);
#pragma unroll
  for (int i = 0; i < ROWS / (THREADS / 32); ++i) {  // a warp's rows at once: their reductions interleave
    const int r = (threadIdx.x >> 5) + i * (THREADS / 32);
    float4* xp = reinterpret_cast<float4*>(X + r * LDX) + lane;
    const float4 x = *xp;
    const float4 gy = *(reinterpret_cast<const float4*>(GY + r * LDX) + lane);
    const float mu = warp_sum((x.x + x.y) + (x.z + x.w)) / (float)H;
    const float4 dx = make_float4(x.x - mu, x.y - mu, x.z - mu, x.w - mu);
    const float var = warp_sum((dx.x * dx.x + dx.y * dx.y) + (dx.z * dx.z + dx.w * dx.w)) / (float)H;
    const float rstd = 1.0f / sqrtf(var + 1e-6f);
    const float4 xh = make_float4(dx.x * rstd, dx.y * rstd, dx.z * rstd, dx.w * rstd);
    const float4 g = make_float4(gy.x * s.x, gy.y * s.y, gy.z * s.z, gy.w * s.w);
    const float mg = warp_sum((g.x + g.y) + (g.z + g.w)) / (float)H;
    const float mgx = warp_sum((g.x * xh.x + g.y * xh.y) + (g.z * xh.z + g.w * xh.w)) / (float)H;
    float4* gp = reinterpret_cast<float4*>(G + r * LDX) + lane;
    float4 acc = *gp;
    acc.x += rstd * (g.x - mg - xh.x * mgx);
    acc.y += rstd * (g.y - mg - xh.y * mgx);
    acc.z += rstd * (g.z - mg - xh.z * mgx);
    acc.w += rstd * (g.w - mg - xh.w * mgx);
    *gp = acc;
    *xp = make_float4(gy.x * xh.x, gy.y * xh.y, gy.z * xh.z, gy.w * xh.w);
  }
}

__device__ __forceinline__ float4 row4(const float* buf, int m) {
  return *(reinterpret_cast<const float4*>(buf + m * LDX) + (threadIdx.x & 31));
}

// The reverse's blocks of Bᵀ, a layer's (last layer first) in the order
// its products read them: for each 128-column slab c of the MLP's hidden
// layer, W1ᵀ's rows 128·c.. (the recomputed pre-activation), W2's rows
// 128·c.. (its gradient, G · W2[c]ᵀ) and W1's columns 128·c.. (the
// gradient of LN2's output); then Wo, Wq, Wk, Wv (G · Woᵀ and the gradient
// of LN1's output)
constexpr int REV_BLOCKS = 3 * (MLP / H) + 4;

struct RevSrc {
  const EncGradParams* p;
  int layers;
  __device__ __forceinline__ const float* operator()(int b, int& ld) const {
    const int l = layers - 1 - b / REV_BLOCKS, j = b % REV_BLOCKS;
    const float* const* w = p->layer[l];
    ld = H;
    if (j < 3 * (MLP / H)) {
      const int c = j / 3;
      if (j % 3 == 0) return p->layer_t[l][W1T] + (size_t)c * H * H;
      if (j % 3 == 1) return w[W2] + (size_t)c * H * H;
      ld = MLP;
      return w[W1] + c * H;
    }
    return w[j == 3 * (MLP / H) ? WO : j == 3 * (MLP / H) + 1 ? WQ : j == 3 * (MLP / H) + 2 ? WK : WV];
  }
};

// The reverse of one block of 64 token rows, layer by layer from the last,
// on three-pass TF32 products (transformer_f32mma.cuh). Shared memory: G,
// the gradient of the residual stream, and four (64, LDX) buffers R1-R4;
// the ring of the weight stream; the softmax statistics. A layer:
//   MLP (G = dL/dx2): R2 = m_in = LN2(x1); a slab c at a time, R1 = pre =
//   m_in · W1[:, c] + b1, then G · W2[c]ᵀ in registers, R1 = gelu(pre), R3 =
//   gpre = (G · W2[c]ᵀ) ⊙ gelu'(pre); dW2[c] = R1ᵀ · G, dW1[:, c] =
//   m_inᵀ · R3, db1[c]; R4 (+)= R3 · W1[:, c]ᵀ; then LN2's backward from x1
//   (read again) and R4 into G.
//   attention (G = dL/dx1): R1 = att, dWo = R1ᵀ · G, R2 = g_att = G · Woᵀ,
//   D; R1, R3, R4 = q, k, v; a thread a (row, head): as a query row, its
//   softmax statistics and dq (in registers), then as a key row, dk and dv
//   over its k and v; dq over q; R2 = LN1(x0)
//   (in place); dWq, dWk, dWv = R2ᵀ · dq, dk, dv; R2 = dq · Wqᵀ + dk · Wkᵀ
//   + dv · Wvᵀ (one register sum); LN1's backward from x0 (read again) into G.
// Every partial gradient goes to the block's slot of `partials`.
__global__ void __launch_bounds__(THREADS, 1)
encode_reverse_kernel(const EncGradParams p, const float* __restrict__ past,
                      const float* __restrict__ stash, const float* __restrict__ g_enc,
                      float* __restrict__ d_x, float* __restrict__ partials, int batch, int layers,
                      int t, int d, int seqs) {
  extern __shared__ float4 smem4[];
  float* G = reinterpret_cast<float*>(smem4);  // dL/d(residual stream)
  float* R1 = G + ROWS * LDX;
  float* R2 = R1 + ROWS * LDX;
  float* R3 = R2 + ROWS * LDX;
  float* R4 = R3 + ROWS * LDX;
  float* ring = R4 + ROWS * LDX;
  float* st_m = ring + Ring<RKC>::FLOATS;  // (ROWS, HEADS) softmax max, sum, and D
  float* st_l = st_m + ROWS * HEADS;
  float* st_d = st_l + ROWS * HEADS;
  const int b0 = blockIdx.x * seqs;
  const int n_tok = min(seqs, batch - b0) * t;
  const size_t tok0 = (size_t)b0 * t;
  const size_t n_tokens = (size_t)batch * t;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* part = partials + (size_t)blockIdx.x * ((size_t)layers * LAYER_GRAD + d * H);
  auto stash_of = [=](int l, int s) { return stash + ((size_t)l * STASH + s) * n_tokens * H; };
  Tf32Stream<RKC, RevSrc> st;
  st.src = RevSrc{&p, layers};
  st.total = layers * REV_BLOCKS * Ring<RKC>::CHUNKS;
  st.ring = ring;
  Probe pr(g_probe);
  // a dW tile into the partials: dw + i · ldo + j (device memory)
  auto dw_to = [](float* dw, int ldo) {
    return [dw, ldo](int i, int j, float v0, float v1) {
      *reinterpret_cast<float2*>(dw + (size_t)i * ldo + j) = make_float2(v0, v1);
    };
  };
  auto store_to = [](float* dst) {
    return [dst](int r, int c, float v0, float v1) {
      *reinterpret_cast<float2*>(dst + r * LDX + c) = make_float2(v0, v1);
    };
  };

  st.start();
  rows_in(G, g_enc, tok0, n_tok);
  pr.mark(P_STASH);
  sync_probe(pr);
  Tile s1;
  for (int l = layers - 1; l >= 0; --l) {
    const float* const* w = p.layer[l];
    float* gp = part + (size_t)l * LAYER_GRAD;

    // ---- MLP: x2 = x1 + gelu(LN2(x1) · W1 + b1) · W2 + b2; G = dL/dx2
    rows_in(R1, stash_of(l, ST_X1), tok0, n_tok);  // R1 = x1
    pr.mark(P_STASH);
    sync_probe(pr);
    layer_norm_rows(R1, R2, w[LN2_S], w[LN2_B]);  // R2 = m_in
    pr.mark(P_LN);
    col_sum(G, gp + G_B2);
    pr.mark(P_PARTW);
    const float* b1 = w[B1];
    for (int c = 0; c < MLP / H; ++c) {
      zero_tile(s1);
      product(R2, st, s1, pr);  // R1 = pre = m_in · W1[:, c] + b1
      tile_out(s1, c * H, [=](int r, int col, float v0, float v1) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + col));
        *reinterpret_cast<float2*>(R1 + r * LDX + col - c * H) = make_float2(v0 + bb.x, v1 + bb.y);
      });
      zero_tile(s1);
      product(G, st, s1, pr);   // G · W2[c]ᵀ; the same thread wrote pre at these positions
      tile_out(s1, 0, [=](int r, int col, float g0, float g1) {
        float2* x = reinterpret_cast<float2*>(R1 + r * LDX + col);
        const float2 pre = *x;
        *x = make_float2(gelu_tanh(pre.x), gelu_tanh(pre.y));
        *reinterpret_cast<float2*>(R3 + r * LDX + col) = make_float2(g0 * dgelu_tanh(pre.x), g1 * dgelu_tanh(pre.y));
      });
      pr.mark(P_GELU);
      sync_probe(pr);
      dw_product(R1, G, pr, dw_to(gp + G_W2 + (size_t)c * H * H, H));  // dW2[c] = gelu(pre)ᵀ · G
      dw_product(R2, R3, pr, dw_to(gp + G_W1 + c * H, MLP));           // dW1[:, c] = m_inᵀ · gpre
      col_sum(R3, gp + G_B1 + c * H);
      pr.mark(P_PARTW);
      zero_tile(s1);
      product(R3, st, s1, pr);  // gpre · W1[:, c]ᵀ, the gradient of m_in
      tile_out(s1, 0, [=](int r, int col, float v0, float v1) {
        float2* o = reinterpret_cast<float2*>(R4 + r * LDX + col);
        *o = c == 0 ? make_float2(v0, v1) : make_float2(o->x + v0, o->y + v1);
      });
      pr.mark(P_EPI);
    }
    sync_probe(pr);
    rows_in(R1, stash_of(l, ST_X1), tok0, n_tok);  // R1 = x1 again
    pr.mark(P_STASH);
    sync_probe(pr);
    ln_backward(R1, R4, w[LN2_S], G);  // G = dL/dx1; R1 = gy ⊙ xhat
    pr.mark(P_LN);
    sync_probe(pr);
    col_sum(R1, gp + G_LN2_S);
    col_sum(R4, gp + G_LN2_B);
    pr.mark(P_PARTW);
    sync_probe(pr);

    // ---- attention: x1 = x0 + att · Wo; G = dL/dx1
    rows_in(R1, stash_of(l, ST_ATT), tok0, n_tok);  // R1 = att
    pr.mark(P_STASH);
    sync_probe(pr);
    dw_product(R1, G, pr, dw_to(gp + G_WO, H));  // dWo = attᵀ · G
    zero_tile(s1);
    product(G, st, s1, pr);
    tile_out(s1, 0, store_to(R2));  // R2 = g_att
    pr.mark(P_EPI);
    sync_probe(pr);
    // thread (row i, head) = (tid % 64, tid / 64): the head's 32 dims of
    // row i in registers, no shuffles. D_i = g_att_i · att_i
    const int ai = threadIdx.x % ROWS, ah = threadIdx.x / ROWS, acol = ah * (H / HEADS);
    auto load32 = [acol](const float* buf, int row, float (&x)[H / HEADS]) {
#pragma unroll
      for (int c = 0; c < H / HEADS; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(buf + row * LDX + acol + c);
        x[c] = v.x, x[c + 1] = v.y, x[c + 2] = v.z, x[c + 3] = v.w;
      }
    };
    auto store32 = [acol](float* buf, int row, const float (&x)[H / HEADS], float scale) {
#pragma unroll
      for (int c = 0; c < H / HEADS; c += 4)
        *reinterpret_cast<float4*>(buf + row * LDX + acol + c) =
            make_float4(x[c] * scale, x[c + 1] * scale, x[c + 2] * scale, x[c + 3] * scale);
    };
    auto dot32 = [acol](const float (&x)[H / HEADS], const float* buf, int row) {
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < H / HEADS; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(buf + row * LDX + acol + c);
        s4[0] = fmaf(x[c], v.x, s4[0]);
        s4[1] = fmaf(x[c + 1], v.y, s4[1]);
        s4[2] = fmaf(x[c + 2], v.z, s4[2]);
        s4[3] = fmaf(x[c + 3], v.w, s4[3]);
      }
      return (s4[0] + s4[1]) + (s4[2] + s4[3]);
    };
    {
      float ga[H / HEADS];
      load32(R2, ai, ga);
      st_d[ai * HEADS + ah] = dot32(ga, R1, ai);
    }
    pr.mark(P_ATT);
    sync_probe(pr);
    rows_in(R1, stash_of(l, ST_Q), tok0, n_tok);  // R1 = q, R3 = k, R4 = v
    rows_in(R3, stash_of(l, ST_K), tok0, n_tok);
    rows_in(R4, stash_of(l, ST_V), tok0, n_tok);
    pr.mark(P_STASH);
    sync_probe(pr);
    // the viewer's rows; none for a row past the valid ones, whose
    // gradients are 0
    const int first = (ai / t) * t, last = ai < n_tok ? first + t : first;
    // query row i: an online softmax over its viewer's keys j (m the running
    // max of the logits, l the sum of exp(logit - m)) and
    // dq_i = scale · Σ_j p_ij (dp_ij - D_i) k_j, dp_ij = g_att_i · v_j,
    // held in registers until k and v are no longer read
    float dq[H / HEADS];
    {
      float q[H / HEADS], ga[H / HEADS];
      load32(R1, ai, q);
      load32(R2, ai, ga);
      const float dd = st_d[ai * HEADS + ah];
      float mx = -INFINITY, sum = 0.f;
#pragma unroll
      for (int c = 0; c < H / HEADS; ++c) dq[c] = 0.f;
      for (int j = first; j < last; ++j) {
        const float s = dot32(q, R3, j) * SCALE;
        const float gp_ij = dot32(ga, R4, j) - dd;
        const float mn = fmaxf(mx, s);
        const float corr = expf(mx - mn);  // 0 for the first key (mx = -inf)
        const float e = expf(s - mn);
        sum = sum * corr + e;
        const float* kr = R3 + j * LDX + acol;
#pragma unroll
        for (int c = 0; c < H / HEADS; c += 4) {
          const float4 k = *reinterpret_cast<const float4*>(kr + c);
          dq[c] = fmaf(e * gp_ij, k.x, dq[c] * corr);
          dq[c + 1] = fmaf(e * gp_ij, k.y, dq[c + 1] * corr);
          dq[c + 2] = fmaf(e * gp_ij, k.z, dq[c + 2] * corr);
          dq[c + 3] = fmaf(e * gp_ij, k.w, dq[c + 3] * corr);
        }
        mx = mn;
      }
      const float f = ai < n_tok ? SCALE / sum : 0.f;
#pragma unroll
      for (int c = 0; c < H / HEADS; ++c) dq[c] *= f;
      st_m[ai * HEADS + ah] = mx;
      st_l[ai * HEADS + ah] = sum;
    }
    pr.mark(P_ATT);
    sync_probe(pr);
    {  // key row j = ai, over the k_j and v_j it read (only its thread reads
       // them in this pass): dk_j = scale · Σ_i p_ij (dp_ij - D_i) q_i with
       // dp_ij = g_att_i · v_j, then dv_j = Σ_i p_ij g_att_i, p_ij computed
       // again, so that k_j, v_j, dk_j and dv_j are not held at once beside dq
      float k[H / HEADS];
      load32(R3, ai, k);
      auto p_of = [&](int i) {
        const int si = i * HEADS + ah;
        return expf(dot32(k, R1, i) * SCALE - st_m[si]) / st_l[si];
      };
      {
        float v[H / HEADS], dk[H / HEADS];
        load32(R4, ai, v);
#pragma unroll
        for (int c = 0; c < H / HEADS; ++c) dk[c] = 0.f;
        for (int i = first; i < last; ++i) {
          const float w_ij = p_of(i) * (dot32(v, R2, i) - st_d[i * HEADS + ah]);
          const float* qr = R1 + i * LDX + acol;
#pragma unroll
          for (int c = 0; c < H / HEADS; c += 4) {
            const float4 q = *reinterpret_cast<const float4*>(qr + c);
            dk[c] = fmaf(w_ij, q.x, dk[c]);
            dk[c + 1] = fmaf(w_ij, q.y, dk[c + 1]);
            dk[c + 2] = fmaf(w_ij, q.z, dk[c + 2]);
            dk[c + 3] = fmaf(w_ij, q.w, dk[c + 3]);
          }
        }
        store32(R3, ai, dk, SCALE);
      }
      float dv[H / HEADS];
#pragma unroll
      for (int c = 0; c < H / HEADS; ++c) dv[c] = 0.f;
      for (int i = first; i < last; ++i) {
        const float p_ij = p_of(i);
        const float* gr = R2 + i * LDX + acol;
#pragma unroll
        for (int c = 0; c < H / HEADS; c += 4) {
          const float4 g = *reinterpret_cast<const float4*>(gr + c);
          dv[c] = fmaf(p_ij, g.x, dv[c]);
          dv[c + 1] = fmaf(p_ij, g.y, dv[c + 1]);
          dv[c + 2] = fmaf(p_ij, g.z, dv[c + 2]);
          dv[c + 3] = fmaf(p_ij, g.w, dv[c + 3]);
        }
      }
      store32(R4, ai, dv, 1.f);
    }
    pr.mark(P_ATT);
    sync_probe(pr);
    store32(R1, ai, dq, 1.f);  // R1 = dq
    rows_in(R2, stash_of(l, ST_X0), tok0, n_tok);  // R2 = x0
    pr.mark(P_STASH);
    sync_probe(pr);
    layer_norm_rows(R2, R2, w[LN1_S], w[LN1_B]);  // R2 = h_in, in place
    pr.mark(P_LN);
    sync_probe(pr);
    dw_product(R2, R1, pr, dw_to(gp + G_WQ, H));  // dWq, dWk, dWv = h_inᵀ · dq, dk, dv
    dw_product(R2, R3, pr, dw_to(gp + G_WK, H));
    dw_product(R2, R4, pr, dw_to(gp + G_WV, H));
    zero_tile(s1);  // dq · Wqᵀ + dk · Wkᵀ + dv · Wvᵀ, the gradient of h_in
    product(R1, st, s1, pr);
    product(R3, st, s1, pr);
    product(R4, st, s1, pr);
    sync_probe(pr);  // every warp is done with h_in and dq
    tile_out(s1, 0, store_to(R2));
    rows_in(R1, stash_of(l, ST_X0), tok0, n_tok);  // R1 = x0 again
    pr.mark(P_STASH);
    sync_probe(pr);
    ln_backward(R1, R2, w[LN1_S], G);  // G = dL/dx0; R1 = gy ⊙ xhat
    pr.mark(P_LN);
    sync_probe(pr);
    col_sum(R1, gp + G_LN1_S);
    col_sum(R2, gp + G_LN1_B);
    pr.mark(P_PARTW);
    sync_probe(pr);
  }
  // G = dL/d(past · in_proj + pos): d_in_proj = pastᵀ · G, d_x = G · in_projᵀ
  float* gin = part + (size_t)layers * LAYER_GRAD;
  for (int e = threadIdx.x; e < d * H; e += THREADS) {
    const int i = e / H, n = e - i * H;
    float s = 0.f;
    for (int m = 0; m < n_tok; ++m) s = fmaf(past[(tok0 + m) * d + i], G[m * LDX + n], s);
    gin[e] = s;
  }
  if (d_x != nullptr) {
    for (int m = warp; m < n_tok; m += THREADS / 32) {
      const float4 g = row4(G, m);
      for (int i = 0; i < d; ++i) {
        const float4 wi = __ldg(reinterpret_cast<const float4*>(p.w_in + i * H) + lane);
        const float s = warp_sum((g.x * wi.x + g.y * wi.y) + (g.z * wi.z + g.w * wi.w));
        if (lane == 0) d_x[(tok0 + m) * d + i] = s;
      }
    }
  }
  pr.mark(P_OUT);
}

// grads[e] = Σ_b partials[b][e] over the blocks in order, four floats a
// thread
__global__ void __launch_bounds__(256)
reduce_partials_kernel(const float4* __restrict__ partials, float4* __restrict__ grads, int n4,
                       int blocks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n4) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) {
    const float4 v = __ldg(partials + (size_t)b * n4 + e);
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  grads[e] = s;
}

bool bad_shape(int batch, int layers, int t, int d) {
  return batch < 1 || layers < 1 || layers > MAX_LAYERS || t < 1 || t > ROWS || d < 1 || d > 4;
}

}  // namespace

extern "C" {

// The floats of one block's partial gradients: layers · 197,760 + d · 128.
int transformer_encode_train_partial_floats(int layers, int d) { return layers * LAYER_GRAD + d * H; }

// The forward with the stash: one launch on `stream`, grid ceil(batch /
// (64 / t)) blocks of 256 threads, 208,896 bytes of dynamic shared memory.
// past (batch, t, d), enc (batch, t, 128) and stash (layers, 6, batch · t,
// 128) f32; layer_ptrs holds 12 device pointers a layer in EncPtr's order,
// the matrices' slots pointing at their transposes (Wqᵀ..Woᵀ, W1ᵀ (4H, H),
// W2ᵀ (H, 4H), each row-major); pos (t, 128). Returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a shape the kernel does not take.
int transformer_encode_train_fwd_f32(const void* past, void* enc, void* stash, const void* const* layer_ptrs,
                                     const void* w_in, const void* pos, int batch, int layers, int t, int d,
                                     void* stream) {
  if (bad_shape(batch, layers, t, d)) return (int)cudaErrorInvalidValue;
  EncParams p = {};
  for (int l = 0; l < layers; ++l)
    for (int i = 0; i < ENC_PTRS; ++i) p.layer[l][i] = static_cast<const float*>(layer_ptrs[l * ENC_PTRS + i]);
  p.w_in = static_cast<const float*>(w_in);
  p.pos = static_cast<const float*>(pos);
  const size_t smem = F32_SMEM_FLOATS * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(encode_stash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int seqs = ROWS / t;
  encode_stash_kernel<<<(batch + seqs - 1) / seqs, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(past), static_cast<float*>(enc), static_cast<float*>(stash), batch, layers,
      t, d, seqs);
  return (int)cudaGetLastError();
}

// The reverse: one launch, the forward's grid, 212,992 bytes of dynamic
// shared memory. g_enc (batch, t, 128) f32, the cotangent of enc; d_x
// (batch, t, d) f32 or null; partials (blocks, partial_floats) f32, every
// float written. layer_ptrs holds 12 device pointers a layer in EncPtr's
// order, the matrices as they are (W, row-major); layer_t_ptrs one a
// layer, W1ᵀ (4H, H) row-major. Returns as the forward.
int transformer_encode_train_bwd_f32(const void* past, const void* stash, const void* g_enc, void* d_x,
                                     void* partials, const void* const* layer_ptrs,
                                     const void* const* layer_t_ptrs, const void* w_in, int batch, int layers,
                                     int t, int d, void* stream) {
  if (bad_shape(batch, layers, t, d)) return (int)cudaErrorInvalidValue;
  EncGradParams p = {};
  for (int l = 0; l < layers; ++l) {
    for (int i = 0; i < ENC_PTRS; ++i) p.layer[l][i] = static_cast<const float*>(layer_ptrs[l * ENC_PTRS + i]);
    for (int i = 0; i < ENC_T_PTRS; ++i)
      p.layer_t[l][i] = static_cast<const float*>(layer_t_ptrs[l * ENC_T_PTRS + i]);
  }
  p.w_in = static_cast<const float*>(w_in);
  const size_t smem = RB_SMEM_FLOATS * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(encode_reverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int seqs = ROWS / t;
  encode_reverse_kernel<<<(batch + seqs - 1) / seqs, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(past), static_cast<const float*>(stash), static_cast<const float*>(g_enc),
      static_cast<float*>(d_x), static_cast<float*>(partials), batch, layers, t, d, seqs);
  return (int)cudaGetLastError();
}

// The reduction: grads (n,) = Σ over `blocks` rows of partials (blocks, n),
// in row order; n a multiple of 4. Returns as the forward.
int transformer_encode_train_dw_f32(const void* partials, void* grads, int n, int blocks, void* stream) {
  if (n < 4 || n % 4 || blocks < 1) return (int)cudaErrorInvalidValue;
  const int n4 = n / 4;
  reduce_partials_kernel<<<(n4 + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(partials), static_cast<float4*>(grads), n4, blocks);
  return (int)cudaGetLastError();
}

const char* transformer_encode_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef TFM_PROBE
// The probe build's clock counters (tfm::Part order, tfm::PARTS of them)
// since the last read, summed over the blocks of both kernels, into out
// (host memory); zeroes them. Returns cudaGetLastError()-style codes.
int transformer_encode_train_probe_read(unsigned long long* out) { return probe_read(tfm::g_probe, out); }
#endif

}  // extern "C"
