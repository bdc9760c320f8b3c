// Differentiable transformer encoder for Hopper (sm_90a), exact f32: a
// forward that stashes what the backward reads, a reverse kernel, and a
// reduction of the weight gradients.
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
//     and 2·T·H for the attention: 24.6 MFLOP a viewer, 0.10 TFLOP, 1.5 ms
//     at the 67 TFLOP/s f32 FMA peak. The reverse recomputes LN2 and the
//     MLP's first product and does the two transposed products a weight
//     (the input gradient and the weight gradient): 28·H² MACs a
//     token-layer plus twice the attention, 0.24 TFLOP, 3.5 ms.
//   * Bytes. The stash is 6·L·T·H f32 a viewer, 755 MB at B = 4096 (0.23
//     ms each way); the weight-gradient partials below are 1.58 MB a block,
//     3.2 GB over 2,048 blocks, written once and read once by the reduction
//     (1.9 ms in all). Both kernels are bound by operations; the partials
//     are the design's largest byte cost.
// What the design does about it:
//   * A block holds 64 token rows, the T tokens of 64 / T viewers (R = 2 at
//     T = 30), as the serving encoder does: every product is gemm64 or
//     gemm_tn below, one operand element from shared memory or L2 feeding
//     64 FMAs. The reverse keeps six (64, H) buffers in shared memory (the
//     gradient of the residual stream and five working buffers, 214 KB in
//     all with the ring and the softmax statistics), walks the MLP's 4H
//     hidden columns 128 at a time so that its pre-activation never needs a
//     (64, 4H) buffer, and recomputes LN1, LN2 and the MLP's first product
//     from the stash rather than storing them.
//   * The attention backward is a warp a row in two passes: a query row's
//     softmax statistics and dq, then a key row's dk and dv, written over
//     the key and value it read (only its warp reads them in that pass).
//     D_i = Σ_j p_ij dp_ij comes as g_att_i · att_i from the stashed output.
//   * Each block writes its partial weight gradients (every Wᵀ-side product
//     over its 64 rows, the bias and LN column sums) to its own slot; the
//     reduction kernel adds the slots in block order. No float atomics:
//     two runs give the same bits.
// Later work (not here): larger row tiles or a split-K dW pass to shrink
// the partials, the products on the tensor cores (TF32 is not exact f32).

#include "transformer_encode.cuh"

namespace {

using namespace tfm;

// the transposed weights the reverse reads a layer: Wqᵀ, Wkᵀ, Wvᵀ, Woᵀ
// (H, H), W1ᵀ (4H, H), W2ᵀ (H, 4H)
enum EncTPtr { WQT, WKT, WVT, WOT, W1T, W2T, ENC_T_PTRS };

// a block's partial gradients of one layer, at these float offsets
constexpr int G_WQ = 0, G_WK = H * H, G_WV = 2 * H * H, G_WO = 3 * H * H;
constexpr int G_W1 = 4 * H * H;   // (H, 4H)
constexpr int G_W2 = 8 * H * H;   // (4H, H)
constexpr int G_B1 = 12 * H * H;  // (4H,)
constexpr int G_B2 = G_B1 + MLP;
constexpr int G_LN1_S = G_B2 + H, G_LN1_B = G_LN1_S + H, G_LN2_S = G_LN1_B + H, G_LN2_B = G_LN2_S + H;
constexpr int LAYER_GRAD = G_LN2_B + H;  // 197,760 floats
// then the input projection's (d, H) after the layers

constexpr int RB_BUFS = 6;                     // G and five working buffers, (ROWS, LDX) each
constexpr int STATS = 3 * ROWS * HEADS;       // softmax max, sum, and D a row and head
constexpr int RB_SMEM_FLOATS = RB_BUFS * ROWS * LDX + WS_FLOATS + STATS;

struct EncGradParams {
  const float* layer[MAX_LAYERS][ENC_PTRS];
  const float* layer_t[MAX_LAYERS][ENC_T_PTRS];
  const float* w_in;  // (d, H)
};

__global__ void __launch_bounds__(THREADS, 1)
encode_stash_kernel(const EncParams p, const float* __restrict__ past, float* __restrict__ enc,
                    float* __restrict__ stash, int batch, int layers, int t, int d, int seqs) {
  extern __shared__ float4 smem4[];
  encode_rows<true>(p, past, enc, stash, batch, layers, t, d, seqs, reinterpret_cast<float*>(smem4));
}

// jax.nn.gelu's tanh form, differentiated
__device__ __forceinline__ float dgelu_tanh(float x) {
  const float c = 0.7978845608028654f, a = 0.044715f;
  const float th = tanhf(c * (x + a * (x * x * x)));
  return 0.5f * (1.0f + th) + 0.5f * x * (1.0f - th * th) * c * (1.0f + 3.0f * a * (x * x));
}

// out[i][j] = Σ_m X[m][i0 + i] · Y[m][j] over the block's 64 rows, for i
// in [0, 64) and j in [0, 128): X and Y (ROWS, LDX) in shared memory.
// Thread (rg, cg) sums rows 4·rg..+3 x columns 8·cg..+7 over m in order
// and hands them to epi(r0, c0, acc) with r0 relative to i0. Reads only:
// the caller synchronizes around it.
template <typename Epi>
__device__ __forceinline__ void gemm_tn(const float* X, int i0, const float* Y, Epi epi) {
  const int r0 = (threadIdx.x >> 4) * 4;
  const int c0 = (threadIdx.x & 15) * 8;
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int m = 0; m < ROWS; ++m) {
    const float4 a = *reinterpret_cast<const float4*>(X + m * LDX + i0 + r0);
    const float4 y0 = *reinterpret_cast<const float4*>(Y + m * LDX + c0);
    const float4 y1 = *reinterpret_cast<const float4*>(Y + m * LDX + c0 + 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], yv[c], acc[r][c]);
  }
  epi(r0, c0, acc);
}

// dW[i0 + i][j0 + j] (row stride ldo, in device memory) = (Xᵀ · Y) for
// all 128 rows i of X's columns: two gemm_tn halves
__device__ __forceinline__ void weight_grad(const float* X, const float* Y, float* __restrict__ dw,
                                            int ldo, int j0) {
  for (int i0 = 0; i0 < H; i0 += ROWS)
    gemm_tn(X, i0, Y, [=](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* o = dw + (size_t)(i0 + r0 + r) * ldo + j0 + c0;
        *reinterpret_cast<float4*>(o) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *reinterpret_cast<float4*>(o + 4) = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    });
}

// out[j] = Σ_m Y[m][j] over the block's 64 rows, in order
__device__ __forceinline__ void col_sum(const float* Y, float* __restrict__ out) {
  if (threadIdx.x < H) {
    float s = 0.f;
    for (int m = 0; m < ROWS; ++m) s += Y[m * LDX + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// rows m < n_tok of an (n_tokens, H) array into a (ROWS, LDX) buffer, the
// other rows 0: a warp a row
__device__ __forceinline__ void rows_in(float* dst, const float* __restrict__ src, size_t tok0,
                                        int n_tok) {
  const int lane = threadIdx.x & 31;
  for (int m = threadIdx.x >> 5; m < ROWS; m += THREADS / 32)
    *reinterpret_cast<float4*>(dst + m * LDX + 4 * lane) =
        m < n_tok ? __ldg(reinterpret_cast<const float4*>(src + (tok0 + m) * H) + lane)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The LN backward of y = (x - mu) · rstd · scale + bias for every row (a
// warp a row): G += dL/dx given gy = dL/dy; X is overwritten with gy ⊙ xhat,
// whose column sums are dL/dscale (gy's are dL/dbias). A zero row of x and
// gy (a padding row) gives 0.
__device__ __forceinline__ void ln_backward(float* X, const float* GY, const float* __restrict__ scale,
                                            float* G) {
  const int lane = threadIdx.x & 31;
  const float4 s = __ldg(reinterpret_cast<const float4*>(scale) + lane);
  for (int r = threadIdx.x >> 5; r < ROWS; r += THREADS / 32) {
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

// a head's dot product of the lane's dims (lanes 8n..8n+7 hold head n),
// in every lane of the head
__device__ __forceinline__ float head_dot(float4 a, float4 b) {
  float s = (a.x * b.x + a.y * b.y) + (a.z * b.z + a.w * b.w);
  s += __shfl_xor_sync(FULL, s, 4);
  s += __shfl_xor_sync(FULL, s, 2);
  s += __shfl_xor_sync(FULL, s, 1);
  return s;
}

__device__ __forceinline__ float4 row4(const float* buf, int m) {
  return *(reinterpret_cast<const float4*>(buf + m * LDX) + (threadIdx.x & 31));
}

__device__ __forceinline__ void set_row4(float* buf, int m, float4 v) {
  *(reinterpret_cast<float4*>(buf + m * LDX) + (threadIdx.x & 31)) = v;
}

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 acc) {
  return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y), fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
}

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
  float* R5 = R4 + ROWS * LDX;
  float* ws = R5 + ROWS * LDX;  // gemm64's ring
  float* st_m = ws + WS_FLOATS;  // (ROWS, HEADS) softmax max, sum, and D
  float* st_l = st_m + ROWS * HEADS;
  float* st_d = st_l + ROWS * HEADS;
  const int b0 = blockIdx.x * seqs;
  const int n_tok = min(seqs, batch - b0) * t;
  const size_t tok0 = (size_t)b0 * t;
  const size_t n_tokens = (size_t)batch * t;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, head = lane >> 3;
  float* part = partials + (size_t)blockIdx.x * ((size_t)layers * LAYER_GRAD + d * H);
  auto stash_of = [=](int l, int s) { return stash + ((size_t)l * STASH + s) * n_tokens * H; };
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
  auto add_to = [](float* dst) {
    return [dst](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) dst[(r0 + r) * LDX + c0 + c] += acc[r][c];
    };
  };

  rows_in(G, g_enc, tok0, n_tok);
  __syncthreads();
  for (int l = layers - 1; l >= 0; --l) {
    const float* const* w = p.layer[l];
    const float* const* wt = p.layer_t[l];
    float* gp = part + (size_t)l * LAYER_GRAD;

    // ---- MLP: x2 = x1 + gelu(LN2(x1) · W1 + b1) · W2 + b2; G = dL/dx2
    rows_in(R1, stash_of(l, ST_X1), tok0, n_tok);  // R1 = x1
    __syncthreads();
    layer_norm(R1, R2, w[LN2_S], w[LN2_B]);  // R2 = m_in
    col_sum(G, gp + G_B2);
    __syncthreads();
    const float* b1 = w[B1];
    for (int c = 0; c < MLP / H; ++c) {
      const int n0 = c * H;
      // pre = m_in · W1[:, n0:+128] + b1: R3 = gelu'(pre), R4 = gelu(pre)
      gemm64(R2, LDX, H, w[W1], MLP, n0, ws, [=](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) {
            const float x = acc[r][cc] + __ldg(b1 + c0 + cc);
            R3[(r0 + r) * LDX + c0 - n0 + cc] = dgelu_tanh(x);
            R4[(r0 + r) * LDX + c0 - n0 + cc] = gelu_tanh(x);
          }
      });
      __syncthreads();
      weight_grad(R4, G, gp + G_W2 + (size_t)n0 * H, H, 0);  // dW2[n0:+128, :] = gelu(pre)ᵀ · G
      // R3 = (G · W2[n0:+128, :]ᵀ) ⊙ gelu'(pre), the pre-activation's gradient
      gemm64(G, LDX, H, wt[W2T], MLP, n0, ws, [=](int r0, int c0, const float (&acc)[4][8]) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) R3[(r0 + r) * LDX + c0 - n0 + cc] *= acc[r][cc];
      });
      __syncthreads();
      weight_grad(R2, R3, gp + G_W1, MLP, n0);  // dW1[:, n0:+128] = m_inᵀ · gpre
      col_sum(R3, gp + G_B1 + n0);
      // R5 (+)= gpre · W1[:, n0:+128]ᵀ, the gradient of m_in
      if (c == 0)
        gemm64(R3, LDX, H, wt[W1T] + (size_t)n0 * H, H, 0, ws, store_to(R5));
      else
        gemm64(R3, LDX, H, wt[W1T] + (size_t)n0 * H, H, 0, ws, add_to(R5));
      __syncthreads();
    }
    ln_backward(R1, R5, w[LN2_S], G);  // G = dL/dx1; R1 = gy ⊙ xhat
    __syncthreads();
    col_sum(R1, gp + G_LN2_S);
    col_sum(R5, gp + G_LN2_B);
    __syncthreads();

    // ---- attention: x1 = x0 + att · Wo; G = dL/dx1
    rows_in(R1, stash_of(l, ST_ATT), tok0, n_tok);  // R1 = att
    __syncthreads();
    weight_grad(R1, G, gp + G_WO, H, 0);  // dWo = attᵀ · G
    gemm64(G, LDX, H, wt[WOT], H, 0, ws, store_to(R2));  // R2 = g_att
    __syncthreads();
    for (int m = warp; m < ROWS; m += THREADS / 32) {  // D = g_att · att a head
      const float s = head_dot(row4(R2, m), row4(R1, m));
      if ((lane & 7) == 0) st_d[m * HEADS + head] = s;
    }
    __syncthreads();
    rows_in(R1, stash_of(l, ST_Q), tok0, n_tok);  // R1 = q, R3 = k, R4 = v
    rows_in(R3, stash_of(l, ST_K), tok0, n_tok);
    rows_in(R4, stash_of(l, ST_V), tok0, n_tok);
    __syncthreads();
    // pass 1, a warp a query row i: its softmax statistics, then
    // dq_i = scale · Σ_j p_ij (dp_ij - D_i) k_j with dp_ij = g_att_i · v_j → R5
    for (int i = warp; i < ROWS; i += THREADS / 32) {
      float4 gq = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n_tok) {
        const int first = (i / t) * t;
        const float4 q = row4(R1, i), ga = row4(R2, i);
        float mx = -INFINITY;
        for (int j = first; j < first + t; ++j) mx = fmaxf(mx, head_dot(q, row4(R3, j)) * SCALE);
        float sum = 0.f;
        for (int j = first; j < first + t; ++j) sum += expf(head_dot(q, row4(R3, j)) * SCALE - mx);
        const float dd = st_d[i * HEADS + head];
        for (int j = first; j < first + t; ++j) {
          const float4 k = row4(R3, j);
          const float pr = expf(head_dot(q, k) * SCALE - mx) / sum;
          gq = fma4(pr * (head_dot(ga, row4(R4, j)) - dd), k, gq);
        }
        gq = make_float4(gq.x * SCALE, gq.y * SCALE, gq.z * SCALE, gq.w * SCALE);
        if ((lane & 7) == 0) {
          st_m[i * HEADS + head] = mx;
          st_l[i * HEADS + head] = sum;
        }
      }
      set_row4(R5, i, gq);
    }
    __syncthreads();
    // pass 2, a warp a key row j: dk_j = scale · Σ_i p_ij (dp_ij - D_i) q_i
    // and dv_j = Σ_i p_ij g_att_i, over the k_j and v_j it read (R3, R4)
    for (int j = warp; j < n_tok; j += THREADS / 32) {
      const int first = (j / t) * t;
      const float4 k = row4(R3, j), v = row4(R4, j);
      float4 gk = make_float4(0.f, 0.f, 0.f, 0.f), gv = gk;
      for (int i = first; i < first + t; ++i) {
        const float4 q = row4(R1, i), ga = row4(R2, i);
        const int s = i * HEADS + head;
        const float pr = expf(head_dot(q, k) * SCALE - st_m[s]) / st_l[s];
        gv = fma4(pr, ga, gv);
        gk = fma4(pr * (head_dot(ga, v) - st_d[s]), q, gk);
      }
      set_row4(R3, j, make_float4(gk.x * SCALE, gk.y * SCALE, gk.z * SCALE, gk.w * SCALE));
      set_row4(R4, j, gv);
    }
    __syncthreads();
    rows_in(R1, stash_of(l, ST_X0), tok0, n_tok);  // R1 = x0
    __syncthreads();
    layer_norm(R1, R2, w[LN1_S], w[LN1_B]);  // R2 = h_in
    __syncthreads();
    weight_grad(R2, R5, gp + G_WQ, H, 0);  // dWq, dWk, dWv = h_inᵀ · dq, dk, dv
    weight_grad(R2, R3, gp + G_WK, H, 0);
    weight_grad(R2, R4, gp + G_WV, H, 0);
    // R2 = dq · Wqᵀ + dk · Wkᵀ + dv · Wvᵀ, the gradient of h_in (gemm64
    // synchronizes before its epilogue: every thread is done with h_in)
    gemm64(R5, LDX, H, wt[WQT], H, 0, ws, store_to(R2));
    gemm64(R3, LDX, H, wt[WKT], H, 0, ws, add_to(R2));
    gemm64(R4, LDX, H, wt[WVT], H, 0, ws, add_to(R2));
    __syncthreads();
    ln_backward(R1, R2, w[LN1_S], G);  // G = dL/dx0; R1 = gy ⊙ xhat
    __syncthreads();
    col_sum(R1, gp + G_LN1_S);
    col_sum(R2, gp + G_LN1_B);
    __syncthreads();
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
// (64 / t)) blocks of 256 threads, 210,944 bytes of dynamic shared memory.
// past (batch, t, d), enc (batch, t, 128) and stash (layers, 6, batch · t,
// 128) f32; layer_ptrs holds 12 device pointers a layer in EncPtr's order;
// pos (t, 128). Returns cudaGetLastError() (0 = ok), or
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
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(encode_stash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int seqs = ROWS / t;
  encode_stash_kernel<<<(batch + seqs - 1) / seqs, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(past), static_cast<float*>(enc), static_cast<float*>(stash), batch, layers,
      t, d, seqs);
  return (int)cudaGetLastError();
}

// The reverse: one launch, the forward's grid, 214,016 bytes of dynamic
// shared memory. g_enc (batch, t, 128) f32, the cotangent of enc; d_x
// (batch, t, d) f32 or null; partials (blocks, partial_floats) f32, every
// float written. layer_ptrs as the forward's; layer_t_ptrs 6 a layer in
// EncTPtr's order. Returns as the forward.
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

}  // extern "C"
