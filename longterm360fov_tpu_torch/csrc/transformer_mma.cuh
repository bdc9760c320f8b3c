// The transformer encoder's bf16 tier on the tensor cores: the forward of
// one block of 64 token rows (transformer_encode.cu's encode_tokens_kernel
// <__nv_bfloat16>), with the arithmetic of the JAX kernel's
// compute_dtype=bfloat16: in_proj and the six matrices stored in bf16,
// every product's activation operand rounded to bf16 where it is written
// (past, the LN outputs, the attention output, the GELU output), the
// products summed in f32; q, k, v, the softmax, the LN statistics, the GELU
// and the residual stream in f32.
//
// A block is MMA_THREADS = 512 threads, 16 warps: one block fits on an SM
// (its shared memory), and 16 warps, four to a scheduler, hide the latency
// of the phases that wait on shared memory, shuffles and the tensor cores.
// Shared memory of a block (222,208 bytes):
//   xs   (64, LDX)  f32   the residual stream x
//   qkv  3 x (64, LDX) f32 q, k, v; the MLP's hidden layer u, (64, LDUB)
//                    bf16, over them once the attention has read them
//   hb   (64, LDB)  bf16  LN1's output, then the attention output, then
//                    LN2's output: each is dead when the next is written
//   ring STAGES x (KC, LDB) bf16  the weight stream
//
// The products: transformer_stream.cuh's gemm_mma<64> (warp w the 16 x 32
// tile at rows 16·(w % 4), columns 32·(w / 4)) through its weight stream in
// the layer's fixed order (EncOrder: Wq, Wk, Wv, Wo, W1's four 128-column
// slabs, W2), 12 chunks of 128 x 128 a layer, one block barrier a chunk.
// The epilogue hands each thread's f32 sums, two columns at a time, to a
// callback: the q, k, v stores, the residual adds, b1 + GELU rounded to
// bf16.
//
// The attention stays on the FMA units in f32: two threads a (row, head),
// 16 of the head's 32 dims each, the logit summed over the pair by one
// shuffle; an online softmax over the viewer's t key rows in shared memory,
// two keys a step; the output, rounded to bf16, goes to hb.
//
// A probe build (-DTFM_PROBE) adds in-kernel clock64 counters
// (transformer_probe.cuh).

#pragma once

#include "transformer_encode.cuh"
#include "transformer_stream.cuh"

namespace tfm {

// a layer's chunks: Wq, Wk, Wv, Wo (H / KC each), W1 (MLP / H slabs of
// H / KC), W2 (MLP / KC)
constexpr int LAYER_CHUNKS = 4 * (H / KC) + (MLP / H) * (H / KC) + MLP / KC;
constexpr int MMA_MAX_D = 64;  // past columns the prologue stages over q, in_proj rows over v
constexpr int MMA_SMEM_BYTES =
    4 * ROWS * LDX * (int)sizeof(float) + (ROWS * LDB + STAGES * CHUNK) * (int)sizeof(bf16);

static_assert(ROWS * LDUB * sizeof(bf16) <= 3 * ROWS * LDX * sizeof(float), "u does not fit over q, k, v");
static_assert(MMA_SMEM_BYTES <= 232448, "a block may have 227 KB of shared memory");
static_assert(MMA_MAX_D * H <= ROWS * LDX, "past and in_proj fit over q and v");
static_assert(MMA_THREADS == 2 * HEADS * ROWS, "two threads a (row, head) of the attention");

// The layer's weights in the order its products read them: chunk g of the
// kernel is chunk j = g % LAYER_CHUNKS of layer g / LAYER_CHUNKS.
struct EncOrder {
  const EncParams* p;

  __device__ __forceinline__ const bf16* source(int g, int& ldw) const {
    const float* const* w = p->layer[g / LAYER_CHUNKS];
    int j = g % LAYER_CHUNKS;
    if (j < 4 * (H / KC)) {  // Wq, Wk, Wv, Wo: (H, H)
      ldw = H;
      return as<bf16>(w[WQ + j / (H / KC)]) + (size_t)(j % (H / KC)) * KC * H;
    }
    j -= 4 * (H / KC);
    if (j < (MLP / H) * (H / KC)) {  // W1 (H, MLP): 128-column slab j / 2
      ldw = MLP;
      return as<bf16>(w[W1]) + (size_t)(j % (H / KC)) * KC * MLP + (j / (H / KC)) * H;
    }
    j -= (MLP / H) * (H / KC);
    ldw = H;  // W2 (MLP, H)
    return as<bf16>(w[W2]) + (size_t)j * KC * H;
  }
};

// Half of one head of one query row's bidirectional attention over its
// viewer's t key rows (first..first + t - 1), in f32, by the two threads
// (lanes 2i, 2i + 1 of `mask`) that hold 16 of the head's dims each: the
// logit summed over the pair by one shuffle, then an online softmax two
// keys a step (m the running max of the logits, l the sum of
// exp(logit - m), o the sum of exp(logit - m) · v) → o / l rounded to bf16
// into out. q_row, K, V and out point at the thread's 16 dims.
__device__ __forceinline__ void attend_half(const float* q_row, const float* K, const float* V, int first, int t,
                                            bf16* out, unsigned mask) {
  constexpr int HD = H / HEADS / 2;
  float q[HD], o[HD];
#pragma unroll
  for (int i = 0; i < HD; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(q_row + i);
    q[i] = v.x; q[i + 1] = v.y; q[i + 2] = v.z; q[i + 3] = v.w;
    o[i] = o[i + 1] = o[i + 2] = o[i + 3] = 0.f;
  }
  // q · K[j] over the head's 32 dims
  auto logit = [&](int j) {
    const float* kr = K + j * LDX;
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HD; i += 4) {
      const float4 k = *reinterpret_cast<const float4*>(kr + i);
      s4[0] = fmaf(q[i], k.x, s4[0]);
      s4[1] = fmaf(q[i + 1], k.y, s4[1]);
      s4[2] = fmaf(q[i + 2], k.z, s4[2]);
      s4[3] = fmaf(q[i + 3], k.w, s4[3]);
    }
    const float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
    return (s + __shfl_xor_sync(mask, s, 1)) * SCALE;
  };
  float m = -INFINITY, l = 0.f;
  const int end = first + t;
  int j = first;
  for (; j + 1 < end; j += 2) {  // two keys a step: one rescale of o for both
    const float sa = logit(j), sb = logit(j + 1);
    const float mn = fmaxf(m, fmaxf(sa, sb));
    const float corr = expf(m - mn);  // 0 for the first keys (m = -inf)
    const float pa = expf(sa - mn), pb = expf(sb - mn);
    l = l * corr + (pa + pb);
    const float* va = V + j * LDX;
#pragma unroll
    for (int i = 0; i < HD; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(va + i);
      const float4 y = *reinterpret_cast<const float4*>(va + LDX + i);
      o[i] = fmaf(pb, y.x, fmaf(pa, x.x, o[i] * corr));
      o[i + 1] = fmaf(pb, y.y, fmaf(pa, x.y, o[i + 1] * corr));
      o[i + 2] = fmaf(pb, y.z, fmaf(pa, x.z, o[i + 2] * corr));
      o[i + 3] = fmaf(pb, y.w, fmaf(pa, x.w, o[i + 3] * corr));
    }
    m = mn;
  }
  if (j < end) {  // the last key of an odd t
    const float s = logit(j);
    const float mn = fmaxf(m, s);
    const float corr = expf(m - mn);
    const float p = expf(s - mn);
    l = l * corr + p;
    const float* vr = V + j * LDX;
#pragma unroll
    for (int i = 0; i < HD; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(vr + i);
      o[i] = fmaf(p, v.x, o[i] * corr);
      o[i + 1] = fmaf(p, v.y, o[i + 1] * corr);
      o[i + 2] = fmaf(p, v.z, o[i + 2] * corr);
      o[i + 3] = fmaf(p, v.w, o[i + 3] * corr);
    }
  }
#pragma unroll
  for (int i = 0; i < HD; i += 8)
    *reinterpret_cast<uint4*>(out + i) =
        make_uint4(Store<bf16>::pack(o[i] / l, o[i + 1] / l), Store<bf16>::pack(o[i + 2] / l, o[i + 3] / l),
                   Store<bf16>::pack(o[i + 4] / l, o[i + 5] / l), Store<bf16>::pack(o[i + 6] / l, o[i + 7] / l));
}

// The block's forward in the bf16 tier: the T tokens of `seqs` = 64 / T
// viewers from past (batch, t, d), d <= MMA_MAX_D, to enc rows; smem holds
// MMA_SMEM_BYTES.
__device__ __forceinline__ void encode_rows_mma(const EncParams& p, const float* __restrict__ past,
                                                float* __restrict__ enc, int batch, int layers, int t, int d,
                                                int seqs, unsigned char* smem) {
  float* xs = reinterpret_cast<float*>(smem);
  float* qb = xs + ROWS * LDX;
  float* kb = qb + ROWS * LDX;
  float* vb = kb + ROWS * LDX;
  bf16* ub = reinterpret_cast<bf16*>(qb);
  bf16* hb = reinterpret_cast<bf16*>(vb + ROWS * LDX);
  WeightStream<EncOrder> ws{{&p}, layers * LAYER_CHUNKS, hb + ROWS * LDB, 0};
  Probe pr(g_probe);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * seqs;
  const int n_tok = min(seqs, batch - b0) * t;  // valid token rows
  const size_t tok0 = (size_t)b0 * t;

  for (int i = 0; i < STAGES - 1; ++i) ws.issue();
  // the block's past rows (rounded to bf16), pos and in_proj (widened to
  // f32) into q, k and v, free until the first product
  float* ps = qb;
  float* pe = kb;
  float* pw = vb;
  const bf16* w_in = as<bf16>(p.w_in);
  for (int i = threadIdx.x; i < n_tok * d; i += MMA_THREADS) ps[i] = Store<bf16>::round(__ldg(past + tok0 * d + i));
  for (int i = threadIdx.x; i < t * H / 4; i += MMA_THREADS)
    reinterpret_cast<float4*>(pe)[i] = __ldg(reinterpret_cast<const float4*>(p.pos) + i);
  for (int i = threadIdx.x; i < d * H; i += MMA_THREADS) pw[i] = Store<bf16>::ldg1(w_in + i);
  __syncthreads();
  pr.mark(P_PRO);
  // x = past · in_proj + pos
  const int n = threadIdx.x % H;
  {  // thread column n, rows m0 + 4i; rows past the valid ones 0
    const int m0 = threadIdx.x / H;
    int row = m0 % t;  // the row's token, for pos
#pragma unroll 4
    for (int i = 0; i < ROWS / (MMA_THREADS / H); ++i) {
      const int m = m0 + i * (MMA_THREADS / H);
      float acc = ps[m * d] * pw[n];
      for (int k = 1; k < d; ++k) acc = fmaf(ps[m * d + k], pw[k * H + n], acc);
      xs[m * LDX + n] = m < n_tok ? acc + pe[row * H + n] : 0.f;
      row += MMA_THREADS / H;
      while (row >= t) row -= t;
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
  for (int l = 0; l < layers; ++l) {
    const float* const* w = p.layer[l];
    layer_norm_bf16<ROWS>(xs, hb, w[LN1_S], w[LN1_B]);
    pr.mark(P_LN);
    gemm_mma<ROWS>(hb, LDB, H, 0, ws, pr, P_WAIT, P_MMA, P_EPI, store_to(qb));
    gemm_mma<ROWS>(hb, LDB, H, 0, ws, pr, P_WAIT, P_MMA, P_EPI, store_to(kb));
    gemm_mma<ROWS>(hb, LDB, H, 0, ws, pr, P_WAIT, P_MMA, P_EPI, store_to(vb));
    sync_probe(pr);
    {  // thread (head, row, half); rows past the valid ones keep LN1's output
      const int half = threadIdx.x & 1, m = (threadIdx.x >> 1) % ROWS, head = threadIdx.x / (2 * ROWS);
      const unsigned mask = __ballot_sync(FULL, m < n_tok);
      if (m < n_tok) {
        const int col = head * (H / HEADS) + half * (H / HEADS / 2);
        attend_half(qb + m * LDX + col, kb + col, vb + col, (m / t) * t, t, hb + m * LDB + col, mask);
      }
    }
    pr.mark(P_ATT);
    gemm_mma<ROWS>(hb, LDB, H, 0, ws, pr, P_WAIT, P_MMA, P_EPI, add_to_x);
    sync_probe(pr);
    layer_norm_bf16<ROWS>(xs, hb, w[LN2_S], w[LN2_B]);
    pr.mark(P_LN);
    // u = gelu(h · W1 + b1) rounded to bf16, 128 columns a product, over q, k, v
    const float* b1 = w[B1];
    auto gelu_to_u = [ub, b1](int r, int c, float v0, float v1) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + c));
      *reinterpret_cast<unsigned*>(ub + r * LDUB + c) = Store<bf16>::pack(gelu_tanh(v0 + bb.x), gelu_tanh(v1 + bb.y));
    };
    for (int n0 = 0; n0 < MLP; n0 += H) gemm_mma<ROWS>(hb, LDB, H, n0, ws, pr, P_WAIT, P_MMA, P_GELU, gelu_to_u);
    const float* b2 = w[B2];
    auto mlp_to_x = [xs, b2](int r, int c, float v0, float v1) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + c));
      float2* x = reinterpret_cast<float2*>(xs + r * LDX + c);
      *x = make_float2(x->x + (v0 + bb.x), x->y + (v1 + bb.y));
    };
    gemm_mma<ROWS>(ub, LDUB, MLP, 0, ws, pr, P_WAIT, P_MMA, P_EPI, mlp_to_x);
    sync_probe(pr);
  }
  // enc_mem rows out: a warp a row
  for (int m = warp; m < n_tok; m += MMA_WARPS)
    reinterpret_cast<float4*>(enc + (tok0 + m) * H)[lane] = *reinterpret_cast<const float4*>(xs + m * LDX + 4 * lane);
  pr.mark(P_OUT);
}

}  // namespace tfm
