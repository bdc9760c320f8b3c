// Fused bilinear resize + KxK conv + bias + ReLU for Hopper (sm_90a), exact
// f32.
//
// Replaces the TPU Pallas kernel of
//   longterm360fov_tpu/ops/conv_resize.py::fused_conv_resize (_kernel)
// which, one frame per grid step, holds the whole (H, W) frame in VMEM,
// forms small = R_h · X · R_wᵀ with two MXU products, and runs the C·K·K
// conv taps, the bias and the ReLU on the VPU: out (B, C, h, w).
//
// What bounds it on the card. The resize operators of resize_matrix have at
// most two non-zeros a row (the lo and hi taps of bilinear sampling), so the
// function reads only the source rows and columns that some tap touches: at
// 64 frames of 960 x 1920 → 32 x 64, 64 rows x 128 columns of each frame,
// 2.1 MB, while the output is 4.2 MB. Bytes bound it: about 2 µs at
// 3.35 TB/s, where a dense R_h · X · R_wᵀ would read all 472 MB (0.14 ms).
// But the taps of one row of small lie 15-30 source pixels apart, so the
// card moves a 32-byte sector for each pair of them (lo and hi columns
// usually share one): 8.4 MB at 64 frames, 157 MB for a 1200-frame 480 x 960
// clip, beside the output's 4.2 and 79 MB. The arithmetic is small:
// 2·C·K·K + 9 FLOP per output pixel.
//
// What the design does about it. A frame does not fit in a block (7.4 MB
// against 227 KB of shared memory), and it need not: the host hands the
// kernel each output row's and column's two taps, (lo, hi) and their f32
// weights, taken from resize_matrix's own non-zeros (a clamped border merges
// both taps into one weight, as resize_matrix does), so a block gathers
// small[i, j] from at most 4 source pixels:
//   small[i, j] = wc_lo · (wr_lo·X[lo_r, lo_c] + wr_hi·X[hi_r, lo_c])
//               + wc_hi · (wr_lo·X[lo_r, hi_c] + wr_hi·X[hi_r, hi_c]),
// the rows first, as the TPU kernel's (R_h · X) · R_wᵀ. Each product pair
// is one rounded multiply and one fused multiply-add, which is what a dense
// f32 product does with its zero terms: the same function to within an ulp.
//   * A block takes a tile of `tile_rows` x `tile_cols` output pixels of one
//     frame (ops/conv_resize.py conv_tile): a whole frame where the frames
//     alone fill the card twice over (a clip: no halo computed twice), else
//     bands of 8 rows, so that 64 frames still give 2 blocks an SM; rows
//     wider than 256 in tiles of 256 columns, so any width is taken. Its
//     taps, the filters and the bias first go to shared memory.
//   * Phase 1 gathers the tile's small with the conv's K/2 halo (zeros past
//     the frame) into shared memory, four pixels a thread at a time so that
//     16 loads are in flight; lo and hi of a pair come through L1 (ld.nc):
//     one sector from the card's memory for both, where they share it.
//   * Phase 2: a thread takes 4 neighbouring output pixels of a row for
//     every channel: its K x (K + 3) window of small in registers (16-byte
//     shared loads, K = 3), C·4·K·K fused multiply-adds in the order dy then
//     dx, the bias and the ReLU, and one 16-byte store a channel where the
//     row is whole 16-byte pieces.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a Hopper block may use

// Shared memory, in floats: filters (C·K·K), bias (C), the row taps of the
// tile's (tile_rows + 2·pad) rows (lo, hi as ints, w_lo, w_hi), the column
// taps of its (tile_cols + 2·pad) columns, then, from a 16-byte boundary,
// small with its halo, rows of ldp = (tile_cols + 2·pad) rounded up to 4
// floats.
__host__ __device__ inline int small_ld(int tile_cols, int pad) { return (tile_cols + 2 * pad + 3) / 4 * 4; }
__host__ __device__ inline int small_at(int tile_rows, int tile_cols, int c_out, int ksize) {
  const int pad = ksize / 2;
  return (c_out * (ksize * ksize + 1) + 4 * (tile_rows + 2 * pad) + 4 * (tile_cols + 2 * pad) + 3) / 4 * 4;
}
__host__ __device__ inline long long smem_floats(int tile_rows, int tile_cols, int c_out, int ksize) {
  return small_at(tile_rows, tile_cols, c_out, ksize) +
         (long long)(tile_rows + 2 * (ksize / 2)) * small_ld(tile_cols, ksize / 2);
}

// The conv of one item: output row i of the tile, columns j0 .. j0 + 3, every
// channel, from small (rows of ldp), K taps a side (KT: the compile-time K,
// 0 for any odd ksize read at run time).
template <int KT>
__device__ __forceinline__ void conv_item(const float* s_small, int ldp, const float* s_k, const float* s_b,
                                          int ksize, int c_out, int i, int j0, float* o, size_t plane, int ncols,
                                          bool vec) {
  const int K = KT ? KT : ksize;
  auto put = [&](float* p, const float (&acc)[4], float bias) {
    const float4 v = make_float4(fmaxf(acc[0] + bias, 0.f), fmaxf(acc[1] + bias, 0.f), fmaxf(acc[2] + bias, 0.f),
                                 fmaxf(acc[3] + bias, 0.f));
    if (vec && ncols == 4) {
      *reinterpret_cast<float4*>(p) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int jj = 0; jj < ncols; ++jj) p[jj] = e[jj];
    }
  };
  if constexpr (KT == 3) {
    float win[3][8];  // rows i .. i + 2 of small, columns j0 .. j0 + 5 (and two unused)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float4 a = *reinterpret_cast<const float4*>(s_small + (i + dy) * ldp + j0);
      const float4 b = *reinterpret_cast<const float4*>(s_small + (i + dy) * ldp + j0 + 4);
      win[dy][0] = a.x, win[dy][1] = a.y, win[dy][2] = a.z, win[dy][3] = a.w;
      win[dy][4] = b.x, win[dy][5] = b.y, win[dy][6] = b.z, win[dy][7] = b.w;
    }
    for (int c = 0; c < c_out; ++c) {
      const float* kc = s_k + c * 9;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[jj] = __fmaf_rn(win[dy][jj + dx], kc[dy * 3 + dx], acc[jj]);
      put(o + c * plane, acc, s_b[c]);
    }
  } else {
    for (int c = 0; c < c_out; ++c) {
      const float* kc = s_k + c * K * K;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int dy = 0; dy < K; ++dy)
        for (int dx = 0; dx < K; ++dx)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[jj] = __fmaf_rn(s_small[(i + dy) * ldp + j0 + jj + dx], kc[dy * K + dx], acc[jj]);
      put(o + c * plane, acc, s_b[c]);
    }
  }
}

// Block (frame blockIdx.x, row band blockIdx.y, column tile blockIdx.z).
template <int KT>
__global__ void __launch_bounds__(kThreads)
conv_resize_kernel(const float* __restrict__ frames,
                   const int* __restrict__ row_idx,   // (2, h): lo, hi
                   const float* __restrict__ row_wt,  // (2, h): w_lo, w_hi
                   const int* __restrict__ col_idx,   // (2, w)
                   const float* __restrict__ col_wt,  // (2, w)
                   const float* __restrict__ kernels,  // (C, K, K)
                   const float* __restrict__ bias,     // (C,)
                   float* __restrict__ out,            // (B, C, h, w)
                   int src_h, int src_w, int h, int w, int c_out, int ksize, int tile_rows, int tile_cols) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int pad = ksize / 2, taps = c_out * ksize * ksize;
  const int r0 = blockIdx.y * tile_rows, c0 = blockIdx.z * tile_cols;
  const int rows = min(tile_rows, h - r0), cols = min(tile_cols, w - c0);
  const int pr = rows + 2 * pad, pc = cols + 2 * pad, ldp = small_ld(tile_cols, pad);
  float* s_k = reinterpret_cast<float*>(smem4);
  float* s_b = s_k + taps;
  int* s_ri = reinterpret_cast<int*>(s_b + c_out);  // (2, pr): lo, hi; -1 past the frame
  float* s_rw = reinterpret_cast<float*>(s_ri + 2 * (tile_rows + 2 * pad));
  int* s_ci = reinterpret_cast<int*>(s_rw + 2 * (tile_rows + 2 * pad));
  float* s_cw = reinterpret_cast<float*>(s_ci + 2 * (tile_cols + 2 * pad));
  float* s_small = s_k + small_at(tile_rows, tile_cols, c_out, ksize);
  const int ldr = tile_rows + 2 * pad, ldc = tile_cols + 2 * pad;
  const float* x = frames + (size_t)blockIdx.x * src_h * src_w;

  for (int i = tid; i < taps; i += nthr) s_k[i] = kernels[i];
  for (int i = tid; i < c_out; i += nthr) s_b[i] = bias[i];
  for (int a = tid; a < pr; a += nthr) {
    const int si = r0 - pad + a;
    const bool in = si >= 0 && si < h;
    s_ri[a] = in ? row_idx[si] : -1;
    s_ri[ldr + a] = in ? row_idx[h + si] : -1;
    s_rw[a] = in ? row_wt[si] : 0.f;
    s_rw[ldr + a] = in ? row_wt[h + si] : 0.f;
  }
  for (int b = tid; b < pc; b += nthr) {
    const int sj = c0 - pad + b;
    const bool in = sj >= 0 && sj < w;
    s_ci[b] = in ? col_idx[sj] : -1;
    s_ci[ldc + b] = in ? col_idx[w + sj] : -1;
    s_cw[b] = in ? col_wt[sj] : 0.f;
    s_cw[ldc + b] = in ? col_wt[w + sj] : 0.f;
  }
  __syncthreads();

  // phase 1: small of the tile with its halo, 4 pixels a thread at a time
  const int np = pr * pc;
  for (int e0 = tid; e0 < np; e0 += 4 * nthr) {
    float v[4][4];
    bool in[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int e = e0 + g * nthr, a = e / pc, b = e - a * pc;
      in[g] = e < np && s_ri[a] >= 0 && s_ci[b] >= 0;
      if (in[g]) {
        const float* top = x + (size_t)s_ri[a] * src_w;
        const float* bot = x + (size_t)s_ri[ldr + a] * src_w;
        const int cl = s_ci[b], ch = s_ci[ldc + b];
        v[g][0] = __ldg(top + cl), v[g][1] = __ldg(bot + cl), v[g][2] = __ldg(top + ch), v[g][3] = __ldg(bot + ch);
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int e = e0 + g * nthr, a = e / pc, b = e - a * pc;
      if (e < np) {
        float s = 0.f;
        if (in[g]) {
          const float rl = s_rw[a], rh = s_rw[ldr + a];
          const float t_lo = __fmaf_rn(rh, v[g][1], __fmul_rn(rl, v[g][0]));
          const float t_hi = __fmaf_rn(rh, v[g][3], __fmul_rn(rl, v[g][2]));
          s = __fmaf_rn(s_cw[ldc + b], t_hi, __fmul_rn(s_cw[b], t_lo));
        }
        s_small[a * ldp + b] = s;
      }
    }
  }
  // the columns of small past pc up to the 16-byte loads' reach read zeros
  for (int a = tid; a < pr; a += nthr)
    for (int b = pc; b < ldp; ++b) s_small[a * ldp + b] = 0.f;
  __syncthreads();

  // phase 2: 4 output pixels of a row a thread, every channel
  const int quads = (cols + 3) / 4;
  const size_t plane = (size_t)h * w;
  const bool vec = (w & 3) == 0;
  float* o = out + (size_t)blockIdx.x * c_out * plane + (size_t)r0 * w + c0;
  for (int it = tid; it < rows * quads; it += nthr) {
    const int i = it / quads, j0 = (it - i * quads) * 4;
    conv_item<KT>(s_small, ldp, s_k, s_b, ksize, c_out, i, j0, o + (size_t)i * w + j0, plane, min(4, cols - j0),
                  vec);
  }
}

}  // namespace

extern "C" {

// The dynamic shared memory of a block of tile_rows x tile_cols output
// pixels (ops/conv_resize.py conv_tile mirrors it), bytes.
long long conv_resize_smem_bytes(int tile_rows, int tile_cols, int c_out, int ksize) {
  return 4 * smem_floats(tile_rows, tile_cols, c_out, ksize);
}

// One launch on `stream`: grid (batch, ceil(h / tile_rows), ceil(w /
// tile_cols)), 256 threads, conv_resize_smem_bytes of dynamic shared memory
// (at most 227 KB); odd ksize, tile_cols a multiple of 4. Returns
// cudaGetLastError() (0 = ok).
int conv_resize_f32(const void* frames, const void* row_idx, const void* row_wt,
                    const void* col_idx, const void* col_wt, const void* kernels,
                    const void* bias, void* out, int batch, int src_h, int src_w,
                    int h, int w, int c_out, int ksize, int tile_rows, int tile_cols, void* stream) {
  const long long smem = 4 * smem_floats(tile_rows, tile_cols, c_out, ksize);
  const int bands = tile_rows < 1 ? 0 : (h + tile_rows - 1) / tile_rows;
  const int tiles = tile_cols < 1 ? 0 : (w + tile_cols - 1) / tile_cols;
  if (batch < 1 || h < 1 || w < 1 || c_out < 1 || ksize < 1 || ksize % 2 == 0 || tile_rows < 1 || tile_cols < 4 ||
      tile_cols % 4 || bands > 65535 || tiles > 65535 || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(batch, bands, tiles);
  auto go = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(frames), static_cast<const int*>(row_idx), static_cast<const float*>(row_wt),
        static_cast<const int*>(col_idx), static_cast<const float*>(col_wt), static_cast<const float*>(kernels),
        static_cast<const float*>(bias), static_cast<float*>(out), src_h, src_w, h, w, c_out, ksize, tile_rows,
        tile_cols);
    return (int)cudaGetLastError();
  };
  return ksize == 3 ? go(conv_resize_kernel<3>) : go(conv_resize_kernel<0>);
}

const char* conv_resize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
