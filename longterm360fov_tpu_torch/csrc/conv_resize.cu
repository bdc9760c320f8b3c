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
// The arithmetic is small: 2·C·K·K + 9 FLOP per output pixel.
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
// Block (frame b, tile of `tile_rows` output rows) gathers its rows of
// small, with the conv's K/2 halo and zero padding, into shared memory, then
// writes out[b, c, rows, :] for every channel, row-contiguous stores. Row
// tiles give several blocks a frame, so 64 frames fill the 132 SMs. Taps,
// kernels and bias are a few KB, read through L1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
conv_resize_kernel(const float* __restrict__ frames,
                   const int* __restrict__ row_idx,   // (2, h): lo, hi
                   const float* __restrict__ row_wt,  // (2, h): w_lo, w_hi
                   const int* __restrict__ col_idx,   // (2, w)
                   const float* __restrict__ col_wt,  // (2, w)
                   const float* __restrict__ kernels,  // (C, K, K)
                   const float* __restrict__ bias,     // (C,)
                   float* __restrict__ out,            // (B, C, h, w)
                   int src_h, int src_w, int h, int w, int c_out, int ksize,
                   int tile_rows) {
  extern __shared__ float smem[];
  const int pad = ksize / 2;
  const int taps = c_out * ksize * ksize;
  float* s_k = smem;
  float* s_b = s_k + taps;
  float* s_small = s_b + c_out;  // (tile_rows + 2·pad) x (w + 2·pad)
  const int pw = w + 2 * pad;
  const int r0 = blockIdx.y * tile_rows;
  const int rows = min(tile_rows, h - r0);
  const int ph = rows + 2 * pad;
  const float* x = frames + (size_t)blockIdx.x * src_h * src_w;

  for (int i = threadIdx.x; i < taps; i += blockDim.x) s_k[i] = kernels[i];
  for (int i = threadIdx.x; i < c_out; i += blockDim.x) s_b[i] = bias[i];
  // the resize: rows r0 - pad .. r0 + rows + pad - 1 of small, zero outside
  for (int e = threadIdx.x; e < ph * pw; e += blockDim.x) {
    const int a = e / pw, bcol = e - a * pw;
    const int si = r0 - pad + a, sj = bcol - pad;
    float v = 0.f;
    if (si >= 0 && si < h && sj >= 0 && sj < w) {
      const float* top = x + (size_t)row_idx[si] * src_w;
      const float* bot = x + (size_t)row_idx[h + si] * src_w;
      const float rl = row_wt[si], rh = row_wt[h + si];
      const int cl = col_idx[sj], ch = col_idx[w + sj];
      const float t_lo = __fmaf_rn(rh, __ldg(bot + cl), __fmul_rn(rl, __ldg(top + cl)));
      const float t_hi = __fmaf_rn(rh, __ldg(bot + ch), __fmul_rn(rl, __ldg(top + ch)));
      v = __fmaf_rn(col_wt[w + sj], t_hi, __fmul_rn(col_wt[sj], t_lo));
    }
    s_small[e] = v;
  }
  __syncthreads();
  // the conv taps (cross-correlation, dy then dx), the bias and the ReLU
  const int per_c = rows * w;
  float* o = out + (size_t)blockIdx.x * c_out * h * w + (size_t)r0 * w;
  for (int e = threadIdx.x; e < c_out * per_c; e += blockDim.x) {
    const int c = e / per_c, rem = e - c * per_c;
    const int i = rem / w, j = rem - i * w;
    const float* kc = s_k + c * ksize * ksize;
    float acc = 0.f;
    for (int dy = 0; dy < ksize; ++dy)
      for (int dx = 0; dx < ksize; ++dx)
        acc = __fmaf_rn(s_small[(i + dy) * pw + j + dx], kc[dy * ksize + dx], acc);
    o[(size_t)c * h * w + rem] = fmaxf(acc + s_b[c], 0.f);
  }
}

}  // namespace

extern "C" {

// One launch on `stream`: grid (batch, ceil(h / tile_rows)), 256 threads,
// (C·K·K + C + (tile_rows + 2·(K/2))·(w + 2·(K/2))) floats of dynamic shared
// memory, which the wrapper keeps within 48 KB. Returns cudaGetLastError()
// (0 = ok).
int conv_resize_f32(const void* frames, const void* row_idx, const void* row_wt,
                    const void* col_idx, const void* col_wt, const void* kernels,
                    const void* bias, void* out, int batch, int src_h, int src_w,
                    int h, int w, int c_out, int ksize, int tile_rows, void* stream) {
  const int pad = ksize / 2;
  const size_t smem = sizeof(float) *
      ((size_t)c_out * ksize * ksize + c_out + (size_t)(tile_rows + 2 * pad) * (w + 2 * pad));
  const dim3 grid(batch, (h + tile_rows - 1) / tile_rows);
  conv_resize_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const int*>(row_idx),
      static_cast<const float*>(row_wt), static_cast<const int*>(col_idx),
      static_cast<const float*>(col_wt), static_cast<const float*>(kernels),
      static_cast<const float*>(bias), static_cast<float*>(out), src_h, src_w, h, w,
      c_out, ksize, tile_rows);
  return (int)cudaGetLastError();
}

const char* conv_resize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
