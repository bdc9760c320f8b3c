// Device code shared by the transformer kernels (transformer_encode.cu,
// transformer_encode_train.cu, transformer_decode.cu): the model's
// constants, the bf16 packing of the bf16 tiers (Store<__nv_bfloat16>),
// the tanh GELU, warp sums and cp.async copies. The products run on the
// tensor cores: three-pass TF32 in the f32 tiers (transformer_tf32.cuh),
// bf16 in the bf16 tiers (transformer_stream.cuh).
//
// A bf16 tier's operands of every product are rounded to bf16 (the weights
// stored so, the activations rounded where they are written), products
// summed in f32; LN, softmax, GELU and the residual stream in f32. A bf16
// value is exact in f32, so each product term is the exact product of the
// two rounded operands.
//
// The f32 activation buffers of a block have row stride LDX = 132 floats, a
// 16-byte multiple whose rows r and r + 4 fall 16 banks apart.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace tfm {

constexpr int H = 128;        // model width: the kernels take hidden = 128 only
constexpr int HEADS = 4;      // 32-wide heads
constexpr int MLP = 4 * H;    // MLP hidden width
constexpr int ROWS = 64;      // token rows a block of the f32 encoder holds
constexpr int THREADS = 256;  // threads of a block of the f32 encoder
constexpr int LDX = H + 4;
constexpr float SCALE = 0.17677669529663687f;  // 1 / sqrt(head width 32)
constexpr unsigned FULL = 0xffffffffu;

// The bf16 tiers' packing of f32 values into bf16 and back, and the
// rounding to bf16.
template <typename T>
struct Store;

template <>
struct Store<__nv_bfloat16> {
  // a pair of bf16 in 32 bits, the first in the low half: widening to f32
  // is a shift, exact
  static __device__ __forceinline__ float lo(unsigned u) { return __uint_as_float(u << 16); }
  static __device__ __forceinline__ float hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }
  static __device__ __forceinline__ unsigned pack(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&v);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float ldg1(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
};

// a pointer of a kernel's pointer table (kept as const float*) to a matrix
// stored in T
template <typename T>
__device__ __forceinline__ const T* as(const float* p) {
  return reinterpret_cast<const T*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Copies of 16 bytes from device to shared memory that do not wait:
// cp.async on the card (the emulation for checking the logic on a CPU
// copies at once).
template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#else
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// every group but the newest N complete
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// jax.nn.gelu's tanh form, with the accurate tanhf
__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x))));
}

}  // namespace tfm
