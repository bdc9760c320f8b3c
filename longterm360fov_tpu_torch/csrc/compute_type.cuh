// The compute type CT of the bf16 tiers, shared by the serving kernels of
// fused_serve.cu and the training kernels of lstm_common.cuh:
//   * float: exact f32 products;
//   * __nv_bfloat16: the TPU kernels' compute_dtype=bfloat16 tier, in which
//     both operands of every product are rounded to bf16 and the products
//     summed in f32. Weights arrive in CT, rounded once per call by the
//     wrapper (half the bytes of f32 from L2); an activation is kept in f32
//     and rounded where it enters a product (cround).
// ldw4 and ldw1 read weights (or any CT vector) through the read-only path
// and widen them to f32, so one loop body serves both types.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

// x as a product operand of the CT tier: rounded to nearest even in bf16,
// as torch and XLA cast
template <typename CT>
__device__ __forceinline__ float cround(float x) {
  if constexpr (std::is_same<CT, float>::value)
    return x;
  else
    return __bfloat162float(__float2bfloat16_rn(x));
}

// 4 consecutive values (one 16-byte load in f32, one 8-byte load in bf16)
__device__ __forceinline__ void ldw4(const float* p, float (&w)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void ldw4(const __nv_bfloat16* p, float (&w)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  w[0] = lo.x;
  w[1] = lo.y;
  w[2] = hi.x;
  w[3] = hi.y;
}

// one value
__device__ __forceinline__ float ldw1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ldw1(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// the logistic function in exact f32 (expf and an IEEE division, no fast
// math), shared by every LSTM cell of the kernels
__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

// one value stored in ST (f32, or bf16 rounded to nearest even)
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }

__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
