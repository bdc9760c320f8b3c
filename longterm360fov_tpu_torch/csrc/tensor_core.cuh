// The bf16 tensor-core instructions that the hand-written kernels use on
// Hopper (sm_90a), shared by the LSTM dW product (lstm_common.cuh) and the
// transformer encoder's bf16 tier (transformer_mma.cuh):
//   * ldsm_x4 / ldsm_x4_trans: ldmatrix of four 8 x 8 tiles of 16-bit values
//     from shared memory, lane l giving the address of row l % 8 of tile
//     l / 8 (16-byte aligned); .trans hands each lane the transposed tile's
//     elements, so a k-major (K, N) slab gives mma's "col" B fragments;
//   * mma_bf16: mma.sync m16n8k16, bf16 operands, f32 accumulators in place.

#pragma once

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
