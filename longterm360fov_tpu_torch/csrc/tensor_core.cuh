// The tensor-core instructions that the hand-written kernels use on Hopper
// (sm_90a), shared by the LSTM dW product (lstm_common.cuh), the bf16 LSTM
// encoders and cell (lstm_mma.cuh), the transformer encoder's bf16 tier
// (transformer_mma.cuh) and its f32 tier (transformer_f32mma.cuh), and the
// cp.async copies that feed the LSTM kernels' shared memory:
//   * ldsm_x4 / ldsm_x4_trans: ldmatrix of four 8 x 8 tiles of 16-bit values
//     from shared memory, lane l giving the address of row l % 8 of tile
//     l / 8 (16-byte aligned); .trans hands each lane the transposed tile's
//     elements, so a k-major (K, N) slab gives mma's "col" B fragments;
//     without .trans, a row of four 32-bit values is read as eight 16-bit
//     ones, so lane l gets the 32-bit value at row l / 4, column l % 4 of
//     each 8 x 4 tile: a TF32 fragment of a k-contiguous operand;
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

// The three-pass TF32 products of the f32 transformer encoder
// (transformer_f32mma.cuh) and the lockstep peer backward (lstm_align.cu):
//   * tf32_rna: x rounded to TF32 (10 mantissa bits), to nearest, ties away
//     from zero, as a 32-bit register that mma reads as a .tf32 operand;
//   * split_tf32: x → (hi, lo) = (tf32(x), tf32(x - hi)), 11 significant
//     bits each, 22 together;
//   * mma_tf32: mma.sync m16n8k8, TF32 operands (A four registers, B two),
//     f32 accumulators in place.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device to shared memory that do not wait (cp.async.cg); 16
// bytes of zeros when !ok (source size 0)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0));  // src size 0: 16 bytes of zeros
}
// 4 bytes (cp.async.ca: the size .cg does not take); zeros when !ok
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// every group but the newest N complete
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }
