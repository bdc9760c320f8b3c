// The probe builds' in-kernel clock64 counters, shared by every kernel that
// has a probe build. Thread 0 of every block adds the clocks it spends in
// each part of its work to that part's sum in a __device__ array (the
// kernel's own, indexed by its own enum of parts); probe_read copies the
// sums out and zeroes them. ClockProbe<false>, the kernels' own build, is
// empty and its marks compile to nothing.

#pragma once

#include <cstddef>

template <bool ON>
struct ClockProbe {
  unsigned long long* sums;
  long long t;
  __device__ explicit ClockProbe(unsigned long long* s) : sums(s), t(now()) {}
  __device__ __forceinline__ void mark(int part) {
    const long long n = now();
    if (threadIdx.x == 0) atomicAdd(sums + part, (unsigned long long)(n - t));
    t = n;
  }
  __device__ __forceinline__ static long long now() {
#if defined(__CUDA_ARCH__)
    return clock64();
#else
    return 0;
#endif
  }
};

template <>
struct ClockProbe<false> {
  __device__ explicit ClockProbe(unsigned long long*) {}
  __device__ __forceinline__ void mark(int) {}
};

// A probe's sums (host memory, N of them) into out; then zeroed. Returns
// cudaGetLastError()-style codes.
template <size_t N>
inline int probe_read(unsigned long long (&sums)[N], unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, sums, sizeof(sums));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[N] = {};
  return (int)cudaMemcpyToSymbol(sums, zero, sizeof(sums));
}
