// Device code shared by the two culled ray kernels, path_sweep.cu and
// ray_exit.cu: one 16-byte-aligned record per atom (x, y, z, vdW) in
// shared memory, the unit roundoff their cull margins scale with, and
// the warp's first-minimum reduction.
#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace pw {

constexpr unsigned kFullMask = 0xffffffffu;

// One atom as the kernels read it from shared memory: a float4 for
// float (one 16-byte load), two 16-byte loads for double.
template <typename T>
struct __align__(16) Rec {
  T x, y, z, r;
};

// Unit roundoff of T (half an ulp of 1): 2^-24 for float, 2^-53 for double.
template <typename T>
__device__ __forceinline__ T unit_roundoff();
template <>
__device__ __forceinline__ float unit_roundoff<float>() {
  return 5.9604644775390625e-8f;
}
template <>
__device__ __forceinline__ double unit_roundoff<double>() {
  return 1.1102230246251565e-16;
}

// Copy n atoms, coords (n,3) and vdw (n,), into records; every thread
// of the block takes part.  The caller synchronises.
template <typename T>
__device__ __forceinline__ void stage_records(const T* __restrict__ coords,
                                              const T* __restrict__ vdw,
                                              int n, Rec<T>* out) {
  for (int a = threadIdx.x; a < n; a += blockDim.x) {
    out[a] = Rec<T>{coords[3 * a], coords[3 * a + 1], coords[3 * a + 2],
                    vdw[a]};
  }
}

// The warp's least (value, index) pair, the lower index on equal values:
// every lane returns it.  Minima are exact, so the result does not depend
// on the order of the shuffles.
template <typename T>
__device__ __forceinline__ void warp_first_min(T& value, int& index) {
  for (int off = 16; off > 0; off >>= 1) {
    const T v = __shfl_xor_sync(kFullMask, value, off);
    const int i = __shfl_xor_sync(kFullMask, index, off);
    if (v < value || (v == value && i < index)) {
      value = v;
      index = i;
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = min(v, __shfl_xor_sync(kFullMask, v, off));
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = max(v, __shfl_xor_sync(kFullMask, v, off));
  }
  return v;
}

}  // namespace pw
