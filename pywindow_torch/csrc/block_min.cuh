// Device code shared by the two optimiser kernels, lbfgsb_stable.cu and
// nm_xy.cu, whose lane is one block of several warps: block-wide minima
// that leave the same value in every thread.
#pragma once

#include <cuda_runtime.h>

namespace pw {

// at most 32 warps a block, at most 4 values a reduction
constexpr int kMaxWarps = 32;
constexpr int kMaxValues = 4;
// doubles of shared memory a BlockMin needs (two buffers)
constexpr int kBlockMinDoubles = 2 * kMaxWarps * kMaxValues;

__device__ __forceinline__ double warp_min(double v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmin(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Block-wide minimum of K <= 4 values per thread: shuffles within each
// warp, one shared-memory slot per warp, one barrier, then every thread
// folds the warps' slots in the same order, so all hold the same
// minimum.  fmin is exact and order-free on non-NaN values, so the result
// equals a serial minimum.  The two buffers alternate: a thread writes a
// buffer again only after the next reduction's barrier, which every
// thread reaches after reading it.  Every thread of the block must make
// the same sequence of calls.
struct BlockMin {
  double* buf;  // kBlockMinDoubles doubles of shared memory
  int parity;

  template <int K>
  __device__ void operator()(double (&v)[K]) {
    static_assert(K <= kMaxValues, "BlockMin: at most kMaxValues values");
    double* b = buf + parity * (kMaxWarps * kMaxValues);
    parity ^= 1;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = warp_min(v[k]);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) b[warp * kMaxValues + k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double m = b[k];
      for (int w = 1; w < n_warps; ++w) m = fmin(m, b[w * kMaxValues + k]);
      v[k] = m;
    }
  }
};

}  // namespace pw
