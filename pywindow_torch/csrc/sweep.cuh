// Device code shared by the two ray walks, path_sweep.cu (the coarse
// sweep of the open rays) and fine_path.cu (the 0.1 A re-sampling of the
// window-slot rays): staging a frame's atoms in shared memory and the
// warp-wide clearance at one probe point.
#pragma once

#include <cuda_runtime.h>

#include "kernels.h"

namespace pw {

// Shared memory a block needs for one frame of N atoms (x, y, z, vdw).
template <typename T>
inline size_t sweep_smem_bytes(int N) {
  return static_cast<size_t>(4) * N * sizeof(T);
}

// Raise the block's dynamic shared-memory limit above the 48 KB default
// where a frame needs it (up to the card's 227 KB; the Python wrappers
// refuse larger frames).
template <typename Kernel>
inline void allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
  }
}

// Copy one frame's atoms, coords (N,3) and vdw (N,), into shared memory
// as four columns; the whole block takes part and synchronises.
template <typename T>
__device__ void stage_atoms(const T* __restrict__ coords,
                            const T* __restrict__ vdw, int N, T* sx, T* sy,
                            T* sz, T* sr) {
  for (int a = threadIdx.x; a < N; a += blockDim.x) {
    sx[a] = coords[3 * a];
    sy[a] = coords[3 * a + 1];
    sz[a] = coords[3 * a + 2];
    sr[a] = vdw[a];
  }
  __syncthreads();
}

// Clearance min_i(|q - x_i| - vdw_i) at q, the atoms strided over the 32
// lanes of the calling warp and reduced by shuffles, so every lane holds
// the result.  Difference form q - x, the plain versions' order of
// operations; padded atoms (coordinates ~1e6, vdW 0) cannot win.
template <typename T>
__device__ T warp_clearance(T q0, T q1, T q2, const T* sx, const T* sy,
                            const T* sz, const T* sr, int N, int lane) {
  T c = T(kBig);
  for (int a = lane; a < N; a += 32) {
    const T d0 = q0 - sx[a];
    const T d1 = q1 - sy[a];
    const T d2 = q2 - sz[a];
    c = min(c, sqrt(d0 * d0 + d1 * d1 + d2 * d2) - sr[a]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    c = min(c, __shfl_xor_sync(0xffffffffu, c, off));
  }
  return c;
}

}  // namespace pw
