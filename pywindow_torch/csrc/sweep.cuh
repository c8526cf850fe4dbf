// Host and device code shared by the kernels that stage a frame's atoms
// in shared memory: raising a block's dynamic shared-memory limit
// (path_sweep.cu, fine_path.cu, dbscan.cu, lbfgsb_stable.cu, nm_xy.cu) and
// staging the atoms as four columns (lbfgsb_stable.cu).
#pragma once

#include <cuda_runtime.h>

#include "kernels.h"

namespace pw {

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

}  // namespace pw
