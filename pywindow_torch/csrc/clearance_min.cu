// clearance_min: the vdW clearance field min_i(|x_i - p| - vdw_i) of Q
// probe points against N atoms.
//
// Replaces pywindow_tpu/ops/pallas_kernels.py::clearance_min_pallas
// (:43).  Like it, this is a standalone function that no pipeline stage
// calls.  Padded atoms follow the MolArrays convention (coordinates
// ~1e6, vdW 0), so they never win the minimum and no mask is read.
//
// Design: one thread per probe; the atoms (x, y, z, r) are staged
// through shared memory in tiles of CLEARANCE_THREADS, one atom per
// thread, so any atom count works.  Distances in the difference form
// ((dx*dx + dy*dy) + dz*dz, as the TPU kernel: the Gram form cancels in
// float32), built with -fmad=false, so each distance rounds exactly as
// the plain version (geometry.clearance_field) computes it and the
// minimum, exact in any order, equals it to the bit.
//
// Bound: ~11 operations per (probe, atom) pair (3 differences, 3
// products, 2 sums, a square root, a difference and a compare) against
// 12 bytes per probe and 16 per atom moved, so the kernel is bound by
// arithmetic at any shape the callers use (Q * N >> Q + N); the square
// root is the costly one.
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int CLEARANCE_THREADS = 256;

__device__ inline float positive_inf(float) { return __int_as_float(0x7f800000); }
__device__ inline double positive_inf(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}

template <typename T>
__global__ void clearance_min_kernel(const T* __restrict__ probes,
                                     const T* __restrict__ coords,
                                     const T* __restrict__ vdw,
                                     T* __restrict__ out, int Q, int N) {
  __shared__ T sx[CLEARANCE_THREADS];
  __shared__ T sy[CLEARANCE_THREADS];
  __shared__ T sz[CLEARANCE_THREADS];
  __shared__ T sr[CLEARANCE_THREADS];

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = q < Q;
  T p0 = T(0), p1 = T(0), p2 = T(0);
  if (live) {
    p0 = probes[3 * q];
    p1 = probes[3 * q + 1];
    p2 = probes[3 * q + 2];
  }
  T best = positive_inf(T(0));
  for (int base = 0; base < N; base += CLEARANCE_THREADS) {
    const int n_tile = min(CLEARANCE_THREADS, N - base);
    __syncthreads();  // the previous tile is fully consumed
    if (threadIdx.x < n_tile) {
      const int a = base + threadIdx.x;
      sx[threadIdx.x] = coords[3 * a];
      sy[threadIdx.x] = coords[3 * a + 1];
      sz[threadIdx.x] = coords[3 * a + 2];
      sr[threadIdx.x] = vdw[a];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n_tile; ++i) {
      const T dx = p0 - sx[i];
      const T dy = p1 - sy[i];
      const T dz = p2 - sz[i];
      const T d = sqrt(dx * dx + dy * dy + dz * dz) - sr[i];
      // a NaN wins and stays (nothing compares below it), as in torch.amin
      if (d < best || d != d) best = d;
    }
  }
  if (live) out[q] = best;
}

template <typename T>
void launch_clearance_min(const T* probes, const T* coords, const T* vdw,
                          T* out, int Q, int N, void* stream) {
  if (Q <= 0 || N <= 0) return;
  const int blocks = (Q + CLEARANCE_THREADS - 1) / CLEARANCE_THREADS;
  clearance_min_kernel<T><<<blocks, CLEARANCE_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      probes, coords, vdw, out, Q, N);
}

}  // namespace

void pw::clearance_min(const float* probes, const float* coords,
                       const float* vdw, float* out, int Q, int N,
                       void* stream) {
  launch_clearance_min(probes, coords, vdw, out, Q, N, stream);
}

void pw::clearance_min(const double* probes, const double* coords,
                       const double* vdw, double* out, int Q, int N,
                       void* stream) {
  launch_clearance_min(probes, coords, vdw, out, Q, N, stream);
}
