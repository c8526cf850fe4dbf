// path_sweep: the coarse ray walk.  Per ray, clearance
// min_i(|q - x_i| - vdw_i) at the probe points q = (l / chunks) * v for
// l = 0 .. min(chunks + 1, max_steps) - 1, reduced to
//   ok   = every probe clearance > 0,
//   pos  = the first step of minimum clearance (strict <),
//   cmin = that minimum clearance.
//
// Replaces pywindow_tpu/ops/pallas_kernels.py::path_sweep_pallas and its
// layout variant _path_sweep_pallas_wide.  Reference behaviour:
// utilities.py:1100-1129.  Padded atoms follow the MolArrays convention
// (coordinates ~1e6, vdW 0) and cannot win the minimum, so no mask.
//
// Design: one warp per ray, atoms strided over the 32 lanes, a
// warp-shuffle min per step, then the running (ok, pos, cmin) over steps
// in registers.  Distances use the difference form |q - x| as the plain
// dense path does (rays.py:336-351 of the JAX package); the TPU kernel's
// Gram form was a trade for the TPU's vector unit that this card does
// not need, and the difference form lets the kernel match its plain
// version exactly in float64.  Work per ray is steps x atoms x ~10 flops
// with the atoms read from L1/L2 (a molecule is a few KB), so the kernel
// is bound by arithmetic and, at the main path's few hundred rays, by
// occupancy.
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int PATH_SWEEP_THREADS = 256;  // 8 rays per block

template <typename T>
__global__ void path_sweep_kernel(const T* __restrict__ vectors,
                                  const int32_t* __restrict__ chunks,
                                  const T* __restrict__ coords,
                                  const T* __restrict__ vdw,
                                  uint8_t* __restrict__ ok_out,
                                  int32_t* __restrict__ pos_out,
                                  T* __restrict__ cmin_out, int P, int N,
                                  int max_steps) {
  const int ray = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (ray >= P) return;  // whole warps only: no block-level sync below
  const T v0 = vectors[3 * ray];
  const T v1 = vectors[3 * ray + 1];
  const T v2 = vectors[3 * ray + 2];
  const int ch = chunks[ray];
  const T chf = T(ch);
  const int n_steps = min(ch + 1, max_steps);

  bool ok = true;
  int pos = 0;
  T cmin = T(pw::kBig);
  for (int l = 0; l < n_steps; ++l) {
    const T frac = T(l) / chf;
    const T q0 = v0 * frac, q1 = v1 * frac, q2 = v2 * frac;
    T c = T(pw::kBig);
    for (int a = lane; a < N; a += 32) {
      const T d0 = q0 - coords[3 * a];
      const T d1 = q1 - coords[3 * a + 1];
      const T d2 = q2 - coords[3 * a + 2];
      c = min(c, sqrt(d0 * d0 + d1 * d1 + d2 * d2) - vdw[a]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      c = min(c, __shfl_xor_sync(0xffffffffu, c, off));
    }
    ok = ok && (c > T(0));
    if (c < cmin) {
      cmin = c;
      pos = l;
    }
  }
  if (lane == 0) {
    ok_out[ray] = ok ? 1 : 0;
    pos_out[ray] = pos;
    cmin_out[ray] = cmin;
  }
}

template <typename T>
void launch_path_sweep(const T* vectors, const int32_t* chunks,
                       const T* coords, const T* vdw, uint8_t* ok,
                       int32_t* pos, T* cmin, int P, int N, int max_steps,
                       void* stream) {
  if (P <= 0) return;
  const int rays_per_block = PATH_SWEEP_THREADS / 32;
  const int blocks = (P + rays_per_block - 1) / rays_per_block;
  path_sweep_kernel<T><<<blocks, PATH_SWEEP_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      vectors, chunks, coords, vdw, ok, pos, cmin, P, N, max_steps);
}

}  // namespace

void pw::path_sweep(const float* vectors, const int32_t* chunks,
                    const float* coords, const float* vdw, uint8_t* ok,
                    int32_t* pos, float* cmin, int P, int N, int max_steps,
                    void* stream) {
  launch_path_sweep(vectors, chunks, coords, vdw, ok, pos, cmin, P, N,
                    max_steps, stream);
}

void pw::path_sweep(const double* vectors, const int32_t* chunks,
                    const double* coords, const double* vdw, uint8_t* ok,
                    int32_t* pos, double* cmin, int P, int N, int max_steps,
                    void* stream) {
  launch_path_sweep(vectors, chunks, coords, vdw, ok, pos, cmin, P, N,
                    max_steps, stream);
}
