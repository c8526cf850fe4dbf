// ray_exit: per ray of each frame, does any vdW sphere cross it in front
// of the origin, and the farthest front exit distance |p1| (-1e30 if
// none).
//
// Replaces pywindow_tpu/ops/pallas_kernels.py::ray_exit_pallas and its
// layout variant _ray_exit_pallas_wide (one kernel, no atom limit).
// Reference behaviour: utilities.py:1132-1161 (vector_preanalysis) and
// :1556-1583 (vector_analysis_reversed).
//
// Design: grid (ray tiles, frames); one thread per ray; the frame's
// molecule (rel, vdw) is staged through shared memory in tiles of
// RAY_EXIT_TILE atoms, so any atom count works.  Per (ray, atom) pair
// the work is ~20 flops and no memory traffic beyond the shared tile, so
// the kernel is bound by arithmetic (and, for one molecule at the main
// path's P ~ 800-950 rays, by having only a handful of blocks in flight
// on the card's 132 SMs; a batch of frames fills the card).
//
// Arithmetic, as in the TPU kernel: the perpendicular distance in the
// stable form rel - t_ca*u (the Gram form |rel|^2 - t_ca^2 cancels near
// tangency); the front test t_hc > 0 and t_ca + o.u > 0 (the algebraic
// form of |p0|^2 < |p1|^2); |p1|^2 in expanded form, with the sqrt after
// the max (sqrt is monotone).  WANT_EXIT=false is the slim pre-analysis
// form with no sqrt at all.
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int RAY_EXIT_THREADS = 128;
constexpr int RAY_EXIT_TILE = 128;

template <typename T, bool WANT_EXIT>
__global__ void ray_exit_kernel(const T* __restrict__ unit_all,
                                const T* __restrict__ rel_all,
                                const T* __restrict__ vdw_all,
                                const T* __restrict__ origin_all,
                                uint8_t* __restrict__ any_front_all,
                                T* __restrict__ max_exit_all, int P, int N) {
  __shared__ T sx[RAY_EXIT_TILE];
  __shared__ T sy[RAY_EXIT_TILE];
  __shared__ T sz[RAY_EXIT_TILE];
  __shared__ T sr[RAY_EXIT_TILE];

  const int frame = blockIdx.y;
  const T* unit = unit_all + static_cast<size_t>(frame) * P * 3;
  const T* rel = rel_all + static_cast<size_t>(frame) * N * 3;
  const T* vdw = vdw_all + static_cast<size_t>(frame) * N;
  const T* origin = origin_all + static_cast<size_t>(frame) * 3;
  uint8_t* any_front = any_front_all + static_cast<size_t>(frame) * P;
  T* max_exit = max_exit_all + static_cast<size_t>(frame) * P;

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < P;
  T u0 = T(0), u1 = T(0), u2 = T(0);
  if (live) {
    u0 = unit[3 * p];
    u1 = unit[3 * p + 1];
    u2 = unit[3 * p + 2];
  }
  const T o0 = origin[0], o1 = origin[1], o2 = origin[2];
  const T ou = o0 * u0 + o1 * u1 + o2 * u2;
  const T oo = o0 * o0 + o1 * o1 + o2 * o2;

  bool anyf = false;
  T best = T(-pw::kBig);
  for (int base = 0; base < N; base += RAY_EXIT_TILE) {
    const int n_tile = min(RAY_EXIT_TILE, N - base);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
      const int a = base + i;
      sx[i] = rel[3 * a];
      sy[i] = rel[3 * a + 1];
      sz[i] = rel[3 * a + 2];
      sr[i] = vdw[a];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n_tile; ++i) {
      const T x0 = sx[i], x1 = sy[i], x2 = sz[i];
      const T t_ca = u0 * x0 + u1 * x1 + u2 * x2;
      const T q0 = x0 - t_ca * u0;
      const T q1 = x1 - t_ca * u1;
      const T q2 = x2 - t_ca * u2;
      const T d2 = q0 * q0 + q1 * q1 + q2 * q2;
      const T under = sr[i] * sr[i] - d2;
      if (under > T(0) && t_ca + ou > T(0)) {
        anyf = true;
        if (WANT_EXIT) {
          const T t1 = t_ca + sqrt(under);
          const T p1n2 = t1 * (t1 + (ou + ou)) + oo;
          best = max(best, p1n2);
        }
      }
    }
  }
  if (live) {
    any_front[p] = anyf ? 1 : 0;
    max_exit[p] = (WANT_EXIT && anyf) ? sqrt(max(best, T(0))) : T(-pw::kBig);
  }
}

template <typename T>
void launch_ray_exit(const T* unit, const T* rel, const T* vdw,
                     const T* origin, uint8_t* any_front, T* max_exit, int B,
                     int P, int N, bool want_exit, void* stream) {
  if (B <= 0 || P <= 0) return;
  const dim3 grid((P + RAY_EXIT_THREADS - 1) / RAY_EXIT_THREADS, B);
  auto s = static_cast<cudaStream_t>(stream);
  if (want_exit) {
    ray_exit_kernel<T, true><<<grid, RAY_EXIT_THREADS, 0, s>>>(
        unit, rel, vdw, origin, any_front, max_exit, P, N);
  } else {
    ray_exit_kernel<T, false><<<grid, RAY_EXIT_THREADS, 0, s>>>(
        unit, rel, vdw, origin, any_front, max_exit, P, N);
  }
}

}  // namespace

void pw::ray_exit(const float* unit, const float* rel, const float* vdw,
                  const float* origin, uint8_t* any_front, float* max_exit,
                  int B, int P, int N, bool want_exit, void* stream) {
  launch_ray_exit(unit, rel, vdw, origin, any_front, max_exit, B, P, N,
                  want_exit, stream);
}

void pw::ray_exit(const double* unit, const double* rel, const double* vdw,
                  const double* origin, uint8_t* any_front, double* max_exit,
                  int B, int P, int N, bool want_exit, void* stream) {
  launch_ray_exit(unit, rel, vdw, origin, any_front, max_exit, B, P, N,
                  want_exit, stream);
}
