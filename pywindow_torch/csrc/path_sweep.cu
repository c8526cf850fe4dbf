// path_sweep: the coarse ray walk.  Per ray of each frame, clearance
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
// Design: grid (ray tiles of 8, frames); the frame's atoms are staged in
// shared memory once per block, then one warp walks one ray: atoms
// strided over the 32 lanes, a warp-shuffle min per step, the running
// (ok, pos, cmin) over steps in registers.  Distances use the difference
// form |q - x| as the plain dense path does (rays.py:336-351 of the JAX
// package); the TPU kernel's Gram form was a trade for the TPU's vector
// unit that this card does not need, and the difference form lets the
// kernel match its plain version exactly in float64.  Work per ray is
// steps x atoms x ~10 flops with the atoms in shared memory, so the
// kernel is bound by arithmetic (a few hundred rays of one molecule by
// occupancy; a batch of frames fills the card).
#include <cuda_runtime.h>

#include "kernels.h"
#include "sweep.cuh"

namespace {

constexpr int PATH_SWEEP_THREADS = 256;  // 8 rays per block
constexpr int RAYS_PER_BLOCK = PATH_SWEEP_THREADS / 32;

template <typename T>
__global__ void path_sweep_kernel(const T* __restrict__ vectors,
                                  const int32_t* __restrict__ chunks,
                                  const T* __restrict__ coords,
                                  const T* __restrict__ vdw,
                                  uint8_t* __restrict__ ok_out,
                                  int32_t* __restrict__ pos_out,
                                  T* __restrict__ cmin_out, int P, int N,
                                  int max_steps) {
  extern __shared__ unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + N;
  T* sz = sy + N;
  T* sr = sz + N;
  const int frame = blockIdx.y;
  pw::stage_atoms(coords + static_cast<size_t>(frame) * N * 3,
                  vdw + static_cast<size_t>(frame) * N, N, sx, sy, sz, sr);

  const int p = blockIdx.x * RAYS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (p >= P) return;  // whole warps only: no block-level sync below
  const size_t ray = static_cast<size_t>(frame) * P + p;
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
    const T c = pw::warp_clearance(v0 * frac, v1 * frac, v2 * frac, sx, sy,
                                   sz, sr, N, lane);
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
                       int32_t* pos, T* cmin, int B, int P, int N,
                       int max_steps, void* stream) {
  if (B <= 0 || P <= 0) return;
  const size_t smem = pw::sweep_smem_bytes<T>(N);
  pw::allow_smem(path_sweep_kernel<T>, smem);
  const dim3 grid((P + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK, B);
  path_sweep_kernel<T><<<grid, PATH_SWEEP_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      vectors, chunks, coords, vdw, ok, pos, cmin, P, N, max_steps);
}

}  // namespace

void pw::path_sweep(const float* vectors, const int32_t* chunks,
                    const float* coords, const float* vdw, uint8_t* ok,
                    int32_t* pos, float* cmin, int B, int P, int N,
                    int max_steps, void* stream) {
  launch_path_sweep(vectors, chunks, coords, vdw, ok, pos, cmin, B, P, N,
                    max_steps, stream);
}

void pw::path_sweep(const double* vectors, const int32_t* chunks,
                    const double* coords, const double* vdw, uint8_t* ok,
                    int32_t* pos, double* cmin, int B, int P, int N,
                    int max_steps, void* stream) {
  launch_path_sweep(vectors, chunks, coords, vdw, ok, pos, cmin, B, P, N,
                    max_steps, stream);
}
