// fine_path: the 0.1 A re-sampling of the W window-slot rays of each
// frame.  Per ray, clearance at q = (l / chunks) * v for
// l = 0 .. min(chunks + 1, max_steps) - 1, reduced to (ok, first-argmin
// step, min clearance) exactly as path_sweep.cu does.
//
// Replaces pywindow_tpu/ops/pallas_kernels.py::_fine_path_flat (the
// frames-on-lanes kernel behind fine_path_sweep) and, for one molecule,
// the step-chunked scan it falls back to there (_fine_scan_flat).
// Reference behaviour: utilities.py:1100-1129 at increment2.
//
// What bounds it: a ray walks ~10x more steps than a coarse one (L2 ~
// 100-120 for a cage) while a frame has only W = 8 such rays, so one
// warp per ray (path_sweep's shape) leaves a single molecule's walk
// latency-bound on 8 warps.  Design: one block per ray; the frame's atoms
// are staged in shared memory; the block's 8 warps take interleaved
// steps (warp w walks l = w, w + 8, ...), each warp keeping its own
// (ok, first-argmin, min) in registers with the atoms strided over its
// lanes; the warps' partials are combined in shared memory by
// (min clearance, then smallest step), which is the sequential
// first-minimum rule.  Difference-form distances, as the plain version.
#include <cuda_runtime.h>

#include "kernels.h"
#include "sweep.cuh"

namespace {

constexpr int FINE_WARPS = 8;
constexpr int FINE_THREADS = 32 * FINE_WARPS;

template <typename T>
__global__ void fine_path_kernel(const T* __restrict__ vectors,
                                 const int32_t* __restrict__ chunks,
                                 const T* __restrict__ coords,
                                 const T* __restrict__ vdw,
                                 uint8_t* __restrict__ ok_out,
                                 int32_t* __restrict__ pos_out,
                                 T* __restrict__ cmin_out, int W, int N,
                                 int max_steps) {
  extern __shared__ unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + N;
  T* sz = sy + N;
  T* sr = sz + N;
  __shared__ T part_c[FINE_WARPS];
  __shared__ int part_pos[FINE_WARPS];
  __shared__ int part_ok[FINE_WARPS];

  const int ray = blockIdx.x;  // frame * W + slot
  const int frame = ray / W;
  pw::stage_atoms(coords + static_cast<size_t>(frame) * N * 3,
                  vdw + static_cast<size_t>(frame) * N, N, sx, sy, sz, sr);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T v0 = vectors[3 * static_cast<size_t>(ray)];
  const T v1 = vectors[3 * static_cast<size_t>(ray) + 1];
  const T v2 = vectors[3 * static_cast<size_t>(ray) + 2];
  const int ch = chunks[ray];
  const T chf = T(ch);
  const int n_steps = min(ch + 1, max_steps);

  bool ok = true;
  int pos = 0;
  T cmin = T(pw::kBig);
  for (int l = warp; l < n_steps; l += FINE_WARPS) {
    const T frac = T(l) / chf;
    const T c = pw::warp_clearance(v0 * frac, v1 * frac, v2 * frac, sx, sy,
                                   sz, sr, N, lane);
    ok = ok && (c > T(0));
    if (c < cmin) {  // steps ascend within a warp: first minimum
      cmin = c;
      pos = l;
    }
  }
  if (lane == 0) {
    part_c[warp] = cmin;
    part_pos[warp] = pos;
    part_ok[warp] = ok ? 1 : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool all_ok = true;
    T best = T(pw::kBig);
    int best_pos = 0;
    for (int w = 0; w < FINE_WARPS; ++w) {
      all_ok = all_ok && part_ok[w] != 0;
      const T c = part_c[w];
      // a warp with no step keeps (1e30, 0) and never wins over a real
      // step: every real clearance is below 1e30
      if (c < best || (c == best && part_pos[w] < best_pos)) {
        best = c;
        best_pos = part_pos[w];
      }
    }
    ok_out[ray] = all_ok ? 1 : 0;
    pos_out[ray] = best_pos;
    cmin_out[ray] = best;
  }
}

template <typename T>
void launch_fine_path(const T* vectors, const int32_t* chunks,
                      const T* coords, const T* vdw, uint8_t* ok,
                      int32_t* pos, T* cmin, int B, int W, int N,
                      int max_steps, void* stream) {
  if (B <= 0 || W <= 0) return;
  const size_t smem = pw::sweep_smem_bytes<T>(N);
  pw::allow_smem(fine_path_kernel<T>, smem);
  fine_path_kernel<T><<<B * W, FINE_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      vectors, chunks, coords, vdw, ok, pos, cmin, W, N, max_steps);
}

}  // namespace

void pw::fine_path(const float* vectors, const int32_t* chunks,
                   const float* coords, const float* vdw, uint8_t* ok,
                   int32_t* pos, float* cmin, int B, int W, int N,
                   int max_steps, void* stream) {
  launch_fine_path(vectors, chunks, coords, vdw, ok, pos, cmin, B, W, N,
                   max_steps, stream);
}

void pw::fine_path(const double* vectors, const int32_t* chunks,
                   const double* coords, const double* vdw, uint8_t* ok,
                   int32_t* pos, double* cmin, int B, int W, int N,
                   int max_steps, void* stream) {
  launch_fine_path(vectors, chunks, coords, vdw, ok, pos, cmin, B, W, N,
                   max_steps, stream);
}
