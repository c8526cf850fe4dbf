// fine_path: the 0.1 A re-sampling of the W window-slot rays of each
// frame.  Per ray, the clearance walk of ray_cull.cuh (probe points
// q = (l / chunks) * v for l = 0 .. min(chunks + 1, max_steps) - 1, reduced
// to ok, the first step of minimum clearance and that minimum): the
// function path_sweep computes, at the fine increment, bit for bit the
// plain version's (ray_kernels.fine_path_plain) in both dtypes.
//
// Replaces pywindow_tpu/ops/pallas_kernels.py::_fine_path_flat (the
// frames-on-lanes kernel behind fine_path_sweep) and, for one molecule,
// the step-chunked scan it falls back to there (_fine_scan_flat).
// Reference behaviour: utilities.py:1100-1129 at increment2.
//
// What bounds it: a window ray walks ~10x more steps than a coarse one
// (L2 ~ 100-120 for a cage), each over every atom, but one to three atoms
// decide it, as on the coarse rays; and half of a cage's W = 8 slots hold
// no window (find_windows points them at a fallback ray and never reads
// them).  So the work that has to be done is the cull pass over the atoms
// of each live slot (a projection and a square root an atom) plus the
// kept atoms at each step, and on one molecule the kernel is bound by
// latency.  Design: one block a frame (a grid of (ceil(W / 8), B) blocks
// of 8 warps), one warp a slot:
// - a slot whose `active` flag is 0 writes the placeholders (ok 0, step
//   0, clearance 1e30) and does no work; a block with no live slot does
//   not stage its atoms (active may be null: every slot is live);
// - the frame's atoms are staged once as 16-byte records, with each
//   warp's bounds and keep mask beside them (pw::walk_smem_bytes,
//   ray_kernels.path_sweep_smem_bytes: the path_sweep layout);
// - each live warp runs pw::walk_culled: the exact per-ray cull, then
//   lanes over steps on the kept atoms and one warp first-min reduction.
#include <cuda_runtime.h>

#include "kernels.h"
#include "ray_cull.cuh"
#include "sweep.cuh"

namespace {

constexpr int FINE_WARPS = 8;
constexpr int FINE_THREADS = 32 * FINE_WARPS;

template <typename T>
__global__ void fine_path_kernel(const T* __restrict__ vectors,
                                 const int32_t* __restrict__ chunks,
                                 const T* __restrict__ coords,
                                 const T* __restrict__ vdw,
                                 const uint8_t* __restrict__ active,
                                 uint8_t* __restrict__ ok_out,
                                 int32_t* __restrict__ pos_out,
                                 T* __restrict__ cmin_out, int W, int N,
                                 int max_steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* atoms = reinterpret_cast<pw::Rec<T>*>(smem_raw);
  const int frame = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = blockIdx.x * FINE_WARPS + warp;
  const size_t ray = static_cast<size_t>(frame) * W + slot;
  const bool live = slot < W && (active == nullptr || active[ray] != 0);
  const bool staged = __syncthreads_or(live);
  if (staged) {
    pw::stage_records(coords + static_cast<size_t>(frame) * N * 3,
                      vdw + static_cast<size_t>(frame) * N, N, atoms);
    __syncthreads();  // the last block-level sync: warps go their own way
  }
  if (slot >= W) return;
  if (!live) {
    if (lane == 0) {
      ok_out[ray] = 0;
      pos_out[ray] = 0;
      cmin_out[ray] = T(pw::kBig);
    }
    return;
  }

  unsigned* keep;
  T* lbs;
  pw::walk_slices(atoms, N, FINE_WARPS, warp, keep, lbs);
  const pw::Segment<T> seg(vectors[3 * ray], vectors[3 * ray + 1],
                           vectors[3 * ray + 2]);
  const int ch = chunks[ray];
  bool ok;
  int pos;
  T cmin;
  pw::walk_culled(atoms, N, lbs, keep, seg, ch, min(ch + 1, max_steps), lane,
                  ok, pos, cmin);
  if (lane == 0) {
    ok_out[ray] = ok ? 1 : 0;
    pos_out[ray] = pos;
    cmin_out[ray] = cmin;
  }
}

template <typename T>
void launch_fine_path(const T* vectors, const int32_t* chunks,
                      const T* coords, const T* vdw, const uint8_t* active,
                      uint8_t* ok, int32_t* pos, T* cmin, int B, int W, int N,
                      int max_steps, void* stream) {
  if (B <= 0 || W <= 0) return;
  const size_t smem = pw::walk_smem_bytes<T>(N, FINE_WARPS);
  pw::allow_smem(fine_path_kernel<T>, smem);
  const dim3 grid((W + FINE_WARPS - 1) / FINE_WARPS, B);
  fine_path_kernel<T><<<grid, FINE_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      vectors, chunks, coords, vdw, active, ok, pos, cmin, W, N, max_steps);
}

}  // namespace

void pw::fine_path(const float* vectors, const int32_t* chunks,
                   const float* coords, const float* vdw,
                   const uint8_t* active, uint8_t* ok, int32_t* pos,
                   float* cmin, int B, int W, int N, int max_steps,
                   void* stream) {
  launch_fine_path(vectors, chunks, coords, vdw, active, ok, pos, cmin, B, W,
                   N, max_steps, stream);
}

void pw::fine_path(const double* vectors, const int32_t* chunks,
                   const double* coords, const double* vdw,
                   const uint8_t* active, uint8_t* ok, int32_t* pos,
                   double* cmin, int B, int W, int N, int max_steps,
                   void* stream) {
  launch_fine_path(vectors, chunks, coords, vdw, active, ok, pos, cmin, B, W,
                   N, max_steps, stream);
}
