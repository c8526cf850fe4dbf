// path_sweep: the coarse ray walk.  Per ray of each frame, the clearance
// walk of ray_cull.cuh (probe points q = (l / chunks) * v for
// l = 0 .. min(chunks + 1, max_steps) - 1, reduced to ok, the first step
// of minimum clearance and that minimum), bit for bit the plain version's
// (ray_kernels.path_sweep_plain) in both dtypes.
//
// Replaces pywindow_tpu/ops/pallas_kernels.py::path_sweep_pallas and its
// layout variant _path_sweep_pallas_wide.  Reference behaviour:
// utilities.py:1100-1129.  Padded atoms follow the MolArrays convention
// (coordinates ~1e6, vdW 0) and cannot win the minimum, so no mask.
//
// What bounds it: a ray's work is steps x atoms clearances, but almost
// none of them can change the outputs: on the main path one to three
// atoms of 168 (CC3) or 468 (REYMAL) decide every ray.  So the kernel
// culls exactly (ray_cull.cuh derives the bound and the rule), then
// evaluates only the kept atoms; what is left is the cull pass over the
// atoms (a divide-free projection and a square root each) and latency (a
// few hundred rays of one molecule; a batch of frames fills the card).
// Design: 8 warps a block, each walking rays_per_warp rays one after
// another (ray_kernels.sweep_rays_per_warp: the fewest of 1, 2, 4 that fit
// one wave of blocks, where a warp's rays are its latency; 4 on a batch,
// where a block's staging and origin clearance then serve 32 rays);
// the frame's atoms are staged once per block as 16-byte records (so a
// frame of N atoms needs 12 N sizeof(T) bytes of shared memory with the
// bounds; ray_kernels.path_sweep_smem_bytes, up to ~4,800 atoms in
// float32):
//
// 0. Zero rays (the empty slots of the open-ray compaction, windows.py,
//    a third of the sweep chunk's rays) probe only the origin at every
//    step: the block computes that clearance c0 once, over all atoms, and
//    each zero ray writes (c0 > 0, step 0, c0), the plain version's
//    values for equal probes (chunks >= 1, at least one step).
// 1-4. Every other ray: pw::walk_culled, one warp (ray_cull.cuh).
#include <cuda_runtime.h>

#include "kernels.h"
#include "ray_cull.cuh"
#include "sweep.cuh"

namespace {

constexpr int PATH_SWEEP_THREADS = 256;  // 8 warps per block
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* atoms = reinterpret_cast<pw::Rec<T>*>(smem_raw);
  const int frame = blockIdx.y;
  pw::stage_records(coords + static_cast<size_t>(frame) * N * 3,
                    vdw + static_cast<size_t>(frame) * N, N, atoms);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned* keep;
  T* lbs;
  pw::walk_slices(atoms, N, RAYS_PER_BLOCK, warp, keep, lbs);

  // 0. the origin's clearance, every probe of a zero ray
  __shared__ T origin_c;
  if (warp == 0) {
    T c = T(pw::kBig);
    for (int a = lane; a < N; a += 32) {
      c = min(c, pw::clearance(T(0), T(0), T(0), atoms[a]));
    }
    c = pw::warp_min(c);
    if (lane == 0) origin_c = c;
  }
  __syncthreads();  // the last block-level sync: warps go their own way

  for (int p = blockIdx.x * RAYS_PER_BLOCK + warp; p < P;
       p += gridDim.x * RAYS_PER_BLOCK) {
    const size_t ray = static_cast<size_t>(frame) * P + p;
    const pw::Segment<T> seg(vectors[3 * ray], vectors[3 * ray + 1],
                             vectors[3 * ray + 2]);
    const int ch = chunks[ray];
    const int n_steps = min(ch + 1, max_steps);
    if (ch >= 1 && n_steps >= 1 && seg.v0 == T(0) && seg.v1 == T(0) &&
        seg.v2 == T(0)) {
      if (lane == 0) {
        ok_out[ray] = origin_c > T(0) ? 1 : 0;
        pos_out[ray] = 0;
        cmin_out[ray] = origin_c;
      }
      continue;
    }
    bool ok;
    int pos;
    T cmin;
    pw::walk_culled(atoms, N, lbs, keep, seg, ch, n_steps, lane, ok, pos,
                    cmin);
    if (lane == 0) {
      ok_out[ray] = ok ? 1 : 0;
      pos_out[ray] = pos;
      cmin_out[ray] = cmin;
    }
  }
}

template <typename T>
void launch_path_sweep(const T* vectors, const int32_t* chunks,
                       const T* coords, const T* vdw, uint8_t* ok,
                       int32_t* pos, T* cmin, int B, int P, int N,
                       int max_steps, int rays_per_warp, void* stream) {
  if (B <= 0 || P <= 0) return;
  const size_t smem = pw::walk_smem_bytes<T>(N, RAYS_PER_BLOCK);
  pw::allow_smem(path_sweep_kernel<T>, smem);
  const int per_block = RAYS_PER_BLOCK * (rays_per_warp > 1 ? rays_per_warp : 1);
  const dim3 grid((P + per_block - 1) / per_block, B);
  path_sweep_kernel<T><<<grid, PATH_SWEEP_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      vectors, chunks, coords, vdw, ok, pos, cmin, P, N, max_steps);
}

}  // namespace

void pw::path_sweep(const float* vectors, const int32_t* chunks,
                    const float* coords, const float* vdw, uint8_t* ok,
                    int32_t* pos, float* cmin, int B, int P, int N,
                    int max_steps, int rays_per_warp, void* stream) {
  launch_path_sweep(vectors, chunks, coords, vdw, ok, pos, cmin, B, P, N,
                    max_steps, rays_per_warp, stream);
}

void pw::path_sweep(const double* vectors, const int32_t* chunks,
                    const double* coords, const double* vdw, uint8_t* ok,
                    int32_t* pos, double* cmin, int B, int P, int N,
                    int max_steps, int rays_per_warp, void* stream) {
  launch_path_sweep(vectors, chunks, coords, vdw, ok, pos, cmin, B, P, N,
                    max_steps, rays_per_warp, stream);
}
