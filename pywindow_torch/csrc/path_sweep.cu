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
// Every probe clearance that decides an output is computed in the plain
// version's difference form and order (ray_kernels.path_sweep_plain;
// -fmad=false), so ok, pos and cmin equal the plain version's bit for bit
// in both dtypes.
//
// What bounds it: a ray's work is steps x atoms clearances, but almost
// none of them can change the outputs: on the main path one to three
// atoms of 168 (CC3) or 468 (REYMAL) decide every ray.  So the kernel
// culls exactly, then evaluates only the kept atoms; what is left is the
// cull pass over the atoms (a divide-free projection and a square root
// each) and latency (a few hundred rays of one molecule; a batch of
// frames fills the card).  Design: 8 warps a block, each walking
// rays_per_warp rays one after another (ray_kernels.sweep_rays_per_warp:
// the fewest of 1, 2, 4 that fit one wave of blocks, where a warp's rays
// are its latency; 4 on a batch, where a block's staging and origin
// clearance then serve 32 rays);
// the frame's atoms are staged once per block as 16-byte records (so a
// frame of N atoms needs 12 N sizeof(T) bytes of shared memory with the
// bounds; ray_kernels.path_sweep_smem_bytes, up to ~4,800 atoms in
// float32):
//
// 0. Zero rays (the empty slots of the open-ray compaction, windows.py,
//    a third of the sweep chunk's rays) probe only the origin at every
//    step: the block computes that clearance c0 once, over all atoms, and
//    each zero ray writes (c0 > 0, step 0, c0), the plain version's
//    values for equal probes (chunks >= 1, at least one step).  Then, per
//    ray:
// 1. LB pass, lanes over atoms: LB_i, a lower bound on atom i's computed
//    clearance at every probe of the ray (below), kept in the warp's
//    shared slice (holding them in registers spilled occupancy away), and
//    the warp's first argmin i*.
// 2. U: atom i*'s computed clearance, with the per-probe arithmetic of
//    step 4, at the valid step nearest its projection on the ray
//    (round(t* chunks) clamped to the steps).  The clearance at any valid
//    probe is >= cmin, so U needs no margin (a minimum over the steps
//    would be tighter by little and cost a warp reduction).
// 3. Keep atom i iff !(LB_i > max(U, 0)), a bit mask per warp in shared
//    memory (a ballot per 32 stored bounds).  A dropped atom's clearance exceeds max(U, 0) >= cmin at every
//    step: at a step where it would be the minimum, that minimum and the
//    kept atoms' minimum both exceed max(U, 0), so the step is > 0 either
//    way (ok unchanged) and can be neither the minimum nor tie it (cmin and
//    pos unchanged); every other step's minimum is the same atom's value.
//    Atom i* is always kept (LB_i* <= U).  Any count up to N works.
// 4. Exact evaluation, lanes over steps (wrapping past 32): each lane's
//    clearance over the kept atoms at its steps, its running
//    (ok, first step, min), then one warp reduction: an AND for ok and a
//    (value, step) first minimum.
//
// The bound.  With u the unit roundoff (2^-24 float, 2^-53 double), the
// ray v, the atom x, radius r, and s the exact point of the segment
// [0, v] nearest x (distance d):
// - a probe q = fl(v * fl(l / chunks)) lies within 2.01u|v| of the
//   segment, and its computed clearance is within 4.5u|q - x| + u r of
//   |q - x| - r, with |q - x| <= |x| + |v|(1 + 2u); so every computed probe
//   clearance is >= d - r - 6.6u|v| - 4.5u|x| - u r;
// - the kernel projects with t = clamp(fl(w * fl(1 / vv)), 0, 1), w = x.v:
//   any t in [0, 1] is a segment point, and |t - t*| |v| <= 3u|x| + 6u|v|,
//   so the computed |x - t v| is <= d + 8.5u|x| + 8u|v| after the rounding
//   of x - t v and of the norm;
// - so LB = fl(fl(|x - t v| - r) - M) with M = 64u(|x|_1 + r + |v|_1)
//   (the 1-norms bound the 2-norms) is <= every computed probe clearance:
//   M is ~4x the 15u|x| + 15u|v| + 2u r the two bullets need.  Where vv is
//   0 or at most 2^-100 the kernel takes t = 0 and adds |v|_1 to M (the probes
//   are then within |v| of the origin).  NaN bounds keep their atom.
// In float32 on REYMAL (|x| + |v| <= ~40 A) M is ~2e-4 A; atoms are culled
// by angstroms, so the margin costs nothing.
#include <cuda_runtime.h>

#include <climits>

#include "kernels.h"
#include "ray_cull.cuh"
#include "sweep.cuh"

namespace {

constexpr int PATH_SWEEP_THREADS = 256;  // 8 warps per block
constexpr int RAYS_PER_BLOCK = PATH_SWEEP_THREADS / 32;
constexpr float CULL_ULPS = 64.0f;  // ray_kernels.SWEEP_CULL_ULPS
constexpr float TINY_VV = 7.8886090522101181e-31f;  // 2^-100, ray_kernels.SWEEP_TINY_VV

__device__ __forceinline__ int nearest_int(float x) { return __float2int_rn(x); }
__device__ __forceinline__ int nearest_int(double x) { return __double2int_rn(x); }

// atom a's clearance at q: the plain version's operations in its order
template <typename T>
__device__ __forceinline__ T clearance(T q0, T q1, T q2, const pw::Rec<T>& a) {
  const T d0 = q0 - a.x;
  const T d1 = q1 - a.y;
  const T d2 = q2 - a.z;
  return sqrt(d0 * d0 + d1 * d1 + d2 * d2) - a.r;
}

// The ray's segment [0, v] and the atom-independent part of the margin.
template <typename T>
struct Segment {
  T v0, v1, v2, inv_vv, margin, slack;

  __device__ Segment(T a, T b, T c) : v0(a), v1(b), v2(c) {
    const T vv = v0 * v0 + v1 * v1 + v2 * v2;
    const T vl1 = (fabs(v0) + fabs(v1)) + fabs(v2);
    const bool proj = vv > T(TINY_VV);
    inv_vv = proj ? T(1) / vv : T(0);
    margin = T(CULL_ULPS) * pw::unit_roundoff<T>();
    slack = margin * vl1 + (proj ? T(0) : vl1);
  }

  // the atom's projection on the segment, t in [0, 1]
  __device__ __forceinline__ T project(const pw::Rec<T>& a) const {
    const T w = a.x * v0 + a.y * v1 + a.z * v2;
    return min(max(w * inv_vv, T(0)), T(1));
  }

  // LB: at most the atom's computed clearance at every probe (header)
  __device__ __forceinline__ T bound(const pw::Rec<T>& a) const {
    const T t = project(a);
    const T p0 = a.x - t * v0;
    const T p1 = a.y - t * v1;
    const T p2 = a.z - t * v2;
    const T dist = sqrt(p0 * p0 + p1 * p1 + p2 * p2);
    const T scale = ((fabs(a.x) + fabs(a.y)) + fabs(a.z)) + a.r;
    return (dist - a.r) - (margin * scale + slack);
  }
};

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
  const int words = (N + 31) / 32;
  const int frame = blockIdx.y;
  pw::stage_records(coords + static_cast<size_t>(frame) * N * 3,
                    vdw + static_cast<size_t>(frame) * N, N, atoms);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned* keep = reinterpret_cast<unsigned*>(atoms + N) + warp * words;
  T* lbs = reinterpret_cast<T*>(reinterpret_cast<unsigned*>(atoms + N) +
                                RAYS_PER_BLOCK * words) +
           warp * N;
  const T inf = T(INFINITY);

  // 0. the origin's clearance, every probe of a zero ray
  __shared__ T origin_c;
  if (warp == 0) {
    T c = T(pw::kBig);
    for (int a = lane; a < N; a += 32) {
      c = min(c, clearance(T(0), T(0), T(0), atoms[a]));
    }
    c = pw::warp_min(c);
    if (lane == 0) origin_c = c;
  }
  __syncthreads();  // the last block-level sync: warps go their own way

  for (int p = blockIdx.x * RAYS_PER_BLOCK + warp; p < P;
       p += gridDim.x * RAYS_PER_BLOCK) {
    const size_t ray = static_cast<size_t>(frame) * P + p;
    const Segment<T> seg(vectors[3 * ray], vectors[3 * ray + 1],
                         vectors[3 * ray + 2]);
    const int ch = chunks[ray];
    const T chf = T(ch);
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

    // 1. the bounds and the atom of least bound
    T best = inf;
    int besti = INT_MAX;
    for (int a = lane; a < N; a += 32) {
      const T lb = seg.bound(atoms[a]);
      lbs[a] = lb;
      if (lb < best) {
        best = lb;
        besti = a;
      }
    }
    pw::warp_first_min(best, besti);

    // 2. U: atom i*'s clearance at the valid step nearest its projection
    T bound = inf;
    if (besti < N && n_steps > 0) {
      const pw::Rec<T> b = atoms[besti];
      const int l =
          min(n_steps - 1, max(0, nearest_int(seg.project(b) * chf)));
      const T frac = T(l) / chf;
      bound = max(clearance(seg.v0 * frac, seg.v1 * frac, seg.v2 * frac, b),
                  T(0));
    }

    // 3. the kept atoms, one bit each
    for (int base = 0; base < N; base += 32) {
      const int a = base + lane;
      const bool kept = a < N && !(lbs[a] > bound);
      const unsigned m = __ballot_sync(pw::kFullMask, kept);
      if (lane == 0) keep[base / 32] = m;
    }
    __syncwarp();

    // 4. lanes over steps, each over the kept atoms
    bool ok = true;
    int pos = INT_MAX;
    T cmin = T(pw::kBig);
    for (int l = lane; l - lane < n_steps; l += 32) {
      if (l < n_steps) {
        const T frac = T(l) / chf;
        const T q0 = seg.v0 * frac, q1 = seg.v1 * frac, q2 = seg.v2 * frac;
        T c = T(pw::kBig);
        for (int w = 0; w < words; ++w) {
          for (unsigned m = keep[w]; m; m &= m - 1) {
            c = min(c, clearance(q0, q1, q2, atoms[32 * w + __ffs(m) - 1]));
          }
        }
        ok = ok && (c > T(0));
        if (c < cmin) {
          cmin = c;
          pos = l;
        }
      }
    }
    ok = __all_sync(pw::kFullMask, ok);
    pw::warp_first_min(cmin, pos);
    if (lane == 0) {
      ok_out[ray] = ok ? 1 : 0;
      pos_out[ray] = pos == INT_MAX ? 0 : pos;
      cmin_out[ray] = cmin;
    }
    __syncwarp();  // the next ray reuses this warp's bounds and mask
  }
}

template <typename T>
void launch_path_sweep(const T* vectors, const int32_t* chunks,
                       const T* coords, const T* vdw, uint8_t* ok,
                       int32_t* pos, T* cmin, int B, int P, int N,
                       int max_steps, int rays_per_warp, void* stream) {
  if (B <= 0 || P <= 0) return;
  // ray_kernels.path_sweep_smem_bytes: records, bit masks, bounds
  const size_t words = (N + 31) / 32;
  const size_t smem = N * sizeof(pw::Rec<T>) +
                      RAYS_PER_BLOCK * words * sizeof(unsigned) +
                      static_cast<size_t>(RAYS_PER_BLOCK) * N * sizeof(T);
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
