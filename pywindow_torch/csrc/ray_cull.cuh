// Device code shared by the three culled ray kernels, path_sweep.cu (the
// coarse walk of the open rays), fine_path.cu (the 0.1 A walk of the
// window-slot rays) and ray_exit.cu: one 16-byte-aligned record per atom
// (x, y, z, vdW) in shared memory, the unit roundoff their cull margins
// scale with, the warp's first-minimum reduction, and the two walks' exact
// per-ray cull (Segment, walk_culled).
//
// The walks.  Per ray, clearance min_i(|q - x_i| - vdw_i) at the probe
// points q = (l / chunks) * v for l = 0 .. min(chunks + 1, max_steps) - 1,
// reduced to
//   ok   = every probe clearance > 0,
//   pos  = the first step of minimum clearance (strict <),
//   cmin = that minimum clearance.
// Every probe clearance that decides an output is computed in the plain
// versions' difference form and order (ray_kernels.path_sweep_plain;
// -fmad=false), so ok, pos and cmin equal the plain version's bit for bit
// in both dtypes.  One warp walks one ray (walk_culled):
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
//    memory (a ballot per 32 stored bounds).  A dropped atom's clearance
//    exceeds max(U, 0) >= cmin at every step: at a step where it would be
//    the minimum, that minimum and the kept atoms' minimum both exceed
//    max(U, 0), so the step is > 0 either way (ok unchanged) and can be
//    neither the minimum nor tie it (cmin and pos unchanged); every other
//    step's minimum is the same atom's value.  Atom i* is always kept
//    (LB_i* <= U).  Any count up to N works.
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
// - Segment projects with t = clamp(fl(w * fl(1 / vv)), 0, 1), w = x.v:
//   any t in [0, 1] is a segment point, and |t - t*| |v| <= 3u|x| + 6u|v|,
//   so the computed |x - t v| is <= d + 8.5u|x| + 8u|v| after the rounding
//   of x - t v and of the norm;
// - so LB = fl(fl(|x - t v| - r) - M) with M = 64u(|x|_1 + r + |v|_1)
//   (the 1-norms bound the 2-norms) is <= every computed probe clearance:
//   M is ~4x the 15u|x| + 15u|v| + 2u r the two bullets need.  Where vv is
//   0 or at most 2^-100 Segment takes t = 0 and adds |v|_1 to M (the probes
//   are then within |v| of the origin).  NaN bounds keep their atom.
// In float32 on REYMAL (|x| + |v| <= ~40 A) M is ~2e-4 A; atoms are culled
// by angstroms, so the margin costs nothing.
#pragma once

#include <cuda_runtime.h>

#include <climits>

#include "kernels.h"

namespace pw {

constexpr unsigned kFullMask = 0xffffffffu;

// the walks' cull margin in unit roundoffs (ray_kernels.SWEEP_CULL_ULPS),
// and the |v|^2 at or below which a ray is treated as the origin, 2^-100
// (ray_kernels.SWEEP_TINY_VV)
constexpr float kSweepCullUlps = 64.0f;
constexpr float kSweepTinyVv = 7.8886090522101181e-31f;

// One atom as the kernels read it from shared memory: a float4 for
// float (one 16-byte load), two 16-byte loads for double.
template <typename T>
struct __align__(16) Rec {
  T x, y, z, r;
};

// Unit roundoff of T (half an ulp of 1): 2^-24 for float, 2^-53 for double.
template <typename T>
__device__ __forceinline__ T unit_roundoff();
template <>
__device__ __forceinline__ float unit_roundoff<float>() {
  return 5.9604644775390625e-8f;
}
template <>
__device__ __forceinline__ double unit_roundoff<double>() {
  return 1.1102230246251565e-16;
}

// Copy n atoms, coords (n,3) and vdw (n,), into records; every thread
// of the block takes part.  The caller synchronises.
template <typename T>
__device__ __forceinline__ void stage_records(const T* __restrict__ coords,
                                              const T* __restrict__ vdw,
                                              int n, Rec<T>* out) {
  for (int a = threadIdx.x; a < n; a += blockDim.x) {
    out[a] = Rec<T>{coords[3 * a], coords[3 * a + 1], coords[3 * a + 2],
                    vdw[a]};
  }
}

// The warp's least (value, index) pair, the lower index on equal values:
// every lane returns it.  Minima are exact, so the result does not depend
// on the order of the shuffles.
template <typename T>
__device__ __forceinline__ void warp_first_min(T& value, int& index) {
  for (int off = 16; off > 0; off >>= 1) {
    const T v = __shfl_xor_sync(kFullMask, value, off);
    const int i = __shfl_xor_sync(kFullMask, index, off);
    if (v < value || (v == value && i < index)) {
      value = v;
      index = i;
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = min(v, __shfl_xor_sync(kFullMask, v, off));
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = max(v, __shfl_xor_sync(kFullMask, v, off));
  }
  return v;
}

__device__ __forceinline__ int nearest_int(float x) { return __float2int_rn(x); }
__device__ __forceinline__ int nearest_int(double x) { return __double2int_rn(x); }

// atom a's clearance at q: the plain version's operations in its order
template <typename T>
__device__ __forceinline__ T clearance(T q0, T q1, T q2, const Rec<T>& a) {
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
    const bool proj = vv > T(kSweepTinyVv);
    inv_vv = proj ? T(1) / vv : T(0);
    margin = T(kSweepCullUlps) * unit_roundoff<T>();
    slack = margin * vl1 + (proj ? T(0) : vl1);
  }

  // the atom's projection on the segment, t in [0, 1]
  __device__ __forceinline__ T project(const Rec<T>& a) const {
    const T w = a.x * v0 + a.y * v1 + a.z * v2;
    return min(max(w * inv_vv, T(0)), T(1));
  }

  // LB: at most the atom's computed clearance at every probe (header)
  __device__ __forceinline__ T bound(const Rec<T>& a) const {
    const T t = project(a);
    const T p0 = a.x - t * v0;
    const T p1 = a.y - t * v1;
    const T p2 = a.z - t * v2;
    const T dist = sqrt(p0 * p0 + p1 * p1 + p2 * p2);
    const T scale = ((fabs(a.x) + fabs(a.y)) + fabs(a.z)) + a.r;
    return (dist - a.r) - (margin * scale + slack);
  }
};

// Shared memory of a walking block of `warps` warps over N atoms
// (ray_kernels.path_sweep_smem_bytes): the atoms' records, then each
// warp's keep mask (ceil(N/32) words), then each warp's N bounds.
template <typename T>
inline size_t walk_smem_bytes(int N, int warps) {
  const size_t words = (N + 31) / 32;
  return N * sizeof(Rec<T>) + warps * words * sizeof(unsigned) +
         static_cast<size_t>(warps) * N * sizeof(T);
}

// The calling warp's slices of that layout, from the block's records.
template <typename T>
__device__ __forceinline__ void walk_slices(Rec<T>* atoms, int N, int warps,
                                            int warp, unsigned*& keep,
                                            T*& lbs) {
  const int words = (N + 31) / 32;
  unsigned* masks = reinterpret_cast<unsigned*>(atoms + N);
  keep = masks + warp * words;
  lbs = reinterpret_cast<T*>(masks + warps * words) + warp * N;
}

// Steps 1-4 of the header for one ray by the calling warp: the N atoms'
// records, the warp's slices lbs (N bounds) and keep (ceil(N/32) words),
// chunks ch and n_steps = min(ch + 1, max_steps) steps.  Every lane
// returns (ok, pos, cmin); pos is 0 when no step is valid.
template <typename T>
__device__ __forceinline__ void walk_culled(const Rec<T>* atoms, int N,
                                            T* lbs, unsigned* keep,
                                            const Segment<T>& seg, int ch,
                                            int n_steps, int lane, bool& ok,
                                            int& pos, T& cmin) {
  const T inf = T(INFINITY);
  const T chf = T(ch);
  const int words = (N + 31) / 32;

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
  warp_first_min(best, besti);

  // 2. U: atom i*'s clearance at the valid step nearest its projection
  T u = inf;
  if (besti < N && n_steps > 0) {
    const Rec<T> b = atoms[besti];
    const int l = min(n_steps - 1, max(0, nearest_int(seg.project(b) * chf)));
    const T frac = T(l) / chf;
    u = max(clearance(seg.v0 * frac, seg.v1 * frac, seg.v2 * frac, b), T(0));
  }

  // 3. the kept atoms, one bit each
  for (int base = 0; base < N; base += 32) {
    const int a = base + lane;
    const bool kept = a < N && !(lbs[a] > u);
    const unsigned m = __ballot_sync(kFullMask, kept);
    if (lane == 0) keep[base / 32] = m;
  }
  __syncwarp();

  // 4. lanes over steps, each over the kept atoms
  ok = true;
  pos = INT_MAX;
  cmin = T(kBig);
  for (int l = lane; l - lane < n_steps; l += 32) {
    if (l < n_steps) {
      const T frac = T(l) / chf;
      const T q0 = seg.v0 * frac, q1 = seg.v1 * frac, q2 = seg.v2 * frac;
      T c = T(kBig);
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
  ok = __all_sync(kFullMask, ok);
  warp_first_min(cmin, pos);
  if (pos == INT_MAX) pos = 0;
  __syncwarp();  // the warp's next ray reuses its bounds and mask
}

}  // namespace pw
