// ray_exit: per ray of each frame, does any vdW sphere cross it in front
// of the origin, and the farthest front exit distance |p1| (-1e30 if
// none).
//
// Replaces pywindow_tpu/ops/pallas_kernels.py::ray_exit_pallas and its
// layout variant _ray_exit_pallas_wide (one kernel, no atom limit).
// Reference behaviour: utilities.py:1132-1161 (vector_preanalysis) and
// :1556-1583 (vector_analysis_reversed).
//
// Arithmetic of a (ray, atom) pair, as in the TPU kernel: the
// perpendicular distance in the stable form rel - t_ca*u (the Gram form
// |rel|^2 - t_ca^2 cancels near tangency); the front test t_hc > 0 and
// t_ca + o.u > 0 (the algebraic form of |p0|^2 < |p1|^2); |p1|^2 in
// expanded form, with the sqrt after the max (sqrt is monotone).
// WANT_EXIT=false is the slim pre-analysis form with no sqrt at all.  A
// pair contributes only when its computed under = r^2 - |perp|^2 is > 0.
//
// What bounds it: all pairs, ~25 single instructions each (-fmad=false),
// run at about the card's FP32 instruction rate already; only less work
// helps, and only ~5 atoms a ray have under > 0 on the main path.  Design:
// - grid (ray tiles, frames), 4 warps a block; a warp takes 32 rays, in
//   the order `order` gives (rays.spiral_tile_order: the golden
//   spiral cut into compact 32-ray patches); each output goes to the ray's
//   own index, so the order is only a grouping and never changes a result;
// - the frame's atoms pass through shared memory in tiles of
//   RAY_EXIT_TILE 16-byte records (x, y, z, r), so any atom count works;
// - per atom tile, an exact cone cull: the lanes test 4 atoms each
//   against the warp's cone (below), compact the surviving records with a
//   ballot into a per-warp list in shared memory, and each lane then walks
//   the list for its own ray (unrolled by 4, so that the loads of
//   independent pairs overlap) with the pair arithmetic above, unchanged.
//   The pairs skipped all have computed under <= 0 and contribute
//   nothing, so any_front and max_exit are bit for bit the parent
//   kernel's.
//
// The cone.  Per frame the warp takes the axis a = s/|s|, s the sum of its
// rays' unit vectors (lane 0's butterfly sum, broadcast, so every lane
// tests against the same a), and over its rays c = min |a.u_j|,
// s = max |a x u_j| and E = max ||u_j|^2 - 1| + 4u (u the unit roundoff;
// the rays are unit only to rounding).  Widened as cos_lo = c - (8u + E)
// and sin_hi = s + (8u + E), they bound every ray's cos and sin of the
// angle beta_j between the lines of a and u_j (the test is line-symmetric:
// the front test compares |p0| and |p1| about the origin, not the ray's
// direction).  For an atom x at line angle theta from a, the distance of x
// from ray j's line is |x| sin(phi_j) with phi_j >= theta - beta_j (line
// angles are a metric), so it is at least
//   LHS = |a x x| cos_lo - |a.x| sin_hi
// (exact for unit a; the computed one is within ~17u|x|).  The computed
// under is <= 0 whenever that distance is >= r(1 + u) + (13u + 2E)|x|
// (the pair's rounding, and |u_j| != 1).  So the kernel drops the atom when
//   LHS >= |r| + 64(u + E)(|x|_1 + |r|),
// which covers both sums with a wide margin, and drops atoms with r = 0
// (padded atoms: rel 0, vdW 0) outright, since their under = -|perp|^2 is
// never > 0.  Atoms with |x| <= r + margin are never dropped, NaN keeps
// the atom, and a degenerate sum (s = 0) culls nothing but r = 0.
#include <cuda_runtime.h>

#include "kernels.h"
#include "ray_cull.cuh"

namespace {

constexpr int RAY_EXIT_WARPS = 4;
constexpr int RAY_EXIT_THREADS = 32 * RAY_EXIT_WARPS;
constexpr int RAY_EXIT_TILE = 128;  // atoms per shared tile
constexpr float CULL_ULPS = 64.0f;  // ray_kernels.EXIT_CULL_ULPS
constexpr float CONE_ULPS = 8.0f;   // ray_kernels.EXIT_CONE_ULPS

// The warp's cone (see the header).
template <typename T>
struct Cone {
  T a0, a1, a2, cos_lo, sin_hi, coef;

  // every lane of the warp calls this; dead lanes (no ray) pass live false
  __device__ Cone(T u0, T u1, T u2, bool live) {
    const T uroff = pw::unit_roundoff<T>();
    T s0 = live ? u0 : T(0), s1 = live ? u1 : T(0), s2 = live ? u2 : T(0);
    for (int off = 16; off > 0; off >>= 1) {
      s0 = s0 + __shfl_xor_sync(pw::kFullMask, s0, off);
      s1 = s1 + __shfl_xor_sync(pw::kFullMask, s1, off);
      s2 = s2 + __shfl_xor_sync(pw::kFullMask, s2, off);
    }
    s0 = __shfl_sync(pw::kFullMask, s0, 0);
    s1 = __shfl_sync(pw::kFullMask, s1, 0);
    s2 = __shfl_sync(pw::kFullMask, s2, 0);
    const T norm = sqrt(s0 * s0 + s1 * s1 + s2 * s2);
    a0 = s0 / norm;
    a1 = s1 / norm;
    a2 = s2 / norm;
    T c = T(INFINITY), s = T(0), e = T(0);
    if (live) {
      c = fabs(a0 * u0 + a1 * u1 + a2 * u2);
      const T x0 = a1 * u2 - a2 * u1;
      const T x1 = a2 * u0 - a0 * u2;
      const T x2 = a0 * u1 - a1 * u0;
      s = sqrt(x0 * x0 + x1 * x1 + x2 * x2);
      e = fabs((u0 * u0 + u1 * u1 + u2 * u2) - T(1));
    }
    c = pw::warp_min(c);
    s = pw::warp_max(s);
    e = pw::warp_max(e) + T(4) * uroff;
    const T widen = T(CONE_ULPS) * uroff + e;
    cos_lo = c - widen;
    sin_hi = s + widen;
    coef = T(CULL_ULPS) * (uroff + e);
  }

  // true when the atom's computed under is <= 0 for every ray of the warp
  __device__ __forceinline__ bool drops(const pw::Rec<T>& x) const {
    if (x.r == T(0)) return true;
    const T h = fabs(a0 * x.x + a1 * x.y + a2 * x.z);
    const T c0 = a1 * x.z - a2 * x.y;
    const T c1 = a2 * x.x - a0 * x.z;
    const T c2 = a0 * x.y - a1 * x.x;
    const T d = sqrt(c0 * c0 + c1 * c1 + c2 * c2);
    const T lhs = d * cos_lo - h * sin_hi;
    const T r = fabs(x.r);
    const T xl1 = (fabs(x.x) + fabs(x.y)) + fabs(x.z);
    return lhs >= r + coef * (xl1 + r);
  }
};

template <typename T, bool WANT_EXIT>
__global__ void ray_exit_kernel(const T* __restrict__ unit_all,
                                const T* __restrict__ rel_all,
                                const T* __restrict__ vdw_all,
                                const T* __restrict__ origin_all,
                                const int32_t* __restrict__ order,
                                uint8_t* __restrict__ any_front_all,
                                T* __restrict__ max_exit_all, int P, int N) {
  __shared__ pw::Rec<T> atoms[RAY_EXIT_TILE];
  __shared__ pw::Rec<T> kept[RAY_EXIT_WARPS][RAY_EXIT_TILE];

  const int frame = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* unit = unit_all + static_cast<size_t>(frame) * P * 3;
  const T* rel = rel_all + static_cast<size_t>(frame) * N * 3;
  const T* vdw = vdw_all + static_cast<size_t>(frame) * N;
  const T* origin = origin_all + static_cast<size_t>(frame) * 3;
  uint8_t* any_front = any_front_all + static_cast<size_t>(frame) * P;
  T* max_exit = max_exit_all + static_cast<size_t>(frame) * P;

  const int first = (blockIdx.x * RAY_EXIT_WARPS + warp) * 32;
  const int slot = first + lane;
  const bool live = slot < P;
  const bool warp_live = first < P;  // warp-uniform
  const int p = live ? order[slot] : 0;
  T u0 = T(0), u1 = T(0), u2 = T(0);
  if (live) {
    u0 = unit[3 * p];
    u1 = unit[3 * p + 1];
    u2 = unit[3 * p + 2];
  }
  const Cone<T> cone(u0, u1, u2, live);
  const T o0 = origin[0], o1 = origin[1], o2 = origin[2];
  const T ou = o0 * u0 + o1 * u1 + o2 * u2;
  const T oo = o0 * o0 + o1 * o1 + o2 * o2;

  bool anyf = false;
  T best = T(-pw::kBig);
  for (int base = 0; base < N; base += RAY_EXIT_TILE) {
    const int n_tile = min(RAY_EXIT_TILE, N - base);
    __syncthreads();  // the previous tile and its lists are consumed
    pw::stage_records(rel + 3 * base, vdw + base, n_tile, atoms);
    __syncthreads();
    if (!warp_live) continue;
    // the cone cull: survivors compacted into this warp's list
    int count = 0;
#pragma unroll
    for (int k = 0; k < RAY_EXIT_TILE / 32; ++k) {
      const int i = 32 * k + lane;
      const pw::Rec<T> at = atoms[min(i, n_tile - 1)];
      const bool keep = i < n_tile && !cone.drops(at);
      const unsigned m = __ballot_sync(pw::kFullMask, keep);
      if (keep) kept[warp][count + __popc(m & ((1u << lane) - 1u))] = at;
      count += __popc(m);
    }
    __syncwarp();
    if (!live) continue;
#pragma unroll 4
    for (int j = 0; j < count; ++j) {
      const pw::Rec<T> at = kept[warp][j];
      const T t_ca = u0 * at.x + u1 * at.y + u2 * at.z;
      const T q0 = at.x - t_ca * u0;
      const T q1 = at.y - t_ca * u1;
      const T q2 = at.z - t_ca * u2;
      const T d2 = q0 * q0 + q1 * q1 + q2 * q2;
      const T under = at.r * at.r - d2;
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
                     const T* origin, const int32_t* order,
                     uint8_t* any_front, T* max_exit, int B, int P, int N,
                     bool want_exit, void* stream) {
  if (B <= 0 || P <= 0) return;
  const dim3 grid((P + RAY_EXIT_THREADS - 1) / RAY_EXIT_THREADS, B);
  auto s = static_cast<cudaStream_t>(stream);
  if (want_exit) {
    ray_exit_kernel<T, true><<<grid, RAY_EXIT_THREADS, 0, s>>>(
        unit, rel, vdw, origin, order, any_front, max_exit, P, N);
  } else {
    ray_exit_kernel<T, false><<<grid, RAY_EXIT_THREADS, 0, s>>>(
        unit, rel, vdw, origin, order, any_front, max_exit, P, N);
  }
}

}  // namespace

void pw::ray_exit(const float* unit, const float* rel, const float* vdw,
                  const float* origin, const int32_t* order,
                  uint8_t* any_front, float* max_exit, int B, int P, int N,
                  bool want_exit, void* stream) {
  launch_ray_exit(unit, rel, vdw, origin, order, any_front, max_exit, B, P,
                  N, want_exit, stream);
}

void pw::ray_exit(const double* unit, const double* rel, const double* vdw,
                  const double* origin, const int32_t* order,
                  uint8_t* any_front, double* max_exit, int B, int P, int N,
                  bool want_exit, void* stream) {
  launch_ray_exit(unit, rel, vdw, origin, order, any_front, max_exit, B, P,
                  N, want_exit, stream);
}
