// clearance_min: the vdW clearance field min_i(|x_i - p| - vdw_i) of Q
// probe points against N atoms.
//
// Replaces pywindow_tpu/ops/pallas_kernels.py::clearance_min_pallas
// (:43).  Like it, this is a standalone function that no pipeline stage
// calls.  Padded atoms follow the MolArrays convention (coordinates
// ~1e6, vdW 0), so they never win the minimum and no mask is read.
//
// What bounds it: visiting every (probe, atom) pair costs ~19 float32
// instructions a pair with the correctly rounded square root (~40 in
// float64), so a kernel that visits every pair sits near the card's
// instruction rate (the first port's design: one thread a probe over
// every atom).
// On a clearance grid almost every atom is far from almost every probe,
// so this design visits only the pairs that an exact rule cannot rule
// out: on the 50^3 grid over the periodic cell a warp of 32 sorted
// probes visits ~7.6 of the 42 32-atom tiles (18% of the pairs,
// chip_smoke.py phase 3).  Four launches on the caller's stream:
//
// 1. frame (one block): the box of the atoms that are finite and within
//    FAR = 1e5 of the origin (parked atoms at 1e6 are not) gives the
//    Morton grid, 16 x 16 x 16 cubic cells over the box's longest side;
//    the block also zeroes the key counters and the two done counters
//    (the workspace needs no memset);
// 2. keys: every probe's and atom's cell, clamped into the grid, as a
//    Morton key, counted with atomics; atoms outside the frame (parked,
//    non-finite) take a far key after every cell, so they sort into
//    tiles of their own.  Probe keys come first, atom keys after them.
//    The last block to finish (a done counter) scans the 2 x 4,096 + 1
//    counters into offsets (a grid of 32^3 cells keeps a few percent
//    fewer tile pairs, but one block scanning its 65,537 counters costs
//    more than that saves);
// 3. scatter: probes and atoms to their sorted positions (atomics, one a
//    warp and cell: the order within a cell may change from run to run;
//    the outputs do not, since every rule below is exact for any
//    order).  The last block writes, per tile of 32 sorted atoms, its
//    box (lo, hi), its largest vdW and a flag when any coordinate or
//    radius is not finite;
// 4. the sweep: one warp per group of 32 consecutive sorted probes, the
//    dead lanes of the last group holding its first probe.  The warp
//    seeds with the tile whose box is nearest (squared gap) to the
//    centre of the group's box, then takes the tiles outward from it
//    (seed + 1, seed - 1, seed + 2, ...), skipping a tile when every lane
//    shows that it cannot lower its minimum; a tile that is visited is
//    staged in the warp's shared-memory slots and its pairs computed as
//    the plain version (geometry.clearance_field) computes them: the
//    difference form (dx*dx + dy*dy) + dz*dz, -fmad=false, a correctly
//    rounded sqrt, d = sqrt - vdW, and a minimum in which a NaN wins and
//    stays (as in torch.amin).  The minimum is exact in any order, so the
//    output equals the plain version's to the bit.
//
// Why a skipped tile is exact (no margin): every operation below is
// correctly rounded (round to nearest, RN) and RN is monotone.  For a
// probe p and an atom a in a tile with box [lo, hi] and largest vdW R:
// - per axis the gap g = max(RN(lo - p), RN(p - hi), 0) is at most
//   |RN(p - a)| (if p < lo, RN(lo - p) <= RN(a - p), which is |dx|; if
//   p > hi, the same on the other side; else g = 0), so its squares and
//   sums, in the pair's own order, give S = RN(RN(gx^2 + gy^2) + gz^2)
//   <= s, the pair's computed squared distance;
// - with X = RN(best + R): if X <= 0, best + R <= 0 exactly (a sum of
//   two numbers rounds to 0 only when it is 0), and d = RN(RN(sqrt s) - r)
//   >= RN(0 - r) = -r >= -R >= best; else Xu = next_up(X) >= best + R
//   and T = next_up(RN(Xu * Xu)) >= Xu^2, so s >= S >= T gives
//   sqrt(s) >= Xu, RN(sqrt s) >= Xu (Xu is a number) and d >= RN(Xu - R)
//   >= best.  Either way d < best is false, and d is not NaN when the
//   tile's coordinates and radii are finite;
// - so a lane may skip a tile when S >= T (T = 0 when X <= 0), and the
//   warp skips it when every lane may (__all_sync).  T is NaN (never
//   skip) when X or Xu * Xu is not finite, when best is NaN, and for a
//   flagged tile; a lane whose probe has a NaN coordinate never votes
//   to skip (the gap's max would drop the NaN);
// - inside a visited tile the same T (from the best at the tile's start,
//   which only falls) spares the square roots of a batch of pairs with
//   s >= T for every lane: the same proof with r <= R;
// - a prefilter takes 32 tiles at a time, a lane a tile, with the gap
//   between the group's box and the tile's (at most every lane's S, by
//   the same monotonicity) against T of the warp's largest best (T grows
//   with best): a tile it rules out is one every lane would skip, so the
//   tiles visited are those of the per-lane rule alone.
// ops/clearance_kernels.clearance_keep mirrors the rule on the CPU with
// torch.nextafter for next_up.
#include <cuda_runtime.h>

#include <cstdint>

#include "kernels.h"

namespace {

constexpr unsigned FULL = 0xffffffffu;
// the keys and scatter passes: blocks of 1,024 threads, so that their
// last blocks scan the counters and write the tiles with 32 warps
constexpr int PASS_THREADS = 1024;
constexpr int FRAME_THREADS = 1024;
// atoms a tile (a divisor of 32; 16 keeps fewer pairs but takes twice
// the tile tests, and was no faster)
constexpr int TILE = 32;
constexpr int GROUP_WARPS = 8;  // probe groups (warps) a block of the sweep
constexpr int SWEEP_THREADS = 32 * GROUP_WARPS;
// the sweep's blocks an SM it is compiled for (62 registers in float32,
// 64 in float64, no spills), and the pairs a lane computes between votes
template <typename T>
struct Sweep {
  static constexpr int blocks = 4;
  static constexpr int batch = sizeof(T) == 4 ? 8 : 4;
};
constexpr int CELL_BITS = 4;
constexpr int AXIS_CELLS = 1 << CELL_BITS;
constexpr int CELLS = AXIS_CELLS * AXIS_CELLS * AXIS_CELLS;
// probe keys [0, CELLS), atom keys [CELLS, 2 CELLS], the last the far key
constexpr int KEYS = 2 * CELLS + 1;
// the last block scans SCAN_PER consecutive counters a thread; the ones
// past whole steps are scanned by one thread
constexpr int SCAN_PER = 8;
constexpr int SCAN_STEP = SCAN_PER * PASS_THREADS;
// the workspace (ops/clearance_kernels.WORK_INTS): the key counters, two
// done counters, then the frame (lo[3], scale) at an 8-byte boundary
constexpr int DONE_WORD = KEYS;
constexpr int FRAME_WORD = (KEYS + 3) / 2 * 2;
constexpr double FAR = 1.0e5;

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T x, y, z, w;
};

__device__ __forceinline__ float positive_inf(float) {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ double positive_inf(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}
__device__ __forceinline__ float quiet_nan(float) {
  return __int_as_float(0x7fffffff);
}
__device__ __forceinline__ double quiet_nan(double) {
  return __longlong_as_double(0x7fffffffffffffffLL);
}
// the next number above a positive finite v
__device__ __forceinline__ float next_up(float v) {
  return __int_as_float(__float_as_int(v) + 1);
}
__device__ __forceinline__ double next_up(double v) {
  return __longlong_as_double(__double_as_longlong(v) + 1);
}

template <typename T>
__device__ __forceinline__ bool near(T x, T y, T z) {
  return fabs(x) < T(FAR) && fabs(y) < T(FAR) && fabs(z) < T(FAR);
}

template <typename T>
__device__ __forceinline__ int cell(T x, T lo, T scale) {
  const T v = (x - lo) * scale;
  return v >= T(AXIS_CELLS - 1) ? AXIS_CELLS - 1
                                : (v > T(0) ? static_cast<int>(v) : 0);
}

// bit b of a cell index to bit 3b
__device__ __forceinline__ int spread(int c) {
  int r = 0;
  for (int b = 0; b < CELL_BITS; ++b) r |= ((c >> b) & 1) << (3 * b);
  return r;
}

// frame = (lo[3], cells per unit of length; all 0 when no atom is near)
template <typename T>
__device__ __forceinline__ int morton(const T* frame, T x, T y, T z) {
  return spread(cell(x, frame[0], frame[3])) |
         (spread(cell(y, frame[1], frame[3])) << 1) |
         (spread(cell(z, frame[2], frame[3])) << 2);
}

// counter[key] += 1 for every active lane, one atomic per distinct key
// of the warp (on a grid, neighbouring probes share cells, and the
// atomics on one counter were the keys and scatter passes' bottleneck):
// returns the lane's slot, the old count plus its rank among the lanes of
// its key
__device__ __forceinline__ int increment(int* counter, int key) {
  const unsigned peers = __match_any_sync(__activemask(), key);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter + key, __popc(peers));
  return __shfl_sync(peers, base, leader) +
         __popc(peers & ((1u << lane) - 1));
}

// True in every thread of the one block that finishes last (the done
// counter counts the blocks); its reads of what the others wrote go to
// L2 (__ldcg).  Every thread of every block must call it.
__device__ __forceinline__ bool last_block(int* done) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1) == gridDim.x - 1;
  __syncthreads();
  return last;
}

// 1. the frame of the near atoms, and the counters zeroed (one block)
template <typename T>
__global__ void __launch_bounds__(FRAME_THREADS)
    frame_kernel(const T* __restrict__ coords, int N,
                 int* __restrict__ counts) {
  __shared__ T part[6][32];
  const T inf = positive_inf(T(0));
  T m[6] = {inf, inf, inf, inf, inf, inf};  // lo[3], then -hi[3]
  for (int a = threadIdx.x; a < N; a += FRAME_THREADS) {
    const T c[3] = {coords[3 * a], coords[3 * a + 1], coords[3 * a + 2]};
    if (!near(c[0], c[1], c[2])) continue;
    for (int k = 0; k < 3; ++k) {
      m[k] = c[k] < m[k] ? c[k] : m[k];
      m[3 + k] = -c[k] < m[3 + k] ? -c[k] : m[3 + k];
    }
  }
  for (int i = threadIdx.x; i < DONE_WORD + 2; i += FRAME_THREADS) {
    counts[i] = 0;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < 6; ++k) {
    for (int o = 16; o > 0; o >>= 1) {
      const T v = __shfl_xor_sync(FULL, m[k], o);
      m[k] = v < m[k] ? v : m[k];
    }
    if (lane == 0) part[k][warp] = m[k];
  }
  __syncthreads();
  if (warp != 0) return;
  T* frame = reinterpret_cast<T*>(counts + FRAME_WORD);
  T ext = T(0);
  T lo[3];
  for (int k = 0; k < 3; ++k) {
    T a = part[k][lane], b = part[3 + k][lane];
    for (int o = 16; o > 0; o >>= 1) {
      const T va = __shfl_xor_sync(FULL, a, o);
      const T vb = __shfl_xor_sync(FULL, b, o);
      a = va < a ? va : a;
      b = vb < b ? vb : b;
    }
    lo[k] = a;
    const T side = -b - a;
    ext = side > ext ? side : ext;
  }
  if (lane == 0) {
    const bool empty = !(lo[0] < inf);
    for (int k = 0; k < 3; ++k) frame[k] = empty ? T(0) : lo[k];
    frame[3] = empty || !(ext > T(0)) ? T(0) : T(AXIS_CELLS) / ext;
  }
}

// an atom record written by another block of this launch, read from L2
__device__ __forceinline__ Vec4<float> load_cg(const Vec4<float>* p) {
  const float4 u = __ldcg(reinterpret_cast<const float4*>(p));
  return {u.x, u.y, u.z, u.w};
}
__device__ __forceinline__ Vec4<double> load_cg(const Vec4<double>* p) {
  const double2 u = __ldcg(reinterpret_cast<const double2*>(p));
  const double2 w = __ldcg(reinterpret_cast<const double2*>(p) + 1);
  return {u.x, u.y, w.x, w.y};
}

// the counters to exclusive offsets, in place, by one block of
// PASS_THREADS: SCAN_PER consecutive counters a thread, a warp scan of
// the threads' sums and one of the warps' sums, the carry of the steps
__device__ void scan_counters(int* counts) {
  __shared__ int warp_sum[PASS_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base + SCAN_STEP <= KEYS; base += SCAN_STEP) {
    int* mine = counts + base + SCAN_PER * threadIdx.x;
    int v[SCAN_PER];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < SCAN_PER; j += 4) {
      const int4 w = __ldcg(reinterpret_cast<const int4*>(mine + j));
      v[j] = w.x, v[j + 1] = w.y, v[j + 2] = w.z, v[j + 3] = w.w;
      sum += w.x + w.y + w.z + w.w;
    }
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = carry, total = carry;
    for (int w = 0; w < PASS_THREADS / 32; ++w) {
      before += w < warp ? warp_sum[w] : 0;
      total += warp_sum[w];
    }
    __syncthreads();
    int run = before + incl - sum;
#pragma unroll
    for (int j = 0; j < SCAN_PER; j += 4) {
      const int4 w = make_int4(run, run + v[j], run + v[j] + v[j + 1],
                               run + v[j] + v[j + 1] + v[j + 2]);
      run += v[j] + v[j + 1] + v[j + 2] + v[j + 3];
      *reinterpret_cast<int4*>(mine + j) = w;
    }
    carry = total;
  }
  if (threadIdx.x == 0) {
    for (int i = KEYS / SCAN_STEP * SCAN_STEP; i < KEYS; ++i) {
      const int c = __ldcg(counts + i);
      counts[i] = carry;
      carry += c;
    }
  }
}

// 2. keys and their counts (element e < Q is probe e, else atom e - Q);
// the last block scans the counts
template <typename T>
__global__ void __launch_bounds__(PASS_THREADS)
    keys_kernel(const T* __restrict__ probes, int Q,
                const T* __restrict__ coords, int N, int* __restrict__ keys,
                int* __restrict__ counts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < Q + N) {
    const T* frame = reinterpret_cast<const T*>(counts + FRAME_WORD);
    int key;
    if (e < Q) {
      key = morton(frame, probes[3 * e], probes[3 * e + 1],
                   probes[3 * e + 2]);
    } else {
      const int a = e - Q;
      const T x = coords[3 * a], y = coords[3 * a + 1],
              z = coords[3 * a + 2];
      key = CELLS + (near(x, y, z) ? morton(frame, x, y, z) : CELLS);
    }
    keys[e] = key;
    increment(counts, key);
  }
  if (last_block(counts + DONE_WORD)) scan_counters(counts);
}

// 3. probes and atoms to their sorted positions (order[pos] is the
// element's index in its own array, probes first); the last block writes
// per tile of 32 sorted atoms (lo, largest vdW), (hi, flag), the flag 1
// when a coordinate or radius is not finite
template <typename T>
__global__ void __launch_bounds__(PASS_THREADS)
    scatter_kernel(const T* __restrict__ probes, int Q,
                   const T* __restrict__ coords, const T* __restrict__ vdw,
                   int N, const int* __restrict__ keys,
                   int* __restrict__ counts,
                   T* __restrict__ sorted_probes, Vec4<T>* __restrict__ atoms,
                   int* __restrict__ order, Vec4<T>* __restrict__ tiles) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < Q + N) {
    const int pos = increment(counts, keys[e]);
    if (e < Q) {
      for (int k = 0; k < 3; ++k) {
        sorted_probes[3 * pos + k] = probes[3 * e + k];
      }
      order[pos] = e;
    } else {
      const int a = e - Q;
      atoms[pos - Q] = {coords[3 * a], coords[3 * a + 1], coords[3 * a + 2],
                         vdw[a]};
      order[pos] = a;
    }
  }
  if (!last_block(counts + DONE_WORD + 1)) return;
  // a warp takes 32 / TILE tiles at a time, TILE lanes a tile
  const int lane = threadIdx.x & 31;
  const int seg = lane / TILE;
  const unsigned seg_mask = (TILE == 32 ? FULL : (1u << TILE) - 1)
                            << (seg * TILE);
  const int nt = (N + TILE - 1) / TILE;
  const T inf = positive_inf(T(0));
  for (int t0 = (threadIdx.x >> 5) * (32 / TILE); t0 < nt;
       t0 += PASS_THREADS / TILE) {
    const int t = t0 + seg;
    const int a = TILE * t + lane % TILE;
    const bool in = t < nt && a < N;
    const Vec4<T> v = in ? load_cg(atoms + a) : Vec4<T>{inf, inf, inf, -inf};
    const bool finite = in && isfinite(v.x) && isfinite(v.y) &&
                        isfinite(v.z) && isfinite(v.w);
    const bool flagged = (__ballot_sync(FULL, in && !finite) & seg_mask) != 0;
    T lo[3] = {finite ? v.x : inf, finite ? v.y : inf, finite ? v.z : inf};
    T hi[3] = {finite ? v.x : -inf, finite ? v.y : -inf, finite ? v.z : -inf};
    T r = finite ? v.w : -inf;
    for (int o = TILE / 2; o > 0; o >>= 1) {
      for (int k = 0; k < 3; ++k) {
        const T l = __shfl_xor_sync(FULL, lo[k], o);
        const T h = __shfl_xor_sync(FULL, hi[k], o);
        lo[k] = l < lo[k] ? l : lo[k];
        hi[k] = h > hi[k] ? h : hi[k];
      }
      const T s = __shfl_xor_sync(FULL, r, o);
      r = s > r ? s : r;
    }
    if (lane % TILE == 0 && t < nt) {
      tiles[2 * t] = {lo[0], lo[1], lo[2], r};
      tiles[2 * t + 1] = {hi[0], hi[1], hi[2], flagged ? T(1) : T(0)};
    }
  }
}

template <typename T>
__device__ __forceinline__ T axis_gap(T p, T lo, T hi) {
  const T a = lo - p;
  const T b = p - hi;
  const T g = a > b ? a : b;
  return g > T(0) ? g : T(0);
}

// squared gap from a point to a box, in the pair's order of operations
template <typename T>
__device__ __forceinline__ T box_gap2(T p0, T p1, T p2, const Vec4<T>& lo,
                                      const Vec4<T>& hi) {
  const T g0 = axis_gap(p0, lo.x, hi.x);
  const T g1 = axis_gap(p1, lo.y, hi.y);
  const T g2 = axis_gap(p2, lo.z, hi.z);
  return g0 * g0 + g1 * g1 + g2 * g2;
}

// the lesser of a and b, NaN if either is (a NaN wins and stays, as in
// torch.amin; nothing compares below it)
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}

// squared gap between two boxes, at most box_gap2 of any point of the
// first (per axis RN(lo - ghi) <= RN(lo - p) and RN(glo - hi) <=
// RN(p - hi) for glo <= p <= ghi)
template <typename T>
__device__ __forceinline__ T box_box_gap2(const T* glo, const T* ghi,
                                          const Vec4<T>& lo,
                                          const Vec4<T>& hi) {
  T g[3];
  const T los[3] = {lo.x, lo.y, lo.z}, his[3] = {hi.x, hi.y, hi.z};
  for (int k = 0; k < 3; ++k) {
    const T a = los[k] - ghi[k];
    const T b = glo[k] - his[k];
    const T m = a > b ? a : b;
    g[k] = m > T(0) ? m : T(0);
  }
  return g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
}

// T of the header: a pair or box with squared distance >= T cannot
// lower best (NaN: no such bound)
template <typename T>
__device__ __forceinline__ T skip_threshold(T best, T rmax) {
  const T x = best + rmax;
  if (x <= T(0)) return T(0);
  if (!(x < positive_inf(T(0)))) return quiet_nan(T(0));
  const T xu = next_up(x);
  const T sq = xu * xu;
  return sq < positive_inf(T(0)) ? next_up(sq) : quiet_nan(T(0));
}

// 4. the sweep: a warp per group of 32 consecutive (sorted) probes
template <typename T>
__global__ void __launch_bounds__(SWEEP_THREADS, Sweep<T>::blocks)
    clearance_min_kernel(const T* __restrict__ probes,
                         const int* __restrict__ order,
                         const Vec4<T>* __restrict__ atoms,
                         const Vec4<T>* __restrict__ tiles,
                         T* __restrict__ out, int Q, int N) {
  __shared__ Vec4<T> stage[SWEEP_THREADS];
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * GROUP_WARPS + (threadIdx.x >> 5)) * 32;
  if (first >= Q) return;  // the whole warp
  Vec4<T>* slots = stage + (threadIdx.x & ~31);
  const int pos = first + lane;
  const bool live = pos < Q;
  const int src = live ? pos : first;
  const T p0 = probes[3 * src], p1 = probes[3 * src + 1],
          p2 = probes[3 * src + 2];
  const bool probe_nan = p0 != p0 || p1 != p1 || p2 != p2;
  const int nt = (N + TILE - 1) / TILE;

  // the group's box and its centre (fmin/fmax drop NaN coordinates)
  T glo[3] = {p0, p1, p2}, ghi[3] = {p0, p1, p2}, c[3];
  for (int k = 0; k < 3; ++k) {
    for (int o = 16; o > 0; o >>= 1) {
      glo[k] = fmin(glo[k], __shfl_xor_sync(FULL, glo[k], o));
      ghi[k] = fmax(ghi[k], __shfl_xor_sync(FULL, ghi[k], o));
    }
    c[k] = (glo[k] + ghi[k]) * T(0.5);
  }
  // the seed: the tile of least squared gap to the centre, the lowest on
  // a tie; tile 0 when no gap is finite
  T seed_gap = positive_inf(T(0));
  int seed = nt;
  for (int t = lane; t < nt; t += 32) {
    const T s = box_gap2(c[0], c[1], c[2], tiles[2 * t], tiles[2 * t + 1]);
    if (s < seed_gap) {
      seed_gap = s;
      seed = t;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const T s = __shfl_xor_sync(FULL, seed_gap, o);
    const int t = __shfl_xor_sync(FULL, seed, o);
    if (s < seed_gap || (s == seed_gap && t < seed)) {
      seed_gap = s;
      seed = t;
    }
  }
  if (seed == nt) seed = 0;

  T best = positive_inf(T(0));
  // every pair of tile t, Sweep<T>::batch atoms at a time (independent
  // arithmetic; the last batch repeats the tile's last atom, which
  // changes nothing), the square roots of a batch spared when s >= thr
  // for every pair of every lane, and the batch's least clearance
  // (NaN first) folded into best
  auto visit = [&](int t, T thr) {
    constexpr int B = Sweep<T>::batch;
    const int a = TILE * t + lane;
    __syncwarp();
    if (lane < TILE && a < N) slots[lane] = atoms[a];
    __syncwarp();
    const int n = min(TILE, N - TILE * t);
    for (int j = 0; j < n; j += B) {
      T s[B], r[B];
      bool need = false;
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const Vec4<T> v = slots[min(j + u, n - 1)];
        const T dx = p0 - v.x;
        const T dy = p1 - v.y;
        const T dz = p2 - v.z;
        s[u] = dx * dx + dy * dy + dz * dz;
        r[u] = v.w;
        need = need || !(s[u] >= thr);
      }
      if (__any_sync(FULL, need)) {
        T d[B];
#pragma unroll
        for (int u = 0; u < B; ++u) d[u] = sqrt(s[u]) - r[u];
#pragma unroll
        for (int w = 1; w < B; w <<= 1) {
#pragma unroll
          for (int u = 0; u + w < B; u += 2 * w) d[u] = nan_min(d[u], d[u + w]);
        }
        best = nan_min(d[0], best);
      }
    }
  };

  visit(seed, quiet_nan(T(0)));
  // the other tiles outward from the seed: step k is tile seed + (k+1)/2
  // for odd k, seed - k/2 for even k.  A prefilter takes 32 steps at a
  // time, a lane a tile: the squared gap G between the group's box and
  // the tile's is at most every lane's S, and T grows with best, so
  // G >= T(the largest best) means every lane would skip the tile; only
  // the other tiles take the per-lane test, with the current best, in
  // step order (the tiles visited are those of the per-lane rule alone).
  // A NaN probe turns the prefilter off.
  const int last = 2 * max(seed, nt - 1 - seed);
  auto tile_at = [&](int k) {
    return (k & 1) ? seed + (k + 1) / 2 : seed - k / 2;
  };
  const bool prefilter = !__any_sync(FULL, probe_nan);
  for (int k0 = 1; k0 <= last; k0 += 32) {
    T top = best;  // the largest best of the warp, NaN if any is NaN
    for (int o = 16; o > 0; o >>= 1) {
      const T b = __shfl_xor_sync(FULL, top, o);
      top = (b > top || b != b) ? b : top;
    }
    const int tk = tile_at(k0 + lane);
    bool maybe = false;
    if (k0 + lane <= last && tk >= 0 && tk < nt) {
      const Vec4<T> lo = tiles[2 * tk];
      const Vec4<T> hi = tiles[2 * tk + 1];
      const T thr = hi.w != T(0) ? quiet_nan(T(0)) : skip_threshold(top, lo.w);
      maybe = !prefilter || !(box_box_gap2(glo, ghi, lo, hi) >= thr);
    }
    for (unsigned todo = __ballot_sync(FULL, maybe); todo != 0;
         todo &= todo - 1) {
      const int t = tile_at(k0 + __ffs(todo) - 1);
      const Vec4<T> lo = tiles[2 * t];
      const Vec4<T> hi = tiles[2 * t + 1];
      const T gap2 = box_gap2(p0, p1, p2, lo, hi);
      const T thr = hi.w != T(0) ? quiet_nan(T(0)) : skip_threshold(best, lo.w);
      if (!__all_sync(FULL, !probe_nan && gap2 >= thr)) visit(t, thr);
    }
  }
  if (live) out[order[pos]] = best;
}

template <typename T>
void launch_clearance_min(const T* probes, const T* coords, const T* vdw,
                          T* out, int Q, int N,
                          const pw::ClearanceWork<T>& work, void* stream) {
  if (Q <= 0 || N <= 0) return;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* atoms = reinterpret_cast<Vec4<T>*>(work.sorted_atoms);
  auto* tiles = reinterpret_cast<Vec4<T>*>(work.tiles);
  const int pass_blocks = (Q + N + PASS_THREADS - 1) / PASS_THREADS;
  const int groups = (Q + 31) / 32;
  frame_kernel<T><<<1, FRAME_THREADS, 0, s>>>(coords, N, work.counts);
  keys_kernel<T><<<pass_blocks, PASS_THREADS, 0, s>>>(probes, Q, coords, N,
                                                      work.keys, work.counts);
  scatter_kernel<T><<<pass_blocks, PASS_THREADS, 0, s>>>(
      probes, Q, coords, vdw, N, work.keys, work.counts, work.sorted_probes,
      atoms, work.order, tiles);
  clearance_min_kernel<T><<<(groups + GROUP_WARPS - 1) / GROUP_WARPS,
                            SWEEP_THREADS, 0, s>>>(
      work.sorted_probes, work.order, atoms, tiles, out, Q, N);
}

}  // namespace

void pw::clearance_min(const float* probes, const float* coords,
                       const float* vdw, float* out, int Q, int N,
                       const ClearanceWork<float>& work, void* stream) {
  launch_clearance_min(probes, coords, vdw, out, Q, N, work, stream);
}

void pw::clearance_min(const double* probes, const double* coords,
                       const double* vdw, double* out, int Q, int N,
                       const ClearanceWork<double>& work, void* stream) {
  launch_clearance_min(probes, coords, vdw, out, Q, N, work, stream);
}
