// nm_xy: the window-xy stage per lane (one lane per (frame, window)):
// the brute_ns x brute_ns grid over [-half, half]^2 and the Nelder-Mead
// polish from its first minimum, in double precision.
//
// Replaces pywindow_tpu/ops/nm_pallas.py::nm_xy_flat with brute_ns > 0
// (body nm_xy_kernel_body, reached through brute_nm_xy_stable_pallas).
// Semantics are those of the plain version,
// pywindow_torch/ops/optim.py::brute_then_polish with the stable
// delta-space objective of the window refinement (scipy's
// brute(..., finish=fmin), utilities.py:1312-1317): the grid points are
// linspace's (start * (1 - i/div) + stop * (i/div), the last exactly
// stop), x outer, first minimum on ties; then fmin's initial simplex,
// coefficients, decision tree and xatol/fatol test, with the stable
// 3-vertex sort.  The objective is
//   f(x, y) = -2 * (clearance((x, y, z*)) - clearance((0, 0, z*)))
// evaluated symbolically per atom (geometry.py's clearance_diff) against
// the anchor context (0, 0, z*), which is computed once per lane.
//
// What bounds it: every evaluation is a pass over atoms with a double
// square root and a divide each, ~10-instruction Newton sequences on this
// card, so a (evaluation, atom) pair costs ~40 FP64 instructions.  Over a
// batch the 400 grid evaluations make the kernel FP64-throughput bound;
// for one molecule (a few lanes) the chain of simplex iterations makes
// it latency bound.  It moves almost no memory, and there is no matrix
// product, so neither the tensor cores nor TMA apply (a lane stages
// < 23 KB once).  Design:
// - a lane is one block of several warps (nm_kernels.lane_threads); an
//   inactive lane (a slot that holds no window) writes its placeholder
//   and returns before staging anything;
// - exact atom cull for the grid (nm_kernels.grid_keep mirrors it, with
//   these operations).  With v_a(p) = base_a + delta_a(p) the value of
//   atom a at grid point p and F(p) = min_a v_a(p), the grid's best value
//   F* = max_p F(p) is at most U for
//     U0 = min_b(hi_b) - m0 + eps   (hi_b: b's greatest distance to the
//                                     square |x|, |y| <= half at z*, less
//                                     its vdW radius), and
//     U1 = max_p min_{a in A} v_a(p) for any atom subset A (F <= F_A),
//   and v_a(p) >= lo_a - m0 - eps (lo_a: the least distance).  An atom
//   with lo_a - m0 - eps > min(U0, U1) + eps is never the minimising atom
//   at any grid point, so every grid value, hence the first argmin, is
//   bit for bit the same without it.  eps = 1e-9 A covers the symbolic
//   form's rounding (~1e-14 A here).  A is the atoms with hi_b within
//   the first of 1, 1/2, ... 1/32 A and 0 of min_b(hi_b) that holds at
//   most 16 of them (none: U1 is not used); its grid pass costs 400 x 16
//   evaluations at most.  The kept atoms are compacted to the front of
//   the context in shared memory, the others behind them; the polish is
//   unbounded and reads all;
// - parallel grid: the points are split over the block's threads by flat
//   index (x outer), four independent min chains a thread, reading the
//   atoms by broadcast; the argmin is reduced as a (value, flat index)
//   pair, lowest index on ties: the serial strict-< scan's first minimum;
// - the simplex: the reflection, then the one candidate scipy's tree
//   needs (evaluating all four at once was measured slower, PERF.md); a
//   shrink's two vertices and the initial simplex's three share one
//   sweep.  Each sweep splits (point, atom) pairs over all threads and
//   ends in one block-wide minimum (block_min.cuh).
#include <cuda_runtime.h>

#include <climits>

#include "block_min.cuh"
#include "kernels.h"
#include "sweep.cuh"

namespace {

constexpr double RHO = 1.0;
constexpr double CHI = 2.0;
constexpr double PSI = 0.5;
constexpr double SIGMA = 0.5;
constexpr double NONZDELT = 0.05;
constexpr double ZDELT = 0.00025;
constexpr double BIG = 1e30;
constexpr double CULL_EPS = 1e-9;  // nm_kernels.CULL_EPS
constexpr int CTX = 6;             // doubles of anchor context per atom
constexpr int MAX_THREADS = 256;
constexpr int GRID_CHAINS = 4;  // grid points a thread evaluates together
constexpr int SUBSET = 16;      // nm_kernels.CULL_SUBSET
constexpr int N_WIDTHS = 7;     // nm_kernels.CULL_WIDTHS: 1, 1/2, ... 1/32, 0

__device__ __forceinline__ double subset_width(int k) {
  return k == N_WIDTHS - 1 ? 0.0 : 1.0 / static_cast<double>(1 << k);
}

// one atom's anchor context: d = (0, 0, z*) - a, |d|^2, |d|, c - m0
struct Atom {
  double d0, d1, d2, db2, db, base;
};

// ctx: (CTX, stride) columns d0, d1, d2, db2, db, base
__device__ __forceinline__ Atom load_atom(const double* ctx, int stride, int a) {
  return Atom{ctx[a],              ctx[stride + a],     ctx[2 * stride + a],
              ctx[3 * stride + a], ctx[4 * stride + a], ctx[5 * stride + a]};
}

__device__ __forceinline__ void store_atom(double* ctx, int stride, int a,
                                           const Atom& at) {
  ctx[a] = at.d0;
  ctx[stride + a] = at.d1;
  ctx[2 * stride + a] = at.d2;
  ctx[3 * stride + a] = at.db2;
  ctx[4 * stride + a] = at.db;
  ctx[5 * stride + a] = at.base;
}

// base_a + delta_a(u0, u1, 0): the atom's clearance at the probe less m0
__device__ __forceinline__ double value(const Atom& at, double u0, double u1) {
  const double g = u0 * at.d0 + u1 * at.d1 + 0.0 * at.d2;
  const double s2 = u0 * u0 + u1 * u1 + 0.0 * 0.0;
  const double num = 2.0 * g + s2;
  const double sum = at.db2 + num;
  const double dp = sqrt(sum < 0.0 ? 0.0 : sum);
  const double den = at.db + dp;
  const double delta = num / (den == 0.0 ? 1.0 : den);
  return at.base + delta;
}

// The per-atom geometry of the anchor pass and the cull: d, |d|^2, and
// the least and greatest distance (less the vdW radius) from the atom to
// the grid's square |x|, |y| <= h at z*.
struct Reach {
  double d0, d1, d2, db2, lo, hi;
};

__device__ __forceinline__ Reach reach(const double* xc, const double* r,
                                       double za, double h, int a) {
  Reach q;
  q.d0 = 0.0 - xc[3 * a];
  q.d1 = 0.0 - xc[3 * a + 1];
  q.d2 = za - xc[3 * a + 2];
  q.db2 = q.d0 * q.d0 + q.d1 * q.d1 + q.d2 * q.d2;
  const double ex = fmax(fabs(q.d0) - h, 0.0);
  const double ey = fmax(fabs(q.d1) - h, 0.0);
  const double fx = fabs(q.d0) + h;
  const double fy = fabs(q.d1) + h;
  q.lo = sqrt(ex * ex + ey * ey + q.d2 * q.d2) - r[a];
  q.hi = sqrt(fx * fx + fy * fy + q.d2 * q.d2) - r[a];
  return q;
}

__device__ __forceinline__ Atom anchor_atom(const Reach& q, double ra, double m0) {
  const double db = sqrt(q.db2);
  return Atom{q.d0, q.d1, q.d2, q.db2, db, (db - ra) - m0};
}

// f at up to 3 points (ux[c], uy[c]), c < count, over all n atoms:
// (point, atom) pairs split over the block, one block-wide minimum;
// every thread gets every value
__device__ void eval_points(const double* ctx, int n, const double (&ux)[3],
                            const double (&uy)[3], int count,
                            pw::BlockMin& red, double (&out)[3]) {
  double best[3] = {BIG, BIG, BIG};
  for (int a = threadIdx.x; a < n; a += blockDim.x) {
    const Atom at = load_atom(ctx, n, a);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < count) best[c] = fmin(best[c], value(at, ux[c], uy[c]));
    }
  }
  red(best);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = -2.0 * best[c];
}

__device__ __forceinline__ double grid_value(double start, double stop, int i,
                                             int ns) {
  const int div = ns - 1;
  if (i == div) return stop;
  const double s = static_cast<double>(i) / static_cast<double>(div);
  return start * (1.0 - s) + stop * s;
}

// visit(idx, min_a v_a) for each of this thread's grid points, in
// increasing flat index (x outer), over the first `count` atoms of ctx
template <class Visit>
__device__ void grid_sweep(const double* ctx, int stride, int count, double h,
                           int ns, Visit visit) {
  const int total = ns * ns;
  const int nt = blockDim.x;
  for (int i0 = threadIdx.x; i0 < total; i0 += GRID_CHAINS * nt) {
    double gx[GRID_CHAINS], gy[GRID_CHAINS], best[GRID_CHAINS];
#pragma unroll
    for (int j = 0; j < GRID_CHAINS; ++j) {
      const int idx = i0 + j * nt;
      const int ix = idx / ns;
      const bool valid = idx < total;
      gx[j] = valid ? grid_value(-h, h, ix, ns) : 0.0;
      gy[j] = valid ? grid_value(-h, h, idx - ix * ns, ns) : 0.0;
      best[j] = BIG;
    }
#pragma unroll 2
    for (int a = 0; a < count; ++a) {
      const Atom at = load_atom(ctx, stride, a);
#pragma unroll
      for (int j = 0; j < GRID_CHAINS; ++j) {
        best[j] = fmin(best[j], value(at, gx[j], gy[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < GRID_CHAINS; ++j) {
      if (i0 + j * nt < total) visit(i0 + j * nt, best[j]);
    }
  }
}

// (value, flat index) a is below b: lower value, or equal and earlier
__device__ __forceinline__ bool pair_less(double va, int ia, double vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// stable sort of the 3 vertices by f (bubble network, swap on strict >)
__device__ __forceinline__ void sort3(double* vx, double* vy, double* vf) {
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (vf[i] > vf[i + 1]) {
        double t = vx[i]; vx[i] = vx[i + 1]; vx[i + 1] = t;
        t = vy[i]; vy[i] = vy[i + 1]; vy[i + 1] = t;
        t = vf[i]; vf[i] = vf[i + 1]; vf[i + 1] = t;
      }
    }
  }
}

__device__ __forceinline__ bool converged(const double* vx, const double* vy,
                                          const double* vf, double xatol,
                                          double fatol) {
  double xs = 0.0, fs = 0.0;
#pragma unroll
  for (int v = 1; v < 3; ++v) {
    xs = fmax(xs, fmax(fabs(vx[v] - vx[0]), fabs(vy[v] - vy[0])));
    fs = fmax(fs, fabs(vf[v] - vf[0]));
  }
  return (xs <= xatol) && (fs <= fatol);
}

__global__ void __launch_bounds__(MAX_THREADS)
    nm_xy_kernel(const double* __restrict__ coords,
                 const double* __restrict__ vdw,
                 const double* __restrict__ zanchor,
                 const double* __restrict__ half,
                 const uint8_t* __restrict__ active,
                 double* __restrict__ xy_out, double* __restrict__ f_out,
                 uint8_t* __restrict__ capped_out,
                 int32_t* __restrict__ iters_out, int N, int ns, int maxiter,
                 double xatol, double fatol) {
  const int lane_id = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (active != nullptr && active[lane_id] == 0) {
    // a slot that holds no window: its outputs are never read
    if (tid == 0) {
      xy_out[2 * lane_id] = 0.0;
      xy_out[2 * lane_id + 1] = 0.0;
      f_out[lane_id] = 0.0;
      capped_out[lane_id] = 0;
      if (iters_out != nullptr) iters_out[lane_id] = 0;
    }
    return;
  }
  extern __shared__ double smem[];
  double* ctx = smem;                       // CTX x N, kept atoms first
  double* sub = ctx + CTX * N;              // CTX x SUBSET: the subset A
  double* red_buf = sub + CTX * SUBSET;     // BlockMin
  double* pair_v = red_buf + pw::kBlockMinDoubles;  // grid argmin, per warp
  int* pair_i = reinterpret_cast<int*>(pair_v + pw::kMaxWarps);
  int* counts = pair_i + pw::kMaxWarps;  // kept, culled, A, widths' counts
  pw::BlockMin red{red_buf, 0};
  const double* xc = coords + static_cast<size_t>(lane_id) * N * 3;
  const double* r = vdw + static_cast<size_t>(lane_id) * N;
  const double za = zanchor[lane_id];
  const double h = half[lane_id];

  // pass 1: m0 = clearance at (0, 0, z*) and min_b(hi_b)
  if (tid < 3 + N_WIDTHS) counts[tid] = 0;
  double mins[2] = {BIG, BIG};
  for (int a = tid; a < N; a += nt) {
    const Reach q = reach(xc, r, za, h, a);
    mins[0] = fmin(mins[0], sqrt(q.db2) - r[a]);
    mins[1] = fmin(mins[1], q.hi);
  }
  red(mins);
  const double m0 = mins[0];
  const double hi_min = mins[1];

  // the subset A: the widest width whose atoms number at most SUBSET
  for (int a = tid; a < N; a += nt) {
    const double hi = reach(xc, r, za, h, a).hi;
    for (int k = 0; k < N_WIDTHS; ++k) {
      if (hi <= hi_min + subset_width(k)) atomicAdd(&counts[3 + k], 1);
    }
  }
  __syncthreads();
  int width = -1;
  for (int k = N_WIDTHS - 1; k >= 0 && counts[3 + k] <= SUBSET; --k) width = k;
  double bound = hi_min + 2.0 * CULL_EPS;
  if (width >= 0) {
    const double lim = hi_min + subset_width(width);
    for (int a = tid; a < N; a += nt) {
      const Reach q = reach(xc, r, za, h, a);
      if (q.hi <= lim) store_atom(sub, SUBSET, atomicAdd(&counts[2], 1), anchor_atom(q, r[a], m0));
    }
    __syncthreads();
    // U1: the grid's best value over A, an upper bound of F*
    double u1[1] = {BIG};
    grid_sweep(sub, SUBSET, counts[2], h, ns,
               [&](int, double v) { u1[0] = fmin(u1[0], -v); });
    red(u1);
    bound = fmin(bound, (-u1[0] + m0) + 2.0 * CULL_EPS);
  }

  // pass 2: the anchor context, kept atoms at the front, culled behind
  for (int a = tid; a < N; a += nt) {
    const Reach q = reach(xc, r, za, h, a);
    const int slot = q.lo <= bound ? atomicAdd(&counts[0], 1)
                                   : N - 1 - atomicAdd(&counts[1], 1);
    store_atom(ctx, N, slot, anchor_atom(q, r[a], m0));
  }
  __syncthreads();

  // brute grid over the kept atoms; strict < keeps a thread's first
  // minimum, then the block's first minimum by (value, index) pairs
  double gbest = INFINITY;
  int gidx = INT_MAX;
  grid_sweep(ctx, N, counts[0], h, ns, [&](int idx, double v) {
    const double fv = -2.0 * v;
    if (gidx == INT_MAX || fv < gbest) {
      gbest = fv;
      gidx = idx;
    }
  });
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(0xffffffffu, gbest, off);
    const int oi = __shfl_xor_sync(0xffffffffu, gidx, off);
    if (pair_less(ov, oi, gbest, gidx)) {
      gbest = ov;
      gidx = oi;
    }
  }
  if ((tid & 31) == 0) {
    pair_v[tid >> 5] = gbest;
    pair_i[tid >> 5] = gidx;
  }
  __syncthreads();
  gbest = pair_v[0];
  gidx = pair_i[0];
  for (int w = 1; w < (nt >> 5); ++w) {
    if (pair_less(pair_v[w], pair_i[w], gbest, gidx)) {
      gbest = pair_v[w];
      gidx = pair_i[w];
    }
  }
  const int bx = gidx / ns;
  const double x0a = grid_value(-h, h, bx, ns);
  const double x0b = grid_value(-h, h, gidx - bx * ns, ns);

  // fmin's initial simplex
  const double step0 = (x0a != 0.0) ? NONZDELT * x0a : ZDELT;
  const double step1 = (x0b != 0.0) ? NONZDELT * x0b : ZDELT;
  double vx[3] = {x0a, x0a + step0, x0a + 0.0 * step0};
  double vy[3] = {x0b, x0b + 0.0 * step1, x0b + step1};
  double vf[3];
  eval_points(ctx, N, vx, vy, 3, red, vf);
  sort3(vx, vy, vf);

  int it = 0;
  while (it < maxiter && !converged(vx, vy, vf, xatol, fatol)) {
    const double xbx = (vx[0] + vx[1]) / 2.0;
    const double xby = (vy[0] + vy[1]) / 2.0;
    const double rx[3] = {(1.0 + RHO) * xbx - RHO * vx[2], 0.0, 0.0};
    const double ry[3] = {(1.0 + RHO) * xby - RHO * vy[2], 0.0, 0.0};
    double fr[3];
    eval_points(ctx, N, rx, ry, 1, red, fr);
    const double fxr = fr[0];
    const bool best = fxr < vf[0];
    const bool good = fxr < vf[1];
    const bool worse = fxr < vf[2];
    double nx = rx[0], ny = ry[0], nf = fxr;
    bool shrink = false;
    if (best || !good) {
      // expansion, outside or inside contraction: the one the tree reads
      const double a = best ? 1.0 + RHO * CHI : (worse ? 1.0 + PSI * RHO : 1.0 - PSI);
      const double b = best ? RHO * CHI : (worse ? PSI * RHO : PSI);
      double cx[3], cy[3], fc[3];
      if (best || worse) {
        cx[0] = a * xbx - b * vx[2];
        cy[0] = a * xby - b * vy[2];
      } else {
        cx[0] = a * xbx + b * vx[2];
        cy[0] = a * xby + b * vy[2];
      }
      cx[1] = cx[2] = cy[1] = cy[2] = 0.0;
      eval_points(ctx, N, cx, cy, 1, red, fc);
      const bool take = best ? fc[0] < fxr : (worse ? fc[0] <= fxr : fc[0] < vf[2]);
      if (take) {
        nx = cx[0];
        ny = cy[0];
        nf = fc[0];
      } else if (!best) {
        shrink = true;
      }
    }
    if (shrink) {
#pragma unroll
      for (int v = 1; v < 3; ++v) {
        vx[v] = vx[0] + SIGMA * (vx[v] - vx[0]);
        vy[v] = vy[0] + SIGMA * (vy[v] - vy[0]);
      }
      const double ux[3] = {vx[1], vx[2], 0.0};
      const double uy[3] = {vy[1], vy[2], 0.0};
      double fv[3];
      eval_points(ctx, N, ux, uy, 2, red, fv);
      vf[1] = fv[0];
      vf[2] = fv[1];
    } else {
      vx[2] = nx;
      vy[2] = ny;
      vf[2] = nf;
    }
    sort3(vx, vy, vf);
    it += 1;
  }
  if (tid == 0) {
    xy_out[2 * lane_id] = vx[0];
    xy_out[2 * lane_id + 1] = vy[0];
    f_out[lane_id] = vf[0];
    capped_out[lane_id] =
        (it >= maxiter && !converged(vx, vy, vf, xatol, fatol)) ? 1 : 0;
    if (iters_out != nullptr) iters_out[lane_id] = it;
  }
}

}  // namespace

void pw::nm_xy(const double* coords, const double* vdw, const double* zanchor,
               const double* half, const uint8_t* active, double* xy,
               double* f, uint8_t* capped, int32_t* iterations, int L, int N,
               int brute_ns, int maxiter, double xatol, double fatol,
               int threads, void* stream) {
  if (L <= 0) return;
  const size_t smem =
      sizeof(double) * (static_cast<size_t>(CTX) * (N + SUBSET) +
                        pw::kBlockMinDoubles + pw::kMaxWarps) +
      sizeof(int) * (pw::kMaxWarps + 3 + N_WIDTHS);
  pw::allow_smem(nm_xy_kernel, smem);
  nm_xy_kernel<<<L, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      coords, vdw, zanchor, half, active, xy, f, capped, iterations, N,
      brute_ns, maxiter, xatol, fatol);
}
