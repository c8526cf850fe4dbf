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
// What bounds it: 400 grid evaluations then up to maxiter simplex
// iterations of 1-4 evaluations each, every evaluation a pass over the
// atoms with a sqrt and a divide in double precision: latency per lane,
// double-precision sqrt/divide throughput over a batch; almost no
// memory traffic.  Design: one warp per lane; the anchor context
// (dx, dy, dz, |d|^2, |d|, clearance - m0 per atom) in shared memory;
// every thread runs the simplex logic redundantly and the atoms of each
// evaluation are split over the lanes and reduced by shuffles.  Unlike
// the plain version, which evaluates every candidate of an iteration in
// one batched call, the kernel evaluates only the candidates that
// scipy's decision tree consumes; the values consumed are the same.
#include <cuda_runtime.h>

#include "kernels.h"
#include "sweep.cuh"

namespace {

constexpr double RHO = 1.0;
constexpr double CHI = 2.0;
constexpr double PSI = 0.5;
constexpr double SIGMA = 0.5;
constexpr double NONZDELT = 0.05;
constexpr double ZDELT = 0.00025;
constexpr int CTX = 6;  // doubles of anchor context per atom

struct Anchor {
  const double* ctx;  // (CTX, N) columns: d0, d1, d2, db2, db, base
  int n;
  int lane;

  // -2 * min_i(base_i + delta_i(u0, u1, 0))
  __device__ double f(double u0, double u1) const {
    const double* d0 = ctx;
    const double* d1 = ctx + n;
    const double* d2 = ctx + 2 * n;
    const double* db2 = ctx + 3 * n;
    const double* db = ctx + 4 * n;
    const double* base = ctx + 5 * n;
    double best = 1e30;
    for (int a = lane; a < n; a += 32) {
      const double g = u0 * d0[a] + u1 * d1[a] + 0.0 * d2[a];
      const double s2 = u0 * u0 + u1 * u1 + 0.0 * 0.0;
      const double num = 2.0 * g + s2;
      const double sum = db2[a] + num;
      const double dp = sqrt(sum < 0.0 ? 0.0 : sum);
      const double den = db[a] + dp;
      const double delta = num / (den == 0.0 ? 1.0 : den);
      best = fmin(best, base[a] + delta);
    }
    for (int off = 16; off > 0; off >>= 1) {
      best = fmin(best, __shfl_xor_sync(0xffffffffu, best, off));
    }
    return -2.0 * best;
  }
};

__device__ __forceinline__ double grid_value(double start, double stop, int i,
                                             int ns) {
  const int div = ns - 1;
  if (i == div) return stop;
  const double s = static_cast<double>(i) / static_cast<double>(div);
  return start * (1.0 - s) + stop * s;
}

// stable sort of the 3 vertices by f (bubble network, swap on strict >)
__device__ __forceinline__ void sort3(double* vx, double* vy, double* vf) {
  for (int pass = 0; pass < 2; ++pass) {
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
  for (int v = 1; v < 3; ++v) {
    xs = fmax(xs, fmax(fabs(vx[v] - vx[0]), fabs(vy[v] - vy[0])));
    fs = fmax(fs, fabs(vf[v] - vf[0]));
  }
  return (xs <= xatol) && (fs <= fatol);
}

__global__ void nm_xy_kernel(const double* __restrict__ coords,
                             const double* __restrict__ vdw,
                             const double* __restrict__ zanchor,
                             const double* __restrict__ half,
                             double* __restrict__ xy_out,
                             double* __restrict__ f_out,
                             uint8_t* __restrict__ capped_out, int N, int ns,
                             int maxiter, double xatol, double fatol) {
  extern __shared__ unsigned char smem_raw[];
  double* ctx = reinterpret_cast<double*>(smem_raw);
  const int lane_id = blockIdx.x;
  const int lane = threadIdx.x;
  const double* xc = coords + static_cast<size_t>(lane_id) * N * 3;
  const double* r = vdw + static_cast<size_t>(lane_id) * N;
  const double za = zanchor[lane_id];

  // anchor context at (0, 0, z*)
  double m0 = 1e30;
  for (int a = lane; a < N; a += 32) {
    const double d0 = 0.0 - xc[3 * a];
    const double d1 = 0.0 - xc[3 * a + 1];
    const double d2 = za - xc[3 * a + 2];
    const double db2 = d0 * d0 + d1 * d1 + d2 * d2;
    const double db = sqrt(db2);
    const double cb = db - r[a];
    ctx[a] = d0;
    ctx[N + a] = d1;
    ctx[2 * N + a] = d2;
    ctx[3 * N + a] = db2;
    ctx[4 * N + a] = db;
    ctx[5 * N + a] = cb;
    m0 = fmin(m0, cb);
  }
  for (int off = 16; off > 0; off >>= 1) {
    m0 = fmin(m0, __shfl_xor_sync(0xffffffffu, m0, off));
  }
  for (int a = lane; a < N; a += 32) ctx[5 * N + a] = ctx[5 * N + a] - m0;
  __syncwarp();
  const Anchor anc{ctx, N, lane};

  // brute grid: x outer, strict < keeps the first minimum
  const double h = half[lane_id];
  double gbest = 0.0, x0a = 0.0, x0b = 0.0;
  bool have = false;
  for (int ix = 0; ix < ns; ++ix) {
    const double gx = grid_value(-h, h, ix, ns);
    for (int iy = 0; iy < ns; ++iy) {
      const double gy = grid_value(-h, h, iy, ns);
      const double fv = anc.f(gx, gy);
      if (!have || fv < gbest) {
        have = true;
        gbest = fv;
        x0a = gx;
        x0b = gy;
      }
    }
  }

  // fmin's initial simplex
  const double step0 = (x0a != 0.0) ? NONZDELT * x0a : ZDELT;
  const double step1 = (x0b != 0.0) ? NONZDELT * x0b : ZDELT;
  double vx[3] = {x0a, x0a + step0, x0a + 0.0 * step0};
  double vy[3] = {x0b, x0b + 0.0 * step1, x0b + step1};
  double vf[3];
  for (int v = 0; v < 3; ++v) vf[v] = anc.f(vx[v], vy[v]);
  sort3(vx, vy, vf);

  int it = 0;
  while (it < maxiter && !converged(vx, vy, vf, xatol, fatol)) {
    const double xbx = (vx[0] + vx[1]) / 2.0;
    const double xby = (vy[0] + vy[1]) / 2.0;
    const double xrx = (1.0 + RHO) * xbx - RHO * vx[2];
    const double xry = (1.0 + RHO) * xby - RHO * vy[2];
    const double fxr = anc.f(xrx, xry);
    const bool best = fxr < vf[0];
    const bool good = fxr < vf[1];
    const bool worse = fxr < vf[2];
    double nx = xrx, ny = xry, nf = fxr;
    bool shrink = false;
    if (best) {
      const double xex = (1.0 + RHO * CHI) * xbx - RHO * CHI * vx[2];
      const double xey = (1.0 + RHO * CHI) * xby - RHO * CHI * vy[2];
      const double fxe = anc.f(xex, xey);
      if (fxe < fxr) {
        nx = xex;
        ny = xey;
        nf = fxe;
      }
    } else if (!good && worse) {
      const double xcx = (1.0 + PSI * RHO) * xbx - PSI * RHO * vx[2];
      const double xcy = (1.0 + PSI * RHO) * xby - PSI * RHO * vy[2];
      const double fxc = anc.f(xcx, xcy);
      if (fxc <= fxr) {
        nx = xcx;
        ny = xcy;
        nf = fxc;
      } else {
        shrink = true;
      }
    } else if (!good) {
      const double xccx = (1.0 - PSI) * xbx + PSI * vx[2];
      const double xccy = (1.0 - PSI) * xby + PSI * vy[2];
      const double fxcc = anc.f(xccx, xccy);
      if (fxcc < vf[2]) {
        nx = xccx;
        ny = xccy;
        nf = fxcc;
      } else {
        shrink = true;
      }
    }
    if (shrink) {
      for (int v = 1; v < 3; ++v) {
        vx[v] = vx[0] + SIGMA * (vx[v] - vx[0]);
        vy[v] = vy[0] + SIGMA * (vy[v] - vy[0]);
        vf[v] = anc.f(vx[v], vy[v]);
      }
    } else {
      vx[2] = nx;
      vy[2] = ny;
      vf[2] = nf;
    }
    sort3(vx, vy, vf);
    it += 1;
  }
  if (lane == 0) {
    xy_out[2 * lane_id] = vx[0];
    xy_out[2 * lane_id + 1] = vy[0];
    f_out[lane_id] = vf[0];
    capped_out[lane_id] =
        (it >= maxiter && !converged(vx, vy, vf, xatol, fatol)) ? 1 : 0;
  }
}

}  // namespace

void pw::nm_xy(const double* coords, const double* vdw, const double* zanchor,
               const double* half, double* xy, double* f, uint8_t* capped,
               int L, int N, int brute_ns, int maxiter, double xatol,
               double fatol, void* stream) {
  if (L <= 0) return;
  const size_t smem = static_cast<size_t>(CTX) * N * sizeof(double);
  pw::allow_smem(nm_xy_kernel, smem);
  nm_xy_kernel<<<L, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      coords, vdw, zanchor, half, xy, f, capped, N, brute_ns, maxiter, xatol,
      fatol);
}
