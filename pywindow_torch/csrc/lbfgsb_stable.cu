// lbfgsb_stable: the whole stable (symbolic-difference, delta-space)
// L-BFGS-B per lane, for the pore centre (d = 3) and the window z
// (d = 1), in double precision.
//
// Replaces pywindow_tpu/ops/lbfgsb_pallas.py::lbfgsb_stable_flat (body
// lbfgsb_stable_kernel_body), which the JAX package reaches through
// pore_centres_pallas and z_opt_stable_pallas.  Semantics are those of
// the plain driver pywindow_torch/ops/lbfgsb.py::lbfgsb_minimize_stable
// (scipy's L-BFGS-B as utilities.py:400-426 and :1301-1305 call it):
// generalized Cauchy point, the 3.0 subspace step, dcsrch/dcstep with
// the lnsrlb step rules, the mainlb restart machinery and termination
// tests, and scipy's FD step with the 1-sided bound adjustment.  Every
// sum, product and comparison follows the plain driver's order of
// operations (built with -fmad=false), and the clearance probes are
// min-reductions, exact in any order, so a lane stops where the plain
// driver's lane stops.
//
// Objective: f(u) = sign * 2 * clearance(p(u)), p(u) = origin + emb(u)
// with the static embedding emb = identity (d = 3) or the z axis
// (d = 1).  Differences f(p + s) - f(p) are taken symbolically per atom
// as (2 s.(p - a) + |s|^2) / (|p + s - a| + |p - a|) (geometry.py's
// clearance_diff), so the FD gradient with h = 1e-8 sees no
// cancellation.
//
// What bounds it: a lane is a long chain of dependent scalar decisions
// (tens of iterations, each a line search of 1-20 evaluations), and each
// evaluation is 1-3 passes over the molecule's atoms with a sqrt and a
// divide per atom in double precision.  So the kernel is latency-bound
// per lane and throughput-bound in double-precision sqrt/divide over a
// batch; it moves almost no memory.  Design: one warp per lane (one
// block of 32 threads); the lane's molecule (N x 4 doubles, 15 KB for
// 468 atoms) is staged in shared memory; every thread runs the scalar
// state machine redundantly, so decisions need no broadcast, and the
// threads split the atoms of each clearance pass, reduced by warp
// shuffles that leave the same minimum in every thread.
#include <cuda_runtime.h>

#include "kernels.h"
#include "sweep.cuh"

namespace {

constexpr int MAXCOR = 10;  // scipy maxcor default; the history limit
constexpr double FTOL = 1e-3;
constexpr double GTOL = 0.9;
constexpr double XTOL = 0.1;
constexpr double XTRAPL = 1.1;
constexpr double XTRAPU = 4.0;
constexpr double EPS64 = 2.220446049250313e-16;
constexpr double BIG = 1e30;    // cauchy / subsm sentinel
constexpr double BIG10 = 1e10;  // lnsrlb sentinel (behaviourally live)

// torch.maximum / torch.minimum: NaN-propagating, unlike fmax/fmin
__device__ __forceinline__ double tmax(double a, double b) {
  return (isnan(a) || isnan(b)) ? (a + b) : (a > b ? a : b);
}
__device__ __forceinline__ double tmin(double a, double b) {
  return (isnan(a) || isnan(b)) ? (a + b) : (a < b ? a : b);
}
__device__ __forceinline__ double tsign(double a) {
  return a > 0.0 ? 1.0 : (a < 0.0 ? -1.0 : a);
}
__device__ __forceinline__ double warp_min(double v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmin(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

template <int D>
__device__ __forceinline__ double dot(const double* a, const double* b) {
  double acc = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < D; ++i) acc = acc + a[i] * b[i];
  return acc;
}

template <int D>
__device__ __forceinline__ void matvec(const double (&bm)[D][D],
                                       const double* v, double* out) {
#pragma unroll
  for (int i = 0; i < D; ++i) out[i] = dot<D>(bm[i], v);
}

// The lane's problem: molecule in shared memory, embedding, bounds.
template <int D>
struct Problem {
  const double* sx;
  const double* sy;
  const double* sz;
  const double* sr;
  int n;
  int lane;
  double org[3];
  double lo[D];
  double up[D];
  double sign2;  // sign * 2
  double fd_step;

  // p(u) = origin + emb(u), emb written out as a 3-vector
  __device__ void point3(const double* u, double* p) const {
    double e[3];
    embed(u, e);
    p[0] = org[0] + e[0];
    p[1] = org[1] + e[1];
    p[2] = org[2] + e[2];
  }
  __device__ void embed(const double* s, double* e) const {
    if (D == 3) {
      e[0] = s[0];
      e[1] = s[1];
      e[2] = s[2];
    } else {
      e[0] = 0.0;
      e[1] = 0.0;
      e[2] = s[0];
    }
  }

  // clearance min_i(|p - a_i| - r_i)
  __device__ double clearance(const double* p) const {
    double c = BIG;
    for (int a = lane; a < n; a += 32) {
      const double d0 = p[0] - sx[a];
      const double d1 = p[1] - sy[a];
      const double d2 = p[2] - sz[a];
      c = fmin(c, sqrt(d0 * d0 + d1 * d1 + d2 * d2) - sr[a]);
    }
    return warp_min(c);
  }

  // min_i((c_i - m0) + delta_i(s_k)) at p, for K displacements s_k (3-D)
  template <int K>
  __device__ void diff_min(const double* p, double m0, const double (&s)[K][3],
                           double* out) const {
    double best[K];
#pragma unroll
    for (int k = 0; k < K; ++k) best[k] = BIG;
    for (int a = lane; a < n; a += 32) {
      const double d0 = p[0] - sx[a];
      const double d1 = p[1] - sy[a];
      const double d2 = p[2] - sz[a];
      const double db2 = d0 * d0 + d1 * d1 + d2 * d2;
      const double db = sqrt(db2);
      const double base = (db - sr[a]) - m0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const double g = s[k][0] * d0 + s[k][1] * d1 + s[k][2] * d2;
        const double s2 = s[k][0] * s[k][0] + s[k][1] * s[k][1] + s[k][2] * s[k][2];
        const double num = 2.0 * g + s2;
        const double dp = sqrt(tmax(db2 + num, 0.0));
        const double den = db + dp;
        const double delta = num / (den == 0.0 ? 1.0 : den);
        best[k] = fmin(best[k], base + delta);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = warp_min(best[k]);
  }

  __device__ double f_abs(const double* u) const {
    double p[3];
    point3(u, p);
    return sign2 * clearance(p);
  }

  // scipy's FD step at q: absolute fd_step, 1-sided bound adjustment
  __device__ void fd_h(const double* q, double* h) const {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      double hk = fd_step;
      const double lower_dist = q[k] - lo[k];
      const double upper_dist = up[k] - q[k];
      const bool violated = upper_dist < hk;
      const bool fitting = fabs(hk) <= tmax(lower_dist, upper_dist);
      if (violated && fitting) hk = -hk;
      if (!fitting && upper_dist >= lower_dist) hk = upper_dist;
      if (!fitting && upper_dist < lower_dist) hk = -lower_dist;
      h[k] = hk;
    }
  }

  // FD gradient at q with steps h
  __device__ void grad(const double* q, const double* h, double* g) const {
    double p[3];
    point3(q, p);
    const double m0 = clearance(p);
    double s[D][3];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      double e[D];
#pragma unroll
      for (int j = 0; j < D; ++j) e[j] = (j == k) ? h[k] : 0.0;
      embed(e, s[k]);
    }
    double out[D];
    diff_min<D>(p, m0, s, out);
#pragma unroll
    for (int k = 0; k < D; ++k) g[k] = (sign2 * out[k]) / h[k];
  }

  // (f(x + disp) - f(x), FD gradient at x + disp); m0x = clearance at x
  __device__ double phi(const double* x, double m0x, const double* dvec,
                        double stp, double* gvec) const {
    double disp[D], q[D], h[D], px[3];
#pragma unroll
    for (int k = 0; k < D; ++k) disp[k] = stp * dvec[k];
#pragma unroll
    for (int k = 0; k < D; ++k) q[k] = x[k] + disp[k];
    fd_h(q, h);
    point3(x, px);
    double s[1][3];
    embed(disp, s[0]);
    double delta;
    diff_min<1>(px, m0x, s, &delta);
    grad(q, h, gvec);
    return sign2 * delta;
  }

  __device__ double pg_max(const double* x, const double* g) const {
    double best = 0.0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const double proj = tmin(tmax(x[k] - g[k], lo[k]), up[k]);
      const double v = fabs(x[k] - proj);
      best = (k == 0) ? v : tmax(best, v);
    }
    return best;
  }
};

// ---- dcstep / dcsrch (pywindow_torch/ops/lbfgsb.py) ---------------------

struct Step {
  double stx, fx, dx, sty, fy, dy, stp;
  bool brackt;
};

__device__ __forceinline__ double safe_div(double p, double q) {
  return p / (q == 0.0 ? 1e-300 : q);
}

__device__ double cubic_gamma(double theta, double da, double db, bool flip) {
  const double s = tmax(tmax(fabs(theta), fabs(da)), fabs(db));
  const double t = theta / s;
  const double g = s * sqrt(tmax(t * t - (da / s) * (db / s), 0.0));
  return flip ? -g : g;
}

__device__ Step dcstep(const Step& st, double fp, double dp, double stpmin,
                       double stpmax) {
  const double stx = st.stx, fx = st.fx, dx = st.dx;
  const double sty = st.sty, fy = st.fy, dy = st.dy, stp = st.stp;
  const bool brackt = st.brackt;
  const double sgnd = dp * tsign(dx);
  const bool case1 = fp > fx;
  const bool case2 = !case1 && (sgnd < 0.0);
  const bool case3 = !case1 && !case2 && (fabs(dp) < fabs(dx));
  const double theta1 = 3.0 * (fx - fp) * safe_div(1.0, stp - stx) + dx + dp;

  double stpf;
  if (case1) {
    const double gamma1 = cubic_gamma(theta1, dx, dp, stp < stx);
    const double p1 = (gamma1 - dx) + theta1;
    const double q1 = ((gamma1 - dx) + gamma1) + dp;
    const double stpc1 = stx + safe_div(p1, q1) * (stp - stx);
    const double stpq1 =
        stx + (safe_div(dx, safe_div(fx - fp, stp - stx) + dx) / 2.0) * (stp - stx);
    stpf = (fabs(stpc1 - stx) < fabs(stpq1 - stx)) ? stpc1
                                                   : stpc1 + (stpq1 - stpc1) / 2.0;
  } else if (case2) {
    const double gamma2 = cubic_gamma(theta1, dx, dp, stp > stx);
    const double p2 = (gamma2 - dp) + theta1;
    const double q2 = ((gamma2 - dp) + gamma2) + dx;
    const double stpc2 = stp + safe_div(p2, q2) * (stx - stp);
    const double stpq2 = stp + safe_div(dp, dp - dx) * (stx - stp);
    stpf = (fabs(stpc2 - stp) > fabs(stpq2 - stp)) ? stpc2 : stpq2;
  } else if (case3) {
    const double gamma3 = cubic_gamma(theta1, dx, dp, stp > stx);
    const double p3 = (gamma3 - dp) + theta1;
    const double q3 = (gamma3 + (dx - dp)) + gamma3;
    const double r3 = safe_div(p3, q3);
    const double stpc3 = (r3 < 0.0 && gamma3 != 0.0)
                             ? stp + r3 * (stx - stp)
                             : (stp > stx ? stpmax : stpmin);
    const double stpq3 = stp + safe_div(dp, dp - dx) * (stx - stp);
    if (brackt) {
      const double c = (fabs(stpc3 - stp) < fabs(stpq3 - stp)) ? stpc3 : stpq3;
      const double lim = stp + 0.66 * (sty - stp);
      stpf = (stp > stx) ? tmin(lim, c) : tmax(lim, c);
    } else {
      const double c = (fabs(stpc3 - stp) > fabs(stpq3 - stp)) ? stpc3 : stpq3;
      stpf = tmin(tmax(c, stpmin), stpmax);
    }
  } else {
    const double theta4 = 3.0 * (fp - fy) * safe_div(1.0, sty - stp) + dy + dp;
    const double gamma4 = cubic_gamma(theta4, dy, dp, stp > sty);
    const double p4 = (gamma4 - dp) + theta4;
    const double q4 = ((gamma4 - dp) + gamma4) + dy;
    const double stpc4 = stp + safe_div(p4, q4) * (sty - stp);
    stpf = brackt ? stpc4 : (stp > stx ? stpmax : stpmin);
  }

  const bool opposite = sgnd < 0.0;
  Step out;
  out.stx = case1 ? stx : stp;
  out.fx = case1 ? fx : fp;
  out.dx = case1 ? dx : dp;
  out.sty = case1 ? stp : (opposite ? stx : sty);
  out.fy = case1 ? fp : (opposite ? fx : fy);
  out.dy = case1 ? dp : (opposite ? dx : dy);
  out.stp = stpf;
  out.brackt = brackt || case1 || case2;
  return out;
}

// dcsrch in delta space (f0 = 0); returns whether the search failed.
template <int D>
__device__ bool dcsrch(const Problem<D>& pr, const double* x, double m0x,
                       const double* dvec, const double* g_vec0, double stp0,
                       double stpmax, int maxfev, double& stp_out,
                       double& f_out, double* g_out) {
  const double f0 = 0.0;
  const double stpmin = 0.0;
  const double g0 = dot<D>(g_vec0, dvec);
  const double gtest = FTOL * g0;
  Step st{0.0, f0, g0, 0.0, f0, g0, stp0, false};
  bool stage1 = true;
  double stmin = 0.0;
  double stmax = stp0 + XTRAPU * stp0;
  double width = stpmax - stpmin;
  double width1 = (stpmax - stpmin) / 0.5;
  int nfev = 1;
  bool done = false;
  bool conv = false;
  double gvec[D];
  double f = pr.phi(x, m0x, dvec, stp0, gvec);

  while (!done && nfev < maxfev + 1) {
    const double stp = st.stp;
    const double g = dot<D>(gvec, dvec);
    const double ftest = f0 + stp * gtest;
    const bool stage1_n = stage1 && !((f <= ftest) && (g >= 0.0));
    const bool converged = (f <= ftest) && (fabs(g) <= GTOL * (-g0));
    const bool warn = (st.brackt && ((stp <= stmin) || (stp >= stmax))) ||
                      (st.brackt && (stmax - stmin <= XTOL * stmax)) ||
                      ((stp == stpmax) && (f <= ftest) && (g <= gtest)) ||
                      ((stp == stpmin) && ((f > ftest) || (g >= gtest)));
    if (converged) conv = true;
    if (converged || warn) {
      done = true;
      break;
    }
    const bool use_mod = stage1_n && (f <= st.fx) && (f > ftest);
    Step nw;
    if (use_mod) {
      Step sm = st;
      sm.fx = st.fx - st.stx * gtest;
      sm.dx = st.dx - gtest;
      sm.fy = st.fy - st.sty * gtest;
      sm.dy = st.dy - gtest;
      nw = dcstep(sm, f - stp * gtest, g - gtest, stmin, stmax);
      nw.fx = nw.fx + nw.stx * gtest;
      nw.fy = nw.fy + nw.sty * gtest;
      nw.dx = nw.dx + gtest;
      nw.dy = nw.dy + gtest;
    } else {
      nw = dcstep(st, f, g, stmin, stmax);
    }
    // bisection safeguard
    const double span = fabs(nw.sty - nw.stx);
    const bool bisect = nw.brackt && (span >= 0.66 * width1);
    double stp_n = bisect ? nw.stx + 0.5 * (nw.sty - nw.stx) : nw.stp;
    const double width1_n = nw.brackt ? width : width1;
    const double width_n = nw.brackt ? span : width;
    const double stmin_n =
        nw.brackt ? tmin(nw.stx, nw.sty) : stp_n + XTRAPL * (stp_n - nw.stx);
    const double stmax_n =
        nw.brackt ? tmax(nw.stx, nw.sty) : stp_n + XTRAPU * (stp_n - nw.stx);
    stp_n = tmin(tmax(stp_n, stpmin), stpmax);
    const bool force_stx =
        (nw.brackt && ((stp_n <= stmin_n) || (stp_n >= stmax_n))) ||
        (nw.brackt && (stmax_n - stmin_n <= XTOL * stmax_n));
    if (force_stx) stp_n = nw.stx;
    nw.stp = stp_n;

    f = pr.phi(x, m0x, dvec, stp_n, gvec);
    st = nw;
    stage1 = stage1_n;
    stmin = stmin_n;
    stmax = stmax_n;
    width = width_n;
    width1 = width1_n;
    nfev += 1;
  }
  // entry errors are task='ERROR' in the Fortran -> mainlb's restarts
  const bool entry_error = (g0 >= 0.0) || (stp0 > stpmax) || (stp0 < stpmin);
  stp_out = st.stp;
  f_out = f;
#pragma unroll
  for (int k = 0; k < D; ++k) g_out[k] = gvec[k];
  return !(done || conv) || entry_error;
}

// ---- Cauchy point, subspace step, B matrix ------------------------------

template <int D>
__device__ void build_b(const double (&sh)[MAXCOR][D],
                        const double (&yh)[MAXCOR][D], int col, double theta,
                        double (&bm)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) bm[i][j] = theta * (i == j ? 1.0 : 0.0);
  }
  for (int k = 0; k < col; ++k) {
    double bs[D];
    matvec<D>(bm, sh[k], bs);
    const double sbs = dot<D>(sh[k], bs);
    const double sy = dot<D>(sh[k], yh[k]);
    const double sbs_s = (sbs == 0.0) ? 1.0 : sbs;
    const double sy_s = (sy == 0.0) ? 1.0 : sy;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        bm[i][j] = bm[i][j] - (bs[i] * bs[j]) / sbs_s + (yh[k][i] * yh[k][j]) / sy_s;
      }
    }
  }
}

// first index of the minimum (strict <), as torch.argmin
template <int D>
__device__ __forceinline__ int argmin(const double* v) {
  int idx = 0;
#pragma unroll
  for (int k = 1; k < D; ++k) {
    if (v[k] < v[idx]) idx = k;
  }
  return idx;
}

template <int D>
__device__ void cauchy(const Problem<D>& pr, const double* x, const double* g,
                       const double (&bm)[D][D], double theta, double epsmch,
                       double* xcp_z, bool* moving) {
  double t_break[D], dvec[D], z[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const double safe_g = (g[k] == 0.0) ? 1.0 : g[k];
    t_break[k] = g[k] > 0.0 ? (x[k] - pr.lo[k]) / safe_g
                            : (g[k] < 0.0 ? (x[k] - pr.up[k]) / safe_g : BIG);
    moving[k] = t_break[k] > 0.0;
    dvec[k] = moving[k] ? -g[k] : 0.0;
    z[k] = 0.0;
    xcp_z[k] = 0.0;
  }
  const double f2_org = theta * dot<D>(dvec, dvec);
  bool found = false;
  double t_old = 0.0;
  for (int it = 0; it < D + 1; ++it) {
    double bd[D];
    matvec<D>(bm, dvec, bd);
    const double f1 = dot<D>(g, dvec) + dot<D>(z, bd);
    const double f2 = tmax(dot<D>(dvec, bd), epsmch * f2_org);
    const double dtm = -f1 / (f2 == 0.0 ? 1.0 : f2);
    double t_cand[D];
#pragma unroll
    for (int k = 0; k < D; ++k) t_cand[k] = moving[k] ? t_break[k] : BIG;
    const int b = argmin<D>(t_cand);
    const double t_next = t_cand[b];
    const double dt = t_next - t_old;
    const bool inside = (dtm < dt) || (t_next >= BIG);
    const bool freeze = found || inside;
    if (!found && inside) {
      const double step = tmax(dtm, 0.0);
#pragma unroll
      for (int k = 0; k < D; ++k) xcp_z[k] = z[k] + step * dvec[k];
    }
    if (!freeze) {
      const double zb = (dvec[b] > 0.0 ? pr.up[b] : pr.lo[b]) - x[b];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        z[k] = (k == b) ? zb : z[k] + dt * dvec[k];
      }
      dvec[b] = 0.0;
      moving[b] = false;
      t_old = t_next;
    }
    found = found || inside;
  }
}

template <int D>
__device__ void solve_small(const double (&a)[D][D], const double* rhs,
                            double* out) {
  if (D == 1) {
    out[0] = rhs[0] / a[0][0];
    return;
  }
  // d = 3: adjugate (cofactor columns as rows) times rhs, over det
  const double c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  const double c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2];
  const double c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  const double det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02;
  const double c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2];
  const double c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0];
  const double c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1];
  const double c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1];
  const double c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2];
  const double c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0];
  out[0] = (c00 * rhs[0] + c10 * rhs[1] + c20 * rhs[2]) / det;
  out[1] = (c01 * rhs[0] + c11 * rhs[1] + c21 * rhs[2]) / det;
  out[2] = (c02 * rhs[0] + c12 * rhs[1] + c22 * rhs[2]) / det;
}

template <int D>
__device__ void subsm(const Problem<D>& pr, const double* x, const double* g,
                      const double (&bm)[D][D], const double* xcp,
                      const bool* free, double* z_out) {
  double freef[D], diff[D], bdiff[D], r[D], rhs[D], dsub[D];
  bool any_free = false;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    freef[k] = free[k] ? 1.0 : 0.0;
    diff[k] = xcp[k] - x[k];
    any_free = any_free || free[k];
  }
  matvec<D>(bm, diff, bdiff);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    r[k] = g[k] + bdiff[k];
    rhs[k] = -(r[k] * freef[k]);
  }
  double bmod[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      bmod[i][j] = bm[i][j] * (freef[i] * freef[j]) + (i == j ? 1.0 - freef[i] : 0.0);
    }
  }
  solve_small<D>(bmod, rhs, dsub);
#pragma unroll
  for (int k = 0; k < D; ++k) dsub[k] = dsub[k] * freef[k];

  double zt[D], zproj[D], pd[D], cand[D];
  bool iword = false;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    zt[k] = xcp[k] + dsub[k];
    iword = iword || (free[k] && ((zt[k] < pr.lo[k]) || (zt[k] > pr.up[k])));
    zproj[k] = tmin(tmax(zt[k], pr.lo[k]), pr.up[k]);
    pd[k] = zproj[k] - x[k];
  }
  const double dd_p = dot<D>(pd, g);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const double safe_d = (dsub[k] == 0.0) ? 1.0 : dsub[k];
    const double low_gap = pr.lo[k] - xcp[k];
    const double up_gap = pr.up[k] - xcp[k];
    double c = (free[k] && dsub[k] < 0.0)
                   ? (low_gap >= 0.0 ? 0.0 : low_gap / safe_d)
                   : BIG;
    if (free[k] && dsub[k] > 0.0) c = (up_gap <= 0.0) ? 0.0 : up_gap / safe_d;
    cand[k] = c;
  }
  const int ibd = argmin<D>(cand);
  const double alpha = tmin(cand[ibd], 1.0);
  const double bound_b = dsub[ibd] > 0.0 ? pr.up[ibd] : pr.lo[ibd];
  const bool use_alpha = iword && (dd_p > 0.0);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    double za = xcp[k] + alpha * dsub[k];
    if (alpha < 1.0 && k == ibd) za = bound_b;
    const double zk = use_alpha ? za : zproj[k];
    z_out[k] = any_free ? zk : xcp[k];
  }
}

// ---- mainlb ---------------------------------------------------------------

template <int D>
__global__ void lbfgsb_kernel(const double* __restrict__ coords,
                              const double* __restrict__ vdw,
                              const double* __restrict__ origin,
                              const double* __restrict__ x0,
                              const double* __restrict__ lower,
                              const double* __restrict__ upper,
                              double* __restrict__ x_out,
                              double* __restrict__ fun_out,
                              int32_t* __restrict__ nit_out,
                              uint8_t* __restrict__ conv_out,
                              uint8_t* __restrict__ capped_out, int N,
                              pw::LbfgsbParams prm) {
  extern __shared__ unsigned char smem_raw[];
  double* sx = reinterpret_cast<double*>(smem_raw);
  double* sy = sx + N;
  double* sz = sy + N;
  double* sr = sz + N;
  const int b = blockIdx.x;
  pw::stage_atoms(coords + static_cast<size_t>(b) * N * 3,
                  vdw + static_cast<size_t>(b) * N, N, sx, sy, sz, sr);

  Problem<D> pr;
  pr.sx = sx;
  pr.sy = sy;
  pr.sz = sz;
  pr.sr = sr;
  pr.n = N;
  pr.lane = threadIdx.x;
  pr.sign2 = prm.sign * 2.0;
  pr.fd_step = prm.fd_step;
  for (int c = 0; c < 3; ++c) pr.org[c] = origin[3 * b + c];
  double x[D];
  bool boxed = true;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    pr.lo[k] = lower[D * b + k];
    pr.up[k] = upper[D * b + k];
    x[k] = tmin(tmax(x0[D * b + k], pr.lo[k]), pr.up[k]);
    boxed = boxed && (fabs(pr.lo[k]) < 1e9) && (fabs(pr.up[k]) < 1e9);
  }
  const double tol = prm.factr * EPS64;
  const double epsmch = EPS64;  // finfo(float64).eps
  const int m = prm.m;

  double fx = pr.f_abs(x);
  double g[D], h0[D];
  pr.fd_h(x, h0);
  {
    double xq[D];
#pragma unroll
    for (int k = 0; k < D; ++k) xq[k] = x[k] + 0.0;
    pr.grad(xq, h0, g);
  }

  double sh[MAXCOR][D], yh[MAXCOR][D];
  for (int r = 0; r < MAXCOR; ++r) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      sh[r][k] = 0.0;
      yh[r][k] = 0.0;
    }
  }
  double theta = 1.0;
  int n_pairs = 0, it = 0, trips = 0;
  bool done = false, conv = false;

  while (!done && it < prm.maxiter && trips < 2 * prm.maxiter + 4 &&
         pr.pg_max(x, g) > prm.pgtol) {
    const int col = min(n_pairs, m);
    double bm[D][D];
    build_b<D>(sh, yh, col, theta, bm);
    double xcp_z[D], xcp[D], z[D], dvec[D];
    bool free[D];
    cauchy<D>(pr, x, g, bm, theta, epsmch, xcp_z, free);
#pragma unroll
    for (int k = 0; k < D; ++k) xcp[k] = x[k] + xcp_z[k];
    if (col > 0) {
      subsm<D>(pr, x, g, bm, xcp, free, z);
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) z[k] = xcp[k];
    }
#pragma unroll
    for (int k = 0; k < D; ++k) dvec[k] = z[k] - x[k];
    const double dnorm = sqrt(dot<D>(dvec, dvec));
    const double gd_old = dot<D>(g, dvec);

    // lnsrlb step rules
    double to_bound = 0.0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const double safe_d = (dvec[k] == 0.0) ? 1.0 : dvec[k];
      const double t = dvec[k] > 0.0 ? (pr.up[k] - x[k]) / safe_d
                                     : (dvec[k] < 0.0 ? (pr.lo[k] - x[k]) / safe_d
                                                      : BIG10);
      to_bound = (k == 0) ? t : tmin(to_bound, t);
    }
    const bool first = it == 0;
    const double stpmx = first ? 1.0 : tmin(to_bound, BIG10);
    const double inv_dnorm = 1.0 / (dnorm == 0.0 ? 1.0 : dnorm);
    const double stp0 = (first && !boxed) ? tmin(inv_dnorm, stpmx) : 1.0;

    double px[3];
    pr.point3(x, px);
    const double m0x = pr.clearance(px);
    double stp, fdelta, gn[D];
    const bool ls_failed =
        dcsrch<D>(pr, x, m0x, dvec, g, stp0, stpmx, prm.maxls, stp, fdelta, gn);

    double xn[D];
    bool stalled = true;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      xn[k] = x[k] + stp * dvec[k];
      stalled = stalled && (xn[k] == x[k]);
    }
    const bool pg_done = pr.pg_max(xn, gn) <= prm.pgtol;
    double fn = fx + fdelta;
    const double reduction = -fdelta;
    const bool f_red = reduction <= tol * tmax(tmax(fabs(fx), fabs(fn)), 1.0);
    const bool step_ok = !ls_failed;
    const bool new_conv = step_ok && (pg_done || f_red || stalled);

    // curvature pair update (mainlb dr/ddum + matupd)
    const double gd = dot<D>(gn, dvec);
    const bool one_step = stp == 1.0;
    const double dr = one_step ? gd - gd_old : (gd - gd_old) * stp;
    const double ddum = one_step ? -gd_old : -gd_old * stp;
    const bool store = step_ok && (dr > EPS64 * ddum);
    double s[D], y[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      s[k] = stp * dvec[k];
      y[k] = gn[k] - g[k];
    }
    int n_pairs_n = n_pairs;
    double theta_n = theta;
    if (store) {
      if (n_pairs >= m) {  // shift left, newest last
        for (int r = 0; r < m - 1; ++r) {
#pragma unroll
          for (int k = 0; k < D; ++k) {
            sh[r][k] = sh[r + 1][k];
            yh[r][k] = yh[r + 1][k];
          }
        }
#pragma unroll
        for (int k = 0; k < D; ++k) {
          sh[m - 1][k] = s[k];
          yh[m - 1][k] = y[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          sh[n_pairs][k] = s[k];
          yh[n_pairs][k] = y[k];
        }
      }
      n_pairs_n = n_pairs + 1;
      theta_n = dot<D>(y, y) / (dr == 0.0 ? 1.0 : dr);
    }
    // restart machinery: a failed search with stored pairs wipes the
    // memory and retries from the same iterate; with none it terminates
    const bool restart = ls_failed && (col > 0);
    const bool fatal = ls_failed && (col == 0);
    if (restart) {
      n_pairs_n = 0;
      theta_n = 1.0;
    }
    if (!ls_failed) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        x[k] = xn[k];
        g[k] = gn[k];
      }
      fx = fn;
      it += 1;
    }
    theta = theta_n;
    n_pairs = n_pairs_n;
    trips += 1;
    conv = conv || new_conv;
    done = done || new_conv || fatal;
  }

  const bool pg_small = pr.pg_max(x, g) <= prm.pgtol;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) x_out[D * b + k] = x[k];
    fun_out[b] = fx;
    nit_out[b] = it;
    conv_out[b] = (conv || pg_small) ? 1 : 0;
    capped_out[b] = (!done && !pg_small) ? 1 : 0;
  }
}

template <int D>
void launch(const double* coords, const double* vdw, const double* origin,
            const double* x0, const double* lower, const double* upper,
            double* x, double* fun, int32_t* nit, uint8_t* conv,
            uint8_t* capped, int B, int N, const pw::LbfgsbParams& prm,
            void* stream) {
  const size_t smem = pw::sweep_smem_bytes<double>(N);
  pw::allow_smem(lbfgsb_kernel<D>, smem);
  lbfgsb_kernel<D><<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      coords, vdw, origin, x0, lower, upper, x, fun, nit, conv, capped, N,
      prm);
}

}  // namespace

void pw::lbfgsb_stable(const double* coords, const double* vdw,
                       const double* origin, const double* x0,
                       const double* lower, const double* upper, double* x,
                       double* fun, int32_t* nit, uint8_t* converged,
                       uint8_t* capped, int B, int N, int d,
                       const LbfgsbParams& params, void* stream) {
  if (B <= 0) return;
  if (d == 3) {
    launch<3>(coords, vdw, origin, x0, lower, upper, x, fun, nit, converged,
              capped, B, N, params, stream);
  } else {
    launch<1>(coords, vdw, origin, x0, lower, upper, x, fun, nit, converged,
              capped, B, N, params, stream);
  }
}
