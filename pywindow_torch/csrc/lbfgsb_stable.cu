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
// evaluation is a pass over the molecule's atoms with 6 + 2d double
// square roots and divides per atom, each a ~10-instruction Newton
// sequence on this card.  Over a batch that is well under a millisecond
// of FP64 pipe time; a call is bound by its slowest lane's latency: the
// length of the per-atom chains a thread walks, the reductions that end
// every pass, and the scalar state machine between them.  It moves almost
// no memory, and there is no matrix product, so neither the tensor cores
// nor TMA apply (a lane stages < 15 KB once).  Design:
// - a lane is one block of several warps (lbfgsb_kernels.lane_threads);
//   its molecule (N x 4 doubles) is staged in shared memory and its atoms
//   are split over all threads, so a thread walks 1-2 atoms, not 6-15;
// - every thread runs the scalar state machine redundantly, so decisions
//   need no broadcast; minima are block-wide (block_min.cuh: shuffles,
//   one slot per warp, one barrier), leaving the same value everywhere;
// - one fused sweep per line-search evaluation: the difference at x and
//   the clearance at q = x + stp d are independent and interleave, |q - a|
//   is computed once and its terms stay in registers (APT atoms a thread)
//   until m0(q) is reduced, and then the d FD differences at q finish
//   from the registers: two reductions an evaluation where there were
//   three passes and three reductions;
// - the clearance at the new iterate is the last evaluation's m0(q)
//   (x + stp d is q to the bit), so an iteration starts with no pass;
// - the curvature history is a ring in shared memory (every thread
//   writes the same values) and the state has no runtime-indexed array,
//   so nothing lives in local memory.
#include <cuda_runtime.h>

#include "block_min.cuh"
#include "kernels.h"
#include "sweep.cuh"

namespace {

constexpr int MAXCOR = 10;  // scipy maxcor default; the history limit
constexpr int MAX_THREADS = 256;
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

// (2 s.e + |s|^2) / (|e + s| + |e|) for e = p - a, |e|^2 = eb2, |e| = eb:
// the symbolic difference |p + s - a| - |p - a| (clearance_diff's order)
__device__ __forceinline__ double sym_delta(const double* s, double s2,
                                            double e0, double e1, double e2,
                                            double eb2, double eb) {
  const double g = s[0] * e0 + s[1] * e1 + s[2] * e2;
  const double num = 2.0 * g + s2;
  const double dp = sqrt(tmax(eb2 + num, 0.0));
  const double den = eb + dp;
  return num / (den == 0.0 ? 1.0 : den);
}

// The terms of |q - a| a thread keeps for its first APT atoms
// (tid + j * threads) between the two halves of an evaluation.
template <int APT>
struct QTerms {
  double d0[APT], d1[APT], d2[APT], db2[APT], db[APT], c[APT];
};

// The lane's problem: molecule in shared memory, embedding, bounds, and
// the block's reduction buffers.
template <int D, int APT>
struct Problem {
  const double* sx;
  const double* sy;
  const double* sz;
  const double* sr;
  int n;
  pw::BlockMin red;
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

  // The first half of an evaluation, one sweep over the thread's atoms:
  // the clearance terms at pq (kept in t for the first APT atoms) and,
  // with WITH_X, min_i((c_i(px) - m0x) + delta_i(sd)) at px.  Returns
  // the thread's partial minima (cq, dx).
  template <bool WITH_X>
  __device__ void sweep_q(const double* pq, const double* px, double m0x,
                          const double* sd, double s2d, QTerms<APT>& t,
                          double& cq, double& dx) const {
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    cq = BIG;
    dx = BIG;
#pragma unroll
    for (int j = 0; j < APT; ++j) {
      const int a = tid + j * nt;
      if (a < n) {
        const double ax = sx[a], ay = sy[a], az = sz[a], ar = sr[a];
        t.d0[j] = pq[0] - ax;
        t.d1[j] = pq[1] - ay;
        t.d2[j] = pq[2] - az;
        t.db2[j] = t.d0[j] * t.d0[j] + t.d1[j] * t.d1[j] + t.d2[j] * t.d2[j];
        t.db[j] = sqrt(t.db2[j]);
        t.c[j] = t.db[j] - ar;
        cq = fmin(cq, t.c[j]);
        if (WITH_X) {
          const double e0 = px[0] - ax;
          const double e1 = px[1] - ay;
          const double e2 = px[2] - az;
          const double eb2 = e0 * e0 + e1 * e1 + e2 * e2;
          const double eb = sqrt(eb2);
          const double base = (eb - ar) - m0x;
          dx = fmin(dx, base + sym_delta(sd, s2d, e0, e1, e2, eb2, eb));
        }
      }
    }
    for (int a = tid + APT * nt; a < n; a += nt) {
      const double ax = sx[a], ay = sy[a], az = sz[a], ar = sr[a];
      const double d0 = pq[0] - ax;
      const double d1 = pq[1] - ay;
      const double d2 = pq[2] - az;
      cq = fmin(cq, sqrt(d0 * d0 + d1 * d1 + d2 * d2) - ar);
      if (WITH_X) {
        const double e0 = px[0] - ax;
        const double e1 = px[1] - ay;
        const double e2 = px[2] - az;
        const double eb2 = e0 * e0 + e1 * e1 + e2 * e2;
        const double eb = sqrt(eb2);
        const double base = (eb - ar) - m0x;
        dx = fmin(dx, base + sym_delta(sd, s2d, e0, e1, e2, eb2, eb));
      }
    }
  }

  // The second half: the FD differences min_i((c_i - m0) + delta_i(s_k))
  // at pq for the D steps s_k, from the kept terms (atoms beyond the
  // cache recompute theirs, with the same operations), reduced.
  __device__ void finish_fd(const double* pq, double m0, const double* h,
                            const QTerms<APT>& t, double* g) {
    double s[D][3], s2[D], out[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      double e[D];
#pragma unroll
      for (int j = 0; j < D; ++j) e[j] = (j == k) ? h[k] : 0.0;
      embed(e, s[k]);
      s2[k] = s[k][0] * s[k][0] + s[k][1] * s[k][1] + s[k][2] * s[k][2];
      out[k] = BIG;
    }
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
#pragma unroll
    for (int j = 0; j < APT; ++j) {
      if (tid + j * nt < n) {
        const double base = t.c[j] - m0;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          out[k] = fmin(out[k], base + sym_delta(s[k], s2[k], t.d0[j], t.d1[j],
                                                 t.d2[j], t.db2[j], t.db[j]));
        }
      }
    }
    for (int a = tid + APT * nt; a < n; a += nt) {
      const double d0 = pq[0] - sx[a];
      const double d1 = pq[1] - sy[a];
      const double d2 = pq[2] - sz[a];
      const double db2 = d0 * d0 + d1 * d1 + d2 * d2;
      const double db = sqrt(db2);
      const double base = (db - sr[a]) - m0;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        out[k] = fmin(out[k], base + sym_delta(s[k], s2[k], d0, d1, d2, db2, db));
      }
    }
    red(out);
#pragma unroll
    for (int k = 0; k < D; ++k) g[k] = (sign2 * out[k]) / h[k];
  }

  // FD gradient at q with steps h; returns the clearance at q
  __device__ double grad(const double* q, const double* h, double* g) {
    double pq[3];
    point3(q, pq);
    QTerms<APT> t;
    double cq[1], dx;
    sweep_q<false>(pq, pq, 0.0, pq, 0.0, t, cq[0], dx);
    red(cq);
    finish_fd(pq, cq[0], h, t, g);
    return cq[0];
  }

  // (f(x + disp) - f(x), FD gradient at q = x + disp, clearance at q);
  // m0x = clearance at x
  __device__ double phi(const double* x, double m0x, const double* dvec,
                        double stp, double* gvec, double& m0q) {
    double disp[D], q[D], h[D], px[3], pq[3], sd[3];
#pragma unroll
    for (int k = 0; k < D; ++k) disp[k] = stp * dvec[k];
#pragma unroll
    for (int k = 0; k < D; ++k) q[k] = x[k] + disp[k];
    fd_h(q, h);
    point3(x, px);
    point3(q, pq);
    embed(disp, sd);
    const double s2d = sd[0] * sd[0] + sd[1] * sd[1] + sd[2] * sd[2];
    QTerms<APT> t;
    double v[2];
    sweep_q<true>(pq, px, m0x, sd, s2d, t, v[1], v[0]);
    red(v);
    m0q = v[1];
    finish_fd(pq, m0q, h, t, gvec);
    return sign2 * v[0];
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
// m0_out: the clearance at x + stp_out * dvec (the last evaluation's q).
template <int D, int APT>
__device__ bool dcsrch(Problem<D, APT>& pr, const double* x, double m0x,
                       const double* dvec, const double* g_vec0, double stp0,
                       double stpmax, int maxfev, double& stp_out,
                       double& f_out, double* g_out, double& m0_out) {
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
  double m0q;
  double f = pr.phi(x, m0x, dvec, stp0, gvec, m0q);

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

    f = pr.phi(x, m0x, dvec, stp_n, gvec, m0q);
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
  m0_out = m0q;
#pragma unroll
  for (int k = 0; k < D; ++k) g_out[k] = gvec[k];
  return !(done || conv) || entry_error;
}

// ---- Cauchy point, subspace step, B matrix ------------------------------

// B from theta * I and the col newest pairs of the history ring (slot of
// the oldest: head), oldest first
template <int D>
__device__ void build_b(const double* hs, const double* hy, int head, int col,
                        int m, double theta, double (&bm)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) bm[i][j] = theta * (i == j ? 1.0 : 0.0);
  }
  for (int k = 0; k < col; ++k) {
    int slot = head + k;
    if (slot >= m) slot -= m;
    double sk[D], yk[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      sk[i] = hs[slot * D + i];
      yk[i] = hy[slot * D + i];
    }
    double bs[D];
    matvec<D>(bm, sk, bs);
    const double sbs = dot<D>(sk, bs);
    const double sy = dot<D>(sk, yk);
    const double sbs_s = (sbs == 0.0) ? 1.0 : sbs;
    const double sy_s = (sy == 0.0) ? 1.0 : sy;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        bm[i][j] = bm[i][j] - (bs[i] * bs[j]) / sbs_s + (yk[i] * yk[j]) / sy_s;
      }
    }
  }
}

// first index of the minimum (strict <), as torch.argmin, and the value
template <int D>
__device__ __forceinline__ int argmin(const double* v, double& vmin) {
  int idx = 0;
  vmin = v[0];
#pragma unroll
  for (int k = 1; k < D; ++k) {
    if (v[k] < vmin) {
      idx = k;
      vmin = v[k];
    }
  }
  return idx;
}

// v[idx] for a runtime idx, as a select chain (no local memory)
template <int D>
__device__ __forceinline__ double pick(const double* v, int idx) {
  double out = v[0];
#pragma unroll
  for (int k = 1; k < D; ++k) {
    if (k == idx) out = v[k];
  }
  return out;
}

template <int D, int APT>
__device__ void cauchy(const Problem<D, APT>& pr, const double* x,
                       const double* g, const double (&bm)[D][D],
                       double theta, double epsmch, double* xcp_z,
                       bool* moving) {
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
    double t_next;
    const int b = argmin<D>(t_cand, t_next);
    const double dt = t_next - t_old;
    const bool inside = (dtm < dt) || (t_next >= BIG);
    const bool freeze = found || inside;
    if (!found && inside) {
      const double step = tmax(dtm, 0.0);
#pragma unroll
      for (int k = 0; k < D; ++k) xcp_z[k] = z[k] + step * dvec[k];
    }
    if (!freeze) {
      const double zb = (pick<D>(dvec, b) > 0.0 ? pick<D>(pr.up, b) : pick<D>(pr.lo, b)) -
                        pick<D>(x, b);
#pragma unroll
      for (int k = 0; k < D; ++k) {
        z[k] = (k == b) ? zb : z[k] + dt * dvec[k];
        if (k == b) {
          dvec[k] = 0.0;
          moving[k] = false;
        }
      }
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

template <int D, int APT>
__device__ void subsm(const Problem<D, APT>& pr, const double* x,
                      const double* g, const double (&bm)[D][D],
                      const double* xcp, const bool* free, double* z_out) {
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
  double cand_min;
  const int ibd = argmin<D>(cand, cand_min);
  const double alpha = tmin(cand_min, 1.0);
  const double bound_b =
      pick<D>(dsub, ibd) > 0.0 ? pick<D>(pr.up, ibd) : pick<D>(pr.lo, ibd);
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

// REG_CAP: one-warp lanes held to 170 registers a thread (12 blocks an
// SM), so that a batch of 1,584 lanes is in flight at once
template <int D, int APT, bool REG_CAP>
__global__ void __launch_bounds__(REG_CAP ? 32 : MAX_THREADS, REG_CAP ? 12 : 1)
    lbfgsb_kernel(const double* __restrict__ coords,
                  const double* __restrict__ vdw,
                  const double* __restrict__ origin,
                  const double* __restrict__ x0,
                  const double* __restrict__ lower,
                  const double* __restrict__ upper,
                  const uint8_t* __restrict__ active,
                  double* __restrict__ x_out, double* __restrict__ fun_out,
                  int32_t* __restrict__ nit_out,
                  uint8_t* __restrict__ conv_out,
                  uint8_t* __restrict__ capped_out, int N,
                  pw::LbfgsbParams prm) {
  const int b = blockIdx.x;
  if (active != nullptr && active[b] == 0) {
    // a slot that holds no window: its outputs are never read
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) x_out[D * b + k] = x0[D * b + k];
      fun_out[b] = 0.0;
      nit_out[b] = 0;
      conv_out[b] = 0;
      capped_out[b] = 0;
    }
    return;
  }
  extern __shared__ double smem[];
  double* sx = smem;
  double* sy = sx + N;
  double* sz = sy + N;
  double* sr = sz + N;
  double* red_buf = sr + N;
  double* hs = red_buf + pw::kBlockMinDoubles;  // history ring, MAXCOR x D
  double* hy = hs + MAXCOR * D;
  pw::stage_atoms(coords + static_cast<size_t>(b) * N * 3,
                  vdw + static_cast<size_t>(b) * N, N, sx, sy, sz, sr);

  Problem<D, APT> pr;
  pr.sx = sx;
  pr.sy = sy;
  pr.sz = sz;
  pr.sr = sr;
  pr.n = N;
  pr.red = pw::BlockMin{red_buf, 0};
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

  // f and the FD gradient at the start; p(x + 0.0) equals p(x) in value,
  // so the gradient's clearance is f's (and the first iteration's m0x)
  double g[D], h0[D], xq[D];
  pr.fd_h(x, h0);
#pragma unroll
  for (int k = 0; k < D; ++k) xq[k] = x[k] + 0.0;
  double m0x = pr.grad(xq, h0, g);
  double fx = pr.sign2 * m0x;

  double theta = 1.0;
  int n_pairs = 0, head = 0, it = 0, trips = 0;
  bool done = false, conv = false;

  while (!done && it < prm.maxiter && trips < 2 * prm.maxiter + 4 &&
         pr.pg_max(x, g) > prm.pgtol) {
    const int col = min(n_pairs, m);
    double bm[D][D];
    build_b<D>(hs, hy, head, col, m, theta, bm);
    double xcp_z[D], xcp[D], z[D], dvec[D];
    bool free[D];
    cauchy<D, APT>(pr, x, g, bm, theta, epsmch, xcp_z, free);
#pragma unroll
    for (int k = 0; k < D; ++k) xcp[k] = x[k] + xcp_z[k];
    if (col > 0) {
      subsm<D, APT>(pr, x, g, bm, xcp, free, z);
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

    double stp, fdelta, gn[D], m0n;
    const bool ls_failed = dcsrch<D, APT>(pr, x, m0x, dvec, g, stp0, stpmx,
                                          prm.maxls, stp, fdelta, gn, m0n);

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
      // full: the newest pair replaces the oldest (head moves on);
      // every thread writes the same values, and every thread has read
      // the ring (build_b) before any passed this iteration's barriers
      int slot = head + n_pairs;
      if (n_pairs >= m) {
        slot = head;
        head = (head + 1 == m) ? 0 : head + 1;
      } else if (slot >= m) {
        slot -= m;
      }
#pragma unroll
      for (int k = 0; k < D; ++k) {
        hs[slot * D + k] = s[k];
        hy[slot * D + k] = y[k];
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
      m0x = m0n;  // the clearance at xn: the last evaluation's q is xn
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

template <int D, int APT, bool REG_CAP>
void launch(const double* coords, const double* vdw, const double* origin,
            const double* x0, const double* lower, const double* upper,
            const uint8_t* active, double* x, double* fun, int32_t* nit,
            uint8_t* conv, uint8_t* capped, int B, int N,
            const pw::LbfgsbParams& prm, int threads, void* stream) {
  const size_t smem =
      sizeof(double) * (static_cast<size_t>(4) * N + pw::kBlockMinDoubles + 2 * MAXCOR * D);
  pw::allow_smem(lbfgsb_kernel<D, APT, REG_CAP>, smem);
  lbfgsb_kernel<D, APT, REG_CAP>
      <<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          coords, vdw, origin, x0, lower, upper, active, x, fun, nit, conv,
          capped, N, prm);
}

// The variant: one-warp lanes held to 170 registers with one cached atom
// a thread (reg_cap: a batch too large for one wave of wider lanes);
// else two cached atoms a thread, which cover the molecule up to 512
// atoms at 256 threads (a larger one's other atoms are recomputed by
// the overflow loops of sweep_q and finish_fd, with the same operations)
template <int D>
void launch_d(const double* coords, const double* vdw, const double* origin,
              const double* x0, const double* lower, const double* upper,
              const uint8_t* active, double* x, double* fun, int32_t* nit,
              uint8_t* conv, uint8_t* capped, int B, int N,
              const pw::LbfgsbParams& prm, int threads, bool reg_cap,
              void* stream) {
  if (reg_cap) {
    launch<D, 1, true>(coords, vdw, origin, x0, lower, upper, active, x, fun,
                       nit, conv, capped, B, N, prm, 32, stream);
  } else {
    launch<D, 2, false>(coords, vdw, origin, x0, lower, upper, active, x, fun,
                        nit, conv, capped, B, N, prm, threads, stream);
  }
}

}  // namespace

void pw::lbfgsb_stable(const double* coords, const double* vdw,
                       const double* origin, const double* x0,
                       const double* lower, const double* upper,
                       const uint8_t* active, double* x, double* fun,
                       int32_t* nit, uint8_t* converged, uint8_t* capped,
                       int B, int N, int d, const LbfgsbParams& params,
                       int threads, bool reg_cap, void* stream) {
  if (B <= 0) return;
  if (d == 3) {
    launch_d<3>(coords, vdw, origin, x0, lower, upper, active, x, fun, nit,
                converged, capped, B, N, params, threads, reg_cap, stream);
  } else {
    launch_d<1>(coords, vdw, origin, x0, lower, upper, active, x, fun, nit,
                converged, capped, B, N, params, threads, reg_cap, stream);
  }
}
