// Host entry points of the pywindow_torch CUDA kernels.
//
// Each launches its kernel on the given stream (a cudaStream_t passed as
// void*) and returns without synchronising or checking; the caller
// (bindings.cpp) checks the launch with C10_CUDA_KERNEL_LAUNCH_CHECK().
// The ray kernels exist for float and for double, so that the double
// version can be held against its plain PyTorch version to the last
// digits; the optimiser kernels run in double only (their state is
// config.OPT_DTYPE).  Pointers are device pointers to contiguous arrays;
// flags are one byte per element (a torch.bool tensor).  Every kernel
// takes a leading frame (or lane) axis B.  This header includes no CUDA
// or PyTorch header.
#pragma once

#include <cstdint>

namespace pw {

// "no value" sentinel of the ray reductions (1e30, as in the JAX package)
constexpr double kBig = 1.0e30;

// ray_exit.cu: per ray (any_front, max_exit) of B frames; unit (B,P,3),
// rel (B,N,3), vdw (B,N), origin (B,3), order (P,) int32, a permutation
// of the rays that groups them into 32-ray tiles -> any_front (B,P),
// max_exit (B,P)
void ray_exit(const float* unit, const float* rel, const float* vdw,
              const float* origin, const int32_t* order, uint8_t* any_front,
              float* max_exit, int B, int P, int N, bool want_exit,
              void* stream);
void ray_exit(const double* unit, const double* rel, const double* vdw,
              const double* origin, const int32_t* order, uint8_t* any_front,
              double* max_exit, int B, int P, int N, bool want_exit,
              void* stream);

// path_sweep.cu: per ray (ok, first-argmin step, min clearance) of B
// frames; vectors (B,P,3), chunks (B,P) int32, coords (B,N,3), vdw (B,N);
// rays_per_warp: rays each warp walks (any >= 1 gives the same outputs)
void path_sweep(const float* vectors, const int32_t* chunks,
                const float* coords, const float* vdw, uint8_t* ok,
                int32_t* pos, float* cmin, int B, int P, int N, int max_steps,
                int rays_per_warp, void* stream);
void path_sweep(const double* vectors, const int32_t* chunks,
                const double* coords, const double* vdw, uint8_t* ok,
                int32_t* pos, double* cmin, int B, int P, int N,
                int max_steps, int rays_per_warp, void* stream);

// fine_path.cu: the same reduction for the W window-slot rays of B
// frames at the fine increment; vectors (B,W,3), chunks (B,W) int32,
// coords (B,N,3), vdw (B,N), active (B,W) or null (every slot active) ->
// ok, pos, cmin (B,W); an inactive slot writes (0, 0, 1e30).
void fine_path(const float* vectors, const int32_t* chunks,
               const float* coords, const float* vdw, const uint8_t* active,
               uint8_t* ok, int32_t* pos, float* cmin, int B, int W, int N,
               int max_steps, void* stream);
void fine_path(const double* vectors, const int32_t* chunks,
               const double* coords, const double* vdw, const uint8_t* active,
               uint8_t* ok, int32_t* pos, double* cmin, int B, int W, int N,
               int max_steps, void* stream);

// dbscan.cu: labels (B,K) int32 of B point sets (B,K,3) with validity
// (B,K) and eps (B,); threads: the block of one frame, a multiple of 32,
// <= 1024; stored: keep the eps-graph in shared memory (else it is tested
// anew where it is needed; cluster_kernels.dbscan_smem_bytes); scratch:
// null keeps the frame in shared memory, else (unstored only) B frames of
// cluster_kernels.dbscan_frame_bytes in global memory hold it.
void dbscan(const float* points, const uint8_t* valid, const float* eps,
            int32_t* labels, int B, int K, int min_samples, int max_clusters,
            int threads, bool stored, uint8_t* scratch, void* stream);
void dbscan(const double* points, const uint8_t* valid, const double* eps,
            int32_t* labels, int B, int K, int min_samples, int max_clusters,
            int threads, bool stored, uint8_t* scratch, void* stream);

// lbfgsb_stable.cu: the stable L-BFGS-B per lane, d = 3 (pore centre,
// identity axis embedding) or d = 1 (window z, z-axis embedding).
// coords (B,N,3), vdw (B,N), origin (B,3), x0/lower/upper (B,d),
// active (B,) or null (every lane active) -> x (B,d), fun (B,), nit (B,)
// int32, converged (B,), capped (B,); an inactive lane writes (x0, 0, 0,
// 0, 0).  threads: the block of one lane, a multiple of 32, <= 256;
// reg_cap: one-warp lanes (threads is then 32) held to 170 registers a
// thread, so that 12 lanes an SM are in flight.
struct LbfgsbParams {
  double sign;  // objective = sign * 2 * clearance
  int maxiter;
  int m;  // history pairs, <= 10
  int maxls;
  double pgtol;
  double factr;
  double fd_step;
};
void lbfgsb_stable(const double* coords, const double* vdw,
                   const double* origin, const double* x0,
                   const double* lower, const double* upper,
                   const uint8_t* active, double* x, double* fun,
                   int32_t* nit, uint8_t* converged, uint8_t* capped, int B,
                   int N, int d, const LbfgsbParams& params, int threads,
                   bool reg_cap, void* stream);

// nm_xy.cu: the window-xy brute grid (brute_ns x brute_ns, inclusive,
// x outer, first minimum) and the Nelder-Mead polish per lane; coords
// (L,N,3) rotated molecules, vdw (L,N), zanchor (L,), half (L,), active
// (L,) or null -> xy (L,2), f (L,), capped (L,), and, when not null,
// iterations (L,) int32; an inactive lane writes ((0, 0), 0, 0, 0).
// threads: the block of one lane, a multiple of 32, <= 256.
void nm_xy(const double* coords, const double* vdw, const double* zanchor,
           const double* half, const uint8_t* active, double* xy, double* f,
           uint8_t* capped, int32_t* iterations, int L, int N, int brute_ns,
           int maxiter, double xatol, double fatol, int threads, void* stream);

// clearance_min.cu: min_i(|x_i - p| - vdw_i) of Q probes (Q,3) against
// N atoms, coords (N,3) and vdw (N,), padded atoms parked far away with
// vdW 0 -> out (Q,).  No frame axis: one probe set, one molecule.
void clearance_min(const float* probes, const float* coords, const float* vdw,
                   float* out, int Q, int N, void* stream);
void clearance_min(const double* probes, const double* coords,
                   const double* vdw, double* out, int Q, int N, void* stream);

}  // namespace pw
