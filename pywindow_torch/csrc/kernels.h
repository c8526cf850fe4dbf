// Host entry points of the pywindow_torch CUDA kernels.
//
// Each launches its kernel on the given stream (a cudaStream_t passed as
// void*) and returns without synchronising or checking; the caller
// (bindings.cpp) checks the launch with C10_CUDA_KERNEL_LAUNCH_CHECK().
// Every kernel exists for float and for double, so that the double
// version can be held against its plain PyTorch version to the last
// digits.  Pointers are device pointers to contiguous arrays; flags are
// one byte per element (a torch.bool tensor).  This header includes no
// CUDA or PyTorch header.
#pragma once

#include <cstdint>

namespace pw {

// "no value" sentinel of the ray reductions (1e30, as in the JAX package)
constexpr double kBig = 1.0e30;

// ray_exit.cu: per ray (any_front, max_exit); unit (P,3), rel (N,3),
// vdw (N,), origin (3,) -> any_front (P,), max_exit (P,)
void ray_exit(const float* unit, const float* rel, const float* vdw,
              const float* origin, uint8_t* any_front, float* max_exit, int P,
              int N, bool want_exit, void* stream);
void ray_exit(const double* unit, const double* rel, const double* vdw,
              const double* origin, uint8_t* any_front, double* max_exit,
              int P, int N, bool want_exit, void* stream);

// path_sweep.cu: per ray (ok, first-argmin step, min clearance);
// vectors (P,3), chunks (P,) int32, coords (N,3), vdw (N,)
void path_sweep(const float* vectors, const int32_t* chunks,
                const float* coords, const float* vdw, uint8_t* ok,
                int32_t* pos, float* cmin, int P, int N, int max_steps,
                void* stream);
void path_sweep(const double* vectors, const int32_t* chunks,
                const double* coords, const double* vdw, uint8_t* ok,
                int32_t* pos, double* cmin, int P, int N, int max_steps,
                void* stream);

// dbscan.cu: labels (B,K) int32 of B point sets (B,K,3) with validity
// (B,K) and eps (B,); adj (B,K,ceil(K/32)) and scratch (B,3,K) int32 are
// caller-allocated work space.
void dbscan(const float* points, const uint8_t* valid, const float* eps,
            int32_t* adj, int32_t* scratch, int32_t* labels, int B, int K,
            int min_samples, int max_clusters, void* stream);
void dbscan(const double* points, const uint8_t* valid, const double* eps,
            int32_t* adj, int32_t* scratch, int32_t* labels, int B, int K,
            int min_samples, int max_clusters, void* stream);

}  // namespace pw
