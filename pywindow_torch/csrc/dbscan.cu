// dbscan: DBSCAN labels of one point set per frame, with the exact
// semantics of pywindow_tpu/ops/cluster.py::dbscan (the sklearn-parity
// contract): eps-graph (dist <= eps, self included, validity-masked),
// core test (neighbour count >= min_samples), min-label propagation over
// the core-core graph to a fixpoint, border points attached to the
// smallest component label among their core neighbours, components
// renumbered 0, 1, ... by ascending root index, ranks >= max_clusters
// folded to -1 (noise and invalid points are -1 too).
//
// Replaces pywindow_tpu/ops/cluster_pallas.py::dbscan_labels_flat.
// Reference behaviour: utilities.py:1478-1487 (sklearn DBSCAN).
//
// Design: one block per frame, points strided over the threads.  The
// adjacency is a bitmask of K x ceil(K/32) words in a scratch tensor the
// wrapper allocates, so any K works (no VMEM-style K limit).  Labels are
// double-buffered in scratch too, so each propagation pass equals one
// iteration of the plain version; __syncthreads_or ends the loop when a
// pass changes nothing.  Renumbering counts the roots <= each label
// (the gather-free rank of cluster._finalise).  The eps-graph costs
// K^2 distances (147k at K = 384); propagation costs one pass over the
// bitmask per graph-diameter step.  With one block per frame a single
// molecule occupies one SM: the kernel is bound by latency, not by the
// card's arithmetic or bandwidth.
#include <climits>

#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int DBSCAN_THREADS = 256;

template <typename T>
__global__ void dbscan_kernel(const T* __restrict__ points,
                              const uint8_t* __restrict__ valid,
                              const T* __restrict__ eps,
                              int32_t* __restrict__ adj_words,
                              int32_t* __restrict__ scratch,
                              int32_t* __restrict__ labels_out, int K,
                              int min_samples, int max_clusters) {
  const int f = blockIdx.x;
  const int W = (K + 31) / 32;
  const T* pts = points + static_cast<size_t>(f) * K * 3;
  const uint8_t* val = valid + static_cast<size_t>(f) * K;
  uint32_t* A = reinterpret_cast<uint32_t*>(adj_words) + static_cast<size_t>(f) * K * W;
  int* lab = scratch + static_cast<size_t>(f) * 3 * K;
  int* nxt = lab + K;
  int* core = nxt + K;
  const T e = eps[f];

  // eps-graph bitmask, neighbour counts, core flags
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const bool vi = val[i] != 0;
    const T xi = pts[3 * i], yi = pts[3 * i + 1], zi = pts[3 * i + 2];
    int count = 0;
    for (int w = 0; w < W; ++w) {
      uint32_t bits = 0;
      const int jn = min(32, K - 32 * w);
      for (int b = 0; vi && b < jn; ++b) {
        const int j = 32 * w + b;
        if (!val[j]) continue;
        const T dx = xi - pts[3 * j];
        const T dy = yi - pts[3 * j + 1];
        const T dz = zi - pts[3 * j + 2];
        if (sqrt(dx * dx + dy * dy + dz * dz) <= e) bits |= 1u << b;
      }
      A[static_cast<size_t>(i) * W + w] = bits;
      count += __popc(bits);
    }
    core[i] = (vi && count >= min_samples) ? 1 : 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    lab[i] = core[i] ? i : INT_MAX;
  }
  __syncthreads();

  // min-label propagation over the core-core graph (Jacobi passes)
  int changed = 1;
  while (changed) {
    int mine = 0;
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      int m = lab[i];
      if (core[i]) {
        for (int w = 0; w < W; ++w) {
          uint32_t bits = A[static_cast<size_t>(i) * W + w];
          while (bits) {
            const int j = 32 * w + __ffs(bits) - 1;
            bits &= bits - 1;
            if (core[j]) m = min(m, lab[j]);
          }
        }
      }
      nxt[i] = m;
      mine |= (m != lab[i]);
    }
    changed = __syncthreads_or(mine);
    int* t = lab;
    lab = nxt;
    nxt = t;
  }

  // border attachment: raw label of every point (INT_MAX = noise)
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    int raw = INT_MAX;
    if (core[i]) {
      raw = lab[i];
    } else if (val[i]) {
      for (int w = 0; w < W; ++w) {
        uint32_t bits = A[static_cast<size_t>(i) * W + w];
        while (bits) {
          const int j = 32 * w + __ffs(bits) - 1;
          bits &= bits - 1;
          if (core[j]) raw = min(raw, lab[j]);
        }
      }
    }
    nxt[i] = raw;
  }
  __syncthreads();

  // renumber by ascending root index; fold ranks >= max_clusters
  int* out = labels_out + static_cast<size_t>(f) * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const int raw = nxt[i];
    int label = -1;
    if (raw != INT_MAX) {
      int roots = 0;
      for (int j = 0; j <= raw; ++j) roots += (core[j] && lab[j] == j);
      label = roots - 1 < max_clusters ? roots - 1 : -1;
    }
    out[i] = label;
  }
}

template <typename T>
void launch_dbscan(const T* points, const uint8_t* valid, const T* eps,
                   int32_t* adj, int32_t* scratch, int32_t* labels, int B,
                   int K, int min_samples, int max_clusters, void* stream) {
  if (B <= 0 || K <= 0) return;
  dbscan_kernel<T><<<B, DBSCAN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      points, valid, eps, adj, scratch, labels, K, min_samples, max_clusters);
}

}  // namespace

void pw::dbscan(const float* points, const uint8_t* valid, const float* eps,
                int32_t* adj, int32_t* scratch, int32_t* labels, int B, int K,
                int min_samples, int max_clusters, void* stream) {
  launch_dbscan(points, valid, eps, adj, scratch, labels, B, K, min_samples,
                max_clusters, stream);
}

void pw::dbscan(const double* points, const uint8_t* valid, const double* eps,
                int32_t* adj, int32_t* scratch, int32_t* labels, int B, int K,
                int min_samples, int max_clusters, void* stream) {
  launch_dbscan(points, valid, eps, adj, scratch, labels, B, K, min_samples,
                max_clusters, stream);
}
