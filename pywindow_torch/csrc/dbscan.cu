// dbscan: DBSCAN labels of one point set per frame, with the exact
// semantics of pywindow_tpu/ops/cluster.py::dbscan (the sklearn-parity
// contract): eps-graph sqrt(d^2) <= eps in difference form (self
// included, validity-masked), core points those with at least
// min_samples neighbours, every core point labelled by the smallest index
// of its core-core component, a border point by the smallest such label
// among its core neighbours, components ranked 0, 1, ... by ascending
// root index, ranks >= max_clusters folded to -1 (noise and invalid
// points are -1 too).  The labels equal the plain version's
// (ops/cluster.py::dbscan) bit for bit; ops/cluster_kernels.dbscan_mirror
// mirrors this algorithm on the CPU.
//
// Replaces pywindow_tpu/ops/cluster_pallas.py::dbscan_labels_flat.
// Reference behaviour: utilities.py:1478-1487 (sklearn DBSCAN).
//
// What bounds it: a frame is a few hundred points (the K = 384 compacted
// ray endpoints of a cage, about 250 of them valid), so the pair tests
// (n^2 / 2 a frame, ~18 float32 instructions each with the square root)
// are ~2 us of one SM's float32 rate, and the rest is latency: the
// block's steps are short and depend on each other.  The design keeps
// everything of a frame on its SM and takes as few dependent steps as it
// can:
// - one block a frame, of ops/cluster_kernels.dbscan_threads threads:
//   1,024 while the launch fits one block an SM, 512 while it fits two,
//   else 256, compiled for 6 blocks an SM (42 registers), so that a batch
//   keeps more frames in flight (on a 1,440-frame chunk 256 threads beat
//   512 and 1,024, on one molecule 1,024 beat 256);
// - the valid points are compacted in order into shared memory (a ballot
//   and a prefix count a round); only valid pairs are tested, and since
//   compaction keeps the order, component minima and root ranks are the
//   same in either index space;
// - the eps-graph is a bit mask in shared memory, word w of row i at
//   mask[w n + i] (a thread a row reads it without bank conflicts), built
//   by 32 x 32 tiles: a warp takes the tile (r, c), r <= c, lane b holds
//   point 32c + b, one ballot a row gives the word (32r + k, c), kept by
//   lane k, and each lane gathers its own column into the word (32c + b,
//   r); each tile's words are two coalesced stores.  So each unordered
//   pair is tested once and sets both bits: x_i - x_j is exactly
//   -(x_j - x_i), so the squares, sums and square root round alike and
//   the test is symmetric bit for bit;
// - a tile pair whose boxes (each tile's least and greatest x, y, z) are
//   farther apart than eps is not tested: its words are 0.  The computed
//   gap g = sqrt(gx^2 + gy^2 + gz^2) of the boxes is at most (1 + 5u) the
//   exact one (u the unit roundoff), every pair's exact distance is at
//   least the exact gap, and its computed distance at least (1 - 5u) the
//   exact one, so g > eps (1 + 32u) + tiny means every computed test is
//   false (tiny = 1e-15 in float32, 1e-150 in float64, keeps the squares
//   clear of underflow; a NaN gap tests the pair).  The spiral's order
//   makes consecutive points z-bands, so on a cage about half the tile
//   pairs go;
// - neighbour counts are popcounts of a row, core flags a ballot;
// - components by union-find in shared memory: every core point starts
//   under its least core neighbour (the row's first core bit) and is
//   moved to the root of that forest; then each core-core edge (i < j)
//   whose ends do not already share a parent (on a cage ~90% of them)
//   hooks the larger root under the smaller (atomicCAS on the root's
//   parent; find with path halving); a parent is always an ancestor below
//   its node, so the root of each tree is its least index, the plain
//   version's min-label fixpoint; one compression pass (reads only) then
//   gives every core point its root.  The rounds do not grow with the
//   graph's diameter, as the plain version's passes do;
// - a root's rank is a prefix count of the root bits (one warp scan of
//   the words' popcounts), and each point's label is written back to its
//   original index.
// Size routes (ops/cluster_kernels.dbscan_route): the mask takes
// 4 K ceil(K/32) bytes, so it is stored for K up to 1,253 (float32) or
// 1,194 (float64), 28.3 KB a block at K = 384 in float32; beyond, the
// kernel tests each row's words anew where it needs them (the counts, the
// unions, the border points; far tiles still skipped) in
// (4 sizeof(T) + 8) K bytes and a few words a tile, up to K = 9,153
// (float32) or 5,481 (float64).  Beyond that the same unstored route keeps
// the frame's records (points, boxes, indices, parents, bits) in a global
// scratch of dbscan_frame_bytes a frame that the wrapper allocates, so any
// K runs in this kernel; the parents' atomics and the block's barriers
// work on global memory as on shared, and the labels are the same.
#include <climits>

#include <cuda_runtime.h>

#include "kernels.h"
#include "ray_cull.cuh"
#include "sweep.cuh"

namespace {

// Shared memory of a block over K slots (ops/cluster_kernels.
// dbscan_smem_bytes): the compacted points' records, each 32-point tile's
// box (two records), the points' original indices and union-find parents,
// the core and root bits and the roots before each word (ceil(K/32) each),
// 32 warp counts and, when stored, the eps-graph of ceil(K/32) x K words.
template <typename T>
size_t dbscan_smem_bytes(int K, bool stored) {
  const size_t words = (K + 31) / 32;
  return (K + 2 * words) * sizeof(pw::Rec<T>) + 2 * sizeof(int) * K +
         3 * sizeof(unsigned) * words + 32 * sizeof(int) +
         (stored ? sizeof(unsigned) * K * words : 0);
}

// A frame's records in the global scratch: the unstored layout, rounded
// up to 256 bytes (ops/cluster_kernels.dbscan_frame_bytes).
template <typename T>
size_t dbscan_frame_bytes(int K) {
  return (dbscan_smem_bytes<T>(K, false) + 255) / 256 * 256;
}

template <typename T>
__device__ __forceinline__ bool within(const pw::Rec<T>& a,
                                       const pw::Rec<T>& b, T eps) {
  const T dx = a.x - b.x;
  const T dy = a.y - b.y;
  const T dz = a.z - b.z;
  return sqrt(dx * dx + dy * dy + dz * dz) <= eps;
}

__device__ __forceinline__ bool bit(const unsigned* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// The smallest gap, below which no point of one box may lie within eps
// of a point of the other, over that of the unit roundoff: a pair's
// computed distance is at least (1 - 10u) times the boxes' computed gap
// (header), and the constant keeps squares clear of underflow.
template <typename T>
__device__ __forceinline__ T tiny_gap();
template <>
__device__ __forceinline__ float tiny_gap<float>() { return 1e-15f; }
template <>
__device__ __forceinline__ double tiny_gap<double>() { return 1e-150; }

// The eps-graph of the compacted points: row i's word w (bit b for point
// 32w + b), zero when the two tiles' boxes are farther apart than eps,
// else from the stored mask (word w of every row, then the next word:
// mask[w * n + i]) or tested anew.
template <typename T, bool STORED>
struct Graph {
  const pw::Rec<T>* pts;
  const pw::Rec<T>* lo;  // per tile, the least x, y, z of its points
  const pw::Rec<T>* hi;  // and the greatest
  const unsigned* mask;
  int n, nw;
  T eps;

  // every pair of tiles r and c is farther apart than eps
  __device__ __forceinline__ bool far(int r, int c) const {
    const T gx = max(max(lo[c].x - hi[r].x, lo[r].x - hi[c].x), T(0));
    const T gy = max(max(lo[c].y - hi[r].y, lo[r].y - hi[c].y), T(0));
    const T gz = max(max(lo[c].z - hi[r].z, lo[r].z - hi[c].z), T(0));
    const T slack = T(32) * pw::unit_roundoff<T>();
    return sqrt(gx * gx + gy * gy + gz * gz) > eps + eps * slack + tiny_gap<T>();
  }

  __device__ __forceinline__ unsigned word(int i, int w) const {
    if (STORED) return mask[w * n + i];
    if (far(i >> 5, w)) return 0u;
    const pw::Rec<T> p = pts[i];
    const int jn = min(32, n - 32 * w);
    unsigned bits = 0;
    for (int b = 0; b < jn; ++b) {
      bits |= static_cast<unsigned>(within(p, pts[32 * w + b], eps)) << b;
    }
    return bits;
  }
};

// The root of x.  Parents only decrease and every parent is an ancestor,
// so the path-halving stores are safe beside other finds and hooks.
__device__ int find_root(volatile int* parent, int x) {
  int cur = parent[x];
  if (cur != x) {
    int prev = x;
    int next;
    while (cur > (next = parent[cur])) {
      parent[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

// The root of x by reads alone: the compression pass, where other threads
// write roots in place (a path-halving store there could put back a
// parent that is not the root after its node was compressed).
__device__ int root_of(const volatile int* parent, int x) {
  for (int p = parent[x]; p != x; p = parent[x]) x = p;
  return x;
}

// Join the trees of a and b: the larger root is hooked under the smaller,
// retried from the new roots when another thread hooked it first.
__device__ void unite(int* parent, int a, int b) {
  int ra = find_root(parent, a);
  int rb = find_root(parent, b);
  while (ra != rb) {
    if (ra > rb) {
      const int t = ra;
      ra = rb;
      rb = t;
    }
    const int old = atomicCAS(&parent[rb], rb, ra);
    if (old == rb) return;
    rb = find_root(parent, old);
    ra = find_root(parent, ra);
  }
}

// MAXT threads a block at most: 1,024 (the 1,024- and 512-thread blocks
// launch within 64 registers a thread) or 256, with 6 blocks an SM (42
// registers: on a batch more frames are in flight).  GLOBAL: the frame's
// records are at scratch + f frame_bytes instead of in shared memory.
template <typename T, bool STORED, bool GLOBAL, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) dbscan_kernel(const T* __restrict__ points,
                              const uint8_t* __restrict__ valid,
                              const T* __restrict__ eps,
                              int32_t* __restrict__ labels_out, int K,
                              int min_samples, int max_clusters,
                              unsigned char* scratch, size_t frame_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      GLOBAL ? scratch + static_cast<size_t>(blockIdx.x) * frame_bytes : smem_raw;
  const int W = (K + 31) / 32;
  auto* pts = reinterpret_cast<pw::Rec<T>*>(base);
  pw::Rec<T>* lo = pts + K;
  pw::Rec<T>* hi = lo + W;
  int* idx = reinterpret_cast<int*>(hi + W);
  int* parent = idx + K;
  unsigned* core = reinterpret_cast<unsigned*>(parent + K);
  unsigned* roots = core + W;
  int* before = reinterpret_cast<int*>(roots + W);
  int* warp_count = before + W;
  unsigned* mask = reinterpret_cast<unsigned*>(warp_count + 32);

  const int f = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const T* frame = points + static_cast<size_t>(f) * K * 3;
  const uint8_t* val = valid + static_cast<size_t>(f) * K;
  int32_t* out = labels_out + static_cast<size_t>(f) * K;

  // 1. order-preserving compaction of the valid points; the others are -1
  int n = 0;
  for (int base = 0; base < K; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool v = i < K && val[i] != 0;
    if (i < K && !v) out[i] = -1;
    const unsigned m = __ballot_sync(pw::kFullMask, v);
    if (lane == 0) warp_count[warp] = __popc(m);
    __syncthreads();
    int off = n;
    int total = n;
    for (int w = 0; w < warps; ++w) {
      off += w < warp ? warp_count[w] : 0;
      total += warp_count[w];
    }
    if (v) {
      const int c = off + __popc(m & ((1u << lane) - 1u));
      pts[c] = pw::Rec<T>{frame[3 * i], frame[3 * i + 1], frame[3 * i + 2], T(0)};
      idx[c] = i;
    }
    n = total;
    __syncthreads();  // warp_count is reused
  }
  const int nw = (n + 31) / 32;
  const Graph<T, STORED> graph{pts, lo, hi, mask, n, nw, eps[f]};

  // 2. each tile's box, then the stored eps-graph, one 32 x 32 tile (r <= c)
  //    a warp at a time: lane b holds point 32c + b, a ballot a row gives
  //    the row's word c (kept by lane k for row 32r + k), and each lane's
  //    own bits give its word r; tiles whose boxes are far apart are zero
  for (int t = warp; t < nw; t += warps) {
    const int j = 32 * t + lane;
    const T inf = T(INFINITY);
    const pw::Rec<T> p = j < n ? pts[j] : pw::Rec<T>{inf, inf, inf, T(0)};
    const pw::Rec<T> q = j < n ? p : pw::Rec<T>{-inf, -inf, -inf, T(0)};
    const T x0 = pw::warp_min(p.x), y0 = pw::warp_min(p.y), z0 = pw::warp_min(p.z);
    const T x1 = pw::warp_max(q.x), y1 = pw::warp_max(q.y), z1 = pw::warp_max(q.z);
    if (lane == 0) {
      lo[t] = pw::Rec<T>{x0, y0, z0, T(0)};
      hi[t] = pw::Rec<T>{x1, y1, z1, T(0)};
    }
  }
  __syncthreads();
  if (STORED) {
    const int tiles = nw * (nw + 1) / 2;
    for (int t = warp; t < tiles; t += warps) {
      int r = 0;
      int rem = t;
      while (rem >= nw - r) {
        rem -= nw - r;
        ++r;
      }
      const int c = r + rem;
      const int j = 32 * c + lane;
      const bool jv = j < n;
      const int rn = min(32, n - 32 * r);
      unsigned col = 0;
      unsigned mine = 0;
      if (!graph.far(r, c)) {
        const pw::Rec<T> pj = pts[jv ? j : 0];
        for (int k = 0; k < rn; ++k) {
          const bool hit = jv && within(pts[32 * r + k], pj, graph.eps);
          const unsigned row = __ballot_sync(pw::kFullMask, hit);
          mine = lane == k ? row : mine;
          col |= static_cast<unsigned>(hit) << k;
        }
      }
      if (lane < rn) mask[c * n + 32 * r + lane] = mine;
      if (r != c && jv) mask[r * n + j] = col;
    }
    __syncthreads();
  }

  // 3. neighbour counts and core flags
  for (int base = 32 * warp; base < n; base += 32 * warps) {
    const int i = base + lane;
    bool is_core = false;
    if (i < n) {
      int count = 0;
      for (int w = 0; w < nw; ++w) count += __popc(graph.word(i, w));
      is_core = count >= min_samples;
    }
    const unsigned m = __ballot_sync(pw::kFullMask, is_core);
    if (lane == 0) core[base / 32] = m;
  }
  __syncthreads();

  // 4. union-find: every core point starts under its least core neighbour
  //    (itself if none is smaller), compressed to the root of that forest,
  //    then each core-core edge i < j joins the two trees unless i and j
  //    already share a parent or j's parent is i (parents are ancestors at
  //    all times, so that proves one tree); then full compression
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int m = i;
    if (bit(core, i)) {
      for (int w = 0; w <= (i >> 5); ++w) {
        const unsigned bits = graph.word(i, w) & core[w];
        if (bits) {
          m = min(m, 32 * w + __ffs(bits) - 1);
          break;
        }
      }
    }
    parent[i] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (bit(core, i)) parent[i] = root_of(parent, i);
  }
  __syncthreads();
  volatile int* vparent = parent;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!bit(core, i)) continue;
    for (int w = i >> 5; w < nw; ++w) {
      unsigned bits = graph.word(i, w) & core[w];
      if (w == (i >> 5)) bits &= ~((2u << (i & 31)) - 1u);  // j > i
      for (; bits; bits &= bits - 1) {
        const int j = 32 * w + __ffs(bits) - 1;
        const int pj = vparent[j];
        if (pj == i || pj == vparent[i]) continue;
        unite(parent, i, j);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (bit(core, i)) parent[i] = root_of(parent, i);
  }
  __syncthreads();

  // 5. the roots, and the roots before each word (one warp scan)
  for (int base = 32 * warp; base < n; base += 32 * warps) {
    const int i = base + lane;
    const bool root = i < n && bit(core, i) && parent[i] == i;
    const unsigned m = __ballot_sync(pw::kFullMask, root);
    if (lane == 0) roots[base / 32] = m;
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < nw; base += 32) {
      const int w = base + lane;
      const int c = w < nw ? __popc(roots[w]) : 0;
      int s = c;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(pw::kFullMask, s, off);
        if (lane >= off) s += y;
      }
      if (w < nw) before[w] = carry + s - c;
      carry += __shfl_sync(pw::kFullMask, s, 31);
    }
  }
  __syncthreads();

  // 6. raw label (a core point's root, a border point's least core
  //    neighbour root), its rank, folded at max_clusters
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int raw = INT_MAX;
    if (bit(core, i)) {
      raw = parent[i];
    } else {
      for (int w = 0; w < nw; ++w) {
        for (unsigned bits = graph.word(i, w) & core[w]; bits; bits &= bits - 1) {
          raw = min(raw, parent[32 * w + __ffs(bits) - 1]);
        }
      }
    }
    int label = -1;
    if (raw != INT_MAX) {
      const int rank = before[raw >> 5] +
                       __popc(roots[raw >> 5] & ((2u << (raw & 31)) - 1u)) - 1;
      label = rank < max_clusters ? rank : -1;
    }
    out[idx[i]] = label;
  }
}

template <typename T, bool STORED, bool GLOBAL, int MAXT, int MINB>
void launch_bounded(const T* points, const uint8_t* valid, const T* eps,
                    int32_t* labels, int B, int K, int min_samples,
                    int max_clusters, int threads, uint8_t* scratch,
                    void* stream) {
  const size_t smem = GLOBAL ? 0 : dbscan_smem_bytes<T>(K, STORED);
  pw::allow_smem(dbscan_kernel<T, STORED, GLOBAL, MAXT, MINB>, smem);
  dbscan_kernel<T, STORED, GLOBAL, MAXT, MINB><<<B, threads, smem,
                                                 static_cast<cudaStream_t>(stream)>>>(
      points, valid, eps, labels, K, min_samples, max_clusters, scratch,
      dbscan_frame_bytes<T>(K));
}

template <typename T, bool STORED, bool GLOBAL>
void launch(const T* points, const uint8_t* valid, const T* eps,
            int32_t* labels, int B, int K, int min_samples, int max_clusters,
            int threads, uint8_t* scratch, void* stream) {
  if (threads <= 256) {
    launch_bounded<T, STORED, GLOBAL, 256, 6>(points, valid, eps, labels, B, K,
                                              min_samples, max_clusters,
                                              threads, scratch, stream);
  } else {
    launch_bounded<T, STORED, GLOBAL, 1024, 1>(points, valid, eps, labels, B,
                                               K, min_samples, max_clusters,
                                               threads, scratch, stream);
  }
}

template <typename T>
void launch_dbscan(const T* points, const uint8_t* valid, const T* eps,
                   int32_t* labels, int B, int K, int min_samples,
                   int max_clusters, int threads, bool stored,
                   uint8_t* scratch, void* stream) {
  if (B <= 0 || K <= 0) return;
  if (stored) {
    launch<T, true, false>(points, valid, eps, labels, B, K, min_samples,
                           max_clusters, threads, nullptr, stream);
  } else if (scratch == nullptr) {
    launch<T, false, false>(points, valid, eps, labels, B, K, min_samples,
                            max_clusters, threads, nullptr, stream);
  } else {
    launch<T, false, true>(points, valid, eps, labels, B, K, min_samples,
                           max_clusters, threads, scratch, stream);
  }
}

}  // namespace

void pw::dbscan(const float* points, const uint8_t* valid, const float* eps,
                int32_t* labels, int B, int K, int min_samples,
                int max_clusters, int threads, bool stored, uint8_t* scratch,
                void* stream) {
  launch_dbscan(points, valid, eps, labels, B, K, min_samples, max_clusters,
                threads, stored, scratch, stream);
}

void pw::dbscan(const double* points, const uint8_t* valid, const double* eps,
                int32_t* labels, int B, int K, int min_samples,
                int max_clusters, int threads, bool stored, uint8_t* scratch,
                void* stream) {
  launch_dbscan(points, valid, eps, labels, B, K, min_samples, max_clusters,
                threads, stored, scratch, stream);
}
