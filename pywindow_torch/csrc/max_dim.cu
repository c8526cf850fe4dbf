// max_dim: the maximum vdW-corrected diameter of B frames, the largest
// dist(i, j) + vdw_i + vdw_j over the frame's valid atoms, either with
// the two atoms that realise it (ops/pair_kernels.max_dim_plain: the
// upper triangle, diagonal included, row-major first maximum) or as the
// value alone over the full matrix (max_dim_value_plain).  The outputs
// equal the plain versions' bit for bit.
//
// Replaces no TPU kernel: the JAX package writes geometry.max_dim and
// max_dim_value in jnp (pywindow_tpu/ops/geometry.py:169, :194) and XLA
// fuses the (B, N, N) field into its reduction.  PyTorch runs them op by
// op, so the plain version writes a (B, N, N, 3) difference tensor and a
// dozen (B, N, N) passes a call: ~25 GB for a 1,200-frame chunk of the
// 424-atom MIBQAR, three calls a chunk (analysis.py's max_dim and
// max_dim_value, windows.py's max_dim_value), ~34 of the ~47 ms a chunk
// held the card in the traced mibqar_md.sweep.
//
// What bounds it: an unordered pair costs ~12 operations (three
// differences, three squares, two sums, the square root, two vdW sums and
// the compare; the value form two sums and a compare more) on 16 bytes an
// atom, read once: operations bound it.  A MIBQAR chunk's 108 M pairs are
// ~0.02 ms at the card's 67 TFLOP/s float32 rate.
//
// Design:
// - a frame's pair matrix in kTile x kTile tiles, only the tiles (r, c)
//   with r <= c; a block a (frame, tile), numbered flat over the grid's x
//   (frame-major, tiles row-major), so any B fits and one frame spreads
//   over nt (nt + 1) / 2 blocks, nt = ceil(N / kTile) (N = 424: 10);
// - the column tile's atoms staged in shared memory as (x, y, z, vdw)
//   records with their mask flags beside them (every vdw bit pattern stays
//   a valid radius); each thread holds one row atom in registers and walks
//   the column tile, all lanes of a warp reading the same record;
// - the plain version's arithmetic op by op (-fmad=false, IEEE square
//   root): dx = x_i - x_j per axis, (dx dx + dy dy) + dz dz, sqrt, then
//   (d + vdw_i) + vdw_j, where(valid, ., -1e30);
// - the argmax in torch's order: a NaN above every number (the first NaN
//   wins), equal values to the smaller flat index i n + j.  It is a total
//   order, so any reduction tree finds the plain argmax: each thread over
//   its row's entries, a warp by shuffles, the block's warps in order,
//   then, in a second launch, one thread a frame over its tiles' partials;
// - the atoms form visits every entry of its tiles, the lower-triangle
//   entries of the diagonal tiles as -1e30 like masked ones.  The plain
//   argmax is a valid triangle entry, always visited, or the first -1e30
//   entry: that one lies in row 0 (row 0 is visited whole) or is (1, 0)
//   (tile (0, 0) holds it: kTile >= 2), so the visited entries hold it;
// - the value form reads both orders of each visited pair: (d + vdw_i) +
//   vdw_j and (d + vdw_j) + vdw_i may differ by an ulp, while d is the
//   same bits both ways (x_j - x_i is exactly -(x_i - x_j)); its maximum
//   propagates a NaN, as amax does, and needs no index.
// Two launches a call, whatever B and N.  ops/pair_kernels.max_dim_mirror
// runs the same tiles and order on the CPU.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "kernels.h"

namespace {

// rows and columns of a pair tile, and the threads of a tile block (one
// a row); ops/pair_kernels.TILE
constexpr int kTile = 128;
constexpr int kWarps = kTile / 32;
constexpr int kReduceThreads = 128;

template <typename T>
struct Atom {
  T x, y, z, v;
};

// torch's argmax order (GreaterOrNan): is (v, k) above (bv, bk)?
template <typename T>
__device__ __forceinline__ bool above(T v, int k, T bv, int bk) {
  if (v != v) return bv == bv || k < bk;
  if (bv != bv) return false;
  return v > bv || (v == bv && k < bk);
}

// amax's maximum: a NaN wins and stays
template <typename T>
__device__ __forceinline__ T nan_max(T v, T bv) {
  return (v > bv || v != v) ? v : bv;
}

template <typename T, bool kAtoms>
__global__ void __launch_bounds__(kTile)
    max_dim_pairs(const T* __restrict__ coords, const T* __restrict__ vdw,
                  const uint8_t* __restrict__ mask, T* __restrict__ part_v,
                  int32_t* __restrict__ part_k, int n, int nt, int tiles) {
  __shared__ Atom<T> col[kTile];
  __shared__ bool col_ok[kTile];
  __shared__ T warp_v[kWarps];
  __shared__ int warp_k[kWarps];

  const int frame = blockIdx.x / tiles;
  int t = blockIdx.x - frame * tiles;
  int r = 0;
  while (t >= nt - r) {
    t -= nt - r;
    ++r;
  }
  const int j0 = (r + t) * kTile;
  const int cols = min(kTile, n - j0);
  const size_t base = static_cast<size_t>(frame) * n;
  if (threadIdx.x < cols) {
    const size_t a = base + j0 + threadIdx.x;
    col[threadIdx.x] = {coords[3 * a], coords[3 * a + 1], coords[3 * a + 2],
                        vdw[a]};
    col_ok[threadIdx.x] = mask[a] != 0;
  }
  const int i = r * kTile + threadIdx.x;
  const T big = static_cast<T>(-pw::kBig);
  T bv = -static_cast<T>(INFINITY);
  int bk = INT_MAX;
  __syncthreads();
  if (i < n) {
    const size_t a = base + i;
    const T xi = coords[3 * a], yi = coords[3 * a + 1], zi = coords[3 * a + 2];
    const T vi = vdw[a];
    const bool mi = mask[a] != 0;
#pragma unroll 4
    for (int jj = 0; jj < cols; ++jj) {
      const Atom<T> c = col[jj];
      const int j = j0 + jj;
      const T dx = xi - c.x;
      const T dy = yi - c.y;
      const T dz = zi - c.z;
      const T d = sqrt(dx * dx + dy * dy + dz * dz);
      const bool ok = mi && col_ok[jj];
      if (kAtoms) {
        const T s = (ok && i <= j) ? (d + vi) + c.v : big;
        const int k = i * n + j;
        if (above(s, k, bv, bk)) {
          bv = s;
          bk = k;
        }
      } else {
        bv = nan_max(ok ? (d + vi) + c.v : big, bv);
        bv = nan_max(ok ? (d + c.v) + vi : big, bv);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int ok = __shfl_down_sync(0xffffffffu, bk, off);
    if (kAtoms) {
      if (above(ov, ok, bv, bk)) {
        bv = ov;
        bk = ok;
      }
    } else {
      bv = nan_max(ov, bv);
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warp_v[warp] = bv;
    warp_k[warp] = bk;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (kAtoms) {
        if (above(warp_v[w], warp_k[w], bv, bk)) {
          bv = warp_v[w];
          bk = warp_k[w];
        }
      } else {
        bv = nan_max(warp_v[w], bv);
      }
    }
    part_v[blockIdx.x] = bv;
    part_k[blockIdx.x] = bk;
  }
}

// one thread a frame: its tiles' partials in order -> value, and for the
// atoms form the two atoms of the flat index
template <typename T, bool kAtoms>
__global__ void max_dim_reduce(const T* __restrict__ part_v,
                               const int32_t* __restrict__ part_k,
                               T* __restrict__ value, int64_t* __restrict__ atom1,
                               int64_t* __restrict__ atom2, int B, int n,
                               int tiles) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= B) return;
  const size_t p = static_cast<size_t>(f) * tiles;
  T bv = part_v[p];
  int bk = part_k[p];
  for (int t = 1; t < tiles; ++t) {
    if (kAtoms) {
      if (above(part_v[p + t], part_k[p + t], bv, bk)) {
        bv = part_v[p + t];
        bk = part_k[p + t];
      }
    } else {
      bv = nan_max(part_v[p + t], bv);
    }
  }
  value[f] = bv;
  if (kAtoms) {
    atom1[f] = bk / n;
    atom2[f] = bk % n;
  }
}

template <typename T>
void launch(const T* coords, const T* vdw, const uint8_t* mask, T* part_v,
            int32_t* part_k, T* value, int64_t* atom1, int64_t* atom2, int B,
            int N, void* stream) {
  const int nt = (N + kTile - 1) / kTile;
  const int tiles = pw::max_dim_tiles(N);
  const int blocks = B * tiles;
  const int reduce_blocks = (B + kReduceThreads - 1) / kReduceThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (atom1 != nullptr) {
    max_dim_pairs<T, true><<<blocks, kTile, 0, s>>>(coords, vdw, mask, part_v,
                                                    part_k, N, nt, tiles);
    max_dim_reduce<T, true><<<reduce_blocks, kReduceThreads, 0, s>>>(
        part_v, part_k, value, atom1, atom2, B, N, tiles);
  } else {
    max_dim_pairs<T, false><<<blocks, kTile, 0, s>>>(coords, vdw, mask, part_v,
                                                     part_k, N, nt, tiles);
    max_dim_reduce<T, false><<<reduce_blocks, kReduceThreads, 0, s>>>(
        part_v, part_k, value, atom1, atom2, B, N, tiles);
  }
}

}  // namespace

namespace pw {

int max_dim_tiles(int n) {
  const int nt = (n + kTile - 1) / kTile;
  return nt * (nt + 1) / 2;
}

void max_dim(const float* coords, const float* vdw, const uint8_t* mask,
             float* part_v, int32_t* part_k, float* value, int64_t* atom1,
             int64_t* atom2, int B, int N, void* stream) {
  launch(coords, vdw, mask, part_v, part_k, value, atom1, atom2, B, N, stream);
}

void max_dim(const double* coords, const double* vdw, const uint8_t* mask,
             double* part_v, int32_t* part_k, double* value, int64_t* atom1,
             int64_t* atom2, int B, int N, void* stream) {
  launch(coords, vdw, mask, part_v, part_k, value, atom1, atom2, B, N, stream);
}

}  // namespace pw
