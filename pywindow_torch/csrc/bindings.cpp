// PyTorch bindings of the pywindow_torch CUDA kernels: the only source
// that includes PyTorch's headers (they dominate the build time).  The
// Python wrappers in pywindow_torch/ops/{ray,cluster}_kernels.py check
// device, dtype, shape and contiguity before calling these; each binding
// launches on the current stream of the tensors' device and checks the
// launch.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include "kernels.h"

namespace {

void* current_stream(const at::Tensor& t) {
  return at::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

uint8_t* bytes(at::Tensor& t) { return static_cast<uint8_t*>(t.data_ptr()); }

template <typename T>
void ray_exit_t(const at::Tensor& unit, const at::Tensor& rel,
                const at::Tensor& vdw, const at::Tensor& origin,
                at::Tensor& any_front, at::Tensor& max_exit, bool want_exit) {
  pw::ray_exit(unit.data_ptr<T>(), rel.data_ptr<T>(), vdw.data_ptr<T>(),
               origin.data_ptr<T>(), bytes(any_front), max_exit.data_ptr<T>(),
               unit.size(0), rel.size(0), want_exit, current_stream(unit));
}

void ray_exit(const at::Tensor& unit, const at::Tensor& rel,
              const at::Tensor& vdw, const at::Tensor& origin,
              at::Tensor any_front, at::Tensor max_exit, bool want_exit) {
  const c10::cuda::CUDAGuard guard(unit.device());
  if (unit.scalar_type() == at::kDouble) {
    ray_exit_t<double>(unit, rel, vdw, origin, any_front, max_exit, want_exit);
  } else {
    ray_exit_t<float>(unit, rel, vdw, origin, any_front, max_exit, want_exit);
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

template <typename T>
void path_sweep_t(const at::Tensor& vectors, const at::Tensor& chunks,
                  const at::Tensor& coords, const at::Tensor& vdw,
                  at::Tensor& ok, at::Tensor& pos, at::Tensor& cmin,
                  int64_t max_steps) {
  pw::path_sweep(vectors.data_ptr<T>(), chunks.data_ptr<int32_t>(),
                 coords.data_ptr<T>(), vdw.data_ptr<T>(), bytes(ok),
                 pos.data_ptr<int32_t>(), cmin.data_ptr<T>(), vectors.size(0),
                 coords.size(0), static_cast<int>(max_steps),
                 current_stream(vectors));
}

void path_sweep(const at::Tensor& vectors, const at::Tensor& chunks,
                const at::Tensor& coords, const at::Tensor& vdw,
                at::Tensor ok, at::Tensor pos, at::Tensor cmin,
                int64_t max_steps) {
  const c10::cuda::CUDAGuard guard(vectors.device());
  if (vectors.scalar_type() == at::kDouble) {
    path_sweep_t<double>(vectors, chunks, coords, vdw, ok, pos, cmin, max_steps);
  } else {
    path_sweep_t<float>(vectors, chunks, coords, vdw, ok, pos, cmin, max_steps);
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

template <typename T>
void dbscan_t(const at::Tensor& points, const at::Tensor& valid,
              const at::Tensor& eps, at::Tensor& adj, at::Tensor& scratch,
              at::Tensor& labels, int64_t min_samples, int64_t max_clusters) {
  pw::dbscan(points.data_ptr<T>(), static_cast<const uint8_t*>(valid.data_ptr()),
             eps.data_ptr<T>(), adj.data_ptr<int32_t>(),
             scratch.data_ptr<int32_t>(), labels.data_ptr<int32_t>(),
             points.size(0), points.size(1), static_cast<int>(min_samples),
             static_cast<int>(max_clusters), current_stream(points));
}

void dbscan(const at::Tensor& points, const at::Tensor& valid,
            const at::Tensor& eps, at::Tensor adj, at::Tensor scratch,
            at::Tensor labels, int64_t min_samples, int64_t max_clusters) {
  const c10::cuda::CUDAGuard guard(points.device());
  if (points.scalar_type() == at::kDouble) {
    dbscan_t<double>(points, valid, eps, adj, scratch, labels, min_samples,
                     max_clusters);
  } else {
    dbscan_t<float>(points, valid, eps, adj, scratch, labels, min_samples,
                    max_clusters);
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("ray_exit", &ray_exit, "per-ray front hit and farthest exit");
  m.def("path_sweep", &path_sweep, "per-ray clearance sweep");
  m.def("dbscan", &dbscan, "DBSCAN labels per frame");
}
