// PyTorch bindings of the pywindow_torch CUDA kernels: the only source
// that includes PyTorch's headers (they dominate the build time).  The
// Python wrappers in pywindow_torch/ops/*_kernels.py
// check device, dtype, shape and contiguity before calling these; each
// binding launches on the current stream of the tensors' device and
// checks the launch.
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

int dim(const at::Tensor& t, int i) { return static_cast<int>(t.size(i)); }

template <typename T>
void ray_exit_t(const at::Tensor& unit, const at::Tensor& rel,
                const at::Tensor& vdw, const at::Tensor& origin,
                const int32_t* order, at::Tensor& any_front,
                at::Tensor& max_exit, bool want_exit) {
  pw::ray_exit(unit.data_ptr<T>(), rel.data_ptr<T>(), vdw.data_ptr<T>(),
               origin.data_ptr<T>(), order, bytes(any_front),
               max_exit.data_ptr<T>(), dim(unit, 0), dim(unit, 1), dim(rel, 1),
               want_exit, current_stream(unit));
}

void ray_exit(const at::Tensor& unit, const at::Tensor& rel,
              const at::Tensor& vdw, const at::Tensor& origin,
              at::Tensor any_front, at::Tensor max_exit, bool want_exit,
              const at::Tensor& order) {
  const c10::cuda::CUDAGuard guard(unit.device());
  const int32_t* ord = order.data_ptr<int32_t>();
  if (unit.scalar_type() == at::kDouble) {
    ray_exit_t<double>(unit, rel, vdw, origin, ord, any_front, max_exit,
                       want_exit);
  } else {
    ray_exit_t<float>(unit, rel, vdw, origin, ord, any_front, max_exit,
                      want_exit);
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

const uint8_t* optional_bytes(const c10::optional<at::Tensor>& t) {
  return t.has_value() ? static_cast<const uint8_t*>(t->data_ptr()) : nullptr;
}

// path_sweep and fine_path share one signature: vectors (B,R,3),
// chunks (B,R), coords (B,N,3), vdw (B,N) -> ok, pos, cmin (B,R)
template <typename T, typename Fn>
void sweep_t(Fn fn, const at::Tensor& vectors, const at::Tensor& chunks,
             const at::Tensor& coords, const at::Tensor& vdw, at::Tensor& ok,
             at::Tensor& pos, at::Tensor& cmin, int64_t max_steps) {
  fn(vectors.data_ptr<T>(), chunks.data_ptr<int32_t>(), coords.data_ptr<T>(),
     vdw.data_ptr<T>(), bytes(ok), pos.data_ptr<int32_t>(), cmin.data_ptr<T>(),
     dim(vectors, 0), dim(vectors, 1), dim(coords, 1),
     static_cast<int>(max_steps), current_stream(vectors));
}

void path_sweep(const at::Tensor& vectors, const at::Tensor& chunks,
                const at::Tensor& coords, const at::Tensor& vdw,
                at::Tensor ok, at::Tensor pos, at::Tensor cmin,
                int64_t max_steps, int64_t rays_per_warp) {
  const c10::cuda::CUDAGuard guard(vectors.device());
  const int rpw = static_cast<int>(rays_per_warp);
  auto launch = [rpw](auto vec, auto ch, auto co, auto vd, auto ok_,
                      auto pos_, auto cmin_, int b, int p, int n, int steps,
                      void* stream) {
    pw::path_sweep(vec, ch, co, vd, ok_, pos_, cmin_, b, p, n, steps, rpw,
                   stream);
  };
  if (vectors.scalar_type() == at::kDouble) {
    sweep_t<double>(launch, vectors, chunks, coords, vdw, ok, pos, cmin,
                    max_steps);
  } else {
    sweep_t<float>(launch, vectors, chunks, coords, vdw, ok, pos, cmin,
                   max_steps);
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void fine_path(const at::Tensor& vectors, const at::Tensor& chunks,
               const at::Tensor& coords, const at::Tensor& vdw,
               const c10::optional<at::Tensor>& active, at::Tensor ok,
               at::Tensor pos, at::Tensor cmin, int64_t max_steps) {
  const c10::cuda::CUDAGuard guard(vectors.device());
  const uint8_t* act = optional_bytes(active);
  auto launch = [act](auto vec, auto ch, auto co, auto vd, auto ok_,
                      auto pos_, auto cmin_, int b, int w, int n, int steps,
                      void* stream) {
    pw::fine_path(vec, ch, co, vd, act, ok_, pos_, cmin_, b, w, n, steps,
                  stream);
  };
  if (vectors.scalar_type() == at::kDouble) {
    sweep_t<double>(launch, vectors, chunks, coords, vdw, ok, pos, cmin,
                    max_steps);
  } else {
    sweep_t<float>(launch, vectors, chunks, coords, vdw, ok, pos, cmin,
                   max_steps);
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

template <typename T>
void dbscan_t(const at::Tensor& points, const at::Tensor& valid,
              const at::Tensor& eps, at::Tensor& labels, int64_t min_samples,
              int64_t max_clusters, int64_t threads, bool stored,
              uint8_t* scratch) {
  pw::dbscan(points.data_ptr<T>(), static_cast<const uint8_t*>(valid.data_ptr()),
             eps.data_ptr<T>(), labels.data_ptr<int32_t>(), dim(points, 0),
             dim(points, 1), static_cast<int>(min_samples),
             static_cast<int>(max_clusters), static_cast<int>(threads), stored,
             scratch, current_stream(points));
}

void dbscan(const at::Tensor& points, const at::Tensor& valid,
            const at::Tensor& eps, at::Tensor labels, int64_t min_samples,
            int64_t max_clusters, int64_t threads, bool stored,
            c10::optional<at::Tensor> scratch) {
  const c10::cuda::CUDAGuard guard(points.device());
  uint8_t* frames = scratch.has_value() ? bytes(*scratch) : nullptr;
  if (points.scalar_type() == at::kDouble) {
    dbscan_t<double>(points, valid, eps, labels, min_samples, max_clusters,
                     threads, stored, frames);
  } else {
    dbscan_t<float>(points, valid, eps, labels, min_samples, max_clusters,
                    threads, stored, frames);
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void lbfgsb_stable(const at::Tensor& coords, const at::Tensor& vdw,
                   const at::Tensor& origin, const at::Tensor& x0,
                   const at::Tensor& lower, const at::Tensor& upper,
                   const c10::optional<at::Tensor>& active, at::Tensor x,
                   at::Tensor fun, at::Tensor nit, at::Tensor converged,
                   at::Tensor capped, double sign, int64_t maxiter, int64_t m,
                   int64_t maxls, double pgtol, double factr, double fd_step,
                   int64_t threads, bool reg_cap) {
  const c10::cuda::CUDAGuard guard(coords.device());
  const pw::LbfgsbParams params{sign,
                                static_cast<int>(maxiter),
                                static_cast<int>(m),
                                static_cast<int>(maxls),
                                pgtol,
                                factr,
                                fd_step};
  pw::lbfgsb_stable(coords.data_ptr<double>(), vdw.data_ptr<double>(),
                    origin.data_ptr<double>(), x0.data_ptr<double>(),
                    lower.data_ptr<double>(), upper.data_ptr<double>(),
                    optional_bytes(active), x.data_ptr<double>(),
                    fun.data_ptr<double>(), nit.data_ptr<int32_t>(),
                    bytes(converged), bytes(capped), dim(coords, 0),
                    dim(coords, 1), dim(x0, 1), params,
                    static_cast<int>(threads), reg_cap, current_stream(coords));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void nm_xy(const at::Tensor& coords, const at::Tensor& vdw,
           const at::Tensor& zanchor, const at::Tensor& half,
           const c10::optional<at::Tensor>& active, at::Tensor xy,
           at::Tensor f, at::Tensor capped,
           const c10::optional<at::Tensor>& iterations, int64_t brute_ns,
           int64_t maxiter, double xatol, double fatol, int64_t threads) {
  const c10::cuda::CUDAGuard guard(coords.device());
  int32_t* iters =
      iterations.has_value() ? iterations->data_ptr<int32_t>() : nullptr;
  pw::nm_xy(coords.data_ptr<double>(), vdw.data_ptr<double>(),
            zanchor.data_ptr<double>(), half.data_ptr<double>(),
            optional_bytes(active), xy.data_ptr<double>(),
            f.data_ptr<double>(), bytes(capped), iters, dim(coords, 0),
            dim(coords, 1), static_cast<int>(brute_ns),
            static_cast<int>(maxiter), xatol, fatol,
            static_cast<int>(threads), current_stream(coords));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void clearance_min(const at::Tensor& probes, const at::Tensor& coords,
                   const at::Tensor& vdw, at::Tensor out) {
  const c10::cuda::CUDAGuard guard(probes.device());
  if (probes.scalar_type() == at::kDouble) {
    pw::clearance_min(probes.data_ptr<double>(), coords.data_ptr<double>(),
                      vdw.data_ptr<double>(), out.data_ptr<double>(),
                      dim(probes, 0), dim(coords, 0), current_stream(probes));
  } else {
    pw::clearance_min(probes.data_ptr<float>(), coords.data_ptr<float>(),
                      vdw.data_ptr<float>(), out.data_ptr<float>(),
                      dim(probes, 0), dim(coords, 0), current_stream(probes));
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("ray_exit", &ray_exit, "per-ray front hit and farthest exit");
  m.def("path_sweep", &path_sweep, "per-ray clearance sweep");
  m.def("fine_path", &fine_path, "window-slot fine clearance sweep");
  m.def("dbscan", &dbscan, "DBSCAN labels per frame");
  m.def("lbfgsb_stable", &lbfgsb_stable, "stable L-BFGS-B per lane");
  m.def("nm_xy", &nm_xy, "window-xy brute grid + Nelder-Mead per lane");
  m.def("clearance_min", &clearance_min, "vdW clearance field of probes");
}
