"""Build and load the hand-written CUDA kernels.

The kernels (``pywindow_torch/csrc/*.cu``) include no PyTorch header;
``csrc/bindings.cpp`` is the one small source that does, and it binds
them with a launch check after every launch.  The extension is built
with ``torch.utils.cpp_extension.load`` for ``sm_90a`` on first use,
never at import, into ``<checkout>/build/pywindow_torch/`` (listed in
``.gitignore``); ``load`` rebuilds when a source changes.

:data:`LAUNCHES` counts kernel launches by kernel name: each wrapper
adds one (:func:`count_launch`) where it launches its kernel and nowhere
else, so a caller can show that a run went through the kernels.  The
count is taken under a lock, since a sweep launches from its dispatching
thread and its collector thread at once; :func:`thread_launches` holds
the calling thread's own counts.
"""

from __future__ import annotations

import collections
import functools
import pathlib
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "pywindow_torch"
SOURCES = (
    "bindings.cpp",
    "ray_exit.cu",
    "path_sweep.cu",
    "fine_path.cu",
    "dbscan.cu",
    "lbfgsb_stable.cu",
    "nm_xy.cu",
    "clearance_min.cu",
)
#: -fmad=false: no multiply-add contraction, so each kernel rounds
#: exactly like its plain PyTorch version (which runs one op at a time).
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-fmad=false")

#: kernel launches by kernel name (see the module docstring).
LAUNCHES: collections.Counter = collections.Counter()
_LAUNCH_LOCK = threading.Lock()
_THREAD = threading.local()


def thread_launches() -> collections.Counter:
    """The calling thread's kernel launches by kernel name."""
    if not hasattr(_THREAD, "launches"):
        _THREAD.launches = collections.Counter()
    return _THREAD.launches


def count_launch(name: str) -> None:
    """Count one launch of kernel ``name`` (in :data:`LAUNCHES` and in
    the calling thread's :func:`thread_launches`)."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
    thread_launches()[name] += 1


@functools.cache
def load_extension():
    """Build the kernels if needed and load them (once per process)."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(
        name="pywindow_torch_kernels",
        sources=[str(CSRC / s) for s in SOURCES],
        build_directory=str(BUILD_DIR),
        extra_cflags=["-O3"],
        extra_cuda_cflags=list(CUDA_FLAGS),
        verbose=False,
    )


_DTYPES = (torch.float32, torch.float64)


def device_type(name: str, t: torch.Tensor) -> str:
    """The device type, "cpu" or "cuda", of the tensor a kernel entry
    point was given: it runs the plain version or the kernel by it."""
    if t.device.type not in ("cpu", "cuda"):
        msg = f"{name}: unsupported device {t.device}"
        raise ValueError(msg)
    return t.device.type


def check_inputs(
    name: str, dtype: torch.dtype, **tensors: torch.Tensor
) -> torch.device:
    """Validate that every tensor is contiguous and on one CUDA device,
    and that float operands have ``dtype``; return the device."""
    if dtype not in _DTYPES:
        msg = f"{name}: dtype {dtype} not supported (float32 or float64)"
        raise TypeError(msg)
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        msg = f"{name}: all tensors must be on one CUDA device, got {devices}"
        raise ValueError(msg)
    for key, t in tensors.items():
        if t.numel() >= 2**31:
            msg = f"{name}: {key} has {t.numel()} elements (kernel indices are 32-bit)"
            raise ValueError(msg)
        if not t.is_contiguous():
            msg = f"{name}: {key} must be contiguous"
            raise ValueError(msg)
        if t.is_floating_point() and t.dtype != dtype:
            msg = f"{name}: {key} has dtype {t.dtype}, expected {dtype}"
            raise TypeError(msg)
    return next(iter(devices))


@functools.cache
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (132 on an H100):
    the optimiser wrappers size their lane blocks by it."""
    return torch.cuda.get_device_properties(device).multi_processor_count


#: shared memory a block may use on the card (227 KB of the SM's 256 KB)
SMEM_LIMIT = 232448


def check_smem(name: str, nbytes: int) -> None:
    """Refuse a launch whose per-block shared memory exceeds the card's
    limit (a molecule too large to stage)."""
    if nbytes > SMEM_LIMIT:
        msg = f"{name}: needs {nbytes} bytes of shared memory per block (> {SMEM_LIMIT})"
        raise ValueError(msg)


def check_shape(name: str, t: torch.Tensor, shape: tuple, what: str) -> None:
    """Raise unless ``t`` has exactly ``shape``."""
    if tuple(t.shape) != tuple(shape):
        msg = f"{name}: {what} must have shape {tuple(shape)}, got {tuple(t.shape)}"
        raise ValueError(msg)


def check_active(name: str, active: torch.Tensor | None, lanes: int) -> None:
    """Raise unless ``active`` is None or a contiguous (lanes,) bool
    tensor (the per-lane flag of the optimiser kernels)."""
    if active is None:
        return
    if active.dtype != torch.bool:
        msg = f"{name}: active must be a bool tensor"
        raise TypeError(msg)
    check_shape(name, active, (lanes,), "active")


def on_active_lanes(active, fn, lane_args: tuple, placeholders: tuple) -> tuple:
    """``fn(*lane_args)`` on the lanes where ``active`` is True, scattered
    into ``placeholders`` (full-size outputs holding what an inactive
    lane's kernel block writes); every lane when ``active`` is None.
    The plain versions' form of the kernels' early exit: lanes are
    independent, so an active lane's result does not depend on the
    others."""
    if active is None:
        return fn(*lane_args)
    idx = torch.nonzero(active).flatten()
    if idx.numel():
        for full, part in zip(placeholders, fn(*(a[idx] for a in lane_args))):
            full[idx] = part
    return placeholders
