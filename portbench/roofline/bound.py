"""The least time the card could take for one recorded kernel call, and
the device time of that call alone: a frozen copy of the port's own
arithmetic for its optimiser kernels (``chip_smoke.bound``,
``operations``, ``optimiser_work``, ``active_lanes``, ``grid_kept``),
with the H100's published peaks.

A call is recorded at the kernel's wrapper by name
(:data:`WRAPPERS`): ``(args, kwargs, out)`` as the wrapper received and
returned them.  A wrapper that a later change of the program removes
records nothing, and the metric that reads it reports nothing.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

from portbench.reference.frozen import nm_kernels

#: H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM3 bytes
#: per second, and operations per second outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}

#: kernel name -> (module of the program, wrapper attribute)
WRAPPERS = {
    "lbfgsb_stable": ("pywindow_torch.ops.lbfgsb_kernels", "lbfgsb_stable_flat_cuda"),
    "nm_xy": ("pywindow_torch.ops.nm_kernels", "nm_xy_flat_cuda"),
}

#: calls captured in one CUDA graph for a device time
GRAPH_CALLS = 20


@contextlib.contextmanager
def recording(seen: dict[str, list]):
    """Inside the block each wrapper of :data:`WRAPPERS` that the program
    still has appends ``(args, kwargs, out)`` of every call to
    ``seen[kernel]`` (the inputs cloned before the call)."""
    patched = []
    try:
        for key, (modname, attr) in WRAPPERS.items():
            module = importlib.import_module(modname)
            fn = getattr(module, attr, None)
            if fn is None:
                continue

            def run(*args, _fn=fn, _key=key, **kwargs):
                copy = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                kw = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in kwargs.items()}
                out = _fn(*args, **kwargs)
                seen.setdefault(_key, []).append((copy, kw, out))
                return out

            patched.append((module, attr, fn))
            setattr(module, attr, run)
        yield seen
    finally:
        for module, attr, fn in patched:
            setattr(module, attr, fn)


def device_ms(fn) -> float:
    """ms a call of ``fn`` keeps the card busy: :data:`GRAPH_CALLS` calls
    captured in one CUDA graph, the median of 5 warm replays over the
    calls (the kernels back to back, no host in between)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_CALLS)
    return sorted(times)[2]


def active_lanes(args, kwargs) -> int:
    """The lanes of an optimiser call that do work."""
    active = kwargs.get("active")
    return args[0].shape[0] if active is None else int(active.sum())


def grid_kept(args, kwargs) -> torch.Tensor:
    """The atoms ``nm_xy``'s grid cull keeps in each active lane (the
    frozen ``grid_keep``, in slices of 1,024 lanes)."""
    active = kwargs.get("active")
    lanes = [a if active is None else a[active] for a in args[:4]]
    ns = kwargs.get("brute_ns", 20)
    kept = [
        nm_kernels.grid_keep(*(a[lo : lo + 1024] for a in lanes), ns).sum(-1)
        for lo in range(0, lanes[0].shape[0], 1024)
    ]
    return torch.cat(kept) if kept else torch.zeros(0, dtype=torch.int64, device=args[0].device)


def optimiser_ops(key: str, args, kwargs, out) -> int:
    """Operations of an optimiser call over its active lanes, per
    (evaluation, atom) as the kernels compute them: ``nm_xy`` the anchor
    pass and 3 simplex evaluations over every atom and the ns^2 grid over
    the atoms the cull keeps; ``lbfgsb_stable`` the start and one
    line-search evaluation per iteration (a lower bound)."""
    lanes = active_lanes(args, kwargs)
    n = args[0].shape[1]
    if key == "nm_xy":
        ns = kwargs.get("brute_ns", 20)
        grid = int(grid_kept(args, kwargs).sum())
        return lanes * n * (12 + 22 * 3) + grid * 22 * ns * ns
    d = args[3].shape[1]
    iters = int(out[2].to(torch.int64).sum())
    return n * ((11 + 22 + 20 * d) * lanes + (11 + (11 + 20) + (11 + 11 + 20 * d)) * iters)


def bound_ms(key: str, args, kwargs, out) -> float:
    """The larger of the bytes the call must move (inputs read once, the
    inactive lanes' inputs not read, outputs written once) over the HBM
    rate and its operations over the peak rate of their type, in ms."""
    t = [a for a in args if torch.is_tensor(a)]
    active = kwargs.get("active")
    b = t[0].shape[0]
    share = 1.0 if active is None else int(active.sum()) / b
    in_bytes = sum(
        a.numel() * a.element_size() * (share if a.ndim and a.shape[0] == b else 1.0) for a in t
    )
    if active is not None:
        in_bytes += active.numel() * active.element_size()
    outs = [o for o in (out if isinstance(out, tuple) else (out,)) if torch.is_tensor(o)]
    out_bytes = sum(o.numel() * o.element_size() for o in outs)
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES
    t_ops = optimiser_ops(key, args, kwargs, out) / PEAK_OPS[t[0].dtype]
    return 1e3 * max(t_bytes, t_ops)


def roofline(key: str, calls: list, wrapper) -> tuple[float, float]:
    """(the calls' summed bound, their summed device time alone), in ms,
    each call replayed through ``wrapper``."""
    bound = sum(bound_ms(key, a, kw, out) for a, kw, out in calls)
    dev = sum(device_ms(lambda a=a, kw=kw: wrapper(*a, **kw)) for a, kw, _ in calls)
    return bound, dev
