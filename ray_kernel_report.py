"""Launch-shape timings of the two culled ray kernels on one CUDA card.

Run from the root of a checkout: ``python3 ray_kernel_report.py``.

On the main-path inputs that ``chip_smoke.py`` phase 3 times
(``chip_smoke.timed_calls``: PUDXES, REYMAL, the first 1,440-frame
DL_POLY chunk, the first 48-frame periodic chunk) and on the chunk's
first 8, 32, 128 and 512 frames:

1. ``path_sweep`` at 1, 2, 4 and 8 rays a warp, beside the blocks of a
   one-ray-a-warp launch and the choice of
   ``ray_kernels.sweep_rays_per_warp``; every launch's outputs must equal
   the rule's to the bit;
2. ``ray_exit`` (full and slim) with the spiral's tile order and with
   index order; the outputs must be equal.

Each is timed twice: ``call``, the warm median of one wrapper call
between CUDA events (``chip_smoke.time_ms``, as phase 3 times it; on an
idle card a small call's reading is the wrapper's host time), and
``device``, the same call captured :data:`GRAPH_CALLS` times in one CUDA
graph and replayed, over the calls (the kernels back to back, no host
in between).  Prints one line per (kernel, input) and the card's name
and power limit.
"""

from __future__ import annotations

import torch

import chip_smoke
from optim_kernel_report import launch_rule
from pywindow_torch.ops import _cuda, ray_kernels

RAYS_PER_WARP = (1, 2, 4, 8)
#: leading slices of the sweep chunk, for launches between one molecule
#: and the chunk
CHUNK_SLICES = (8, 32, 128, 512)
#: calls captured in one CUDA graph for the device time
GRAPH_CALLS = 20


def device_ms(fn) -> float:
    """ms a call of ``fn`` keeps the card busy: GRAPH_CALLS calls captured
    in one CUDA graph, the median of 5 warm replays over the calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm-up on the capture stream
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


def both_ms(fn) -> str:
    """``call / device`` ms of ``fn``."""
    return f"{chip_smoke.time_ms(fn):.4f} / {device_ms(fn):.4f}"


def frames(args, b):
    """The first ``b`` frames of a kernel call's inputs."""
    n = args[0].shape[0]
    return tuple(
        a[:b].contiguous() if torch.is_tensor(a) and a.ndim and a.shape[0] == n else a
        for a in args
    )


def sweep_row(label, args) -> None:
    b, p = args[0].shape[:2]
    sms = _cuda.sm_count(args[0].device)
    ref = ray_kernels.path_sweep_cuda(*args)
    row = []
    for rpw in RAYS_PER_WARP:
        with launch_rule(ray_kernels, "sweep_rays_per_warp", lambda f, r, s, k=rpw: k):
            out = ray_kernels.path_sweep_cuda(*args)
            torch.cuda.synchronize()
            chip_smoke.check(all(torch.equal(x, y) for x, y in zip(out, ref)), f"{label} {rpw}: differs")
            ms = both_ms(lambda: ray_kernels.path_sweep_cuda(*args))
        row.append(f"{rpw}: {ms}")
    blocks = b * -(-p // ray_kernels.SWEEP_WARPS)
    print(
        f"path_sweep {label} B={b} P={p} ({blocks} one-ray blocks, {blocks / sms:.1f} an SM; "
        f"rule {ray_kernels.sweep_rays_per_warp(b, p, sms)}) call / device ms by rays a warp: "
        f"{', '.join(row)}"
    )


def exit_row(label, args) -> None:
    unit, rel, vdw, origin, want_exit, order = args
    index = torch.arange(unit.shape[1], dtype=torch.int32, device=unit.device)
    ref = ray_kernels.ray_exit_cuda(*args)
    out = ray_kernels.ray_exit_cuda(unit, rel, vdw, origin, want_exit, index)
    torch.cuda.synchronize()
    chip_smoke.check(all(torch.equal(x, y) for x, y in zip(out, ref)), f"{label}: orders differ")
    spiral = both_ms(lambda: ray_kernels.ray_exit_cuda(*args))
    plain = both_ms(lambda: ray_kernels.ray_exit_cuda(unit, rel, vdw, origin, want_exit, index))
    print(
        f"ray_exit {label} {tuple(unit.shape)} call / device ms: spiral tile order {spiral}, "
        f"index order {plain}"
    )


def main() -> None:
    smi = chip_smoke.phase_card()
    seen = chip_smoke.record_inputs()
    sweeps = chip_smoke.timed_calls("path_sweep", seen["path_sweep"])
    for label, args, _ in sweeps:
        sweep_row(label, args)
        if label == chip_smoke.SWEEP_LABEL:
            for b in CHUNK_SLICES:
                sweep_row(f"{label}[:{b}]", frames(args, b))
    for label, args, _ in chip_smoke.timed_calls("ray_exit", seen["ray_exit"]):
        exit_row(label, args)
    print(smi)


if __name__ == "__main__":
    main()
