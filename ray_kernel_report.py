"""Launch-shape and device timings of the culled ray kernels and DBSCAN on
one CUDA card.

Run from the root of a checkout: ``python3 ray_kernel_report.py
[--kernels path_sweep,ray_exit,dbscan,fine_path] [--widths 128,256,512,1024]``
(default: all four kernels, all four widths).

On the main-path inputs that ``chip_smoke.py`` phase 3 times
(``chip_smoke.timed_calls``: PUDXES, REYMAL, the first 1,440-frame
DL_POLY chunk, the first 48-frame periodic chunk) and on the chunk's
first 8, 32, 128 and 512 frames:

1. ``path_sweep`` at 1, 2, 4 and 8 rays a warp, beside the blocks of a
   one-ray-a-warp launch and the choice of
   ``ray_kernels.sweep_rays_per_warp``; every launch's outputs must equal
   the rule's to the bit;
2. ``ray_exit`` (full and slim) with the spiral's tile order and with
   index order; the outputs must be equal;
3. ``dbscan`` at the block ``cluster_kernels.dbscan_labels_cuda``
   chooses, then at each of ``--widths`` threads a frame beside the
   choice of ``cluster_kernels.dbscan_threads``; every width's labels
   must equal the rule's (``--widths ''`` times the wrapper alone);
4. ``fine_path`` as the pipeline calls it (its active slots).

Each is timed twice: ``call``, the warm median of one wrapper call
between CUDA events (``chip_smoke.time_ms``, as phase 3 times it; on an
idle card a small call's reading is the wrapper's host time), and
``device``, the same call captured in one CUDA graph and replayed
(``chip_smoke.device_ms``: the kernels back to back, no host in
between).  Prints one line per (kernel, input) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse

import torch

import chip_smoke
from chip_smoke import device_ms
from optim_kernel_report import launch_rule
from pywindow_torch.ops import _cuda, cluster_kernels, ray_kernels

RAYS_PER_WARP = (1, 2, 4, 8)
DBSCAN_WIDTHS = (128, 256, 512, 1024)
#: leading slices of the sweep chunk, for launches between one molecule
#: and the chunk
CHUNK_SLICES = (8, 32, 128, 512)
KERNELS = ("path_sweep", "ray_exit", "dbscan", "fine_path")


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


def dbscan_row(label, args, widths) -> None:
    b, k = args[0].shape[:2]
    valid = args[1].to(torch.float64).sum(-1)

    def run():
        return cluster_kernels.dbscan_labels_cuda(*args)

    ref = run()
    row = [f"wrapper: {both_ms(run)}"]
    for width in widths:
        with launch_rule(cluster_kernels, "dbscan_threads", lambda f, s, w=width: w):
            out = run()
            torch.cuda.synchronize()
            chip_smoke.check(torch.equal(out, ref), f"dbscan {label} {width}: labels differ")
            row.append(f"{width}: {both_ms(run)}")
    rule = f"; rule {cluster_kernels.dbscan_threads(b, _cuda.sm_count(args[0].device))}" if widths else ""
    print(
        f"dbscan {label} B={b} K={k} ({float(valid.mean()):.1f} valid a frame{rule}) call / device "
        f"ms by threads a frame: {', '.join(row)}"
    )


def fine_row(label, args) -> None:
    live = "all" if len(args) < 6 or args[5] is None else int(args[5].sum())
    print(
        f"fine_path {label} {tuple(args[0].shape)} ({live} slots walked) call / device ms: "
        f"{both_ms(lambda: ray_kernels.fine_path_cuda(*args))}"
    )


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", default=",".join(KERNELS))
    parser.add_argument("--widths", default=",".join(map(str, DBSCAN_WIDTHS)))
    opts = parser.parse_args()
    wanted = opts.kernels.split(",")
    widths = [int(w) for w in opts.widths.split(",") if w]
    smi = chip_smoke.phase_card()
    seen = chip_smoke.record_inputs()
    rows = {
        "path_sweep": sweep_row, "ray_exit": exit_row, "fine_path": fine_row,
        "dbscan": lambda label, args: dbscan_row(label, args, widths),
    }
    for key in KERNELS:
        if key not in wanted:
            continue
        for label, args, _ in chip_smoke.timed_calls(key, seen[key]):
            rows[key](label, args)
            if label == chip_smoke.SWEEP_LABEL and key in ("path_sweep", "dbscan"):
                for b in CHUNK_SLICES:
                    rows[key](f"{label}[:{b}]", frames(args, b))
    print(smi)


if __name__ == "__main__":
    main()
