"""Registers, spills and block-width timings of the two optimiser kernels
on one CUDA card.

Run from the root of a checkout: ``python3 optim_kernel_report.py``.

1. ``nvcc -Xptxas -v`` on ``csrc/lbfgsb_stable.cu`` and ``csrc/nm_xy.cu``
   with the extension's flags: registers, stack frame and spill bytes of
   every kernel instantiation;
2. the main-path inputs of ``lbfgsb_stable`` and ``nm_xy`` that
   ``chip_smoke.py`` phase 3 times (``chip_smoke.timed_calls``: PUDXES,
   REYMAL, the first 1,440-frame DL_POLY chunk, the first 48-frame
   periodic chunk; both d of lbfgsb_stable), each kernel timed
   (warm median, CUDA events) at every block width of 32-256 threads
   and, for lbfgsb_stable, the one-warp variant held to 170 registers; every
   configuration's outputs must equal the default's to the bit.

Prints one line per (kernel, input, configuration) and the card's name
and power limit.  ``--ptxas DIR`` also prints step 1 for the two sources
in another csrc directory (an earlier version of the kernels).
"""

from __future__ import annotations

import contextlib
import pathlib
import subprocess
import sys

import torch

import chip_smoke
from pywindow_torch.ops import _cuda, lbfgsb_kernels, nm_kernels

ROOT = pathlib.Path(__file__).resolve().parent

WIDTHS = (32, 64, 128, 256)
#: (threads a lane, register cap) of lbfgsb_stable
LBFGSB_LAUNCHES = tuple((w, False) for w in WIDTHS) + ((32, True),)


def ptxas_report(csrc: pathlib.Path = _cuda.CSRC) -> None:
    """Compile each optimiser source of ``csrc`` alone with -Xptxas -v (no
    PyTorch header: seconds) and print ptxas's lines about its kernels."""
    out = ROOT / "build" / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    for src in ("lbfgsb_stable.cu", "nm_xy.cu"):
        cmd = [
            "nvcc", *_cuda.CUDA_FLAGS, "-std=c++17", "-Xptxas", "-v", "-c",
            str(csrc / src), "-o", str(out / (src + ".o")),
        ]
        res = subprocess.run(cmd, capture_output=True, text=True, check=True)
        for line in res.stderr.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                print(f"{csrc.name}/{src}: {line.split('ptxas info    :')[-1].strip()}")
            elif "bytes stack frame" in line:
                print(f"{csrc.name}/{src}: {line.strip()}")


@contextlib.contextmanager
def launch_rule(module, name: str, rule):
    """``module.name`` (a wrapper's block-width rule) replaced by ``rule``
    for the duration, restored after."""
    saved = getattr(module, name)
    setattr(module, name, rule)
    try:
        yield
    finally:
        setattr(module, name, saved)


def main() -> None:
    smi = chip_smoke.phase_card()
    ptxas_report()
    if sys.argv[1:2] == ["--ptxas"]:
        ptxas_report(pathlib.Path(sys.argv[2]).resolve())
    seen = chip_smoke.record_inputs()
    for label, args, kwargs in chip_smoke.timed_calls("lbfgsb_stable", seen["lbfgsb_stable"]):
        ref = lbfgsb_kernels.lbfgsb_stable_flat_cuda(*args, **kwargs)
        row = []
        for width, cap in LBFGSB_LAUNCHES:
            with launch_rule(lbfgsb_kernels, "lane_launch", lambda lanes, n, sms, w=width, c=cap: (w, c)):
                out = lbfgsb_kernels.lbfgsb_stable_flat_cuda(*args, **kwargs)
                torch.cuda.synchronize()
                chip_smoke.check(all(torch.equal(a, b) for a, b in zip(out, ref)), f"{label} {width}: differs")
                ms = chip_smoke.time_ms(lambda: lbfgsb_kernels.lbfgsb_stable_flat_cuda(*args, **kwargs))
            row.append(f"{width}{'/cap' if cap else ''}: {ms:.4f}")
        print(f"lbfgsb_stable {label} {tuple(args[0].shape)} ms by threads a lane: {', '.join(row)}")
    for label, args, kwargs in chip_smoke.timed_calls("nm_xy", seen["nm_xy"]):
        ref = nm_kernels.nm_xy_flat_cuda(*args, **kwargs)
        row = []
        for width in WIDTHS:
            with launch_rule(nm_kernels, "lane_threads", lambda lanes, n, sms, w=width: w):
                out = nm_kernels.nm_xy_flat_cuda(*args, **kwargs)
                torch.cuda.synchronize()
                chip_smoke.check(all(torch.equal(a, b) for a, b in zip(out, ref)), f"{label} {width}: differs")
                ms = chip_smoke.time_ms(lambda: nm_kernels.nm_xy_flat_cuda(*args, **kwargs))
            row.append(f"{width}: {ms:.4f}")
        print(f"nm_xy {label} {tuple(args[0].shape)} ms by threads a lane: {', '.join(row)}")
    print(smi)


if __name__ == "__main__":
    main()
